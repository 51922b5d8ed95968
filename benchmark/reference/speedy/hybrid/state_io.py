"""Grid-state injection/extraction for the hybrid coupler (PyTorch port of
speedyml/hybrid/state_io.py).

The reference's mode-30/31 state exchange (ppo_iogrid.f90:497-602):
  * 3-D variables (T, u, v, q) with q in g/kg; logp = ln(p_s / p0);
  * injection clamps q >= 0, transforms grid -> spectral (vdspec for winds,
    spec for scalars) with triangular truncation, sets BOTH leapfrog time
    levels, and evaluates the physical-bounds safety gate on the truncation
    round trip (ppo_iogrid.f90:513-577).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..dynamics.state import SpectralState


class GridState(NamedTuple):
    """Grid-space prognostic state (the internal_state_vector analog)."""

    t: torch.Tensor      # (kx, il, ix) absolute temperature [K]
    u: torch.Tensor      # (kx, il, ix) zonal wind [m/s]
    v: torch.Tensor      # (kx, il, ix) meridional wind [m/s]
    q: torch.Tensor      # (kx, il, ix) specific humidity [g/kg]
    logp: torch.Tensor   # (il, ix)     ln(p_s / p0)


# physical-bounds safety gate (ppo_iogrid.f90:563-577)
SAFE_BOUNDS = dict(u=(-150.0, 150.0), v=(-120.0, 120.0),
                   t=(160.0, 330.0), q=(-6.0, 30.0))


def safety_check(gs: GridState) -> torch.Tensor:
    """is_safe_to_run_speedy: a 0-d bool tensor, True iff all fields are
    within physical bounds. It stays on the device: a caller that branches
    on it pays one synchronisation."""
    ok = None
    for name in ("u", "v", "t", "q"):
        lo, hi = SAFE_BOUNDS[name]
        f = getattr(gs, name)
        cond = (torch.amin(f) >= lo) & (torch.amax(f) <= hi)
        ok = cond if ok is None else ok & cond
    return ok


def inject(dy, gs: GridState):
    """Grid state -> SpectralState + safety flag (iogrid mode 30).

    Returns (state, safe): both leapfrog levels hold the injected fields;
    safe is the post-truncation bounds check as a 0-d bool tensor.
    """
    T = dy.T

    def cast(x):
        return torch.as_tensor(x, dtype=dy.dtype, device=dy.device)

    q = torch.clamp(cast(gs.q), min=0.0)
    vor, div = T.vdspec(cast(gs.u), cast(gs.v), kcos=2)
    vor = T.trunct(vor)
    div = T.trunct(div)
    t_sp = T.trunct(T.grid_to_spec(cast(gs.t)))
    q_sp = T.trunct(T.grid_to_spec(q))
    ps_sp = T.trunct(T.grid_to_spec(cast(gs.logp)))

    def two(x):
        return torch.stack([x, x], dim=0)

    state = SpectralState(vor=two(vor), div=two(div), t=two(t_sp),
                          ps=two(ps_sp), tr=two(q_sp[None]))
    # the gate reads the truncated round trip, as the reference re-grids
    # the spectral fields before checking (ppo_iogrid.f90:540-560)
    safe = safety_check(extract(dy, state, level=0))
    return state, safe


def extract(dy, state: SpectralState, level: int = 0) -> GridState:
    """Spectral state -> grid state (iogrid mode 31; the reference reads
    Fortran time index 1 = our level 0)."""
    f = state.at_level(level)
    T = dy.T
    ug, vg = T.uv_grid(f.vor, f.div)
    return GridState(t=T.spec_to_grid(f.t), u=ug, v=vg,
                     q=T.spec_to_grid(f.tr[0]), logp=T.spec_to_grid(f.ps))
