"""Time-mean / variance diagnostics with GrADS output (PyTorch port of
speedyml/utils/timemean.py).

The reference's post-processing accumulators (src/mod_tmean.f90,
src/ppo_tminc.f90, src/ppo_tmout.f90): grid-space means of the prognostic
fields, second moments (variances + covariances), 2-D surface diagnostics
(including the lapse-rate mean-sea-level pressure reduction,
ppo_tminc.f90:47-66) and every-step flux means. The sums are tensors on the
model's device in the model dtype; `tm_update` and `tm_update_fluxes` return
a new state and never write one in place. `tmout`'s normalize-write-reset
cycle is `finalize` + `write_grads`, on the host in float64.

Diabatic-heating means (the reference's ns3d3 block, ppo_tminc.f90:264-268)
are not accumulated, as in the JAX package: only the summed tendency leaves
`Physics.step_physics`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dynamics.implicit import geopotential
from ..physics.constants import PP
from ..physics.humidity import rel_hum

#: order of the 3-D mean fields (reference save3d(:,:,1:9) less psi/chi/omega,
#: which tmout derives from the saved winds at output time)
MEAN3D_NAMES = ("u", "v", "t", "q", "phi", "rh")
#: second moments (reference ns3d2 block, ppo_tminc.f90:241-255)
VAR3D_NAMES = ("u2", "v2", "t2", "q2", "uv", "vt")
#: 2-D fields saved at post-processing steps (subset of save2d_1)
MEAN2D_NAMES = ("ps", "mslp", "u0", "v0", "t0", "rh0")
#: 2-D flux fields saved every step (subset of save2d_2, StepFluxes units)
FLUX2D_NAMES = ("precnv", "precls", "evap_s", "ustr_s", "vstr_s",
                "olr", "tsr", "ssr")


class TimeMeanState(NamedTuple):
    """Accumulated sums; divide by the counters to get means."""

    mean3d: torch.Tensor   # (6, kx, il, ix)
    var3d: torch.Tensor    # (6, kx, il, ix)
    mean2d: torch.Tensor   # (6, il, ix)
    flux2d: torch.Tensor   # (8, il, ix)
    rnsave: torch.Tensor   # () post-proc sample counter (mod_tmean rnsave)
    nstep: torch.Tensor    # () every-step flux counter


def init_timemean(kx: int, il: int, ix: int, dtype=torch.float32,
                  device: torch.device | str | None = None) -> TimeMeanState:
    """tmout(imode=0) equivalent (ppo_tmout.f90:700 block), on `device`
    (the card unless the caller names another)."""
    from ..device import resolve_device
    dev = resolve_device(device)

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=dev)

    return TimeMeanState(mean3d=z(len(MEAN3D_NAMES), kx, il, ix),
                         var3d=z(len(VAR3D_NAMES), kx, il, ix),
                         mean2d=z(len(MEAN2D_NAMES), il, ix),
                         flux2d=z(len(FLUX2D_NAMES), il, ix),
                         rnsave=z(), nstep=z())


def tm_update(dy, st, f, tm: TimeMeanState) -> TimeMeanState:
    """Accumulate one post-processing sample from prognostic fields `f` (one
    leapfrog time level); `st` is the model's sigma tables (numpy).

    Mirrors ppo_tminc.f90:47-100 (2-D) and 180-255 (3-D means + second
    moments) on sigma surfaces, as the JAX package does (the reference
    interpolates to pressure surfaces at accumulation time).
    """
    T = dy.T
    ucosm, vcosm = T.uvspec(f.vor, f.div)
    ug = T.spec_to_grid(ucosm, kcos=2)
    vg = T.spec_to_grid(vcosm, kcos=2)
    tg = T.spec_to_grid(f.t)
    qg = T.spec_to_grid(f.tr[0])
    psg = T.spec_to_grid(f.ps)
    phig = T.spec_to_grid(geopotential(f.t, dy.phis, dy.vg_np,
                                       dy.geop_corrections))
    # relative humidity at full levels: pressure p/p0 = exp(psg) * sigma
    psn = torch.exp(psg)                                 # p_s / p0
    sig = torch.as_tensor(np.asarray(st.sig, np.float64), dtype=tg.dtype,
                          device=tg.device)
    rh, _ = rel_hum(qg, tg, psn[None] * sig[:, None, None])

    kxm = tg.shape[0] - 1
    gam0 = 0.006 / PP.gg
    rgam = PP.rd * gam0
    # surface air temperature: lapse extrapolation from the lowest full
    # level (suflux-style), then the tminc MSL reduction with clipped tsg
    t0 = tg[kxm] * (1.0 / sig[kxm]) ** rgam
    tsg = 0.5 * (t0 + torch.clamp(t0, 255.0, 295.0))
    phis = torch.as_tensor(np.asarray(dy.phis0_grid, np.float64),
                           dtype=tg.dtype, device=tg.device)
    mslp = psn * (1.0 + gam0 * phis / tsg) ** (1.0 / rgam)  # p_msl / p0

    m3 = torch.stack([ug, vg, tg, qg, phig, rh])
    v3 = torch.stack([ug * ug, vg * vg, tg * tg, qg * qg, ug * vg, vg * tg])
    m2 = torch.stack([psn, mslp, ug[kxm], vg[kxm], t0, rh[kxm]])
    return tm._replace(mean3d=tm.mean3d + m3, var3d=tm.var3d + v3,
                       mean2d=tm.mean2d + m2, rnsave=tm.rnsave + 1.0)


def tm_update_fluxes(fx, tm: TimeMeanState) -> TimeMeanState:
    """Accumulate the every-step flux block (ppo_tminc save2d_2 analog)."""
    f2 = torch.stack([fx.precnv, fx.precls, fx.evap_s, fx.ustr_s, fx.vstr_s,
                      fx.olr, fx.tsr, fx.ssr])
    return tm._replace(flux2d=tm.flux2d + f2, nstep=tm.nstep + 1.0)


def finalize(tm: TimeMeanState) -> dict:
    """tmout(imode>0) normalization (ppo_tmout.f90:34-42): divide sums by
    the counters; variances become central moments. Returns numpy float64
    arrays."""
    def host(t):
        return t.detach().to("cpu", torch.float64).numpy()

    n = float(tm.rnsave)
    out = {}
    if n > 0:
        m3 = host(tm.mean3d) / n
        v3 = host(tm.var3d) / n
        for i, name in enumerate(MEAN3D_NAMES):
            out[name] = m3[i]
        # central moments: var(x) = E[x^2]-E[x]^2, cov similarly
        mu = dict(zip(MEAN3D_NAMES, m3))
        out["u2"] = v3[0] - mu["u"] ** 2
        out["v2"] = v3[1] - mu["v"] ** 2
        out["t2"] = v3[2] - mu["t"] ** 2
        out["q2"] = v3[3] - mu["q"] ** 2
        out["uv"] = v3[4] - mu["u"] * mu["v"]
        out["vt"] = v3[5] - mu["v"] * mu["t"]
        m2 = host(tm.mean2d) / n
        for i, name in enumerate(MEAN2D_NAMES):
            out[name] = m2[i]
    ns = float(tm.nstep)
    if ns > 0:
        f2 = host(tm.flux2d) / ns
        for i, name in enumerate(FLUX2D_NAMES):
            out[name] = f2[i]
    return out


def write_grads(tm: TimeMeanState, basepath: str, lat: np.ndarray,
                sigma: np.ndarray, year: int = 1981, month: int = 1,
                dt_hours: int = 24) -> dict:
    """Write the normalized means as one GrADS time record (.grd + .ctl),
    the reference's output format for tmout (ppo_setctl.f90). Returns the
    finalized field dict."""
    from ..io.grads import GradsWriter

    fields = finalize(tm)
    f3d = [(name, fields[name]) for name in MEAN3D_NAMES + VAR3D_NAMES
           if name in fields]
    f2d = [(name, fields[name]) for name in MEAN2D_NAMES + FLUX2D_NAMES
           if name in fields]
    ix = f2d[0][1].shape[-1] if f2d else f3d[0][1].shape[-1]
    with GradsWriter(basepath, lat, sigma, ix,
                     var3d=[n for n, _ in f3d], var2d=[n for n, _ in f2d],
                     year0=year, month0=month, dt_hours=dt_hours) as w:
        w.append([a for _, a in f3d], [a for _, a in f2d])
    return fields
