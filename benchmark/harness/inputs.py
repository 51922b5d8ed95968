"""A cell's inputs, made from the run's seed: the reservoirs and their
readout, the standardizer, the start state and the boundary files.

Everything here is the benchmark's own. The weights are drawn on the run's
device by one torch.Generator in a few large calls, in float32 (the type
they are served in), so that the same seed gives the same inputs; the
reference draws them again from the seed rather than reading the program's
copies.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from reference.hybrid import (QMIN, SST_MIN, boundary_host, layout,
                              reservoir_nodes, start_state)
from reference.speedy.core.calendar import ModelDate
from reference.speedy.coupler.climatology import build_climatology
from reference.speedy.domain.decomposition import pack_global
from reference.speedy.io.synthetic_boundary import write_synthetic_boundary
from reference.speedy.transforms.tables import build_tables

F32 = torch.float32
# bits of the run's seed the boundary files take (numpy's default_rng takes
# any nonnegative integer; this keeps the value plain)
SEED_MASK = (1 << 63) - 1


def ring_shifts(n: int, deg: int) -> tuple:
    """deg distinct circulant shifts in [1, n-1], a function of (n, deg)
    only, with the plain ring edge 1 among them."""
    rs = np.random.default_rng(7919 * deg + n)
    shifts = {1}
    while len(shifts) < min(deg, n - 1):
        shifts.add(int(rs.integers(1, n)))
    return tuple(sorted(shifts))


def make_weights(cfg: dict, L, seed: int, device) -> dict:
    """The reservoirs of all regions and the readout, float32 on `device`:

    * adjacency: `degree` circulant shifts per node with uniform(0, 1)
      values, each row scaled to sum to `radius`, so that the spectral
      radius of every region's matrix is exactly `radius` (a nonnegative
      matrix whose rows all sum to r has spectral radius r);
    * Win: block-diagonal, sigma * uniform(-1, 1), q = n / n_in nodes per
      input;
    * Wout: the hybrid's (R, n_out, n_out + n) passes `model_block` times
      the standardized SPEEDY forecast through on its model block and adds
      `reservoir_scale` * N(0, 1) weights on the reservoir block; the
      ML-only readout (R, n_out, n) is the reservoir block alone;
    * x0: `x0_scale` * N(0, 1), the reservoirs' start state.
    """
    r, ro = cfg["reservoir"], cfg["readout"]
    R, n_in, n_out = L.R, L.n_in, L.n_out
    n = reservoir_nodes(cfg, n_in)
    deg = r["degree"]
    g = torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)
    a_val = torch.rand((R, n, deg), generator=g, device=device)
    a_val = a_val * (r["radius"] / a_val.sum(dim=-1, keepdim=True))
    win = r["sigma"] * (2.0 * torch.rand((R, n), generator=g,
                                         device=device) - 1.0)
    w_res = ro["reservoir_scale"] * torch.randn((R, n_out, n), generator=g,
                                                device=device)
    if r["ml_only"]:
        wout = w_res
    else:
        eye = torch.eye(n_out, device=device) * ro["model_block"]
        wout = torch.cat([eye.expand(R, n_out, n_out), w_res], dim=-1)
    del w_res
    x0 = r["x0_scale"] * torch.randn((R, n), generator=g, device=device)
    return dict(a_val=a_val, shifts=ring_shifts(n, deg), win=win,
                wout=wout.contiguous(), x0=x0,
                node_map=torch.arange(n, device=device) // (n // n_in),
                leakage=r["leakage"])


def write_boundary(cfg: dict, seed: int, root: str) -> str:
    """Seeded stand-in boundary files (orography, land-sea mask, monthly
    climatologies) in a new directory under `root`."""
    m = cfg["model"]
    d = os.path.join(root, "boundary")
    os.makedirs(d, exist_ok=True)
    return write_synthetic_boundary(d, int(seed) & SEED_MASK, ix=m["ix"],
                                    il=m["il"])


class Start:
    """The start state and the standardizer of a configuration: the
    model's state of rest at the first date, and per-element means (that
    state, packed) and spreads (the configuration's scale of each
    variable, packed), as float32 tensors on `device`."""

    def __init__(self, cfg: dict, bindir: str, device):
        m = cfg["model"]
        self.L = layout(cfg)
        atmo, logp = start_state(cfg, bindir)
        self.atmo = atmo.to(device, F32)
        self.logp = logp.to(device, F32)
        self.pr = torch.zeros_like(self.logp)
        tables = build_tables(m["ntrun"], m["ix"], m["il"])
        clim = build_climatology(bindir, tables.gcos, tables.radang)
        self.date = ModelDate(*m["start"])
        sst, tisr = boundary_host(clim, tables, self.date, m["ix"])

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        ss = torch.clamp(dev(sst), min=SST_MIN)
        gv0 = pack_global(self.L, self.atmo, self.logp, self.pr, ss,
                          dev(tisr))
        sc = cfg["scales"]
        ones = torch.ones_like(self.logp)
        scale3d = torch.stack([sc[k] * torch.ones_like(self.atmo[0])
                               for k in ("t", "u", "v", "q")])
        gvs = pack_global(self.L, scale3d, sc["logp"] * ones,
                          sc["precip"] * ones, sc["sst"] * ones,
                          sc["tisr"] * ones)
        idx = torch.as_tensor(self.L.input_index, dtype=torch.int64,
                              device=device)
        tidx = torch.as_tensor(self.L.target_index, dtype=torch.int64,
                               device=device)
        self.stz = dict(in_mean=gv0[idx], in_std=gvs[idx],
                        out_mean=gv0[tidx], out_std=gvs[tidx])


def members(start: Start, x0, E: int, amplitude: float, seed: int):
    """E members around the start state: the reservoir state and the fields
    repeated, every member's fields but the first perturbed by
    `amplitude` * N(0, 1) (seeded; q kept at or above QMIN)."""
    dev = start.atmo.device
    g = torch.Generator(device=dev).manual_seed(
        (int(seed) ^ 0x5A5A5A5A) & SEED_MASK)
    atmo = start.atmo[None].repeat(E, 1, 1, 1, 1)
    atmo[1:] += amplitude * torch.randn(atmo[1:].shape, generator=g,
                                        device=dev)
    atmo[:, 3] = torch.clamp(atmo[:, 3], min=QMIN)
    return (x0[None].repeat(E, 1, 1), atmo,
            start.logp[None].repeat(E, 1, 1),
            start.pr[None].repeat(E, 1, 1))
