"""The slab ocean's inputs, made from the run's seed: its reservoirs and
readout, its standardizer, its start state and the active regions.

Like harness/inputs.py, everything is drawn on the run's device by one
torch.Generator (its own stream of the seed) in float32, and the reference
draws it again rather than reading the program's copies. The ocean's input
map comes from the reference's own layout code (reference/coupled.py).
"""

from __future__ import annotations

import numpy as np
import torch

from reference.coupled import ocean_maps
from reference.hybrid import SST_MIN, boundary_host
from reference.speedy.coupler.climatology import build_climatology
from reference.speedy.domain.decomposition import pack_global
from reference.speedy.transforms.tables import build_tables

from .inputs import SEED_MASK, ring_shifts

# the ocean's stream of the run's seed, apart from the atmosphere's
OCEAN_STREAM = 0x0CEA0


def start_fields(cfg: dict, bindir: str, start):
    """(gv0, gvs, sea, sst): the packed start state and the packed scales
    (as harness/inputs.Start packs them for the atmosphere's standardizer),
    the grid's sea fraction and the start date's SST (host float64)."""
    m = cfg["model"]
    L = start.L
    dev = start.atmo.device
    tables = build_tables(m["ntrun"], m["ix"], m["il"])
    clim = build_climatology(bindir, tables.gcos, tables.radang)
    sst, tisr = boundary_host(clim, tables, start.date, m["ix"])

    def on_dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    gv0 = pack_global(L, start.atmo, start.logp, start.pr,
                      torch.clamp(on_dev(sst), min=SST_MIN), on_dev(tisr))
    sc = cfg["scales"]
    ones = torch.ones_like(start.logp)
    scale3d = torch.stack([sc[k] * torch.ones_like(start.atmo[0])
                           for k in ("t", "u", "v", "q")])
    gvs = pack_global(L, scale3d, sc["logp"] * ones, sc["precip"] * ones,
                      sc["sst"] * ones, sc["tisr"] * ones)
    return gv0, gvs, np.asarray(clim.fmask_s, np.float64), sst


def active_regions(L, sea, sst) -> np.ndarray:
    """(R_o,) bool: the regions whose core points are all sea (sea fraction
    at least 0.5) and above the 272 K floor of the SST input at the start
    date, standing in for the training-variance threshold (land and
    ice-covered points have no SST variance)."""
    _, tgt, _ = ocean_maps(L)
    pts = tgt - L.gv_sizes["sst"][0]
    return ((sea.reshape(-1)[pts] >= 0.5)
            & (sst.reshape(-1)[pts] > SST_MIN)).all(axis=1)


def make_ocean(cfg: dict, start, bindir: str, seed: int, device) -> dict:
    """The ocean's reservoirs, readout, standardizer, start state and
    active regions, float32 on `device`:

    * adjacency: `degree` circulant shifts per node with uniform(0, 1)
      values, each row scaled to sum to `radius`, except the rows of the
      nodes that read an SST core input, which are zero: those nodes hold
      tanh(Win u) of their input alone;
    * Win: slab_sigma * uniform(-1, 1), n_o / n_in nodes per input;
    * Wout (R_o, ncore, n_o): persistence, the even nodes of each core's
      SST input weighted win / sum(win^2) so that the readout gives back
      the standardized input where tanh is linear, plus
      `reservoir_scale` * N(0, 1) on every node;
    * standardizer: means the packed start state at the inputs and the
      targets, spreads the configuration's scales;
    * x0: `x0_scale` * N(0, 1).
    """
    o = cfg["ocean"]
    L = start.L
    inp, tgt, core = ocean_maps(L)
    R, n_in = inp.shape
    ncore = tgt.shape[1]
    # n_o = round(slab_nodes / n_in) * n_in (mod_slab_ocean_reservoir.f90)
    q = max(1, int(round(o["slab_nodes"] / n_in)))
    n = q * n_in
    deg = o["degree"]
    g = torch.Generator(device=device).manual_seed(
        (int(seed) ^ OCEAN_STREAM) & SEED_MASK)
    a_val = torch.rand((R, n, deg), generator=g, device=device)
    a_val = a_val * (o["radius"] / a_val.sum(dim=-1, keepdim=True))
    win = o["slab_sigma"] * (2.0 * torch.rand((R, n), generator=g,
                                              device=device) - 1.0)
    wout = o["reservoir_scale"] * torch.randn((R, ncore, n), generator=g,
                                              device=device)
    x0 = o["x0_scale"] * torch.randn((R, n), generator=g, device=device)
    for c, pos in enumerate(core):
        nodes = torch.arange(pos * q, (pos + 1) * q, device=device)
        a_val[:, nodes] = 0.0
        even = nodes[nodes % 2 == 0]
        w = win[:, even]
        wout[:, c, even] += w / (w * w).sum(dim=-1, keepdim=True)
    idx = torch.as_tensor(inp, device=device)
    tidx = torch.as_tensor(tgt, device=device)
    gv0, gvs, sea, sst = start_fields(cfg, bindir, start)
    stz = dict(in_mean=gv0[idx], in_std=gvs[idx], out_mean=gv0[tidx],
               out_std=gvs[tidx])
    return dict(a_val=a_val, shifts=ring_shifts(n, deg), win=win,
                wout=wout.contiguous(), x0=x0,
                node_map=torch.arange(n, device=device) // q,
                leakage=o["slab_leakage"], stz=stz,
                active=active_regions(L, sea, sst))
