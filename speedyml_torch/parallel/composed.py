"""The whole hybrid step over one mesh axis (PyTorch port of
speedyml/parallel/composed.py).

The replacement of the reference's per-step MPI cycle
(src/mpires.f90:218-804: gather the outputs to rank 0, rebuild the global
grids, run SPEEDY serially on rank 0, scatter halo'd inputs and forecasts
back):

  pack -> latitude-sharded SPEEDY window -> all-gather of the forecast grid
  -> pack the forecast -> region-sharded reservoir step -> all-gather of
  the region outputs -> scatter

One mesh axis serves both roles: the region count R (1152) and the
latitude count il (48) are each divisible by any practical rank count, and
the window and the reservoir use the ranks one after the other (the
reservoir reads the window's forecast). The JAX package writes the step as
one jitted program and lets XLA place its all-gathers; here each rank runs
it eagerly, and its collectives are, per step:

  * all_reduce: one per forward transform of the window (parallel.spatial;
    4 per dycore step and 5 for the injection), and one of the safety
    flags, whose sum must be the rank count (the broadcast abort of
    mpires.f90:744);
  * all_gather: the forecast grid (every field of the window's end, and its
    precipitation, in one tensor), and the region outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..domain.decomposition import scatter_outputs
from ..domain.standardize import (Standardizer, standardize_in,
                                  standardize_out, unstandardize_out)
from ..hybrid.experiment import HybridRunner, atmo_to_grid
from ..hybrid.forecast import SpeedyForecaster
from ..hybrid.state_io import GridState
from ..reservoir.esn import predict_step
from .mesh import Mesh, Placement, shard
from .spatial import _localize_dycore, _localize_physics, lat_slice


class ComposedHybridStep:
    """The hybrid step over one mesh axis, on every rank of it.

    hm: a trained HybridModel (not ml_only), whole on this rank's device;
    speedy: the model that provides the window; axis: the mesh axis that
    splits latitude in the window and regions in the reservoir step (None:
    the mesh's first); physics=False gives the dry window.
    """

    def __init__(self, hm, speedy, mesh: Mesh, axis: Optional[str] = None,
                 physics: bool = True):
        if hm.ml_only:
            raise ValueError("the composed step is the hybrid exchange")
        self.hm = hm
        self.speedy = speedy
        self.mesh = mesh
        self.axis = axis if axis is not None else mesh.axis_names[0]
        self.n_shards = mesh.shape[self.axis]
        self.shard = mesh.coord(self.axis)
        self.comm = mesh.comm(self.axis)
        cfg = speedy.config
        if cfg.il % self.n_shards:
            raise ValueError(f"{self.n_shards} ranks do not divide "
                             f"il={cfg.il}")
        if hm.layout.R % self.n_shards:
            raise ValueError(f"{self.n_shards} ranks do not divide "
                             f"R={hm.layout.R}")
        self.fc = SpeedyForecaster(speedy, hours=hm.rcfg.timestep,
                                   physics=physics)
        self.runner = HybridRunner(hm, self.fc)
        self.jl = cfg.il // self.n_shards
        self.loc = _localize_dycore(speedy.dy, self.comm, self.n_shards,
                                    self.shard)
        self.ploc = _localize_physics(speedy.phys, self.n_shards, self.shard)
        self._placed = None

    def place(self):
        """This rank's block of regions of the trained parameters, the
        standardizer and the two gather maps: (params, stz, idx, tidx)."""
        hm = self.hm
        regions = Placement(self.mesh, (self.axis,))
        p = hm.params
        params = dataclasses.replace(
            p, **{k: shard(getattr(p, k), regions)
                  for k in ("a_idx", "a_val", "win", "wout")})
        stz = Standardizer(*(shard(f, regions) for f in hm.stz))
        idx, tidx = hm.layout.maps(p.win.device)
        return params, stz, shard(idx, regions), shard(tidx, regions)

    def shard_surface(self, tree):
        """This rank's latitude block of a surf tree."""
        return lat_slice(tree, self.speedy.config.il, self.shard,
                         self.n_shards)

    def step(self, x, atmo, logp, precip_t, sst, tisr, surf, forcing):
        """One composed hybrid step. x: this rank's block of regions of the
        reservoir state; atmo, logp, precip_t, sst, tisr and forcing whole;
        surf this rank's latitude block (shard_surface). Returns (x', atmo',
        logp', precip_t', safe): x' this rank's block, the grids whole (the
        same on every rank), safe the global safety flag (a 0-d bool
        tensor)."""
        if self._placed is None:
            self._placed = self.place()
        params, stz, idx, tidx = self._placed
        cfg = self.speedy.config
        kx = cfg.kx
        runner = self.runner
        gv = runner.pack(atmo, logp, precip_t, sst, tisr)

        gs = lat_slice(atmo_to_grid(atmo, logp), cfg.il, self.shard,
                       self.n_shards)
        res = self.fc.window(gs, surf, forcing, dy=self.loc, phys=self.ploc,
                             il=self.jl)
        flags = self.comm.all_reduce(res.safe.to(torch.float32))
        safe = flags >= self.n_shards
        g = res.gs
        grid = self.comm.all_gather(torch.cat(
            [g.t, g.u, g.v, g.q, g.logp[None], res.precip_mm[None]]), dim=1)
        fgs = GridState(t=grid[:kx], u=grid[kx:2 * kx],
                        v=grid[2 * kx:3 * kx], q=grid[3 * kx:4 * kx],
                        logp=grid[4 * kx])
        model_gv = runner.pack_forecast(fgs, grid[4 * kx + 1], sst, tisr)

        u = standardize_in(stz, gv[idx])
        mv = standardize_out(stz, model_gv[tidx])
        x, out_std = predict_step(params, x, u, mv)
        out = self.comm.all_gather(unstandardize_out(stz, out_std), dim=0)
        atmo2, logp2, pr2 = scatter_outputs(self.hm.layout, out)
        atmo2, pr2 = self.hm._clamp(atmo2, pr2)
        return x, atmo2, logp2, pr2, safe


def single_device_step(hm, fc, x, atmo, logp, precip_t, sst, tisr, surf,
                       forcing):
    """The same hybrid step on one device, what ComposedHybridStep is held
    against: pack, the window of `fc` on the whole grid under (surf,
    forcing), the forecast packed as HybridRunner.forecast_gv packs it,
    HybridModel.step. Returns (x', atmo', logp', precip_t', safe)."""
    runner = HybridRunner(hm, fc)
    gv = runner.pack(atmo, logp, precip_t, sst, tisr)
    res = fc.window(atmo_to_grid(atmo, logp), surf, forcing)
    model_gv = runner.pack_forecast(res.gs, res.precip_mm, sst, tisr)
    return (*hm.step(x, gv, model_gv), res.safe)
