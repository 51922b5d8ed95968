"""Ensemble-batched hybrid stepping (PyTorch port of speedyml/hybrid/
ensemble.py): the whole hybrid step over E members at once.

The reference's operating mode is one trajectory (parallelmain.f90:206-273).
Here E members share one set of launches:

  * the window (pack, the SPEEDY window through `SpeedyForecaster.window`,
    the forecast pack) runs under `torch.func.vmap`, so each of its eager
    kernels does E members' grid work;
  * the reservoir part runs outside vmap on an explicit member axis: the
    advance broadcasts the shared adjacency and Win over (E, R, n), and the
    readout is ONE product (R, n_out, na) x (R, na, E), so the 3.7 GB wout
    is read once per step for all members (a readout under vmap would
    expand the weights per member).

Members share the weights, the statistics and the boundary forcing (SST,
TISR, surface state per date); the reservoir state and the atmospheric
fields are per member.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.calendar import ModelDate
from ..coupler.daily import init_coupler_state
from ..device import to_host
from ..domain.decomposition import pack_global, scatter_outputs
from ..domain.standardize import (standardize_in, standardize_out,
                                  unstandardize_out)
from ..physics.radiation import diurnal_tisr
from ..reservoir.esn import predict_step
from ..utils import diag
from .experiment import QMIN, SST_MIN, clamp_precip_t
from .forecast import SpeedyForecaster
from .state_io import GridState


class EnsembleHybrid:
    """The hybrid step over an ensemble axis E (hybrid models only)."""

    def __init__(self, hm, fc: SpeedyForecaster):
        if hm.ml_only:
            raise ValueError("the ensemble step batches the hybrid exchange; "
                             "an ML-only model has none")
        self.hm = hm
        self.fc = fc
        self.eps = hm.rcfg.precip_epsilon
        self._windows = torch.func.vmap(
            self._member_window, in_dims=(0, 0, 0, None, None, None, None))

    def _member_window(self, atmo, logp, precip_t, ss, ti, surf, forcing):
        """One member's packed state, its packed window forecast and the
        window's safety flag."""
        L = self.hm.layout
        f32 = torch.float32
        gv = pack_global(L, atmo, logp, precip_t, ss, ti)
        gs = GridState(t=atmo[0], u=atmo[1], v=atmo[2],
                       q=torch.clamp(atmo[3], min=0.0), logp=logp)
        res = self.fc.window(gs, surf, forcing)
        f_atmo = torch.stack([res.gs.t, res.gs.u, res.gs.v,
                              torch.clamp(res.gs.q, min=QMIN)])
        f_pr = torch.log1p(torch.clamp(res.precip_mm, min=0.0) / self.eps)
        model_gv = pack_global(L, f_atmo.to(f32), res.gs.logp.to(f32),
                               f_pr.to(f32), ss, ti)
        return gv, model_gv, res.safe

    def _dev32(self, a):
        return torch.as_tensor(a, dtype=torch.float32,
                               device=self.hm.params.win.device)

    def forecast(self, atmo_e, logp_e, precip_t_e, sst, tisr, surf,
                 forcing):
        """The members' windows: (gv_e, model_gv_e, safe_e), the packed
        states (E, gv_len), their packed forecasts and the windows' safety
        flags (E,)."""
        with diag.span("ensemble.window", device=True):
            ss = torch.clamp(self._dev32(sst), min=SST_MIN)
            ti = torch.clamp(self._dev32(tisr), min=0.0)
            return self._windows(self._dev32(atmo_e), self._dev32(logp_e),
                                 self._dev32(precip_t_e), ss, ti, surf,
                                 forcing)

    def exchange(self, x_e, gv_e, model_gv_e):
        """The reservoir part for all members: standardize, advance and
        read out (one product for all members), unstandardize, scatter,
        clamp. Returns (x_e, atmo_e, logp_e, precip_t_e)."""
        hm = self.hm
        L = hm.layout
        with diag.span("ensemble.exchange", device=True):
            with diag.span("ensemble.exchange.pack", device=True):
                idx, tidx = L.maps(gv_e.device)
                u = standardize_in(hm.stz, gv_e[:, idx])      # (E, R, n_in)
                mv = standardize_out(hm.stz, model_gv_e[:, tidx])
                x_e = self._dev32(x_e)
            x_e, out_std = predict_step(hm.params, x_e, u, mv)
            with diag.span("ensemble.exchange.unpack", device=True):
                out = unstandardize_out(hm.stz, out_std)
                atmo, logp, pr = torch.func.vmap(
                    lambda o: scatter_outputs(L, o))(out)
                atmo = torch.cat([atmo[:, :3],
                                  torch.clamp(atmo[:, 3:], min=QMIN)], dim=1)
                if pr is not None:
                    pr = clamp_precip_t(pr, self.eps, hm.rcfg.precip_cap_mm)
        return x_e, atmo, logp, pr

    def step(self, x_e, atmo_e, logp_e, precip_t_e, sst, tisr, surf,
             forcing):
        """One ensemble hybrid step.

        x_e (E, R, n); atmo_e (E, 4, kx, il, ix); logp_e/precip_t_e
        (E, il, ix); sst/tisr (il, ix) shared, numpy or tensors; surf and
        forcing the window's boundary state (fc._surf_forcing). Returns
        (x_e, atmo_e, logp_e, precip_t_e, safe_e) with safe_e (E,) bool."""
        gv, model_gv, safe = self.forecast(atmo_e, logp_e, precip_t_e, sst,
                                           tisr, surf, forcing)
        return (*self.exchange(x_e, gv, model_gv), safe)

    # ------------------------------------------------------------------
    @diag.loop("ensemble")
    def run(self, x_e, atmo_e, logp_e, precip_t_e, date: ModelDate,
            n_steps: int, sst_fn=None, verbose: int = 0,
            collect: bool = True) -> dict:
        """Ensemble prediction loop (the batched parallelmain.f90:206-273).

        Boundary SST (climatology, or sst_fn(date)) and diurnal TISR per
        date, and one boundary state (_surf_forcing) per date for all
        members; members evolve independently. An unsafe member makes the
        run abort (the reference's global gate, mpires.f90:744). Returns a
        dict: per-member trajectories (E on axis 1) as host numpy if
        collect, the final x, `aborted`, the date reached, and `final`
        (atmo_e, logp_e, precip_t_e)."""
        fc = self.fc
        sp = fc.speedy
        date = ModelDate(date.iyear, date.imonth, date.iday, date.ihour)
        traj = {k: [] for k in ("atmo", "logp", "precip_t")}
        aborted = False
        for step_i in range(n_steps):
            with diag.span("ensemble.boundary", index=step_i):
                sst = np.asarray(init_coupler_state(sp.clim, date).sst_am)
                if sst_fn is not None:
                    sst = sst_fn(date)
                tisr = diurnal_tisr(date.tyear, date.ihour,
                                    sp.dy.tables.gsin, sp.dy.tables.gcos,
                                    sp.config.ix)
                surf, forcing = fc._surf_forcing(date, sst_hybrid=sst)
            with diag.span("ensemble.step", index=step_i):
                x_e, atmo_e, logp_e, precip_t_e, safe = self.step(
                    x_e, atmo_e, logp_e, precip_t_e, sst, tisr, surf,
                    forcing)
            date.advance_hours(self.hm.rcfg.timestep)
            with diag.span("ensemble.flag_wait", index=step_i):
                all_safe = bool(safe.all())
            if not all_safe:
                aborted = True
                break
            if collect:
                traj["atmo"].append(to_host(atmo_e))
                traj["logp"].append(to_host(logp_e))
                traj["precip_t"].append(to_host(precip_t_e))
            if verbose and (step_i + 1) % verbose == 0:
                print(f"  ensemble step {step_i + 1}/{n_steps}", flush=True)
        out = {k: (np.stack(v) if v else None) for k, v in traj.items()}
        out.update(x=x_e, aborted=aborted, date=date,
                   final=(atmo_e, logp_e, precip_t_e))
        return out
