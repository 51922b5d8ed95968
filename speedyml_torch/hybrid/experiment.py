"""Hybrid training and prediction (PyTorch port of the dry-window slice of
speedyml/hybrid/experiment.py).

The global state lives in ONE packed supervector on the device; reservoir
input packing is a gather, output scattering a reshape, and the SPEEDY
window forecast runs on the same device (parallelmain.f90:30-282 and
mpires.f90:218-804 redesigned).

Data contract (the reference's unit fixes, mod_reservoir.f90:322-603):
  * atmo3d variables (T, u, v, q[g/kg]) with q clamped >= QMIN,
  * precip -> log(1 + P/eps), eps = precip_epsilon (mod_reservoir.f90:44),
  * sst clamped >= 272 K, tisr clamped >= 0.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.calendar import ModelDate
from ..core.config import ReservoirConfig
from ..domain.decomposition import (RegionLayout, gather_inputs,
                                    gather_targets, pack_global,
                                    scatter_outputs)
from ..domain.standardize import (Standardizer, compute_stats_gv,
                                  standardize_in, standardize_out,
                                  unstandardize_out)
from ..reservoir.esn import EsnParams, predict_step, synchronize
from ..reservoir.generate import generate_esn, radius_by_lat
from ..reservoir.training import (drive_and_accumulate, drive_discard,
                                  init_normal_eq, ridge_solve)
from .forecast import SpeedyForecaster
from .state_io import GridState

QMIN = 1e-6     # q floor [g/kg] (reference training-data clamp)
SST_MIN = 272.0
# fallback ceiling [mm per window] for the PREDICTED log-precip channel;
# train_hybrid replaces it with the training series' own maximum
PRECIP_MM_CAP = 40.0


def clamp_precip_t(pr_t, eps: float, cap_mm: float = PRECIP_MM_CAP):
    """Clamp the transformed log-precip channel to [0, log1p(cap/eps)]."""
    return torch.clamp(pr_t, 0.0, math.log1p(cap_mm / eps))


def transform_and_pack(layout: RegionLayout, atmo, logp, precip, sst, tisr,
                       eps: float) -> torch.Tensor:
    """Apply the reference's unit fixes and pack to (T, gv_len) float32, on
    the tensors' device. atmo: (T, 4, kx, il, ix); the rest (T, il, ix)."""
    f32 = torch.float32
    T = atmo.shape[0]
    a = atmo.to(f32).clone()
    a[:, 3] = torch.clamp(a[:, 3], min=QMIN)
    pr = torch.log1p(torch.clamp(precip, min=0.0) / eps).to(f32)
    ss = torch.clamp(sst, min=SST_MIN).to(f32)
    ti = torch.clamp(tisr, min=0.0).to(f32)
    gv = torch.empty((T, layout.gv_len), dtype=f32, device=atmo.device)
    s = layout.gv_sizes
    gv[:, s["atmo3d"][0]:s["atmo3d"][1]] = a.reshape(T, -1)
    gv[:, s["logp"][0]:s["logp"][1]] = logp.reshape(T, -1).to(f32)
    for name, arr in (("precip", pr), ("sst", ss), ("tisr", ti)):
        t0, t1 = s[name]
        if t1 > t0:
            gv[:, t0:t1] = arr.reshape(T, -1)
    return gv


def grid_to_atmo(gs: GridState) -> torch.Tensor:
    """GridState -> (4, kx, il, ix) in the reference variable order."""
    return torch.stack([gs.t, gs.u, gs.v, gs.q])


def atmo_to_grid(atmo, logp) -> GridState:
    return GridState(t=atmo[0], u=atmo[1], v=atmo[2],
                     q=torch.clamp(atmo[3], min=0.0), logp=logp)


# ----------------------------------------------------------------------
# the trained hybrid model
# ----------------------------------------------------------------------
@dataclasses.dataclass
class HybridModel:
    """Trained per-region reservoirs + standardization + layout."""

    layout: RegionLayout
    params: EsnParams
    stz: Standardizer
    rcfg: ReservoirConfig
    ml_only: bool = False

    def step(self, x, gv, model_gv=None):
        """One reservoir step on the packed supervector gv (gv_len,):
        standardize, advance + read out, unstandardize, scatter to the grid
        (experiment.py:184-211). Returns (x, atmo, logp, precip_t)."""
        L = self.layout
        u = standardize_in(self.stz, gather_inputs(L, gv))
        if self.ml_only:
            model_vec = None
        else:
            if model_gv is None:
                raise ValueError("a hybrid step needs the model forecast")
            model_vec = standardize_out(self.stz, gather_targets(L, model_gv))
        x, out_std = predict_step(self.params, x, u, model_vec)
        out = unstandardize_out(self.stz, out_std)
        atmo, logp, precip_t = scatter_outputs(L, out)
        # physical sanity clamps (mpires.f90:456-462)
        atmo = torch.cat([atmo[:3], torch.clamp(atmo[3:], min=QMIN)])
        if precip_t is not None:
            precip_t = clamp_precip_t(precip_t, self.rcfg.precip_epsilon,
                                      self.rcfg.precip_cap_mm)
        return x, atmo, logp, precip_t

    def synchronize(self, gv_series, x=None):
        """Drive the reservoirs with true data (mod_reservoir.f90:1354-1416)."""
        if x is None:
            x = torch.zeros((self.layout.R, self.params.n),
                            dtype=torch.float32, device=gv_series.device)
        u = standardize_in(self.stz, gather_inputs(self.layout, gv_series))
        return synchronize(self.params, x, u)


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def _block_generator(device, seed: int, bi: int, k: int) -> torch.Generator:
    """Noise stream k of region block bi: a pure function of (seed, bi, k)."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + bi) * 2 + k)


def train_hybrid(layout: RegionLayout, rcfg: ReservoirConfig,
                 gv_truth: torch.Tensor, gv_model: Optional[torch.Tensor],
                 seed: int = 0, region_block: int = 0, chunk: int = 64,
                 verbose: bool = False) -> HybridModel:
    """Train all regions' readouts by blocked normal-equation accumulation.

    gv_truth: (T, gv_len) transformed truth series, on the training device.
    gv_model: (T, gv_len) imperfect-model forecasts valid at each index
              (hybrid) or None (ml_only).
    region_block: regions trained per pass (0 = all at once); the
    (Rb, na, na) normal equations and their f64 solve bound it.
    """
    dev = gv_truth.device
    R = layout.R
    ml_only = gv_model is None
    Tn = gv_truth.shape[0]
    discard = max(1, rcfg.discardlength // rcfg.timestep)
    if Tn <= discard + 2:
        raise ValueError(f"training series of {Tn} is not longer than the "
                         f"discard of {discard} + 2")

    # record the training support of the precip channel: predictions are
    # clamped to it (clamp_precip_t)
    p0, p1 = layout.gv_sizes.get("precip", (0, 0))
    if p1 > p0:
        pmax = float(rcfg.precip_epsilon
                     * np.expm1(float(gv_truth[:, p0:p1].max())))
        rcfg = dataclasses.replace(rcfg, precip_cap_mm=max(pmax, 1.0))

    stz = compute_stats_gv(layout, gv_truth)
    idx, tidx = layout.maps(dev)
    radii = radius_by_lat(layout.lat_region_deg[:, 0],
                          layout.lat_region_deg[:, 1],
                          max_radius=rcfg.radius_high,
                          min_radius=rcfg.radius_low)
    blocks = [np.arange(R)] if region_block in (0, R) else [
        np.arange(i, min(i + region_block, R))
        for i in range(0, R, region_block)]

    n_model = 0 if ml_only else layout.n_out
    wout_all = None
    idx_parts, val_parts, win_parts, shifts = [], [], [], []
    t_start = time.perf_counter()
    for bi, blk in enumerate(blocks):
        Rb = len(blk)
        params = generate_esn(seed + 17 * bi, Rb, layout.n_in, layout.n_out,
                              n_model, m_target=rcfg.nodes_per_input,
                              deg=rcfg.degree, sigma=rcfg.sigma,
                              leakage=rcfg.leakage, radii=radii[blk],
                              device=dev)
        b = torch.as_tensor(blk, device=dev)
        u_blk = (gv_truth[:, idx[b]] - stz.in_mean[b]) / stz.in_std[b]
        y_blk = (gv_truth[:, tidx[b]] - stz.out_mean[b]) / stz.out_std[b]
        m_blk = None if ml_only else \
            (gv_model[:, tidx[b]] - stz.out_mean[b]) / stz.out_std[b]

        x = torch.zeros((Rb, params.n), dtype=torch.float32, device=dev)
        x = drive_discard(params, x, u_blk[:discard],
                          noise_mag=rcfg.noise_std,
                          generator=_block_generator(dev, seed, bi, 0))
        acc = init_normal_eq(params, layout.n_out)._replace(x=x)
        # pairs: state after u(t) vs target(t+1), t = discard..T-2
        acc = drive_and_accumulate(
            params, acc, u_blk[discard:-1], y_blk[discard + 1:],
            None if ml_only else m_blk[discard + 1:],
            noise_mag=rcfg.noise_std,
            generator=_block_generator(dev, seed, bi, 1), chunk=chunk)
        wout = ridge_solve(acc, n_model, rcfg.beta_res, rcfg.beta_model,
                           prior_val=rcfg.prior_val,
                           use_prior=rcfg.prior_val != 0.0)
        del acc
        if wout_all is None:
            wout_all = torch.empty((R,) + tuple(wout.shape[1:]),
                                   dtype=torch.float32, device=dev)
        wout_all[b] = wout.to(torch.float32)
        del wout
        idx_parts.append(params.a_idx)
        val_parts.append(params.a_val)
        win_parts.append(params.win)
        shifts.append(params.a_shift)
        if verbose:
            el = time.perf_counter() - t_start
            print(f"  train block {bi + 1}/{len(blocks)} ({Rb} regions): "
                  f"{el:.1f} s, {el / (bi + 1):.2f} s/block", flush=True)

    # all blocks of one reservoir geometry share the circulant shifts
    a_shift = shifts[0] if all(s == shifts[0] for s in shifts) else None
    params_all = EsnParams(a_idx=torch.cat(idx_parts),
                           a_val=torch.cat(val_parts),
                           win=torch.cat(win_parts), wout=wout_all,
                           node_map=params.node_map, leakage=rcfg.leakage,
                           a_shift=a_shift)
    return HybridModel(layout=layout, params=params_all, stz=stz, rcfg=rcfg,
                       ml_only=ml_only)


# ----------------------------------------------------------------------
# prediction
# ----------------------------------------------------------------------
class HybridRunner:
    """The dry-window prediction loop (parallelmain.f90:206-273): per hybrid
    timestep, the SPEEDY window from the current state, then the reservoir
    step on [state; forecast]. SST and TISR come from the caller's sst_fn
    and tisr_fn (speedyml HybridRunner.run contract), since the dry window
    has no climatology."""

    def __init__(self, hm: HybridModel, fc: Optional[SpeedyForecaster]):
        if not hm.ml_only and fc is None:
            raise ValueError("a hybrid model needs a forecaster")
        self.hm = hm
        self.fc = fc
        self.eps = hm.rcfg.precip_epsilon

    def pack(self, atmo, logp, precip_t, sst, tisr) -> torch.Tensor:
        """Global fields -> packed f32 supervector, with the SST/TISR unit
        fixes."""
        f32 = torch.float32
        dev = atmo.device
        ss = torch.clamp(torch.as_tensor(sst, dtype=f32, device=dev),
                         min=SST_MIN)
        ti = torch.clamp(torch.as_tensor(tisr, dtype=f32, device=dev),
                         min=0.0)
        return pack_global(self.hm.layout, atmo.to(f32), logp.to(f32),
                           None if precip_t is None else precip_t.to(f32),
                           ss, ti)

    def forecast_gv(self, atmo, logp, sst, tisr):
        """The window from (atmo, logp) packed as the model supervector, and
        the window's safety flag (a 0-d bool tensor)."""
        res = self.fc.forecast(atmo_to_grid(atmo, logp))
        f_atmo = torch.stack([res.gs.t, res.gs.u, res.gs.v,
                              torch.clamp(res.gs.q, min=QMIN)])
        f_pr = torch.log1p(torch.clamp(res.precip_mm, min=0.0) / self.eps)
        return self.pack(f_atmo, res.gs.logp, f_pr, sst, tisr), res.safe

    def run(self, x, atmo0, logp0, precip_t0, date: ModelDate, n_steps: int,
            sst_fn: Callable, tisr_fn: Callable) -> dict:
        """Run n_steps hybrid steps from transformed global fields.

        sst_fn(date), tisr_fn(date) -> (il, ix) boundary fields. Returns a
        dict of stacked trajectory tensors (atmo, logp, precip_mm, sst), the
        final reservoir state x and transformed precip precip_t (to resume
        from), the date, and `aborted`: the loop stops
        early when the window's safety gate trips (ppo_iogrid.f90:563-577 ->
        mpires.f90:744), which costs one device sync per step.
        """
        hm = self.hm
        dev = x.device
        f32 = torch.float32
        atmo = torch.as_tensor(atmo0, dtype=f32, device=dev)
        logp = torch.as_tensor(logp0, dtype=f32, device=dev)
        precip_t = None if precip_t0 is None else \
            torch.as_tensor(precip_t0, dtype=f32, device=dev)
        date = ModelDate(date.iyear, date.imonth, date.iday, date.ihour)
        traj = {k: [] for k in ("atmo", "logp", "precip_mm", "sst")}
        aborted = False
        for _ in range(n_steps):
            sst = torch.as_tensor(sst_fn(date), dtype=f32, device=dev)
            tisr = torch.as_tensor(tisr_fn(date), dtype=f32, device=dev)
            gv = self.pack(atmo, logp, precip_t, sst, tisr)
            model_gv = None
            if not hm.ml_only:
                model_gv, safe = self.forecast_gv(atmo, logp, sst, tisr)
                if not bool(safe):
                    aborted = True
                    break
            x, atmo, logp, precip_t = hm.step(x, gv, model_gv)
            date.advance_hours(hm.rcfg.timestep)
            traj["atmo"].append(atmo)
            traj["logp"].append(logp)
            traj["precip_mm"].append(
                None if precip_t is None
                else self.eps * torch.expm1(torch.clamp(precip_t, min=0.0)))
            traj["sst"].append(sst)
        out = {k: (torch.stack(v) if v and v[0] is not None else None)
               for k, v in traj.items()}
        out.update(x=x, precip_t=precip_t, date=date, aborted=aborted)
        return out
