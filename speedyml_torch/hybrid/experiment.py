"""Hybrid training and prediction (PyTorch port of speedyml/hybrid/
experiment.py: data collection, training and the per-step prediction loop
with its slab-ocean coupling, writers and checkpoints; hybrid/fastloop.py
holds the chunked loop for long runs).

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
import os
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.calendar import (ModelDate, datetime_from_hours,
                             hours_since_epoch)
from ..core.config import ReservoirConfig
from ..coupler.daily import init_coupler_state
from ..device import resolve_device, to_host
from ..domain.decomposition import (RegionLayout, gather_inputs,
                                    gather_targets, pack_global,
                                    scatter_outputs)
from ..domain.standardize import (Standardizer, compute_stats_gv,
                                  standardize_in, standardize_out,
                                  unstandardize_out)
from ..io.checkpoint import load_prediction, save_prediction
from ..physics.radiation import diurnal_tisr
from ..reservoir.esn import (EsnParams, advance, predict_step, readout_split,
                             synchronize)
from ..reservoir.generate import generate_esn, radius_by_lat, shifts_from_ell
from ..reservoir.slab import compose_week_inputs
from ..reservoir.training import (block_generator, drive_and_accumulate,
                                  drive_discard, fold_segment,
                                  init_normal_eq, ridge_solve)
from .forecast import SpeedyForecaster, TrajectoryRunner
from .state_io import GridState

QMIN = 1e-6     # q floor [g/kg] (reference training-data clamp)
SST_MIN = 272.0
# fallback ceiling [mm per window] for the PREDICTED log-precip channel;
# train_hybrid replaces it with the training series' own maximum
PRECIP_MM_CAP = 40.0


def clamp_precip_t(pr_t, eps: float, cap_mm: float = PRECIP_MM_CAP):
    """Clamp the transformed log-precip channel to [0, log1p(cap/eps)]."""
    return torch.clamp(pr_t, 0.0, math.log1p(cap_mm / eps))


class TruthSeries(NamedTuple):
    """A 6-hourly series on the device (the ERA5-training-set analog)."""

    atmo: torch.Tensor    # (T, nvars=4, kx, il, ix) order (T, u, v, q)
    logp: torch.Tensor    # (T, il, ix)
    precip: torch.Tensor  # (T, il, ix) raw mm per window
    sst: torch.Tensor     # (T, il, ix)
    tisr: torch.Tensor    # (T, il, ix)
    hours: np.ndarray     # (T,) hours since epoch per sample


def collect_truth(runner: TrajectoryRunner, n_samples: int) -> TruthSeries:
    """Advance the truth trajectory n_samples windows, recording each."""
    atmo, logp, precip, sst, tisr, hours = [], [], [], [], [], []
    for _ in range(n_samples):
        s = runner.advance()
        atmo.append(grid_to_atmo(s.gs))
        logp.append(s.gs.logp)
        precip.append(s.precip_mm)
        sst.append(s.sst)
        tisr.append(s.tisr)
        d = runner.date
        hours.append(hours_since_epoch(d.iyear, d.imonth, d.iday, d.ihour))
    dev, dtype = logp[0].device, logp[0].dtype
    return TruthSeries(
        atmo=torch.stack(atmo), logp=torch.stack(logp),
        precip=torch.stack(precip),
        sst=torch.as_tensor(np.stack(sst), dtype=dtype, device=dev),
        tisr=torch.as_tensor(np.stack(tisr), dtype=dtype, device=dev),
        hours=np.asarray(hours))


def collect_forecasts(fc: SpeedyForecaster, truth: TruthSeries):
    """Imperfect-model one-window forecasts from each truth state.

    Returns (atmo, logp, precip) tensors aligned so index t is the forecast
    VALID at truth sample t (launched from t-1); index 0 is a copy of truth
    (never used: training pairs start at t=1). This is the analog of the
    reference's precomputed "restart_6hour" SPEEDY states
    (speedy_res_interface.f90:637-723).
    """
    T = truth.atmo.shape[0]
    sst_host = truth.sst.double().cpu().numpy()
    atmo, logp = [truth.atmo[0]], [truth.logp[0]]
    precip = [torch.zeros_like(truth.precip[0])]
    for t in range(T - 1):
        y, m, d, h = datetime_from_hours(int(truth.hours[t]))
        date = ModelDate(iyear=y, imonth=m, iday=d, ihour=h)
        res = fc.forecast(atmo_to_grid(truth.atmo[t], truth.logp[t]), date,
                          sst_hybrid=sst_host[t])
        atmo.append(grid_to_atmo(res.gs))
        logp.append(res.gs.logp)
        precip.append(res.precip_mm)
    return torch.stack(atmo), torch.stack(logp), torch.stack(precip)


def transform_and_pack(layout: RegionLayout, atmo, logp, precip, sst, tisr,
                       eps: float, ohtc=None) -> torch.Tensor:
    """Apply the reference's unit fixes and pack to (T, gv_len) float32, on
    the tensors' device. atmo: (T, 4, kx, il, ix); the rest (T, il, ix).
    A section the layout has (ohtc with `use_ohtc=True`) must be given."""
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
    for name, arr in (("precip", pr), ("sst", ss), ("tisr", ti),
                      ("ohtc", ohtc)):
        t0, t1 = s.get(name, (0, 0))
        if t1 > t0:
            if arr is None:
                raise ValueError(f"{name} required by layout")
            gv[:, t0:t1] = torch.as_tensor(arr, device=atmo.device).to(
                f32).reshape(T, -1)
    return gv


def invert_precip(precip_t, eps: float):
    """log(1 + P/eps) -> P [mm]."""
    return eps * torch.expm1(torch.clamp(precip_t, min=0.0))


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
    # the ML-only readout (R, n_out, n) f32 of an also_ml training, on the
    # device of the weights (3.6 GB at reference width); see ml_variant
    wout_ml: Optional[torch.Tensor] = None

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
        atmo, precip_t = self._clamp(atmo, precip_t)
        return x, atmo, logp, precip_t

    def _clamp(self, atmo, precip_t):
        """Physical sanity clamps (mpires.f90:456-462): the q floor and the
        training support of the log-precip channel."""
        atmo = torch.cat([atmo[:3], torch.clamp(atmo[3:], min=QMIN)])
        if precip_t is not None:
            precip_t = clamp_precip_t(precip_t, self.rcfg.precip_epsilon,
                                      self.rcfg.precip_cap_mm)
        return atmo, precip_t

    def step_split(self, x, gv, model_gv):
        """step() plus the v_ml/v_p component grids (mod_reservoir.f90:
        1458-1469; shipped to disk by the reference via mpires.f90:
        1146-1547). The components are in physical units and satisfy
        atmo = atmo_ml + atmo_p before the clamps: the ML increment is
        std * v_ml, the SPEEDY part std * v_p + mean. Returns
        (x, atmo, logp, precip_t, comp) with comp a dict of atmo_ml,
        logp_ml, atmo_p, logp_p."""
        if self.ml_only:
            raise ValueError("the component split needs the model block")
        L = self.layout
        stz = self.stz
        u = standardize_in(stz, gather_inputs(L, gv))
        model_vec = standardize_out(stz, gather_targets(L, model_gv))
        x = advance(self.params, x, u)
        out_std, v_ml, v_p = readout_split(self.params, x, model_vec)
        atmo, logp, precip_t = scatter_outputs(
            L, unstandardize_out(stz, out_std))
        atmo, precip_t = self._clamp(atmo, precip_t)
        atmo_ml, logp_ml, _ = scatter_outputs(L, v_ml * stz.out_std)
        atmo_p, logp_p, _ = scatter_outputs(
            L, v_p * stz.out_std + stz.out_mean)
        comp = dict(atmo_ml=atmo_ml, logp_ml=logp_ml, atmo_p=atmo_p,
                    logp_p=logp_p)
        return x, atmo, logp, precip_t, comp

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
# device bytes a training block holds per entry of its (na, na) systems at
# the solve: the f32 hi/lo pair (8), the f64 system and its Cholesky factor
# (16), and one for the solver's workspace and the block's other tensors
# (an also_ml block of 48 regions at na=5896 peaked at 24.96 bytes an entry
# on an H100, PERF.md section 5)
SOLVE_BYTES_PER_ENTRY = 25
# the share of the free device memory a training block may budget for: its
# (na, na) systems, one drive segment and the series training keeps on the
# card
BLOCK_MEMORY_SHARE = 0.55


def segment_bytes(R: int, na: int, chunk: int) -> int:
    """Device bytes of one drive segment of a block of R regions on the
    card: its augmented states (reservoir.training.fold_segment steps) and
    the kernel's scratch for one of its launches (builds the kernel if it is
    not built yet)."""
    from ..ops import accum
    seg = fold_segment(R, na, chunk, "cuda")
    kseg = accum.segment_steps(R, na)
    return 4 * (seg * R * na
                + accum._load().accum_ss_scratch_floats(kseg, R, na))


def region_block_for(na: int, free_bytes: int, R: int, series_bytes: int = 0,
                     chunk: int = 128) -> int:
    """Regions per training block on the card, a multiple of 8:
    SOLVE_BYTES_PER_ENTRY of each (na, na) system per region, one drive
    segment (segment_bytes) and the series training keeps on the card
    (series_bytes), in BLOCK_MEMORY_SHARE of `free_bytes` (the device's free
    memory)."""
    per_region = na * na * SOLVE_BYTES_PER_ENTRY
    rb = min(R, int(BLOCK_MEMORY_SHARE * free_bytes / per_region)) // 8 * 8
    while rb > 8 and rb * per_region + segment_bytes(rb, na, chunk) \
            + series_bytes > BLOCK_MEMORY_SHARE * free_bytes:
        rb -= 8
    return max(1, rb)


def _load_block(path: str, also_ml: bool, dev) -> Optional[dict]:
    """A finished region block from its checkpoint file, as tensors on dev;
    None when the file is absent, or when an also_ml run finds it without
    the ML readout (the accumulator that readout needs is gone, so the block
    is trained again)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if also_ml and "wout_ml" not in z.files:
            return None
        part = {k: torch.as_tensor(z[k], device=dev)
                for k in ("wout", "a_val", "win")
                + (("wout_ml",) if also_ml else ())}
        part["a_idx"] = torch.as_tensor(z["a_idx"], dtype=torch.int64,
                                        device=dev)
        part["a_shift"] = (tuple(int(s) for s in z["a_shift"])
                           if "a_shift" in z.files else None)
        part["q"] = int(z["q"])
    return part


def _save_block(path: str, part: dict) -> None:
    """One region block in the JAX package's checkpoint file (the same
    keys and dtypes: a_idx int32, the rest float32), written atomically."""
    extra = {}
    if part["a_shift"] is not None:
        extra["a_shift"] = np.asarray(part["a_shift"], np.int32)
    if "wout_ml" in part:
        extra["wout_ml"] = to_host(part["wout_ml"])
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:           # atomic: write, then rename
        np.savez(fh, wout=to_host(part["wout"]),
                 a_idx=to_host(part["a_idx"]).astype(np.int32),
                 a_val=to_host(part["a_val"]), win=to_host(part["win"]),
                 q=part["q"], **extra)
    os.replace(tmp, path)


def train_hybrid(layout: RegionLayout, rcfg: ReservoirConfig,
                 gv_truth: torch.Tensor, gv_model: Optional[torch.Tensor],
                 seed: int = 0, region_block: int = 0, chunk: int = 64,
                 verbose: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 also_ml: bool = False) -> HybridModel:
    """Train all regions' readouts by blocked normal-equation accumulation.

    gv_truth: (T, gv_len) transformed truth series, on the training device.
    gv_model: (T, gv_len) imperfect-model forecasts valid at each index
              (hybrid) or None (ml_only).
    region_block: regions trained per pass (0 = all at once); the
    (Rb, na, na) normal equations and their f64 solve bound it.
    checkpoint_dir: if set, each finished region block is written there as
    `block_{bi:04d}.npz`, atomically, in the JAX package's format, and a
    block found there is loaded instead of trained. Generation and noise
    are pure functions of (seed, block), so a resumed run gives the
    uninterrupted run's model bitwise, and a JAX block directory gives the
    JAX weights.
    also_ml: also solve the ML-ONLY readout from the same normal equations.
    The augmented vector is [model; nodes], so the ML-only system
    (fit_chunk_ml, mod_reservoir.f90:1491-1535) is the trailing (n, n)
    sub-block of the hybrid's: one more f64 Cholesky per block, no second
    training pass. The readout is kept in `HybridModel.wout_ml` on the
    training device (3.6 GB in f32 at reference width); `ml_variant(hm)`
    serves it. An also_ml run that finds a block checkpoint without it
    trains that block again.

    The JAX package's `upload_dtype` (float16 host uploads) and
    `solver="device"` (emulated f64) are workarounds for a TPU behind a slow
    link and are not ported: the series is on the device already, and the
    ridge system is always solved in f64 on the device.
    """
    dev = gv_truth.device
    R = layout.R
    ml_only = gv_model is None
    if also_ml and ml_only:
        raise ValueError("also_ml needs a hybrid training run (gv_model)")
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
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)

    n_model = 0 if ml_only else layout.n_out
    solve = dict(beta_res=rcfg.beta_res, beta_model=rcfg.beta_model,
                 prior_val=rcfg.prior_val, use_prior=rcfg.prior_val != 0.0)
    readouts = {}                   # (R, ...) wout [and wout_ml], f32
    idx_parts, val_parts, win_parts, shifts = [], [], [], []
    t_start = time.perf_counter()
    for bi, blk in enumerate(blocks):
        Rb = len(blk)
        b = torch.as_tensor(blk, device=dev)
        ck = None if not checkpoint_dir else \
            os.path.join(checkpoint_dir, f"block_{bi:04d}.npz")
        part = None if ck is None else _load_block(ck, also_ml, dev)
        if part is None:
            params = generate_esn(seed + 17 * bi, Rb, layout.n_in,
                                  layout.n_out, n_model,
                                  m_target=rcfg.nodes_per_input,
                                  deg=rcfg.degree, sigma=rcfg.sigma,
                                  leakage=rcfg.leakage, radii=radii[blk],
                                  device=dev)
            u_blk = (gv_truth[:, idx[b]] - stz.in_mean[b]) / stz.in_std[b]
            y_blk = (gv_truth[:, tidx[b]] - stz.out_mean[b]) / stz.out_std[b]
            m_blk = None if ml_only else \
                (gv_model[:, tidx[b]] - stz.out_mean[b]) / stz.out_std[b]

            x = torch.zeros((Rb, params.n), dtype=torch.float32, device=dev)
            x = drive_discard(params, x, u_blk[:discard],
                              noise_mag=rcfg.noise_std,
                              generator=block_generator(dev, seed, bi, 0))
            acc = init_normal_eq(params, layout.n_out)._replace(x=x)
            # pairs: state after u(t) vs target(t+1), t = discard..T-2
            acc = drive_and_accumulate(
                params, acc, u_blk[discard:-1], y_blk[discard + 1:],
                None if ml_only else m_blk[discard + 1:],
                noise_mag=rcfg.noise_std,
                generator=block_generator(dev, seed, bi, 1), chunk=chunk)
            del u_blk, y_blk, m_blk
            part = dict(wout=ridge_solve(acc, n_model, **solve).to(
                torch.float32), a_idx=params.a_idx, a_val=params.a_val,
                win=params.win, a_shift=params.a_shift, q=params.q)
            if also_ml:
                # the ML-only system: the trailing (n, n) sub-block
                acc_ml = acc._replace(
                    ss_hi=acc.ss_hi[:, n_model:, n_model:],
                    ss_lo=acc.ss_lo[:, n_model:, n_model:],
                    sy_hi=acc.sy_hi[:, :, n_model:],
                    sy_lo=acc.sy_lo[:, :, n_model:])
                part["wout_ml"] = ridge_solve(acc_ml, 0, **solve).to(
                    torch.float32)
                del acc_ml
            del acc
            if ck is not None:
                _save_block(ck, part)
        for k in ("wout", "wout_ml") if also_ml else ("wout",):
            if k not in readouts:
                readouts[k] = torch.empty((R,) + tuple(part[k].shape[1:]),
                                          dtype=torch.float32, device=dev)
            readouts[k][b] = part[k]
        idx_parts.append(part["a_idx"])
        val_parts.append(part["a_val"])
        win_parts.append(part["win"])
        shifts.append(part["a_shift"])
        q_nodes = part["q"]
        del part
        if verbose:
            el = time.perf_counter() - t_start
            print(f"  train block {bi + 1}/{len(blocks)} ({Rb} regions): "
                  f"{el:.1f} s, {el / (bi + 1):.2f} s/block", flush=True)

    a_idx = torch.cat(idx_parts)
    # all blocks of one reservoir geometry share the circulant shifts; a
    # resume over blocks written without them finds them in the indices
    a_shift = shifts[0] if shifts[0] is not None and all(
        s == shifts[0] for s in shifts) else None
    if a_shift is None:
        found = shifts_from_ell(to_host(a_idx))
        a_shift = None if found is None else tuple(int(s) for s in found)
    n_nodes = win_parts[0].shape[1]
    params_all = EsnParams(a_idx=a_idx, a_val=torch.cat(val_parts),
                           win=torch.cat(win_parts),
                           wout=readouts["wout"],
                           node_map=torch.arange(n_nodes, device=dev)
                           // q_nodes,
                           leakage=rcfg.leakage, a_shift=a_shift)
    return HybridModel(layout=layout, params=params_all, stz=stz, rcfg=rcfg,
                       ml_only=ml_only, wout_ml=readouts.get("wout_ml"))


def ml_variant(hm: HybridModel) -> HybridModel:
    """The ML-ONLY model (configuration 2, mod_reservoir.f90:295-296,
    1491-1535) of a `train_hybrid(..., also_ml=True)` run: the same
    reservoirs and standardization, the readout restricted to the reservoir
    block (n_model == 0). It shares the hybrid's tensors, wout_ml included,
    on their device."""
    if hm.wout_ml is None:
        raise ValueError("no ML-only readout: train with also_ml=True")
    return HybridModel(layout=hm.layout,
                       params=dataclasses.replace(hm.params, wout=hm.wout_ml),
                       stz=hm.stz, rcfg=hm.rcfg, ml_only=True)


# ----------------------------------------------------------------------
# prediction
# ----------------------------------------------------------------------
class HybridRunner:
    """The prediction loop (parallelmain.f90:206-273): per hybrid timestep,
    the SPEEDY window from the current state, then the reservoir step on
    [state; forecast]. SST defaults to the forecaster's climatology and TISR
    to the analytic diurnal cycle; sst_fn and tisr_fn override them (a dry
    forecaster built from a bare dycore has no climatology and needs
    sst_fn)."""

    def __init__(self, hm: HybridModel, fc: Optional[SpeedyForecaster],
                 clim=None, dy=None):
        if not hm.ml_only and fc is None:
            raise ValueError("a hybrid model needs a forecaster")
        self.hm = hm
        self.fc = fc
        speedy = fc.speedy if fc is not None else None
        self.clim = clim if clim is not None else (
            speedy.clim if speedy is not None else None)
        self.dy = dy if dy is not None else (
            fc.dy if fc is not None else None)
        self.eps = hm.rcfg.precip_epsilon
        # optional (il, ix) output-side lognormal debias for the precip
        # channel: sigma^2/2 of the readout's log1p residual, subtracted
        # before the inversion, so that the WRITTEN mm estimates E[P] and is
        # not exp-inflated; what is fed back is untouched
        self.precip_debias = None

    def _sst(self, date: ModelDate) -> np.ndarray:
        """Boundary SST for the date: the climatology with its sea-ice
        blending."""
        if self.clim is None:
            raise ValueError("no climatology to take the SST from: pass "
                             "sst_fn, or a forecaster built on a Speedy")
        return np.asarray(init_coupler_state(self.clim, date).sst_am)

    def _tisr(self, date: ModelDate) -> np.ndarray:
        """Hourly-resolved TISR for the date (the reference's
        get_tisr_by_date, mpires.f90:1676-1710: diurnal, matching the
        train-time TISR statistics)."""
        if self.dy is None:
            raise ValueError("no dycore to take the latitudes from: pass "
                             "tisr_fn")
        return diurnal_tisr(date.tyear, date.ihour, self.dy.tables.gsin,
                            self.dy.tables.gcos, self.hm.layout.ix)

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

    def forecast_gv(self, atmo, logp, sst, tisr, date=None):
        """The window from (atmo, logp) at `date` under the boundary SST
        `sst`, packed as the model supervector, and the window's safety flag
        (a 0-d bool tensor)."""
        res = self.fc.forecast(atmo_to_grid(atmo, logp), date,
                               sst_hybrid=sst)
        return self.pack_forecast(res.gs, res.precip_mm, sst, tisr), res.safe

    def pack_forecast(self, gs: GridState, precip_mm, sst, tisr):
        """A window's end state and precipitation [mm] as the model
        supervector: the q floor and the log-precip transform, then pack."""
        f_atmo = torch.stack([gs.t, gs.u, gs.v, torch.clamp(gs.q, min=QMIN)])
        f_pr = torch.log1p(torch.clamp(precip_mm, min=0.0) / self.eps)
        return self.pack(f_atmo, gs.logp, f_pr, sst, tisr)

    def precip_mm(self, precip_t):
        """The written precipitation [mm] of a transformed log-precip field:
        the output-side debias, then the inverse transform."""
        if self.precip_debias is not None:
            precip_t = torch.clamp(precip_t - torch.as_tensor(
                self.precip_debias, dtype=precip_t.dtype,
                device=precip_t.device), min=0.0)
        return invert_precip(precip_t, self.eps)

    def run(self, x, atmo0, logp0, precip_t0, date: ModelDate, n_steps: int,
            sst_fn: Optional[Callable] = None,
            tisr_fn: Optional[Callable] = None, ocean=None, x_ocean=None,
            sst_anom0=None, writer=None, component_writers=None,
            checkpoint_path=None, checkpoint_every: int = 0,
            verbose: int = 0, deadline=None, gv_sum0=None,
            n_accum0: int = 0) -> dict:
        """Run n_steps hybrid steps from transformed global fields.

        sst_fn(date) -> (il, ix) SST override; default climatology. Mutually
        exclusive with `ocean` (an interactive ocean's anomaly is defined
        against the climatology; adding it on top of an observed field would
        count observed anomalies twice).
        sst_anom0: (il, ix) initial SST ANOMALY against climatology (not an
        absolute field), applied until the first weekly ocean update.
        tisr_fn(date) -> (il, ix) TISR override; default diurnal analytic.
        ocean: trained reservoir.slab.OceanModel. It steps every
        timestep_slab hours on the rolling week-mean supervector and feeds
        its predicted SST back to both the atmosphere reservoirs and
        SPEEDY's boundary condition (mod_slab_ocean_reservoir.f90:1268-1316,
        cpl_sea.f90:38-44); x_ocean is its reservoir state, gv_sum0 and
        n_accum0 the week's running sum and count to resume from.
        writer: io.output.ForecastWriter, appended to every step (the
        reference root's per-step write, mpires.f90:518-563).
        component_writers: (writer_ml, writer_p) pair of ForecastWriters for
        the per-step v_ml/v_p contributions in physical units
        (atmo = atmo_ml + atmo_p; mpires.f90:1146-1547).
        checkpoint_path, checkpoint_every: an atomic full-state checkpoint
        (io.checkpoint) every so many steps; resume_from() continues from it.
        verbose: print every so many steps. deadline: a time.time() value
        after which the loop stops cleanly at the end of a step.
        Returns a dict of stacked trajectory tensors on the device (atmo,
        logp, precip_mm, sst), the final reservoir state x and transformed
        precip precip_t (to resume from), x_ocean, the date, and `aborted`:
        the loop stops early when the window's safety gate trips
        (ppo_iogrid.f90:563-577 -> mpires.f90:744), which costs one device
        sync per step; a writer costs one download per step.
        """
        hm = self.hm
        L = hm.layout
        if sst_fn is not None and ocean is not None:
            raise ValueError(
                "sst_fn (observed SST) and an interactive ocean are mutually "
                "exclusive: the ocean anomaly is defined against climatology")
        dev = x.device
        f32 = torch.float32
        atmo = torch.as_tensor(atmo0, dtype=f32, device=dev)
        logp = torch.as_tensor(logp0, dtype=f32, device=dev)
        precip_t = None if precip_t0 is None else \
            torch.as_tensor(precip_t0, dtype=f32, device=dev)
        date = ModelDate(date.iyear, date.imonth, date.iday, date.ihour)
        traj = {k: [] for k in ("atmo", "logp", "precip_mm", "sst")}
        aborted = False
        gv_sum = None if gv_sum0 is None else \
            torch.as_tensor(gv_sum0, dtype=f32, device=dev)
        n_accum = int(n_accum0)
        # the ocean feedback persists as an ANOMALY against climatology
        # between weekly updates (applied again on the advancing
        # climatology), not as a week-frozen absolute field: the seasonal
        # cycle the reservoirs were trained on keeps moving underneath
        sst_anom = None if sst_anom0 is None else \
            np.asarray(to_host(sst_anom0), np.float64)
        spw = 0 if ocean is None else ocean.steps_per_week
        for step_i in range(n_steps):
            sst = sst_fn(date) if sst_fn is not None else self._sst(date)
            tisr = tisr_fn(date) if tisr_fn is not None else self._tisr(date)
            if sst_anom is not None:
                sst = np.clip(to_host(sst) + sst_anom, 200.0, 306.0)
            gv = self.pack(atmo, logp, precip_t, sst, tisr)

            if ocean is not None:
                gv_sum = gv if gv_sum is None else gv_sum + gv
                n_accum += 1
                if n_accum == spw:
                    if x_ocean is None:
                        x_ocean = ocean.zero_state()
                    # week-mean ATMO blocks + instantaneous SST/TISR/OHTC
                    # (mpires.f90:776-791; see slab.weekly_ocean_inputs)
                    gv_week = compose_week_inputs(gv, gv_sum, spw, L)
                    x_ocean, sst_core = ocean.step(x_ocean, gv_week)
                    clim_sst = to_host(self._sst(date))
                    sst_anom = ocean.compose_sst(sst_core, clim_sst,
                                                 L) - clim_sst
                    gv_sum, n_accum = None, 0

            model_gv = None
            if not hm.ml_only:
                model_gv, safe = self.forecast_gv(atmo, logp, sst, tisr,
                                                  date)
                if not bool(safe):
                    aborted = True
                    break
            if component_writers is not None and not hm.ml_only:
                x, atmo, logp, precip_t, comp = hm.step_split(x, gv,
                                                              model_gv)
                w_ml, w_p = component_writers
                w_ml.append(to_host(comp["atmo_ml"]),
                            to_host(comp["logp_ml"]))
                w_p.append(to_host(comp["atmo_p"]),
                           to_host(comp["logp_p"]))
            else:
                x, atmo, logp, precip_t = hm.step(x, gv, model_gv)
            date.advance_hours(hm.rcfg.timestep)
            traj["atmo"].append(atmo)
            traj["logp"].append(logp)
            traj["precip_mm"].append(
                None if precip_t is None else self.precip_mm(precip_t))
            traj["sst"].append(torch.as_tensor(sst, dtype=f32, device=dev))
            if writer is not None:
                pr_mm = traj["precip_mm"][-1]
                writer.append(to_host(atmo), to_host(logp),
                              precip_mm=None if pr_mm is None
                              else to_host(pr_mm), sst=to_host(sst))
            if checkpoint_path and checkpoint_every and \
                    (step_i + 1) % checkpoint_every == 0:
                extra = {}
                if sst_anom is not None:
                    extra["sst_anom"] = sst_anom
                if ocean is not None:
                    # the week's accumulator and the ocean reservoir state:
                    # without them a mid-week resume would restart the
                    # week-mean window out of phase, on a cold ocean state
                    extra["n_accum"] = n_accum
                    if gv_sum is not None:
                        extra["gv_sum"] = gv_sum
                    if x_ocean is not None:
                        extra["x_ocean"] = x_ocean
                save_prediction(checkpoint_path, x, atmo, logp, precip_t,
                                date, step=step_i + 1, extra=extra or None)
            if verbose and (step_i + 1) % verbose == 0:
                print(f"  predict step {step_i + 1}/{n_steps} "
                      f"[{time.strftime('%H:%M:%S')}]", flush=True)
            if deadline is not None and time.time() > deadline:
                break                       # a budgeted run stops cleanly
        out = {k: (torch.stack(v) if v and v[0] is not None else None)
               for k, v in traj.items()}
        out.update(x=x, x_ocean=x_ocean, precip_t=precip_t, date=date,
                   aborted=aborted)
        return out

    def resume_from(self, checkpoint_path: str, n_steps: int,
                    device: torch.device | str | None = None, **kw) -> dict:
        """Continue a prediction exactly from a checkpoint that run() or the
        chunked loop wrote, on `device` (the card unless the caller names
        another). Keyword arguments go on to run()."""
        dev = resolve_device(device)
        st = load_prediction(checkpoint_path)
        ex = st["extra"]
        if "sst_cur" in ex:
            # an old checkpoint holds the ABSOLUTE fed-back SST: turn it into
            # the anomaly against the climatology at the checkpoint's date
            ex["sst_anom"] = np.asarray(ex.pop("sst_cur"), np.float64) \
                - to_host(self._sst(st["date"]))
        if "x_ocean" in ex and kw.get("ocean") is not None \
                and kw.get("x_ocean") is None:
            kw["x_ocean"] = torch.as_tensor(ex["x_ocean"], device=dev)
        return self.run(torch.as_tensor(st["x"], device=dev), st["atmo"],
                        st["logp"], st["precip_t"], st["date"], n_steps,
                        sst_anom0=kw.pop("sst_anom0", ex.get("sst_anom")),
                        gv_sum0=kw.pop("gv_sum0", ex.get("gv_sum")),
                        n_accum0=kw.pop("n_accum0",
                                        int(ex.get("n_accum", 0))), **kw)
