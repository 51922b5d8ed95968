"""Slab-ocean reservoir: weekly SST prediction coupled to the atmosphere
(PyTorch port of speedyml/reservoir/slab.py).

One batched ESN over all horizontal regions, driven on the slow (weekly,
timestep_slab = 168 h) cadence; the redesign of the reference's per-region
"special" ocean reservoir (src/mod_slab_ocean_reservoir.f90).

Inputs per region (get_training_data_from_atmo,
mod_slab_ocean_reservoir.f90:271-405): week-averaged bottom-level atmosphere
(T, u, v, q) over the halo patch + logp patch + SST patch + TISR patch
(+ optional OHTC patch); target = SST at the region core one week ahead.
Regions are active only where the training SST variance exceeds a threshold
(sst_bool_prediction); elsewhere climatology is used.

The layout, the weekly series and the statistics are host numpy, the same
code as the JAX package's. The reservoirs, their training and the weekly
step run on the device; `compose_sst` works on the host in float64, once a
week on one (il, ix) field.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.calendar import ModelDate, datetime_from_hours
from ..core.config import ReservoirConfig
from ..coupler.daily import interp_sea
from ..device import resolve_device, to_host
from ..domain.decomposition import RegionLayout, _patch_indices
from ..domain.standardize import SST_STD_FLOOR, Standardizer
from .esn import EsnParams, advance, predict_step, readout, synchronize
from .generate import generate_esn, shifts_from_ell
from .training import (block_generator, drive_and_accumulate, drive_discard,
                       init_normal_eq, ridge_solve)


class OceanLayout(NamedTuple):
    """Gather maps for the ocean reservoir, indexing the SAME packed global
    supervector as the atmosphere layout."""

    input_index: np.ndarray   # (R, n_in) int32 into gv
    target_index: np.ndarray  # (R, n_out) int32 into gv (sst core points)
    sections: dict            # name -> (start, stop) within the input vector
    n_in: int
    n_out: int
    R: int


def build_ocean_layout(L: RegionLayout, bottom_level: Optional[int] = None
                       ) -> OceanLayout:
    """Derive the ocean gather maps from the atmosphere layout.

    Ocean reservoirs are per HORIZONTAL region (R_ocean = nregy*nregx, one
    per column regardless of the atmosphere's vertical slabs); inputs index
    the global supervector directly.

    bottom_level: sigma level index used for the near-surface atmosphere
    inputs (default kx-1 = lowest model level)."""
    kz = L.kx - 1 if bottom_level is None else bottom_level
    npatch = L.inpy * L.inpx
    ncore = L.resy * L.resx
    nv = L.nvars
    ngp = L.il * L.ix
    has_ohtc = L.gv_sizes.get("ohtc", (0, 0))[1] > L.gv_sizes.get(
        "ohtc", (0, 0))[0]

    sections = {}
    pos = 0
    in2d = ["logp", "sst", "tisr"] + (["ohtc"] if has_ohtc else [])
    for name, ln in [("atmo_bot", nv * npatch)] + [(n, npatch)
                                                   for n in in2d]:
        sections[name] = (pos, pos + ln)
        pos += ln
    n_in = pos
    n_out = ncore * (2 if has_ohtc else 1)    # [sst core | ohtc core]

    Ro = L.nregy * L.nregx
    input_index = np.empty((Ro, n_in), np.int32)
    target_index = np.empty((Ro, n_out), np.int32)

    a0 = L.gv_sizes["atmo3d"][0]
    for r in range(Ro):
        ry, rx = divmod(r, L.nregx)
        patch = _patch_indices(L.il, L.ix, ry * L.resy - L.overlap,
                               rx * L.resx - L.overlap, L.inpy, L.inpx)
        sec = np.empty(nv * npatch, np.int32)
        for p in range(npatch):
            for v in range(nv):
                sec[v + nv * p] = a0 + (v * L.kx + kz) * ngp + patch[p]
        s0, s1 = sections["atmo_bot"]
        input_index[r, s0:s1] = sec
        for name in in2d:
            g0, g1 = L.gv_sizes[name]
            if g1 <= g0:
                raise ValueError(f"ocean reservoir needs {name} in the "
                                 f"layout")
            u0, u1 = sections[name]
            input_index[r, u0:u1] = g0 + patch
        core = _patch_indices(L.il, L.ix, ry * L.resy, rx * L.resx,
                              L.resy, L.resx)
        target_index[r, :ncore] = L.gv_sizes["sst"][0] + core
        if has_ohtc:
            target_index[r, ncore:] = L.gv_sizes["ohtc"][0] + core

    return OceanLayout(input_index=input_index, target_index=target_index,
                       sections=sections, n_in=n_in, n_out=n_out, R=Ro)


def weekly_average(gv_series: np.ndarray, steps_per_week: int) -> np.ndarray:
    """Average the 6-hourly transformed supervector over each week window.
    Plain block-mean of EVERY field (see weekly_ocean_inputs for the
    reference's actual input mixing). Returns (T_w, gv_len)."""
    T = gv_series.shape[0]
    Tw = T // steps_per_week
    return gv_series[:Tw * steps_per_week].reshape(
        Tw, steps_per_week, -1).mean(axis=1)


def weekly_ocean_inputs(gv_series: np.ndarray, steps_per_week: int,
                        L: RegionLayout) -> np.ndarray:
    """Ocean-reservoir input series at slab cadence, with the reference's
    mixing: ONLY the atmosphere blocks (atmo3d + logp) are week-averaged
    (rolling_average_over_a_period_2d applied to atmo3d_start:logp_end,
    mod_slab_ocean_reservoir.f90:398; prediction-time averaging
    mpires.f90:776-791); the SST/TISR/OHTC blocks stay INSTANTANEOUS values
    at the week boundary (the reference strides the un-averaged trainingdata
    at ::timestep_slab). Returns (T_w, gv_len)."""
    T = gv_series.shape[0]
    Tw = T // steps_per_week
    g = gv_series[:Tw * steps_per_week].reshape(Tw, steps_per_week, -1)
    out = np.array(g[:, -1], copy=True)            # week-boundary endpoint
    for name in ("atmo3d", "logp"):
        s0, s1 = L.gv_sizes[name]
        out[:, s0:s1] = g[:, :, s0:s1].mean(axis=1)
    return out


def compose_week_inputs(gv_end: torch.Tensor, gv_sum: torch.Tensor,
                        steps_per_week: int, L: RegionLayout) -> torch.Tensor:
    """Prediction-time analog of weekly_ocean_inputs for ONE week window:
    gv_end is the current (week-boundary) supervector, gv_sum the running sum
    over the window. Atmosphere blocks become the window mean, everything
    else keeps the instantaneous endpoint (mpires.f90:776-791). On the
    tensors' device, out of place."""
    out = gv_end.clone()
    for name in ("atmo3d", "logp"):
        s0, s1 = L.gv_sizes[name]
        out[s0:s1] = gv_sum[s0:s1] / steps_per_week
    return out


def _section_stats(series: np.ndarray, sections: dict, groups: dict,
                   eps: float = 1e-8, std_floors: Optional[dict] = None):
    """Per-region scalar stats per (section, group) expanded to per-element
    (the reference's per-variable scalars, mod_utilities.f90:934-1040).

    groups[name] = number of interleaved variables in the section (stats are
    computed per variable, shared across patch positions).
    std_floors[name] = absolute std floor for clamped/bounded INPUT sections
    (see standardize.SST_STD_FLOOR)."""
    T, R, n = series.shape
    mean = np.empty((R, n), np.float32)
    std = np.empty((R, n), np.float32)
    for name, (s0, s1) in sections.items():
        if s1 <= s0:
            continue
        g = groups.get(name, 1)
        sec = series[:, :, s0:s1].reshape(T, R, (s1 - s0) // g, g)
        m = sec.mean(axis=(0, 2))            # (R, g)
        sd = sec.std(axis=(0, 2)) + eps
        if std_floors and name in std_floors:
            sd = np.maximum(sd, std_floors[name])
        mean[:, s0:s1] = np.tile(m[:, None, :], (1, (s1 - s0) // g, 1)
                                 ).reshape(R, -1)
        std[:, s0:s1] = np.tile(sd[:, None, :], (1, (s1 - s0) // g, 1)
                                ).reshape(R, -1)
    return mean, std


@dataclasses.dataclass
class OceanModel:
    """Trained slab-ocean reservoirs + masks. The parameters and the
    standardizer are tensors on the model's device; the layout, the active
    mask and the gate are host numpy."""

    ol: OceanLayout
    params: EsnParams
    stz: Standardizer
    active: np.ndarray        # (R,) bool: sst variance above threshold
    rcfg: ReservoirConfig
    # optional (il, ix) per-gridpoint anomaly-gate scale: compose_sst
    # tightens the clip to 3x this value pointwise. Set it to the model's
    # OPEN-LOOP one-week residual std (calibrate_gate): trust the ocean
    # prediction only up to its demonstrated skill. The total training-SST
    # std is the wrong scale: the seasonal cycle dominates it, so a 3-sigma
    # gate admits warm-pool anomalies of a few K that atmosphere reservoirs
    # trained on climatological SST have never seen.
    anom_std: Optional[np.ndarray] = None

    @property
    def steps_per_week(self) -> int:
        return self.rcfg.timestep_slab // self.rcfg.timestep

    @property
    def device(self) -> torch.device:
        return self.params.win.device

    def maps(self) -> torch.Tensor:
        """input_index as an int64 tensor on the model's device, copied
        there once."""
        idx = getattr(self, "_idx", None)
        if idx is None or idx.device != self.device:
            idx = torch.as_tensor(self.ol.input_index, dtype=torch.int64,
                                  device=self.device)
            self._idx = idx
        return idx

    def _gv(self, gv) -> torch.Tensor:
        return torch.as_tensor(gv, dtype=torch.float32, device=self.device)

    def zero_state(self) -> torch.Tensor:
        return torch.zeros((self.ol.R, self.params.n), dtype=torch.float32,
                           device=self.device)

    def _inputs(self, gv: torch.Tensor) -> torch.Tensor:
        """(..., gv_len) supervectors -> standardized (..., R, n_in)."""
        return (gv[..., self.maps()] - self.stz.in_mean) / self.stz.in_std

    def step(self, x, gv_weekmean):
        """One weekly step: returns (x', sst core values (R, n_out) [K])."""
        x, out_std = predict_step(self.params, x,
                                  self._inputs(self._gv(gv_weekmean)))
        return x, out_std * self.stz.out_std + self.stz.out_mean

    def synchronize(self, gv_weekly, x=None):
        """Drive the reservoirs with a (T_w, gv_len) weekly input series."""
        if x is None:
            x = self.zero_state()
        return synchronize(self.params, x, self._inputs(self._gv(gv_weekly)))

    def open_loop(self, gv_weekly, x=None):
        """Teacher-forced one-week-ahead predictions over a weekly input
        series: (x, (T_w, R, n_out) physical outputs); the prediction at
        index t is valid at week t+1's end."""
        if x is None:
            x = self.zero_state()
        outs = []
        for u in self._inputs(self._gv(gv_weekly)):
            x = advance(self.params, x, u)
            outs.append(readout(self.params, x))
        return x, torch.stack(outs) * self.stz.out_std + self.stz.out_mean

    def calibrate_gate(self, gv_truth, L: RegionLayout, discard: int = 8,
                       train_anom_std=None):
        """Set the compose_sst anomaly gate from OPEN-LOOP residuals.

        Runs teacher-forced one-week-ahead predictions over the training
        series and stores the per-gridpoint residual std as anom_std. The
        fed-back anomaly is then clipped to 3x the model's demonstrated
        skill: the analog of the reference's 6 K acceptance gate
        (cpl_sea.f90:38-44) recalibrated to the training regime's actual
        variance.

        train_anom_std: optional (il, ix) per-gridpoint std of the TRAINING
        SST's deviation from the date-matched climatological boundary (see
        training_anomaly_std). When the truth carries real anomalies (the
        observed-SST / synthetic-ENSO regime), a skilful model's residuals
        are SMALL, and gating on them alone would clip the very anomalies
        the ocean was trained to produce. The gate scale is therefore
        max(residual std, training anomaly std): admit what the coupled
        system has seen in training, never less than the model's noise
        floor. In the climatological regime train_anom_std ~ 0 over open
        water.
        Returns (gate_std_grid, open_loop_rms, persistence_rms)."""
        gv_truth = to_host(gv_truth)
        spw = self.steps_per_week
        gv_w = weekly_ocean_inputs(gv_truth, spw, L)
        Tw = gv_w.shape[0]
        ends = np.arange(1, Tw + 1) * spw - 1
        truth = gv_truth[ends][:, self.ol.target_index]     # (Tw, R, n_out)
        _, pred = self.open_loop(gv_w[:-1])
        pred = to_host(pred)                                  # valid at t+1
        resid = pred[discard:] - truth[discard + 1:]
        ncore = L.resy * L.resx
        resid_sst = resid[:, :, :ncore]                     # (T', R, ncore)
        per_pt = resid_sst.std(axis=0)                      # (R, ncore)
        pers = truth[discard + 1:, :, :ncore] - truth[discard:-1, :, :ncore]

        grid = np.zeros((L.il, L.ix))
        g_ss0 = L.gv_sizes["sst"][0]
        tgt = self.ol.target_index[:, :ncore] - g_ss0
        grid.reshape(-1)[tgt.reshape(-1)] = per_pt.reshape(-1)
        if train_anom_std is not None:
            grid = np.maximum(grid, np.asarray(train_anom_std, np.float64))
        self.anom_std = grid
        ol_rms = float(np.sqrt((resid_sst[:, self.active] ** 2).mean()))
        p_rms = float(np.sqrt((pers[:, self.active] ** 2).mean()))
        return grid, ol_rms, p_rms

    def compose_sst(self, sst_pred_core, sst_clim, layout: RegionLayout):
        """Blend predicted SST (active regions) with climatology: the
        reference's sst_bool_prediction + sea-mask freeze
        (mod_slab_ocean_reservoir.f90:833-867, mpires.f90:456-563). Host
        numpy, float64; sst_pred_core may be a tensor on the device.

        Predicted SST is gated to within slab_anom_clip [K] of the
        climatology, the anomaly analog of the reference's 6 K hybrid-SST
        acceptance gate at the SPEEDY boundary (cpl_sea.f90:38-44): a
        reservoir extrapolating far outside its training distribution
        (short ocean training records) must not be allowed to destabilize
        the coupled system. ENSO-scale anomalies (+-3 K) pass untouched;
        absolute bounds [200, 306] K apply last."""
        L = layout
        ncore = L.resy * L.resx
        clim = np.asarray(to_host(sst_clim), np.float64)
        grid = clim.copy()
        flat = grid.reshape(-1)
        g_ss0 = L.gv_sizes["sst"][0]
        tgt = self.ol.target_index[:, :ncore] - g_ss0   # flat grid indices
        pred = np.asarray(to_host(sst_pred_core), np.float64)[:, :ncore]
        act = self.active
        flat[tgt[act].reshape(-1)] = pred[act].reshape(-1)
        grid = flat.reshape(grid.shape)
        clip = self.rcfg.slab_anom_clip
        if clip:
            cf = np.asarray(clip, np.float64)
            if self.anom_std is not None:
                cf = np.minimum(cf, np.maximum(3.0 * self.anom_std, 0.05))
            grid = np.clip(grid, clim - cf, clim + cf)
        # sanity bounds ONLY: the boundary field is the ICE-BLENDED sst_am
        # (sst + sice*(tice - sst), cpl_sea.f90), which legitimately reaches
        # ~237 K over sea ice. Flooring it at the open-water freezing point
        # would jump polar surface temperatures by tens of K at the first
        # ocean step and destabilize the whole coupled system.
        return np.clip(grid, 200.0, 306.0)


def training_anomaly_std(clim, hours: np.ndarray, sst_series,
                         subsample: int = 4) -> np.ndarray:
    """(il, ix) per-gridpoint std [K] of the truth SST's deviation from the
    date-matched climatological sea boundary: the training-distribution
    anomaly scale for the compose_sst gate (see calibrate_gate).

    Open water only: where the climatological ice fraction ever exceeds 5%
    the result is zeroed, because there the ice-blended sst_am deviates
    from the climatological blend through the PROGNOSTIC ice temperature,
    which is not an SST anomaly the ocean reservoir should be licensed to
    feed back."""
    h = np.asarray(hours)[::subsample]
    ss = np.asarray(to_host(sst_series), np.float64)[::subsample]
    dev_sq = np.zeros(ss.shape[1:], np.float64)
    dev_mean = np.zeros_like(dev_sq)
    ice_any = np.zeros_like(dev_sq, dtype=bool)
    for i in range(len(h)):
        date = ModelDate(*datetime_from_hours(int(h[i])))
        sstcl, sicecl, ticecl = interp_sea(clim, date.imonth, date.tmonth)
        blend = sstcl + sicecl * (ticecl - sstcl)
        dev = ss[i] - blend
        dev_mean += dev
        dev_sq += dev * dev
        ice_any |= sicecl > 0.05
    n = max(len(h), 1)
    var = dev_sq / n - (dev_mean / n) ** 2
    std = np.sqrt(np.maximum(var, 0.0))
    std[ice_any] = 0.0
    return std


def train_ocean(L: RegionLayout, rcfg: ReservoirConfig, gv_truth,
                seed: int = 100, bottom_level: Optional[int] = None,
                region_block: int = 0, checkpoint_dir: Optional[str] = None,
                device: torch.device | str | None = None) -> OceanModel:
    """Train the slab-ocean reservoirs from the 6-hourly truth supervector
    (train_slab_ocean_model, mod_slab_ocean_reservoir.f90:172-269).

    gv_truth: (T, gv_len) transformed truth series, a tensor (the model is
    then trained on its device) or a numpy array (on `device`: the card
    unless the caller names another). The weekly series and its statistics
    are formed on the host; each block's standardized series is uploaded and
    its reservoirs are generated, driven and solved on the device.
    region_block: regions trained per pass (0 = all at once); the (Rb, n, n)
    normal equations and their f64 solve bound it.
    checkpoint_dir: if set, each finished region block is written there
    (atomic .npz) and blocks found there are skipped on re-entry;
    generation and noise are pure functions of (seed, block), so a resumed
    run gives the uninterrupted run's model bitwise."""
    dev = gv_truth.device if torch.is_tensor(gv_truth) \
        else resolve_device(device)
    gv_truth = to_host(gv_truth)
    ol = build_ocean_layout(L, bottom_level)
    spw = rcfg.timestep_slab // rcfg.timestep
    gv_w = weekly_ocean_inputs(gv_truth, spw, L)
    Tw = gv_w.shape[0]
    if Tw <= 4:
        raise ValueError(f"{Tw} weekly samples: the slab ocean needs more "
                         f"than 4 to train")

    inputs = gv_w[:, ol.input_index]                       # (Tw, R, n_in)
    # targets: INSTANTANEOUS SST (+OHTC) at week boundaries: the reference
    # never averages the SST block (rolling_average_over_a_period_2d covers
    # only atmo3d_start:logp_end, mod_slab_ocean_reservoir.f90:398) and
    # strides the raw series at ::timestep_slab for training
    ends = np.arange(1, Tw + 1) * spw - 1
    targets_raw = gv_truth[ends][:, ol.target_index]       # (Tw, R, n_out)

    in_mean, in_std = _section_stats(
        inputs, ol.sections, groups={"atmo_bot": L.nvars},
        std_floors={"sst": SST_STD_FLOOR})
    ncore = L.resy * L.resx
    out_sec = {"sst": (0, ncore)}
    if ol.n_out > ncore:
        out_sec["ohtc"] = (ncore, ol.n_out)
    out_mean, out_std = _section_stats(targets_raw, out_sec, groups={})

    # active where SST varies (sst_bool_prediction threshold)
    sst_var = targets_raw[:, :, :ncore].var(axis=(0, 2))   # (R,)
    active = sst_var > rcfg.sst_variance_threshold

    u_all = (inputs - in_mean) / in_std
    y_all = (targets_raw - out_mean) / out_std

    R = ol.R
    blocks = [np.arange(R)] if region_block in (0, R) else [
        np.arange(i, min(i + region_block, R))
        for i in range(0, R, region_block)]
    idx_p, val_p, win_p, wout_p = [], [], [], []
    q_nodes = None
    discard = max(1, min(Tw // 4, 8))
    chunk = min(16, max(1, Tw - discard - 1))
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
    f32 = torch.float32
    for bi, blk in enumerate(blocks):
        ck = None
        if checkpoint_dir:
            ck = os.path.join(checkpoint_dir, f"ocean_block_{bi:04d}.npz")
            if os.path.exists(ck):
                with np.load(ck) as z:
                    idx_p.append(z["a_idx"])
                    val_p.append(z["a_val"])
                    win_p.append(z["win"])
                    wout_p.append(z["wout"])
                    q_nodes = int(z["q"])
                continue
        params = generate_esn(seed + 31 * bi, len(blk), ol.n_in, ol.n_out,
                              n_model=0, m_target=rcfg.slab_nodes,
                              deg=rcfg.degree, sigma=rcfg.slab_sigma,
                              leakage=rcfg.slab_leakage,
                              radii=np.full(len(blk), 0.9), device=dev)
        q_nodes = params.n // ol.n_in
        u_blk = torch.as_tensor(u_all[:, blk], dtype=f32, device=dev)
        y_blk = torch.as_tensor(y_all[:, blk], dtype=f32, device=dev)
        x = torch.zeros((len(blk), params.n), dtype=f32, device=dev)
        x = drive_discard(params, x, u_blk[:discard],
                          noise_mag=rcfg.slab_noise_std,
                          generator=block_generator(dev, seed, bi, 0))
        acc = init_normal_eq(params, ol.n_out)._replace(x=x)
        acc = drive_and_accumulate(
            params, acc, u_blk[discard:-1], y_blk[discard + 1:],
            noise_mag=rcfg.slab_noise_std,
            generator=block_generator(dev, seed, bi, 1), chunk=chunk)
        wout = ridge_solve(acc, 0, rcfg.slab_beta_res, 1.0)
        del acc
        idx_p.append(params.a_idx.cpu().numpy().astype(np.int32))
        val_p.append(params.a_val.cpu().numpy())
        win_p.append(params.win.cpu().numpy())
        wout_p.append(wout.to(f32).cpu().numpy())
        del wout
        if ck is not None:
            tmp = ck + ".tmp"
            with open(tmp, "wb") as fh:     # atomic: write, then rename
                np.savez(fh, a_idx=idx_p[-1], a_val=val_p[-1],
                         win=win_p[-1], wout=wout_p[-1], q=q_nodes)
            os.replace(tmp, ck)

    n_nodes = win_p[0].shape[1]
    a_idx_h = np.concatenate(idx_p)
    shifts = shifts_from_ell(a_idx_h)   # the circulant path when detected
    params_all = EsnParams(
        a_idx=torch.as_tensor(a_idx_h, dtype=torch.int64, device=dev),
        a_val=torch.as_tensor(np.concatenate(val_p), device=dev),
        win=torch.as_tensor(np.concatenate(win_p), device=dev),
        wout=torch.as_tensor(np.concatenate(wout_p), device=dev),
        node_map=torch.arange(n_nodes, device=dev) // q_nodes,
        leakage=rcfg.slab_leakage,
        a_shift=None if shifts is None else tuple(int(s) for s in shifts))
    stz = Standardizer(*(torch.as_tensor(a, device=dev)
                         for a in (in_mean, in_std, out_mean, out_std)))
    return OceanModel(ol=ol, params=params_all, stz=stz, active=active,
                      rcfg=rcfg)
