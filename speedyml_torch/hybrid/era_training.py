"""Train the hybrid model from ERA-schema files: the reference's contract
(PyTorch port of speedyml/hybrid/era_training.py).

The reference trains on files, never on a live model run
(speedy_res_interface.f90:439-635 read_era, 637-723 read_model_states):
truth = regridded-ERA5 year files (+ hourly TISR companions), imperfect
model = precomputed one-window SPEEDY forecasts ("restart_6hour_yYYYY.nc").
This module reads exactly that file schema (io.era) on the host and trains
on the device; it never runs the model.

Alignment (as collect_forecasts): model-state index t is the one-window
forecast VALID at truth sample t (launched from t-1); training pairs are
(input t, target t+1), so index 0 of the model series is never consumed.
Sample 0 is dated 1 January 00h of the first year.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.calendar import ModelDate, datetime_from_hours, hours_since_epoch
from ..core.config import ReservoirConfig
from ..device import resolve_device
from ..domain.decomposition import RegionLayout
from ..io import era
from ..physics.radiation import diurnal_tisr
from .experiment import (HybridModel, TruthSeries, train_hybrid,
                         transform_and_pack)


class EraTrainingData(NamedTuple):
    truth: TruthSeries                     # on the device
    model_atmo: Optional[torch.Tensor]     # (T, 4, kx, il, ix) or None
    model_logp: Optional[torch.Tensor]     # (ml_only)
    model_precip: Optional[torch.Tensor]


def _analytic_tisr(hours: np.ndarray, y0: int, il: int, ix: int,
                   slat, clat) -> np.ndarray:
    """Fallback TISR when no files exist: the same analytic diurnal cycle
    prediction uses (physics.radiation.diurnal_tisr), so train/predict TISR
    statistics agree."""
    out = np.empty((hours.size, il, ix), np.float32)
    for i, h in enumerate(hours):
        y, m, d, hh = datetime_from_hours(int(h))
        date = ModelDate(y, m, d, hh)
        out[i] = diurnal_tisr(date.tyear, hh, slat, clat, ix)
    return out


def load_era_training(era_dir: str, y0: int, y1: int,
                      tisr_dir: Optional[str] = None,
                      model_dir: Optional[str] = None,
                      suffix: str = "_regridded_mpi_fixed_var_gcc",
                      model_template: str = "restart_6hour_y{year}.nc",
                      timestep: int = 6, slat=None, clat=None,
                      device: torch.device | str | None = None
                      ) -> EraTrainingData:
    """Read truth (+ optional model states) for years [y0, y1] onto `device`
    (the card unless the caller names another).

    era_dir must hold era_5_y{YYYY}{suffix}.nc; tisr_dir the TISR companions
    (era_dir when None; analytic diurnal fallback when files are absent);
    model_dir the restart_6hour files (None -> ml_only training).
    """
    dev = resolve_device(device)
    d = era.read_era_range(era_dir, y0, y1, tisr_dir=None, suffix=suffix)
    T = d["atmo"].shape[0]
    il, ix = d["logp"].shape[-2:]
    hours = (hours_since_epoch(y0, 1, 1, 0)
             + np.arange(T, dtype=np.int64) * timestep)

    tdir = tisr_dir if tisr_dir is not None else era_dir
    if os.path.exists(era.tisr_file_name(tdir, y0)):
        tisr = np.concatenate([
            era.read_tisr_year(era.tisr_file_name(tdir, y))
            for y in range(y0, y1 + 1)])
        if tisr.shape[0] < T:
            raise ValueError(f"{tisr.shape[0]} TISR records for {T} samples")
        tisr = tisr[:T]
    elif "tisr" in d:
        tisr = d["tisr"]
    else:
        if slat is None or clat is None:
            raise ValueError("no TISR files: pass slat/clat for the analytic "
                             "diurnal cycle")
        tisr = _analytic_tisr(hours, y0, il, ix, slat, clat)

    precip = d.get("p6hr")
    if precip is None:
        precip = np.zeros((T, il, ix), np.float32)
    sst = d.get("sst")
    if sst is None:
        raise ValueError(
            "ERA files carry no SST variable; the reservoir input layout "
            "requires it (use_sst=False layouts excepted)")

    def up(a):
        return torch.as_tensor(a, device=dev)

    truth = TruthSeries(atmo=up(d["atmo"]), logp=up(d["logp"]),
                        precip=up(precip), sst=up(sst), tisr=up(tisr),
                        hours=hours)
    if model_dir is None:
        return EraTrainingData(truth, None, None, None)

    parts = [era.read_model_states(
        os.path.join(model_dir, model_template.format(year=y)))
        for y in range(y0, y1 + 1)]
    m_atmo = np.concatenate([p["atmo"] for p in parts])[:T]
    m_logp = np.concatenate([p["logp"] for p in parts])[:T]
    if all("p6hr" in p for p in parts):
        m_precip = np.concatenate([p["p6hr"] for p in parts])[:T]
    else:
        m_precip = np.zeros_like(precip)
    if m_atmo.shape != d["atmo"].shape:
        raise ValueError(f"model states {m_atmo.shape} against truth "
                         f"{d['atmo'].shape}")
    return EraTrainingData(truth, up(m_atmo), up(m_logp), up(m_precip))


def train_from_era(layout: RegionLayout, rcfg: ReservoirConfig,
                   era_dir: str, y0: int, y1: int,
                   tisr_dir: Optional[str] = None,
                   model_dir: Optional[str] = None,
                   seed: int = 0, region_block: int = 0, chunk: int = 64,
                   slat=None, clat=None,
                   device: torch.device | str | None = None):
    """File-based training end to end: ERA-schema files -> HybridModel, on
    `device` (the card unless the caller names another).

    Returns (HybridModel, EraTrainingData, gv_truth); gv_truth is the packed
    transformed truth series on the device, for synchronization before
    prediction (mod_reservoir.f90:940-961 start_prediction).
    """
    data = load_era_training(era_dir, y0, y1, tisr_dir=tisr_dir,
                             model_dir=model_dir, timestep=rcfg.timestep,
                             slat=slat, clat=clat, device=device)
    t = data.truth
    gv_truth = transform_and_pack(layout, t.atmo, t.logp, t.precip, t.sst,
                                  t.tisr, rcfg.precip_epsilon)
    gv_model = None
    if data.model_atmo is not None:
        gv_model = transform_and_pack(layout, data.model_atmo,
                                      data.model_logp, data.model_precip,
                                      t.sst, t.tisr, rcfg.precip_epsilon)
    hm: HybridModel = train_hybrid(layout, rcfg, gv_truth, gv_model,
                                   seed=seed, region_block=region_block,
                                   chunk=chunk)
    return hm, data, gv_truth
