"""SPEEDY window forecasts + truth-trajectory generation for the hybrid model
(PyTorch port of speedyml/hybrid/forecast.py).

A window injects a grid state, runs the stepone bootstrap and then leapfrog
steps with physics to the end of the window (6 h = 24 steps at T30), and
extracts the grid state, with the window's precipitation and the coupler's
heat fluxes summed on the way. The steps are a Python loop of eager calls.

The same window drives truth-trajectory generation: a TrajectoryRunner
carries the grid state across windows and applies the daily land/sea/ice
coupler update.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.calendar import ModelDate
from ..coupler.anomaly import apply_sst_anomaly
from ..coupler.daily import daily_coupler_update, init_coupler_state
from ..dynamics.core import Dycore
from ..model import Speedy, ice_flux
from ..physics.driver import init_rad_carry
from ..physics.radiation import diurnal_tisr
from .state_io import GridState, extract, inject


class WindowResult(NamedTuple):
    gs: GridState              # forecast grid state at window end
    precip_mm: torch.Tensor    # (il, ix) precipitation [mm] over the window
    safe: torch.Tensor         # () bool: injection passed the safety gate
    flux_sums: tuple           # (hflux_l, hflux_s, hflux_i) sums for coupler


class SpeedyForecaster:
    """Runs SPEEDY for a fixed window (default 6 h) from an injected grid
    state: the hybrid's "imperfect model" step.

    physics=False gives the dry core (a deliberately more imperfect model
    for self-generated training data). The dry core needs no boundary files:
    `SpeedyForecaster.dry(dycore)` builds it from a bare `Dycore`.
    """

    def __init__(self, speedy: Optional[Speedy], hours: int = 6,
                 physics: bool = True, dy: Optional[Dycore] = None):
        if speedy is None and (physics or dy is None):
            raise ValueError("without a Speedy only the dry core of a given "
                             "dycore can run")
        self.speedy = speedy
        self.dy = dy if dy is not None else speedy.dy
        cfg = self.dy.config
        if (hours * cfg.nsteps) % 24:
            raise ValueError(f"a {hours} h window is not a whole number of "
                             f"{cfg.nsteps}-per-day steps")
        self.hours = hours
        self.nsteps_window = hours * cfg.nsteps // 24
        self.physics = physics

    @classmethod
    def dry(cls, dy: Dycore, hours: int = 6) -> "SpeedyForecaster":
        """The dry-core forecaster of a bare dycore (zero forcing, no
        climatology)."""
        return cls(None, hours=hours, physics=False, dy=dy)

    # ------------------------------------------------------------------
    def window(self, gs: GridState, surf, forcing) -> WindowResult:
        """One window from grid state `gs` under the surface state `surf`
        (unused by the dry core) and the diffusion corrections `forcing`.
        It runs whatever the safety flag says; the caller decides what an
        unsafe start means."""
        dy = self.dy
        cfg = dy.config
        nst = self.nsteps_window
        state, safe = inject(dy, gs)
        z = torch.zeros((cfg.il, cfg.ix), dtype=dy.dtype, device=dy.device)

        if not self.physics:
            state = dy.step(state, forcing, 0, 0, "half")
            state = dy.step(state, forcing, 0, 1, "delt")
            for _ in range(nst - 1):
                state = dy.step(state, forcing, 1, 1, "delt2")
            return WindowResult(gs=extract(dy, state, level=0), precip_mm=z,
                                safe=safe, flux_sums=(z, z, z))

        phys_fn = self.speedy._phys_fn
        # precip unit: physics precnv/precls are g/(m^2 s); x delt/1000 -> mm
        mm_per_step = cfg.delt / 1000.0
        rday = 1.0 / cfg.nsteps
        rad = init_rad_carry(cfg.kx, cfg.il, cfg.ix, dy.dtype, dy.device)
        # stepone bootstrap (ini_stepone.f90) = window step 1
        state, (rad, fx) = dy.step(state, forcing, 0, 0, "half",
                                   phys_fn(surf, rad, True))
        state, (rad, fx) = dy.step(state, forcing, 0, 1, "delt",
                                   phys_fn(surf, rad, True))
        precip = (fx.precnv + fx.precls) * mm_per_step
        acc = (fx.hfluxn_l * rday, fx.hfluxn_s * rday,
               ice_flux(fx, surf) * rday)
        for j in range(1, nst):
            lradsw = (j % cfg.nstrad) == 0
            state, (rad, fx) = dy.step(state, forcing, 1, 1, "delt2",
                                       phys_fn(surf, rad, lradsw))
            precip = precip + (fx.precnv + fx.precls) * mm_per_step
            acc = (acc[0] + fx.hfluxn_l * rday,
                   acc[1] + fx.hfluxn_s * rday,
                   acc[2] + ice_flux(fx, surf) * rday)
        return WindowResult(gs=extract(dy, state, level=0), precip_mm=precip,
                            safe=safe, flux_sums=acc)

    # ------------------------------------------------------------------
    def _surf_forcing(self, date: ModelDate, sst_hybrid=None):
        """The window's boundary state at `date`: a fresh coupler state
        (climatology, or `sst_hybrid` where it is within 6 K of it), then
        fordate, pinned to the model dtype and uploaded."""
        sp = self.speedy
        if torch.is_tensor(sst_hybrid):
            sst_hybrid = sst_hybrid.double().cpu().numpy()
        sp.coupler = init_coupler_state(sp.clim, date, sst_hybrid=sst_hybrid)
        sp.date = date
        return sp.surf_forcing(date)

    def forecast(self, gs: GridState, date: Optional[ModelDate] = None,
                 sst_hybrid=None) -> WindowResult:
        """One window forecast from grid state `gs` valid at `date`.

        sst_hybrid, (il, ix) numpy or tensor, overrides the climatological
        SST boundary condition (the reference's ini_sea hybrid hook,
        cpl_sea.f90:38-44). The dry core of a Speedy takes the date's
        diffusion corrections (tcorh, qcorh) as the full model does; without
        a date, or built from a bare dycore, it runs on zero forcing.
        """
        if not self.physics and (self.speedy is None or date is None):
            return self.window(gs, None, self.dy.zero_forcing())
        if date is None:
            raise ValueError("a full-physics window needs its date")
        surf, forcing = self._surf_forcing(date, sst_hybrid)
        return self.window(gs, surf, forcing)


@dataclasses.dataclass
class TruthSample:
    """One 6-hourly truth record (the ERA5-slice analog)."""

    gs: GridState
    precip_mm: torch.Tensor  # accumulated over the PREVIOUS window
    sst: np.ndarray          # coupler sst_am at sample time
    tisr: np.ndarray         # (il, ix) top incoming solar, diurnal


class TrajectoryRunner:
    """Generates a 6-hourly "truth" trajectory by integrating SPEEDY
    continuously: the grid state and ONE persistent coupler state are
    carried across windows (unlike SpeedyForecaster.forecast, which
    re-initializes the coupler per window exactly as the reference
    re-launches SPEEDY).

    sst_anom_fn(date) -> (il, ix) SST anomaly [K] (coupler.anomaly) is
    imposed on the coupler's atmosphere-facing SST after every daily update:
    the truth then feels the anomaly through the surface fluxes and qcorh,
    and the recorded SST samples carry it into training. Without it the
    truth's SST is exactly climatology."""

    def __init__(self, speedy: Speedy, hours: int = 6,
                 truth_physics: bool = True, sst_anom_fn=None):
        self.speedy = speedy
        self.fc = SpeedyForecaster(speedy, hours=hours, physics=truth_physics)
        self.hours = hours
        self.sst_anom_fn = sst_anom_fn
        self.date: Optional[ModelDate] = None
        self.gs: Optional[GridState] = None
        self.cs = None
        self._day_flux = None
        self._hour = 0

    def initialize(self, year: int = 1982, month: int = 1,
                   spinup_days: int = 10):
        """Rest start + spin-up (self-generated truth needs the model to
        leave the rest state first)."""
        sp = self.speedy
        sp.initialize(year=year, month=month)
        if spinup_days:
            sp.run_days(spinup_days)
        self.date = sp.date
        self.cs = sp.coupler
        self.gs = extract(sp.dy, sp.state, level=0)
        self._hour = 0
        self._day_flux = None

    def current_sample(self, precip_mm=None) -> TruthSample:
        sp = self.speedy
        cfg = sp.config
        # hourly-resolved TISR (the reference trains on hourly ERA5 TISR,
        # speedy_res_interface.f90:368-370; daily zonal fsol has no diurnal
        # signal for the reservoirs to learn)
        tisr = diurnal_tisr(self.date.tyear, self.date.ihour,
                            sp.dy.tables.gsin, sp.dy.tables.gcos, cfg.ix)
        if precip_mm is None:
            precip_mm = torch.zeros((cfg.il, cfg.ix), dtype=sp.dy.dtype,
                                    device=sp.device)
        return TruthSample(gs=self.gs, precip_mm=precip_mm,
                           sst=np.asarray(self.cs.sst_am), tisr=tisr)

    def advance(self) -> TruthSample:
        """Advance one window; returns the truth sample at the NEW time."""
        sp = self.speedy
        sp.coupler = self.cs
        surf, forcing = sp.surf_forcing(self.date)
        res = self.fc.window(self.gs, surf, forcing)
        self.gs = res.gs
        # daily coupler update once a full day has elapsed
        sums = torch.stack(res.flux_sums).double()
        self._day_flux = sums if self._day_flux is None \
            else self._day_flux + sums
        self._hour += self.hours
        self.date.advance_hours(self.hours)
        if self._hour >= 24:
            daily_coupler_update(sp.clim, self.cs, self.date,
                                 *self._day_flux.cpu().numpy())
            if self.sst_anom_fn is not None:
                apply_sst_anomaly(self.cs, self.sst_anom_fn(self.date))
            self._hour = 0
            self._day_flux = None
        return self.current_sample(precip_mm=res.precip_mm)
