"""SPEEDY window forecasts + truth-trajectory generation for the hybrid model
(PyTorch port of speedyml/hybrid/forecast.py).

A window injects a grid state, runs the stepone bootstrap and then leapfrog
steps with physics to the end of the window (6 h = 24 steps at T30), and
extracts the grid state, with the window's precipitation and the coupler's
heat fluxes summed on the way. The steps are a Python loop of eager calls.

The same window drives truth-trajectory generation: a TrajectoryRunner
carries the grid state across windows and applies the daily land/sea/ice
coupler update; a FusedDataGenerator runs the truth a day at a time beside
the imperfect model's forecasts, for bulk training data.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.calendar import ModelDate, hours_since_epoch
from ..coupler.anomaly import apply_sst_anomaly
from ..coupler.daily import (daily_coupler_update, fordate,
                             init_coupler_state)
from ..device import Download
from ..dynamics.core import Dycore, Forcing
from ..model import Speedy, ice_flux
from ..physics.driver import init_rad_carry, phys_hook
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
    def window(self, gs: GridState, surf, forcing, dy=None, phys=None,
               il: Optional[int] = None) -> WindowResult:
        """One window from grid state `gs` under the surface state `surf`
        (unused by the dry core) and the diffusion corrections `forcing`.
        It runs whatever the safety flag says; the caller decides what an
        unsafe start means.

        dy, phys and il replace the forecaster's dycore, its model's physics
        and the grid's latitude count: parallel.composed passes a rank's
        latitude-local copies (parallel.spatial) and its block's row count,
        and gs, surf and the results are then that rank's rows (the JAX
        package's _window_fn(dy=, phys=, il=))."""
        dy = dy if dy is not None else self.dy
        cfg = dy.config
        il = il if il is not None else cfg.il
        nst = self.nsteps_window
        state, safe = inject(dy, gs)
        z = torch.zeros((il, cfg.ix), dtype=dy.dtype, device=dy.device)

        if not self.physics:
            state = dy.step(state, forcing, 0, 0, "half")
            state = dy.step(state, forcing, 0, 1, "delt")
            for _ in range(nst - 1):
                state = dy.step(state, forcing, 1, 1, "delt2")
            return WindowResult(gs=extract(dy, state, level=0), precip_mm=z,
                                safe=safe, flux_sums=(z, z, z))

        phys = phys if phys is not None else self.speedy.phys

        # precip unit: physics precnv/precls are g/(m^2 s); x delt/1000 -> mm
        mm_per_step = cfg.delt / 1000.0
        rday = 1.0 / cfg.nsteps
        rad = init_rad_carry(cfg.kx, il, cfg.ix, dy.dtype, dy.device)
        # stepone bootstrap (ini_stepone.f90) = window step 1
        state, (rad, fx) = dy.step(state, forcing, 0, 0, "half",
                                   phys_hook(phys, surf, rad, True))
        state, (rad, fx) = dy.step(state, forcing, 0, 1, "delt",
                                   phys_hook(phys, surf, rad, True))
        precip = (fx.precnv + fx.precls) * mm_per_step
        acc = (fx.hfluxn_l * rday, fx.hfluxn_s * rday,
               ice_flux(fx, surf) * rday)
        for j in range(1, nst):
            lradsw = (j % cfg.nstrad) == 0
            state, (rad, fx) = dy.step(state, forcing, 1, 1, "delt2",
                                       phys_hook(phys, surf, rad, lradsw))
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


class FusedDataGenerator:
    """Day-batched truth + imperfect-model training data.

    Each day runs wpd = 24 // hours truth windows (full physics unless
    truth_physics=False) and, after each, a dry-core window launched from
    that window's START state with q clamped at 0, as collect_forecasts
    launches from a saved truth state. The dry window's diffusion
    corrections come from a FRESH climatological coupler carrying the day's
    SST (the reference re-launches SPEEDY for every forecast,
    mpires.f90:1548-1660). fordate for the truth runs once a day, at the
    reference's cadence (fordate(1), at_gcm.f90:64-70), so this truth is not
    TrajectoryRunner's, which refreshes it every window.

    The day's windows are launched with no host sync into preallocated
    (wpd, ...) stacks on the device. The host then reads two things, the
    day's flux sums and its safety flag, in one copy; starts the day's
    download into pinned host buffers on a side stream, which runs beside
    the next day's kernels; and runs the daily coupler update and the SST
    anomaly on the host, whose post-update SST is the day's last sample's.

    sst_anom_fn(date) -> (il, ix) SST anomaly [K] (coupler.anomaly), imposed
    after initialize() and after every daily update: the truth feels it
    through the surface fluxes and qcorh, and the recorded SST carries it
    into training. truth_physics=False (a dry truth) exists for parity
    tests: full-physics windows amplify rounding through their discrete
    triggers, so only the dry core compares tightly across implementations.
    """

    def __init__(self, speedy: Speedy, hours: int = 6,
                 truth_physics: bool = True, sst_anom_fn=None):
        if 24 % hours:
            raise ValueError(f"{hours} h windows do not divide a day")
        self.speedy = speedy
        self.hours = hours
        self.wpd = 24 // hours           # windows per day
        self.sst_anom_fn = sst_anom_fn
        self.fc_phys = SpeedyForecaster(speedy, hours=hours,
                                        physics=truth_physics)
        self.fc_dry = SpeedyForecaster(speedy, hours=hours, physics=False)
        self.date: Optional[ModelDate] = None
        self.gs: Optional[GridState] = None
        self.cs = None
        self._side = torch.cuda.Stream(speedy.device) \
            if speedy.device.type == "cuda" else None

    def initialize(self, year: int = 1982, month: int = 1,
                   spinup_days: int = 10):
        """Rest start + spin-up; the SST anomaly is imposed from the start."""
        sp = self.speedy
        sp.initialize(year=year, month=month)
        if spinup_days:
            sp.run_days(spinup_days)
        self.date = sp.date
        self.cs = sp.coupler
        if self.sst_anom_fn is not None:
            apply_sst_anomaly(self.cs, self.sst_anom_fn(self.date))
        self.gs = extract(sp.dy, sp.state, level=0)

    def _day_inputs(self):
        """The day's boundary state, made on the host and uploaded: fordate
        once for the truth windows (surface state and forcing), and one
        fresh-coupler forcing per window for the dry forecasts, all of them
        in one copy. Returns (surf, forcing, dry_forcings, sst_day)."""
        sp = self.speedy
        sp.coupler = self.cs
        surf, forcing = sp.surf_forcing(self.date)
        sst_day = np.array(self.cs.sst_am)
        corr = []
        d = ModelDate(self.date.iyear, self.date.imonth, self.date.iday,
                      self.date.ihour)
        for _ in range(self.wpd):
            cs_w = init_coupler_state(sp.clim, d, sst_hybrid=sst_day)
            _, tcorh, qcorh = fordate(sp.dy, sp.clim, cs_w, d)
            corr += [tcorh, qcorh]
            d.advance_hours(self.hours)
        up = sp._upload(corr)
        dry = [Forcing(tcorh=up[2 * w], qcorh=up[2 * w + 1])
               for w in range(self.wpd)]
        return surf, forcing, dry, sst_day

    def _run_day(self, gs: GridState, surf, forcing, dry_forcings):
        """The day's windows from grid state gs. Nothing here reads a value
        back to the host. Returns (gs at the day's end, the stacks [atmo,
        logp, precip, m_atmo, m_logp] (wpd, ...), the day's flux sums
        (3, il, ix), the day's safety flag as a 0-d bool tensor)."""
        dy = self.speedy.dy
        cfg = dy.config
        wpd = self.wpd

        def stack(*shape):
            return torch.empty((wpd,) + shape, dtype=dy.dtype,
                               device=dy.device)

        atmo, m_atmo = stack(4, cfg.kx, cfg.il, cfg.ix), \
            stack(4, cfg.kx, cfg.il, cfg.ix)
        logp, precip, m_logp = (stack(cfg.il, cfg.ix) for _ in range(3))
        fx = safe = None
        for w in range(wpd):
            res = self.fc_phys.window(gs, surf, forcing)
            dres = self.fc_dry.window(
                gs._replace(q=torch.clamp(gs.q, min=0.0)), surf,
                dry_forcings[w])
            for i, f in enumerate(res.gs[:4]):
                atmo[w, i] = f
            for i, f in enumerate(dres.gs[:4]):
                m_atmo[w, i] = f
            logp[w] = res.gs.logp
            m_logp[w] = dres.gs.logp
            precip[w] = res.precip_mm
            sums = torch.stack(res.flux_sums)
            fx = sums if fx is None else fx + sums
            ok = res.safe & dres.safe
            safe = ok if safe is None else safe & ok
            gs = res.gs
        return gs, [atmo, logp, precip, m_atmo, m_logp], fx, safe

    def generate(self, n_samples: int, verbose: int = 0, log=print) -> dict:
        """n_samples 6-hourly truth samples and the aligned dry-core
        forecasts, as host numpy: the TruthSeries fields (atmo, logp,
        precip, sst, tisr, hours) plus m_atmo, m_logp and m_precip (all
        zeros: the dry core has no precipitation). m_*[t] is the forecast
        VALID at sample t, launched from t-1; index 0 is launched from the
        pre-series state, a usable pair (collect_forecasts copies truth
        there). verbose: a progress line every so many days, handed to
        `log` (print by default)."""
        sp = self.speedy
        ix = sp.config.ix
        n_days = -(-n_samples // self.wpd)
        keys = ("atmo", "logp", "precip", "m_atmo", "m_logp")
        out = {k: [] for k in keys + ("sst", "tisr", "hours")}

        def flush(dl, sst, tisr, hours):
            for k, a in zip(keys, dl.arrays()):
                out[k].append(a)
            out["sst"].append(np.stack(sst))
            out["tisr"].append(np.stack(tisr))
            out["hours"].append(np.asarray(hours))

        pending = None
        t0 = time.perf_counter()
        for di in range(n_days):
            surf, forcing, dry, sst_day = self._day_inputs()
            self.gs, stacks, fx, safe = self._run_day(self.gs, surf,
                                                      forcing, dry)
            # the day's one read of the device: flux sums and flag together
            head = torch.cat([fx.reshape(-1).double(),
                              safe.reshape(1).double()]).cpu().numpy()
            if not head[-1]:
                raise RuntimeError(f"the truth trajectory tripped the safety "
                                   f"gate on day {di}")
            dl = Download(stacks, self.wpd, self._side)
            if pending is not None:
                flush(*pending)
            # per sample: the date and TISR at each window's end; the day's
            # last sample carries the NEW day's (post-update) SST, as in
            # TrajectoryRunner.advance
            sst, tisr, hours = [], [], []
            d = self.date
            for _ in range(self.wpd):
                d.advance_hours(self.hours)
                tisr.append(diurnal_tisr(d.tyear, d.ihour, sp.dy.tables.gsin,
                                         sp.dy.tables.gcos, ix))
                hours.append(hours_since_epoch(d.iyear, d.imonth, d.iday,
                                               d.ihour))
                sst.append(sst_day)
            daily_coupler_update(sp.clim, self.cs, self.date,
                                 *head[:-1].reshape(3, *sst_day.shape))
            if self.sst_anom_fn is not None:
                apply_sst_anomaly(self.cs, self.sst_anom_fn(self.date))
            sst[-1] = np.array(self.cs.sst_am)
            pending = (dl, sst, tisr, hours)
            if verbose and (di + 1) % verbose == 0:
                el = time.perf_counter() - t0
                log(f"  day {di + 1}/{n_days} ({el:.0f}s, "
                    f"{el / ((di + 1) * self.wpd):.2f}s/sample)")
        flush(*pending)
        res = {k: np.concatenate(v)[:n_samples] for k, v in out.items()}
        res["m_precip"] = np.zeros_like(res["precip"])
        return res
