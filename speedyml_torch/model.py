"""Full-physics SPEEDY T30L8 atmosphere model (PyTorch port of
speedyml/model.py).

Orchestrates the dycore + physics + coupler at the reference's cadences
(src/at_gcm.f90): per-day fordate + flux zeroing, 96 leapfrog steps (a Python
loop of eager steps), end-of-day slab land/sea/ice update. The model state
stays on the device; the coupler works on the host in numpy float64 at the
daily cadence and its fields are uploaded once per day.

The options that are off by default run as in the JAX package: random
diabatic forcing (`rdf_on`, physics.randfor), SPPT (`sppt_on`,
physics.sppt; its noise comes from torch generators, not jax.random) and
the time-mean diagnostics with GrADS output (`time_means_on`,
utils.timemean, `write_time_means`). The 6-h window of the hybrid
forecasters runs without them, as the JAX one does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .core.calendar import ModelDate
from .core.config import ModelConfig
from .coupler.climatology import build_climatology
from .coupler.daily import (SSTFR, CouplerState, daily_coupler_update,
                            fordate, init_coupler_state)
from .dynamics.core import Dycore, Forcing
from .dynamics.initial import rest_state
from .dynamics.state import SpectralState
from .io.boundary import BoundaryData
from .physics.constants import PP, make_sigma_tables
from .physics.driver import (Physics, RadCarry, StepFluxes,
                             SurfaceDailyState, init_rad_carry)
from .physics.randfor import make_randfh
from .physics.sppt import Sppt
from .physics.surface import sflset
from .utils.timemean import (init_timemean, tm_update, tm_update_fluxes,
                             write_grads)


class DailyFluxes(NamedTuple):
    """Daily-mean fluxes for the coupler (ppo_dmflux.f90)."""

    hflux_l: torch.Tensor
    hflux_s: torch.Tensor
    hflux_i: torch.Tensor
    precip: torch.Tensor     # total precipitation [g/(m^2 s)] daily mean
    evap: torch.Tensor       # weighted evaporation [g/(m^2 s)] daily mean
    tsr: torch.Tensor
    olr: torch.Tensor


def ice_flux(fx: StepFluxes, surf: SurfaceDailyState) -> torch.Tensor:
    """Net heat flux into the sea-ice slab: the sea-surface flux plus the
    difice term over the ice-free fraction (ppo_dmflux.f90)."""
    esbc = PP.emisfc * PP.sbc
    difice = ((PP.albsea - PP.albice) * fx.ssrd
              + esbc * (SSTFR**4 - surf.tice_am**4)
              + fx.shf_s + fx.evap_s * PP.alhc)
    return fx.hfluxn_s + difice * (1.0 - surf.sice_am)


class Speedy:
    """The model on `device` (the card unless the caller names another),
    with the boundary files of `bindir` (see io.boundary; stand-in files:
    io.synthetic_boundary)."""

    def __init__(self, config: ModelConfig, bindir: str,
                 device: torch.device | str | None = None):
        self.config = config
        # dycore first (owns the spectral transform + truncated orography)
        self.dy = Dycore(config, orog=BoundaryData(bindir).orog,
                         device=device)
        self.device = self.dy.device
        self.clim = build_climatology(bindir, self.dy.tables.gcos,
                                      self.dy.tables.radang)
        self.st = make_sigma_tables(self.dy.vg.hsg)
        # orographic drag factor from the truncated surface geopotential
        # (sflset(phis0), ini_agcm_init path)
        self.phys = Physics(self.st, clat=self.dy.tables.gcos,
                            forog=sflset(self.dy.phis0_grid),
                            fmask1=self.clim.fmask_l,
                            phis0_grid=self.dy.phis0_grid,
                            dtype=self.dy.dtype, device=self.device)

        self.date: Optional[ModelDate] = None
        self.coupler: Optional[CouplerState] = None
        self.state: Optional[SpectralState] = None
        self.rad: Optional[RadCarry] = None
        self.surf: Optional[SurfaceDailyState] = None
        self.forcing: Optional[Forcing] = None
        self._bootstrapped = False

        # random diabatic forcing pattern (off by default; ini_inirdf)
        self._randfh = None
        if config.rdf_on:
            self._randfh = torch.as_tensor(
                make_randfh(self.dy.T, np.asarray(self.dy.tables.gsin),
                            config.ix, seed=config.rdf_index),
                dtype=self.dy.dtype, device=self.device)

        # time-mean diagnostics (off by default; mod_tmean/ppo_tminc/tmout)
        self.time_means = None
        if config.time_means_on:
            self.time_means = self._zero_time_means()

        # SPPT stochastic physics (off by default, mod_tsteps.f90:68): the
        # AR(1) state, and the days run so far (its noise is a function of
        # the day and the step)
        self._sppt = None
        self._sppt_state = None
        self._sppt_day = 0
        if config.sppt_on:
            self._sppt = Sppt(self.dy)
            self._sppt_state = self._sppt.init()

    # ------------------------------------------------------------------
    def _upload(self, arrays):
        """Host arrays of one shape -> tensors of the model dtype on the
        device, through one stacked copy."""
        stacked = np.stack([np.asarray(a, np.float64) for a in arrays])
        return torch.as_tensor(stacked, dtype=self.dy.dtype,
                               device=self.device).unbind(0)

    def _make_surf(self, rad_fields: dict) -> SurfaceDailyState:
        """The coupler state and fordate's fields pinned to the model dtype
        and uploaded (two copies: the (il, ix) fields and the zonal ones)."""
        cs = self.coupler
        grid = self._upload([cs.stl_am, cs.snowd_am, cs.soilw_am, cs.sst_am,
                             cs.sice_am, cs.tice_am, rad_fields["alb_l"],
                             rad_fields["alb_s"], rad_fields["albsfc"],
                             rad_fields["snowc"]])
        zonal = self._upload([rad_fields[k] for k in (
            "fsol", "ozupp", "ozone", "zenit", "stratz")])
        return SurfaceDailyState(*grid, *zonal)

    def surf_forcing(self, date: ModelDate):
        """fordate for the current coupler state at `date`: the surface
        state and the diffusion corrections, uploaded."""
        rad_fields, tcorh, qcorh = fordate(self.dy, self.clim, self.coupler,
                                           date)
        tcorh, qcorh = self._upload([tcorh, qcorh])
        return (self._make_surf(rad_fields),
                Forcing(tcorh=tcorh, qcorh=qcorh))

    def initialize(self, year: int = 1981, month: int = 1,
                   state: Optional[SpectralState] = None):
        """agcm_init equivalent: coupler init, fordate(0), rest start +
        stepone bootstrap (with physics)."""
        cfg = self.config
        self.date = ModelDate(iyear=year, imonth=month, iday=1, ihour=0)
        self.coupler = init_coupler_state(self.clim, self.date)
        self.surf, self.forcing = self.surf_forcing(self.date)
        self.state = state if state is not None else rest_state(self.dy)
        self.rad = init_rad_carry(cfg.kx, cfg.il, cfg.ix, self.dy.dtype,
                                  self.device)
        self._bootstrap()

    def _zero_time_means(self):
        cfg = self.config
        return init_timemean(cfg.kx, cfg.il, cfg.ix, self.dy.dtype,
                             self.device)

    def _phys_fn(self, surf, rad, lradsw: bool, randfh=None,
                 sppt_pattern=None):
        """The physics hook of one dycore step. The model's own steps pass
        its random diabatic forcing pattern and SPPT pattern; the hybrid
        forecasters' windows pass neither."""
        def fn(dy, fphy):
            tends, rad_new, fluxes = self.phys.step_physics(
                dy, fphy, surf, rad, lradsw, randfh=randfh)
            if sppt_pattern is not None:
                tends = self._sppt.perturb(tends, sppt_pattern)
            return tends, (rad_new, fluxes)
        return fn

    def _bootstrap(self):
        """stepone with physics: forward half-step then leapfrog half-step
        (ini_stepone.f90; lradsw=.true. initially, mod_lflags.f90:22)."""
        dy = self.dy
        state, (rad, _) = dy.step(self.state, self.forcing, 0, 0, "half",
                                  self._phys_fn(self.surf, self.rad, True,
                                                self._randfh))
        state, (rad, _) = dy.step(state, self.forcing, 0, 1, "delt",
                                  self._phys_fn(self.surf, rad, True,
                                                self._randfh))
        self.state, self.rad = state, rad
        self._bootstrapped = True

    # ------------------------------------------------------------------
    def run_day(self) -> DailyFluxes:
        """agcm_1day + coupler exchange (at_gcm.f90:38-44, 64-106)."""
        if not self._bootstrapped:
            raise RuntimeError("call initialize() first")
        dy, cfg = self.dy, self.config
        rsteps = 1.0 / cfg.nsteps

        # 1. forcing for the current date (fordate(1))
        self.surf, self.forcing = self.surf_forcing(self.date)
        surf, forcing = self.surf, self.forcing

        # 2.-3. one day of leapfrog steps with flux accumulation, the SPPT
        # pattern's step before each (its noise keyed by the day and the
        # step) and the time means after each
        state, rad = self.state, self.rad
        z = torch.zeros((cfg.il, cfg.ix), dtype=dy.dtype, device=self.device)
        acc = DailyFluxes(z, z, z, z, z, z, z)
        if self._sppt is not None:
            self._sppt_day += 1
        for j in range(cfg.nsteps):
            lradsw = (j % cfg.nstrad) == 0
            pattern = None
            if self._sppt is not None:
                self._sppt_state, pattern = self._sppt.step(
                    self._sppt_state, self._sppt_day, j)
            state, (rad, fx) = dy.step(
                state, forcing, 1, 1, "delt2",
                self._phys_fn(surf, rad, lradsw, self._randfh, pattern))
            if self.time_means is not None:
                tm = tm_update_fluxes(fx, self.time_means)
                # sample the prognostics every nstppr steps (ppo_tminc)
                if (j + 1) % cfg.nstppr == 0:
                    tm = tm_update(dy, self.st, state.at_level(0), tm)
                self.time_means = tm
            acc = DailyFluxes(
                hflux_l=acc.hflux_l + fx.hfluxn_l * rsteps,
                hflux_s=acc.hflux_s + fx.hfluxn_s * rsteps,
                hflux_i=acc.hflux_i + ice_flux(fx, surf) * rsteps,
                precip=acc.precip + (fx.precnv + fx.precls) * rsteps,
                evap=acc.evap + fx.evap * rsteps,
                tsr=acc.tsr + fx.tsr * rsteps,
                olr=acc.olr + fx.olr * rsteps)
        self.state, self.rad = state, rad

        # 4. date advance + coupler slab models (daily)
        self.date.advance_day()
        daily_coupler_update(self.clim, self.coupler, self.date,
                             *(f.double().cpu().numpy() for f in (
                                 acc.hflux_l, acc.hflux_s, acc.hflux_i)))
        return acc

    def run_days(self, ndays: int) -> Optional[DailyFluxes]:
        acc = None
        for _ in range(ndays):
            acc = self.run_day()
        return acc

    def write_time_means(self, basepath: str) -> dict:
        """tmout(imode>0) equivalent: normalize the accumulated means, write
        one GrADS record (basepath.grd + basepath.ctl), reset the
        accumulators (ppo_tmout.f90:34-42, ppo_setctl.f90). Returns the
        field dict (numpy float64)."""
        if self.time_means is None:
            raise ValueError("set ModelConfig.time_means_on")
        fields = write_grads(
            self.time_means, basepath,
            np.degrees(np.asarray(self.dy.tables.radang)),
            np.asarray(self.st.sig),
            year=self.date.iyear, month=self.date.imonth)
        self.time_means = self._zero_time_means()
        return fields

    # ------------------------------------------------------------------
    def grid_view(self, level: int = 0) -> dict:
        """Diagnostic grid-space view of the current state, as numpy."""
        T = self.dy.T
        f = self.state.at_level(level)
        ug, vg = T.uv_grid(f.vor, f.div)
        out = dict(u=ug, v=vg, t=T.spec_to_grid(f.t),
                   q=T.spec_to_grid(f.tr[0]),
                   ps=torch.exp(T.spec_to_grid(f.ps)) * 1013.0)
        return {k: v.cpu().numpy() for k, v in out.items()}
