"""The semi-implicit leapfrog dynamical core (PyTorch port of
speedyml/dynamics/core.py).

The reference's stepping machinery (src/dyn_step.f90, src/ini_stepone.f90)
as functions over a `SpectralState` of tensors. The implicit and diffusion
tables for the three dt values of the stepone bootstrap ("half", "delt",
"delt2") are built at construction. A caller integrates by looping over
`step` in Python.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.config import ModelConfig
from ..core.constants import DYN, PHYS
from ..core.vertical import make_vertical_grid
from ..device import resolve_device
from ..transforms.spectral import SpectralTransform
from ..transforms.tables import build_tables
from .hdiff import DiffusionCoefs, build_diffusion, hordif
from .implicit import (ImplicitCoefs, build_implicit,
                       geopotential_corrections, implicit_correction)
from .state import SpectralState, Tendencies
from .tendencies import grtend, sptend


class Forcing(NamedTuple):
    """Date-dependent spectral correction fields (reference mod_hdifcon.f90
    tcorh/qcorh)."""

    tcorh: torch.Tensor   # (mx, 2, nx) real-pair spectral
    qcorh: torch.Tensor   # (mx, 2, nx)


class Dycore:
    """Holds the static coefficients on `device` (the card unless the
    caller names another); exposes the step functions. config.dtype picks
    float32 or float64 for all state."""

    def __init__(self, config: ModelConfig = ModelConfig(),
                 orog: Optional[np.ndarray] = None,
                 device: torch.device | str | None = None):
        if config.grid_compute not in ("float32", "bfloat16"):
            raise ValueError(f"grid_compute {config.grid_compute!r}: "
                             f"float32 or bfloat16")
        self.config = config
        self.device = resolve_device(device)
        self.dtype = torch.float64 if config.dtype == "float64" \
            else torch.float32
        self.np_dtype = np.float64 if config.dtype == "float64" \
            else np.float32
        dtype, dev = self.dtype, self.device

        tables = build_tables(config.ntrun, config.ix, config.il)
        self.tables = tables
        self.T = SpectralTransform(tables, dtype=dtype, device=dev)
        self.vg = make_vertical_grid(config.kx)
        # vertical tables in the model's numpy dtype (host constants) and as
        # tensors (device constants)
        self.vg_np = {k: np.asarray(getattr(self.vg, k), dtype=self.np_dtype)
                      for k in ("hsg", "dhs", "fsg", "dhsr", "fsgr",
                                "xgeop1", "xgeop2")}
        self.vgt = {k: torch.as_tensor(v, device=dev)
                    for k, v in self.vg_np.items()}
        self.geop_corrections = geopotential_corrections(self.vg_np)
        self.akap = PHYS.akap
        self.rgas = PHYS.rgas
        self.sdrag = 1.0 / (DYN.tdrs * 3600.0)
        # opt-in reduced-precision grid-space tendency compute
        # (ModelConfig.grid_compute; tendencies.grtend); None = full
        self.grid_dtype = (torch.bfloat16 if config.grid_compute
                           == "bfloat16" else None)

        # surface geopotential: spec(grav*orog) truncated (ini_invars.f90:31-34)
        if orog is None:
            orog = np.zeros((config.il, config.ix))
        phi0 = PHYS.grav * np.asarray(orog, dtype=np.float64)
        phis = self.T.host_trunct(self.T.host_grid_to_spec(phi0))
        self.phis_np = np.asarray(phis, self.np_dtype)    # (mx, 2, nx)
        self.phis = torch.as_tensor(self.phis_np, device=dev)
        self.phis0_grid = np.asarray(self.T.host_spec_to_grid(phis),
                                     self.np_dtype)

        # implicit + diffusion tables for the three dt values of the bootstrap
        diff = build_diffusion(config.ntrun, config.mx, config.nx)
        self._imp = {}
        self._dif = {}
        self._dt = {"half": 0.5 * config.delt, "delt": config.delt,
                    "delt2": config.delt2}
        for key, dtv in self._dt.items():
            self._imp[key] = ImplicitCoefs(
                build_implicit(self.vg, dtv, config.alph, config.mx,
                               config.nx), dtype=dtype, device=dev)
            self._dif[key] = DiffusionCoefs(diff, dtv, dtype=dtype,
                                            device=dev)
        self.imp_main = self._imp["delt2"]

        # orographic-correction vertical profiles (ini_indyns.f90:114-127)
        rgam = PHYS.rgas * DYN.gamma / (1000.0 * PHYS.grav)
        qexp = DYN.hscale / DYN.hshum
        fsg = self.vg.fsg
        tcorv = np.zeros(config.kx)
        qcorv = np.zeros(config.kx)
        tcorv[1:] = fsg[1:] ** rgam
        qcorv[2:] = fsg[2:] ** qexp
        self.tcorv = torch.as_tensor(np.asarray(tcorv, self.np_dtype),
                                     device=dev)
        self.qcorv = torch.as_tensor(np.asarray(qcorv, self.np_dtype),
                                     device=dev)

    def zero_forcing(self) -> Forcing:
        z = torch.zeros((self.config.mx, 2, self.config.nx), dtype=self.dtype,
                        device=self.device)
        return Forcing(tcorh=z, qcorh=z)

    # ------------------------------------------------------------------
    def _diffuse(self, state: SpectralState, tend: Tendencies,
                 forcing: Forcing, dif: DiffusionCoefs) -> Tendencies:
        """Horizontal diffusion + stratospheric drag (dyn_step.f90:60-106)."""
        vor0, div0, t0, tr0 = state.vor[0], state.div[0], state.t[0], \
            state.tr[0]

        vordt = hordif(vor0, tend.vordt, dif.dmp, dif.dmp1)
        divdt = hordif(div0, tend.divdt, dif.dmpd, dif.dmp1d)
        ctmp = t0 + forcing.tcorh[None] * self.tcorv[:, None, None, None]
        tdt = hordif(ctmp, tend.tdt, dif.dmp, dif.dmp1)

        # stratospheric zonal-mean drag on the top level (dyn_step.f90:78-82)
        vordt[0, 0, :] += -self.sdrag * vor0[0, 0, :]
        divdt[0, 0, :] += -self.sdrag * div0[0, 0, :]

        # extra del^2 stratospheric diffusion on the top level
        vordt[0] = hordif(vor0[0], vordt[0], dif.dmps, dif.dmp1s)
        divdt[0] = hordif(div0[0], divdt[0], dif.dmps, dif.dmp1s)
        tdt[0] = hordif(ctmp[0], tdt[0], dif.dmps, dif.dmp1s)

        # tracers: humidity (tracer 0) uses dmpd with orographic correction
        qtmp = tr0.clone()
        qtmp[0] += forcing.qcorh[None] * self.qcorv[:, None, None, None]
        trdt = tend.trdt.clone()
        trdt[0] = hordif(qtmp[0], tend.trdt[0], dif.dmpd, dif.dmp1d)
        if self.config.ntr > 1:
            trdt[1:] = hordif(qtmp[1:], trdt[1:], dif.dmp, dif.dmp1)
        return Tendencies(vordt=vordt, divdt=divdt, tdt=tdt, psdt=tend.psdt,
                          trdt=trdt)

    def _timint(self, field, fdt, j1: int, dt: float, eps: float,
                wil: float):
        """Leapfrog with Robert-Williams filter (dyn_step.f90:153-190).

        field: (2, ...) both time levels; fdt the tendency (truncated here).
        """
        fdt = self.T.trunct(fdt)
        fj = field[j1]
        fnew = field[0] + dt * fdt
        f0 = fj + wil * eps * (field[0] - 2 * fj + fnew)
        f1 = fnew - (1 - wil) * eps * (f0 - 2 * fj + fnew)
        return torch.stack([f0, f1], dim=0)

    def step(self, state: SpectralState, forcing: Forcing, j1: int, j2: int,
             dt_key: str, phys_fn: Optional[Callable] = None):
        """One (forward or leapfrog) time step (dyn_step.f90:1-128).

        j1/j2 are 0-based time-level indices (reference's J1-1/J2-1):
          j1=0, j2=0: forward step; j1=0, j2=1: initial leapfrog;
          j1=1, j2=1: filtered leapfrog.

        Returns the new state, or (state, extras) when phys_fn is given
        (the grtend hook's contract).
        """
        cfg = self.config
        imp = self._imp[dt_key]
        dif = self._dif[dt_key]
        dt = self._dt[dt_key]

        tend, extras = grtend(self, state.at_level(j2), state.at_level(0),
                              phys_fn)
        if cfg.alph == 0.0:
            tend = sptend(self, state.at_level(j2), tend, imp)
        else:
            tend = sptend(self, state.at_level(0), tend, imp)
            divdt, tdt, psdt = implicit_correction(imp, tend.divdt, tend.tdt,
                                                   tend.psdt)
            tend = tend._replace(divdt=divdt, tdt=tdt, psdt=psdt)

        tend = self._diffuse(state, tend, forcing, dif)

        eps = 0.0 if j1 == 0 else cfg.rob
        wil = cfg.wil

        def ti(field, fdt):
            return self._timint(field, fdt, j1=j1, dt=dt, eps=eps, wil=wil)

        new_state = SpectralState(vor=ti(state.vor, tend.vordt),
                                  div=ti(state.div, tend.divdt),
                                  t=ti(state.t, tend.tdt),
                                  ps=ti(state.ps, tend.psdt),
                                  tr=ti(state.tr, tend.trdt))
        if phys_fn is None:
            return new_state
        return new_state, extras

    def stepone(self, state: SpectralState, forcing: Forcing,
                phys_fn: Optional[Callable] = None):
        """Initial forward + leapfrog half-steps (ini_stepone.f90:14-31)."""
        if phys_fn is None:
            state = self.step(state, forcing, 0, 0, "half")
            return self.step(state, forcing, 0, 1, "delt")
        state, _ = self.step(state, forcing, 0, 0, "half", phys_fn)
        return self.step(state, forcing, 0, 1, "delt", phys_fn)

    def make_scan_step(self, phys_fn: Optional[Callable] = None):
        """f(state, forcing): one leapfrog step of the main loop."""
        def f(state, forcing):
            return self.step(state, forcing, 1, 1, "delt2", phys_fn)
        return f

    def run_steps(self, state: SpectralState, forcing: Forcing, nsteps: int,
                  phys_fn: Optional[Callable] = None) -> SpectralState:
        """nsteps leapfrog steps (the JAX package's lax.scan as a Python
        loop). With phys_fn each step's extras are dropped."""
        step_fn = self.make_scan_step(phys_fn)
        for _ in range(nsteps):
            state = step_fn(state, forcing)
            if phys_fn is not None:
                state = state[0]
        return state
