"""The SPEEDY T30L8 model's set-up for the reference's 6-h window (a frozen
copy of the parts of speedyml_torch/model.py that the window needs): the
dycore, the climatology, the physics tables, and `surf_forcing`, which
runs fordate for the coupler state at a date and uploads the surface state
and the diffusion corrections. The window itself is written out in
reference/hybrid.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.calendar import ModelDate
from .core.config import ModelConfig
from .coupler.climatology import build_climatology
from .coupler.daily import CouplerState, fordate
from .dynamics.core import Dycore, Forcing
from .io.boundary import BoundaryData
from .physics.constants import make_sigma_tables
from .physics.driver import Physics, SurfaceDailyState
from .physics.surface import sflset


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
