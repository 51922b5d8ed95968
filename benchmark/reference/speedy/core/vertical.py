"""Sigma-coordinate vertical discretization.

The port's own copy of speedyml/core/vertical.py: the vertical-level setup
of the reference (src/ini_indyns.f90:36-64, src/dyn_geop.f90) as pure numpy
tables, which the dynamics turn into tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import PHYS

_HSG_TABLES = {
    5: np.array([0.000, 0.150, 0.350, 0.650, 0.900, 1.000]),
    7: np.array([0.020, 0.140, 0.260, 0.420, 0.600, 0.770, 0.900, 1.000]),
    8: np.array([0.000, 0.050, 0.140, 0.260, 0.420, 0.600, 0.770, 0.900, 1.000]),
}


@dataclasses.dataclass(frozen=True)
class VerticalGrid:
    """Half/full sigma levels and derived coefficients (float64 numpy).

    Attributes mirror the quantities in the reference (ini_indyns.f90:51-64,
    ini_indyns.f90:88-92):
      hsg  : (kx+1,) half-level sigma (interfaces, 0=top)
      dhs  : (kx,)   layer thickness
      fsg  : (kx,)   full-level sigma (layer centers)
      dhsr : (kx,)   0.5 / dhs
      fsgr : (kx,)   akap / (2 * fsg)
      xgeop1, xgeop2 : (kx,) hydrostatic-integration coefficients
    """

    kx: int
    hsg: np.ndarray
    dhs: np.ndarray
    fsg: np.ndarray
    dhsr: np.ndarray
    fsgr: np.ndarray
    xgeop1: np.ndarray
    xgeop2: np.ndarray


def make_vertical_grid(kx: int = 8) -> VerticalGrid:
    hsg = _HSG_TABLES[kx].astype(np.float64)
    dhs = hsg[1:] - hsg[:-1]
    fsg = 0.5 * (hsg[1:] + hsg[:-1])
    dhsr = 0.5 / dhs
    fsgr = PHYS.akap / (2.0 * fsg)

    rgas = PHYS.rgas
    xgeop1 = rgas * np.log(hsg[1:] / fsg)
    xgeop2 = np.zeros(kx)
    # xgeop2[k+1] = rgas*log(fsg[k+1]/hsg[k+1]) in 1-based Fortran; here index k
    # holds the coefficient applied to level k when integrating from below.
    xgeop2[1:] = rgas * np.log(fsg[1:] / hsg[1:-1])
    return VerticalGrid(kx=kx, hsg=hsg, dhs=dhs, fsg=fsg, dhsr=dhsr,
                        fsgr=fsgr, xgeop1=xgeop1, xgeop2=xgeop2)
