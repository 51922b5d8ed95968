"""Horizontal diffusion damping coefficients (PyTorch port of
speedyml/dynamics/hdiff.py).

The del^8 / del^2 damping set-up of the reference (src/ini_indyns.f90:94-112)
and the implicit damping factors for one dt (src/ini_impint.f90:34-41). The
tables are numpy float64 on the host; the coefficients are tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.constants import DYN
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DiffusionTables:
    dmp: np.ndarray    # (mx, nx) del^8 damping for vor, T
    dmpd: np.ndarray   # (mx, nx) del^8 damping for div
    dmps: np.ndarray   # (mx, nx) del^2 stratospheric damping


def build_diffusion(ntrun: int, mx: int, nx: int) -> DiffusionTables:
    hdiff = 1.0 / (DYN.thd * 3600.0)
    hdifd = 1.0 / (DYN.thdd * 3600.0)
    hdifs = 1.0 / (DYN.thds * 3600.0)
    rlap = 1.0 / (ntrun * (ntrun + 1))

    twn = (np.arange(mx)[:, None] + np.arange(nx)[None, :]).astype(np.float64)
    elap = twn * (twn + 1.0) * rlap
    elapn = elap ** DYN.npowhd
    return DiffusionTables(dmp=hdiff * elapn, dmpd=hdifd * elapn,
                           dmps=hdifs * elap)


class DiffusionCoefs:
    """Damping coefficients for one dt, as (mx, 1, nx) tensors that broadcast
    over level axes and the (re, im) axis."""

    def __init__(self, tables: DiffusionTables, dt: float,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None):
        device = resolve_device(device)

        def as_t(x):
            return torch.as_tensor(np.asarray(x, np.float64)[:, None, :],
                                   dtype=dtype, device=device)
        self.dmp = as_t(tables.dmp)
        self.dmpd = as_t(tables.dmpd)
        self.dmps = as_t(tables.dmps)
        self.dmp1 = as_t(1.0 / (1.0 + tables.dmp * dt))
        self.dmp1d = as_t(1.0 / (1.0 + tables.dmpd * dt))
        self.dmp1s = as_t(1.0 / (1.0 + tables.dmps * dt))


def hordif(field, fdt, dmp, dmp1):
    """fdt <- (fdt - dmp*field) * dmp1 (dyn_step.f90:130-151)."""
    return (fdt - dmp * field) * dmp1
