"""Humidity conversions (PyTorch port of speedyml/physics/humidity.py;
reference: src/phy_shtorh.f90)."""

from __future__ import annotations

import torch


def qsat_gkg(ta, pres_norm):
    """Saturation specific humidity [g/kg] at temperature ta [K] and
    normalized pressure p/p0 (phy_shtorh.f90:36-56)."""
    e0, c1, c2 = 6.108e-3, 17.269, 21.875
    t0, t1, t2 = 273.16, 35.86, 7.66
    es = torch.where(ta >= t0,
                     e0 * torch.exp(c1 * (ta - t0) / (ta - t1)),
                     e0 * torch.exp(c2 * (ta - t0) / (ta - t2)))
    return 622.0 * es / (pres_norm - 0.378 * es)


def rel_hum(qa, ta, pres_norm):
    """q [g/kg] -> (rh, qsat) (shtorh imode > 0)."""
    qs = qsat_gkg(ta, pres_norm)
    return qa / qs, qs
