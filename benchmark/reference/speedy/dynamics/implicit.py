"""Semi-implicit gravity-wave tables and correction step (PyTorch port of
speedyml/dynamics/implicit.py).

The per-total-wavenumber inverse matrices xj are built in numpy float64 on
the host, once per dt (the stepone bootstrap needs three), exactly as the
reference's `impint` (src/ini_impint.f90); `implicit` (src/dyn_implic.f90)
applies them as batched einsums on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.constants import DYN, PHYS
from ..core.vertical import VerticalGrid
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class ImplicitTables:
    """Numpy float64 tables from impint for a given (dt, alph)."""

    dt: float
    tref: np.ndarray    # (kx,) reference temperature profile
    tref1: np.ndarray   # rgas * tref
    tref2: np.ndarray   # akap * tref
    tref3: np.ndarray   # fsgr * tref
    xc: np.ndarray      # (kx, kx)  (already scaled by xi)
    xd: np.ndarray      # (kx, kx)
    dhsx: np.ndarray    # (kx,)
    elz: np.ndarray     # (mx, nx)
    xj_mn: np.ndarray   # (mx, nx, kx, kx) per-(m,n) inverse (0 where l == 0)


def build_implicit(vg: VerticalGrid, dt: float, alph: float,
                   mx: int, nx: int) -> ImplicitTables:
    """ini_impint.f90:43-152 in vectorized numpy."""
    kx = vg.kx
    rgas, akap, a = PHYS.rgas, PHYS.akap, PHYS.rearth
    hsg, dhs, fsg, fsgr = vg.hsg, vg.dhs, vg.fsg, vg.fsgr

    rgam = rgas * DYN.gamma / (1000.0 * PHYS.grav)
    tref = 288.0 * np.maximum(0.2, fsg) ** rgam
    tref1 = rgas * tref
    tref2 = akap * tref
    tref3 = fsgr * tref

    xi = dt * alph
    xxi = xi / (a * a)
    dhsx = xi * dhs

    ll = np.arange(mx)[:, None] + np.arange(nx)[None, :]
    elz = ll * (ll + 1.0) * xxi

    # T(K) = TEX + YA(K,K')*D(K') + XA(K,K')*SIG(K')
    ya = -akap * tref[:, None] * dhs[None, :]
    xa = np.zeros((kx, kx))
    for k in range(1, kx):
        xa[k, k - 1] = 0.5 * (akap * tref[k] / fsg[k]
                              - (tref[k] - tref[k - 1]) / dhs[k])
    for k in range(kx - 1):
        xa[k, k] = 0.5 * (akap * tref[k] / fsg[k]
                          - (tref[k + 1] - tref[k]) / dhs[k])

    # sig(k) = xb(k,k')*d(k')
    dsum = np.cumsum(dhs)
    xb = np.zeros((kx, kx))
    for k in range(kx - 1):
        for k1 in range(kx):
            xb[k, k1] = dhs[k1] * dsum[k]
            if k1 <= k:
                xb[k, k1] -= dhs[k1]

    # t(k) = tex + xc(k,k')*d(k')   (xa contributes only k2 < kx rows)
    xc = ya + xa[:, : kx - 1] @ xb[: kx - 1, :]

    # P(K) = XD(K,K')*T(K')
    xd = np.zeros((kx, kx))
    for k in range(kx):
        for k1 in range(k + 1, kx):
            xd[k, k1] = rgas * np.log(hsg[k1 + 1] / hsg[k1])
        xd[k, k] = rgas * np.log(hsg[k + 1] / fsg[k])

    xe = xd @ xc

    lmax = mx + nx - 2
    xj = np.zeros((lmax + 1, kx, kx))  # index by l, l=0 row left zero
    eye = np.eye(kx)
    for l in range(1, lmax + 1):
        xxx = l * (l + 1) / (a * a)
        xf = xi * xi * xxx * (rgas * np.outer(tref, dhs) - xe) + eye
        xj[l] = np.linalg.inv(xf)

    # gather xj per (m, n); l = m + n
    xj_mn = xj[np.minimum(ll, lmax)]
    xj_mn[ll == 0] = 0.0

    return ImplicitTables(dt=dt, tref=tref, tref1=tref1, tref2=tref2,
                          tref3=tref3, xc=xc * xi, xd=xd, dhsx=dhsx,
                          elz=elz, xj_mn=xj_mn)


class ImplicitCoefs:
    """Implicit tables as tensors on the device."""

    def __init__(self, tables: ImplicitTables,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None):
        device = resolve_device(device)
        self.dt = tables.dt

        def as_t(x):
            return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                                   device=device)
        self.tref = as_t(tables.tref)
        self.tref1 = as_t(tables.tref1)
        self.tref2 = as_t(tables.tref2)
        self.tref3 = as_t(tables.tref3)
        self.xc = as_t(tables.xc)
        self.xd = as_t(tables.xd)
        self.dhsx = as_t(tables.dhsx)
        self.elz = as_t(tables.elz)
        self.xj_mn = as_t(tables.xj_mn)


def implicit_correction(imp: ImplicitCoefs, divdt, tdt, psdt):
    """Implicit gravity-wave correction (dyn_implic.f90:27-67).

    divdt, tdt: (kx, mx, 2, nx) real-pair spectral; psdt: (mx, 2, nx).
    """
    # ye(k) = sum_k1 xd(k,k1) tdt(k1) + tref1(k) * psdt
    ye = torch.einsum("kl,lmcn->kmcn", imp.xd, tdt)
    ye = ye + imp.tref1[:, None, None, None] * psdt[None]
    yf = divdt + imp.elz[None, :, None, :] * ye
    # divdt(m,n,:) = xj(m,n) @ yf(m,n,:)
    new_divdt = torch.einsum("mnkl,lmcn->kmcn", imp.xj_mn, yf)
    new_psdt = psdt - torch.einsum("kmcn,k->mcn", new_divdt, imp.dhsx)
    new_tdt = tdt + torch.einsum("kl,lmcn->kmcn", imp.xc, new_divdt)
    return new_divdt, new_tdt, new_psdt


def geopotential_corrections(vg_np: dict) -> list[tuple[int, float]]:
    """(k, corf) of the lapse-rate correction (dyn_geop.f90:27-31), computed
    on the host from the vertical tables in the model's numpy dtype."""
    xg1, hsg, fsg = vg_np["xgeop1"], vg_np["hsg"], vg_np["fsg"]
    kx = len(fsg)
    return [(k, float(xg1[k] * 0.5 * np.log(hsg[k + 1] / fsg[k])
                      / np.log(fsg[k + 1] / fsg[k - 1])))
            for k in range(1, kx - 1)]


def geopotential(t_spec, phis, vg: dict, corrections):
    """Hydrostatic integration (dyn_geop.f90:19-32).

    t_spec: (kx, mx, 2, nx) real-pair temperature; phis: (mx, 2, nx) surface
    geopotential; vg: the vertical tables as host floats (keys xgeop1 and
    xgeop2); corrections: geopotential_corrections(...).
    Returns phi: (kx, mx, 2, nx).
    """
    kx = t_spec.shape[0]
    xg1 = vg["xgeop1"]
    xg2 = vg["xgeop2"]

    levels = [phis + float(xg1[kx - 1]) * t_spec[kx - 1]]
    for k in range(kx - 2, -1, -1):
        levels.append(levels[-1] + float(xg2[k + 1]) * t_spec[k + 1]
                      + float(xg1[k]) * t_spec[k])
    phi = torch.stack(levels[::-1], dim=0)

    # lapse-rate correction in the free troposphere, zonal (m=0) part only
    rows = [(k, corf * (t_spec[k + 1, 0, :] - t_spec[k - 1, 0, :]))
            for k, corf in corrections]
    for k, row in rows:
        phi[k, 0, :] += row
    return phi
