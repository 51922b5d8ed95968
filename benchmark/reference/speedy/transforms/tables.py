"""Static spherical-harmonic transform tables (numpy float64); the port's own
copy of speedyml/transforms/tables.py.

Builds everything the reference computes in `parmtr`/`lgndre`/`gaussl`
(src/spe_spectral.f90:2-242) plus latitude functions (src/ini_indyns.f90:72-85),
re-shaped for batched einsum/matmul evaluation instead of per-latitude
scalar loops.

Conventions (all 0-based):
  m = zonal wavenumber index, 0..mx-1  (mx = ntrun+1)
  n = "offset" index, 0..nx-1          (nx = ntrun+2); total wavenumber l = m+n
  grid rows run south -> north (row 0 = southernmost latitude), matching the
  reference's "J=1 is Southernmost point" convention (ini_indyns.f90:73).
  Spectral fields are complex (mx, nx); Fourier fields complex (il, mx);
  grid fields real (il, ix).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.constants import PHYS


def gauss_legendre(iy: int) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian latitudes for one hemisphere, pole -> equator.

    Returns (sia, wt): sin(latitude) and quadrature weights for the iy roots
    with positive sin(lat), ordered from pole to equator (largest sia first),
    matching the reference's `gaussl` (spe_spectral.f90:2-43).
    """
    n = 2 * iy
    x = np.zeros(iy)
    w = np.zeros(iy)
    for i in range(iy):
        z = np.cos(np.pi * (i + 0.75) / (n + 0.5))
        z1 = 2.0
        while abs(z - z1) > 3e-14:
            p1, p2 = 1.0, 0.0
            for j in range(1, n + 1):
                p3 = p2
                p2 = p1
                p1 = ((2.0 * j - 1.0) * z * p2 - (j - 1.0) * p3) / j
            pp = n * (z * p1 - p2) / (z * z - 1.0)
            z1 = z
            z = z1 - p1 / pp
        x[i] = z
        w[i] = 2.0 / ((1.0 - z * z) * pp * pp)
    return x, w


def _legendre_poly(sia: float, coa: float, mx: int, nx: int) -> np.ndarray:
    """Normalized associated Legendre table alp[m, n] at one latitude.

    Recursion follows the reference `lgndre` (spe_spectral.f90:194-242);
    total wavenumber l = m + n.
    """
    mxp, nxp = mx, nx + 1  # for isc=1: mxp = mtrun+1 = mx
    emm = np.arange(mxp, dtype=np.float64)
    ell = emm[:, None] + np.arange(nxp, dtype=np.float64)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        epsi = np.sqrt((ell**2 - emm[:, None] ** 2) / (4.0 * ell**2 - 1.0))
    epsi[:, nxp - 1] = 0.0
    epsi[0, 0] = 0.0
    repsi = np.where(epsi > 0.0, 1.0 / np.where(epsi > 0, epsi, 1.0), 0.0)

    alp = np.zeros((mxp, nx))
    alp[0, 0] = np.sqrt(0.5)
    for m in range(1, mxp):
        consq = np.sqrt(0.5 * (2.0 * m + 1.0) / m)
        alp[m, 0] = consq * coa * alp[m - 1, 0]
    alp[:, 1] = sia * alp[:, 0] * repsi[:, 1]
    for n in range(2, nx):
        alp[:, n] = (sia * alp[:, n - 1] - epsi[:, n - 1] * alp[:, n - 2]) * repsi[:, n]
    alp[np.abs(alp) <= 1e-30] = 0.0
    return alp


@dataclasses.dataclass(frozen=True)
class SpectralTables:
    """All static operators for the T{ntrun} transform; numpy float64."""

    # sizes
    ntrun: int
    ix: int
    il: int
    iy: int
    mx: int
    nx: int

    # latitude functions (full grid, south -> north)
    sia_half: np.ndarray   # (iy,) sin(lat), pole->equator (positive)
    wt: np.ndarray         # (iy,) Gaussian weights
    radang: np.ndarray     # (il,) latitude [rad]
    gsin: np.ndarray       # (il,) sin(lat)
    gcos: np.ndarray       # (il,) cos(lat)
    coriol: np.ndarray     # (il,) 2*omega*sin(lat)
    cosgr: np.ndarray      # (il,) 1/cos(lat)
    cosgr2: np.ndarray     # (il,) 1/cos^2(lat)

    # spectral-space operators (mx, nx)
    el2: np.ndarray        # l(l+1)/a^2   (Laplacian factor)
    elm2: np.ndarray       # inverse of el2 (0 at l=0)
    el4: np.ndarray        # el2^2
    trfilt: np.ndarray     # triangular-truncation filter (l <= ntrun)
    gradx: np.ndarray      # (mx,) m/a
    gradym: np.ndarray     # (mx, nx)
    gradyp: np.ndarray     # (mx, nx)
    uvdx: np.ndarray       # (mx, nx)
    uvdym: np.ndarray      # (mx, nx)
    uvdyp: np.ndarray      # (mx, nx)
    vddym: np.ndarray      # (mx, nx)
    vddyp: np.ndarray      # (mx, nx)

    # Legendre matmul operators over the FULL latitude grid
    leg_inv: np.ndarray    # (mx, nx, il): spec -> fourier   (gridy equivalent)
    leg_fwd: np.ndarray    # (mx, nx, il): fourier -> spec   (specy equivalent)


def build_tables(ntrun: int = 30, ix: int = 96, il: int = 48) -> SpectralTables:
    iy = il // 2
    mx = ntrun + 1
    nx = ntrun + 2
    a = PHYS.rearth

    sia, wt = gauss_legendre(iy)
    coa = np.sqrt(1.0 - sia**2)

    # full-grid latitude functions; row 0 = south pole side (ini_indyns.f90:72-85)
    rad_half = np.arcsin(sia)              # pole -> equator, positive
    radang = np.concatenate([-rad_half, rad_half[::-1]])
    gsin = np.sin(radang)
    gcos = np.cos(radang)
    coriol = 2.0 * PHYS.omega * gsin
    cosgr = 1.0 / gcos
    cosgr2 = 1.0 / gcos**2

    m_idx = np.arange(mx, dtype=np.float64)
    n_idx = np.arange(nx, dtype=np.float64)
    ll = m_idx[:, None] + n_idx[None, :]          # total wavenumber l
    el2 = ll * (ll + 1.0) / a**2
    el4 = el2**2
    elm2 = np.zeros_like(el2)
    elm2[el2 > 0] = 1.0 / el2[el2 > 0]
    trfilt = (ll <= ntrun).astype(np.float64)

    # epsilon table used in the derivative couplings (parmtr, spe_spectral.f90:130-146)
    # epsi_p[m, n] in the reference's 1-based code is epsi(m2, n) with m2 = m+1:
    # eps(l, m) = sqrt((l^2 - m^2)/(4 l^2 - 1)) evaluated at l = m + n (0-based).
    def eps(l_arr, m_arr):
        with np.errstate(divide="ignore", invalid="ignore"):
            v = np.sqrt((l_arr**2 - m_arr**2) / (4.0 * l_arr**2 - 1.0))
        return np.nan_to_num(v)

    el1 = ll  # float l
    m2d = np.broadcast_to(m_idx[:, None], (mx, nx)).astype(np.float64)
    # reference: epsi(m2,n) with ell(m2,n) = n + (m+1) - 2 = l (0-based l = m+n)
    eps_n = eps(el1, m2d)           # epsi at (l, m)
    eps_p = eps(el1 + 1.0, m2d)     # epsi at (l+1, m) -> epsi(m2, n+1)

    gradx = m_idx / a
    gradym = np.zeros((mx, nx))
    gradyp = np.zeros((mx, nx))
    uvdx = np.zeros((mx, nx))
    uvdym = np.zeros((mx, nx))
    uvdyp = np.zeros((mx, nx))
    vddym = np.zeros((mx, nx))
    vddyp = np.zeros((mx, nx))

    # n = 0 row (reference n==1 branch, spe_spectral.f90:160-170)
    uvdx[:, 0] = -a / (m_idx + 1.0)
    # rows n >= 1
    with np.errstate(divide="ignore", invalid="ignore"):
        uvdx[:, 1:] = -a * m_idx[:, None] / (el1[:, 1:] * (el1[:, 1:] + 1.0))
    uvdx[0, 1:] = 0.0  # m=0: numerator 0 (l>0 there so no 0/0)
    gradym[:, 1:] = (el1[:, 1:] - 1.0) * eps_n[:, 1:] / a
    uvdym[:, 1:] = -a * eps_n[:, 1:] / el1[:, 1:]
    vddym[:, 1:] = (el1[:, 1:] + 1.0) * eps_n[:, 1:] / a
    gradyp[:, :] = (el1 + 2.0) * eps_p / a
    uvdyp[:, :] = -a * eps_p / (el1 + 1.0)
    vddyp[:, :] = el1 * eps_p / a

    # Legendre polynomial table cpol[m, n, h] for hemisphere index h
    cpol = np.zeros((mx, nx, iy))
    for h in range(iy):
        cpol[:, :, h] = _legendre_poly(sia[h], coa[h], mx, nx)

    # masks: the reference restricts m-sums via nsh2 (spe_spectral.f90:99-114):
    # keep (m, n) with l <= ntrun+1 (trapezoidal: one row beyond triangular).
    mask_grid = (ll <= ntrun + 1).astype(np.float64)          # used in gridy
    mask_spec = mask_grid * (n_idx[None, :] <= ntrun)          # specy: n <= ntrun1-1
    parity = (-1.0) ** n_idx                                   # antisymmetric for odd n

    # full-grid inverse operator: fourier[m, j] = sum_n spec[m, n] * leg_inv[m, n, j]
    leg_inv = np.zeros((mx, nx, il))
    # northern rows: j_full = il-1-h  -> +cpol ; southern rows j_full = h -> parity*cpol
    for h in range(iy):
        leg_inv[:, :, il - 1 - h] = cpol[:, :, h] * mask_grid
        leg_inv[:, :, h] = cpol[:, :, h] * mask_grid * parity[None, :]

    # forward operator: spec[m, n] = sum_j fourier[m, j] * leg_fwd[m, n, j]
    leg_fwd = np.zeros((mx, nx, il))
    for h in range(iy):
        w = wt[h]
        leg_fwd[:, :, il - 1 - h] = w * cpol[:, :, h] * mask_spec
        leg_fwd[:, :, h] = w * cpol[:, :, h] * mask_spec * parity[None, :]

    return SpectralTables(
        ntrun=ntrun, ix=ix, il=il, iy=iy, mx=mx, nx=nx,
        sia_half=sia, wt=wt, radang=radang, gsin=gsin, gcos=gcos,
        coriol=coriol, cosgr=cosgr, cosgr2=cosgr2,
        el2=el2, elm2=elm2, el4=el4, trfilt=trfilt,
        gradx=gradx, gradym=gradym, gradyp=gradyp,
        uvdx=uvdx, uvdym=uvdym, uvdyp=uvdyp, vddym=vddym, vddyp=vddyp,
        leg_inv=leg_inv, leg_fwd=leg_fwd,
    )
