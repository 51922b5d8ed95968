"""Shortwave + longwave radiation and cloud diagnostics (PyTorch port of
speedyml/physics/radiation.py).

The reference's phy_radiat.f90 (sol_oz, solar, cloud, radsw, radlw, radset)
over (kx, il, ix) grids. The daily solar fields (`solar`, `diurnal_tisr`,
`sol_oz`) are host-side numpy, float64; the per-step schemes are functions
of tensors, their few-level flux recursions short Python loops.

0-based level conventions: level 0 = top. Cloud-top index icltop is 0-based
with sentinel kx (= "no cloud", reference nlev+1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .constants import PP, DeviceTables


class SolarFields(NamedTuple):
    """Zonally-uniform daily solar forcing (sol_oz, phy_radiat.f90:1-75);
    all (il,) broadcastable over longitude."""

    fsol: np.ndarray | torch.Tensor
    ozupp: np.ndarray | torch.Tensor
    ozone: np.ndarray | torch.Tensor
    zenit: np.ndarray | torch.Tensor
    stratz: np.ndarray | torch.Tensor


def _declination(tyear: float):
    """Solar declination + Sun-Earth distance factor (the Hartmann-1994
    Fourier series used by phy_radiat.f90:86-103). Returns (sdecl, cdecl,
    fdis)."""
    alpha = 2.0 * np.pi * tyear
    ca1, sa1 = np.cos(alpha), np.sin(alpha)
    ca2, sa2 = ca1 * ca1 - sa1 * sa1, 2 * sa1 * ca1
    ca3, sa3 = ca1 * ca2 - sa1 * sa2, sa1 * ca2 + sa2 * ca1

    decl = (0.006918 - 0.399912 * ca1 + 0.070257 * sa1 - 0.006758 * ca2
            + 0.000907 * sa2 - 0.002697 * ca3 + 0.001480 * sa3)
    fdis = (1.000110 + 0.034221 * ca1 + 0.001280 * sa1 + 0.000719 * ca2
            + 0.000077 * sa2)
    return np.sin(decl), np.cos(decl), fdis


def solar(tyear: float, csol: float, slat: np.ndarray, clat: np.ndarray):
    """Daily-average insolation at the atmosphere top (phy_radiat.f90:77-121).
    Pure numpy (host-side daily update)."""
    sdecl, cdecl, fdis = _declination(tyear)
    tdecl = sdecl / cdecl

    csolp = csol / np.pi
    ch0 = np.clip(-tdecl * slat / clat, -1.0, 1.0)
    h0 = np.arccos(ch0)
    sh0 = np.sin(h0)
    return csolp * fdis * (h0 * slat * sdecl + sh0 * clat * cdecl)


def diurnal_tisr(tyear: float, utc_hours: float, slat: np.ndarray,
                 clat: np.ndarray, ix: int) -> np.ndarray:
    """Instantaneous TOA incident solar flux (il, ix) with the diurnal cycle.

    The reference feeds the reservoirs hourly ERA5 TISR at prediction time
    (mpires.f90:1676-1710 get_tisr_by_date); with no data files this
    analytic cycle stands in:  S = 4*solc * fdis * max(0, cos zenith),
    cos(zenith) = slat*sdecl + clat*cdecl*cos(hour angle), hour angle 0 at
    local solar noon.  Its exact daily mean over the hour angle is solar()'s
    fsol, so train-time (daily files or this function) and predict-time TISR
    statistics agree by construction.
    """
    sdecl, cdecl, fdis = _declination(tyear)
    lon = 2.0 * np.pi * np.arange(ix) / ix
    h = (2.0 * np.pi * utc_hours / 24.0 - np.pi) + lon     # hour angle
    cosz = slat[:, None] * sdecl + clat[:, None] * cdecl * np.cos(h)[None, :]
    return 4.0 * PP.solc * fdis * np.maximum(cosz, 0.0)


def sol_oz(tyear: float, slat: np.ndarray, clat: np.ndarray) -> SolarFields:
    """Zonal solar/ozone forcing for the date (phy_radiat.f90:1-75).
    Computed host-side in numpy; uploaded by the caller."""
    alpha = 4.0 * np.arcsin(1.0) * (tyear + 10.0 / 365.0)
    coz1 = max(0.0, np.cos(alpha))
    coz2 = 1.8
    azen, nzen = 1.0, 2
    rzen = -np.cos(alpha) * 23.45 * np.arcsin(1.0) / 90.0
    czen, szen = np.cos(rzen), np.sin(rzen)
    fs0 = 6.0

    topsr = solar(tyear, 4.0 * PP.solc, slat, clat)
    flat2 = 1.5 * slat**2 - 0.5
    fsol = topsr
    ozupp = 0.5 * PP.epssw
    ozone = 0.4 * PP.epssw * (1.0 + coz1 * slat + coz2 * flat2)
    zenit = 1.0 + azen * (1.0 - (clat * czen + slat * szen)) ** nzen
    ozupp = fsol * ozupp * zenit
    ozone = fsol * ozone * zenit
    stratz = np.maximum(fs0 - fsol, 0.0)
    return SolarFields(fsol=fsol, ozupp=ozupp, ozone=ozone, zenit=zenit,
                       stratz=stratz)


def cloud(st: DeviceTables, qa, rh, precnv, precls, iptop, gse, fmask):
    """Cloud cover/top diagnostics (phy_radiat.f90:123-233).

    Returns (icltop [0-based int32, sentinel kx], cloudc, clstr, qcloud).
    """
    kx = qa.shape[0]
    nl1 = kx - 2
    rrcl = 1.0 / (PP.rhcl2 - PP.rhcl1)

    hit0 = rh[nl1] > PP.rhcl1
    cloudc = torch.where(hit0, rh[nl1] - PP.rhcl1, torch.zeros_like(rh[nl1]))
    icltop = torch.where(hit0, nl1, kx).to(torch.int32)

    # 1-based k=3..nlev-2 -> 0-based 2..kx-3 (strictly-improving scan)
    for k in range(2, kx - 2):
        drh = rh[k] - PP.rhcl1
        better = (drh > cloudc) & (qa[k] > PP.qacl)
        cloudc = torch.where(better, drh, cloudc)
        icltop = torch.where(better, k, icltop)

    cl1 = torch.clamp(cloudc * rrcl, max=1.0)
    pr1 = torch.clamp(86.4 * (precnv + precls), max=PP.pmaxcl)
    cloudc = torch.clamp(PP.wpcl * torch.sqrt(pr1) + cl1 * cl1, max=1.0)
    icltop = torch.minimum(iptop, icltop)

    qcloud = qa[nl1]

    # stratiform clouds at the top of the PBL
    clfact = 1.2
    rgse = 1.0 / (PP.gse_s1 - PP.gse_s0)
    fstab = torch.clamp(rgse * (gse - PP.gse_s0), 0.0, 1.0)
    clstr = fstab * torch.clamp(PP.clsmax - clfact * cloudc, min=0.0)
    clstrl = torch.clamp(clstr, min=PP.clsminl) * rh[kx - 1]
    clstr = clstr + fmask * (clstrl - clstr)
    return icltop, cloudc, clstr, qcloud


class RadSWOut(NamedTuple):
    ssrd: torch.Tensor     # downward SW at surface
    ssr: torch.Tensor      # net downward SW at surface
    tsr: torch.Tensor      # net downward SW at top
    dfabs: torch.Tensor    # SW absorbed per layer (kx, il, ix)
    tau2_lw: torch.Tensor  # LW transmissivities (4, kx, il, ix)
    stratc: torch.Tensor   # (2, il, ix) stratospheric LW corrections


def radsw(st: DeviceTables, sol: SolarFields, psa, qa, icltop, cloudc, clstr,
          albsfc) -> RadSWOut:
    """Shortwave absorption + LW transmissivity setup
    (phy_radiat.f90:235-435). `sol`: (il,) tensors on the fields' device."""
    kx = qa.shape[0]
    nl1 = kx - 2
    fband2 = 0.05
    fband1 = 1.0 - fband2

    dsig = st.dsig
    sig = st.sig
    ones = torch.ones_like(psa)
    zero = torch.zeros_like(psa)

    fsol = sol.fsol[:, None] * ones
    ozupp = sol.ozupp[:, None]
    ozone = sol.ozone[:, None]
    zenit = sol.zenit[:, None]
    stratz = sol.stratz[:, None]

    # cloud reflectivity per level (tau2 band 3 in the reference): albcl *
    # cloudc at the cloud top, albcls * clstr added at the lowest level
    refl_top = PP.albcl * cloudc
    refl_pbl = PP.albcls * clstr

    psaz = psa * zenit
    acloud = cloudc * torch.clamp(PP.abscl1 * qa[nl1], max=PP.abscl2)

    # SW band-1 transmissivity per layer
    tau1 = []
    for k in range(kx):
        deltap = psaz * dsig[k]
        if k == 0:
            t = torch.exp(-deltap * PP.absdry)
        else:
            abs1 = PP.absdry + PP.absaer * sig[k] ** 2
            if k == kx - 1:
                t = torch.exp(-deltap * (abs1 + PP.abswv1 * qa[k]))
            else:
                extra = torch.where(icltop <= k, acloud, zero)
                t = torch.exp(-deltap * (abs1 + PP.abswv1 * qa[k] + extra))
        tau1.append(t)

    # SW band-2 transmissivity (levels 1..kx-1)
    tau2b = [ones]
    for k in range(1, kx):
        tau2b.append(torch.exp(-psaz * dsig[k] * PP.abswv2 * qa[k]))

    # --- downward flux ---
    dfabs = [zero for _ in range(kx)]
    ftop = fsol
    flux1 = fsol * fband1
    flux2 = fsol * fband2

    # ozone and dry-air absorption in the stratosphere (levels 0, 1)
    for k, oz in ((0, ozupp), (1, ozone)):
        dfabs[k] = flux1
        flux1 = tau1[k] * (flux1 - oz * psa)
        dfabs[k] = dfabs[k] - flux1

    # troposphere: cloud reflection + band-1 absorption (levels 2..kx-1)
    refl_map = {}
    for k in range(2, kx):
        refl_k = torch.where(icltop == k, refl_top, zero)
        if k == kx - 1:
            refl_k = refl_k + refl_pbl
        r = flux1 * refl_k
        refl_map[k] = r
        flux1 = flux1 - r
        dfabs[k] = dfabs[k] + flux1
        flux1 = tau1[k] * flux1
        dfabs[k] = dfabs[k] - flux1

    # band 2 absorption (levels 1..kx-1)
    for k in range(1, kx):
        dfabs[k] = dfabs[k] + flux2
        flux2 = tau2b[k] * flux2
        dfabs[k] = dfabs[k] - flux2

    # --- surface and upward flux ---
    fsfcd = flux1 + flux2
    flux1 = flux1 * albsfc
    fsfc = fsfcd - flux1

    for k in range(kx - 1, -1, -1):
        dfabs[k] = dfabs[k] + flux1
        flux1 = tau1[k] * flux1
        dfabs[k] = dfabs[k] - flux1
        if k in refl_map:
            flux1 = flux1 + refl_map[k]

    ftop = ftop - flux1

    # --- LW transmissivity setup (phy_radiat.f90:387-434) ---
    tau_lw = [[None] * kx for _ in range(4)]
    for k in (0,):
        deltap = psa * dsig[k]
        tau_lw[0][k] = torch.exp(-deltap * PP.ablwin)
        tau_lw[1][k] = torch.exp(-deltap * PP.ablco2)
        tau_lw[2][k] = ones
        tau_lw[3][k] = ones
    for k in (1, kx - 1):
        deltap = psa * dsig[k]
        tau_lw[0][k] = torch.exp(-deltap * PP.ablwin)
        tau_lw[1][k] = torch.exp(-deltap * PP.ablco2)
        tau_lw[2][k] = torch.exp(-deltap * PP.ablwv1 * qa[k])
        tau_lw[3][k] = torch.exp(-deltap * PP.ablwv2 * qa[k])
    acloud_lw = cloudc * PP.ablcl2
    for k in range(2, kx - 1):
        deltap = psa * dsig[k]
        acloud1 = torch.where(icltop > k, acloud_lw, PP.ablcl1 * cloudc)
        tau_lw[0][k] = torch.exp(-deltap * (PP.ablwin + acloud1))
        tau_lw[1][k] = torch.exp(-deltap * PP.ablco2)
        tau_lw[2][k] = torch.exp(-deltap * torch.maximum(PP.ablwv1 * qa[k],
                                                         acloud_lw))
        tau_lw[3][k] = torch.exp(-deltap * torch.maximum(PP.ablwv2 * qa[k],
                                                         acloud_lw))

    tau2_lw = torch.stack([torch.stack(b, dim=0) for b in tau_lw], dim=0)

    eps1 = PP.epslw / (dsig[0] + dsig[1])
    stratc = torch.stack([stratz * psa * ones, eps1 * psa], dim=0)

    return RadSWOut(ssrd=fsfcd, ssr=fsfc, tsr=ftop,
                    dfabs=torch.stack(dfabs, dim=0),
                    tau2_lw=tau2_lw, stratc=stratc)


def _fband_lookup(st: DeviceTables, t):
    """fband(nint(T), band) -> (4, ...) (radset table). nint rounds half to
    even here and in the JAX package."""
    idx = torch.clamp(torch.round(t).to(torch.int64), 100, 400) - 100
    return torch.movedim(st.fband[idx], -1, 0)


def radlw_down(st: DeviceTables, tau2_lw, ta):
    """Downward LW (radlw imode=-1; phy_radiat.f90:484-584).

    Returns (fsfcd=slrd, dfabs, flux_bands (4,...), st4a1, st4a2).
    """
    kx = ta.shape[0]
    wvi = st.wvi

    # temperature at layer boundaries
    half = [ta[k] + wvi[k][1] * (ta[k + 1] - ta[k]) for k in range(kx - 1)]

    st4a2 = [None] * kx
    st4a1 = [None] * kx
    # stratospheric mean temps
    strat_mean0 = 0.75 * ta[0] + 0.25 * half[0]
    strat_mean1 = 0.50 * ta[1] + 0.25 * (half[0] + half[1])
    # tropospheric temperature gradients
    anish = 0.5
    for k in range(2, kx - 1):
        st4a2[k] = anish * torch.clamp(half[k] - half[k - 1], min=0.0)
    st4a2[kx - 1] = torch.clamp(ta[kx - 1] - half[kx - 2], min=0.0)

    # blackbody emission
    sbc = PP.sbc
    st4a1[0] = sbc * strat_mean0**4
    st4a1[1] = sbc * strat_mean1**4
    st4a2[0] = torch.zeros_like(ta[0])
    st4a2[1] = torch.zeros_like(ta[0])
    for k in range(2, kx):
        st3a = sbc * ta[k] ** 3
        st4a1[k] = st3a * ta[k]
        st4a2[k] = 4.0 * st3a * st4a2[k]

    fb = _fband_lookup(st, ta)             # (4, kx, il, ix): [band, level]

    dfabs = [torch.zeros_like(ta[0]) for _ in range(kx)]
    flux = [torch.zeros_like(ta[0]) for _ in range(4)]

    # stratosphere, bands 0-1, level 0
    for jb in range(2):
        emis = 1.0 - tau2_lw[jb, 0]
        brad = fb[jb, 0] * (st4a1[0] + emis * st4a2[0])
        flux[jb] = emis * brad
        dfabs[0] = dfabs[0] - flux[jb]

    # troposphere, all bands, levels 1..kx-1
    for jb in range(4):
        for k in range(1, kx):
            emis = 1.0 - tau2_lw[jb, k]
            brad = fb[jb, k] * (st4a1[k] + emis * st4a2[k])
            dfabs[k] = dfabs[k] + flux[jb]
            flux[jb] = tau2_lw[jb, k] * flux[jb] + emis * brad
            dfabs[k] = dfabs[k] - flux[jb]

    fsfcd = PP.emisfc * (flux[0] + flux[1] + flux[2] + flux[3])
    corlw = PP.epslw * PP.emisfc * st4a1[kx - 1]
    dfabs[kx - 1] = dfabs[kx - 1] - corlw
    fsfcd = fsfcd + corlw

    return (fsfcd, torch.stack(dfabs, dim=0), torch.stack(flux, dim=0),
            torch.stack(st4a1, dim=0), torch.stack(st4a2, dim=0))


def radlw_up(st: DeviceTables, tau2_lw, stratc, ta, ts, fsfcd, fsfcu,
             flux_bands, dfabs, st4a1, st4a2):
    """Upward LW (radlw imode=1; phy_radiat.f90:600-656).

    fsfcu: surface blackbody emission = emisfc*sbc*ts^4 (computed by caller
    alongside suflux's slru). Returns (slr=fsfc, olr=ftop, dfabs).
    """
    kx = ta.shape[0]
    dsig = st.dsig
    refsfc = 1.0 - PP.emisfc

    fsfc = fsfcu - fsfcd
    fb_ts = _fband_lookup(st, ts)
    flux = [fb_ts[jb] * fsfcu + refsfc * flux_bands[jb] for jb in range(4)]

    dfabs = [dfabs[k] for k in range(kx)]
    dfabs[kx - 1] = dfabs[kx - 1] + PP.epslw * fsfcu

    fb = _fband_lookup(st, ta)
    for jb in range(4):
        for k in range(kx - 1, 0, -1):
            emis = 1.0 - tau2_lw[jb, k]
            brad = fb[jb, k] * (st4a1[k] - emis * st4a2[k])
            dfabs[k] = dfabs[k] + flux[jb]
            flux[jb] = tau2_lw[jb, k] * flux[jb] + emis * brad
            dfabs[k] = dfabs[k] - flux[jb]

    for jb in range(2):
        emis = 1.0 - tau2_lw[jb, 0]
        brad = fb[jb, 0] * (st4a1[0] - emis * st4a2[0])
        dfabs[0] = dfabs[0] + flux[jb]
        flux[jb] = tau2_lw[jb, 0] * flux[jb] + emis * brad
        dfabs[0] = dfabs[0] - flux[jb]

    corlw1 = dsig[0] * stratc[1] * st4a1[0] + stratc[0]
    corlw2 = dsig[1] * stratc[1] * st4a1[1]
    dfabs[0] = dfabs[0] - corlw1
    dfabs[1] = dfabs[1] - corlw2
    ftop = corlw1 + corlw2 + flux[0] + flux[1] + flux[2] + flux[3]

    return fsfc, ftop, torch.stack(dfabs, dim=0)
