"""Daily coupler: climatology interpolation, slab land/sea/ice models, and
date-dependent forcing (fordate). The port's own copy of
speedyml/coupler/daily.py: host-side numpy, float64.

Re-design of the reference's cpl_land.f90 / cpl_sea.f90 / cpl_sea_model.f90 /
mod_cpl_land_model.f90 / ini_fordate.f90 as host-side numpy at the daily
cadence (tiny fields; the per-step physics consumes the results as tensors).

Coupling flags fixed to the reference defaults (mod_cpl_flags.f90): land
model on (icland=1), climatological SST (icsea=0), thermodynamic ice model on
(icice=1), no observed anomalies (isstan=0).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.calendar import ModelDate
from ..core.constants import PHYS, DYN
from ..physics.constants import PP
from .climatology import Climatology

SSTFR = 273.2 - 1.8    # freezing-point SST


def forint(imon: int, fmon: float, for12: np.ndarray) -> np.ndarray:
    """Linear interpolation of monthly means (cpl_bcinterp.f90:1-23).
    imon 1-based; for12 (12, il, ix)."""
    if fmon <= 0.5:
        imon2 = 12 if imon == 1 else imon - 1
        wmon = 0.5 - fmon
    else:
        imon2 = 1 if imon == 12 else imon + 1
        wmon = fmon - 0.5
    a = for12[imon - 1]
    return a + wmon * (for12[imon2 - 1] - a)


def forin5(imon: int, fmon: float, for12: np.ndarray) -> np.ndarray:
    """Mean-conserving interpolation (cpl_bcinterp.f90:25-63). imon 1-based."""
    im2 = (imon - 3) % 12
    im1 = (imon - 2) % 12
    im0 = imon - 1
    ip1 = imon % 12
    ip2 = (imon + 1) % 12

    c0 = 1.0 / 12.0
    t0 = c0 * fmon
    t1 = c0 * (1.0 - fmon)
    t2 = 0.25 * fmon * (1.0 - fmon)
    wm2 = -t1 + t2
    wm1 = -c0 + 8 * t1 - 6 * t2
    w0 = 7 * c0 + 10 * t2
    wp1 = -c0 + 8 * t0 - 6 * t2
    wp2 = -t0 + t2
    return (wm2 * for12[im2] + wm1 * for12[im1] + w0 * for12[im0]
            + wp1 * for12[ip1] + wp2 * for12[ip2])


@dataclasses.dataclass
class CouplerState:
    """Prognostic + diagnostic surface state (numpy, (il, ix))."""

    # land
    stl_lm: np.ndarray
    stl_am: np.ndarray
    snowd_am: np.ndarray
    soilw_am: np.ndarray
    # sea / ice
    sst_om: np.ndarray
    tice_om: np.ndarray
    sice_om: np.ndarray
    sst_am: np.ndarray
    sice_am: np.ndarray
    tice_am: np.ndarray
    # climatologies at current date (needed as model inputs next day)
    stlcl_ob: np.ndarray
    sstcl_ob: np.ndarray
    sicecl_ob: np.ndarray
    ticecl_ob: np.ndarray


def interp_land(clim: Climatology, imon: int, fmon: float):
    stlcl = forin5(imon, fmon, clim.stl12)
    snowdcl = forint(imon, fmon, clim.snowd12)
    soilwcl = forint(imon, fmon, clim.soilw12)
    return stlcl, snowdcl, soilwcl


def interp_sea(clim: Climatology, imon: int, fmon: float):
    """SST/ice interpolation + ice adjustment (cpl_sea.f90:73-116)."""
    sstcl = forin5(imon, fmon, clim.sst12)
    sicecl = forint(imon, fmon, clim.sice12)

    warm = sstcl > SSTFR
    sicecl_w = np.minimum(0.5, sicecl)
    ticecl_w = np.full_like(sstcl, SSTFR)
    sstcl_w = np.where(sicecl_w > 0.0,
                       SSTFR + (sstcl - SSTFR) / (1.0 - sicecl_w), sstcl)

    sicecl_c = np.maximum(0.5, sicecl)
    ticecl_c = SSTFR + (sstcl - SSTFR) / sicecl_c
    sstcl_c = np.full_like(sstcl, SSTFR)

    sstcl_n = np.where(warm, sstcl_w, sstcl_c)
    sicecl_n = np.where(warm, sicecl_w, sicecl_c)
    ticecl_n = np.where(warm, ticecl_w, ticecl_c)
    return sstcl_n, sicecl_n, ticecl_n


def ice_blend(sst, sice, tice):
    """The SST the atmosphere sees over a sea-ice fraction `sice` of
    temperature `tice` (cpl_sea.f90:44, :198)."""
    return sst + sice * (tice - sst)


def clim_sst_am(clim: Climatology, date: ModelDate) -> np.ndarray:
    """The climatological SST the atmosphere sees at `date`:
    init_coupler_state(clim, date).sst_am, without the land fields."""
    return ice_blend(*interp_sea(clim, date.imonth, date.tmonth))


def init_coupler_state(clim: Climatology, date: ModelDate,
                       sst_hybrid: np.ndarray | None = None,
                       sst_bias: float = 0.0) -> CouplerState:
    """ini_land + ini_sea (cpl_land.f90:1-24, cpl_sea.f90:1-48).

    sst_hybrid: when given, overwrite sst_am ML-style (the hybrid hook,
    cpl_sea.f90:38-47).
    """
    stlcl, snowdcl, soilwcl = interp_land(clim, date.imonth, date.tmonth)
    sstcl, sicecl, ticecl = interp_sea(clim, date.imonth, date.tmonth)

    stl_lm = stlcl.copy()
    stl_am = stl_lm.copy()

    sst_om = np.zeros_like(sstcl)     # icsea = 0
    tice_om = ticecl.copy()
    sice_om = sicecl.copy()

    sst_am = sstcl.copy()
    sice_am = sice_om.copy()
    tice_am = tice_om.copy()

    if sst_hybrid is not None:
        diff = sst_am - sst_hybrid
        sst_am = np.where(diff < 6.0, sst_hybrid, sst_am) + sst_bias

    sst_am = ice_blend(sst_am, sice_am, tice_am)

    return CouplerState(
        stl_lm=stl_lm, stl_am=stl_am, snowd_am=snowdcl, soilw_am=soilwcl,
        sst_om=sst_om, tice_om=tice_om, sice_om=sice_om, sst_am=sst_am,
        sice_am=sice_am, tice_am=tice_am, stlcl_ob=stlcl, sstcl_ob=sstcl,
        sicecl_ob=sicecl, ticecl_ob=ticecl)


def daily_coupler_update(clim: Climatology, cs: CouplerState,
                         date: ModelDate, hflux_l: np.ndarray,
                         hflux_s: np.ndarray, hflux_i: np.ndarray) -> None:
    """End-of-day exchange: agcm_to_coupler + coupler_to_agcm
    (at_gcm.f90:42-44) with the slab models integrated one day.
    Mutates cs in place. date must already be advanced to the new day."""
    # --- land (cpl_land.f90 + mod_cpl_land_model.f90:land_model) ---
    stlcl, snowdcl, soilwcl = interp_land(clim, date.imonth, date.tmonth)
    tanom = cs.stl_lm - stlcl
    tanom = clim.cdland * (tanom + clim.rhcapl * hflux_l)
    cs.stl_lm = tanom + stlcl
    cs.stl_am = cs.stl_lm
    cs.snowd_am = snowdcl
    cs.soilw_am = soilwcl
    cs.stlcl_ob = stlcl

    # --- sea / ice (cpl_sea.f90 + cpl_sea_model.f90:sea_model) ---
    sstcl, sicecl, ticecl = interp_sea(clim, date.imonth, date.tmonth)

    # ocean mixed layer (output unused for sst_am when icsea=0, but kept)
    hflux = hflux_s - clim.hfseacl - cs.sice_om * (
        hflux_i + clim.beta * (SSTFR - cs.tice_om))
    tanom = cs.sst_om - sstcl
    tanom = clim.cdsea * (tanom + clim.rhcaps * hflux)
    sst1 = tanom + sstcl

    # sea-ice slab
    hflux_ice = hflux_i + clim.beta * (SSTFR - cs.tice_om)
    tanom = cs.tice_om - ticecl
    anom0 = 20.0
    cdis = clim.cdice * (anom0 / (anom0 + np.abs(tanom)))
    tanom = cdis * (tanom + clim.rhcapi * hflux_ice)
    tice1 = tanom + ticecl

    cs.sst_om = sst1
    cs.tice_om = tice1
    # sea-ice fraction persists (cpl_sea_model.f90:200-201)

    # sea2atm with icsea=0, icice=1 (cpl_sea.f90:155-200)
    cs.sice_am = cs.sice_om
    cs.tice_am = cs.tice_om
    cs.sst_am = ice_blend(sstcl, cs.sice_am, cs.tice_am)
    cs.sstcl_ob = sstcl
    cs.sicecl_ob = sicecl
    cs.ticecl_ob = ticecl


def _qsat_np(ta, pres_norm):
    e0, c1, c2 = 6.108e-3, 17.269, 21.875
    t0, t1, t2 = 273.16, 35.86, 7.66
    es = np.where(ta >= t0,
                  e0 * np.exp(c1 * (ta - t0) / (ta - t1)),
                  e0 * np.exp(c2 * (ta - t0) / (ta - t2)))
    return 622.0 * es / (pres_norm - 0.378 * es)


def fordate(dy, clim: Climatology, cs: CouplerState, date: ModelDate):
    """Date-dependent forcing (ini_fordate.f90:fordate, imode=1).

    Returns (surface radiative fields dict, tcorh, qcorh): the spectral
    diffusion corrections as float64 numpy arrays in the real-pair layout
    (mx, 2, nx) of `dynamics.core.Forcing` (host transform).
    """
    from ..physics.radiation import sol_oz

    tyear = date.tyear
    slat = dy.tables.gsin
    clat = dy.tables.gcos

    sol = sol_oz(tyear, slat, clat)

    snowc = np.minimum(1.0, cs.snowd_am / PP.sd2sc)
    alb_l = clim.alb0 + snowc * (PP.albsn - clim.alb0)
    alb_s = PP.albsea + cs.sice_am * (PP.albice - PP.albsea)
    albsfc = alb_s + clim.fmask_l * (alb_l - alb_s)

    # temperature correction for horizontal diffusion
    gamlat = DYN.gamma / (1000.0 * PHYS.grav)
    phis0 = np.asarray(dy.phis0_grid, np.float64)
    corh_t = gamlat * phis0
    tcorh = dy.T.host_grid_to_spec(corh_t)

    # humidity correction
    pexp = 1.0 / (PP.rd * gamlat)
    tsfc = clim.fmask_l * cs.stl_am + clim.fmask_s * cs.sst_am
    tref = tsfc + corh_t
    psfc = (tsfc / tref) ** pexp
    qref = _qsat_np(tref, 1.0)
    qsfc = _qsat_np(tsfc, psfc)
    corh_q = DYN.refrh1 * (qref - qsfc)
    qcorh = dy.T.host_grid_to_spec(corh_q)

    rad_fields = dict(snowc=snowc, alb_l=alb_l, alb_s=alb_s, albsfc=albsfc,
                      fsol=sol.fsol, ozupp=sol.ozupp, ozone=sol.ozone,
                      zenit=sol.zenit, stratz=sol.stratz)
    return rad_fields, tcorh, qcorh
