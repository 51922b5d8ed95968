"""Surface fluxes of momentum, energy and moisture (PyTorch port of
speedyml/physics/surface.py; reference: src/phy_suflux.f90).

Vectorized over the (il, ix) grid; the land/sea duality becomes a pair of
branches blended by the fractional land mask, exactly as the reference's
(ngp, 3) land/sea/weighted columns.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .constants import PP, DeviceTables
from .humidity import qsat_gkg


class SurfaceFluxes(NamedTuple):
    ustr: torch.Tensor     # weighted u-stress
    vstr: torch.Tensor
    shf: torch.Tensor      # weighted sensible heat flux
    evap: torch.Tensor     # weighted evaporation [g/(m^2 s)]
    slru: torch.Tensor     # weighted upward sfc LW
    ustr_s: torch.Tensor   # sea-only stress (for coupler daily means)
    vstr_s: torch.Tensor
    shf_s: torch.Tensor
    evap_s: torch.Tensor
    evap_l: torch.Tensor
    hfluxn_l: torch.Tensor  # net heat flux into land surface
    hfluxn_s: torch.Tensor  # net heat flux into sea surface
    tsfc: torch.Tensor
    tskin: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor
    t0: torch.Tensor
    q0: torch.Tensor


def sflset(phi0_grid: np.ndarray) -> np.ndarray:
    """Orographic factor for land surface drag (phy_suflux.f90:358-382)."""
    rhdrag = 1.0 / (PP.gg * PP.hdrag)
    return 1.0 + PP.fhdrag * (1.0 - np.exp(-np.maximum(phi0_grid, 0.0) * rhdrag))


def suflux(st: DeviceTables, clat, forog, psa, ua, va, ta, qa, rh, phi, phi0,
           fmask, tland, tsea, swav, ssrd, slrd, alb_l, alb_s, snowc):
    """Compute surface fluxes and skin temperature (phy_suflux.f90:66-356).

    clat: (il,) cos(lat) and forog: (il, ix) orographic drag factor, tensors
    on the fields' device.
    All level arrays (kx, il, ix); phi0 is surface geopotential (il, ix).
    """
    kx = ua.shape[0]
    nl1 = kx - 2
    wvi = st.wvi
    sigl = st.sigl

    esbc = PP.emisfc * PP.sbc
    esbc4 = 4.0 * esbc
    ghum0 = 1.0 - PP.fhum0
    dlambda = PP.clambsn - PP.clambda

    # --- 1. extrapolation to the surface ---
    u0 = PP.fwind0 * ua[kx - 1]
    v0 = PP.fwind0 * va[kx - 1]

    gtemp0 = 1.0 - PP.ftemp0
    rcp = 1.0 / PP.cp
    rdphi0 = -1.0 / (PP.rd * 288.0 * sigl[kx - 1])

    dt1 = wvi[kx - 1][1] * (ta[kx - 1] - ta[nl1])
    t1_land_x = ta[kx - 1] + dt1
    t1_sea_x = t1_land_x + phi0 * dt1 * rdphi0
    t2_sea = ta[kx - 1] + rcp * phi[kx - 1]
    t2_land = t2_sea - rcp * phi0

    unstable = ta[kx - 1] > ta[nl1]
    t1_land = torch.where(unstable,
                          PP.ftemp0 * t1_land_x + gtemp0 * t2_land,
                          ta[kx - 1])
    t1_sea = torch.where(unstable,
                         PP.ftemp0 * t1_sea_x + gtemp0 * t2_sea, ta[kx - 1])
    t0 = t1_sea + fmask * (t1_land - t1_sea)

    # density * wind speed (with gustiness)
    prd = PP.p0 / PP.rd
    vg2 = PP.vgust**2
    denvvs0 = (prd * psa / t0) * torch.sqrt(u0 * u0 + v0 * v0 + vg2)

    # --- 2. land fluxes with prescribed skin temperature ---
    sqclat = torch.sqrt(clat)[:, None]
    tskin = tland + PP.ctday * sqclat * ssrd * (1.0 - alb_l) * psa

    rdth = PP.fstab / PP.dtheta
    astab = 0.5
    dth_l = tskin - t2_land
    dthl = torch.where(dth_l > 0, torch.clamp(dth_l, max=PP.dtheta),
                       torch.clamp(astab * dth_l, min=-PP.dtheta))
    denvvs1 = denvvs0 * (1.0 + dthl * rdth)

    cdldv = PP.cdl * denvvs0 * forog
    ustr_l = -cdldv * ua[kx - 1]
    vstr_l = -cdldv * va[kx - 1]

    chlcp = PP.chl * PP.cp
    shf_l = chlcp * denvvs1 * (tskin - t1_land)

    q1_l = qa[kx - 1]            # fhum0 = 0 path (phy_suflux.f90:195-197)
    qsat_skin = qsat_gkg(tskin, psa)
    evap_l = PP.chl * denvvs1 * torch.clamp(swav * qsat_skin - q1_l, min=0.0)

    # --- 3. land energy balance: adjust skin temperature ---
    tsk3 = tskin**3
    dslr = esbc4 * tsk3
    slru_l = esbc * tsk3 * tskin
    hfluxn_l = (ssrd * (1.0 - alb_l) + slrd
                - (slru_l + shf_l + PP.alhc * evap_l))

    clamb = PP.clambda + snowc * dlambda
    hfluxn_l = hfluxn_l - clamb * (tskin - tland)
    qsat_skin1 = qsat_gkg(tskin + 1.0, psa)
    dqsat = torch.where(evap_l > 0, swav * (qsat_skin1 - qsat_skin),
                        torch.zeros_like(evap_l))

    dhfdt = clamb + dslr + PP.chl * denvvs1 * (PP.cp + PP.alhc * dqsat)
    dtskin = hfluxn_l / dhfdt
    tskin = tskin + dtskin

    shf_l = shf_l + chlcp * denvvs1 * dtskin
    evap_l = evap_l + PP.chl * denvvs1 * dqsat * dtskin
    slru_l = slru_l + dslr * dtskin
    hfluxn_l = clamb * (tskin - tland)

    # --- 4. sea fluxes ---
    dth_s = tsea - t2_sea
    dths = torch.where(dth_s > 0, torch.clamp(dth_s, max=PP.dtheta),
                       torch.clamp(astab * dth_s, min=-PP.dtheta))
    denvvs2 = denvvs0 * (1.0 + dths * rdth)

    q1_s = qa[kx - 1]

    cdsdv = PP.cds * denvvs2
    ustr_s = -cdsdv * ua[kx - 1]
    vstr_s = -cdsdv * va[kx - 1]

    chscp = PP.chs * PP.cp
    shf_s = chscp * denvvs2 * (tsea - t1_sea)
    evap_s = PP.chs * denvvs2 * (qsat_gkg(tsea, psa) - q1_s)

    slru_s = esbc * tsea**4
    hfluxn_s = (ssrd * (1.0 - alb_s) + slrd
                - (slru_s + shf_s + PP.alhc * evap_s))

    # --- 5. land/sea weighting ---
    w = lambda sea, land: sea + fmask * (land - sea)
    ustr = w(ustr_s, ustr_l)
    vstr = w(vstr_s, vstr_l)
    shf = w(shf_s, shf_l)
    evap = w(evap_s, evap_l)
    slru = w(slru_s, slru_l)
    tsfc = w(tsea, tland)
    tskin_w = w(tsea, tskin)
    t0 = w(t1_sea, t1_land)
    q0 = w(q1_s, q1_l)

    return SurfaceFluxes(ustr=ustr, vstr=vstr, shf=shf, evap=evap, slru=slru,
                         ustr_s=ustr_s, vstr_s=vstr_s, shf_s=shf_s,
                         evap_s=evap_s, evap_l=evap_l,
                         hfluxn_l=hfluxn_l, hfluxn_s=hfluxn_s,
                         tsfc=tsfc, tskin=tskin_w, u0=u0, v0=v0, t0=t0, q0=q0)
