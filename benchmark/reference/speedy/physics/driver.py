"""The physics parametrizations called in their order (PyTorch port of
speedyml/physics/driver.py; reference: src/phy_phypar.f90).

`step_physics` is the grid-space physics increment used by the dynamical
core's grtend hook: it consumes the j1-time-level prognostic fields, the
daily surface/solar state and the persistent radiation carry, and returns
tendency increments plus the updated carry and the fluxes the coupler needs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..dynamics.implicit import geopotential
from .condensation import lscond
from .constants import PP, DeviceTables, SigmaTables
from .convection import convmf
from .humidity import rel_hum
from .radiation import SolarFields, cloud, radlw_down, radlw_up, radsw
from .surface import suflux
from .vdiff import vdifsc


class SurfaceDailyState(NamedTuple):
    """Daily-updated surface fields (coupler + fordate outputs), all (il, ix)
    except the zonal solar fields (il,)."""

    stl_am: torch.Tensor     # land surface temperature
    snowd_am: torch.Tensor   # snow depth
    soilw_am: torch.Tensor   # soil water availability
    sst_am: torch.Tensor     # SST (incl. ice blending)
    sice_am: torch.Tensor    # sea-ice fraction
    tice_am: torch.Tensor    # sea-ice temperature
    alb_l: torch.Tensor
    alb_s: torch.Tensor
    albsfc: torch.Tensor
    snowc: torch.Tensor
    fsol: torch.Tensor       # (il,)
    ozupp: torch.Tensor
    ozone: torch.Tensor
    zenit: torch.Tensor
    stratz: torch.Tensor


class RadCarry(NamedTuple):
    """State persisting between shortwave steps (nstrad cadence)."""

    tau2_lw: torch.Tensor   # (4, kx, il, ix)
    stratc: torch.Tensor    # (2, il, ix)
    tt_rsw: torch.Tensor    # (kx, il, ix) SW heating [K/s]
    ssrd: torch.Tensor      # (il, ix)
    ssr: torch.Tensor
    tsr: torch.Tensor


class StepFluxes(NamedTuple):
    """Per-step fluxes needed by the coupler daily means and output."""

    precnv: torch.Tensor
    precls: torch.Tensor
    evap: torch.Tensor       # land/sea-weighted evaporation [g/(m^2 s)]
    evap_l: torch.Tensor
    evap_s: torch.Tensor
    hfluxn_l: torch.Tensor
    hfluxn_s: torch.Tensor
    shf_s: torch.Tensor
    ssrd: torch.Tensor
    ustr_s: torch.Tensor
    vstr_s: torch.Tensor
    ssr: torch.Tensor
    slr_s: torch.Tensor
    olr: torch.Tensor
    tsr: torch.Tensor


def init_rad_carry(kx: int, il: int, ix: int, dtype,
                   device: torch.device | str | None = None) -> RadCarry:
    device = resolve_device(device)

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    return RadCarry(tau2_lw=torch.ones((4, kx, il, ix), dtype=dtype,
                                       device=device),
                    stratc=z(2, il, ix), tt_rsw=z(kx, il, ix),
                    ssrd=z(il, ix), ssr=z(il, ix), tsr=z(il, ix))


def phys_hook(phys, surf: SurfaceDailyState, rad: RadCarry, lradsw: bool):
    """The physics hook of one dycore step (Dycore.step's phys_fn):
    phys.step_physics under surf and rad; the hook's carry is (RadCarry,
    StepFluxes)."""
    def fn(dy, fphy):
        tends, rad_new, fluxes = phys.step_physics(dy, fphy, surf, rad,
                                                   lradsw)
        return tends, (rad_new, fluxes)
    return fn


class Physics:
    """Holds the static physics tables on `device` (the card unless the
    caller names another) in `dtype`; exposes the per-step function."""

    def __init__(self, st: SigmaTables, clat, forog, fmask1, phis0_grid,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.dtype = dtype
        # the sigma tables once, as Python floats and device tensors: a
        # numpy scalar times a tensor would go through numpy's operator
        self.st = DeviceTables(st, dtype, self.device)

        def up(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=self.device)

        self.clat = up(clat)          # (il,)
        self.forog = up(forog)        # (il, ix)
        self.fmask1 = up(fmask1)      # (il, ix) model land fraction
        self.phis0 = up(phis0_grid)   # (il, ix) surface geopotential

    def step_physics(self, dy, f, surf: SurfaceDailyState, rad: RadCarry,
                     lradsw: bool):
        """Returns ((du, dv, dtt, dqt) grid increments, new RadCarry,
        StepFluxes). lradsw is a Python bool: on a shortwave step the cloud
        and shortwave schemes run and the carry is replaced, otherwise the
        carry passes through untouched (it is never written in place)."""
        st = self.st
        T = dy.T
        kx = dy.config.kx
        nl1 = kx - 2

        # --- 1. grid-point fields at the physics time level (one batched
        # transform per cos-scaling group) ---
        ucosm, vcosm = T.uvspec(f.vor, f.div)
        g2 = T.spec_to_grid(torch.cat([ucosm, vcosm]), kcos=2)
        ug, vg = g2[:kx], g2[kx:]
        phi = geopotential(f.t, dy.phis, dy.vg_np, dy.geop_corrections)
        g1 = T.spec_to_grid(torch.cat([f.t, f.tr[0], phi, f.ps[None]]))
        tg = g1[:kx]
        qg = torch.clamp(g1[kx:2 * kx], min=0.0)
        phig = g1[2 * kx:3 * kx]
        pslg = g1[3 * kx]

        psg = torch.exp(pslg)
        rps = 1.0 / psg

        se = PP.cp * tg + phig
        rh, qsat = rel_hum(qg, tg, st.sig_col * psg[None])

        grdsig = st.grdsig_col
        grdscp = st.grdscp_col

        # --- 2. precipitation ---
        itop, cbmf, precnv, dfse, dfqa = convmf(st, psg, se, qg, qsat)
        tt_cnv = dfse * rps[None] * grdscp
        qt_cnv = dfqa * rps[None] * grdsig
        icnv = (kx - 1) - itop

        itop, precls, tt_lsc, qt_lsc = lscond(st, psg, qg, qsat, itop)

        ttend = tt_cnv + tt_lsc
        qtend = qt_cnv + qt_lsc

        # --- 3. radiation ---
        if lradsw:
            sol = SolarFields(fsol=surf.fsol, ozupp=surf.ozupp,
                              ozone=surf.ozone, zenit=surf.zenit,
                              stratz=surf.stratz)
            gse = (se[nl1] - se[kx - 1]) / (phig[nl1] - phig[kx - 1])
            icltop, cloudc, clstr, _ = cloud(st, qg, rh, precnv, precls,
                                             itop, gse, self.fmask1)
            out = radsw(st, sol, psg, qg, icltop, cloudc, clstr, surf.albsfc)
            rad = RadCarry(tau2_lw=out.tau2_lw, stratc=out.stratc,
                           tt_rsw=out.dfabs * rps[None] * grdscp,
                           ssrd=out.ssrd, ssr=out.ssr, tsr=out.tsr)

        slrd, dfabs_lw, flux_bands, st4a1, st4a2 = radlw_down(
            st, rad.tau2_lw, tg)

        # --- surface fluxes ---
        fx = suflux(st, self.clat, self.forog, psg, ug, vg, tg, qg, rh, phig,
                    self.phis0, self.fmask1, surf.stl_am, surf.sst_am,
                    surf.soilw_am, rad.ssrd, slrd, surf.alb_l, surf.alb_s,
                    surf.snowc)

        slr, olr, dfabs_lw = radlw_up(st, rad.tau2_lw, rad.stratc, tg,
                                      fx.tsfc, slrd, fx.slru, flux_bands,
                                      dfabs_lw, st4a1, st4a2)
        tt_rlw = dfabs_lw * rps[None] * grdscp
        ttend = ttend + rad.tt_rsw + tt_rlw

        # --- 4. PBL: vertical diffusion + surface flux tendencies (added to
        # the lowest level of vdifsc's own fresh tensors) ---
        ut_pbl, vt_pbl, tt_pbl, qt_pbl = vdifsc(st, ug, vg, se, rh, qg, qsat,
                                                phig, icnv)
        g_last = grdsig[kx - 1]
        gc_last = grdscp[kx - 1]
        ut_pbl[kx - 1] += fx.ustr * rps * g_last
        vt_pbl[kx - 1] += fx.vstr * rps * g_last
        tt_pbl[kx - 1] += fx.shf * rps * gc_last
        qt_pbl[kx - 1] += fx.evap * rps * g_last

        utend = ut_pbl
        vtend = vt_pbl
        ttend = ttend + tt_pbl
        qtend = qtend + qt_pbl

        fluxes = StepFluxes(precnv=precnv, precls=precls,
                            evap=fx.evap, evap_l=fx.evap_l, evap_s=fx.evap_s,
                            hfluxn_l=fx.hfluxn_l, hfluxn_s=fx.hfluxn_s,
                            shf_s=fx.shf_s, ssrd=rad.ssrd,
                            ustr_s=fx.ustr_s, vstr_s=fx.vstr_s,
                            ssr=rad.ssr, slr_s=slr, olr=olr, tsr=rad.tsr)
        return (utend, vtend, ttend, qtend[None]), rad, fluxes
