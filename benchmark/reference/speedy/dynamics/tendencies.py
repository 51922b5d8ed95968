"""Grid-space nonlinear tendencies and spectral linear tendencies (PyTorch
port of speedyml/dynamics/tendencies.py).

`grtend` (src/dyn_grtend.f90) and `sptend` (src/dyn_sptend.f90) as batched
functions: per-level loops become a leading kx axis, vertical loops become
cumulative sums and stacked slices. With `Dycore.grid_dtype` set (bfloat16,
`ModelConfig.grid_compute`) grtend's grid-space work runs in that dtype, as
the JAX package's does; the spectral state and the transforms stay in the
model dtype.

Grid arrays are (kx, il, ix); spectral arrays (kx, mx, 2, nx).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .implicit import ImplicitCoefs, geopotential
from .state import PrognosticFields, Tendencies


def grtend(dy, fdyn: PrognosticFields, fphy: PrognosticFields,
           phys_fn: Optional[Callable] = None):
    """Nonlinear grid-space tendencies -> spectral (dyn_grtend.f90:1-279).

    fdyn: fields at the dynamics time level (j2); fphy: at the physics time
    level (j1). phys_fn(dy, fphy) must return ((utend, vtend, ttend, trtend),
    extras): grid-space tendency increments added before the spectral
    conversion (phy_phypar.f90 contract) plus whatever the caller threads
    through (radiation carry, fluxes).

    Returns (Tendencies, extras); extras is None without phys_fn.
    """
    T = dy.T
    vg = dy.vgt
    dhs, dhsr, fsgr = vg["dhs"], vg["dhsr"], vg["fsgr"]
    tref = dy.imp_main.tref          # (kx,) reference temperature (impint)
    tref3 = dy.imp_main.tref3
    akap = dy.akap
    rgas = dy.rgas
    coriol = T.coriol

    # opt-in reduced-precision grid compute (speedyml/dynamics/
    # tendencies.py:70-107): the grid fields and the vertical constants are
    # cast after the inverse transforms; what goes back to spectral space
    # is cast to the model dtype first (JAX promotes it in the einsum)
    gd = dy.grid_dtype
    tref_full = tref
    if gd is not None:
        dhs, dhsr, fsgr, tref3, coriol = (
            x.to(gd) for x in (dhs, dhsr, fsgr, tref3, coriol))

    def to_spec_dtype(x):
        return x.to(T.dtype)

    # grid converts: one batched transform per cos-scaling group
    kx = fdyn.vor.shape[0]
    ntr = fdyn.tr.shape[0]
    trf = fdyn.tr.reshape(ntr * kx, *fdyn.tr.shape[2:])
    g1 = T.spec_to_grid(torch.cat([fdyn.vor, fdyn.div, fdyn.t, trf]))
    tg_full = g1[2 * kx:3 * kx]
    if gd is not None:
        g1 = g1.to(gd)
    vorg, divg, tg = g1[:kx], g1[kx:2 * kx], g1[2 * kx:3 * kx]
    trg = g1[3 * kx:].reshape(ntr, kx, *g1.shape[1:])

    ucosm, vcosm = T.uvspec(fdyn.vor, fdyn.div)
    pdx_s, pdy_s = T.grad(fdyn.ps)
    g2 = T.spec_to_grid(torch.cat(
        [ucosm, vcosm, pdx_s[None], pdy_s[None]]), kcos=2)
    if gd is not None:
        g2 = g2.to(gd)
    ug, vg_, px, py = g2[:kx], g2[kx:2 * kx], g2[2 * kx], g2[2 * kx + 1]

    vorg_abs = vorg + coriol[:, None]                  # planetary vorticity

    w = dhs[:, None, None]
    umean = torch.sum(ug * w, dim=0)                   # (il, ix)
    vmean = torch.sum(vg_ * w, dim=0)
    dmean = torch.sum(divg * w, dim=0)

    # log-ps tendency (dyn_grtend.f90:94-103)
    psdt = T.grid_to_spec(to_spec_dtype(-umean * px - vmean * py))
    psdt[0, :, 0] = 0.0

    # vertical sigma velocity (dyn_grtend.f90:105-123), interfaces
    # (kx+1, il, ix) with index 0 at the top
    puv = (ug - umean[None]) * px[None] + (vg_ - vmean[None]) * py[None]
    zero_iface = torch.zeros_like(umean)[None]
    sigdt = torch.cat(
        [zero_iface, -torch.cumsum(w * (puv + divg - dmean[None]), dim=0)])
    sigm = torch.cat([zero_iface, -torch.cumsum(w * puv, dim=0)])

    # temperature anomaly, taken before any downcast: T and tref are
    # ~270 K, so rounding first would wipe out the anomaly's low bits
    tgg = tg_full - tref_full[:, None, None]
    if gd is not None:
        tgg = tgg.to(gd)
    rpx = rgas * px
    rpy = rgas * py

    def vadv(field):
        """Interface vertical advection -> per-level contribution
        (temp(k)+temp(k+1))*dhsr(k), temp(iface) = sigdt*(df across iface)."""
        df = field[1:] - field[:-1]                            # (kx-1, il, ix)
        iface = sigdt[1:-1] * df                               # interior
        iface_full = torch.cat([zero_iface, iface, zero_iface])
        return (iface_full[1:] + iface_full[:-1]) * dhsr[:, None, None]

    # wind tendencies (dyn_grtend.f90:140-162)
    utend = vg_ * vorg_abs - tgg * rpx - vadv(ug)
    vtend = -ug * vorg_abs - tgg * rpy - vadv(vg_)

    # temperature tendency (dyn_grtend.f90:165-182)
    dtgg = tgg[1:] - tgg[:-1]
    dtref = tref_full[1:] - tref_full[:-1]
    if gd is not None:
        dtref = dtref.to(gd)
    iface_t = sigdt[1:-1] * dtgg + sigm[1:-1] * dtref[:, None, None]
    iface_t = torch.cat([zero_iface, iface_t, zero_iface])
    ttend = (tgg * divg
             - (iface_t[1:] + iface_t[:-1]) * dhsr[:, None, None]
             + fsgr[:, None, None] * tgg * (sigdt[1:] + sigdt[:-1])
             + tref3[:, None, None] * (sigm[1:] + sigm[:-1])
             + akap * (tg * puv - tgg * dmean[None]))

    # tracer tendencies (dyn_grtend.f90:187-217)
    dtr = trg[:, 1:] - trg[:, :-1]                     # (ntr, kx-1, il, ix)
    iface_tr = sigdt[None, 1:-1] * dtr
    # no vertical advection between the top three layers (moisture; the
    # reference zeroes interfaces k=2,3, i.e. interior ifaces 0,1 here)
    iface_tr[:, 0:2] = 0.0
    zi = torch.zeros_like(iface_tr[:, :1])
    iface_tr = torch.cat([zi, iface_tr, zi], dim=1)
    trtend = (trg * divg[None]
              - (iface_tr[:, 1:] + iface_tr[:, :-1])
              * dhsr[None, :, None, None])

    # physics (phy_phypar contract: adds to the grid tendencies)
    extras = None
    if phys_fn is not None:
        (du, dv, dtt, dtrt), extras = phys_fn(dy, fphy)
        utend = utend + du
        vtend = vtend + dv
        ttend = ttend + dtt
        trtend = trtend + dtrt

    # back to spectral (dyn_grtend.f90:233-277): one batched vdspec over
    # [wind | T-flux | tracer-flux], one grid_to_spec over [ke | T | tracer]
    u_side = torch.cat([utend, -ug * tgg,
                        (-ug[None] * trg).reshape(ntr * kx, *ug.shape[1:])])
    v_side = torch.cat([vtend, -vg_ * tgg,
                        (-vg_[None] * trg).reshape(ntr * kx, *vg_.shape[1:])])
    vors, divs = T.vdspec(to_spec_dtype(u_side), to_spec_dtype(v_side),
                          kcos=2)
    vordt = vors[:kx]
    divdt = divs[:kx]
    tdt_flux = divs[kx:2 * kx]
    trdt_flux = divs[2 * kx:].reshape(ntr, kx, *divs.shape[1:])

    ke = 0.5 * (ug * ug + vg_ * vg_)
    s1 = T.grid_to_spec(to_spec_dtype(torch.cat(
        [ke, ttend, trtend.reshape(ntr * kx, *ttend.shape[1:])])))
    divdt = divdt - T.lap(s1[:kx])
    tdt = tdt_flux + s1[kx:2 * kx]
    trdt = trdt_flux + s1[2 * kx:].reshape(ntr, kx, *s1.shape[1:])

    return Tendencies(vordt=vordt, divdt=divdt, tdt=tdt, psdt=psdt,
                      trdt=trdt), extras


def sptend(dy, f: PrognosticFields, tend: Tendencies,
           imp: ImplicitCoefs) -> Tendencies:
    """Spectral linear tendencies (dyn_sptend.f90:27-66)."""
    T = dy.T
    dhs = dy.vgt["dhs"]
    dhsr = dy.vgt["dhsr"]
    kx = f.vor.shape[0]

    dmeanc = torch.sum(f.div * dhs[:, None, None, None], dim=0)  # (mx, 2, nx)
    psdt = tend.psdt - dmeanc
    psdt[0, :, 0] = 0.0

    # sigma-dot at interfaces (only interior kx-1 accumulate; last stays 0)
    incr = -(dhs[: kx - 1, None, None, None]
             * (f.div[: kx - 1] - dmeanc[None]))
    zero_iface = torch.zeros_like(dmeanc)[None]
    sigdtc = torch.cat([zero_iface, torch.cumsum(incr, dim=0), zero_iface])

    tref = imp.tref
    dtref = tref[1:] - tref[:-1]
    dumk = sigdtc[1:-1] * dtref[:, None, None, None]
    dumk = torch.cat([zero_iface, dumk, zero_iface])

    tdt = (tend.tdt
           - (dumk[1:] + dumk[:-1]) * dhsr[:, None, None, None]
           + imp.tref3[:, None, None, None] * (sigdtc[1:] + sigdtc[:-1])
           - imp.tref2[:, None, None, None] * dmeanc[None])

    # geopotential + RT*lap(ps) into the divergence tendency
    phi = geopotential(f.t, dy.phis, dy.vg_np, dy.geop_corrections)
    dump = phi + dy.rgas * imp.tref[:, None, None, None] * f.ps[None]
    divdt = tend.divdt - T.lap(dump)

    return Tendencies(vordt=tend.vordt, divdt=divdt, tdt=tdt, psdt=psdt,
                      trdt=tend.trdt)
