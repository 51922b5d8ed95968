"""Simplified mass-flux deep convection (PyTorch port of
speedyml/physics/convection.py; reference: src/phy_convmf.f90).

The reference's per-column control flow (top detection, descending
entrainment loop) is expressed as masked updates over the whole (il, ix) grid
with a short static descent over levels.

All level arrays are (kx, il, ix); 0-based level 0 = top, kx-1 = PBL.
"""

from __future__ import annotations

import torch

from .constants import PP, DeviceTables


def convmf(st: DeviceTables, psa, se, qa, qsat):
    """Returns (itop, cbmf, precnv, dfse, dfqa).

    itop: (il, ix) int32, 0-based top level of convection; kx = no convection.
    dfse/dfqa: net fluxes into each layer (to be converted to tendencies by
    the caller via rps*grdscp/grdsig as in phy_phypar.f90:100-105).
    """
    kx = se.shape[0]
    nl1 = kx - 2                      # 0-based index of layer above PBL
    wvi, entr = st.wvi, st.entr

    fqmax = 5.0
    fm0 = PP.p0 * st.dsig[kx - 1] / (PP.gg * PP.trcnv * 3600.0)
    rdps = 2.0 / (1.0 - PP.psmin)
    alhc = PP.alhc

    # saturation moist static energy (levels >= 1 used)
    mss = se + alhc * qsat

    # ---- 2. conditions for convection (phy_convmf.f90:90-140) ----
    mse0 = se[kx - 1] + alhc * qa[kx - 1]
    mse1 = torch.minimum(mse0, se[nl1] + alhc * qa[nl1])
    mss0 = torch.maximum(mse0, mss[kx - 1])

    ktop1 = torch.full(psa.shape, kx - 1, dtype=torch.int32,
                       device=psa.device)
    ktop2 = ktop1
    msthr = torch.zeros_like(mse0)
    # 0-based k from kx-4 down to 2 (reference k=nlev-3..3 descending)
    for k in range(kx - 4, 1, -1):
        mss2 = mss[k] + wvi[k][1] * (mss[k + 1] - mss[k])
        ktop1 = torch.where(mss0 > mss2, k, ktop1)
        hit2 = mse1 > mss2
        ktop2 = torch.where(hit2, k, ktop2)
        msthr = torch.where(hit2, mss2, msthr)

    qthr0 = PP.rhbl * qsat[kx - 1]
    qthr1 = PP.rhbl * qsat[nl1]
    lqthr = (qa[kx - 1] > qthr0) & (qa[nl1] > qthr1)

    cond_base = (psa > PP.psmin) & (ktop1 < kx - 1)
    case1 = ktop2 < kx - 1
    active = cond_base & (case1 | lqthr)
    itop = torch.where(active, ktop1, kx)
    qdif = torch.where(case1,
                       torch.maximum(qa[kx - 1] - qthr0,
                                     (mse0 - msthr) / alhc),
                       qa[kx - 1] - qthr0)

    # ---- 3. convection fluxes (phy_convmf.f90:142-237) ----
    zero = torch.zeros_like(psa)
    dfse = [zero] * kx
    dfqa = [zero] * kx

    # 3.1 boundary layer (cloud base); inactive columns may divide by zero
    # under the mask, as in the reference
    k, k1 = kx - 1, kx - 2
    qmax = torch.maximum(1.01 * qa[k], qsat[k])
    sb = se[k1] + wvi[k1][1] * (se[k] - se[k1])
    qb = torch.minimum(qa[k1] + wvi[k1][1] * (qa[k] - qa[k1]), qa[k])
    fpsa = psa * torch.clamp((psa - PP.psmin) * rdps, max=1.0)
    fmass = torch.where(
        active, fm0 * fpsa * torch.clamp(qdif / (qmax - qb), max=fqmax), zero)
    cbmf = fmass
    fus = fmass * se[k]
    fuq = fmass * qmax
    fds = fmass * sb
    fdq = fmass * qb
    dfse[k] = fds - fus
    dfqa[k] = fdq - fuq

    # 3.2 intermediate layers (entrainment) + 3.3 top layer, masked descent
    precnv = zero
    dfqa_pbl_extra = zero
    for k in range(kx - 2, 1, -1):
        k1 = k - 1
        inter = active & (itop < k)
        top = active & (itop == k)

        # --- top layer: condensation + detrainment (uses carry as-is) ---
        qsatb = qsat[k] + wvi[k][1] * (qsat[k + 1] - qsat[k])
        prec_k = torch.clamp(fuq - fmass * qsatb, min=0.0)
        dfse[k] = torch.where(top, fus - fds + alhc * prec_k, dfse[k])
        dfqa[k] = torch.where(top, fuq - fdq - prec_k, dfqa[k])
        precnv = precnv + torch.where(top, prec_k, zero)

        # --- intermediate layer ---
        lower = fus - fds
        lower_q = fuq - fdq
        enmass = entr[k] * psa * cbmf
        fmass_n = fmass + enmass
        fus_n = fus + enmass * se[k]
        fuq_n = fuq + enmass * qa[k]
        sb = se[k1] + wvi[k1][1] * (se[k] - se[k1])
        qb = qa[k1] + wvi[k1][1] * (qa[k] - qa[k1])
        fds_n = fmass_n * sb
        fdq_n = fmass_n * qb

        delq = PP.rhil * qsat[k] - qa[k]
        fsq = torch.where(inter & (delq > 0.0), PP.smf * cbmf * delq, zero)

        dfse[k] = torch.where(inter, lower + fds_n - fus_n, dfse[k])
        dfqa[k] = torch.where(inter, lower_q + fdq_n - fuq_n + fsq, dfqa[k])
        dfqa_pbl_extra = dfqa_pbl_extra - fsq

        fmass = torch.where(inter, fmass_n, fmass)
        fus = torch.where(inter, fus_n, fus)
        fuq = torch.where(inter, fuq_n, fuq)
        fds = torch.where(inter, fds_n, fds)
        fdq = torch.where(inter, fdq_n, fdq)

    dfqa[kx - 1] = dfqa[kx - 1] + dfqa_pbl_extra
    dfse_a = torch.stack(dfse, dim=0) * active[None]
    dfqa_a = torch.stack(dfqa, dim=0) * active[None]
    return itop, cbmf, precnv * active, dfse_a, dfqa_a
