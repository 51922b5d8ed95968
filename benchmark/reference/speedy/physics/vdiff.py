"""Vertical diffusion and shallow convection (PyTorch port of
speedyml/physics/vdiff.py; reference: src/phy_vdifsc.f90).

Indexing note: the reference's sigh(k) (mod_physcon, 0:kx) is the interface
BELOW 1-based layer k; for our 0-based layer k that interface is sigh[k+1].
"""

from __future__ import annotations

import torch

from .constants import PP, DeviceTables


def vdifsc(st: DeviceTables, ua, va, se, rh, qa, qsat, phi, icnv):
    """Returns (utenvd, vtenvd, ttenvd, qtenvd); all (kx, il, ix).

    icnv: (il, ix) >0 where deep convection active.
    """
    kx = se.shape[0]
    nl1 = kx - 2

    sig = st.sig
    sigh = st.sigh   # (kx+1,), index 0 = top interface
    dsig = st.dsig

    cshc = dsig[kx - 1] / 3600.0
    cvdi = (sigh[kx - 1] - sigh[1]) / ((kx - 2) * 3600.0)

    fshcq = cshc / PP.trshc
    fshcse = cshc / (PP.trshc * PP.cp)
    fvdiq = cvdi / PP.trvdi
    fvdise = cvdi / (PP.trvds * PP.cp)

    rsig = [1.0 / d for d in dsig]         # (kx,)
    # rsig1 for 0-based layer k = 1/(1 - sigma at its lower interface)
    rsig1 = [1.0 / (1.0 - s) for s in sigh[1:kx]]   # layers 0..kx-2

    utenvd = torch.zeros_like(se)
    vtenvd = torch.zeros_like(se)
    tt = [torch.zeros_like(se[0]) for _ in range(kx)]
    qt = [torch.zeros_like(se[0]) for _ in range(kx)]

    # ---- 2. shallow convection between PBL (kx-1) and nl1 ----
    drh0 = PP.rhgrad * (sig[kx - 1] - sig[nl1])
    fvdiq2_pbl = fvdiq * sigh[kx - 1]      # sigh(nl1) 1-based

    dmse = (se[kx - 1] - se[nl1]) + PP.alhc * (qa[kx - 1] - qsat[nl1])
    drh = rh[kx - 1] - rh[nl1]
    zero = torch.zeros_like(dmse)
    fcnv = torch.where(icnv > 0, PP.redshc, 1.0).to(dmse.dtype)

    shc = dmse >= 0.0
    fluxse = torch.where(shc, fcnv * fshcse * dmse, zero)
    tt[nl1] = tt[nl1] + fluxse * rsig[nl1]
    tt[kx - 1] = tt[kx - 1] - fluxse * rsig[kx - 1]

    fluxq_shc = torch.where(shc & (drh >= 0.0),
                            fcnv * fshcq * qsat[kx - 1] * drh, zero)
    fluxq_vdi = torch.where(~shc & (drh >= drh0),
                            fvdiq2_pbl * qsat[nl1] * drh, zero)
    fluxq = fluxq_shc + fluxq_vdi
    qt[nl1] = qt[nl1] + fluxq * rsig[nl1]
    qt[kx - 1] = qt[kx - 1] - fluxq * rsig[kx - 1]

    # ---- 3. vertical diffusion of moisture above the PBL ----
    # reference k=3..nlev-2 (1-based) with sigh(k)>0.5 -> 0-based k=2..kx-3,
    # lower interface sigh[k+1]
    for k in range(2, kx - 2):
        if sigh[k + 1] > 0.5:
            drh0_k = PP.rhgrad * (sig[k + 1] - sig[k])
            fvdiq2 = fvdiq * sigh[k + 1]
            drh_k = rh[k + 1] - rh[k]
            fq = torch.where(drh_k >= drh0_k, fvdiq2 * qsat[k] * drh_k,
                             zero)
            qt[k] = qt[k] + fq * rsig[k]
            qt[k + 1] = qt[k + 1] - fq * rsig[k + 1]

    # ---- 4. damping of super-adiabatic lapse rate ----
    # For each k < kx-1: if se(k) < se0 = se(k+1)+segrad*(phi(k)-phi(k+1)):
    #   tt(k) += f*rsig(k);  tt(k1) -= f*rsig1(k) for all k1 > k
    cum = torch.zeros_like(se[0])
    for k in range(kx - 1):
        se0 = se[k + 1] + PP.segrad * (phi[k] - phi[k + 1])
        f = torch.where(se[k] < se0, fvdise * (se0 - se[k]), zero)
        tt[k] = tt[k] + f * rsig[k] - cum
        cum = cum + f * rsig1[k]
    tt[kx - 1] = tt[kx - 1] - cum

    ttenvd = torch.stack(tt, dim=0)
    qtenvd = torch.stack(qt, dim=0)
    return utenvd, vtenvd, ttenvd, qtenvd
