"""Large-scale condensation (PyTorch port of
speedyml/physics/condensation.py; reference: src/phy_lscond.f90)."""

from __future__ import annotations

import torch

from .constants import PP, DeviceTables


def lscond(st: DeviceTables, psa, qa, qsat, itop):
    """Returns (itop, precls, dtlsc, dqlsc).

    dqlsc in [g/kg / s]; dtlsc in [K/s]; precls in [g/(m^2 s)].
    """
    kx = qa.shape[0]

    qsmax = 10.0
    rtlsc = 1.0 / (PP.trlsc * 3600.0)
    tfact = PP.alhc / PP.cp

    psa2 = psa * psa

    sig2 = st.sig2_col
    rhref = PP.rhlsc + PP.drhlsc * (sig2 - 1.0)
    rhref = torch.cat([rhref[:kx - 1],
                       torch.clamp(rhref[kx - 1:], min=PP.rhblsc)])
    dqmax = qsmax * sig2 * rtlsc

    dqa = rhref * qsat - qa                       # (kx, il, ix)
    # level 0 (top) excluded (loop k=2..nlev in the reference)
    cond = (dqa < 0.0) & (st.levels > 0)
    zero = torch.zeros_like(dqa)
    dqlsc = torch.where(cond, dqa * rtlsc, zero)
    dtlsc = torch.where(cond,
                        tfact * torch.minimum(-dqlsc, dqmax * psa2[None]),
                        zero)

    # update cloud-top: lowest-index condensing level
    cond_top = torch.amin(torch.where(cond, st.levels, kx), dim=0)
    itop_new = torch.minimum(itop, cond_top)

    precls = -torch.sum(st.pfact_col * dqlsc, dim=0) * psa
    return itop_new, precls, dtlsc, dqlsc
