"""Physics constants and sigma/latitude function tables (the port's own copy
of speedyml/physics/constants.py; host-side numpy, float64).

Gathers the reference's constant modules (src/mod_physcon.f90,
mod_cnvcon.f90, mod_lsccon.f90, mod_vdicon.f90, mod_radcon.f90,
mod_sflcon.f90) plus the sigma-function setup of inphys
(src/ini_inphys.f90) into one typed container.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PhysicsParams:
    # mod_physcon
    p0: float = 1.0e5
    gg: float = 9.81
    rd: float = 287.0
    cp: float = 1004.0
    alhc: float = 2501.0     # latent heat of condensation [J/g]
    alhs: float = 2801.0
    sbc: float = 5.67e-8

    # convection (mod_cnvcon)
    psmin: float = 0.8
    trcnv: float = 6.0
    rhbl: float = 0.9
    rhil: float = 0.7
    entmax: float = 0.5
    smf: float = 0.8

    # large-scale condensation (mod_lsccon)
    trlsc: float = 4.0
    rhlsc: float = 0.9
    drhlsc: float = 0.1
    rhblsc: float = 0.95

    # vertical diffusion / shallow convection (mod_vdicon)
    trshc: float = 6.0
    trvdi: float = 24.0
    trvds: float = 6.0
    redshc: float = 0.5
    rhgrad: float = 0.5
    segrad: float = 0.1

    # radiation & clouds (mod_radcon)
    solc: float = 342.0
    albsea: float = 0.07
    albice: float = 0.60
    albsn: float = 0.60
    rhcl1: float = 0.30
    rhcl2: float = 1.00
    qacl: float = 0.20
    wpcl: float = 0.2
    pmaxcl: float = 10.0
    clsmax: float = 0.60
    clsminl: float = 0.15
    gse_s0: float = 0.25
    gse_s1: float = 0.40
    albcl: float = 0.43
    albcls: float = 0.50
    epssw: float = 0.020
    epslw: float = 0.05
    emisfc: float = 0.98
    absdry: float = 0.033
    absaer: float = 0.033
    abswv1: float = 0.022
    abswv2: float = 15.000
    abscl1: float = 0.015
    abscl2: float = 0.15
    ablwin: float = 0.3
    ablco2: float = 6.0
    ablwv1: float = 0.7
    ablwv2: float = 50.0
    ablcl1: float = 12.0
    ablcl2: float = 0.6

    # surface fluxes (mod_sflcon)
    fwind0: float = 0.95
    ftemp0: float = 1.0
    fhum0: float = 0.0
    cdl: float = 2.4e-3
    cds: float = 1.0e-3
    chl: float = 1.2e-3
    chs: float = 0.9e-3
    vgust: float = 5.0
    ctday: float = 1.0e-2
    dtheta: float = 3.0
    fstab: float = 0.67
    hdrag: float = 2000.0
    fhdrag: float = 0.5
    clambda: float = 7.0
    clambsn: float = 7.0

    # surface / soil (mod_surfcon)
    swcap: float = 0.30
    swwil: float = 0.17
    sd2sc: float = 60.0


PP = PhysicsParams()


@dataclasses.dataclass(frozen=True)
class SigmaTables:
    """Functions of sigma (ini_inphys.f90:22-48), float64 numpy."""

    sig: np.ndarray      # (kx,) full-level sigma
    sigl: np.ndarray     # log(sig)
    sigh: np.ndarray     # (kx+1,) half-level sigma (index 0 = top)
    dsig: np.ndarray     # layer thickness
    grdsig: np.ndarray   # g/(dsig*p0)
    grdscp: np.ndarray   # grdsig/cp
    wvi: np.ndarray      # (kx, 2) vertical interpolation weights


def make_sigma_tables(hsg: np.ndarray) -> SigmaTables:
    kx = hsg.size - 1
    sig = 0.5 * (hsg[1:] + hsg[:-1])
    sigl = np.log(sig)
    dsig = hsg[1:] - hsg[:-1]
    grdsig = PP.gg / (dsig * PP.p0)
    grdscp = grdsig / PP.cp

    wvi = np.zeros((kx, 2))
    for k in range(kx - 1):
        wvi[k, 0] = 1.0 / (sigl[k + 1] - sigl[k])
        wvi[k, 1] = (np.log(hsg[k + 1]) - sigl[k]) * wvi[k, 0]
    wvi[kx - 1, 0] = 0.0
    wvi[kx - 1, 1] = (np.log(0.99) - sigl[kx - 1]) * wvi[kx - 2, 0]
    return SigmaTables(sig=sig, sigl=sigl, sigh=hsg.copy(), dsig=dsig,
                       grdsig=grdsig, grdscp=grdscp, wvi=wvi)


def make_fband() -> np.ndarray:
    """LW band energy fractions vs temperature (radset, phy_radiat.f90:659-692).

    Returns (301, 4) table indexed by round(T)-100, clipped to [100, 400].
    """
    eps1 = 1.0 - PP.epslw
    fband = np.zeros((301, 4))
    t = np.arange(200, 321)
    i = t - 100
    fband[i, 1] = (0.148 - 3.0e-6 * (t - 247) ** 2) * eps1
    fband[i, 2] = (0.356 - 5.2e-6 * (t - 282) ** 2) * eps1
    fband[i, 3] = (0.314 + 1.0e-5 * (t - 315) ** 2) * eps1
    fband[i, 0] = eps1 - fband[i, 1] - fband[i, 2] - fband[i, 3]
    fband[: 200 - 100] = fband[200 - 100]
    fband[320 - 100 + 1:] = fband[320 - 100]
    return fband


class DeviceTables:
    """The sigma functions as the tensor physics reads them: Python floats
    where the schemes multiply a field by one level's value, and small
    tensors on `device` in `dtype` where they use a whole profile. Built once
    (in `Physics`), so that no step converts or uploads a constant. The JAX
    package embeds the same numpy tables in its compiled programs."""

    def __init__(self, st: SigmaTables, dtype, device):
        import torch

        kx = st.sig.size
        self.sig = [float(v) for v in st.sig]
        self.sigl = [float(v) for v in st.sigl]
        self.sigh = [float(v) for v in st.sigh]
        self.dsig = [float(v) for v in st.dsig]
        self.wvi = [[float(v) for v in row] for row in st.wvi]

        def col(a):          # (kx,) -> (kx, 1, 1) on the device
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=device)[:, None, None]

        self.sig_col = col(st.sig)
        self.sig2_col = col(st.sig ** 2)
        self.grdsig_col = col(st.grdsig)
        self.grdscp_col = col(st.grdscp)
        self.pfact_col = col(st.dsig * (PP.p0 / PP.gg))   # lscond
        # entrainment profile of convmf over levels 1..kx-2
        # (phy_convmf.f90:80-88)
        entr = np.maximum(0.0, st.sig[1:kx - 1] - 0.5) ** 2
        self.entr = [0.0] + [float(v) for v in PP.entmax * entr / entr.sum()] \
            + [0.0]
        self.fband = torch.as_tensor(make_fband(), dtype=dtype, device=device)
        self.levels = torch.arange(kx, dtype=torch.int32,
                                   device=device)[:, None, None]
