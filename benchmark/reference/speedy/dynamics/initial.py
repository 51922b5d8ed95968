"""Initial conditions: reference atmosphere at rest (PyTorch port of
speedyml/dynamics/initial.py).

The istart=0 path of the reference (src/ini_invars.f90:36-112): isothermal
216 K stratosphere over a constant-lapse-rate troposphere in hydrostatic
balance with the (truncated) orography, at rest, with reference humidity
decaying with height. Built in numpy float64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import DYN, PHYS

from .state import SpectralState


def rest_state(dy) -> SpectralState:
    cfg = dy.config
    kx, mx, nx, ntr = cfg.kx, cfg.mx, cfg.nx, cfg.ntr

    gam1 = DYN.gamma / (1000.0 * PHYS.grav)
    tref, ttop = 288.0, 216.0
    gam2 = gam1 / tref
    rgam = PHYS.rgas * gam1
    rgamr = 1.0 / rgam
    ccon = np.sqrt(2.0)     # mean-value coefficient: c00 = sqrt(2) * mean

    fsg = np.asarray(dy.vg.fsg)
    phis = np.asarray(dy.phis_np, np.float64)          # (mx, 2, nx)

    t = np.zeros((kx, mx, 2, nx))
    t[0, 0, 0, 0] = ccon * ttop
    t[1, 0, 0, 0] = ccon * ttop
    surfs = -gam1 * phis
    surfs[0, 0, 0] = ccon * tref - gam1 * phis[0, 0, 0]
    for k in range(2, kx):
        t[k] = surfs * float(fsg[k] ** rgam)

    # log-ps consistent with the temperature profile (p_ref = 1013 hPa at z=0)
    rlog0 = np.log(1.013)
    phis0 = np.asarray(dy.phis0_grid, np.float64)
    surfg = rlog0 + rgamr * np.log(1.0 - gam2 * phis0)
    ps = dy.T.host_trunct(dy.T.host_grid_to_spec(surfg))

    # tropospheric specific humidity in g/kg
    esref = 17.0
    qref = DYN.refrh1 * 0.622 * esref
    qexp = DYN.hscale / DYN.hshum
    surfg_q = qref * np.exp(qexp * surfg)
    surfs_q = dy.T.host_trunct(dy.T.host_grid_to_spec(surfg_q))
    tr = np.zeros((ntr, kx, mx, 2, nx))
    for k in range(2, kx):
        tr[0, k] = surfs_q * float(fsg[k] ** qexp)

    zeros = np.zeros((kx, mx, 2, nx))

    def stack2(x):
        # round to the model dtype on the host first, as the JAX package does
        x = np.asarray(np.stack([x, x], axis=0), dy.np_dtype)
        return torch.as_tensor(x, device=dy.device)

    return SpectralState(vor=stack2(zeros), div=stack2(zeros), t=stack2(t),
                         ps=stack2(ps), tr=stack2(tr))
