"""The plain coupled step: the hybrid step under a fed-back SST anomaly,
and the weekly slab-ocean step that makes the anomaly, in float64.

It follows the published coupling (SPEEDY-ML, mpires.f90:456-563,776-791
and mod_slab_ocean_reservoir.f90:271-405,833-867):

* each 6-h step, the sea boundary is the ice-blended climatological SST
  plus the anomaly, bounded to 200..306 K; the window reads it through the
  6 K hybrid-SST gate of ini_sea, the reservoirs read it rounded to float32
  and floored at 272 K;
* once a week, each horizontal region's ocean reservoir reads its halo
  patch of the week's supervectors, the bottom-level atmosphere and logp
  averaged over the week, SST and TISR as they were at its last step;
  gather, standardize, advance, read out, unstandardize gives the SST of
  the region's core;
* the prediction replaces the climatology at the active regions' cores,
  within 6 K of the climatology and inside 200..306 K; the anomaly fed
  back is that field less the climatology of the week's last step.

Like `hybrid.py`, it takes nothing from the measured program: the weights
come as plain tensors made from the run's seed, the input map is built
here from the region layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .hybrid import QMIN, SST_MIN, ReferenceEsn, ReferenceHybrid
from .speedy.core.calendar import ModelDate
from .speedy.domain.decomposition import _patch_indices, pack_global
from .speedy.hybrid.state_io import GridState

F64 = torch.float64
SST_LO, SST_HI = 200.0, 306.0     # bounds of the SST field fed back [K]


def ocean_maps(L):
    """(input_index (R_o, n_in), target_index (R_o, ncore), sst_core
    (ncore,)) of the horizontal regions' ocean reservoirs, into the packed
    supervector of layout L: inputs are [bottom-level atmosphere over the
    halo patch, variables fastest | logp | SST | TISR patches], targets the
    SST at the region's core; sst_core are the input positions that read
    the core's SST."""
    kz = L.kx - 1
    ngp = L.il * L.ix
    npatch = L.inpy * L.inpx
    nv = L.nvars
    ncore = L.resy * L.resx
    a0 = L.gv_sizes["atmo3d"][0]
    R = L.nregy * L.nregx
    n_in = nv * npatch + 3 * npatch
    inp = np.empty((R, n_in), np.int64)
    tgt = np.empty((R, ncore), np.int64)
    for r in range(R):
        ry, rx = divmod(r, L.nregx)
        patch = _patch_indices(L.il, L.ix, ry * L.resy - L.overlap,
                       rx * L.resx - L.overlap, L.inpy, L.inpx)
        for p in range(npatch):
            for v in range(nv):
                inp[r, v + nv * p] = a0 + (v * L.kx + kz) * ngp + patch[p]
        for j, name in enumerate(("logp", "sst", "tisr")):
            s = nv * npatch + j * npatch
            inp[r, s:s + npatch] = L.gv_sizes[name][0] + patch
        tgt[r] = L.gv_sizes["sst"][0] + _patch_indices(
            L.il, L.ix, ry * L.resy, rx * L.resx, L.resy, L.resx)
    s0 = nv * npatch + npatch
    core = np.array([s0 + (cy + L.overlap) * L.inpx + cx + L.overlap
                     for cy in range(L.resy) for cx in range(L.resx)])
    return inp, tgt, core


def week_inputs(L, gv_sum, gv_last, steps: int):
    """The ocean's weekly supervector: atmo3d and logp as the week's mean,
    everything else as at its last step."""
    out = gv_last.clone()
    for name in ("atmo3d", "logp"):
        s0, s1 = L.gv_sizes[name]
        out[s0:s1] = gv_sum[s0:s1] / steps
    return out


class ReferenceOcean:
    """The slab-ocean reservoirs and their readout, float64."""

    def __init__(self, w: dict, stz: dict, L, active):
        self.esn = ReferenceEsn(w, stz, L, 1.0, 1.0)
        self.stz = self.esn.stz
        inp, tgt, _ = ocean_maps(L)
        dev = self.esn.win.device
        self.inp = torch.as_tensor(inp, device=dev)
        self.tgt = tgt
        self.active = np.asarray(active, bool)
        self.L = L

    def step(self, x, gv_week):
        """One weekly step: (x', the SST of each region's core (R_o, ncore)
        in K)."""
        s = self.stz
        u = (gv_week.to(F64)[self.inp] - s["in_mean"]) / s["in_std"]
        x = self.esn.advance(x.to(F64), u)
        return x, self.esn.readout(x) * s["out_std"] + s["out_mean"]

    def compose(self, core, clim, clip: float):
        """The SST field fed back: the prediction at the active regions'
        cores, the climatology elsewhere, within `clip` K of the
        climatology, inside 200..306 K (host float64)."""
        clim = np.asarray(clim, np.float64)
        flat = clim.copy().reshape(-1)
        g0 = self.L.gv_sizes["sst"][0]
        act = self.active
        flat[(self.tgt[act] - g0).reshape(-1)] = \
            core.detach().cpu().numpy()[act].reshape(-1)
        grid = np.clip(flat.reshape(clim.shape), clim - clip, clim + clip)
        return np.clip(grid, SST_LO, SST_HI)

    def active_points(self):
        """Flat grid indices of the active regions' core points."""
        g0 = self.L.gv_sizes["sst"][0]
        return (self.tgt[self.active] - g0).reshape(-1)


class ReferenceCoupled:
    """The plain coupled hybrid of a configuration, float64 on `device`:
    the atmosphere's step under an SST anomaly and the ocean's weekly
    step."""

    def __init__(self, cfg: dict, bindir: str, w: dict, stz: dict,
                 ocean_w: dict, ocean_stz: dict, active, device):
        self.hyb = ReferenceHybrid(cfg, bindir, w, stz, device)
        self.L = self.hyb.L
        self.ocean = ReferenceOcean(ocean_w, ocean_stz, self.L, active)
        self.clip = float(cfg["ocean"]["slab_anom_clip"])
        self.device = self.hyb.device
        self.model_gv = None

    def sea(self, date: ModelDate, anom):
        """(sst, ss, ti, clim): the SST the window reads (host float64, the
        ice-blended climatology plus the anomaly, bounded), the SST and
        TISR sections the reservoirs read, and the climatology."""
        hyb = self.hyb
        clim, _, ti = hyb.boundary(date)
        a = anom.detach().to("cpu", F64).numpy()
        sst = np.clip(clim + a, SST_LO, SST_HI)
        ss = torch.clamp(hyb._dev(np.float32(sst)), min=SST_MIN)
        return sst, ss, ti, clim

    def inputs(self, atmo, logp, pr, date: ModelDate, anom):
        """The packed supervector a step reads (gv)."""
        _, ss, ti, _ = self.sea(date, anom)
        return pack_global(self.L, *(t.to(self.device, F64)
                                     for t in (atmo, logp, pr)), ss, ti)

    def advance(self, x, gv):
        """The atmosphere reservoirs' advance alone on gv."""
        esn = self.hyb.esn
        s = esn.stz
        return esn.advance(x.to(self.device, F64),
                           (gv[esn.idx] - s["in_mean"]) / s["in_std"])

    def step(self, x, atmo, logp, pr, date: ModelDate, anom):
        """One hybrid step from (x, atmo, logp, precip_t) at `date` under
        the anomaly. Returns (x, atmo, logp, precip_t, safe, gv); the
        window's packed forecast is kept as `self.model_gv`."""
        hyb = self.hyb
        x, atmo, logp, pr = (t.to(self.device, F64)
                             for t in (x, atmo, logp, pr))
        sst, ss, ti, _ = self.sea(date, anom)
        gv = pack_global(self.L, atmo, logp, pr, ss, ti)
        gs = GridState(t=atmo[0], u=atmo[1], v=atmo[2],
                       q=torch.clamp(atmo[3], min=0.0), logp=logp)
        fgs, precip_mm, safe = hyb.window(gs, date, sst)
        f_atmo = torch.stack([fgs.t, fgs.u, fgs.v,
                              torch.clamp(fgs.q, min=QMIN)])
        f_pr = torch.log1p(torch.clamp(precip_mm, min=0.0) / hyb.esn.eps)
        self.model_gv = pack_global(self.L, f_atmo, fgs.logp, f_pr, ss, ti)
        return (*hyb.esn.exchange(x, gv, self.model_gv), bool(safe), gv)

    def week(self, x_ocean, gv_sum, gv_last, steps: int, clim_last):
        """The ocean's weekly step on the week's supervectors: (x_ocean',
        the anomaly fed back (il, ix) host float64)."""
        x_ocean, core = self.ocean.step(
            x_ocean, week_inputs(self.L, gv_sum, gv_last, steps))
        grid = self.ocean.compose(core, clim_last, self.clip)
        return x_ocean, grid - np.asarray(clim_last, np.float64)

