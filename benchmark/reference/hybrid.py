"""A plain hybrid step for one member, in float64, on top of the frozen
model copy in `speedy/`.

It follows the published algorithm (the SPEEDY-ML hybrid step,
mod_reservoir.f90:1418-1489 and parallelmain.f90:206-273): pack the state
into the global supervector, run the 6-h SPEEDY window from it, pack the
window's forecast, standardize, advance the reservoirs
x <- (1-l) x + l tanh(A x + Win u), read out Wout [model; x~], unstandardize,
scatter back to the grid and clamp. It is written out here operation by
operation and takes nothing from the measured program: the weights come to
it as plain tensors made from the run's seed, the boundary state it works
out itself from the boundary files and the date.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .speedy.core.calendar import ModelDate
from .speedy.core.config import ModelConfig
from .speedy.coupler.climatology import build_climatology
from .speedy.coupler.daily import init_coupler_state
from .speedy.domain.decomposition import (build_layout, pack_global,
                                          scatter_outputs)
from .speedy.dynamics.core import Dycore
from .speedy.dynamics.initial import rest_state
from .speedy.hybrid.state_io import GridState, extract, inject
from .speedy.io.boundary import BoundaryData
from .speedy.model import Speedy
from .speedy.physics.driver import init_rad_carry, phys_hook
from .speedy.physics.radiation import diurnal_tisr
from .speedy.transforms.tables import build_tables

F64 = torch.float64
QMIN = 1e-6          # q floor [g/kg] of the hybrid's outputs
SST_MIN = 272.0      # floor of the SST fed to the reservoirs [K]


def model_config(cfg: dict, dtype: str = "float64") -> ModelConfig:
    m = cfg["model"]
    return ModelConfig(ntrun=m["ntrun"], ix=m["ix"], il=m["il"], kx=m["kx"],
                       dtype=dtype)


def layout(cfg: dict):
    """The region layout of the configuration (1152 regions of 2 x 2
    points, one halo point, all 8 levels in one slab at T30L8)."""
    m, lay = cfg["model"], cfg["layout"]
    tables = build_tables(m["ntrun"], m["ix"], m["il"])
    return build_layout(ix=m["ix"], il=m["il"], kx=m["kx"],
                        resx=lay["resx"], resy=lay["resy"],
                        overlap=lay["overlap"], nz_slabs=lay["nz_slabs"],
                        radang_deg=np.degrees(tables.radang))


def reservoir_nodes(cfg: dict, n_in: int) -> int:
    """n = round(m / n_in) * n_in (mod_reservoir.f90:169-172)."""
    return max(1, int(round(cfg["reservoir"]["nodes_per_input"] / n_in))) \
        * n_in


def start_state(cfg: dict, bindir: str):
    """The model's state of rest at its first date (agcm_init's rest
    start), as float64 grid fields on the CPU: (atmo (4, kx, il, ix), logp
    (il, ix))."""
    dy = Dycore(model_config(cfg), orog=BoundaryData(bindir).orog,
                device="cpu")
    gs = extract(dy, rest_state(dy))
    atmo = torch.stack([gs.t, gs.u, gs.v, torch.clamp(gs.q, min=QMIN)])
    return atmo, gs.logp


def boundary_host(clim, tables, date: ModelDate, ix: int):
    """The boundary fields the reservoirs read at `date`: the
    climatological SST of a fresh coupler (ice-blended) and the analytic
    diurnal TISR, host float64."""
    sst = np.asarray(init_coupler_state(clim, date).sst_am, np.float64)
    tisr = diurnal_tisr(date.tyear, date.ihour, np.asarray(tables.gsin),
                        np.asarray(tables.gcos), ix)
    return sst, np.asarray(tisr, np.float64)


class ReferenceEsn:
    """The reservoirs and their readout, float64."""

    def __init__(self, w: dict, stz: dict, L, eps: float, cap_mm: float):
        self.a_val = w["a_val"].to(F64)
        self.shifts = tuple(int(s) for s in w["shifts"])
        self.win = w["win"].to(F64)
        self.wout = w["wout"].to(F64)
        self.node_map = w["node_map"]
        self.leak = float(w["leakage"])
        self.stz = {k: v.to(F64) for k, v in stz.items()}
        self.L = L
        dev = self.win.device
        self.idx = torch.as_tensor(L.input_index, dtype=torch.int64,
                                   device=dev)
        self.tidx = torch.as_tensor(L.target_index, dtype=torch.int64,
                                    device=dev)
        self.eps = eps
        self.pr_cap = math.log1p(cap_mm / eps)

    def advance(self, x, u):
        ax = torch.zeros_like(x)
        for d, s in enumerate(self.shifts):
            ax = ax + self.a_val[:, :, d] * torch.roll(x, -s, dims=-1)
        drive = ax + self.win * u[:, self.node_map]
        return (1.0 - self.leak) * x + self.leak * torch.tanh(drive)

    def readout(self, x, model_std=None):
        xt = x.clone()
        xt[:, 1::2] = x[:, 1::2] ** 2
        aug = xt if model_std is None else torch.cat([model_std, xt], dim=-1)
        # (R, n_out, k) x (R, k) in blocks of regions
        out = torch.empty(aug.shape[0], self.wout.shape[1], dtype=F64,
                          device=aug.device)
        for r0 in range(0, aug.shape[0], 128):
            r1 = r0 + 128
            out[r0:r1] = torch.einsum("rok,rk->ro", self.wout[r0:r1],
                                      aug[r0:r1])
        return out

    def exchange(self, x, gv, model_gv=None):
        """Standardize, advance, read out, unstandardize, scatter, clamp.
        Returns (x, atmo, logp, precip_t)."""
        s = self.stz
        u = (gv[self.idx] - s["in_mean"]) / s["in_std"]
        mstd = None if model_gv is None else \
            (model_gv[self.tidx] - s["out_mean"]) / s["out_std"]
        x = self.advance(x, u)
        out = self.readout(x, mstd) * s["out_std"] + s["out_mean"]
        atmo, logp, pr = scatter_outputs(self.L, out)
        atmo = torch.cat([atmo[:3], torch.clamp(atmo[3:], min=QMIN)])
        pr = torch.clamp(pr, 0.0, self.pr_cap)
        return x, atmo, logp, pr


class ReferenceHybrid:
    """The plain single-member hybrid (or ML-only) step of a
    configuration, float64 on `device`."""

    def __init__(self, cfg: dict, bindir: str, w: dict, stz: dict, device):
        m, r = cfg["model"], cfg["reservoir"]
        self.cfg = cfg
        self.ml_only = bool(r["ml_only"])
        self.device = torch.device(device)
        self.L = layout(cfg)
        self.hours = m["window_hours"]
        self.esn = ReferenceEsn(w, stz, self.L, r["precip_epsilon"],
                                r["precip_cap_mm"])
        self.tables = build_tables(m["ntrun"], m["ix"], m["il"])
        if self.ml_only:
            self.sp = None
            self.clim = build_climatology(bindir, self.tables.gcos,
                                          self.tables.radang)
        else:
            self.sp = Speedy(model_config(cfg), bindir, device=self.device)
            self.clim = self.sp.clim
        self.physics = bool(m["physics"])
        self.activity = None

    def _dev(self, a):
        return torch.as_tensor(np.asarray(a), dtype=F64, device=self.device)

    def boundary(self, date: ModelDate):
        """(ss, ti): the SST and TISR sections the reservoirs read."""
        sst, tisr = boundary_host(self.clim, self.tables, date,
                                  self.cfg["model"]["ix"])
        # the supervector carries them in float32
        ss = torch.clamp(self._dev(np.float32(sst)), min=SST_MIN)
        ti = torch.clamp(self._dev(np.float32(tisr)), min=0.0)
        return sst, ss, ti

    def window(self, gs: GridState, date: ModelDate, sst):
        """The SPEEDY window from `gs` at `date` under a fresh coupler state
        (climatology, or `sst` where it lies within 6 K of it): stepone,
        then leapfrog steps with physics, precipitation summed. Returns
        (GridState, precip_mm, safe). With physics, `self.activity` holds
        the shares of grid columns (%) in which convection and large-scale
        condensation rained at some step of the window."""
        sp = self.sp
        sp.coupler = init_coupler_state(sp.clim, date, sst_hybrid=sst)
        sp.date = date
        surf, forcing = sp.surf_forcing(date)
        dy = sp.dy
        cfg = dy.config
        nst = self.hours * cfg.nsteps // 24
        state, safe = inject(dy, gs)
        if not self.physics:
            state = dy.step(state, forcing, 0, 0, "half")
            state = dy.step(state, forcing, 0, 1, "delt")
            for _ in range(nst - 1):
                state = dy.step(state, forcing, 1, 1, "delt2")
            return (extract(dy, state), torch.zeros_like(gs.logp), safe)
        phys = sp.phys
        mm_per_step = cfg.delt / 1000.0
        rad = init_rad_carry(cfg.kx, cfg.il, cfg.ix, dy.dtype, dy.device)
        state, (rad, fx) = dy.step(state, forcing, 0, 0, "half",
                                   phys_hook(phys, surf, rad, True))
        state, (rad, fx) = dy.step(state, forcing, 0, 1, "delt",
                                   phys_hook(phys, surf, rad, True))
        precip = (fx.precnv + fx.precls) * mm_per_step
        cnv, lsc = fx.precnv > 0, fx.precls > 0
        for j in range(1, nst):
            lradsw = (j % cfg.nstrad) == 0
            state, (rad, fx) = dy.step(state, forcing, 1, 1, "delt2",
                                       phys_hook(phys, surf, rad, lradsw))
            precip = precip + (fx.precnv + fx.precls) * mm_per_step
            cnv, lsc = cnv | (fx.precnv > 0), lsc | (fx.precls > 0)
        self.activity = {
            "convection_pct": 100.0 * float(cnv.double().mean()),
            "condensation_pct": 100.0 * float(lsc.double().mean())}
        return extract(dy, state), precip, safe

    def hybrid_step(self, x, atmo, logp, pr, date: ModelDate):
        """One member's hybrid step from (x, atmo, logp, precip_t) at
        `date`. Returns (x, atmo, logp, precip_t, safe)."""
        x, atmo, logp, pr = (self._dev(t) if not torch.is_tensor(t) else
                             t.to(self.device, F64)
                             for t in (x, atmo, logp, pr))
        sst, ss, ti = self.boundary(date)
        gv = pack_global(self.L, atmo, logp, pr, ss, ti)
        gs = GridState(t=atmo[0], u=atmo[1], v=atmo[2],
                       q=torch.clamp(atmo[3], min=0.0), logp=logp)
        fgs, precip_mm, safe = self.window(gs, date, sst)
        f_atmo = torch.stack([fgs.t, fgs.u, fgs.v,
                              torch.clamp(fgs.q, min=QMIN)])
        f_pr = torch.log1p(torch.clamp(precip_mm, min=0.0) / self.esn.eps)
        model_gv = pack_global(self.L, f_atmo, fgs.logp, f_pr, ss, ti)
        return (*self.esn.exchange(x, gv, model_gv), bool(safe))

    def ml_step(self, x, atmo, logp, pr, date: ModelDate, anom=None):
        """One ML-only step of the chunked loop: the SST section is the
        climatology plus the fed-back anomaly, clamped to 200..306 K, then
        to SST_MIN. Returns (x, atmo, logp, precip_t, sane)."""
        x, atmo, logp, pr = (t.to(self.device, F64)
                             for t in (x, atmo, logp, pr))
        sst, _, ti = self.boundary(date)
        s = self._dev(sst)
        if anom is not None:
            s = s + anom.to(self.device, F64)
        ss = torch.clamp(torch.clamp(s, 200.0, 306.0), min=SST_MIN)
        ss = ss.float().double()
        gv = pack_global(self.L, atmo, logp, pr, ss, ti)
        x, atmo, logp, pr = self.esn.exchange(x, gv)
        sane = bool(torch.isfinite(atmo).all() and torch.isfinite(logp).all()
                    and atmo[0].min() > 150.0 and atmo[0].max() < 400.0
                    and atmo[1:3].abs().max() < 500.0)
        return x, atmo, logp, pr, sane
