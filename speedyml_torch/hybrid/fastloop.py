"""Device-resident K-step hybrid prediction loop (PyTorch port of
speedyml/hybrid/fastloop.py).

The per-step HybridRunner touches the host every hybrid step: it reads the
safety flag (one device sync), rebuilds the boundary state and uploads it,
and keeps or writes the step's fields. This module runs K steps (one ocean
"week" by default) as ONE chunk whose body never touches the host: every
launch of the K windows and reservoir steps is queued without waiting for a
result, the K outputs go into preallocated (K, ...) stacks, and the safety
flags are read once, after the chunk. It is the loop-level analog of the
reference's per-step file/MPI cycle (src/mpires.f90:218-804). On the card
each step's window is one replay of a captured CUDA graph (_WindowGraph).

  for each chunk of K steps:                       [host]
    K steps, no host sync:                         [device]
      SST = clim(k) + anomaly -> pack gv
      SPEEDY window (full physics; a graph replay) <- surf/qcorh on device
      pack model_gv -> reservoir advance+readout -> scatter
      accumulate week-sum supervector + safety flags
    stage the next chunk's boundary fields (host), read the K flags
    weekly slab-ocean step (device) -> new SST anomaly   [one small fetch]
    start this chunk's trajectory download on a side stream; a worker
    thread writes it out while the next chunk runs

Everything date-dependent but SST-independent (climatology interpolation,
solar/ozone tables, albedos, diurnal TISR, tcorh) is precomputed on the host
per chunk and uploaded in one copy per shape; an ML-only chunk, which runs
no window, builds only the two fields its step reads (the ice-blended SST
climatology and the TISR). The two SST-dependent pieces
of the boundary condition, the hybrid-SST gate + ice blending
(cpl_sea.f90:38-44) and the humidity forcing correction qcorh
(ini_fordate.f90), are computed on the device from the fed-back SST.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ..core.calendar import ModelDate
from ..core.constants import DYN, PHYS
from ..coupler.daily import clim_sst_am, fordate, init_coupler_state
from ..device import Download
from ..domain.decomposition import pack_global
from ..dynamics.core import Forcing
from ..io.checkpoint import save_prediction
from ..physics.constants import PP
from ..physics.driver import SurfaceDailyState
from ..physics.radiation import diurnal_tisr
from ..reservoir.slab import compose_week_inputs
from ..utils import diag
from .experiment import QMIN, SST_MIN
from .forecast import SpeedyForecaster
from .state_io import GridState


class StepFields(NamedTuple):
    """Per-step host-precomputed boundary fields, stacked (K, ...). The
    ML-only step reads the first two; the rest feed only the window and are
    None on an ML-only model."""

    sst_clim: np.ndarray     # ice-blended climatological SST (reservoir input)
    tisr: np.ndarray
    sstcl: np.ndarray = None   # adjusted open-water SST clim (gate reference)
    sicecl: np.ndarray = None
    ticecl: np.ndarray = None
    stl_am: np.ndarray = None
    snowd_am: np.ndarray = None
    soilw_am: np.ndarray = None
    alb_l: np.ndarray = None
    alb_s: np.ndarray = None
    albsfc: np.ndarray = None
    snowc: np.ndarray = None
    fsol: np.ndarray = None    # (K, il) zonal
    ozupp: np.ndarray = None
    ozone: np.ndarray = None
    zenit: np.ndarray = None
    stratz: np.ndarray = None


# the fields the ML-only step reads (run_chunk); the window reads the rest
ML_FIELDS = ("sst_clim", "tisr")
WINDOW_FIELDS = tuple(f for f in StepFields._fields if f not in ML_FIELDS)


class ChunkResult(NamedTuple):
    """What one chunk leaves on the device: the end-of-chunk carry and the
    K-step stacks."""

    x: torch.Tensor
    atmo: torch.Tensor
    logp: torch.Tensor
    pr: torch.Tensor
    gv_sum: torch.Tensor     # sum of the K packed supervectors
    gv_last: torch.Tensor    # the last step's packed supervector
    atmo_st: torch.Tensor    # (K, 4, kx, il, ix)
    logp_st: torch.Tensor    # (K, il, ix)
    pr_st: torch.Tensor      # (K, il, ix) transformed log-precip
    sst_st: torch.Tensor     # (K, il, ix)
    safe_st: torch.Tensor    # (K,) bool


def _n_fields(xs: StepFields) -> int:
    """The number of fields built a step (the fastloop.fields span's count)."""
    return sum(f is not None for f in xs)


def _ml_sane(atmo2, logp2):
    """Default ml_only safety: finite state inside physical bounds. The
    closed-loop reservoir has no window model to flag divergence, so the
    gate checks the readout's own output (invars-gate analog)."""
    ok = torch.isfinite(atmo2).all() & torch.isfinite(logp2).all()
    return (ok & (atmo2[0].min() > 150.0) & (atmo2[0].max() < 400.0)
            & (atmo2[1:3].abs().max() < 500.0))


def _qsat_dev(ta, pres_norm):
    """Device twin of coupler.daily._qsat_np (identical constants)."""
    e0, c1, c2 = 6.108e-3, 17.269, 21.875
    t0, t1, t2 = 273.16, 35.86, 7.66
    es = torch.where(ta >= t0,
                     e0 * torch.exp(c1 * (ta - t0) / (ta - t1)),
                     e0 * torch.exp(c2 * (ta - t0) / (ta - t2)))
    return 622.0 * es / (pres_norm - 0.378 * es)


class _WindowGraph:
    """One CUDA graph of ScanHybridRunner._window_eager: the window's ~54k
    launches of a step captured once and replayed every step, in place of
    the host's eager dispatch. It reads static input buffers that each
    replay fills by copy (atmo, logp, sst, ss, ti and the step's window
    fields, so no step's own address is captured) and writes static output
    buffers (the packed model supervector and the safety flag) that the
    next replay overwrites. Its memory is a pool of its own, the window's
    working set."""

    def __init__(self, body, args, key):
        self.key = key
        self.inputs = [a.clone() for a in args]
        stream = torch.cuda.Stream(args[0].device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            # one eager pass first, so that lazy set-up (library handles,
            # workspaces, FFT plans) is done outside the capture
            body(*self._call())
            self.graph = torch.cuda.CUDAGraph()
            # thread_local: another thread's work (the writer's flush)
            # cannot break the capture
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.outputs = body(*self._call())
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)

    def _call(self):
        atmo, logp, sst, ss, ti, *fields = self.inputs
        xs = StepFields(sst_clim=None, tisr=None,
                        **{n: f[None] for n, f in zip(WINDOW_FIELDS, fields)})
        return atmo, logp, sst, ss, ti, xs, 0

    def replay(self, args):
        """The outputs of the window on `args`, on the current stream."""
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        self.graph.replay()
        return self.outputs


class ScanHybridRunner:
    """Chunked device-resident prediction loop; drop-in alternative to
    HybridRunner.run for production-length integrations. It runs on the
    device of the model's weights.

    hm: trained HybridModel; speedy: full model (provides dycore tables,
    climatology and the window); physics: window physics flag; chunk: steps
    between two reads of the safety flags (forced to ocean.steps_per_week
    when an ocean is coupled).
    """

    def __init__(self, hm, speedy=None, physics: bool = True,
                 chunk: int = 28):
        if speedy is None and not hm.ml_only:
            raise ValueError("the hybrid configuration needs the SPEEDY "
                             "window model")
        self.hm = hm
        self.speedy = speedy
        self.physics = physics
        self.chunk = chunk
        self.device = hm.params.win.device
        # ml_only safety predicate (atmo2, logp2, xs) -> 0-d bool tensor,
        # evaluated on the POST-step state; xs is step k's StepFields, whose
        # window-only fields are None on an ml_only model. None selects the
        # default sanity gate (finite + physical T/wind bounds): the ml_only
        # analog of the window path's safety flag (the reference's invars
        # gate, mpires.f90:744); tests override it.
        self._ml_safe_fn = None
        # optional (il, ix) output-side precip debias (sigma^2/2 of the
        # readout's log1p residual; see HybridRunner.precip_debias)
        self.precip_debias = None
        self._side = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        # the window's CUDA graph (on the card; captured at the first
        # window) and the number of captures made
        self._graph = None
        self._captures = 0
        if speedy is None:
            self.fc = None
            self.dtype = torch.float32
            return
        self.fc = SpeedyForecaster(speedy, hours=hm.rcfg.timestep,
                                   physics=physics)
        # boundary fields ride the model dtype (f64 in the CPU tests), so
        # that the chunked loop reproduces the per-step runner
        dy = speedy.dy
        self.dtype = dy.dtype
        # constant forcing pieces (ini_fordate.f90): tcorh is a pure
        # function of the truncated orography
        gamlat = DYN.gamma / (1000.0 * PHYS.grav)
        corh_t = gamlat * np.asarray(dy.phis0_grid, np.float64)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float64),
                                   dtype=self.dtype, device=self.device)

        self._corh_t = dev(corh_t)
        self._tcorh = dev(dy.T.host_grid_to_spec(corh_t))
        self._pexp = 1.0 / (PP.rd * gamlat)
        self._fmask_l = dev(speedy.clim.fmask_l)
        self._fmask_s = dev(speedy.clim.fmask_s)

    # ------------------------------------------------------------------
    def _host_step_fields(self, date: ModelDate) -> dict:
        """The SST-independent boundary fields the step reads, for one step
        (host numpy): on an ML-only model sst_clim and tisr alone, on a
        hybrid model all of StepFields. Overridable (tests stub this the way
        they stub HybridRunner._sst)."""
        sp = self.speedy
        tisr = diurnal_tisr(date.tyear, date.ihour, sp.dy.tables.gsin,
                            sp.dy.tables.gcos, sp.config.ix)
        if self.hm.ml_only:
            return dict(sst_clim=clim_sst_am(sp.clim, date), tisr=tisr)
        cs = init_coupler_state(sp.clim, date)
        with diag.span("fastloop.fields.host.fordate"):
            rad, _, _ = fordate(sp.dy, sp.clim, cs, date)
        return dict(sst_clim=cs.sst_am, sstcl=cs.sstcl_ob, sicecl=cs.sice_am,
                    ticecl=cs.tice_am, stl_am=cs.stl_am,
                    snowd_am=cs.snowd_am, soilw_am=cs.soilw_am, tisr=tisr,
                    alb_l=rad["alb_l"], alb_s=rad["alb_s"],
                    albsfc=rad["albsfc"], snowc=rad["snowc"],
                    fsol=rad["fsol"], ozupp=rad["ozupp"],
                    ozone=rad["ozone"], zenit=rad["zenit"],
                    stratz=rad["stratz"])

    def _precompute(self, date0: ModelDate, K: int) -> StepFields:
        """The chunk's fields stacked (K, ...) in float64: on an ML-only
        model only ML_FIELDS (the rest stay None), on a hybrid model all,
        a field that a stub leaves out as zeros."""
        d = ModelDate(date0.iyear, date0.imonth, date0.iday, date0.ihour)
        L = self.hm.layout
        keys = ML_FIELDS if self.hm.ml_only else StepFields._fields
        pad = np.zeros((L.il, L.ix))
        rows = []
        with diag.span("fastloop.fields.host"):
            for _ in range(K):
                r = self._host_step_fields(d)
                rows.append([r.get(k, pad) for k in keys])
                d.advance_hours(self.hm.rcfg.timestep)
            return StepFields(**{k: np.stack([np.asarray(r[i], np.float64)
                                              for r in rows])
                                 for i, k in enumerate(keys)})

    def _upload_fields(self, xs: StepFields) -> StepFields:
        """The chunk's boundary fields that are not None to the device,
        pinned to the model dtype: fields of one shape are stacked into one
        pinned host buffer and go up in ONE non-blocking copy (on a hybrid
        model two in all, the (K, il, ix) and the zonal (K, il) fields; on
        an ML-only model one), then are sliced on the device. A
        non-blocking copy from pinned memory does not make the host wait
        for the chunk that is still running."""
        by_shape = {}
        for k, v in xs._asdict().items():
            if v is not None:
                by_shape.setdefault(v.shape, []).append(k)
        out = {}
        with diag.span("fastloop.fields.upload"):
            for shape, keys in by_shape.items():
                host = torch.empty((len(keys),) + shape, dtype=self.dtype,
                                   pin_memory=self.device.type == "cuda")
                for i, k in enumerate(keys):
                    host[i].copy_(torch.from_numpy(getattr(xs, k)))
                dev = host.to(self.device, non_blocking=True)
                for i, k in enumerate(keys):
                    out[k] = dev[i]
        return StepFields(**out)

    # ------------------------------------------------------------------
    def _qcorh_dev(self, tsfc):
        """fordate's humidity forcing correction from the (SST-dependent)
        surface temperature, on the device (ini_fordate.f90:fordate)."""
        tref = tsfc + self._corh_t
        psfc = (tsfc / tref) ** self._pexp
        corh_q = DYN.refrh1 * (_qsat_dev(tref, 1.0) - _qsat_dev(tsfc, psfc))
        return self.speedy.dy.T.grid_to_spec(corh_q)

    def _model_gv(self, atmo, logp, sst, ss, ti, xs: StepFields, k: int):
        """The window from (atmo, logp) under step k's boundary state with
        the fed-back SST, packed as the model supervector, and its safety
        flag. Nothing here reads a value back to the host.

        On the card this replays the window's CUDA graph, captured at the
        first call and again when the shapes change; the two tensors it
        returns are then the graph's output buffers, which the next call
        overwrites: read them in stream order before it, and clone what
        must outlive the step. Elsewhere it runs the window eagerly."""
        if self.device.type != "cuda":
            return self._window_eager(atmo, logp, sst, ss, ti, xs, k)
        args = (atmo, logp, sst, ss, ti) + tuple(
            getattr(xs, f)[k] for f in WINDOW_FIELDS)
        key = (tuple(a.shape for a in args), self.dtype)
        if self._graph is None or self._graph.key != key:
            self._graph = None          # its pool goes before the next one
            self._graph = _WindowGraph(self._window_eager, args, key)
            self._captures += 1
        diag.count("graphed", 1)
        return self._graph.replay(args)

    def _window_eager(self, atmo, logp, sst, ss, ti, xs: StepFields, k: int):
        """_model_gv's window, launched op by op (what the graph
        captures)."""
        # the hybrid-SST gate + ice blending of ini_sea (cpl_sea.f90:38-48,
        # coupler.daily.init_coupler_state)
        sstcl, sicecl, ticecl = xs.sstcl[k], xs.sicecl[k], xs.ticecl[k]
        sst_am = torch.where(sstcl - sst < 6.0, sst, sstcl)
        sst_am = sst_am + sicecl * (ticecl - sst_am)
        surf = SurfaceDailyState(
            stl_am=xs.stl_am[k], snowd_am=xs.snowd_am[k],
            soilw_am=xs.soilw_am[k], sst_am=sst_am, sice_am=sicecl,
            tice_am=ticecl, alb_l=xs.alb_l[k], alb_s=xs.alb_s[k],
            albsfc=xs.albsfc[k], snowc=xs.snowc[k], fsol=xs.fsol[k],
            ozupp=xs.ozupp[k], ozone=xs.ozone[k], zenit=xs.zenit[k],
            stratz=xs.stratz[k])
        tsfc = self._fmask_l * xs.stl_am[k] + self._fmask_s * sst_am
        forcing = Forcing(tcorh=self._tcorh, qcorh=self._qcorh_dev(tsfc))
        gs = GridState(t=atmo[0], u=atmo[1], v=atmo[2],
                       q=torch.clamp(atmo[3], min=0.0), logp=logp)
        res = self.fc.window(gs, surf, forcing)
        f32 = torch.float32
        f_atmo = torch.stack([res.gs.t, res.gs.u, res.gs.v,
                              torch.clamp(res.gs.q, min=QMIN)]).to(f32)
        f_pr = torch.log1p(torch.clamp(res.precip_mm, min=0.0)
                           / self.hm.rcfg.precip_epsilon).to(f32)
        return pack_global(self.hm.layout, f_atmo, res.gs.logp.to(f32), f_pr,
                           ss, ti), res.safe

    def run_chunk(self, x, atmo, logp, pr, anom, xs: StepFields,
                  K: int) -> ChunkResult:
        """K hybrid steps from the carry (x, atmo, logp, pr) under the SST
        anomaly `anom` and the uploaded boundary fields `xs`, all tensors on
        the device. The body makes no host sync: it reads no value back,
        uploads nothing and branches on no tensor; the caller reads
        `safe_st` afterwards, once."""
        hm = self.hm
        L = hm.layout
        dev = self.device
        f32 = torch.float32
        atmo_st = torch.empty((K,) + tuple(atmo.shape), dtype=f32, device=dev)
        logp_st = torch.empty((K, L.il, L.ix), dtype=f32, device=dev)
        pr_st = torch.empty((K, L.il, L.ix), dtype=f32, device=dev)
        sst_st = torch.empty((K, L.il, L.ix), dtype=self.dtype, device=dev)
        safe_st = torch.empty((K,), dtype=torch.bool, device=dev)
        gv_sum = torch.zeros((L.gv_len,), dtype=f32, device=dev)
        gv = gv_sum
        captures = self._captures
        for k in range(K):
            # sst rides the model dtype down the WINDOW path; the packed
            # supervector is always f32 (the HybridRunner.pack contract)
            sst = torch.clamp(xs.sst_clim[k] + anom, 200.0, 306.0)
            ss = torch.clamp(sst.to(f32), min=SST_MIN)
            ti = torch.clamp(xs.tisr[k].to(f32), min=0.0)
            gv = pack_global(L, atmo, logp, pr, ss, ti)
            gv_sum = gv_sum + gv
            if hm.ml_only:
                model_gv = None
            else:
                with diag.span("fastloop.window", device=True):
                    model_gv, safe = self._model_gv(atmo, logp, sst, ss, ti,
                                                    xs, k)
            x, atmo, logp, pr = hm.step(x, gv, model_gv)
            if hm.ml_only:
                safe = _ml_sane(atmo, logp) if self._ml_safe_fn is None \
                    else self._ml_safe_fn(atmo, logp, StepFields(
                        *(None if f is None else f[k] for f in xs)))
            atmo_st[k] = atmo
            logp_st[k] = logp
            pr_st[k] = pr
            sst_st[k] = sst
            safe_st[k] = safe
        if self._captures > captures:
            diag.count("captures", self._captures - captures)
        return ChunkResult(x, atmo, logp, pr, gv_sum, gv, atmo_st, logp_st,
                           pr_st, sst_st, safe_st)

    # ------------------------------------------------------------------
    @diag.loop("fastloop")
    def run(self, x, atmo0, logp0, precip_t0, date: ModelDate, n_steps: int,
            ocean=None, x_ocean=None, sst_anom0=None, writer=None,
            checkpoint_path=None, checkpoint_every: int = 0,
            verbose: int = 0, deadline=None, fetch_traj: bool = True,
            stream: bool = False, step0: int = 0) -> dict:
        """HybridRunner.run-compatible chunked loop.

        checkpoint_every is in STEPS but rounds to chunk boundaries.
        fetch_traj=False skips the per-chunk trajectory download entirely
        (no writer output either); stream=True downloads each chunk, feeds
        the writer, accumulates running summary stats (out["summary"]) and
        DROPS the host copy, so that the host's memory does not grow with
        the run's length (a kept multi-year trajectory is tens of GB).
        step0: absolute step offset added to saved checkpoint steps, so a
        resumed run's checkpoints stay absolute and a second resume
        integrates the right remaining length.
        Returns the HybridRunner.run result dict with the trajectory as host
        numpy (atmo, logp, precip_mm, sst), the carry (x, atmo_end,
        logp_end, precip_t, x_ocean) as tensors, sst_anom, and chunk_ms (on
        the card: each chunk's time by CUDA events); n_steps is floored to a
        multiple of the chunk size. out["steps_done"] is authoritative; on a
        mid-chunk safety abort the trajectory, steps_done and date are
        truncated AT the abort step, atmo_last/logp_last are the last SAFE
        state (from the trajectory stacks), and the reservoir states x and
        x_ocean are None (they only exist at chunk boundaries): post-abort
        state never leaks out (mpires.f90:744 aborts atomically).
        """
        hm = self.hm
        L = hm.layout
        dev = self.device
        f32 = torch.float32
        K = self.chunk if ocean is None else ocean.steps_per_week
        n_chunks = n_steps // K
        if n_chunks < 1:
            raise ValueError(f"n_steps {n_steps} < chunk {K}")
        date = ModelDate(date.iyear, date.imonth, date.iday, date.ihour)
        date_start = ModelDate(date.iyear, date.imonth, date.iday,
                               date.ihour)
        x = torch.as_tensor(x, dtype=f32, device=dev)
        atmo = torch.as_tensor(atmo0, dtype=f32, device=dev)
        logp = torch.as_tensor(logp0, dtype=f32, device=dev)
        pr = torch.zeros((L.il, L.ix), dtype=f32, device=dev) \
            if precip_t0 is None else \
            torch.as_tensor(precip_t0, dtype=f32, device=dev)
        anom = torch.zeros((L.il, L.ix), dtype=self.dtype, device=dev) \
            if sst_anom0 is None else \
            torch.as_tensor(sst_anom0, dtype=self.dtype, device=dev)
        if ocean is not None and x_ocean is None:
            x_ocean = ocean.zero_state()

        traj = {k: [] for k in ("atmo", "logp", "precip_mm", "sst")}
        keep_traj = fetch_traj and not stream
        fetch = fetch_traj or stream
        summary = {"steps": 0, "sst_first": None, "sst_last": None}
        last_state = {}         # streamed: the last flushed step's fields
        eps = hm.rcfg.precip_epsilon
        this_run = diag.current_run()

        def acc_summary(a, p_mm, ss):
            for name, arr in (("t", a[:, 0]), ("u", a[:, 1]),
                              ("q", a[:, 3]), ("sst", ss),
                              ("precip_mm", p_mm)):
                summary[f"{name}_min"] = min(
                    summary.get(f"{name}_min", np.inf), float(arr.min()))
                summary[f"{name}_max"] = max(
                    summary.get(f"{name}_max", -np.inf), float(arr.max()))
            if summary["sst_first"] is None:
                summary["sst_first"] = ss[0].copy()
            summary["sst_last"] = ss[-1].copy()
            summary["steps"] += len(a)

        def flush(dl: Download, ci: int):
            with diag.span("fastloop.flush", index=ci, run=this_run):
                a, lp, p_log, ss = dl.arrays()
                if not len(a):
                    return
                if self.precip_debias is not None:
                    p_log = np.maximum(p_log - self.precip_debias, 0.0)
                p_mm = eps * np.expm1(np.maximum(p_log, 0.0))
                if writer is not None:
                    for j in range(len(a)):
                        writer.append(a[j], lp[j], precip_mm=p_mm[j],
                                      sst=ss[j])
                acc_summary(a, p_mm, ss)
                if keep_traj:
                    for k, v in (("atmo", a), ("logp", lp),
                                 ("precip_mm", p_mm), ("sst", ss)):
                        traj[k].append(np.array(v))
                else:               # streamed: drop all but the tail step
                    last_state.update(atmo=a[-1].copy(), logp=lp[-1].copy())

        steps_done = 0
        aborted = False
        pending = None          # the previous chunk's download
        chunk_ms = []
        t_run0 = t_prev = time.time()
        # single-worker pool: the writer appends run in order on the
        # trajectory as it arrives, beside the next chunk's launches
        pool = ThreadPoolExecutor(max_workers=1)
        flush_fut = None
        with diag.span("fastloop.fields", index=0) as fields:
            xs_host = self._precompute(date, K)
            xs_dev = self._upload_fields(xs_host)
            fields.count("fields", _n_fields(xs_host))
        try:
            for ci in range(n_chunks):
                if pending is not None:
                    if flush_fut is not None:
                        with diag.span("fastloop.flush_wait", index=ci):
                            flush_fut.result()
                    flush_fut = pool.submit(flush, pending, ci - 1)
                    pending = None
                with diag.span("fastloop.chunk", index=ci) as chunk:
                    if self._side is not None:
                        ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                                    for _ in range(2))
                        ev0.record()
                    res = self.run_chunk(x, atmo, logp, pr, anom, xs_dev, K)
                    if self._side is not None:
                        ev1.record()
                        chunk.timed_by(ev0, ev1)
                # while the device works through the chunk: stage the next
                # chunk's boundary fields
                clim_last = xs_host.sst_clim[K - 1]
                date_next = ModelDate(date.iyear, date.imonth, date.iday,
                                      date.ihour)
                for _ in range(K):
                    date_next.advance_hours(hm.rcfg.timestep)
                if ci + 1 < n_chunks:
                    with diag.span("fastloop.fields",
                                   index=ci + 1) as fields:
                        xs_host = self._precompute(date_next, K)
                        xs_dev = self._upload_fields(xs_host)
                        fields.count("fields", _n_fields(xs_host))
                # the chunk's one read of the device: K safety flags
                with diag.span("fastloop.flag_wait", index=ci):
                    safe = res.safe_st.cpu().numpy()
                if self._side is not None:
                    chunk_ms.append(ev0.elapsed_time(ev1))
                upto = int(np.argmax(~safe)) if (~safe).any() else K
                aborted = upto < K
                chunk.count("steps", upto)
                if ocean is not None and not aborted:
                    with diag.span("fastloop.ocean", index=ci) as osp:
                        with diag.span("fastloop.ocean.step", device=True):
                            gv_week = compose_week_inputs(res.gv_last,
                                                          res.gv_sum, K, L)
                            x_ocean, sst_core = ocean.step(x_ocean, gv_week)
                        # the host's blend reads the prediction back: the
                        # loop's one sync besides the flags
                        with diag.span("fastloop.ocean.compose"):
                            grid = ocean.compose_sst(sst_core, clim_last, L)
                            anom = torch.as_tensor(grid - clim_last,
                                                   dtype=self.dtype,
                                                   device=dev)
                        osp.count("active", int(ocean.active.sum()))
                x, atmo, logp, pr = res.x, res.atmo, res.logp, res.pr
                date = date_next
                steps_done += upto
                if fetch:
                    pending = Download(
                        [res.atmo_st, res.logp_st, res.pr_st, res.sst_st],
                        upto, self._side)
                if aborted:
                    break
                if checkpoint_path and checkpoint_every and \
                        ((ci + 1) * K) % max(checkpoint_every // K * K,
                                             K) == 0:
                    extra = {"sst_anom": anom.double()}
                    if ocean is not None:
                        extra["n_accum"] = 0
                        extra["x_ocean"] = x_ocean
                    # the step is ABSOLUTE (step0 + progress): a checkpoint
                    # written by a resumed run must not restart the count
                    save_prediction(checkpoint_path, x, atmo, logp, pr, date,
                                    step=step0 + (ci + 1) * K, extra=extra)
                if verbose and ((ci + 1) * K) % verbose < K:
                    now = time.time()
                    print(f"  fast-loop chunk {ci + 1}/{n_chunks} "
                          f"({steps_done} steps, "
                          f"{now - t_prev:.1f}s since last print, "
                          f"{(now - t_run0) / steps_done:.2f}s/step avg) "
                          f"[{time.strftime('%H:%M:%S')}]", flush=True)
                    t_prev = now
                if deadline is not None and time.time() > deadline:
                    break
            # after the last chunk (ci): its flush and the one before
            if flush_fut is not None:
                with diag.span("fastloop.flush_wait", index=ci + 1):
                    flush_fut.result()
            if pending is not None:
                flush(pending, ci)
        finally:
            pool.shutdown(wait=True)
        out = {k: (np.concatenate(v) if v else None)
               for k, v in traj.items()}
        out.update(x=x, x_ocean=x_ocean, atmo_end=atmo, logp_end=logp,
                   precip_t=pr, date=date, aborted=aborted,
                   sst_anom=anom.cpu().numpy(), steps_done=steps_done,
                   chunk_ms=chunk_ms)
        if aborted:
            # abort atomicity: the carry above is END-of-chunk state that
            # ran through the unsafe window. Hand back the last SAFE state
            # from the trajectory stacks instead, truncate the date to the
            # abort step, and drop every carried state.
            out.update(x=None, x_ocean=None, atmo_end=None, logp_end=None,
                       precip_t=None)
            date_ab = date_start
            for _ in range(steps_done):
                date_ab.advance_hours(hm.rcfg.timestep)
            out["date"] = date_ab
            if keep_traj and steps_done:
                out["atmo_last"] = out["atmo"][-1]
                out["logp_last"] = out["logp"][-1]
            elif last_state:
                out["atmo_last"] = last_state["atmo"]
                out["logp_last"] = last_state["logp"]
        if stream:
            s = dict(summary)
            if s["sst_first"] is not None:
                s["sst_drift_K"] = float(
                    np.abs(s["sst_last"] - s["sst_first"]).max())
                s["sst_drift_mean_K"] = float(
                    (s["sst_last"] - s["sst_first"]).mean())
            s.pop("sst_first", None)
            s.pop("sst_last", None)
            out["summary"] = s
        return out
