"""The coupled loop: one trajectory of the hybrid coupled to the slab ocean
through `ScanHybridRunner.run(ocean=..., writer=..., stream=True)`, in
chunks of one ocean week. After each chunk the ocean steps once on the
week's supervectors and the host blends its prediction into the SST
anomaly that the next chunk's windows and reservoirs read; a
`ForecastWriter` writes every 6-h step to the run's temporary directory.
Set-up ends with one warm-up week; the window carries on from its carry
(reservoir states, fields, the ocean's state and the anomaly it fed back),
in one call whose deadline is the window's close.

Traffic keys: chunk (the steps of an ocean week, which the configuration's
timestep_slab fixes; checked), check_chunks (chunks the check keeps besides
the first), check_steps (steps of each kept chunk the check runs through
the window), trace_chunks (chunks a traced slice runs: the last one is
read, the ones before it stage its boundary fields and its writer).
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from .. import checks, inputs, ocean_inputs, program
from ..pace import Pace
from ..sampling import Sampler
from ..trace import read_slices
from ..work import advance, readout, spectral
from .ensemble import YEAR_HOURS, _date_after
from reference.coupled import ReferenceCoupled

# an upper bound on the chunks of a window; the deadline ends the run
MAX_CHUNKS = 10 ** 6


class _Slice:
    """The deadline of a traced slice of run(): run() tests `time.time() >
    deadline` after each chunk, before the next one opens its spans, which
    Python answers by this object's __lt__. After the first `n - 1`
    chunks, which stage the read chunk's boundary fields and the writer, it
    starts the reading; after the n-th, the read one, it has passed."""

    def __init__(self, n: int, start):
        self.n = n
        self.start = start
        self.done = 0

    def __lt__(self, now):
        self.done += 1
        if self.done == self.n - 1:
            self.start()
        return self.done >= self.n


def ocean_model(cfg: dict, hm, ow: dict, wout_dtype=None):
    """The program's OceanModel over the benchmark's ocean weights `ow`,
    through build_ocean_layout on the hybrid's layout."""
    from speedyml_torch import ReservoirConfig
    from speedyml_torch.domain.standardize import Standardizer
    from speedyml_torch.reservoir.esn import EsnParams, cast_wout
    from speedyml_torch.reservoir.slab import OceanModel, build_ocean_layout

    o = cfg["ocean"]
    ol = build_ocean_layout(hm.layout)
    R, n, deg = ow["a_val"].shape
    dev = ow["a_val"].device
    shifts = torch.as_tensor(ow["shifts"], dtype=torch.int64, device=dev)
    a_idx = ((torch.arange(n, device=dev)[:, None] + shifts[None]) % n)[
        None].expand(R, n, deg)
    params = EsnParams(a_idx=a_idx, a_val=ow["a_val"], win=ow["win"],
                       wout=ow["wout"], node_map=ow["node_map"],
                       leakage=ow["leakage"], a_shift=tuple(ow["shifts"]))
    if wout_dtype is not None:
        params = cast_wout(params, wout_dtype)
    rcfg = ReservoirConfig(timestep=cfg["model"]["window_hours"],
                           timestep_slab=o["timestep_slab"],
                           slab_nodes=o["slab_nodes"], degree=deg,
                           slab_sigma=o["slab_sigma"],
                           slab_leakage=o["slab_leakage"],
                           slab_anom_clip=o["slab_anom_clip"])
    return OceanModel(ol=ol, params=params, stz=Standardizer(**ow["stz"]),
                      active=ow["active"], rcfg=rcfg)


def _record_samples(runner, ocean, sampler, K, n_steps):
    """Wrap runner.run_chunk and ocean.step: keep, of the kept chunks, the
    carry and the anomaly that enter the chunk, its stacks, the ocean's
    state that enters its weekly step and the anomaly fed back after it
    (the next chunk's input; the last chunk's is read from run()'s
    result), and every chunk's anomaly, for the reading beside activity.
    Returns (the chunks' anomalies, {chunk: kept sample} of the kept chunks
    still waiting for the anomaly fed back after them)."""
    orig_chunk, orig_step = runner.run_chunk, ocean.step
    count = [0, 0]
    anoms = []
    by_chunk = {}

    def run_chunk(x, atmo, logp, pr, anom, xs, K_):
        i = count[0]
        anoms.append(anom.clone())
        if i - 1 in by_chunk:
            by_chunk.pop(i - 1)["anom_out"] = anom.clone()
        slot = sampler.slot(i)
        if slot is not None:
            inp = [t.clone() for t in (x, atmo, logp, pr, anom)]
            steps = sorted(int(s) for s in sampler.rng.choice(
                K, size=min(n_steps, K), replace=False))
        res = orig_chunk(x, atmo, logp, pr, anom, xs, K_)
        if slot is not None:
            kept = dict(chunk=i, inputs=inp, result=res, steps=steps)
            sampler.kept[slot] = kept
            by_chunk[i] = kept
        count[0] = i + 1
        return res

    def step(x, gv_week):
        i = count[1]
        if i in by_chunk:
            by_chunk[i]["x_ocean"] = x.clone()
        count[1] = i + 1
        return orig_step(x, gv_week)

    runner.run_chunk = run_chunk
    ocean.step = step
    return anoms, by_chunk


def execute(run):
    from speedyml_torch.hybrid.fastloop import ScanHybridRunner
    from speedyml_torch.io.output import ForecastWriter

    cfg, tr, dev = run.cfg, run.traffic, run.device
    m = cfg["model"]
    hours = m["window_hours"]
    _, wout_dtype = program.variant_settings(run.variant)

    bindir = inputs.write_boundary(cfg, run.seed, run.tmp)
    start = inputs.Start(cfg, bindir, dev)
    w = inputs.make_weights(cfg, start.L, run.seed, dev)
    ow = ocean_inputs.make_ocean(cfg, start, bindir, run.seed, dev)
    sp = program.speedy(cfg, bindir, dev)
    hm = program.hybrid_model(cfg, sp, w, start.stz, wout_dtype)
    ocean = ocean_model(cfg, hm, ow, wout_dtype)
    K = ocean.steps_per_week
    if K != tr["chunk"]:
        raise ValueError(f"an ocean week is {K} steps, the traffic's chunk "
                         f"{tr['chunk']}")
    runner = ScanHybridRunner(hm, sp, physics=m["physics"], chunk=K)
    x0, n, k = w["x0"], w["win"].shape[1], w["wout"].shape[-1]
    del w

    def writer(name):
        return ForecastWriter(os.path.join(run.tmp, name), m["kx"], m["il"],
                              m["ix"], with_sst=True)

    # warm-up: one ocean week, writer and all; the window carries on from
    # its carry, so that its first chunk runs under a fed-back anomaly
    with writer("warmup.nc") as wr:
        warm = runner.run(x0, start.atmo, start.logp, start.pr, start.date,
                          K, ocean=ocean, x_ocean=ow["x0"], writer=wr,
                          stream=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run.values["setup_end"] = time.perf_counter()
    del x0, ow
    if warm["aborted"]:
        run.attempted, run.failed = K, 1
        run.numbers = {}
        return
    carry = (warm["x"], warm["atmo_end"], warm["logp_end"],
             warm["precip_t"])
    date0 = warm["date"]

    pace = Pace(dev.type == "cuda")
    runner.run_chunk = pace.wrap_step(runner.run_chunk)
    sampler = Sampler(run.seed, tr["check_chunks"])
    anoms, by_chunk = _record_samples(runner, ocean, sampler, K,
                                      tr["check_steps"])

    gc.collect()               # the set-up's garbage, not the window's
    pace.start()
    with writer("forecast.nc") as wr:
        t0 = time.perf_counter()
        out = runner.run(*carry, date0, K * MAX_CHUNKS, ocean=ocean,
                         x_ocean=warm["x_ocean"],
                         sst_anom0=warm["sst_anom"], writer=wr, stream=True,
                         deadline=time.time() + run.seconds)
        t1 = time.perf_counter()
    run.values["pace"] = pace.summary()
    steps = out["steps_done"]
    aborted = bool(out["aborted"])
    for i in list(by_chunk):            # the last chunk's fed-back anomaly
        by_chunk.pop(i)["anom_out"] = torch.as_tensor(out["sst_anom"])
    run.values["steps"] = steps
    run.values["step_s"] = (t1 - t0) / max(steps, 1)
    run.attempted = steps
    run.failed = int(aborted)
    run.values["sypd"] = (steps * hours / YEAR_HOURS) / ((t1 - t0) / 86400.0)
    run.spans["chunk_ms"] = list(out["chunk_ms"])
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        run.values["memory_peak_bytes"] = peak
        run.values["peak_mem_gib"] = peak / 2**30
    run.values["anomaly"] = _anomaly_reading(anoms, ocean, hm.layout)

    if run.trace and not aborted:
        sampler.stop()
        L, ol = hm.layout, ocean.ol
        no = ocean.params.win.shape[-1]
        fl_r, by_r = readout(L.R, L.n_out, k)
        fl_a, by_a = advance(L.R, n, L.n_in, cfg["reservoir"]["degree"])
        fl_s, by_s = spectral(cfg["work"]["inverse_level_transforms"],
                              cfg["work"]["forward_level_transforms"],
                              m["ntrun"] + 1, m["ntrun"] + 2, m["il"],
                              m["ix"])
        fl_or, by_or = readout(ol.R, ol.n_out, no)
        fl_oa, by_oa = advance(ol.R, no, ol.n_in, cfg["ocean"]["degree"])
        run.work = {"flops": {"float32": fl_r + fl_a + fl_s
                              + (fl_or + fl_oa) / K},
                    "bytes": by_r + by_a + by_s + (by_or + by_oa) / K}
        state = (out["x"], out["atmo_end"], out["logp_end"],
                 out["precip_t"], out["date"])
        ocean_state = dict(x_ocean=out["x_ocean"], sst_anom0=out["sst_anom"])
        n_chunks = tr["trace_chunks"]

        def chunks(start):
            # run() stages the boundary fields of one chunk more beside the
            # read one, then stops
            with writer("traced.nc") as wr:
                runner.run(*state, (n_chunks + 1) * K, ocean=ocean,
                           writer=wr, stream=True,
                           deadline=_Slice(n_chunks, start), **ocean_state)
        run.trace_summary = read_slices(chunks)
        run.values["trace_steps"] = K

    samples = sampler.samples()
    del runner, hm, sp, out, ocean, carry, warm, anoms
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compare(run, bindir, samples, aborted)


def _anomaly_reading(anoms, ocean, L) -> dict:
    """The SST anomaly the window's chunks ran under, over the active
    regions' core points: its rms and largest magnitude over all chunks,
    and the smallest rms of a chunk (K; read after the window)."""
    if not anoms:
        return {}
    ncore = L.resy * L.resx
    pts = (ocean.ol.target_index[ocean.active, :ncore]
           - L.gv_sizes["sst"][0]).reshape(-1)
    a = torch.stack([x.reshape(-1) for x in anoms]).double().cpu()
    a = a[:, torch.as_tensor(pts, dtype=torch.int64)]
    return {"sst_anom_rms_K": float(a.pow(2).mean().sqrt()),
            "sst_anom_max_K": float(a.abs().max()),
            "sst_anom_chunk_rms_min_K": float(
                a.pow(2).mean(dim=1).sqrt().min()),
            "chunks": len(anoms)}


# kept steps whose window gaps the check sets aside, the worst first. A
# float32 window can flip one column's moist trigger where the float64
# reference does not: the column's convective rain appears in one and not
# the other, and the spectral transforms spread it over the globe at a
# size that a bf16 readout gives too. The same window code built in
# float64 matches the reference at such a step as at any other (PERF.md,
# section 2). A fault of the program shows in more than one kept step.
SPARE_STEPS = 1


def _worst(values, spare: int = 0) -> float:
    """The largest of `values` once the `spare` largest are set aside, or
    the largest where no more than `spare` + 1 are given; NaN where one is
    not finite or none is."""
    if not values or not all(np.isfinite(v) for v in values):
        return float("nan")
    v = sorted(values)
    return v[-1 - spare] if len(v) > spare + 1 else v[-1]


def compare(run, bindir, samples, aborted):
    """The reference's check of each kept chunk, from its carry: the
    atmosphere's reservoirs carried over the chunk on the program's own
    states, the kept steps through the whole hybrid step (window, advance,
    readout), then the week's ocean step from the program's ocean state on
    the week composed of the same supervectors, and the anomaly it feeds
    back, against the program's. Each of the window's three numbers is
    the worst over the kept steps once the SPARE_STEPS worst are set
    aside."""
    cfg = run.cfg
    dev = run.device
    start = inputs.Start(cfg, bindir, dev)
    w = inputs.make_weights(cfg, start.L, run.seed, dev)
    ow = ocean_inputs.make_ocean(cfg, start, bindir, run.seed, dev)
    ref = ReferenceCoupled(cfg, bindir, w, start.stz, ow, ow["stz"],
                           ow["active"], dev)
    del w, ow
    hours = cfg["model"]["window_hours"]
    K = run.traffic["chunk"]
    # the warm-up week comes before the window's first chunk
    first = _date_after(start.date, K * hours)
    pts = ref.ocean.active_points()
    sc = cfg["scales"]
    dyn, q, precip, sst, mismatch = [], [], [], [], int(aborted)
    active = []
    for s in samples:
        x, atmo, logp, pr, anom = s["inputs"]
        res = s["result"]
        date = _date_after(first, s["chunk"] * K * hours)
        gsum = None
        for k in range(K):
            if k in s["steps"]:
                x, ra, rl, rp, rsafe, gv = ref.step(x, atmo, logp, pr, date,
                                                    anom)
                if ref.hyb.activity is not None:
                    active.append(ref.hyb.activity)
                g = checks.scaled_gaps(cfg, res.atmo_st[k], res.logp_st[k],
                                       res.pr_st[k], ra, rl, rp)
                dyn.append(checks.rms([g[v] for v in checks.DYN
                                       + ("logp",)]))
                q.append(checks.median_abs([g["q"]]))
                precip.append(checks.quantile_abs([g["precip"]],
                                                  checks.PRECIP_QUANTILE))
                mismatch += int(bool(res.safe_st[k]) != rsafe)
            else:
                gv = ref.inputs(atmo, logp, pr, date, anom)
                x = ref.advance(x, gv)
            gsum = gv if gsum is None else gsum + gv
            if k < K - 1:
                date.advance_hours(hours)
            atmo, logp, pr = res.atmo_st[k], res.logp_st[k], res.pr_st[k]
        if "x_ocean" in s and "anom_out" in s:
            clim_last = ref.sea(date, anom)[3]
            _, want = ref.week(s["x_ocean"], gsum, gv, K, clim_last)
            got = s["anom_out"].to("cpu", torch.float64).numpy()
            gap = np.abs(got - want).reshape(-1)[pts] / sc["sst"]
            sst.append(float(gap.max()) if gap.size else 0.0)
        else:
            sst.append(float("nan"))
    run.numbers = {"dyn_gap": _worst(dyn, SPARE_STEPS),
                   "q_gap": _worst(q, SPARE_STEPS),
                   "precip_gap": _worst(precip, SPARE_STEPS),
                   "flag_mismatch": mismatch, "sst_gap": _worst(sst)}
    print("check steps", json.dumps({"dyn_gap": dyn, "q_gap": q,
                                     "precip_gap": precip}),
          file=sys.stderr)
    reading = dict(run.values.get("anomaly", {}))
    if active:
        reading = {**{k: statistics.fmean(a[k] for a in active)
                      for k in active[0]}, **reading}
    if reading:
        run.values["activity"] = reading
