"""The ensemble loop: `EnsembleHybrid.run(collect=False)` over E members,
called in segments of `segment_steps` steps until the window closes, state
and date carried from one segment to the next.

Traffic keys: members (E), segment_steps, perturbation (the members'
seeded spread around the start state), check_steps (steps the check keeps
besides the first), check_members (members it compares at each kept step,
drawn from the halves of the ensemble in turn), trace_segments (segments
profiled after the window in a traced run).
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from .. import checks, inputs, program
from ..pace import Pace
from ..sampling import Sampler
from ..trace import read_slices
from ..work import advance, readout, spectral
from reference.hybrid import ReferenceHybrid

YEAR_HOURS = 365 * 24


def _date_after(date, hours):
    from reference.speedy.core.calendar import ModelDate

    d = ModelDate(date.iyear, date.imonth, date.iday, date.ihour)
    d.advance_hours(hours)
    return d


def _record_samples(ens, sampler, members_per_step, E):
    """Wrap ens.step: keep the inputs and outputs of the kept steps'
    chosen members (copies on the card; the run holds the rest). Returns
    a dict that holds the last step's safety flags."""
    orig = ens.step
    count = [0]
    last = {}

    def step(x_e, atmo_e, logp_e, pr_e, *rest):
        i = count[0]
        slot = sampler.slot(i)
        if slot is not None:
            half = E // 2 if E > 1 else 1
            ms = [sampler.draw(0, half) if j % 2 == 0 else
                  sampler.draw(half, E) for j in range(members_per_step)]
            idx = torch.as_tensor(ms, device=x_e.device)
            inp = [t[idx] for t in (x_e, atmo_e, logp_e, pr_e)]
        out = orig(x_e, atmo_e, logp_e, pr_e, *rest)
        if slot is not None:
            sampler.kept[slot] = dict(step=i, members=ms, inputs=inp,
                                      outputs=[t[idx] for t in out])
        last["safe"] = out[-1]
        count[0] = i + 1
        return out

    ens.step = step
    return last


def _record_spans(run, ens, fc):
    """Spans of a traced run: CUDA events around the members' windows and
    the reservoir exchange, the host clock around the per-date boundary
    calls of EnsembleHybrid.run (SST, TISR, _surf_forcing). Returns a
    function that undoes the module patches and turns the events into
    run.spans."""
    import speedyml_torch.hybrid.ensemble as ens_mod

    events = {"window_ms": [], "exchange_ms": []}
    host = [0.0]
    on = [True]

    def cuda_span(name, fn):
        def wrapped(*a, **k):
            if not on[0]:
                return fn(*a, **k)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            events[name].append((e0, e1))
            return out
        return wrapped

    def host_span(fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            host[0] += time.perf_counter() - t0
            return out
        return wrapped

    ens.forecast = cuda_span("window_ms", ens.forecast)
    ens.exchange = cuda_span("exchange_ms", ens.exchange)
    fc._surf_forcing = host_span(fc._surf_forcing)
    saved = (ens_mod.init_coupler_state, ens_mod.diurnal_tisr)
    ens_mod.init_coupler_state = host_span(saved[0])
    ens_mod.diurnal_tisr = host_span(saved[1])
    step = ens.step

    def step_with_boundary(*a):
        if on[0]:
            run.spans["boundary_ms"].append(1e3 * host[0])
        host[0] = 0.0
        return step(*a)

    ens.step = step_with_boundary

    def finish():
        on[0] = False
        ens_mod.init_coupler_state, ens_mod.diurnal_tisr = saved
        torch.cuda.synchronize()
        for name, pairs in events.items():
            run.spans[name] = [a.elapsed_time(b) for a, b in pairs]
    return finish


def execute(run):
    from speedyml_torch.hybrid.ensemble import EnsembleHybrid
    from speedyml_torch.hybrid.forecast import SpeedyForecaster

    cfg, tr, dev = run.cfg, run.traffic, run.device
    E, S = tr["members"], tr["segment_steps"]
    hours = cfg["model"]["window_hours"]
    grid_compute, wout_dtype = program.variant_settings(run.variant)

    bindir = inputs.write_boundary(cfg, run.seed, run.tmp)
    start = inputs.Start(cfg, bindir, dev)
    w = inputs.make_weights(cfg, start.L, run.seed, dev)
    sp = program.speedy(cfg, bindir, dev, grid_compute)
    hm = program.hybrid_model(cfg, sp, w, start.stz, wout_dtype)
    fc = SpeedyForecaster(sp, hours=hours, physics=cfg["model"]["physics"])
    ens = EnsembleHybrid(hm, fc)
    mem = inputs.members(start, w["x0"], E, tr["perturbation"], run.seed)
    n, k = w["win"].shape[1], w["wout"].shape[-1]
    del w
    # warm-up: one step at the window's shapes, its result thrown away
    ens.run(*mem, start.date, 1, collect=False)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run.values["setup_end"] = time.perf_counter()

    pace = Pace(dev.type == "cuda")
    ens.step = pace.wrap_step(ens.step)
    sampler = Sampler(run.seed, tr["check_steps"])
    last = _record_samples(ens, sampler, tr["check_members"], E)
    finish = _record_spans(run, ens, fc) if run.trace else None

    carry, date = mem, start.date
    steps, aborted = 0, False
    gc.collect()               # the set-up's garbage, not the window's
    pace.start()
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    t_last = t0
    while True:
        out = ens.run(*carry, date, S, collect=False)
        t = time.perf_counter()
        if out["aborted"]:
            aborted = True
            break
        carry, date = (out["x"], *out["final"]), out["date"]
        if t > deadline and steps:
            break
        steps += S
        t_last = t
        if t > deadline:
            break
    run.values["pace"] = pace.summary()
    run.values["steps"] = steps
    run.attempted = steps * E
    if aborted:
        run.failed = int((~last["safe"]).sum())
    run.values["step_s"] = (t_last - t0) / max(steps, 1)
    run.values["sypd"] = (steps * E * hours / YEAR_HOURS) / (
        (t_last - t0) / 86400.0)
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        run.values["memory_peak_bytes"] = peak
        run.values["peak_mem_gib"] = peak / 2**30

    if run.trace and not aborted:
        finish()
        sampler.stop()
        L = hm.layout
        m = cfg["model"]
        fl_r, by_r = readout(L.R, L.n_out, k, E)
        fl_a, by_a = advance(L.R, n, L.n_in, cfg["reservoir"]["degree"], E)
        tc = cfg["work"]
        fl_s, by_s = spectral(tc["inverse_level_transforms"],
                              tc["forward_level_transforms"], m["ntrun"] + 1,
                              m["ntrun"] + 2, m["il"], m["ix"], E)
        run.work = {"flops": {"float32": fl_r + fl_a + fl_s},
                    "bytes": by_r + by_a + by_s}

        def segment(start):
            start()
            ens.run(*carry, date, tr["trace_segments"] * S, collect=False)
        run.trace_summary = read_slices(segment)

    samples = sampler.samples()
    del ens, hm, fc, sp, mem, carry, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compare(run, bindir, samples, aborted)


def compare(run, bindir, samples, aborted):
    """The reference's single-member steps from each kept (step, member)'s
    inputs, against the program's outputs. The weights and the
    standardizer are made again from the seed."""
    cfg = run.cfg
    start = inputs.Start(cfg, bindir, run.device)
    w = inputs.make_weights(cfg, start.L, run.seed, run.device)
    ref = ReferenceHybrid(cfg, bindir, w, start.stz, run.device)
    del w
    hours = cfg["model"]["window_hours"]
    dyn, q, precip, mismatch = [], [], [], int(aborted)
    active = []
    for s in samples:
        date = _date_after(start.date, s["step"] * hours)
        xin, ain, lin, pin = s["inputs"]
        _, ao, lo, po, so = s["outputs"]
        for j in range(len(s["members"])):
            _, ra, rl, rp, rsafe = ref.hybrid_step(xin[j], ain[j], lin[j],
                                                   pin[j], date)
            if ref.activity is not None:
                active.append(ref.activity)
            g = checks.scaled_gaps(cfg, ao[j], lo[j], po[j], ra, rl, rp)
            dyn.append(checks.rms([g[k] for k in checks.DYN + ("logp",)]))
            q.append(checks.median_abs([g["q"]]))
            precip.append(checks.quantile_abs([g["precip"]],
                                              checks.PRECIP_QUANTILE))
            mismatch += int(bool(so[j]) != rsafe)
    run.numbers = {"dyn_gap": max(dyn, default=float("nan")),
                   "q_gap": max(q, default=float("nan")),
                   "precip_gap": max(precip, default=float("nan")),
                   "flag_mismatch": mismatch}
    if active:
        run.values["activity"] = {
            k: statistics.fmean(a[k] for a in active) for k in active[0]}
