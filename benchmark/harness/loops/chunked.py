"""The chunked loop: one trajectory through `ScanHybridRunner.run` with
`stream=True` and no writer (summary statistics only), in one call whose
deadline is the window's close; the loop stops after the chunk that
crosses it.

Traffic keys: chunk (K, steps between two reads of the safety flags),
check_chunks (chunks the check keeps besides the first), trace_chunks
(chunks profiled after the window in a traced run; the first of them is
left out of the profile's reading, since its boundary fields are staged
before it and not beside the chunk before).
"""

from __future__ import annotations

import gc
import time

import torch

from .. import checks, inputs, program
from ..pace import Pace
from ..sampling import Sampler
from ..trace import read_slices
from ..work import advance, readout
from .ensemble import YEAR_HOURS, _date_after
from reference.hybrid import ReferenceHybrid

# an upper bound on the steps of a window; the deadline ends the run
MAX_CHUNKS = 10 ** 6


def _record_samples(runner, sampler):
    """Wrap runner.run_chunk: keep the carry that enters the kept chunks and
    what they leave (the K-step stacks and the end carry)."""
    orig = runner.run_chunk
    count = [0]

    def run_chunk(x, atmo, logp, pr, anom, xs, K):
        i = count[0]
        slot = sampler.slot(i)
        if slot is not None:
            inp = [t.clone() for t in (x, atmo, logp, pr, anom)]
        res = orig(x, atmo, logp, pr, anom, xs, K)
        if slot is not None:
            sampler.kept[slot] = dict(chunk=i, inputs=inp, result=res)
        count[0] = i + 1
        return res

    runner.run_chunk = run_chunk


def execute(run):
    from speedyml_torch.hybrid.fastloop import ScanHybridRunner

    cfg, tr, dev = run.cfg, run.traffic, run.device
    K = tr["chunk"]
    hours = cfg["model"]["window_hours"]
    _, wout_dtype = program.variant_settings(run.variant)

    bindir = inputs.write_boundary(cfg, run.seed, run.tmp)
    start = inputs.Start(cfg, bindir, dev)
    w = inputs.make_weights(cfg, start.L, run.seed, dev)
    sp = program.speedy(cfg, bindir, dev)
    hm = program.hybrid_model(cfg, sp, w, start.stz, wout_dtype)
    runner = ScanHybridRunner(hm, sp, physics=cfg["model"]["physics"],
                              chunk=K)
    x0 = w["x0"]
    n = w["win"].shape[1]
    del w
    # warm-up: one chunk at the window's shapes, its result thrown away
    runner.run(x0, start.atmo, start.logp, start.pr, start.date, K,
               stream=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run.values["setup_end"] = time.perf_counter()

    pace = Pace(dev.type == "cuda")
    runner.run_chunk = pace.wrap_step(runner.run_chunk)
    for name in ("_precompute", "_upload_fields"):
        setattr(runner, name,
                pace.wrap_host("precompute_ms", getattr(runner, name)))
    sampler = Sampler(run.seed, tr["check_chunks"])
    _record_samples(runner, sampler)

    gc.collect()               # the set-up's garbage, not the window's
    pace.start()
    t0 = time.perf_counter()
    out = runner.run(x0, start.atmo, start.logp, start.pr, start.date,
                     K * MAX_CHUNKS, stream=True,
                     deadline=time.time() + run.seconds)
    t1 = time.perf_counter()
    run.values["pace"] = pace.summary()
    # the host's boundary fields of each chunk (_precompute and
    # _upload_fields), ms
    run.spans["precompute_ms"] = [v for v in pace.host["precompute_ms"]
                                  if v > 0]
    steps = out["steps_done"]
    aborted = bool(out["aborted"])
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

    if run.trace and not aborted:
        sampler.stop()
        L = hm.layout
        fl_r, by_r = readout(L.R, L.n_out, hm.params.wout.shape[-1])
        fl_a, by_a = advance(L.R, n, L.n_in, cfg["reservoir"]["degree"])
        run.work = {"flops": {"float32": fl_r + fl_a},
                    "bytes": by_r + by_a, "readout_bytes": by_r,
                    "readout_flops": fl_r}
        carry = (out["x"], out["atmo_end"], out["logp_end"],
                 out["precip_t"])
        n_chunks = tr["trace_chunks"]
        orig = runner.run_chunk

        def chunks(start):
            # the reading starts at the second chunk, whose boundary fields
            # were staged beside the first
            counted = [0]

            def counting(*a):
                counted[0] += 1
                if counted[0] == 2:
                    start()
                return orig(*a)
            runner.run_chunk = counting
            runner.run(*carry, out["date"], n_chunks * K, stream=True)
        run.trace_summary = read_slices(chunks)
        run.values["trace_steps"] = (n_chunks - 1) * K

    samples = sampler.samples()
    del runner, hm, sp, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compare(run, bindir, samples, aborted)


def compare(run, bindir, samples, aborted):
    """The reference's K steps from the carry entering each kept chunk,
    against the chunk's stacks and end state."""
    cfg = run.cfg
    start = inputs.Start(cfg, bindir, run.device)
    w = inputs.make_weights(cfg, start.L, run.seed, run.device)
    ref = ReferenceHybrid(cfg, bindir, w, start.stz, run.device)
    del w
    hours = cfg["model"]["window_hours"]
    K = run.traffic["chunk"]
    gaps, mismatch = [], int(aborted)
    for s in samples:
        x, atmo, logp, pr, anom = s["inputs"]
        res = s["result"]
        date = _date_after(start.date, s["chunk"] * K * hours)
        for k in range(K):
            x, atmo, logp, pr, sane = ref.ml_step(x, atmo, logp, pr, date,
                                                  anom)
            g = checks.scaled_gaps(cfg, res.atmo_st[k], res.logp_st[k],
                                   res.pr_st[k], atmo, logp, pr)
            gaps.append(checks.widest(g.values()))
            mismatch += int(bool(res.safe_st[k]) != sane)
            date.advance_hours(hours)
    run.numbers = {"out_gap": max(gaps, default=float("nan")),
                   "flag_mismatch": mismatch}
