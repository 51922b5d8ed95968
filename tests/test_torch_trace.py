"""speedyml_torch.utils.diag's tracer (span, tracing, spans, count, loop)
and its spans in the ensemble loop and the chunked loop, on the CPU.

Off, a span records nothing and enters no profiler range. On, under a torch
profiler or inside tracing(), each span is a profiler range of its name and
a record whose host interval lies inside that range's, to 50 us (the two
read one clock). The loops' spans are checked at the full T30 grid with a
narrow reservoir (n = n_in, two shifts), the window dry: an E = 2 ensemble
and an ML-only chunked loop give each documented span once a step or chunk,
and their outputs are bitwise those of the same run untraced; a hybrid
chunked loop keeps the fordate span the ML-only one no longer has. The
benchmark's reader of the spans (benchmark/harness/program_spans.py) takes
the first traced run of a store.
"""

import importlib.util
import os
import sys
import tempfile
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from speedyml_torch import ModelConfig, ModelDate, ReservoirConfig
from speedyml_torch.domain.decomposition import build_layout, pack_global
from speedyml_torch.domain.standardize import Standardizer
from speedyml_torch.hybrid.ensemble import EnsembleHybrid
from speedyml_torch.hybrid.experiment import HybridModel
from speedyml_torch.hybrid.fastloop import ScanHybridRunner
from speedyml_torch.hybrid.forecast import SpeedyForecaster
from speedyml_torch.hybrid.state_io import extract
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.model import Speedy
from speedyml_torch.reservoir.esn import EsnParams
from speedyml_torch.utils import diag

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = ModelDate(1982, 1, 1, 0)
CLOCK_US = 50


def _load(relpath):
    path = os.path.join(REPO, relpath)
    name = "bench_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


program_spans = _load("benchmark/harness/program_spans.py")


@pytest.fixture(autouse=True)
def empty_store():
    diag.clear()
    yield
    diag.clear()


@pytest.fixture(scope="module")
def models():
    """A float64 SPEEDY on stand-in files at its start state, and a hybrid
    and an ML-only model over 1152 regions of n = n_in nodes with a
    seeded small readout."""
    sp = Speedy(ModelConfig(dtype="float64"),
                write_synthetic_boundary(tempfile.mkdtemp(), 3), device="cpu")
    sp.initialize(START.iyear, START.imonth)
    L = build_layout(radang_deg=np.degrees(np.asarray(sp.dy.tables.radang)))
    gs = extract(sp.dy, sp.state)
    atmo = torch.stack([gs.t, gs.u, gs.v,
                        torch.clamp(gs.q, min=1e-6)]).float()
    logp = gs.logp.float()
    gv0 = pack_global(L, atmo, logp, torch.zeros_like(logp),
                      torch.full_like(logp, 280.0), torch.zeros_like(logp))
    idx, tidx = L.maps("cpu")
    stz = Standardizer(in_mean=gv0[idx],
                       in_std=torch.full((L.R, L.n_in), 5.0),
                       out_mean=gv0[tidx], out_std=torch.ones(L.R, L.n_out))
    g = torch.Generator().manual_seed(5)
    n, shifts = L.n_in, (1, 2)

    def model(ml_only):
        na = n if ml_only else n + L.n_out
        params = EsnParams(
            a_idx=((torch.arange(n)[:, None] + torch.tensor(shifts)) % n)[
                None].expand(L.R, n, len(shifts)),
            a_val=0.3 * torch.randn((L.R, n, len(shifts)), generator=g),
            win=0.5 * torch.randn((L.R, n), generator=g),
            wout=0.003 * torch.randn((L.R, L.n_out, na), generator=g),
            node_map=torch.arange(n), leakage=1.0, a_shift=shifts)
        return HybridModel(layout=L, params=params, stz=stz,
                           rcfg=ReservoirConfig(), ml_only=ml_only)

    return dict(sp=sp, L=L, atmo=atmo, logp=logp, n=n,
                hybrid=model(False), ml=model(True))


# ----------------------------------------------------------------------
# the tracer


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(diag, "_range", Counting)
    assert diag.span("a") is diag.span("b", device=True)
    with diag.span("outer", index=3) as s:
        with diag.span("inner"):
            diag.count("n", 2)
        s.count("steps", 4)
        s.timed_by(None, None)
    assert diag.spans() == [] and entered == []
    with diag.tracing():
        with diag.span("on"):
            pass
    assert entered == ["on"] and [r["name"] for r in diag.spans()] == ["on"]


def test_spans_are_profiler_ranges_on_its_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with diag.span("trace.outer", index=i):
                with diag.span("trace.inner"):
                    torch.ones(256).mul_(2.0).sum()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("trace."):
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.end_ns()))
    recs = diag.spans()
    assert Counter(r["name"] for r in recs) == {"trace.outer": 3,
                                                "trace.inner": 3}
    assert {k: len(v) for k, v in events.items()} == {"trace.outer": 3,
                                                      "trace.inner": 3}
    slack = CLOCK_US * 1000
    for r in recs:
        assert any(s - slack <= r["start_ns"] <= r["end_ns"] <= e + slack
                   for s, e in events[r["name"]]), r
        assert r["device_ms"] is None and r["host_ms"] >= 0
    assert [r["index"] for r in recs if r["name"] == "trace.inner"] == \
        [0, 1, 2]


def test_tracing_without_a_profiler_records_and_a_null_span_stays_null():
    with diag.span("before"):
        pass
    with diag.span("off.outer"):
        with diag.tracing():
            with diag.span("on.inner", device=True) as s:
                s.count("k", 1)
                diag.count("k", 2)
    with diag.span("after"):
        pass
    recs = diag.spans()
    assert [r["name"] for r in recs] == ["on.inner"]
    # the enclosing span was entered off, so it keeps no record and is no
    # parent; with no CUDA in use, a device span is timed on the host
    assert recs[0]["parent"] is None and recs[0]["counts"] == {"k": 3}
    assert recs[0]["device_ms"] is None


def test_parent_and_run_ids_across_threads():
    box = {}

    @diag.loop("demo")
    def run():
        this = diag.current_run()
        with diag.span("demo.a", index=7):
            with diag.span("demo.a.b"):
                pass

        def writer():
            with diag.span("demo.flush", index=7, run=this):
                pass
        t = threading.Thread(target=writer)
        t.start()
        t.join()
        box["run"] = this

    with diag.tracing():
        run()
        run()
    recs = diag.spans()
    first, second = recs[:3], recs[3:]
    assert [r["name"] for r in first] == ["demo.a.b", "demo.a", "demo.flush"]
    b, a, flush = first
    assert b["parent"] == a["id"] and a["parent"] is None
    assert flush["parent"] is None and b["index"] == 7
    assert {r["run"] for r in first} == {first[0]["run"]}
    assert {r["loop"] for r in recs} == {"demo"}
    assert {r["run"] for r in second} == {box["run"][0]} != {a["run"]}
    assert len({r["id"] for r in recs}) == 6
    assert diag.current_run() == (None, None)


def test_store_bound_drops_the_oldest_and_counts_them():
    n = diag.CAPACITY + 2
    with diag.tracing():
        for i in range(n):
            with diag.span(f"s{i}"):
                pass
    names = [r["name"] for r in diag.spans()]
    assert len(names) == diag.CAPACITY and diag.dropped() == 2
    assert names[0] == "s2" and names[-1] == f"s{n - 1}"
    diag.clear()
    assert diag.spans() == [] and diag.dropped() == 0


def test_threads_share_the_store_without_losing_a_record():
    """More threads than cores entering nested spans at a short switch
    interval: every span is kept or counted as dropped, once, with its own
    thread's parent."""
    workers, per = 2 * (os.cpu_count() or 1) + 2, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(w):
            for i in range(per):
                with diag.span(f"t{w}", index=i):
                    with diag.span(f"t{w}.inner"):
                        pass
        with diag.tracing():
            threads = [threading.Thread(target=work, args=(w,))
                       for w in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = diag.spans()
    assert len(recs) + diag.dropped() == 2 * workers * per
    assert len({r["id"] for r in recs}) == len(recs)
    ids = {r["id"]: r for r in recs}
    for r in recs:
        if r["name"].endswith(".inner"):
            parent = ids[r["parent"]]
            assert parent["name"] + ".inner" == r["name"]
            assert parent["index"] == r["index"]


# ----------------------------------------------------------------------
# the loops' spans

ENSEMBLE_SPANS = {
    "ensemble.boundary": None, "ensemble.step": None,
    "ensemble.window": "ensemble.step", "ensemble.exchange": "ensemble.step",
    "ensemble.exchange.pack": "ensemble.exchange",
    "esn.advance": "ensemble.exchange", "esn.readout": "ensemble.exchange",
    "ensemble.exchange.unpack": "ensemble.exchange",
    "ensemble.flag_wait": None,
}


def test_ensemble_run_spans_once_a_step_and_bitwise_outputs(models):
    m = models
    ens = EnsembleHybrid(m["hybrid"], SpeedyForecaster(m["sp"],
                                                      physics=False))
    members = (torch.zeros(2, m["L"].R, m["n"]),
               torch.stack([m["atmo"], m["atmo"] + 0.1]),
               torch.stack([m["logp"], m["logp"]]),
               torch.zeros(2, *m["logp"].shape))
    steps = 2
    plain = ens.run(*members, START, steps, collect=False)
    assert diag.spans() == []
    with diag.tracing():
        traced = ens.run(*members, START, steps, collect=False)
    assert not plain["aborted"] and not traced["aborted"]
    for a, b in zip((plain["x"], *plain["final"]),
                    (traced["x"], *traced["final"])):
        assert torch.equal(a, b)
    recs = diag.spans()
    names = {r["id"]: r["name"] for r in recs}
    assert Counter(r["name"] for r in recs) == {k: steps
                                                for k in ENSEMBLE_SPANS}
    for r in recs:
        assert names.get(r["parent"]) == ENSEMBLE_SPANS[r["name"]], r
        assert r["loop"] == "ensemble" and r["index"] in range(steps)
    assert len({r["run"] for r in recs}) == 1
    assert program_spans.step_median(
        "esn.advance", "host_ms", under="ensemble.exchange") > 0


def _ml_run(m, chunk, n_steps, **kw):
    runner = ScanHybridRunner(m["ml"], m["sp"], physics=False, chunk=chunk)
    return runner, runner.run(torch.zeros(m["L"].R, m["n"]), m["atmo"],
                              m["logp"], None, START, n_steps, **kw)


def test_chunked_run_spans_once_a_chunk_and_bitwise_outputs(models):
    K, chunks = 2, 3
    _, plain = _ml_run(models, K, K * chunks, stream=True)
    with diag.tracing():
        _, traced = _ml_run(models, K, K * chunks, stream=True)
    for key in ("x", "atmo_end", "logp_end", "precip_t"):
        assert torch.equal(plain[key], traced[key])
    assert plain["summary"] == traced["summary"]
    recs = diag.spans()
    by = {}
    for r in recs:
        by.setdefault(r["name"], []).append(r)
    per_chunk = {"fastloop.fields": range(chunks),
                 "fastloop.fields.host": range(chunks),
                 "fastloop.fields.upload": range(chunks),
                 "fastloop.chunk": range(chunks),
                 "fastloop.flag_wait": range(chunks),
                 "fastloop.flush": range(chunks),
                 # the wait for chunk ci - 2's flush, then after the last
                 "fastloop.flush_wait": range(2, chunks + 1)}
    for name, want in per_chunk.items():
        assert sorted(r["index"] for r in by[name]) == list(want), name
    assert len(by["esn.advance"]) == len(by["esn.readout"]) == K * chunks
    # the ML-only chunk builds no radiation fields: no fordate span
    assert set(by) == set(per_chunk) | {"esn.advance", "esn.readout"}
    ids = {r["id"]: r for r in recs}
    parent = {n: ids[by[n][0]["parent"]]["name"] for n in
              ("fastloop.fields.host", "fastloop.fields.upload",
               "esn.readout")}
    assert parent == {"fastloop.fields.host": "fastloop.fields",
                      "fastloop.fields.upload": "fastloop.fields",
                      "esn.readout": "fastloop.chunk"}
    assert all(r["counts"] == {"steps": K} for r in by["fastloop.chunk"])
    assert all(r["counts"] == {"fields": 2} for r in by["fastloop.fields"])
    # the writer thread's flushes belong to the run
    assert {r["run"] for r in recs} == {recs[0]["run"]}
    assert {r["loop"] for r in recs} == {"fastloop"}
    assert all(r["parent"] is None for r in by["fastloop.flush"])
    assert program_spans.chunk_median(
        K, "fastloop.fields.host.fordate") is None
    assert program_spans.chunk_median(K, "fastloop.fields") > 0


def test_hybrid_chunked_run_keeps_fordate_and_all_fields(models):
    """The hybrid chunk still builds every field its window reads, fordate
    once a step under the host's fields."""
    K, chunks = 2, 2
    runner = ScanHybridRunner(models["hybrid"], models["sp"], physics=False,
                              chunk=K)
    with diag.tracing():
        out = runner.run(torch.zeros(models["L"].R, models["n"]),
                         models["atmo"], models["logp"], None, START,
                         K * chunks, stream=True)
    assert not out["aborted"] and out["steps_done"] == K * chunks
    recs = diag.spans()
    names = {r["id"]: r["name"] for r in recs}
    fordate = [r for r in recs if r["name"] == "fastloop.fields.host.fordate"]
    assert sorted(r["index"] for r in fordate) == \
        sorted(list(range(chunks)) * K)
    assert {names[r["parent"]] for r in fordate} == {"fastloop.fields.host"}
    fields = [r for r in recs if r["name"] == "fastloop.fields"]
    assert sorted(r["index"] for r in fields) == list(range(chunks))
    assert all(r["counts"] == {"fields": 17} for r in fields)
    fordate_ms = program_spans.chunk_median(K, "fastloop.fields.host.fordate")
    assert 0 < fordate_ms < program_spans.chunk_median(K, "fastloop.fields")


def test_chunk_steps_count_stops_at_an_abort(models):
    K = 4
    runner = ScanHybridRunner(models["ml"], models["sp"], physics=False,
                              chunk=K)
    calls = [0]

    def unsafe_at_6(atmo, logp, xs):
        calls[0] += 1
        return torch.tensor(calls[0] != 7)
    runner._ml_safe_fn = unsafe_at_6
    with diag.tracing():
        out = runner.run(torch.zeros(models["L"].R, models["n"]),
                         models["atmo"], models["logp"], None, START, 3 * K)
    assert out["aborted"] and out["steps_done"] == 6
    steps = [(r["index"], r["counts"]["steps"]) for r in diag.spans()
             if r["name"] == "fastloop.chunk"]
    assert steps == [(0, K), (1, 2)]
    assert program_spans.chunk_median(K, "fastloop.chunk") is not None


def test_program_spans_reads_the_first_traced_run():
    def rec(i, name, run, loop, index, host, device=None, parent=None,
            counts=None):
        return dict(name=name, id=i, parent=parent, run=run, loop=loop,
                    index=index, start_ns=0, end_ns=0, host_ms=host,
                    device_ms=device, counts=counts or {})

    store = [
        rec(1, "ensemble.step", 4, "ensemble", 0, 900.0),
        rec(2, "fastloop.fields.host.fordate", 5, "fastloop", 1, 1.0),
        rec(3, "fastloop.fields.host.fordate", 5, "fastloop", 1, 2.0),
        rec(4, "fastloop.fields", 5, "fastloop", 1, 9.0),
        rec(5, "fastloop.chunk", 5, "fastloop", 1, 30.0,
            counts={"steps": 2}),
        rec(6, "fastloop.fields", 5, "fastloop", 2, 11.0),
        rec(7, "fastloop.chunk", 5, "fastloop", 2, 31.0,
            counts={"steps": 1}),
        rec(8, "fastloop.fields", 6, "fastloop", 1, 99.0),
        rec(9, "fastloop.chunk", 6, "fastloop", 1, 99.0,
            counts={"steps": 2}),
        rec(10, "esn.advance", 4, "ensemble", 0, 1.0, 5.0, parent=11),
        rec(11, "ensemble.exchange", 4, "ensemble", 0, 2.0, 8.0),
        rec(12, "esn.advance", None, None, None, 1.0, 7.0),
    ]
    ps = program_spans
    assert [r["id"] for r in ps.first_run("fastloop", store)] == \
        [2, 3, 4, 5, 6, 7]
    assert ps.first_run("absent", store) == []
    # chunk 2 counted 1 step of 2: only chunk 1 is complete
    assert ps.chunk_median(2, "fastloop.fields", recs=store) == 9.0
    assert ps.chunk_median(
        2, "fastloop.fields.host.fordate", recs=store) == 3.0
    assert ps.chunk_median(3, "fastloop.fields", recs=store) is None
    assert ps.step_median("ensemble.step", recs=store) == 900.0
    assert ps.step_median("esn.advance", "device_ms",
                          under="ensemble.exchange", recs=store) == 5.0
    assert ps.step_median("esn.advance", "device_ms", under="other",
                          recs=store) is None
    assert ps.step_median("ensemble.step", recs=[]) is None
    idle = _load("benchmark/metrics/precompute_idle_pct.ml.py").read

    class Run:
        trace_summary = {"gaps": {"fastloop.fields.host.fordate": 0.6,
                                  "fastloop.fields.upload": 0.1,
                                  "fastloop.chunk": 0.1, "python": 0.2}}
    assert idle(Run()) == pytest.approx(70.0)
    Run.trace_summary = {"gaps": {"python": 0.7, "aten::mul": 0.1}}
    assert idle(Run()) is None
