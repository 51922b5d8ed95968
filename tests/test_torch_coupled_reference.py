"""The port's coupled loop (ScanHybridRunner.run with an OceanModel, a
ForecastWriter and a fed-back SST anomaly) against the benchmark's plain
float64 reference of the coupled step (benchmark/reference/coupled.py), on
the CPU at a small size: the full T30L8 grid with full physics in float64,
1152 regions of n = 576 nodes, the slab ocean at its published width
(n_o = 4032) on seeded stand-in weights, and an ocean week of 2 steps
(timestep_slab 12 h), two weeks run. And the loop's spans of the window
and of the ocean step: once a step and once a week, with the chunk's
index and the active regions' count, outputs and the forecast file
bitwise those of the same run untraced.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from speedyml_torch.hybrid.fastloop import ScanHybridRunner
from speedyml_torch.io.output import ForecastWriter
from speedyml_torch.utils import diag

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
CPU = torch.device("cpu")
SEED = 3_100_000_777
WEEKS = 2

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def empty_store():
    diag.clear()
    yield
    diag.clear()


def _config():
    with open(os.path.join(BENCH, "configs", "coupled_t30l8.json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["model"]["dtype"] = "float64"
    cfg["reservoir"]["nodes_per_input"] = 576
    cfg["ocean"]["timestep_slab"] = 12
    return cfg


def _run(parts, writer_path):
    """Two ocean weeks from the start, with a writer. Returns (out, the
    chunks' inputs and stacks, the packed window forecasts of the second
    week, the ocean steps' inputs)."""
    runner = ScanHybridRunner(parts["hm"], parts["sp"], physics=True)
    ocean = parts["ocean"]
    orig_chunk, orig_window = runner.run_chunk, runner._model_gv
    chunks, windows, weeks = [], [], []

    def run_chunk(x, atmo, logp, pr, anom, xs, K):
        inp = [t.clone() for t in (x, atmo, logp, pr, anom)]
        res = orig_chunk(x, atmo, logp, pr, anom, xs, K)
        chunks.append(dict(inputs=inp, result=res))
        return res

    def model_gv(*a):
        out = orig_window(*a)
        windows.append(out[0].clone())
        return out

    def step(x, gv_week):
        weeks.append((x.clone(), gv_week.clone()))
        return type(ocean).step(ocean, x, gv_week)
    runner.run_chunk, runner._model_gv = run_chunk, model_gv
    ocean.step = step
    st = parts["start"]
    K = ocean.steps_per_week
    try:
        with ForecastWriter(writer_path, 8, 48, 96, with_sst=True) as wr:
            out = runner.run(parts["w"]["x0"], st.atmo, st.logp, st.pr,
                             st.date, WEEKS * K, ocean=ocean,
                             x_ocean=parts["ow"]["x0"], writer=wr,
                             stream=True)
    finally:
        del ocean.step
    return out, chunks, windows[K:], weeks


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    sys.path.insert(0, BENCH)
    from harness import inputs, ocean_inputs, program
    from harness.loops.coupled import ocean_model

    torch.manual_seed(0)
    cfg = _config()
    tmp = tmp_path_factory.mktemp("coupled")
    bindir = inputs.write_boundary(cfg, SEED, str(tmp))
    start = inputs.Start(cfg, bindir, CPU)
    w = inputs.make_weights(cfg, start.L, SEED, CPU)
    ow = ocean_inputs.make_ocean(cfg, start, bindir, SEED, CPU)
    sp = program.speedy(cfg, bindir, CPU)
    hm = program.hybrid_model(cfg, sp, w, start.stz)
    ocean = ocean_model(cfg, hm, ow)
    p = dict(cfg=cfg, bindir=bindir, start=start, w=w, ow=ow, sp=sp, hm=hm,
             ocean=ocean)
    plain = _run(p, str(tmp / "plain.nc"))
    with diag.tracing():
        traced = _run(p, str(tmp / "traced.nc"))
    p.update(plain=plain, traced=traced, spans=diag.spans(), tmp=tmp)
    return p


def test_ocean_maps_are_the_programs(parts):
    """The reference builds the ocean's input map itself; it has to read
    the same supervector entries as the port's build_ocean_layout."""
    from reference.coupled import ocean_maps

    inp, tgt, core = ocean_maps(parts["start"].L)
    ol = parts["ocean"].ol
    assert np.array_equal(inp, ol.input_index)
    assert np.array_equal(tgt, ol.target_index)
    # the persistence block reads each core's own SST
    assert np.array_equal(inp[:, core], tgt)
    assert ol.n_in == 112 and parts["ocean"].params.n == 4032


def test_coupled_chunk_and_ocean_step_match_the_reference(parts):
    """The second week, which runs under the anomaly the first week's ocean
    fed back, step by step from the port's own state at each step's start:
    - the window's packed forecast: both windows are float64 and read the
      same SST through the same 6 K gate, but the port packs it in float32
      (the HybridRunner.pack contract), so they agree to float32's rounding
      of the fields (2e-7 of their largest value, 1e-4 K of a 300 K one);
    - the step's outputs: the port reads out in float32 from a float32
      supervector, the reference in float64 (5e-6 of each variable's
      scale);
    - the week's ocean input: the port sums 2 float32 supervectors
      (5e-5 of a 300 K value);
    - the anomaly fed back after the week: the ocean step in float32 on
      that input, from the port's own ocean state, against float64; the
      port's prediction is a float32 SST, whose rounding at 300 K is 3e-5
      K (4e-5 K; an ocean that read the wrong patch or a week mean of the
      wrong fields is off by tenths of a K)."""
    from harness import checks
    from harness.loops.ensemble import _date_after
    from reference.coupled import ReferenceCoupled, week_inputs

    cfg, st = parts["cfg"], parts["start"]
    out, chunks, windows, weeks = parts["plain"]
    assert not out["aborted"] and out["steps_done"] == 2 * WEEKS
    ref = ReferenceCoupled(cfg, parts["bindir"], parts["w"], st.stz,
                           parts["ow"], parts["ow"]["stz"],
                           parts["ow"]["active"], CPU)
    pts = ref.ocean.active_points()
    K = parts["ocean"].steps_per_week
    x, atmo, logp, pr, anom = chunks[1]["inputs"]
    res = chunks[1]["result"]
    # the week runs under the anomaly the first week fed back
    assert float(anom.reshape(-1)[pts].abs().max()) > 0.05
    date = _date_after(st.date, K * 6)
    gsum = None
    for k in range(K):
        x, ra, rl, rp, safe, gv = ref.step(x, atmo, logp, pr, date, anom)
        torch.testing.assert_close(
            windows[k].double(), ref.model_gv, rtol=0,
            atol=2e-7 * float(ref.model_gv.abs().max()))
        assert safe and bool(res.safe_st[k])
        g = checks.scaled_gaps(cfg, res.atmo_st[k], res.logp_st[k],
                               res.pr_st[k], ra, rl, rp)
        assert checks.widest(g.values()) < 5e-6, k
        gsum = gv if gsum is None else gsum + gv
        if k < K - 1:
            date.advance_hours(6)
        atmo, logp, pr = res.atmo_st[k], res.logp_st[k], res.pr_st[k]
    x_ocean, gv_week = weeks[1]
    torch.testing.assert_close(gv_week.double(),
                               week_inputs(ref.L, gsum, gv, K), rtol=0,
                               atol=5e-5 * float(gv.abs().max()))
    _, want = ref.week(x_ocean, gsum, gv, K, ref.sea(date, anom)[3])
    got = np.asarray(out["sst_anom"], np.float64)
    assert np.abs(want.reshape(-1)[pts]).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-5)


def test_spans_leave_the_run_bitwise(parts):
    from speedyml_torch.io.output import read_forecast

    a, b = parts["plain"][0], parts["traced"][0]
    for key in ("x", "x_ocean", "atmo_end", "logp_end", "precip_t"):
        assert torch.equal(a[key], b[key]), key
    assert np.array_equal(a["sst_anom"], b["sst_anom"])
    assert a["summary"] == b["summary"]
    fa = read_forecast(str(parts["tmp"] / "plain.nc"))
    fb = read_forecast(str(parts["tmp"] / "traced.nc"))
    assert set(fa) == set(fb) and "SST" in fa
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


def test_window_and_ocean_spans(parts):
    """fastloop.window once a step inside the chunk, with the chunk's
    index; fastloop.ocean.step and .compose once a week under
    fastloop.ocean, which counts the active regions; the ocean's own ESN
    spans under fastloop.ocean.step, apart from the chunk's."""
    recs = parts["spans"]
    K = parts["ocean"].steps_per_week
    ids = {r["id"]: r for r in recs}
    by = {}
    for r in recs:
        by.setdefault(r["name"], []).append(r)

    def parent(r):
        return ids[r["parent"]]["name"] if r["parent"] else None

    assert sorted(r["index"] for r in by["fastloop.window"]) == \
        sorted(list(range(WEEKS)) * K)
    assert {parent(r) for r in by["fastloop.window"]} == {"fastloop.chunk"}
    n_active = int(parts["ocean"].active.sum())
    assert 0 < n_active < parts["ocean"].ol.R
    assert [(r["index"], r["counts"]) for r in by["fastloop.ocean"]] == \
        [(i, {"active": n_active}) for i in range(WEEKS)]
    for name in ("fastloop.ocean.step", "fastloop.ocean.compose"):
        assert [r["index"] for r in by[name]] == list(range(WEEKS)), name
        assert {parent(r) for r in by[name]} == {"fastloop.ocean"}, name
    under = {}
    for r in by["esn.advance"] + by["esn.readout"]:
        under.setdefault(parent(r), []).append(r)
    assert len(under["fastloop.chunk"]) == 2 * WEEKS * K
    assert len(under["fastloop.ocean.step"]) == 2 * WEEKS
    # the host times nest: the week's step and blend inside its span
    for o in by["fastloop.ocean"]:
        kids = [r for r in recs if r["parent"] == o["id"]]
        assert all(o["start_ns"] <= r["start_ns"] <= r["end_ns"]
                   <= o["end_ns"] for r in kids)
