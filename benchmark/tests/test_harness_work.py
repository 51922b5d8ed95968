"""The benchmark's data files and its counting, against hand counts."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import BENCH

ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_name_finds_its_files():
    s = spec()
    loops = os.listdir(os.path.join(BENCH, "harness", "loops"))
    for c in s["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
    for w in s["workloads"]:
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) \
                as f:
            assert json.load(f)["loop"] + ".py" in loops
        assert os.path.isfile(os.path.join(BENCH, "limits",
                                           w["name"] + ".json"))
    for m in s["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


def test_contract_shapes():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in s["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
        layer = [m for m in s["per_layer"] if w["name"] in m["workloads"]]
        assert layer and all(m["moves"] in e2e for m in layer)
    for m in s["per_layer"]:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_traffic_files():
    with open(os.path.join(BENCH, "traffic", "ensemble_e256.json")) as f:
        ens = json.load(f)
    with open(os.path.join(BENCH, "traffic", "chunked_k28.json")) as f:
        ml = json.load(f)
    assert (ens["members"], ens["segment_steps"]) == (256, 2)
    assert ml["chunk"] == 28


def test_readout_and_advance_counts():
    from harness.work import advance, readout

    # the hybrid readout of 256 members: 2 * 1152 * 136 * 5896 * 256
    flops, nbytes = readout(1152, 136, 5896, 256)
    assert flops == 472_953_913_344
    assert nbytes == (1152 * 136 * 5896 * 4 + 256 * 1152 * 5896 * 4
                      + 256 * 1152 * 136 * 4)
    # the ML-only readout streams 3.61 GB of float32 weights a step
    flops, nbytes = readout(1152, 136, 5760)
    assert flops == 1_804_861_440
    assert nbytes - 1152 * 5760 * 4 - 1152 * 136 * 4 == 3_609_722_880
    # advance: 6 shifted products, Win, the leak, per node
    flops, nbytes = advance(1152, 5760, 576, 6)
    assert flops == 1152 * 5760 * 18
    assert nbytes == 4 * (1152 * 5760 * 6 + 1152 * 5760 + 1152 * 576
                          + 2 * 1152 * 5760)


def test_spectral_counts():
    from harness.work import spectral

    # one level at T30 (mx 31, nx 32) on 48 x 96: Legendre 2*31*2*32*48,
    # DFT 2*48*62*96
    flops, nbytes = spectral(1, 0, 31, 32, 48, 96)
    assert flops == 190_464 + 571_392
    assert nbytes == (31 * 2 * 32 + 48 * 96) * 4
    flops, _ = spectral(2341, 1858, 31, 32, 48, 96, E=256)
    assert flops == 4199 * 761_856 * 256


def test_bound_takes_the_larger_side():
    from harness.work import bound_seconds, peaks

    peak = peaks("NVIDIA H100 80GB HBM3")
    assert peak["hbm_bytes_per_s"] == 3.35e12
    w = {"flops": {"float32": 67e12}, "bytes": 1.0}
    assert bound_seconds(w, peak) == pytest.approx(1.0)
    w = {"flops": {"float32": 1.0}, "bytes": 6.7e12}
    assert bound_seconds(w, peak) == pytest.approx(2.0)
    assert peaks("a card not in the table") is None


def test_trace_arithmetic():
    from harness.trace import kernel_seconds, summarize_intervals

    # two overlapping kernels 10-30 and 20-40 us, one 60-70 us; the host
    # runs op A 0-50 with B 35-45 inside it, then nothing
    dev = [(10, 30, "gemv_k"), (20, 40, "elem"), (60, 70, "gemv_k")]
    host = [(0, 50, "A"), (35, 45, "B")]
    s = summarize_intervals(dev, host)
    assert s["window_s"] == pytest.approx(70e-6)
    assert s["busy_s"] == pytest.approx(40e-6)
    # idle gaps 0-10 (inside A), 40-60 (middle 50: after A, so python)
    assert s["gaps"] == pytest.approx({"A": 10e-6, "python": 20e-6})
    assert kernel_seconds(s, "GEMV") == pytest.approx(30e-6)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_idle_gaps_go_to_the_innermost_host_event(seed):
    """The sweep that names each gap's host event against a plain search
    over every event, on random nested and overlapping events."""
    import random

    from harness.trace import _innermost

    rng = random.Random(seed)
    host = []
    for _ in range(300):
        s = rng.uniform(0, 1000)
        host.append((s, s + rng.expovariate(1 / 30), f"op{len(host)}"))
    times = sorted(rng.uniform(-10, 1100) for _ in range(500))

    def plain(t):
        running = [(h[0], i, h[2]) for i, h in enumerate(
            sorted(host, key=lambda h: h[0])) if h[0] <= t < h[1]]
        return max(running)[2] if running else "python"
    assert _innermost(host, times) == [plain(t) for t in times]


def test_sampler_keeps_the_first_and_k_more():
    from harness.sampling import Sampler

    kept = set()
    for seed in range(200):
        s = Sampler(seed, 3)
        slots = {}
        for i in range(40):
            sl = s.slot(i)
            if sl is not None:
                slots[sl] = i
        assert slots[-1] == 0 and len(slots) == 4
        kept.update(v for k, v in slots.items() if k >= 0)
    # over many seeds every step after the first is kept sometimes
    assert kept == set(range(1, 40))
    a, b = Sampler(12345, 3), Sampler(12345, 3)
    assert [a.slot(i) for i in range(50)] == [b.slot(i) for i in range(50)]


def test_profiler_events_are_split_by_device():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from harness.trace import summarize

    def ev(s, e, name, dev):
        # times in ns, as the profiler's raw results give them
        return NS(start_ns=lambda: 1000 * s, end_ns=lambda: 1000 * e,
                  name=lambda: name, device_type=lambda: dev)
    events = [ev(10, 20, "kernel", DeviceType.CUDA),
              ev(0, 30, "aten::mul", DeviceType.CPU)]
    prof = NS(profiler=NS(kineto_results=NS(events=lambda: events)))
    s = summarize(prof)
    assert s["busy_s"] == pytest.approx(10e-6)
    assert s["window_s"] == pytest.approx(30e-6)
    assert s["kernels"] == pytest.approx({"kernel": 10e-6})
