"""The coupled cell (hybrid_loop) at a small size on the CPU, through its
loop (harness/loops/coupled.py) and its check: the sound run is correct,
and the check's control and planted faults in the coupling are not. The
size is this file's own: reservoirs of n = 576 nodes, the ocean at its
published width, an ocean week of 2 steps (timestep_slab 12 h)."""

from __future__ import annotations

import copy

import pytest
import torch

SEED = 2_900_000_555
SIZE = dict(config={"reservoir": {"nodes_per_input": 576},
                    "ocean": {"timestep_slab": 12}},
            traffic={"chunk": 2, "check_chunks": 1, "check_steps": 2})


def run_coupled(seed, tmp, variant=None):
    """One small run of hybrid_loop on the CPU. Returns (run, correct)."""
    from harness.cell import Cell, Run
    from harness.checks import verdict
    from harness.cli import execute

    cell = Cell("hybrid_loop")
    cell.config = copy.deepcopy(cell.config)
    for section, kv in SIZE["config"].items():
        cell.config[section].update(kv)
    cell.traffic = dict(cell.traffic, **SIZE["traffic"])
    run = Run(cell, seed, 1.0, False, torch.device("cpu"), str(tmp),
              variant)
    execute(run)
    return run, verdict(run.numbers, cell.limits) and run.failed == 0


def test_sound_run_is_correct(tmp_path):
    run, correct = run_coupled(SEED, tmp_path)
    assert correct, run.numbers
    assert run.attempted > 0 and run.failed == 0
    # the window's chunks ran under an anomaly the ocean fed back
    act = run.values["activity"]
    assert act["sst_anom_chunk_rms_min_K"] > 0.01
    assert act["sst_anom_max_K"] <= 6.0


def test_control_is_not_correct(tmp_path):
    run, correct = run_coupled(SEED, tmp_path, variant="bf16_wout")
    assert not correct, run.numbers


def _ocean_readout_off(monkeypatch):
    """One active region's predicted core SST 0.05 K off where the ocean's
    step makes it."""
    from speedyml_torch.reservoir.slab import OceanModel

    orig = OceanModel.step

    def step(self, x, gv):
        x, sst = orig(self, x, gv)
        sst = sst.clone()
        sst[int(self.active.nonzero()[0][0])] += 0.05
        return x, sst
    monkeypatch.setattr(OceanModel, "step", step)


def _anomaly_not_in_window(monkeypatch):
    """The window reads the climatological SST, not the fed-back one (the
    reservoirs' inputs still carry it)."""
    from speedyml_torch.hybrid.fastloop import ScanHybridRunner

    orig = ScanHybridRunner._model_gv

    def model_gv(self, atmo, logp, sst, ss, ti, xs, k):
        return orig(self, atmo, logp, torch.clamp(xs.sst_clim[k], 200.0,
                                                  306.0), ss, ti, xs, k)
    monkeypatch.setattr(ScanHybridRunner, "_model_gv", model_gv)


@pytest.mark.parametrize("fault,number", [
    (_ocean_readout_off, "sst_gap"),
    (_anomaly_not_in_window, "dyn_gap"),
], ids=["ocean-readout", "anomaly-not-in-window"])
def test_fault_is_not_correct(fault, number, monkeypatch, tmp_path):
    fault(monkeypatch)
    run, correct = run_coupled(SEED, tmp_path)
    assert not correct, run.numbers
    assert run.numbers[number] > run.cell.limits[number], run.numbers


@pytest.mark.parametrize("values,want", [
    ([3.0, 1.0, 2.0], 2.0),
    ([1.0, 9.0], 9.0),
    ([5.0, 1.0, 5.0], 5.0),
    ([1.0, float("nan"), 0.5], None),
    ([], None),
], ids=["set-aside", "too-few", "tie", "not-finite", "none"])
def test_worst_sets_aside_one(values, want):
    from harness.loops.coupled import SPARE_STEPS, _worst

    got = _worst(values, SPARE_STEPS)
    assert got == want if want is not None else got != got


def _window_off_at(steps):
    """A fault planted in the window's t at one column, at the chunk's
    steps `steps`: a moist trigger that flips there, as a float32 window
    can at one step, or a fault of the program where it recurs."""
    from speedyml_torch.hybrid.fastloop import ScanHybridRunner

    orig = ScanHybridRunner._model_gv

    def model_gv(self, atmo, logp, sst, ss, ti, xs, k):
        gv, safe = orig(self, atmo, logp, sst, ss, ti, xs, k)
        if k in steps:
            gv = gv.clone()
            gv[self.hm.layout.gv_sizes["atmo3d"][0] + 1000] += 5.0
        return gv, safe
    return model_gv


@pytest.mark.parametrize("steps,correct", [((1,), True), ((1, 2), False)],
                         ids=["one-step", "two-steps"])
def test_one_off_step_is_set_aside(steps, correct, monkeypatch, tmp_path):
    """With three kept steps the check sets the worst aside: the window
    off at one of them is still correct, off at two it is not."""
    from speedyml_torch.hybrid.fastloop import ScanHybridRunner

    monkeypatch.setattr(ScanHybridRunner, "_model_gv",
                        _window_off_at(steps))
    monkeypatch.setitem(SIZE, "config",
                        {**SIZE["config"],
                         "ocean": {"timestep_slab": 18}})
    monkeypatch.setitem(SIZE, "traffic",
                        {**SIZE["traffic"], "chunk": 3, "check_steps": 3})
    run, got = run_coupled(SEED, tmp_path)
    assert got == correct, run.numbers
    assert (run.numbers["dyn_gap"] > run.cell.limits["dyn_gap"]) != correct


def test_traced_slice_reads_one_chunk(monkeypatch, tmp_path):
    """A traced run's slice on the CPU, the profiler's start and stop
    stood in by the program's tracing(): the reading starts between the
    staging chunk and the read one, so that every `.cpl` metric that reads
    the program's host spans finds the read chunk whole, with its windows,
    ocean step and blend, and the fields staged beside it (CUDA events
    time the device spans on the card only)."""
    from speedyml_torch.utils import diag

    import harness.loops.coupled as coupled

    def read_slices(fn):
        cm = diag.tracing()
        fn(cm.__enter__)
        cm.__exit__(None, None, None)
        return {"busy_s": 1.0, "window_s": 4.0, "kernels": {}, "gaps": {},
                "device_ops": [], "idle_gaps": []}
    monkeypatch.setattr(coupled, "read_slices", read_slices)
    from harness.cell import Cell, Run
    from harness.cli import execute, metrics_of

    diag.clear()
    cell = Cell("hybrid_loop")
    cell.config = copy.deepcopy(cell.config)
    for section, kv in SIZE["config"].items():
        cell.config[section].update(kv)
    cell.traffic = dict(cell.traffic, **SIZE["traffic"])
    run = Run(cell, SEED, 1.0, True, torch.device("cpu"), str(tmp_path))
    execute(run)
    run.values["kind"] = "NVIDIA H100 80GB HBM3"
    got = metrics_of(run, 0.0)
    recs = [r for r in diag.spans() if r["loop"] == "fastloop"]
    diag.clear()
    K = SIZE["traffic"]["chunk"]
    chunks = [r for r in recs if r["name"] == "fastloop.chunk"]
    assert [(r["index"], r["counts"]) for r in chunks] == [(1, {"steps": K})]
    assert sorted(r["index"] for r in recs
                  if r["name"] == "fastloop.window") == [1] * K
    assert [r["index"] for r in recs if r["name"] == "fastloop.fields"] == [2]
    host = ("ocean_compose_ms.cpl", "fields_ms.cpl", "fordate_ms.cpl",
            "chunk_launch_ms.cpl", "flush_wait_ms.cpl",
            "device_idle_pct.cpl", "mfu_pct.cpl")
    assert set(host) <= set(got), got
    assert got["device_idle_pct.cpl"]["value"] == 75.0
    assert 0 < got["fordate_ms.cpl"]["value"] < got["fields_ms.cpl"]["value"]
