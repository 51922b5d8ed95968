"""A cell added as new files only: a traffic mix, its limits and a
per-layer metric's reader, named in BENCHMARK.json, run through the
existing harness without an edit to any file it already has."""

from __future__ import annotations

import json
import os
import shutil

from conftest import BENCH, run_small

ROOT = os.path.dirname(BENCH)


def test_new_cell_from_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", ".scratch",
                                                  "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    # the new files
    (root / "benchmark" / "traffic" / "ensemble_e4.json").write_text(
        json.dumps({"loop": "ensemble", "members": 4, "segment_steps": 1,
                    "perturbation": 0.02, "check_steps": 1,
                    "check_members": 2, "trace_segments": 1}))
    (root / "benchmark" / "limits" / "hybrid_ens4.json").write_text(
        (root / "benchmark" / "limits" / "hybrid_ens256.json").read_text())
    (root / "benchmark" / "metrics" / "steps_done.ens4.py").write_text(
        "def read(run):\n    return run.values.get('steps')\n")
    spec["workloads"].append({"name": "hybrid_ens4", "config": "hybrid_t30l8",
                              "traffic": "ensemble_e4", "chips": 1,
                              "why": "four members"})
    spec["per_layer"].append({"name": "steps_done.ens4", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "ensemble loop host boundary",
                              "moves": "sypd", "workloads": ["hybrid_ens4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    from harness.cell import Cell
    cell = Cell("hybrid_ens4", str(root))
    assert cell.traffic["members"] == 4
    assert [m["name"] for m in cell.per_layer] == ["steps_done.ens4"]
    run, correct = run_small("hybrid_ens4", 77, tmp_path, root=str(root),
                             size="hybrid_ens256")
    assert correct, run.numbers
    # the small size keeps its own member count; the new mix's others hold
    assert run.cell.traffic["perturbation"] == 0.02
    assert cell.reader("steps_done.ens4")(run) == run.values["steps"] > 0
    after = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
             if p.is_file() and p in before}
    assert after == before
