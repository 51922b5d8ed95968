"""One run of one cell: set-up, the measured window, the traced slice (with
--trace 1), the check against the reference, and the result line.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, breakdown (traced runs), pace and activity
(readings the check does not judge) and, last, the numbers the check
compared with their limits. The same numbers are the last lines of
standard error.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import sys
import tempfile

from .cell import Cell, Run

FORBIDDEN = ("jax", "jaxlib", "flax", "speedyml")


def loaded_forbidden() -> list:
    """Modules whose top-level name (the part before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_for(cell: Cell):
    """The card, or an exit without a result when the machine has fewer
    cards than the cell asks for."""
    import torch

    need = cell.workload["chips"]
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card")
    if torch.cuda.device_count() < need:
        raise SystemExit(f"{cell.name} needs {need} cards, the machine has "
                         f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def execute(run: Run):
    loop = importlib.import_module(
        "harness.loops." + run.traffic["loop"])
    loop.execute(run)


def metrics_of(run: Run, t_start: float) -> dict:
    cell = run.cell
    out = {}
    if run.trace:
        for m in cell.per_layer:
            v = cell.reader(m["name"])(run)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
    vals = dict(run.values)
    vals["setup_s"] = vals["setup_end"] - t_start
    for m in cell.end_to_end:
        if m["name"] in vals:
            out[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    return out


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = Cell(args.workload)
    # the system under test: a checkout without it has nothing to measure
    import speedyml_torch  # noqa: F401
    import torch

    dev = device_for(cell)

    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        run = Run(cell, args.seed, args.seconds, bool(args.trace), dev, tmp)
        execute(run)
    found = loaded_forbidden()
    if found:
        print("modules of jax or of the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    run.values["kind"] = torch.cuda.get_device_name(dev)
    metrics = metrics_of(run, t_start)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.workload["chips"],
              "memory_peak_bytes": run.values.get("memory_peak_bytes")}
    line = {"correct": None, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.trace_summary is not None:
        device["busy_s"] = run.trace_summary["busy_s"]
        device["window_s"] = run.trace_summary["window_s"]
        line["breakdown"] = {"device_ops": run.trace_summary["device_ops"],
                             "idle_gaps": run.trace_summary["idle_gaps"]}
    # readings beside the metrics, which the check does not judge: the
    # window's pace a step (harness/pace.py) and the share of columns in
    # which the reference's windows rained (convection, condensation)
    for key in ("pace", "activity"):
        if key in run.values:
            line[key] = run.values[key]
            print(key, json.dumps(run.values[key]), file=sys.stderr)
    line["correct"] = _verdict(run)
    line["checks"] = {k: {"value": _plain(run.numbers.get(k)), "limit": v}
                      for k, v in sorted(cell.limits.items())}
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


def _plain(v):
    """A number as JSON holds it: None for one that is not finite."""
    return v if v is None or math.isfinite(v) else None


def _verdict(run: Run) -> bool:
    from .checks import verdict

    return verdict(run.numbers, run.cell.limits) and run.failed == 0
