"""A cell of the benchmark found by its name, and the state of one run.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
`BENCHMARK.json` gives it:

  configs/<config>.json      the configuration as it is run
  traffic/<traffic>.json     the traffic mix; its "loop" names the module
                             of harness/loops/ that runs it
  limits/<workload>.json     the limit of each number the check compares
  metrics/<metric>.py        the reader of one per-layer metric
"""

from __future__ import annotations

import importlib.util
import json
import os
from collections import defaultdict

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of `workloads` with its configuration, traffic, limits
    and the metrics it reports."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        bench = os.path.join(root, "benchmark")
        spec = _json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in spec["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        conf = [c for c in spec["configs"]
                if c["name"] == self.workload["config"]][0]
        self.config = _json(os.path.join(root, conf["file"]))
        self.traffic = _json(os.path.join(
            bench, "traffic", self.workload["traffic"] + ".json"))
        self.limits = _json(os.path.join(bench, "limits", name + ".json"))
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]

    def reader(self, metric: str):
        """The `read(run)` function of a per-layer metric."""
        path = os.path.join(self.root, "benchmark", "metrics",
                            metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Run:
    """What one run of a cell measured and compared.

    spans: name -> list of readings (ms), recorded by the benchmark around
    calls into the program; trace: the profiler's summary of the traced
    slice (harness/trace.py); work: the counted operations and bytes of one
    step (harness/work.py); numbers: what the check compared."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, tmp: str, variant: str | None = None):
        self.cell = cell
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.tmp = tmp
        # a lower-precision path of the program switched on (the check's
        # control); None in every run of the benchmark itself
        self.variant = variant
        self.spans = defaultdict(list)
        self.values = {}        # run-level readings: e2e and helpers
        self.trace_summary = None
        self.work = None
        self.numbers = {}
        self.attempted = 0
        self.failed = 0
