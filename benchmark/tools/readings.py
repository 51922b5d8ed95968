#!/usr/bin/env python3
"""The numbers a cell's check compares, over many seeds in one process: the
readings that its limits are set from.

    python3 benchmark/tools/readings.py --workload <name> \
        --seeds 11,12,13 [--variant bf16_wout|bf16_grid] [--seconds 8]

Each seed makes its inputs anew and runs the cell's set-up, a short window
at the cell's own load and its check, as a run of benchmark/run.py does.
--variant switches a lower-precision path of the program on: the control,
which the check has to fail. One JSON line per seed on standard output.
Needs the card.
"""

import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")


def main(argv):
    import argparse

    from harness.cell import Cell, Run
    from harness.cli import device_for, execute

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variant", default=None)
    p.add_argument("--seconds", type=float, default=8.0)
    a = p.parse_args(argv)
    cell = Cell(a.workload)
    dev = device_for(cell)
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
            run = Run(cell, seed, a.seconds, False, dev, tmp, a.variant)
            execute(run)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "variant": a.variant, "numbers": run.numbers,
                          "steps": run.values.get("steps"),
                          "sypd": run.values.get("sypd"),
                          "pace": run.values.get("pace"),
                          "activity": run.values.get("activity"),
                          "failed": run.failed,
                          "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
