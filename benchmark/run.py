#!/usr/bin/env python3
"""Run one cell of speedyml_torch's benchmark once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. With --trace 0 the result line carries the
cell's end-to-end metrics, with --trace 1 its per-layer metrics. See
benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# kernel and build caches of the program and of torch at fixed paths inside
# the checkout, so that only a checkout's first run builds anything
CACHE = os.path.join(HERE, ".cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = os.path.join(CACHE, sub)
# one process with few threads: the host work is small arrays
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
