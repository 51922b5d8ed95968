#!/usr/bin/env python3
"""Time of the sharded reservoir training drive at 1, 2 and 4 ranks.

    python3 scripts_torch/bench_scaling.py [--backend gloo] [--cpu]

Each rank count starts that many processes (speedyml_torch.parallel.launch)
with regions split over dp, and times the drive and the compensated fold of
the same series (speedyml_torch.parallel.reservoir.drive_and_accumulate; on
the card the fold is the CUDA kernel) after one warm-up drive: ms per drive
over 3 drives, the slowest rank's, and the wall time relative to one rank.

Rank r runs on cuda:(r mod the visible GPUs), or on the CPU with --cpu. Ranks
that share one device measure how their work serializes on it, not how the
drive scales: with one GPU (or on the CPU, where all ranks share the same
cores) the expected curve is a flat or rising wall time, since the work is
fixed and the parallelism is simulated; what such a run checks is that the
sharded drive has no hidden serialization or replication blow-up. Scaling
needs one GPU per rank (and NCCL). NCCL refuses two ranks on one GPU: ranks
that share one need --backend gloo. The backend is never changed for the
caller.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from speedyml_torch.device import script_device  # noqa: E402

R, N_IN, N_OUT, T, CHUNK = 32, 48, 16, 64, 16
SEED = 0
RANKS = (1, 2, 4)
REPS = 3


def _bench_rank(rank, world, device):
    """One rank of `world`: the drive over this rank's regions, timed."""
    import torch.distributed as dist

    from speedyml_torch.ops import accum
    from speedyml_torch.parallel import reservoir as pres
    from speedyml_torch.parallel.mesh import (make_mesh, series_sharding,
                                              shard, shard_params)
    from speedyml_torch.reservoir.generate import generate_esn

    mesh = make_mesh(world, tp=1)
    params = generate_esn(SEED, R, N_IN, N_OUT, n_model=N_OUT,
                          m_target=4 * N_IN, deg=4, device=device)
    g = torch.Generator(device=device).manual_seed(SEED)
    series = series_sharding(mesh)
    u, y, m = (shard(torch.randn((T, R, k), generator=g, device=device),
                     series) for k in (N_IN, N_OUT, N_OUT))
    sp = shard_params(params, mesh)

    def drive():
        acc = pres.init_normal_eq(sp, N_OUT, N_OUT, mesh)
        acc = pres.drive_and_accumulate(sp, acc, u, y, m, mesh, chunk=CHUNK)
        float(acc.ss_hi[0, 0, 0])            # waits for the device

    drive()
    dist.barrier()
    launches = accum.accumulate_ss_scan.launches
    t0 = time.perf_counter()
    for _ in range(REPS):
        drive()
    ms = 1e3 * (time.perf_counter() - t0) / REPS
    return dict(ms=ms, launches=(accum.accumulate_ss_scan.launches
                                 - launches) // REPS)


def main(argv=None) -> int:
    from speedyml_torch.parallel.launch import run_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the CPU (needs --backend gloo)")
    args = ap.parse_args(argv)
    dev = script_device(args.cpu)
    gpus = torch.cuda.device_count() if dev.type == "cuda" else 0
    results = {}
    shared = False
    for nd in RANKS:
        devices = ([f"cuda:{r % gpus}" for r in range(nd)] if gpus
                   else ["cpu"] * nd)
        # CPU ranks split the host's cores between them: oversubscribed
        # threads would measure their contention
        threads = None if gpus else max(1, (os.cpu_count() or 1) // nd)
        out = run_ranks(_bench_rank, nd, args.backend, devices,
                        threads=threads)
        results[nd] = max(o["ms"] for o in out)
        per_dev = -(-nd // gpus) if gpus else nd
        shared = shared or per_dev > 1
        print(f"ranks={nd}: {results[nd]:8.1f} ms/drive (regions/rank: "
              f"{R // nd}, ranks per device: {per_dev}, kernel launches "
              f"per rank: {out[0]['launches']}, {args.backend}, "
              f"{devices[0].split(':')[0]})", flush=True)
    base = results[RANKS[0]]
    print(f"relative wall vs {RANKS[0]} rank:",
          {k: round(v / base, 3) for k, v in results.items()})
    if max(results.values()) >= 2.0 * base:
        print("WARNING: sharded execution much slower than one rank")
    elif shared:
        print("OK: no serialization blow-up (ranks share a device: not a "
              "scaling figure)")
    else:
        print("OK: sharded execution scales without serialization blow-up")
    return 0


if __name__ == "__main__":
    sys.exit(main())
