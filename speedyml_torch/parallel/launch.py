"""Start the ranks of a multi-device run: one process per rank.

`run_ranks` spawns `world` processes on this host (the `spawn` start
method: a parent that has initialized CUDA cannot fork), each on the device
the caller names for it, joined by a `file://` rendezvous in a temporary
directory. A rank that raises makes `run_ranks` raise with the traceback of
every rank that failed (a peer waiting in a collective may fail too, and
first); the other ranks are stopped. Under torchrun, `init_torchrun` joins
the group torchrun set up.

The backend is always the caller's: NCCL for CUDA ranks on distinct GPUs,
gloo for CPU ranks, and gloo for CUDA ranks that share one GPU, which NCCL
refuses. Nothing here retries with another backend or moves a rank to
another device.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException


def _join(backend: str, device: torch.device, init_method: str, world: int,
          rank: int) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # a collective that waits 15 minutes for its peers fails the rank
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=900))


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               devices: Sequence[str], tmp: str, args: tuple,
               threads) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    device = torch.device(devices[rank])
    try:
        _join(backend, device, f"file://{tmp}/rendezvous", world, rank)
        out = fn(rank, world, device, *args)
        torch.save(out, os.path.join(tmp, f"result{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, backend: str,
              devices: Sequence[str], args: tuple = (),
              threads: int | None = None) -> list:
    """Run fn(rank, world, device, *args) in `world` new processes, rank r
    on devices[r], and return the ranks' return values in rank order.

    fn must be importable by name (a module-level function) and its return
    value picklable; `threads` sets each rank's torch thread count. A rank
    that raises makes this raise a RuntimeError that holds the traceback of
    each rank that failed."""
    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices, got "
                         f"{list(devices)}")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(
                _rank_main, args=(fn, world, backend, tuple(devices), tmp,
                                  args, threads),
                nprocs=world, join=True, start_method="spawn")
        except ProcessException as e:
            failed = []
            for r in range(world):
                path = os.path.join(tmp, f"error{r}.txt")
                if os.path.exists(path):
                    with open(path) as f:
                        failed.append(f"rank {r}:\n{f.read()}")
            raise RuntimeError(
                f"{len(failed)} of {world} ranks failed ({backend}):\n"
                + "\n".join(failed)) from e
        return [torch.load(os.path.join(tmp, f"result{r}.pt"),
                           weights_only=False) for r in range(world)]


def init_torchrun(backend: str, device_type: str):
    """Join the group of a rank that torchrun started (its RANK, WORLD_SIZE,
    LOCAL_RANK and rendezvous variables). The rank's device is
    cuda:LOCAL_RANK, or the CPU where device_type is "cpu". Returns
    (rank, world, device)."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    device = (torch.device("cuda", int(os.environ["LOCAL_RANK"]))
              if device_type == "cuda" else torch.device(device_type))
    _join(backend, device, "env://", world, rank)
    return rank, world, device
