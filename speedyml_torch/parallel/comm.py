"""The layer's one communicator: all_reduce and all_gather over a process
group, counted.

These two are the JAX layer's collectives: the psum of the forward Legendre
transform and the all-gathers XLA inserts. Both backends have them for the
tensors the layer passes: NCCL for CUDA tensors on distinct GPUs, gloo for
CPU tensors and, where the caller asks for it by name, for CUDA tensors of
ranks that share one GPU (NCCL refuses two ranks on one device). The backend
is the caller's: nothing here picks another one.

Each communicator counts its calls, the payload bytes this rank puts in
(the reduced tensor; the gathered block) and the host seconds spent inside
the calls, by kind, so that a caller can read the collectives of one step.
The seconds include the wait for the device to finish the input: a
collective's host call returns when its result is ready (gloo) or queued
behind it (NCCL).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "all_gather")

class Communicator:
    """all_reduce and all_gather over `group` (None: the default group)."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        self.reset()

    def reset(self) -> None:
        self.calls = dict.fromkeys(KINDS, 0)
        self.bytes = dict.fromkeys(KINDS, 0)
        self.seconds = dict.fromkeys(KINDS, 0.0)

    def _count(self, kind: str, t: torch.Tensor, t0: float) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += t.numel() * t.element_size()
        self.seconds[kind] += time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the group. A contiguous t is summed in place;
        the result is returned."""
        t = t.contiguous()
        t0 = time.perf_counter()
        dist.all_reduce(t, group=self.group)
        self._count("all_reduce", t, t0)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's t (all of one shape), concatenated along `dim` in
        the group's rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        t0 = time.perf_counter()
        dist.all_gather(parts, t, group=self.group)
        self._count("all_gather", t, t0)
        return torch.cat(parts, dim=dim)


def counts(*comms: Communicator) -> dict:
    """The calls and bytes of several communicators, summed by kind:
    {kind: {"calls": n, "bytes": b}}."""
    return {k: {"calls": sum(c.calls[k] for c in comms),
                "bytes": sum(c.bytes[k] for c in comms)} for k in KINDS}
