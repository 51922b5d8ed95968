"""Device mesh, placements and the sharding of the batched reservoirs
(PyTorch port of speedyml/parallel/mesh.py).

The replacement of the reference's MPI layer (src/mpires.f90,
src/res_domain.f90 processor_decomposition): the region batch axis R is
split over the mesh axis "dp", the reservoir node axis over "tp", and the
global supervector is replicated.

Mesh axes:
  dp: regions (independent reservoirs, res_domain.f90:31-94)
  tp: reservoir nodes (rows of A and win, the matching columns of wout)

Where the JAX package names a sharding for XLA to honour, here a
`Placement` says how a whole tensor lies across the mesh, and a rank holds
its own block of it: `shard(a, placement)` cuts that block from the whole
and `gather(block, placement)` rebuilds the whole with all-gathers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..reservoir.esn import EsnParams
from .comm import Communicator


class Mesh:
    """A DeviceMesh of every rank of the default group (one process per
    rank), its axes named, with one Communicator per axis. `shape` maps
    axis name -> size, as the JAX Mesh's does. device_type is the mesh's
    (None: "cuda" under NCCL, else "cpu"); the collectives follow their
    tensors' devices."""

    def __init__(self, shape, axis_names, device_type: Optional[str] = None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} for axes {axis_names}")
        if math.prod(shape) != dist.get_world_size():
            raise ValueError(f"a {shape} mesh over "
                             f"{dist.get_world_size()} ranks")
        if device_type is None:
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        ranks = torch.arange(math.prod(shape)).reshape(shape)
        self.device_mesh = DeviceMesh(device_type, ranks,
                                      mesh_dim_names=tuple(axis_names))
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.comms = {a: Communicator(self.device_mesh.get_group(a))
                      for a in self.axis_names}

    def coord(self, axis: str) -> int:
        """This rank's index along `axis`."""
        return self.device_mesh.get_local_rank(axis)

    def comm(self, axis: str) -> Communicator:
        return self.comms[axis]


def make_mesh(n_devices: Optional[int] = None, tp: int = 1,
              device_type: Optional[str] = None) -> Mesh:
    """A (dp, tp) mesh over the n_devices ranks (by default, and
    necessarily, all) of the initialized default group."""
    if n_devices is None:
        n_devices = dist.get_world_size()
    if n_devices % tp:
        raise ValueError(f"tp={tp} does not divide {n_devices} ranks")
    return Mesh((n_devices // tp, tp), ("dp", "tp"), device_type)


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a whole tensor lies across `mesh` (the JAX PartitionSpec):
    spec[d] is None for a dimension every rank holds whole, or the mesh
    axes, major first, whose ranks split dimension d into equal blocks.
    Dimensions past the spec are whole."""

    mesh: Mesh
    spec: tuple

    def axes(self, d: int) -> tuple:
        a = self.spec[d]
        return () if a is None else (a,) if isinstance(a, str) else tuple(a)


def _block(placement: Placement, d: int, size: int):
    """(start, length) of this rank's block of dimension d (of `size`)."""
    mesh, axes = placement.mesh, placement.axes(d)
    parts, index = 1, 0
    for a in axes:
        parts *= mesh.shape[a]
        index = index * mesh.shape[a] + mesh.coord(a)
    if size % parts:
        raise ValueError(f"{parts} blocks do not divide {size} "
                         f"(axes {axes})")
    return index * (size // parts), size // parts


def shard(a: torch.Tensor, placement: Placement) -> torch.Tensor:
    """This rank's block of the whole tensor `a` (a contiguous copy)."""
    for d in range(len(placement.spec)):
        if placement.axes(d):
            start, length = _block(placement, d, a.shape[d])
            a = a.narrow(d, start, length)
    return a.contiguous()


def gather(block: torch.Tensor, placement: Placement) -> torch.Tensor:
    """The whole tensor from every rank's block: one all-gather per
    splitting axis, minor axis first."""
    for d in range(len(placement.spec)):
        for a in reversed(placement.axes(d)):
            block = placement.mesh.comm(a).all_gather(block, dim=d)
    return block


def region_sharding(mesh: Mesh) -> Placement:
    """(R, ...) tensors split over regions."""
    return Placement(mesh, ("dp",))


def state_sharding(mesh: Mesh) -> Placement:
    """Reservoir state (R, n): regions over dp, nodes over tp."""
    return Placement(mesh, ("dp", "tp"))


def series_sharding(mesh: Mesh) -> Placement:
    """Training series (T, R, n_in): time whole, regions over dp."""
    return Placement(mesh, (None, "dp"))


def fold_sharding(mesh: Mesh) -> Placement:
    """The normal equations (R, ...) of the sharded fold: a dp block's
    regions split again over its tp ranks (parallel.reservoir)."""
    return Placement(mesh, (("dp", "tp"),))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def shard_params(params: EsnParams, mesh: Mesh) -> EsnParams:
    """This rank's part of the batched ESN parameters: its dp block of
    regions; of those, its tp block of node rows of a_idx, a_val and win
    (a_idx keeps the whole node numbering: x is gathered over tp before
    each advance); wout's columns for its nodes, tp rank 0 also holding the
    model part of the augmented axis, so that the tp ranks' partial
    readouts sum to the whole; node_map and a_shift whole."""
    n_model = params.n_model
    n = params.n
    regions = region_sharding(mesh)
    rows = state_sharding(mesh)
    n0, nl = _block(rows, 1, n)
    wout = shard(params.wout, regions)
    cols = [wout[..., n_model + n0:n_model + n0 + nl]]
    if mesh.coord("tp") == 0:
        cols.insert(0, wout[..., :n_model])
    return EsnParams(
        a_idx=shard(params.a_idx, rows),
        a_val=shard(params.a_val, rows),
        win=shard(params.win, rows),
        wout=torch.cat(cols, dim=-1),
        node_map=params.node_map,
        leakage=params.leakage,
        a_shift=params.a_shift)
