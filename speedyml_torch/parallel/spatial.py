"""The latitude-sharded SPEEDY step (PyTorch port of
speedyml/parallel/spatial.py).

Every rank of a mesh axis holds the whole spectral state (31 x 2 x 32 per
field and level, ~8 kB) and one block of latitude rows of every grid field:

  * inverse transforms (spec -> grid) are local: each rank contracts the
    replicated coefficients against its own rows of the Legendre operator;
  * forward transforms (grid -> spec) contract the local rows and
    all-reduce the partial coefficients over the axis: the step's only
    collective, four per dycore step (grtend's psdt, its two vdspec
    transforms and the batched kinetic-energy/temperature/tracer one);
  * all grid-space tendency and physics work is pointwise in latitude, so
    there is no halo exchange (spectral models take horizontal
    derivatives spectrally).

The JAX package runs this inside one shard_map; here each rank calls the
same step functions on a shallow copy of the dycore and the physics whose
transform and latitude constants are its own rows (`_localize_dycore`,
`_localize_physics`).
"""

from __future__ import annotations

import copy

import torch

from ..physics.driver import phys_hook
from ..transforms.spectral import SpectralTransform
from .comm import Communicator
from .mesh import Mesh


class LatLocalTransform(SpectralTransform):
    """A SpectralTransform whose grid and Fourier tensors hold latitude rows
    j0 .. j0 + jl of this rank only; spectral tensors are whole. The
    spectral operators and the DFT are the wrapped transform's; the
    Legendre operators and cosgr, cosgr2 and coriol are this rank's rows,
    and fourier_to_spec all-reduces its partial contraction over `comm`.
    `il` stays the whole grid's, `jl` is the block's."""

    def __init__(self, T: SpectralTransform, comm: Communicator,
                 n_shards: int, shard: int):
        if T.il % n_shards:
            raise ValueError(f"{n_shards} shards do not divide il={T.il}")
        self.__dict__.update(T.__dict__)
        self.comm = comm
        self.jl = T.il // n_shards
        j0 = shard * self.jl
        rows = slice(j0, j0 + self.jl)
        self.leg_inv = T.leg_inv[..., rows].contiguous()
        self.leg_fwd = T.leg_fwd[..., rows].contiguous()
        self.cosgr = T.cosgr[rows]
        self.cosgr2 = T.cosgr2[rows]
        self.coriol = T.coriol[rows]

    def fourier_to_spec(self, fourier):
        """Partial Legendre contraction over the local rows, all-reduced
        over the latitude axis."""
        return self.comm.all_reduce(super().fourier_to_spec(fourier))


def _localize_dycore(dy, comm: Communicator, n_shards: int, shard: int):
    """Shallow Dycore copy whose transform is this rank's
    LatLocalTransform (the tendencies read coriol from the transform)."""
    loc = copy.copy(dy)
    loc.T = LatLocalTransform(dy.T, comm, n_shards, shard)
    return loc


def _localize_physics(phys, n_shards: int, shard: int):
    """Shallow Physics copy with this rank's rows of its latitude constants
    (clat, forog, fmask1, phis0; no other table of the physics has a
    latitude axis)."""
    loc = copy.copy(phys)
    jl = phys.clat.shape[0] // n_shards
    rows = slice(shard * jl, (shard + 1) * jl)
    for name in ("clat", "forog", "fmask1", "phis0"):
        setattr(loc, name, getattr(phys, name)[rows])
    return loc


def _lat_axis(a, il: int):
    """The last axis of size il of a tensor, or None (ix != il on this grid,
    so the match is unambiguous)."""
    for ax in range(a.dim() - 1, -1, -1):
        if a.shape[ax] == il:
            return ax
    return None


def _map_tree(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, t) for t in tree)
    return tree


def lat_slice(tree, il: int, shard: int, n_shards: int):
    """This rank's latitude block of every tensor of a tree (NamedTuples,
    tuples, lists): each is cut on its last axis of size il, so (il,),
    (il, ix) and (..., il, ix) leaves alike; the rest pass whole (the JAX
    package's _lat_spec)."""
    jl = il // n_shards

    def cut(a):
        ax = _lat_axis(a, il)
        return a if ax is None else a.narrow(ax, shard * jl, jl)
    return _map_tree(cut, tree)


def lat_gather(tree, jl: int, comm: Communicator):
    """The whole of every tensor of a tree of latitude blocks (the inverse
    of lat_slice): each is all-gathered on its last axis of size jl."""
    def whole(a):
        ax = _lat_axis(a, jl)
        return a if ax is None else comm.all_gather(a, dim=ax)
    return _map_tree(whole, tree)


class SpatialDycore:
    """Step functions over a latitude-sharded mesh axis.

    Usage, on every rank of the axis: sd = SpatialDycore(dy, mesh, "lat");
    state = sd.step_fn()(state, forcing). The state and forcing are whole
    on every rank (they are small); grid-space work is split over the axis.
    """

    def __init__(self, dy, mesh: Mesh, axis: str = "lat", phys=None):
        self.dy = dy
        self.mesh = mesh
        self.axis = axis
        self.n = mesh.shape[axis]
        self.comm = mesh.comm(axis)
        self.phys = phys
        shard = mesh.coord(axis)
        self.shard = shard
        self.il = dy.config.il
        if self.il % self.n:
            raise ValueError(f"{self.n} shards do not divide il={self.il}")
        self.loc = _localize_dycore(dy, self.comm, self.n, shard)
        self.ploc = (None if phys is None
                     else _localize_physics(phys, self.n, shard))

    def step_fn(self, j1: int = 1, j2: int = 1, dt_key: str = "delt2"):
        """Dry-core step: (SpectralState, Forcing) -> SpectralState."""
        loc = self.loc

        def step(state, forcing):
            return loc.step(state, forcing, j1, j2, dt_key)
        return step

    def run_steps_fn(self, nsteps: int, dt_key: str = "delt2"):
        loc = self.loc

        def run(state, forcing):
            for _ in range(nsteps):
                state = loc.step(state, forcing, 1, 1, dt_key)
            return state
        return run

    def wrap_physics(self, lradsw: bool = True, j1: int = 1, j2: int = 1,
                     dt_key: str = "delt2"):
        """Full-physics step: (state, forcing, surf, rad) -> (state, rad,
        fluxes), surf and rad this rank's latitude blocks (shard_surface)
        and rad and fluxes returned as blocks. The JAX package derives the
        blocks' specs from example trees; here shard_surface cuts them."""
        if self.ploc is None:
            raise ValueError("pass phys= to shard physics")
        loc, ploc = self.loc, self.ploc

        def step(state, forcing, surf, rad):
            new_state, (rad_new, fluxes) = loc.step(
                state, forcing, j1, j2, dt_key,
                phys_hook(ploc, surf, rad, lradsw))
            return new_state, rad_new, fluxes
        return step

    def shard_surface(self, tree):
        """This rank's latitude block of a surf/rad/flux tree."""
        return lat_slice(tree, self.il, self.shard, self.n)

    def gather_surface(self, tree):
        """The whole tree from every rank's latitude blocks."""
        return lat_gather(tree, self.il // self.n, self.comm)
