"""The batched reservoirs with regions over dp and nodes over tp: the
predict step and the training drive.

The JAX package leaves the node split to GSPMD (speedyml/parallel/mesh.py:
42-56: "XLA inserts a psum over tp"). Here each collective is written out:

  * advance: x is all-gathered over tp first, since a row of the sparse
    adjacency may read any node; each tp rank then advances its own rows
    with reservoir.esn.advance (its node offset n0);
  * readout: each tp rank reads out its columns of wout (tp rank 0 also the
    model part), and the partial readouts are all-reduced over tp. They sum
    in another order than the single-device product;
  * training: reservoir.training.drive_and_accumulate, driven as in
    predict; its fold takes the rank's tp share of the dp block's regions,
    so each tp rank folds whole regions with the unmodified compensated
    fold (ops.accum: the CUDA kernel on the card) and the two-sum of sy,
    and the gathered accumulators and state equal the single-device fold.

Tensors are this rank's blocks (parallel.mesh placements): x
state_sharding (regions over dp, nodes over tp); inputs, targets and model
states series_sharding or region_sharding (regions over dp); the normal
equations fold_sharding.
"""

from __future__ import annotations

import torch

from ..reservoir import esn, training
from ..reservoir.esn import EsnParams
from ..reservoir.training import NormalEq
from .mesh import Mesh, _block, fold_sharding, state_sharding


def _node_rows(params: EsnParams, mesh: Mesh):
    """(n0, nl): this rank's first node and node count."""
    return _block(state_sharding(mesh), 1, params.node_map.shape[0])


def advance(params: EsnParams, x, u, mesh: Mesh):
    """One reservoir update of this rank's nodes: x all-gathered over tp,
    then this rank's rows advanced (reservoir.esn.advance on a node
    block)."""
    n0, _ = _node_rows(params, mesh)
    x_full = mesh.comm("tp").all_gather(x, dim=-1)
    return esn.advance(params, x_full, u, n0)


def readout(params: EsnParams, x, model_vec, mesh: Mesh):
    """outvec = Wout @ [model_vec; x~] from this rank's columns, the
    partial products all-reduced over tp (model_vec is read on tp rank 0
    only, which holds the model columns)."""
    n0, _ = _node_rows(params, mesh)
    return mesh.comm("tp").all_reduce(esn.readout(params, x, model_vec, n0))


def predict_step(params: EsnParams, x, feedback, model_vec, mesh: Mesh):
    """One prediction step (reservoir.esn.predict_step) on this rank's
    block: returns (x, out) with out (regions of the dp block, n_out),
    the same on every tp rank."""
    x = advance(params, x, feedback, mesh)
    return x, readout(params, x, model_vec, mesh)


def init_normal_eq(params: EsnParams, n_out: int, n_model: int, mesh: Mesh,
                   dtype: torch.dtype = torch.float32) -> NormalEq:
    """Zero accumulators of this rank's fold regions (fold_sharding) at the
    whole augmented width n_model + n, and a zero state block."""
    R = params.win.shape[0]
    _, rf = _block(fold_sharding(mesh), 0, R * mesh.shape["dp"])
    na = n_model + params.node_map.shape[0]
    dev = params.win.device

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=dev)
    return NormalEq(ss_hi=z(rf, na, na), ss_lo=z(rf, na, na),
                    sy_hi=z(rf, n_out, na), sy_lo=z(rf, n_out, na),
                    x=z(R, params.win.shape[-1]))


def drive_and_accumulate(params: EsnParams, acc: NormalEq, inputs, targets,
                         model_states, mesh: Mesh,
                         chunk: int = 128) -> NormalEq:
    """reservoir.training.drive_and_accumulate (without input noise) on
    this rank's blocks: inputs (T, Rb, n_in), targets (T, Rb, n_out) and
    model_states (T, Rb, n_model) or None for the rank's dp block of Rb
    regions; acc from init_normal_eq. The state advances over all of the
    block's regions, gathered over tp; the fold takes the rank's tp share
    of them, whole. acc's four accumulators are updated in place."""
    n0, nl = _node_rows(params, mesh)
    Rb = inputs.shape[1]
    tp, j = mesh.shape["tp"], mesh.coord("tp")
    rf = acc.ss_hi.shape[0]
    if rf * tp != Rb:
        raise ValueError(f"{tp} tp ranks fold {rf} of {Rb} regions each")
    gather_tp = mesh.comm("tp").all_gather

    def step(p, x_full, u):
        return gather_tp(esn.advance(p, x_full, u, n0), dim=-1)

    acc = training.drive_and_accumulate(
        params, acc._replace(x=gather_tp(acc.x, dim=-1)), inputs, targets,
        model_states, chunk=chunk, step=step,
        regions=slice(j * rf, (j + 1) * rf))
    return acc._replace(x=acc.x[..., n0:n0 + nl].contiguous())
