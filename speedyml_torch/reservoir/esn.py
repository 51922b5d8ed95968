"""Batched echo-state-network core (PyTorch port of speedyml/reservoir/esn.py).

The 1152 independent region reservoirs are one batched computation with a
leading region axis R (the reference: one MPI rank per region,
src/mod_reservoir.f90).

Sparse adjacency is fixed-degree ELL, (R, n, deg) indices and values, with
two execution paths in `spmv_ell`:
  * generic ELL: a row gather and a small reduction;
  * circulant support (`a_shift` set): when node i connects to
    (i + s_d) mod n for deg shifts s_d shared by all regions, A @ x is deg
    shifted slices times values: contiguous memory traffic, no gather. The
    shifts are host ints, so the slices are plain views.

Win is block-diagonal with q = n / n_in contiguous nodes per input
(mod_reservoir.f90:262-283), so Win @ u is an elementwise multiply against
the input repeated q times.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils import diag


@dataclasses.dataclass
class EsnParams:
    """Batched reservoir parameters (leading axis R = regions)."""

    a_idx: torch.Tensor      # (R, n, deg) int64 column indices
    a_val: torch.Tensor      # (R, n, deg) adjacency values (radius-scaled)
    win: torch.Tensor        # (R, n) block-diagonal input weights
    wout: torch.Tensor       # (R, n_out, n_model + n) readout
    node_map: torch.Tensor   # (n,) int64: node -> input index
    leakage: float
    # shared circulant shifts when a_idx[r, i, d] == (i + s_d) % n for ALL
    # regions (enables the shifted-slice path); None for arbitrary ELL
    a_shift: Optional[tuple[int, ...]] = None

    @property
    def n(self) -> int:
        return self.win.shape[-1]

    @property
    def n_in(self) -> int:
        """Number of inputs (reads node_map back from the device)."""
        return int(self.node_map[-1]) + 1

    @property
    def q(self) -> int:
        """Nodes per input (n = q * n_in)."""
        return self.n // self.n_in

    @property
    def n_model(self) -> int:
        return self.wout.shape[-1] - self.win.shape[-1]


def spmv_ell(a_idx, a_val, x, a_shift=None, n0: int = 0):
    """Batched ELL sparse matvec: y[r, i] = sum_d val[r,i,d] * x[r, idx[r,i,d]].

    x: (..., R, N) -> (..., R, n); leading axes (ensemble members) share the
    matrices. a_idx and a_val hold the rows n0 .. n0 + n of the adjacency
    (all of them, n = N, on one device; a tp block of them in
    parallel.reservoir), x the whole state. With a_shift (deg host ints;
    idx[r,i,d] = (i + s_d) mod N) the gather becomes deg contiguous shifted
    slices.
    """
    R, n, deg = a_idx.shape
    if a_shift is not None:
        xx = torch.cat([x, x], dim=-1)             # (..., R, 2N) wraparound
        y = None
        for d, s in enumerate(a_shift):
            t = a_val[:, :, d] * xx[..., n0 + s:n0 + s + n]
            y = t if y is None else y + t
        return y
    idx = a_idx.reshape(R, n * deg).expand(*x.shape[:-1], n * deg)
    gathered = torch.gather(x, -1, idx).reshape(*x.shape[:-1], n, deg)
    return torch.sum(a_val * gathered, dim=-1)


def win_apply(params: EsnParams, u, n0: int = 0):
    """Win @ u via the block structure: node j gets input node_map[j]
    (params.win holds the nodes n0 .. n0 + n)."""
    node_map = params.node_map
    if n0 or node_map.shape[0] != params.n:
        node_map = node_map[n0:n0 + params.n]
    return params.win * torch.index_select(u, -1, node_map)


def advance(params: EsnParams, x, u, n0: int = 0):
    """One reservoir update x <- (1-l)x + l*tanh(A x + Win u)
    (mod_reservoir.f90:1418-1435).

    params may hold the node rows n0 .. n0 + n only (a tp block,
    parallel.mesh.shard_params) with x the whole state: then the new values
    of those rows are returned."""
    u = u.to(x.dtype)
    y = spmv_ell(params.a_idx, params.a_val, x, params.a_shift, n0)
    x_new = torch.tanh(y + win_apply(params, u, n0))
    if n0 or x.shape[-1] != params.n:
        x = x[..., n0:n0 + params.n]
    lk = params.leakage
    return (1.0 - lk) * x + lk * x_new


def nonlinear_state(x, n0: int = 0):
    """x~ with odd (0-based) nodes squared (the reference squares 1-based
    even indices, mod_reservoir.f90:1029); x holds the nodes n0.. ."""
    mask = (torch.arange(n0, n0 + x.shape[-1], device=x.device) % 2).to(
        x.dtype)
    return x * (1.0 - mask) + (x * x) * mask


def readout(params: EsnParams, x, model_vec=None, n0: int = 0):
    """outvec = Wout @ [model_vec; x~] (predict, mod_reservoir.f90:1446-1455).

    model_vec: (R, n_model) standardized imperfect-model forecast (hybrid) or
    None (ml_only; wout then has n_model == 0).

    wout may be stored in bfloat16 (cast_wout), which halves the largest
    weight stream of the predict step. Then aug is rounded to bf16 too, and
    the product accumulates and is returned in f32 (the JAX package's
    preferred_element_type). An f64 wout gives an f64 readout.

    x may hold the nodes n0.. only, and wout their columns (a tp block):
    the result is then that block's part of the readout.
    """
    xt = nonlinear_state(x, n0)
    if model_vec is not None and params.n_model > 0:
        aug = torch.cat([model_vec.to(xt.dtype), xt], dim=-1)
    else:
        aug = xt
    return _wout_matvec(params.wout, aug)


def _wout_matvec(w, v):
    """w (R, n_out, k) @ v (R, k) -> (R, n_out). A bf16 w takes v rounded to
    bf16 and sums in f32 (see readout). v (E, R, k), E ensemble members,
    gives (E, R, n_out) from ONE product (R, n_out, k) x (R, k, E): the
    weights are read once for all members."""
    if v.dim() == 3:
        return _wout_bmm(w, v.permute(1, 2, 0)).permute(2, 0, 1)
    return _wout_bmm(w, v[..., None])[..., 0]


def _wout_bmm(w, v):
    """w (R, n_out, k) @ v (R, k, m) -> (R, n_out, m), as _wout_matvec."""
    if w.dtype == torch.bfloat16:
        v16 = v.to(torch.bfloat16)
        if w.is_cuda:
            # cuBLAS reads the bf16 weights as they are and writes f32
            return torch.bmm(w, v16, out_dtype=torch.float32)
        # the CPU has no bf16 x bf16 -> f32 bmm; the f32 products of bf16
        # values are exact, so this is the same sum
        return torch.bmm(w.float(), v16.float())
    dt = torch.promote_types(w.dtype, v.dtype)
    return torch.bmm(w.to(dt), v.to(dt))


def readout_split(params: EsnParams, x, model_vec):
    """Readout decomposed into the SPEEDY (v_p) and reservoir (v_ml)
    contributions (mod_reservoir.f90:1458-1469), in standardized space.

    Returns (outvec, v_ml, v_p) with outvec = v_p + v_ml. The two partial
    products sum in another order than readout's single one, so outvec
    agrees with readout to rounding, not bitwise.
    """
    n_model = params.n_model
    v_ml = _wout_matvec(params.wout[..., n_model:], nonlinear_state(x))
    v_p = _wout_matvec(params.wout[..., :n_model], model_vec.to(x.dtype))
    return v_p + v_ml, v_ml, v_p


def cast_wout(params: EsnParams, dtype=torch.bfloat16) -> EsnParams:
    """Readout weights in reduced-precision storage; accumulation stays f32.
    Keep f32 for golden-value comparisons."""
    return dataclasses.replace(params, wout=params.wout.to(dtype))


def synchronize(params: EsnParams, x, inputs):
    """Drive the reservoir with a (T, R, n_in) series, no readout
    (mod_reservoir.f90:1354-1380)."""
    inputs = inputs.to(x.dtype)
    for u in inputs:
        x = advance(params, x, u)
    return x


def predict_step(params: EsnParams, x, feedback, model_vec=None):
    """One prediction step: advance with feedback, read out."""
    with diag.span("esn.advance", device=True):
        x = advance(params, x, feedback)
    with diag.span("esn.readout", device=True):
        return x, readout(params, x, model_vec)
