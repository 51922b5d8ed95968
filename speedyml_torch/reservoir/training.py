"""Ridge-regression training of the batched reservoirs (PyTorch port of
speedyml/reservoir/training.py).

  * The reservoir runs over the training series in a Python loop, one
    segment of whole chunks at a time (fold_segment: the kernel's own
    segment on the card); each segment's augmented states [model; x~] are
    folded into the normal equations `ss += aug^T aug` by the
    compensated-accumulation kernel (ops/accum.py), chunk by chunk, into an
    (hi, lo) f32 pair per entry (~2^-48 effective precision from f32
    arithmetic), so memory does not grow with the series. The small
    `sy += target^T aug` fold stays a plain einsum.
  * Multiplicative Gaussian input noise (mod_utilities.f90:1387-1410) comes
    from a torch.Generator.
  * The ridge system is assembled and solved in float64 on the tensors'
    device with a Cholesky factorization.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..ops.accum import (SCRATCH_BYTES, _two_sum_, accumulate_ss_scan,
                         segment_steps)
from .esn import EsnParams, advance, nonlinear_state


class NormalEq(NamedTuple):
    ss_hi: torch.Tensor   # (R, na, na) sum of aug aug^T (leading part)
    ss_lo: torch.Tensor   # compensation part
    sy_hi: torch.Tensor   # (R, n_out, na) sum of target aug^T
    sy_lo: torch.Tensor
    x: torch.Tensor       # (R, n) carried reservoir state


def init_normal_eq(params: EsnParams, n_out: int,
                   dtype: torch.dtype = torch.float32) -> NormalEq:
    R = params.win.shape[0]
    na = params.n_model + params.n
    dev = params.win.device

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=dev)
    return NormalEq(ss_hi=z(R, na, na), ss_lo=z(R, na, na),
                    sy_hi=z(R, n_out, na), sy_lo=z(R, n_out, na),
                    x=z(R, params.n))


def block_generator(device, seed: int, bi: int, k: int) -> torch.Generator:
    """Noise stream k of region block bi: a pure function of (seed, bi, k),
    so a training run that skips blocks it finds finished changes no other
    block's noise."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + bi) * 2 + k)


def _add_noise(inputs, noise_mag: float, generator: torch.Generator):
    noise = torch.randn(inputs.shape, generator=generator,
                        dtype=inputs.dtype, device=inputs.device)
    return inputs + noise * noise_mag * inputs


def fold_segment(R: int, na: int, chunk: int, device) -> int:
    """Time steps driven and folded at a time by drive_and_accumulate: a
    multiple of `chunk` and of the kernel's 32-step stage. On the card it is
    the kernel's own segment (ops.accum.segment_steps) where that is a
    multiple of chunk, so that the segmented fold issues the launches of one
    call over the whole series; else the least multiple of both, or, where
    that passes four kernel segments, the most steps of lcm(chunk, 32) that
    one kernel segment holds. Elsewhere: the steps of aug that SCRATCH_BYTES
    holds, in whole chunks."""
    if torch.device(device).type == "cuda":
        kseg = segment_steps(R, na)
        both = math.lcm(kseg, chunk)
        if both <= 4 * kseg:
            return both
        base = math.lcm(chunk, 32)
        return max(base, kseg // base * base)
    steps = SCRATCH_BYTES // (4 * R * na)
    return max(chunk, steps // chunk * chunk)


def drive_and_accumulate(params: EsnParams, acc: NormalEq, inputs, targets,
                         model_states=None, noise_mag: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         chunk: int = 128, step=advance,
                         regions: slice = slice(None)) -> NormalEq:
    """Run the reservoir over a training series, accumulating normal equations.

    inputs:  (T, R, n_in) standardized input series u(t), t = 0..T-1
    targets: (T, R, n_out) truth at t+1 (already shifted by the caller)
    model_states: (T, R, n_model) imperfect-model forecast valid at t+1
    noise_mag: multiplicative input noise magnitude (training only)
    chunk: timesteps per fold; T is truncated to a multiple of chunk. The
    series is driven and folded one fold_segment of whole chunks at a time,
    so memory does not grow with T.
    step(params, x, u): the reservoir update of the carried state acc.x
    (esn.advance); regions: the regions of the series and of x whose
    states the accumulators fold (all of them). The sharded drive
    (parallel.reservoir) passes an update that gathers the node blocks and
    its tp rank's share of the regions.

    The (state-after-u(t), target(t+1)) pairing matches the reference's
    chunked layer (mod_reservoir.f90:1004-1065). acc's four accumulators
    are updated in place; the returned NormalEq holds them and the new x.
    """
    dt = acc.x.dtype
    inputs = inputs.to(dt)
    targets = targets.to(dt)
    if model_states is not None:
        model_states = model_states.to(dt)
    if noise_mag > 0.0:
        if generator is None:
            raise ValueError("noise_mag > 0 needs a generator")
        inputs = _add_noise(inputs, noise_mag, generator)

    T = inputs.shape[0]
    chunk = min(chunk, T)
    nchunks = T // chunk
    if nchunks == 0:
        raise ValueError(f"no training data: T={T} < chunk={chunk}")
    Tc = nchunks * chunk

    n_model = 0 if model_states is None else model_states.shape[-1]
    R, _, na = acc.ss_hi.shape
    segment = fold_segment(R, na, chunk, acc.x.device)
    # the augmented states [model; x~] of one segment at a time
    buf = torch.empty((min(segment, Tc), R, na), dtype=dt,
                      device=acc.x.device)
    x = acc.x
    for s0 in range(0, Tc, segment):
        s1 = min(s0 + segment, Tc)
        aug = buf[:s1 - s0]
        if model_states is not None:
            aug[:, :, :n_model] = model_states[s0:s1, regions]
        for t in range(s0, s1):
            x = step(params, x, inputs[t])
            aug[t - s0, :, n_model:] = nonlinear_state(x[regions])
        for c0 in range(0, s1 - s0, chunk):
            sy_d = torch.einsum("tro,tra->roa",
                                targets[s0 + c0:s0 + c0 + chunk, regions],
                                aug[c0:c0 + chunk])
            _two_sum_(acc.sy_hi, acc.sy_lo, sy_d)
        accumulate_ss_scan(acc.ss_hi, acc.ss_lo, aug, chunk)
    return acc._replace(x=x)


def drive_discard(params: EsnParams, x, inputs, noise_mag: float = 0.0,
                  generator: Optional[torch.Generator] = None):
    """Discard/spin-up phase: advance only (mod_reservoir.f90:983-996)."""
    inputs = inputs.to(x.dtype)
    if noise_mag > 0.0:
        if generator is None:
            raise ValueError("noise_mag > 0 needs a generator")
        inputs = _add_noise(inputs, noise_mag, generator)
    for u in inputs:
        x = advance(params, x, u)
    return x


def _ridge_diag_rhs(ss, sy, n_model: int, beta_res: float,
                    beta_model: float, prior_val: float, use_prior: bool):
    """Add the beta diagonal (beta with no prior, beta^2 with one;
    fit_chunk_hybrid, mod_reservoir.f90:1235-1334) and the prior RHS.
    ss and sy are updated in place and returned."""
    na = ss.shape[-1]
    diag = torch.full((na,), beta_res if not use_prior else beta_res**2,
                      dtype=ss.dtype, device=ss.device)
    if n_model > 0:
        diag[:n_model] = beta_model if not use_prior else beta_model**2
    ss.diagonal(dim1=-2, dim2=-1).add_(diag)
    if use_prior and n_model > 0:
        k = min(n_model, sy.shape[1])
        sy.diagonal(dim1=-2, dim2=-1)[:, :k] += prior_val * beta_model**2
    return ss, sy


def ridge_solve(acc: NormalEq, n_model: int, beta_res: float,
                beta_model: float, prior_val: float = 0.0,
                use_prior: bool = False) -> torch.Tensor:
    """Solve (SS + B) Wout^T = SY^T per region in float64 on acc's device
    (fit_chunk_hybrid/ml, mod_reservoir.f90:1177-1334) by Cholesky.

    Returns wout (R, n_out, na) float64.
    """
    f64 = torch.float64
    ss = acc.ss_hi.to(f64)
    ss += acc.ss_lo
    sym = ss + ss.mT                           # exact symmetry for Cholesky
    del ss
    sym *= 0.5
    sy = acc.sy_hi.to(f64)
    sy += acc.sy_lo
    sym, sy = _ridge_diag_rhs(sym, sy, n_model, beta_res, beta_model,
                              prior_val, use_prior)
    chol = torch.linalg.cholesky(sym)
    del sym
    wt = torch.cholesky_solve(sy.mT, chol)     # (R, na, n_out)
    return wt.mT
