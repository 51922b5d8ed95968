"""Linear-algebra utilities with reference-parity semantics (the port's
counterpart of speedyml/reservoir/linalg.py).

The reference's mod_linalg.f90 wraps LAPACK/MKL/ARPACK; the batched trainer
(reservoir.training) replaces the hot paths, but these direct equivalents
are kept for tooling and interchange:
  mldivide : solve A^T X = B^T and return X^T (mod_linalg.f90:109-151 dgesv)
  pinv_svd : SVD pseudo-inverse (mod_linalg.f90:27-107 dgesvd)
Both run in float64 on the device of their input tensors (arrays go to the
card unless `device` names another) and accept an optional leading batch
axis.
"""

from __future__ import annotations

import torch

from ..device import resolve_device


def _f64(a, device) -> torch.Tensor:
    """A tensor as float64 on its own device; an array on `device`."""
    if torch.is_tensor(a):
        return a.to(torch.float64)
    return torch.as_tensor(a, dtype=torch.float64,
                           device=resolve_device(device))


def mldivide(A, B, device: torch.device | str | None = None) -> torch.Tensor:
    """X such that X @ A = B, computed as solve(A^T, B^T)^T in float64
    (the reference's Wout = mldivide(SS^T, SY^T) convention)."""
    A64 = _f64(A, device)
    B64 = _f64(B, A64.device)
    return torch.linalg.solve(A64.mT, B64.mT).mT


def pinv_svd(A, rcond: float = 1e-15,
             device: torch.device | str | None = None) -> torch.Tensor:
    """Moore-Penrose pseudo-inverse via SVD in float64. Singular values at
    or below rcond times the largest are dropped (numpy's meaning of
    rcond)."""
    return torch.linalg.pinv(_f64(A, device), rtol=rcond)
