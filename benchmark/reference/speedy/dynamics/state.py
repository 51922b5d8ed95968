"""Prognostic spectral state as named tuples of tensors (PyTorch port of
speedyml/dynamics/state.py).

Spectral arrays are REAL with an (re, im) axis: (..., mx, 2, nx). The two
leapfrog time levels are a leading axis of size 2 (level 0 = "current",
level 1 = "new", the reference's F(1)/F(2)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device


class SpectralState(NamedTuple):
    """Leapfrog prognostic state (mod_dynvar.f90:9-33)."""

    vor: torch.Tensor   # (2, kx, mx, 2, nx) vorticity
    div: torch.Tensor   # (2, kx, mx, 2, nx) divergence
    t: torch.Tensor     # (2, kx, mx, 2, nx) absolute temperature
    ps: torch.Tensor    # (2, mx, 2, nx)     log(p_s / p0)
    tr: torch.Tensor    # (2, ntr, kx, mx, 2, nx) tracers (tracer 0: q, g/kg)

    def at_level(self, j: int) -> "PrognosticFields":
        return PrognosticFields(self.vor[j], self.div[j], self.t[j],
                                self.ps[j], self.tr[j])


class PrognosticFields(NamedTuple):
    """One time level of the prognostic state."""

    vor: torch.Tensor   # (kx, mx, 2, nx)
    div: torch.Tensor
    t: torch.Tensor
    ps: torch.Tensor    # (mx, 2, nx)
    tr: torch.Tensor    # (ntr, kx, mx, 2, nx)


class Tendencies(NamedTuple):
    vordt: torch.Tensor
    divdt: torch.Tensor
    tdt: torch.Tensor
    psdt: torch.Tensor
    trdt: torch.Tensor


def zero_state(kx: int, mx: int, nx: int, ntr: int, dtype,
               device: torch.device | str | None = None) -> SpectralState:
    """Both leapfrog levels of every field at zero, on `device` (the card
    unless the caller names another)."""
    dev = resolve_device(device)

    def z(*s):
        return torch.zeros(s, dtype=dtype, device=dev)
    return SpectralState(vor=z(2, kx, mx, 2, nx), div=z(2, kx, mx, 2, nx),
                         t=z(2, kx, mx, 2, nx), ps=z(2, mx, 2, nx),
                         tr=z(2, ntr, kx, mx, 2, nx))
