"""Operations and bytes of a step, counted from shapes, and the chip's peaks.

These count the algorithm's work, whatever implements it: each input byte
read once and each output byte written once, products as two operations
per multiply-add. The column physics' elementwise work is not counted.
"""

from __future__ import annotations

import json
import os

from .cell import BENCH

F32 = 4


def readout(R: int, n_out: int, k: int, E: int = 1, w_bytes: int = F32):
    """Wout (R, n_out, k) times the augmented states of E members:
    (flops, bytes)."""
    flops = 2 * R * n_out * k * E
    nbytes = R * n_out * k * w_bytes + E * R * k * F32 + E * R * n_out * F32
    return flops, nbytes


def advance(R: int, n: int, n_in: int, deg: int, E: int = 1):
    """x <- (1-l) x + l tanh(A x + Win u) for E members (A: deg entries a
    row; the tanh counted as one operation): (flops, bytes)."""
    flops = E * R * n * (2 * deg + 2 + 4)
    nbytes = (R * n * deg * F32 + R * n * F32            # A values, Win
              + E * R * n_in * F32                        # u
              + 2 * E * R * n * F32)                      # x in, x out
    return flops, nbytes


def spectral(n_inv: int, n_fwd: int, mx: int, nx: int, il: int, ix: int,
             E: int = 1):
    """n_inv spectral -> grid and n_fwd grid -> spectral transforms of one
    level each (Legendre sums over nx modes at il latitudes, then a dense
    DFT over ix longitudes), for E members: (flops, bytes)."""
    per = 2 * mx * 2 * nx * il + 2 * il * 2 * mx * ix
    io = (mx * 2 * nx + il * ix) * F32
    return (n_inv + n_fwd) * per * E, (n_inv + n_fwd) * io * E


def peaks(kind: str):
    """The published peaks of a device kind (peaks.json), or None."""
    with open(os.path.join(BENCH, "peaks.json")) as f:
        return json.load(f).get(kind)


def bound_seconds(work: dict, peak: dict) -> float:
    """The least time the chip could take for `work` ({"flops": {precision:
    count}, "bytes": count}): the larger of its operations over the peak of
    the precision they run in and its bytes over the memory bandwidth."""
    t_ops = sum(n / peak[p] for p, n in work["flops"].items())
    return max(t_ops, work["bytes"] / peak["hbm_bytes_per_s"])
