"""Per-region standardization of packed input/output vectors (PyTorch port
of speedyml/domain/standardize.py).

The reference standardizes each variable per region with a scalar mean/std
per (variable, level) plus special handling of 2-D fields
(mod_utilities.f90:640-1343; res_domain.f90:1211-1563). The stats are
expanded once into per-element (R, n_in)/(R, n_out) tensors, so applying
them is an elementwise multiply-add on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .decomposition import RegionLayout


class Standardizer(NamedTuple):
    in_mean: torch.Tensor    # (R, n_in)
    in_std: torch.Tensor     # (R, n_in)
    out_mean: torch.Tensor   # (R, n_out)
    out_std: torch.Tensor    # (R, n_out)


# Physical std floor [K] for the CLAMPED SST input section: fully ice-covered
# input patches are exactly 272 K in training, so their std collapses to eps
# and a small fed-back anomaly would become a huge standardized input
# (speedyml/domain/standardize.py:27-39 gives the measured history).
SST_STD_FLOOR = 0.3


def floor_sst_std(stz: Standardizer, layout: RegionLayout) -> Standardizer:
    """Apply SST_STD_FLOOR to the SST input section (idempotent)."""
    t0, t1 = layout.sizes["sst"]
    if t1 <= t0:
        return stz
    in_std = stz.in_std.clone()
    in_std[:, t0:t1] = torch.clamp(in_std[:, t0:t1], min=SST_STD_FLOOR)
    return stz._replace(in_std=in_std)


def _expand(layout: RegionLayout, m, sd, stats2d, R: int, n_in: int,
            device) -> Standardizer:
    """Per-element float32 vectors from the per-(region, level, var) atmo
    stats m, sd (R, inpz, nvars) and the 2-D sections' {name: (mean, std)}
    of (R,) each, all float64; the SST std floored at SST_STD_FLOOR."""
    L = layout
    f64 = torch.float64
    npatch = L.inpy * L.inpx
    s0, s1 = L.sizes["atmo3d"]
    in_mean = torch.empty((R, n_in), dtype=f64, device=device)
    in_std = torch.empty_like(in_mean)

    def expand(x, n):      # (R, z, v) -> (R, z * n * v), patch index middle
        return x[:, :, None, :].expand(-1, -1, n, -1).reshape(R, -1)

    in_mean[:, s0:s1] = expand(m, npatch)
    in_std[:, s0:s1] = expand(sd, npatch)
    for name, (m2, sd2) in stats2d.items():
        t0s, t1s = L.sizes[name]
        if name == "sst":
            sd2 = torch.clamp(sd2, min=SST_STD_FLOOR)
        in_mean[:, t0s:t1s] = m2[:, None]
        in_std[:, t0s:t1s] = sd2[:, None]

    # output stats: the same stats restricted to the core sections (core
    # level zz sits at input slab position zz + vert_overlap)
    out_mean = torch.empty((R, L.n_out), dtype=f64, device=device)
    out_std = torch.empty_like(out_mean)
    o0, o1 = L.out_sizes["atmo3d"]
    ncore = L.resy * L.resx
    core = slice(L.vert_overlap, L.vert_overlap + L.kz_core)
    out_mean[:, o0:o1] = expand(m[:, core], ncore)
    out_std[:, o0:o1] = expand(sd[:, core], ncore)
    for name in ("logp", "precip"):
        if name in L.out_sizes:
            t0s, _ = L.sizes[name]
            u0, u1 = L.out_sizes[name]
            out_mean[:, u0:u1] = in_mean[:, t0s:t0s + 1]
            out_std[:, u0:u1] = in_std[:, t0s:t0s + 1]

    f32 = torch.float32
    return Standardizer(in_mean=in_mean.to(f32), in_std=in_std.to(f32),
                        out_mean=out_mean.to(f32), out_std=out_std.to(f32))


def _sections2d(layout: RegionLayout):
    return [(name,) + layout.sizes[name]
            for name in ("logp", "precip", "sst", "tisr", "ohtc")
            if layout.sizes[name][1] > layout.sizes[name][0]]


def compute_stats(layout: RegionLayout, inputs: torch.Tensor,
                  eps: float = 1e-8) -> Standardizer:
    """Per-(region, var, level) stats from a gathered input series
    (T, R, n_in), expanded to per-element vectors, on its device: the dense
    form of compute_stats_gv (biased std, ddof=0, in float64). Stats are
    shared across the spatial patch within a region (the reference's
    per-var-per-level scalars, mod_utilities.f90:934-1040)."""
    L = layout
    T, R, n_in = inputs.shape
    x = inputs.to(torch.float64)
    s0, s1 = L.sizes["atmo3d"]
    atmo = x[:, :, s0:s1].reshape(T, R, L.inpz, L.inpy * L.inpx, L.nvars)
    stats2d = {name: (x[:, :, t0:t1].mean(dim=(0, 2)),
                      x[:, :, t0:t1].std(dim=(0, 2), correction=0) + eps)
               for name, t0, t1 in _sections2d(L)}
    return _expand(L, atmo.mean(dim=(0, 3)),
                   atmo.std(dim=(0, 3), correction=0) + eps, stats2d, R,
                   n_in, x.device)


def compute_stats_gv(layout: RegionLayout, gv: torch.Tensor,
                     chunk: int = 256, eps: float = 1e-8) -> Standardizer:
    """Per-(region, var, level) stats from the PACKED series gv (T, gv_len),
    streamed in chunks of samples, on gv's device.

    First and second moments accumulate in float64 (biased std, ddof=0);
    stats are shared across the spatial patch of a region. Returns float32
    tensors on gv's device.
    """
    L = layout
    dev = gv.device
    f64 = torch.float64
    T = gv.shape[0]
    idx, _ = L.maps(dev)
    R, n_in = idx.shape
    npatch = L.inpy * L.inpx
    s0, s1 = L.sizes["atmo3d"]
    sec2d = _sections2d(L)

    m1_a = torch.zeros((R, L.inpz, L.nvars), dtype=f64, device=dev)
    m2_a = torch.zeros_like(m1_a)
    m1_2d = {name: torch.zeros(R, dtype=f64, device=dev)
             for name, _, _ in sec2d}
    m2_2d = {name: torch.zeros(R, dtype=f64, device=dev)
             for name, _, _ in sec2d}
    for t0 in range(0, T, chunk):
        blk = gv[t0:t0 + chunk][:, idx].to(f64)        # (c, R, n_in)
        c = blk.shape[0]
        atmo = blk[:, :, s0:s1].reshape(c, R, L.inpz, npatch, L.nvars)
        m1_a += atmo.sum(dim=(0, 3))
        m2_a += atmo.square().sum(dim=(0, 3))
        for name, t0s, t1s in sec2d:
            sec = blk[:, :, t0s:t1s]
            m1_2d[name] += sec.sum(dim=(0, 2))
            m2_2d[name] += sec.square().sum(dim=(0, 2))

    n_a = T * npatch
    m = m1_a / n_a
    sd = torch.sqrt(torch.clamp(m2_a / n_a - m * m, min=0.0)) + eps
    stats2d = {}
    for name, t0s, t1s in sec2d:
        n2 = T * (t1s - t0s)
        m2 = m1_2d[name] / n2
        stats2d[name] = (m2, torch.sqrt(torch.clamp(
            m2_2d[name] / n2 - m2 * m2, min=0.0)) + eps)
    return _expand(L, m, sd, stats2d, R, n_in, dev)


def standardize_in(stz: Standardizer, u):
    return (u - stz.in_mean) / stz.in_std


def standardize_out(stz: Standardizer, y):
    return (y - stz.out_mean) / stz.out_std


def unstandardize_out(stz: Standardizer, y):
    return y * stz.out_std + stz.out_mean
