"""Trained-weight persistence: the batched native format (the port's
counterpart of `save_model`/`load_model` in speedyml/io/weights.py; the two
packages write and read the same file).

One NetCDF-3 file holds the whole trained hybrid model (ELL adjacency, win,
wout, standardization stats, hyperparameters) in region-leading batched
arrays, written and read in one go. NetCDF-3 classic through scipy.io.

The reference-worker layout (one file per region and level) is not ported.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch
from scipy.io import netcdf_file

from ..core.config import ReservoirConfig
from ..device import resolve_device, to_host
from ..domain.decomposition import build_layout
from ..domain.standardize import Standardizer, floor_sst_std
from ..hybrid.experiment import HybridModel
from ..reservoir.esn import EsnParams
from ..reservoir.generate import shifts_from_ell


def _native(a: np.ndarray) -> np.ndarray:
    """NetCDF-3 data is big-endian; torch needs native byte order."""
    a = np.asarray(a)
    return a.astype(a.dtype.newbyteorder("="))


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as host numpy, a floating-point one as float32."""
    return to_host(t.to(torch.float32) if t.dtype.is_floating_point else t)


def save_model(path: str, hm: HybridModel) -> None:
    """Write a trained HybridModel to one NetCDF-3 file. The tensors come to
    the host here; a bf16 readout is written as f32 (exactly)."""
    p = hm.params
    stz = hm.stz
    a_idx = _host(p.a_idx)
    wout = _host(p.wout)
    R, n, deg = a_idx.shape
    q = n // stz.in_mean.shape[1]

    f = netcdf_file(path, "w", version=2)
    try:
        # region is the UNLIMITED record dimension: the format packs each
        # variable's size as int32, so a fixed-shape wout (1152, 136, 5896)
        # f32 = 3.7 GB overflows it; as a record variable only the
        # per-region record size (3.2 MB) is packed and the total may exceed
        # 4 GB
        f.createDimension("region", None)
        f.createDimension("node", n)
        f.createDimension("deg", deg)
        f.createDimension("n_out", wout.shape[1])
        f.createDimension("n_aug", wout.shape[2])
        f.createDimension("n_in", stz.in_mean.shape[1])

        def wv(name, dtype, dims, data):
            v = f.createVariable(name, dtype, dims)
            v[:] = data

        wv("a_idx", "i4", ("region", "node", "deg"), a_idx)
        wv("a_val", "f4", ("region", "node", "deg"), _host(p.a_val))
        wv("win", "f4", ("region", "node"), _host(p.win))
        wv("wout", "f4", ("region", "n_out", "n_aug"), wout)
        wv("in_mean", "f4", ("region", "n_in"), _host(stz.in_mean))
        wv("in_std", "f4", ("region", "n_in"), _host(stz.in_std))
        wv("out_mean", "f4", ("region", "n_out"), _host(stz.out_mean))
        wv("out_std", "f4", ("region", "n_out"), _host(stz.out_std))

        L = hm.layout
        meta = dict(leakage=p.leakage, q=q, ml_only=int(hm.ml_only),
                    rcfg=dataclasses.asdict(hm.rcfg),
                    layout=dict(ix=L.ix, il=L.il, kx=L.kx, nvars=L.nvars,
                                resx=L.resx, resy=L.resy, overlap=L.overlap,
                                nz_slabs=L.nz, vert_overlap=L.vert_overlap))
        f.meta_json = json.dumps(meta).encode()
    finally:
        f.close()


def load_model(path: str, radang_deg: Optional[np.ndarray] = None,
               device: torch.device | str | None = None) -> HybridModel:
    """Read a trained HybridModel back (inverse of save_model) onto `device`
    (the card unless the caller names another)."""
    device = resolve_device(device)
    f = netcdf_file(path, "r", mmap=False)
    try:
        meta = json.loads(bytes(f.meta_json).decode())

        def g(name, dtype=torch.float32):
            return torch.as_tensor(_native(f.variables[name][:]),
                                   device=device).to(dtype)

        a_idx = _native(f.variables["a_idx"][:])
        shifts = shifts_from_ell(a_idx)     # recover the circulant path
        win = g("win")
        params = EsnParams(
            a_idx=torch.as_tensor(a_idx, device=device).to(torch.int64),
            a_val=g("a_val"), win=win, wout=g("wout"),
            node_map=torch.arange(win.shape[1], device=device)
            // int(meta["q"]),
            leakage=float(meta["leakage"]),
            a_shift=None if shifts is None
            else tuple(int(s) for s in shifts))
        stz = Standardizer(in_mean=g("in_mean"), in_std=g("in_std"),
                           out_mean=g("out_mean"), out_std=g("out_std"))
    finally:
        f.close()

    lo = meta["layout"]
    rcfg = ReservoirConfig(**meta["rcfg"])
    layout = build_layout(ix=lo["ix"], il=lo["il"], kx=lo["kx"],
                          nvars=lo["nvars"], resx=lo["resx"], resy=lo["resy"],
                          overlap=lo["overlap"],
                          nz_slabs=lo.get("nz_slabs", 1),
                          vert_overlap=lo.get("vert_overlap", 1),
                          radang_deg=radang_deg)
    # files written before the clamped-SST std floor existed carry the
    # collapsed (eps-scale) stds; the floor is idempotent and equivalent to
    # what training applies (see standardize.SST_STD_FLOOR)
    stz = floor_sst_std(stz, layout)
    return HybridModel(layout=layout, params=params, stz=stz, rcfg=rcfg,
                       ml_only=bool(meta["ml_only"]))
