"""Trained-weight persistence (the port's counterpart of
speedyml/io/weights.py; the two packages write and read the same files).

Two formats:

1. **Batched native format** (`save_model`/`load_model`): one NetCDF-3 file
   holds the whole trained hybrid model (ELL adjacency, win, wout,
   standardization stats, hyperparameters) in region-leading batched
   arrays, written and read in one go.

2. **Reference worker layout** (`export_worker_files`/
   `import_worker_files`): one file per region and level,
   `worker_%04d_level_%d_<trial>.nc` with variables win/wout/rows/cols/
   vals/mean/std (mod_reservoir.f90:1703-1738, mod_io.f90:2938-2983), plus
   a controller file, for interchange with the Fortran SPEEDY-ML. COO <->
   fixed-degree ELL conversion happens on load and save, on the host.

NetCDF-3 classic through scipy.io.
"""

from __future__ import annotations

import dataclasses
import json
import os
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


# ----------------------------------------------------------------------
# reference worker layout (per region/level files)
# ----------------------------------------------------------------------
def ell_to_coo(a_idx: np.ndarray, a_val: np.ndarray):
    """One region's ELL -> 1-based COO (rows, cols, vals), dropping zero
    padding entries."""
    n, deg = a_idx.shape
    rows = np.repeat(np.arange(n, dtype=np.int32), deg)
    cols = a_idx.reshape(-1).astype(np.int32)
    vals = a_val.reshape(-1).astype(np.float64)
    keep = vals != 0.0
    return rows[keep] + 1, cols[keep] + 1, vals[keep]


def coo_to_ell(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int,
               deg: Optional[int] = None):
    """1-based COO -> fixed-degree ELL (pad with zero-valued self entries).
    Vectorized: slot = rank within row after a stable row sort (a Python
    per-entry loop is ~40M iterations over a full 1152-region import)."""
    rows0 = np.asarray(rows, np.int64) - 1
    cols0 = np.asarray(cols, np.int64) - 1
    counts = np.bincount(rows0, minlength=n)
    d = int(counts.max()) if deg is None else max(deg, int(counts.max()))
    a_idx = np.zeros((n, d), np.int32)
    a_val = np.zeros((n, d), np.float32)
    order = np.argsort(rows0, kind="stable")
    r_sorted = rows0[order]
    starts = np.zeros(len(r_sorted), np.int64)
    if len(r_sorted):
        first = np.r_[0, np.flatnonzero(np.diff(r_sorted)) + 1]
        starts[first] = first
        starts = np.maximum.accumulate(starts)
    slot = np.arange(len(r_sorted)) - starts
    a_idx[r_sorted, slot] = cols0[order]
    a_val[r_sorted, slot] = np.asarray(vals)[order]
    return a_idx, a_val


def export_worker_files(dirpath: str, hm: HybridModel,
                        trial_name: str = "trial",
                        level_index: int = 1) -> None:
    """Write per-region files in the reference's schema
    (write_trained_res, mod_reservoir.f90:1703-1738): win (n, n_in) dense,
    wout (n_out, n_aug), COO rows/cols/vals (1-based), mean/std per
    (var-level | 2-D field) in the reference stat order. The tensors may
    lie on any device; they come to the host here, a bf16 readout as f32
    (exactly)."""
    os.makedirs(dirpath, exist_ok=True)
    p = hm.params
    L = hm.layout
    a_idx = _host(p.a_idx)
    a_val = _host(p.a_val)
    win = _host(p.win)
    wout = _host(p.wout)
    means, stds = _stats_to_reference_order(hm)
    n = win.shape[1]
    q = p.q
    n_in = n // q

    for r in range(L.R):
        rows, cols, vals = ell_to_coo(a_idx[r], a_val[r])
        win_dense = np.zeros((n, n_in))
        win_dense[np.arange(n), np.arange(n) // q] = win[r]
        fn = os.path.join(
            dirpath, f"worker_{r:04d}_level_{level_index}_{trial_name}.nc")
        f = netcdf_file(fn, "w")
        try:
            f.createDimension("win_x", n)
            f.createDimension("win_y", n_in)
            f.createDimension("wout_x", wout.shape[1])
            f.createDimension("wout_y", wout.shape[2])
            f.createDimension("rows_x", len(rows))
            f.createDimension("cols_x", len(cols))
            f.createDimension("vals_x", len(vals))
            f.createDimension("mean_x", means.shape[1])
            f.createDimension("std_x", stds.shape[1])

            def wv(name, dtype, dims, data):
                v = f.createVariable(name, dtype, dims)
                v[:] = data

            wv("win", "f8", ("win_x", "win_y"), win_dense)
            wv("wout", "f8", ("wout_x", "wout_y"), wout[r])
            wv("rows", "i4", ("rows_x",), rows)
            wv("cols", "i4", ("cols_x",), cols)
            wv("vals", "f8", ("vals_x",), vals)
            wv("mean", "f8", ("mean_x",), means[r])
            wv("std", "f8", ("std_x",), stds[r])
        finally:
            f.close()

    with open(os.path.join(dirpath, f"{trial_name}_controller_file.txt"),
              "w") as fh:
        rc = hm.rcfg
        fh.write("-" * 59 + "\n")
        for k, v in (("num_hor_regions", L.R), ("ml_only", hm.ml_only),
                     ("atmo_timestep", rc.timestep),
                     ("ocean_timestep", rc.timestep_slab),
                     ("precip_epsilon", rc.precip_epsilon),
                     ("full_predictvars", L.nvars),
                     ("full_heightlevels", L.kx), ("overlap", L.overlap),
                     ("reservoir_nodes", p.n), ("deg", a_idx.shape[-1]),
                     ("beta_res", rc.beta_res), ("beta_model", rc.beta_model),
                     ("sigma", rc.sigma), ("leakage", rc.leakage),
                     ("prior_val", rc.prior_val)):
            fh.write(f" {k}:{v}\n")
        fh.write("-" * 59 + "\n")


def _stats_to_reference_order(hm: HybridModel):
    """The per-element Standardizer -> the reference's compact per-region
    stat vector [per-(var,level) atmo means | logp | precip | sst | tisr]
    (standardize_data, mod_utilities.f90:934-1040), as host arrays."""
    L = hm.layout
    in_mean = _host(hm.stz.in_mean)
    in_std = _host(hm.stz.in_std)
    npatch = L.inpy * L.inpx
    s0, s1 = L.sizes["atmo3d"]
    # element (v + nvars*(xx + inpx*(yy + inpy*z))): stats constant over the
    # patch -> take patch position 0 for each (z, v)
    m3 = in_mean[:, s0:s1].reshape(L.R, L.inpz, npatch, L.nvars)[:, :, 0, :]
    s3 = in_std[:, s0:s1].reshape(L.R, L.inpz, npatch, L.nvars)[:, :, 0, :]
    # reference order: (var, level) var-major
    parts_m = [m3.transpose(0, 2, 1).reshape(L.R, -1)]
    parts_s = [s3.transpose(0, 2, 1).reshape(L.R, -1)]
    for name in ("logp", "precip", "sst", "tisr", "ohtc"):
        t0, t1 = L.sizes[name]
        if t1 > t0:
            parts_m.append(in_mean[:, t0:t0 + 1])
            parts_s.append(in_std[:, t0:t0 + 1])
    return np.concatenate(parts_m, 1), np.concatenate(parts_s, 1)


def _stats_from_reference_order(layout, means, stds,
                                device=None) -> Standardizer:
    """Inverse of _stats_to_reference_order -> Standardizer on `device`
    (the card unless the caller names another). The rows are those given:
    all of the layout's regions or a subset of them."""
    device = resolve_device(device)
    L = layout
    R = means.shape[0]
    npatch = L.inpy * L.inpx
    nvl = L.nvars * L.inpz
    m3 = means[:, :nvl].reshape(R, L.nvars, L.inpz).transpose(0, 2, 1)
    s3 = stds[:, :nvl].reshape(R, L.nvars, L.inpz).transpose(0, 2, 1)
    in_mean = np.empty((R, L.n_in), np.float32)
    in_std = np.empty((R, L.n_in), np.float32)
    a0, a1 = L.sizes["atmo3d"]
    in_mean[:, a0:a1] = np.repeat(m3[:, :, None, :], npatch, 2).reshape(R, -1)
    in_std[:, a0:a1] = np.repeat(s3[:, :, None, :], npatch, 2).reshape(R, -1)
    k = nvl
    for name in ("logp", "precip", "sst", "tisr", "ohtc"):
        t0, t1 = L.sizes[name]
        if t1 > t0:
            in_mean[:, t0:t1] = means[:, k:k + 1]
            in_std[:, t0:t1] = stds[:, k:k + 1]
            k += 1
    out_mean = np.empty((R, L.n_out), np.float32)
    out_std = np.empty((R, L.n_out), np.float32)
    ncore = L.resy * L.resx
    o0, o1 = L.out_sizes["atmo3d"]
    mc = m3[:, L.vert_overlap:L.vert_overlap + L.kz_core, :]
    sc = s3[:, L.vert_overlap:L.vert_overlap + L.kz_core, :]
    out_mean[:, o0:o1] = np.repeat(mc[:, :, None, :], ncore, 2).reshape(R, -1)
    out_std[:, o0:o1] = np.repeat(sc[:, :, None, :], ncore, 2).reshape(R, -1)
    k = nvl
    for name in ("logp", "precip"):
        if name in L.out_sizes:
            u0, u1 = L.out_sizes[name]
            out_mean[:, u0:u1] = means[:, k:k + 1]
            out_std[:, u0:u1] = stds[:, k:k + 1]
            k += 1
    return Standardizer(*(torch.as_tensor(a, device=device)
                          for a in (in_mean, in_std, out_mean, out_std)))


def import_worker_files(dirpath: str, layout, rcfg: ReservoirConfig,
                        trial_name: str = "trial", level_index: int = 1,
                        ml_only: bool = False, regions=None,
                        device: torch.device | str | None = None
                        ) -> HybridModel:
    """Read reference-schema per-worker files into a batched HybridModel
    (read_trained_res, mod_io.f90:2938-2983) on `device` (the card unless
    the caller names another). regions: optional region-id subset (the
    batched model then covers only those rows)."""
    device = resolve_device(device)
    L = layout
    idxs, vals_l, wins, wouts, means, stds = [], [], [], [], [], []
    deg = None
    for r in (range(L.R) if regions is None else regions):
        fn = os.path.join(
            dirpath, f"worker_{r:04d}_level_{level_index}_{trial_name}.nc")
        f = netcdf_file(fn, "r", mmap=False)
        try:
            win_dense = _native(f.variables["win"][:])
            wout = _native(f.variables["wout"][:])
            rows = _native(f.variables["rows"][:])
            cols = _native(f.variables["cols"][:])
            vv = _native(f.variables["vals"][:])
            means.append(_native(f.variables["mean"][:]))
            stds.append(_native(f.variables["std"][:]))
        finally:
            f.close()
        n = win_dense.shape[0]
        a_idx, a_val = coo_to_ell(rows, cols, vv, n, deg)
        deg = a_idx.shape[1]
        idxs.append(a_idx)
        vals_l.append(a_val)
        # block-diagonal win: node j reads input j // q
        q = n // win_dense.shape[1]
        wins.append(win_dense[np.arange(n), np.arange(n) // q])
        wouts.append(wout)

    # pad every region to the common max degree
    dmax = max(a.shape[1] for a in idxs)
    idxs = [np.pad(a, ((0, 0), (0, dmax - a.shape[1]))) for a in idxs]
    vals_l = [np.pad(a, ((0, 0), (0, dmax - a.shape[1]))) for a in vals_l]

    n = idxs[0].shape[0]
    a_idx_h = np.stack(idxs)
    shifts = shifts_from_ell(a_idx_h)   # recover the circulant path

    def dev32(a):
        return torch.as_tensor(a, device=device).to(torch.float32)

    params = EsnParams(
        a_idx=torch.as_tensor(a_idx_h, device=device).to(torch.int64),
        a_val=dev32(np.stack(vals_l)), win=dev32(np.stack(wins)),
        wout=dev32(np.stack(wouts)),
        node_map=torch.arange(n, device=device) // (n // L.n_in),
        leakage=rcfg.leakage,
        a_shift=None if shifts is None else tuple(int(s) for s in shifts))
    stz = _stats_from_reference_order(L, np.stack(means), np.stack(stds),
                                      device)
    return HybridModel(layout=L, params=params, stz=stz, rcfg=rcfg,
                       ml_only=ml_only)
