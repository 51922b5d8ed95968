"""The system under test: speedyml_torch's model, reservoirs and readout,
built from the benchmark's inputs through the program's own entry points.

The program is imported here and in the loops only; the reference never
sees it.
"""

from __future__ import annotations

import numpy as np
import torch


def speedy(cfg: dict, bindir: str, device, grid_compute: str | None = None):
    """The program's SPEEDY model on the boundary files of `bindir` at the
    configuration's first date."""
    from speedyml_torch import ModelConfig
    from speedyml_torch.model import Speedy

    m = cfg["model"]
    sp = Speedy(ModelConfig(ntrun=m["ntrun"], ix=m["ix"], il=m["il"],
                            kx=m["kx"], dtype=m["dtype"],
                            grid_compute=grid_compute or m["grid_compute"]),
                bindir, device=device)
    sp.initialize(m["start"][0], m["start"][1])
    return sp


def hybrid_model(cfg: dict, sp, w: dict, stz: dict, wout_dtype=None):
    """The program's HybridModel over the benchmark's weights `w` and
    standardizer `stz` (tensors on the card)."""
    from speedyml_torch import ReservoirConfig
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.domain.standardize import Standardizer
    from speedyml_torch.hybrid.experiment import HybridModel
    from speedyml_torch.reservoir.esn import EsnParams, cast_wout

    m, lay, r = cfg["model"], cfg["layout"], cfg["reservoir"]
    L = build_layout(ix=m["ix"], il=m["il"], kx=m["kx"], resx=lay["resx"],
                     resy=lay["resy"], overlap=lay["overlap"],
                     nz_slabs=lay["nz_slabs"],
                     radang_deg=np.degrees(np.asarray(
                         sp.dy.tables.radang)))
    R, n, deg = w["a_val"].shape
    dev = w["a_val"].device
    shifts = torch.as_tensor(w["shifts"], dtype=torch.int64, device=dev)
    # the circulant support as the ELL index array the parameters carry
    # (the shifted-slice path reads only its shape)
    a_idx = ((torch.arange(n, device=dev)[:, None] + shifts[None]) % n)[
        None].expand(R, n, deg)
    params = EsnParams(a_idx=a_idx, a_val=w["a_val"], win=w["win"],
                       wout=w["wout"], node_map=w["node_map"],
                       leakage=w["leakage"], a_shift=tuple(w["shifts"]))
    if wout_dtype is not None:
        params = cast_wout(params, wout_dtype)
    rcfg = ReservoirConfig(nodes_per_input=r["nodes_per_input"],
                           degree=deg, sigma=r["sigma"],
                           leakage=r["leakage"],
                           precip_epsilon=r["precip_epsilon"],
                           precip_cap_mm=r["precip_cap_mm"],
                           ml_only=r["ml_only"],
                           timestep=m["window_hours"])
    return HybridModel(L, params, Standardizer(**stz), rcfg,
                       ml_only=r["ml_only"])


def variant_settings(variant: str | None):
    """(grid_compute, wout dtype) of a lower-precision path of the program
    switched on: the check's control."""
    if variant is None:
        return None, None
    if variant == "bf16_grid":
        return "bfloat16", None
    if variant == "bf16_wout":
        return None, torch.bfloat16
    raise ValueError(f"unknown variant {variant!r}")
