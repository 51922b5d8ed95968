"""Carry the JAX package's weights and state into the port.

Each function takes a speedyml object (or anything with the same fields)
whose arrays numpy can read, and returns the speedyml_torch counterpart, the
port's own type, on `device` (the card unless the caller names another).
Nothing here imports jax or speedyml: objects are read by their fields and
arrays cross as numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.config import ModelConfig, ReservoirConfig
from .coupler.climatology import Climatology
from .coupler.daily import CouplerState
from .device import resolve_device
from .domain.decomposition import RegionLayout
from .domain.standardize import Standardizer
from .dynamics.state import SpectralState
from .hybrid.experiment import HybridModel
from .hybrid.state_io import GridState
from .physics.driver import RadCarry, SurfaceDailyState
from .reservoir.esn import EsnParams
from .reservoir.slab import OceanLayout, OceanModel


def tensor(a, device=None, dtype: torch.dtype | None = None):
    """numpy-readable array -> a tensor on device that owns a copy of the
    data (the port updates some tensors in place). bfloat16 (which numpy
    holds as ml_dtypes.bfloat16) crosses through float32, which is exact."""
    device = resolve_device(device)
    arr = np.array(a)
    if arr.dtype.name == "bfloat16":
        t = torch.as_tensor(arr.astype(np.float32), device=device)
        return t.to(dtype or torch.bfloat16)
    t = torch.as_tensor(arr, device=device)
    return t if dtype is None else t.to(dtype)


def esn_params(p, device=None) -> EsnParams:
    """speedyml EsnParams -> EsnParams (indices as int64, shifts as ints)."""
    shift = None if p.a_shift is None else tuple(
        int(s) for s in np.asarray(p.a_shift))
    node_map = tensor(p.node_map, device, torch.int64)
    return EsnParams(a_idx=tensor(p.a_idx, device, torch.int64),
                     a_val=tensor(p.a_val, device),
                     win=tensor(p.win, device),
                     wout=tensor(p.wout, device),
                     node_map=node_map, leakage=float(p.leakage),
                     a_shift=shift)


def standardizer(stz, device=None) -> Standardizer:
    return Standardizer(*(tensor(getattr(stz, f), device)
                          for f in Standardizer._fields))


def region_layout(layout) -> RegionLayout:
    """speedyml RegionLayout -> RegionLayout (host arrays are shared)."""
    names = [f.name for f in dataclasses.fields(RegionLayout) if f.init
             and not f.name.startswith("_")]
    return RegionLayout(**{n: getattr(layout, n) for n in names})


def _config(cls, cfg):
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls)})


def model_config(cfg) -> ModelConfig:
    """speedyml ModelConfig -> the port's ModelConfig, field by field."""
    return _config(ModelConfig, cfg)


def reservoir_config(cfg) -> ReservoirConfig:
    """speedyml ReservoirConfig -> the port's ReservoirConfig."""
    return _config(ReservoirConfig, cfg)


def hybrid_model(hm, device=None) -> HybridModel:
    """speedyml HybridModel -> HybridModel on `device`, with the ML-only
    readout of an also_ml training (its host_np["wout_ml"]) as wout_ml."""
    host = getattr(hm, "host_np", None) or {}
    return HybridModel(layout=region_layout(hm.layout),
                       params=esn_params(hm.params, device),
                       stz=standardizer(hm.stz, device),
                       rcfg=reservoir_config(hm.rcfg), ml_only=hm.ml_only,
                       wout_ml=None if "wout_ml" not in host
                       else tensor(host["wout_ml"], device))


def spectral_state(s, device=None) -> SpectralState:
    return SpectralState(*(tensor(getattr(s, f), device)
                           for f in SpectralState._fields))


def grid_state(gs, device=None) -> GridState:
    return GridState(*(tensor(getattr(gs, f), device)
                       for f in GridState._fields))


def surface_state(surf, device=None,
                  dtype: torch.dtype | None = None) -> SurfaceDailyState:
    """speedyml SurfaceDailyState (numpy or jax leaves) -> the port's."""
    return SurfaceDailyState(*(tensor(getattr(surf, f), device, dtype)
                               for f in SurfaceDailyState._fields))


def rad_carry(rad, device=None) -> RadCarry:
    return RadCarry(*(tensor(getattr(rad, f), device)
                      for f in RadCarry._fields))


def _host_dataclass(cls, obj):
    """A host-side (numpy) dataclass of the port from an object with the
    same fields; arrays are copied, since the coupler updates its state."""
    fields = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        fields[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    return cls(**fields)


def coupler_state(cs) -> CouplerState:
    """speedyml CouplerState -> the port's CouplerState (host numpy)."""
    return _host_dataclass(CouplerState, cs)


def climatology(clim) -> Climatology:
    """speedyml Climatology -> the port's Climatology (host numpy)."""
    return _host_dataclass(Climatology, clim)


def ocean_layout(ol) -> OceanLayout:
    """speedyml OceanLayout -> the port's (host arrays are shared)."""
    return OceanLayout(*(getattr(ol, f) for f in OceanLayout._fields))


def ocean_model(om, device=None) -> OceanModel:
    """speedyml OceanModel -> the port's OceanModel, by fields: the
    reservoirs and the standardizer as tensors on `device`, the layout, the
    active mask and the gate as host numpy."""
    return OceanModel(
        ol=ocean_layout(om.ol), params=esn_params(om.params, device),
        stz=standardizer(om.stz, device), active=np.array(om.active),
        rcfg=reservoir_config(om.rcfg),
        anom_std=None if om.anom_std is None else np.array(om.anom_std))
