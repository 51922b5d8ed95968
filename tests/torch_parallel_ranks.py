"""What each rank of tests/test_torch_parallel.py runs: the port's
multi-device layer on 4 gloo CPU ranks. This module imports torch and
speedyml_torch only (no jax, nothing of speedyml), as every rank must.

`rank_main(rank, world, device, cfg)` returns, as numpy arrays, what its
rank holds whole after each piece: the sharded reservoir fold and predict
step, the latitude-sharded dry step, 24 dry steps and one full-physics
step, and the composed hybrid step, dry and with physics.
"""

import numpy as np
import torch

from speedyml_torch import ModelConfig, ReservoirConfig
from speedyml_torch.domain.decomposition import build_layout
from speedyml_torch.domain.standardize import Standardizer
from speedyml_torch.dynamics.core import Dycore, Forcing
from speedyml_torch.dynamics.state import SpectralState
from speedyml_torch.hybrid.experiment import HybridModel
from speedyml_torch.model import Speedy
from speedyml_torch.parallel import comm as pcomm
from speedyml_torch.parallel import reservoir as pres
from speedyml_torch.parallel.composed import ComposedHybridStep
from speedyml_torch.parallel.mesh import (Mesh, Placement, fold_sharding,
                                          gather, make_mesh,
                                          region_sharding, series_sharding,
                                          shard, shard_params,
                                          state_sharding)
from speedyml_torch.parallel.spatial import SpatialDycore
from speedyml_torch.physics.driver import RadCarry, SurfaceDailyState
from speedyml_torch.reservoir.esn import EsnParams

CPU = torch.device("cpu")


def esn_params(d, prefix=""):
    """EsnParams from the arrays of a dict (keys prefix + field)."""
    shift = d.get(prefix + "a_shift")
    return EsnParams(
        a_idx=torch.as_tensor(d[prefix + "a_idx"], dtype=torch.int64),
        a_val=torch.as_tensor(d[prefix + "a_val"]),
        win=torch.as_tensor(d[prefix + "win"]),
        wout=torch.as_tensor(d[prefix + "wout"]),
        node_map=torch.as_tensor(d[prefix + "node_map"], dtype=torch.int64),
        leakage=float(d[prefix + "leakage"]),
        a_shift=None if shift is None else tuple(int(s) for s in shift))


def tensors(cls, arrays):
    return cls(*(torch.as_tensor(a) for a in arrays))


def host(tree):
    if torch.is_tensor(tree):
        return tree.numpy().copy()
    return type(tree)(*(host(t) for t in tree)) if hasattr(
        tree, "_fields") else [host(t) for t in tree]


def _esn(cfg, out):
    mesh = make_mesh(4, tp=2)
    d = cfg["esn"]
    params = esn_params(d)
    sp = shard_params(params, mesh)
    series = series_sharding(mesh)
    u, y, m = (shard(torch.as_tensor(d[k]), series) for k in "uym")
    acc = pres.init_normal_eq(sp, y.shape[-1], m.shape[-1], mesh)
    acc = pres.drive_and_accumulate(sp, acc, u, y, m, mesh, chunk=4)
    folds = fold_sharding(mesh)
    for name in ("ss_hi", "ss_lo", "sy_hi", "sy_lo"):
        out["fold_" + name] = gather(getattr(acc, name), folds).numpy()
    out["fold_x"] = gather(acc.x, state_sharding(mesh)).numpy()

    x0 = shard(torch.as_tensor(d["x0"]), state_sharding(mesh))
    regions = region_sharding(mesh)
    u0 = shard(torch.as_tensor(d["u"][0]), regions)
    m0 = shard(torch.as_tensor(d["m"][0]), regions)
    x1, y1 = pres.predict_step(sp, x0, u0, m0, mesh)
    out["predict_x"] = gather(x1, state_sharding(mesh)).numpy()
    out["predict_out"] = gather(y1, regions).numpy()
    out["predict_comm"] = pcomm.counts(*mesh.comms.values())


def _dry(cfg, lat, out):
    dy = Dycore(ModelConfig(dtype="float64"), device=CPU)
    sd = SpatialDycore(dy, lat, axis="lat")
    state = tensors(SpectralState, cfg["dry_state"])
    forcing = dy.zero_forcing()
    out["dry_step"] = host(sd.step_fn()(state, forcing))
    sd.comm.reset()
    out["dry_run"] = host(sd.run_steps_fn(24)(state, forcing))
    out["dry_run_comm"] = pcomm.counts(sd.comm)


def _physics(cfg, lat, sp, out):
    sd = SpatialDycore(sp.dy, lat, axis="lat", phys=sp.phys)
    ph = cfg["physics"]
    surf = sd.shard_surface(tensors(SurfaceDailyState, ph["surf"]))
    rad = sd.shard_surface(tensors(RadCarry, ph["rad"]))
    state, rad, fx = sd.wrap_physics(lradsw=True)(
        tensors(SpectralState, ph["state"]), tensors(Forcing, ph["forcing"]),
        surf, rad)
    out["phys_state"] = host(state)
    out["phys_rad"] = host(sd.gather_surface(rad))
    out["phys_fluxes"] = host(sd.gather_surface(fx))


def _composed(cfg, lat, sp, out, world):
    c = cfg["composed"]
    d = dict(np.load(c["model"], mmap_mode="c"))
    L = build_layout(radang_deg=np.degrees(np.asarray(sp.dy.tables.radang)))
    stz = Standardizer(*(torch.as_tensor(d["stz_" + f])
                         for f in Standardizer._fields))
    hm = HybridModel(layout=L, params=esn_params(d), stz=stz,
                     rcfg=ReservoirConfig(), ml_only=False)
    surf = tensors(SurfaceDailyState, c["surf"])
    forcing = tensors(Forcing, c["forcing"])
    args = [torch.as_tensor(c[k]) for k in
            ("atmo", "logp", "precip_t")] + [c["sst"], c["tisr"]]
    for physics in (False, True):
        comp = ComposedHybridStep(hm, sp, lat, physics=physics)
        x = shard(torch.as_tensor(c["x0"]), Placement(lat, ("lat",)))
        comp.comm.reset()
        x, atmo, logp, pr, safe = comp.step(
            x, *args, comp.shard_surface(surf), forcing)
        counts = pcomm.counts(comp.comm)
        key = "composed_" + ("physics" if physics else "dry")
        out[key] = dict(
            x=gather(x, Placement(lat, ("lat",))).numpy(),
            atmo=atmo.numpy(), logp=logp.numpy(), precip_t=pr.numpy(),
            safe=bool(safe), comm=counts)
    # temperature out of the safety bounds in rank 1's latitude rows only
    bad = args[0].clone()
    jl = sp.config.il // world
    bad[0, :, jl:2 * jl] = 400.0
    comp = ComposedHybridStep(hm, sp, lat, physics=False)
    x = shard(torch.as_tensor(c["x0"]), Placement(lat, ("lat",)))
    out["composed_unsafe_safe"] = bool(comp.step(
        x, bad, *args[1:], comp.shard_surface(surf), forcing)[4])


def rank_main(rank, world, device, cfg):
    out = {}
    _esn(cfg, out)
    lat = Mesh((world,), ("lat",))
    _dry(cfg, lat, out)
    sp = Speedy(ModelConfig(dtype="float64"), cfg["bindir"], device=CPU)
    _physics(cfg, lat, sp, out)
    _composed(cfg, lat, sp, out, world)
    return out


def failing_rank(rank, world, device, bad):
    """Rank `bad` raises before its first collective; the others wait in
    one."""
    if rank == bad:
        raise RuntimeError(f"rank {rank} failed on purpose")
    torch.distributed.barrier()
    return rank
