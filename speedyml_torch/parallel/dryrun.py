"""The multi-device dry run: one step of each sharded phase of the hybrid
pipeline on every rank, each held against the port's single-device
function on the same device (the port of __graft_entry__.py's
dryrun_multichip).

  1. reservoir training: the drive and the compensated fold with regions
     over dp and nodes over tp (tp=2 when the rank count is even and at
     least 4), bitwise against the single-device drive;
  2. the hybrid predict step with scatter_outputs on the same mesh;
  3. a dycore ensemble step, one member per rank, bitwise;
  4. the latitude-sharded full-physics step;
  5. the slab-ocean reservoirs' weekly step, regions over dp;
  6. the composed hybrid step with physics, over one latitude axis.

The rank count must split the tiny layout's 24 regions over dp and each dp
block over tp (1, 2, 3, 4, 6, 8, 12 or 24 ranks); each of those divides the
48 latitude rows, so phases 4 and 6 run on all ranks (the JAX dry run's
gcd(ranks, 48)).

Phases 1, 2 and 5 run on a tiny region layout (ix=12, il=8, kx=2, 24
regions); phases 3, 4 and 6 on the T30 model in float32 on stand-in
boundary files written from a seed to a temporary directory.

    python -m speedyml_torch.parallel.dryrun --nproc 4 --backend gloo \\
        --device cpu
    python -m speedyml_torch.parallel.dryrun --nproc 4 --backend gloo \\
        --device cuda         # four ranks sharing the first GPU
    torchrun --nproc-per-node 4 -m speedyml_torch.parallel.dryrun \\
        --backend nccl --device cuda     # one GPU per rank

The device and the backend are the caller's: --device cuda puts every
rank spawned here on cuda:0 (ranks that share a GPU need gloo; NCCL
refuses them), under torchrun rank r uses cuda:LOCAL_RANK. Every check
raises; a failing rank fails the run with a nonzero exit code.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
TINY = dict(ix=12, il=8, kx=2, nvars=4, resx=2, resy=2, overlap=1)
TN, CHUNK = 8, 4
# float32 bounds, each relative to the largest magnitude of the field
# held: a tp readout sums its partial products in another order (one
# rounding of the sum: the largest difference); a latitude-sharded physics
# step and window sum the forward transforms in another order, which the
# moist schemes' discrete triggers can turn into a whole column's
# difference (ROADMAP note (c)): the state after one step by its largest
# difference, the fluxes and a window's outputs by their rms difference
# (the window's: the bound of tests/test_composed.py:169-172)
READOUT_REL = 1e-6
PHYSICS_STEP_REL = 1e-4
COMPOSED_REL = 2e-3


def _rel(got, want, rms=False) -> float:
    """Largest (or rms) |got - want| over the largest |want|."""
    d = (got - want).abs()
    d = d.square().mean().sqrt() if rms else d.max()
    return float(d / want.abs().max().clamp_min(1e-30))


def _equal(label, got, want):
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: differs from the single-device "
                             f"result by {float((got - want).abs().max())}")


def _within(label, got, want, rel, rms=False) -> float:
    err = _rel(got, want, rms)
    if not err <= rel:
        raise AssertionError(f"{label}: {'rms ' if rms else ''}{err:.3e} of "
                             f"scale from the single-device result (bound "
                             f"{rel})")
    return err


def _random_esn(seed, R, n_in, n_out, n_model, device):
    from ..reservoir.generate import generate_esn
    p = generate_esn(seed, R, n_in, n_out, n_model=n_model,
                     m_target=2 * n_in, deg=4, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    wout = 0.1 * torch.randn(p.wout.shape, generator=g, device=device)
    p.wout = wout
    return p


def phase_training(mesh, L, device):
    from ..ops import accum
    from ..reservoir.training import drive_and_accumulate, init_normal_eq
    from . import reservoir as pres
    from .mesh import (fold_sharding, gather, series_sharding, shard,
                       shard_params, state_sharding)

    params = _random_esn(SEED, L.R, L.n_in, L.n_out, L.n_out, device)
    g = torch.Generator(device=device).manual_seed(SEED)
    u, y, m = (torch.randn((TN, L.R, k), generator=g, device=device)
               for k in (L.n_in, L.n_out, L.n_out))
    sp = shard_params(params, mesh)
    series = series_sharding(mesh)
    acc = pres.init_normal_eq(sp, L.n_out, L.n_out, mesh)
    before = accum.accumulate_ss_scan.launches
    acc = pres.drive_and_accumulate(sp, acc, shard(u, series),
                                    shard(y, series), shard(m, series),
                                    mesh, chunk=CHUNK)
    launches = accum.accumulate_ss_scan.launches - before
    ref = drive_and_accumulate(params, init_normal_eq(params, L.n_out),
                               u, y, m, chunk=CHUNK)
    for name in ("ss_hi", "ss_lo", "sy_hi", "sy_lo"):
        _equal(f"training {name}", gather(getattr(acc, name),
                                          fold_sharding(mesh)),
               getattr(ref, name))
    _equal("training x", gather(acc.x, state_sharding(mesh)), ref.x)
    return dict(ss=list(ref.ss_hi.shape), accum_launches=launches)


def phase_predict(mesh, L, device):
    from ..domain.decomposition import scatter_outputs
    from ..reservoir.esn import predict_step
    from . import reservoir as pres
    from .mesh import gather, region_sharding, shard, shard_params, \
        state_sharding

    params = _random_esn(SEED + 1, L.R, L.n_in, L.n_out, L.n_out, device)
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    gv = torch.randn(L.gv_len, generator=g, device=device)
    x0 = 0.1 * torch.randn((L.R, params.n), generator=g, device=device)
    idx, tidx = L.maps(device)
    regions = region_sharding(mesh)
    x, out = pres.predict_step(shard_params(params, mesh),
                               shard(x0, state_sharding(mesh)),
                               shard(gv[idx], regions),
                               shard(gv[tidx], regions), mesh)
    x = gather(x, state_sharding(mesh))
    atmo, logp, precip = scatter_outputs(L, gather(out, regions))
    x_ref, out_ref = predict_step(params, x0, gv[idx], gv[tidx])
    atmo_ref, logp_ref, precip_ref = scatter_outputs(L, out_ref)
    _equal("predict x", x, x_ref)
    return dict(atmo=list(atmo.shape), err=max(
        _within("predict atmo", atmo, atmo_ref, READOUT_REL),
        _within("predict logp", logp, logp_ref, READOUT_REL),
        _within("predict precip", precip, precip_ref, READOUT_REL)))


def phase_ensemble(world_comm, rank, world, dy, device):
    from ..dynamics.initial import rest_state

    state = rest_state(dy)
    g = torch.Generator(device=device).manual_seed(SEED + 3)

    def member(k):
        # member k: the rest state with temperature nudged by k * 0.1 K of
        # smooth noise
        noise = torch.randn(state.t.shape, generator=g, device=device,
                            dtype=state.t.dtype)
        noise[..., 6:, :, :] = 0.0
        noise[..., :, :, 6:] = 0.0
        return state._replace(t=state.t + 0.1 * k * noise)

    members = [member(k) for k in range(world)]
    forcing = dy.zero_forcing()
    mine = dy.step(members[rank], forcing, 1, 1, "delt2")
    whole = [world_comm.all_gather(f[None], dim=0) for f in mine]
    for k in range(world):
        ref = dy.step(members[k], forcing, 1, 1, "delt2")
        for name, got, want in zip(ref._fields, whole, ref):
            _equal(f"ensemble member {k} {name}", got[k], want)
    return dict(members=world)


def phase_lat_physics(lat, sp):
    from .spatial import SpatialDycore

    sd = SpatialDycore(sp.dy, lat, axis="lat", phys=sp.phys)
    sd.comm.reset()
    state, rad, fx = sd.wrap_physics(lradsw=True)(
        sp.state, sp.forcing, sd.shard_surface(sp.surf),
        sd.shard_surface(sp.rad))
    rad, fx = sd.gather_surface(rad), sd.gather_surface(fx)
    ref, (ref_rad, ref_fx) = sp.dy.step(
        sp.state, sp.forcing, 1, 1, "delt2",
        sp._phys_fn(sp.surf, sp.rad, True))
    err = max(_within(f"physics {name}", got, want, PHYSICS_STEP_REL)
              for name, got, want in zip(ref._fields, state, ref))
    rms = max(_within(f"physics {name}", getattr(fx, name),
                      getattr(ref_fx, name), PHYSICS_STEP_REL, rms=True)
              for name in ("precnv", "precls", "evap", "olr", "tsr",
                           "hfluxn_s"))
    rms = max(rms, _within("physics tt_rsw", rad.tt_rsw, ref_rad.tt_rsw,
                           PHYSICS_STEP_REL, rms=True))
    return dict(shards=lat.shape["lat"], err=err, flux_rms=rms,
                comm={k: v for k, v in sd.comm.calls.items()})


def phase_ocean(mesh, L, device):
    from ..reservoir.esn import predict_step
    from ..reservoir.slab import build_ocean_layout
    from . import reservoir as pres
    from .mesh import gather, region_sharding, shard, shard_params, \
        state_sharding

    ol = build_ocean_layout(L)
    params = _random_esn(SEED + 5, ol.R, ol.n_in, ol.n_out, 0, device)
    g = torch.Generator(device=device).manual_seed(SEED + 5)
    gv = torch.randn(L.gv_len, generator=g, device=device)
    mean = 0.1 * torch.randn((ol.R, ol.n_in), generator=g, device=device)
    std = 1.0 + 0.1 * torch.rand((ol.R, ol.n_in), generator=g,
                                 device=device)
    oidx = torch.as_tensor(ol.input_index, dtype=torch.int64, device=device)
    u = (gv[oidx] - mean) / std
    x0 = torch.zeros((ol.R, params.n), device=device)
    regions = region_sharding(mesh)
    x, sst = pres.predict_step(shard_params(params, mesh),
                               shard(x0, state_sharding(mesh)),
                               shard(u, regions), None, mesh)
    x_ref, sst_ref = predict_step(params, x0, u)
    _equal("ocean x", gather(x, state_sharding(mesh)), x_ref)
    return dict(regions=ol.R, err=_within(
        "ocean sst", gather(sst, regions), sst_ref, READOUT_REL))


def phase_composed(lat, sp, device):
    from ..core.config import ReservoirConfig
    from ..domain.decomposition import build_layout
    from ..domain.standardize import Standardizer
    from ..hybrid.experiment import HybridModel
    from ..hybrid.state_io import extract
    from .comm import counts
    from .composed import ComposedHybridStep, single_device_step
    from .mesh import Placement, gather, shard

    L = build_layout(radang_deg=np.degrees(np.asarray(
        sp.dy.tables.radang)))
    p = _random_esn(SEED + 6, L.R, L.n_in, L.n_out, L.n_out, device)
    p.wout = 0.1 * p.wout                    # a 0.01-scale readout
    one = torch.ones((L.R, L.n_in), device=device)
    stz = Standardizer(in_mean=0 * one, in_std=one,
                       out_mean=torch.zeros((L.R, L.n_out), device=device),
                       out_std=torch.ones((L.R, L.n_out), device=device))
    hm = HybridModel(layout=L, params=p, stz=stz, rcfg=ReservoirConfig(),
                     ml_only=False)
    gs = extract(sp.dy, sp.state)
    atmo = torch.stack([gs.t, gs.u, gs.v, torch.clamp(gs.q, min=1e-6)]
                       ).float()
    logp = gs.logp.float()
    pr = torch.zeros_like(logp)
    sst = np.asarray(sp.coupler.sst_am, np.float32)
    tisr = np.zeros_like(sst)
    x0 = torch.zeros((L.R, p.n), device=device)
    comp = ComposedHybridStep(hm, sp, lat, physics=True)
    regions = Placement(lat, ("lat",))
    comp.comm.reset()
    x, a, lp, pt, safe = comp.step(shard(x0, regions), atmo, logp, pr, sst,
                                   tisr, comp.shard_surface(sp.surf),
                                   sp.forcing)
    comm = counts(comp.comm)
    if not bool(safe):
        raise AssertionError("the composed step tripped the safety gate")
    x = gather(x, regions)
    for name, t in (("x", x), ("atmo", a), ("logp", lp), ("precip_t", pt)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"composed {name} is not finite")
    ref = single_device_step(hm, comp.fc, x0, atmo, logp, pr, sst, tisr,
                             sp.surf, sp.forcing)
    outs = zip(("x", "atmo", "logp", "precip_t"), (x, a, lp, pt), ref)
    err = max(_within(f"composed {name}", got, want, COMPOSED_REL, rms=True)
              for name, got, want in outs)
    return dict(regions=L.R, rms=err, comm=comm)


def dryrun_rank(rank: int, world: int, device: torch.device) -> dict:
    """All six phases on this rank; returns each phase's numbers and
    seconds (the same checks run on every rank)."""
    from ..core.config import ModelConfig
    from ..domain.decomposition import build_layout
    from ..io.synthetic_boundary import write_synthetic_boundary
    from ..model import Speedy
    from .comm import Communicator
    from .mesh import Mesh, make_mesh

    tp = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = make_mesh(world, tp=tp)
    L = build_layout(**TINY)
    if L.R % (world // tp) or (L.R // (world // tp)) % tp:
        raise ValueError(f"{L.R} regions do not split over dp={world // tp}"
                         f", tp={tp}")
    lat = Mesh((world,), ("lat",))
    out = dict(rank=rank, world=world, dp=world // tp, tp=tp,
               device=str(device), seconds={})

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out[label] = fn(*args)
        out["seconds"][label] = time.perf_counter() - t0

    timed("training", phase_training, mesh, L, device)
    timed("predict", phase_predict, mesh, L, device)
    with tempfile.TemporaryDirectory() as bindir:
        write_synthetic_boundary(bindir, SEED)
        sp = Speedy(ModelConfig(dtype="float32"), bindir, device=device)
        sp.initialize(year=1982, month=1)
        timed("ensemble", phase_ensemble, Communicator(), rank, world,
              sp.dy, device)
        timed("lat_physics", phase_lat_physics, lat, sp)
        timed("ocean", phase_ocean, mesh, L, device)
        timed("composed", phase_composed, lat, sp, device)
    return out


def main(argv=None) -> int:
    import os

    from .launch import init_torchrun, run_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=4,
                    help="ranks to spawn (ignored under torchrun)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist
        rank, world, device = init_torchrun(args.backend, args.device)
        try:
            results = [dryrun_rank(rank, world, device)]
        finally:
            dist.destroy_process_group()
    else:
        if args.device == "cuda" and not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to run the "
                             "ranks on the CPU")
        device = "cuda:0" if args.device == "cuda" else "cpu"
        results = run_ranks(dryrun_rank, args.nproc, args.backend,
                            [device] * args.nproc)
    for r in results:
        print(json.dumps(r))
    r = results[0]
    print(f"dryrun OK on {r['world']} ranks ({args.backend}, "
          f"{args.device}; dp={r['dp']}, tp={r['tp']}, lat={r['world']}) "
          f"in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
