"""speedyml_torch.parallel on 4 gloo CPU ranks against the port's
single-device functions and against speedyml.parallel on the virtual CPU
mesh (conftest's 8 devices; meshes of the same shape: make_mesh(4, tp=2)
and a 4-device ("lat",) mesh).

The ranks are started once for the module (tests/torch_parallel_ranks.py,
which imports torch and speedyml_torch only) and return what they hold
whole; the references run here.

Tolerances:
  * sharded fold and predict state against the port's single-device drive:
    bitwise (the same operations on each region and node row; the fold
    takes whole regions through the same compensated fold);
  * the predict readout against the port's: rtol 1e-6 (the tp ranks'
    partial products are summed by an all-reduce, in another order);
  * against JAX's sharded drive and predict step: tests/test_parallel.py's
    1e-5 and 1e-4;
  * latitude-sharded dry step and 24 steps: tests/test_spatial.py:66,82
    (rtol 1e-11 / atol 1e-13; 1e-9 / 1e-12), against the port's
    single-device steps and against JAX's SpatialDycore;
  * one full-physics step, float64 on stand-in boundary files:
    tests/test_spatial.py:114-121 (rtol 1e-9), against both;
  * composed dry step: against JAX's ComposedHybridStep(physics=False) at
    1e-5 of each output's scale (tests/test_composed.py:110-113 allows
    3e-4; measured 2.3e-6 at most, in precip_t), and against the port's
    single-device hybrid step at the same 1e-5 (measured: equal; the
    window's float64 rounding differences vanish in the float32 outputs);
  * composed full-physics step: the global gate holds, every output is
    finite, and within 1e-5 of each output's scale of the port's
    single-device step, as the dry step (tests/test_composed.py:169-172
    allows 2e-3; measured: equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import torch_parallel_ranks as ranks
from speedyml.core.config import ModelConfig as JaxConfig
from speedyml.core.config import ReservoirConfig as JaxReservoirConfig
from speedyml.domain.decomposition import build_layout as jax_layout
from speedyml.domain.standardize import Standardizer as JaxStandardizer
from speedyml.dynamics.core import Dycore as JaxDycore
from speedyml.dynamics.core import Forcing as JaxForcing
from speedyml.dynamics.state import SpectralState as JaxState
from speedyml.hybrid.experiment import HybridModel as JaxHybridModel
from speedyml.model import Speedy as JaxSpeedy
from speedyml.parallel import mesh as jmesh
from speedyml.parallel.composed import ComposedHybridStep as JaxComposed
from speedyml.parallel.spatial import SpatialDycore as JaxSpatial
from speedyml.physics import driver as jdrv
from speedyml.reservoir.esn import predict_step as jax_predict
from speedyml.reservoir.generate import generate_esn as jax_generate
from speedyml.reservoir.training import \
    drive_and_accumulate as jax_drive
from speedyml.reservoir.training import init_normal_eq as jax_init
from speedyml_torch import ModelConfig, convert
from speedyml_torch.dynamics.core import Dycore
from speedyml_torch.dynamics.initial import rest_state
from speedyml_torch.hybrid.experiment import QMIN, atmo_to_grid
from speedyml_torch.hybrid.forecast import SpeedyForecaster
from speedyml_torch.hybrid.state_io import extract
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.model import Speedy
from speedyml_torch.parallel.composed import single_device_step
from speedyml_torch.parallel.launch import run_ranks
from speedyml_torch.reservoir.esn import predict_step
from speedyml_torch.reservoir.training import (drive_and_accumulate,
                                               init_normal_eq)

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

CPU = "cpu"
W = 4
CHUNK = 4
COMPOSED_TOL = 1e-5


def _esn_setup(R=16, n_in=24, n_out=8, n_model=8, T=12):
    """tests/test_parallel.py's _setup, and its predict start state."""
    params = jax_generate(3, R, n_in, n_out, n_model, m_target=2 * n_in,
                          deg=4)
    rng = np.random.default_rng(0)
    params = params._replace(
        wout=jnp.asarray(rng.normal(size=params.wout.shape) * 0.1,
                         jnp.float32))
    u, y, m = (rng.normal(size=(T, R, k)).astype(np.float32)
               for k in (n_in, n_out, n_model))
    x0 = (np.random.default_rng(1).normal(size=(R, params.win.shape[1]))
          * 0.1).astype(np.float32)
    return params, u, y, m, x0


def _esn_arrays(p, prefix=""):
    out = {prefix + f: np.asarray(getattr(p, f)) for f in
           ("a_idx", "a_val", "win", "wout", "node_map")}
    out[prefix + "leakage"] = float(p.leakage)
    out[prefix + "a_shift"] = (None if p.a_shift is None
                               else np.asarray(p.a_shift))
    return out


def _perturbed_state(dy, seed):
    """tests/test_spatial.py's rest state plus a smooth perturbation, on
    the port's rest state; numpy (vor, div, t, ps, tr)."""
    rng = np.random.default_rng(seed)
    state = rest_state(dy)

    def bump(a, scale):
        a = a.numpy()
        p = rng.normal(size=a.shape) * scale
        p[..., 11:, :, :] = 0.0
        p[..., :, :, 11:] = 0.0
        return a + p

    return (bump(state.vor, 2e-6), bump(state.div, 1e-6),
            bump(state.t, 0.2), bump(state.ps, 1e-3), state.tr.numpy())


def _np(tree):
    return [a.numpy() for a in tree]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs every piece starts from, built once: the reservoirs and
    series; a dry state; a float64 model on stand-in files, one day from
    rest; the composed step's model (tests/test_composed.py's setup: the
    full layout, a small random readout) saved for the ranks."""
    tmp = tmp_path_factory.mktemp("parallel")
    bindir = write_synthetic_boundary(str(tmp / "bc"), seed=9)
    jp, u, y, m, x0 = _esn_setup()
    esn = dict(_esn_arrays(jp), u=u, y=y, m=m, x0=x0)

    dry_dy = Dycore(ModelConfig(dtype="float64"), device=CPU)
    dry_state = _perturbed_state(dry_dy, seed=3)

    tm = Speedy(ModelConfig(dtype="float64"), bindir, device=CPU)
    tm.initialize(1982, 1)
    tm.run_days(1)
    surf, forcing = tm.surf_forcing(tm.date)
    physics = dict(state=_np(tm.state), surf=_np(surf), rad=_np(tm.rad),
                   forcing=_np(forcing))

    radang_deg = np.degrees(np.asarray(tm.dy.tables.radang))
    JL = jax_layout(radang_deg=radang_deg)
    rng = np.random.default_rng(0)
    p6 = jax_generate(0, JL.R, JL.n_in, JL.n_out, n_model=JL.n_out,
                      m_target=JL.n_in, deg=4)
    na = JL.n_out + p6.win.shape[1]
    p6 = p6._replace(wout=jnp.asarray(
        0.02 * rng.normal(size=(JL.R, JL.n_out, na)), jnp.float32))

    def f32(a):
        return jnp.asarray(a, jnp.float32)
    stz = JaxStandardizer(
        in_mean=f32(rng.normal(size=(JL.R, JL.n_in)) * 0.1),
        in_std=f32(1.0 + 0.1 * rng.random((JL.R, JL.n_in))),
        out_mean=f32(rng.normal(size=(JL.R, JL.n_out)) * 0.1),
        out_std=f32(1.0 + 0.1 * rng.random((JL.R, JL.n_out))))
    jhm = JaxHybridModel(layout=JL, params=p6, stz=stz,
                         rcfg=JaxReservoirConfig(), ml_only=False)
    model_path = str(tmp / "model.npz")
    np.savez(model_path, **_esn_arrays(p6),
             **{"stz_" + f: np.asarray(getattr(stz, f))
                for f in stz._fields})
    gs = extract(tm.dy, tm.state)
    atmo = np.stack([gs.t.numpy(), gs.u.numpy(), gs.v.numpy(),
                     np.maximum(gs.q.numpy(), QMIN)]).astype(np.float32)
    logp = gs.logp.numpy().astype(np.float32)
    fsol = np.abs(surf.fsol.numpy()).astype(np.float32)
    composed = dict(
        model=model_path, atmo=atmo, logp=logp,
        precip_t=np.zeros_like(logp),
        sst=np.asarray(tm.coupler.sst_am, np.float32),
        tisr=fsol[:, None] * np.ones((1, tm.config.ix), np.float32),
        x0=(rng.normal(size=(JL.R, p6.win.shape[1])) * 0.1).astype(
            np.float32),
        surf=physics["surf"], forcing=physics["forcing"])
    cfg = dict(bindir=bindir, esn=esn, dry_state=dry_state, physics=physics,
               composed=composed)
    return dict(cfg=cfg, jp=jp, tm=tm, surf=surf, forcing=forcing,
                dry_dy=dry_dy, jhm=jhm, bindir=bindir)


@pytest.fixture(scope="module")
def rank_out(setup):
    """What each of the 4 gloo CPU ranks holds whole."""
    return run_ranks(ranks.rank_main, W, "gloo", [CPU] * W,
                     args=(setup["cfg"],), threads=1)


@pytest.fixture(scope="module")
def lat_mesh():
    return JaxMesh(np.array(jax.devices()[:W]), ("lat",))


def close(got, want, rtol, atol, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=name)


# ----------------------------------------------------------------------
# the reservoirs: regions over dp, nodes over tp
# ----------------------------------------------------------------------
def test_sharded_fold_matches_single_device(setup, rank_out):
    """Gathered ss/sy (hi and lo) and x equal the single-device fold
    bitwise; JAX's sharded fold within test_parallel.py's 1e-5."""
    e = setup["cfg"]["esn"]
    got = rank_out[0]
    p = convert.esn_params(setup["jp"], CPU)
    acc = init_normal_eq(p, e["y"].shape[-1])
    ref = drive_and_accumulate(p, acc, torch.as_tensor(e["u"]),
                               torch.as_tensor(e["y"]),
                               torch.as_tensor(e["m"]), chunk=CHUNK)
    for name in ("ss_hi", "ss_lo", "sy_hi", "sy_lo", "x"):
        np.testing.assert_array_equal(got["fold_" + name],
                                      getattr(ref, name).numpy(), name)

    mesh = jmesh.make_mesh(W, tp=2)
    jp = setup["jp"]
    sp = jmesh.shard_params(jp, mesh)
    series = jmesh.series_sharding(mesh)
    uu, yy, mm = (jax.device_put(jnp.asarray(e[k]), series) for k in "uym")
    acc0 = jax_init(jp, e["y"].shape[-1])
    accs = jax.tree.map(
        lambda a: jax.device_put(a, jmesh.region_sharding(mesh)), acc0)
    accs = accs._replace(x=jax.device_put(acc0.x,
                                          jmesh.state_sharding(mesh)))
    jout = jax.jit(lambda a, u, y, m: jax_drive(sp, a, u, y, m,
                                                chunk=CHUNK))(accs, uu, yy,
                                                              mm)
    close(got["fold_ss_hi"], jout.ss_hi, 1e-5, 1e-5, "ss_hi")
    close(got["fold_sy_hi"], jout.sy_hi, 1e-5, 1e-5, "sy_hi")
    close(got["fold_x"], jout.x, 1e-5, 1e-6, "x")


def test_sharded_predict_matches_single_device(setup, rank_out):
    """The predict step: the state bitwise, the tp readout to rtol 1e-6 of
    the port's single-device step; JAX's sharded step within 1e-5/1e-4.
    Its collectives: one all-gather of x and one all-reduce of the
    readout over tp, then the test's gathers."""
    e = setup["cfg"]["esn"]
    got = rank_out[0]
    p = convert.esn_params(setup["jp"], CPU)
    x_ref, out_ref = predict_step(p, torch.as_tensor(e["x0"]),
                                  torch.as_tensor(e["u"][0]),
                                  torch.as_tensor(e["m"][0]))
    np.testing.assert_array_equal(got["predict_x"], x_ref.numpy())
    close(got["predict_out"], out_ref.numpy(), 1e-6, 1e-7, "out")

    mesh = jmesh.make_mesh(W, tp=2)
    sp = jmesh.shard_params(setup["jp"], mesh)
    regions = jmesh.region_sharding(mesh)
    xs = jax.device_put(jnp.asarray(e["x0"]), jmesh.state_sharding(mesh))
    jx, jy = jax.jit(lambda x, u, m: jax_predict(sp, x, u, m))(
        xs, jax.device_put(jnp.asarray(e["u"][0]), regions),
        jax.device_put(jnp.asarray(e["m"][0]), regions))
    close(got["predict_x"], jx, 1e-5, 1e-6, "x")
    close(got["predict_out"], jy, 1e-4, 1e-5, "out")


# ----------------------------------------------------------------------
# the latitude-sharded step
# ----------------------------------------------------------------------
def _jax_state(arrays):
    return JaxState(*(jnp.asarray(a) for a in arrays))


def test_lat_sharded_dry_step(setup, rank_out, lat_mesh):
    dy = setup["dry_dy"]
    state = ranks.tensors(type(rest_state(dy)), setup["cfg"]["dry_state"])
    ref = dy.step(state, dy.zero_forcing(), 1, 1, "delt2")
    jdy = JaxDycore(JaxConfig(dtype="float64"))
    jsd = JaxSpatial(jdy, lat_mesh, axis="lat")
    jref = jax.jit(jsd.step_fn())(_jax_state(setup["cfg"]["dry_state"]),
                                  jdy.zero_forcing())
    for i, name in enumerate(ref._fields):
        got = rank_out[0]["dry_step"][i]
        close(got, getattr(ref, name).numpy(), 1e-11, 1e-13, name)
        close(got, getattr(jref, name), 1e-11, 1e-13, name)


def test_lat_sharded_run_steps(setup, rank_out, lat_mesh):
    """24 steps: the error does not grow; four all-reduces (forward
    transforms) a step and no other collective."""
    dy = setup["dry_dy"]
    state = ranks.tensors(type(rest_state(dy)), setup["cfg"]["dry_state"])
    ref = dy.run_steps(state, dy.zero_forcing(), 24)
    jdy = JaxDycore(JaxConfig(dtype="float64"))
    jsd = JaxSpatial(jdy, lat_mesh, axis="lat")
    jref = jax.jit(jsd.run_steps_fn(24))(
        _jax_state(setup["cfg"]["dry_state"]), jdy.zero_forcing())
    for i, name in enumerate(ref._fields[:4]):
        got = rank_out[0]["dry_run"][i]
        close(got, getattr(ref, name).numpy(), 1e-9, 1e-12, name)
        close(got, getattr(jref, name), 1e-9, 1e-12, name)
    comm = rank_out[0]["dry_run_comm"]
    assert comm["all_reduce"]["calls"] == 4 * 24
    assert comm["all_gather"]["calls"] == 0


def test_lat_sharded_physics_step(setup, rank_out, lat_mesh):
    """One full-physics step with surf and rad split over latitude: the
    state, the radiation carry and the fluxes, gathered."""
    tm, surf, forcing = setup["tm"], setup["surf"], setup["forcing"]
    ref, (ref_rad, ref_fx) = tm.dy.step(
        tm.state, forcing, 1, 1, "delt2", tm._phys_fn(surf, tm.rad, True))
    ph = setup["cfg"]["physics"]
    jm = JaxSpeedy(JaxConfig(dtype="float64"), bindir=setup["bindir"])
    jsd = JaxSpatial(jm.dy, lat_mesh, axis="lat", phys=jm.phys)
    jsurf = jdrv.SurfaceDailyState(*ph["surf"])
    jrad = jdrv.RadCarry(*(jnp.asarray(a) for a in ph["rad"]))
    fn = jsd.wrap_physics(jsurf, jrad, lradsw=True)
    jst, jrad2, jfx = jax.jit(fn)(
        _jax_state(ph["state"]), JaxForcing(*ph["forcing"]),
        jsd.shard_surface(jsurf), jsd.shard_surface(jrad))
    got = rank_out[0]
    for i, name in enumerate(ref._fields):
        close(got["phys_state"][i], getattr(ref, name).numpy(), 1e-9,
              1e-11, name)
        close(got["phys_state"][i], getattr(jst, name), 1e-9, 1e-11, name)
    for i, name in enumerate(ref_fx._fields):
        close(got["phys_fluxes"][i], getattr(ref_fx, name).numpy(), 1e-9,
              1e-9, name)
        close(got["phys_fluxes"][i], getattr(jfx, name), 1e-9, 1e-9, name)
    for i, name in enumerate(ref_rad._fields):
        close(got["phys_rad"][i], getattr(ref_rad, name).numpy(), 1e-9,
              1e-12, name)
        close(got["phys_rad"][i], getattr(jrad2, name), 1e-9, 1e-12, name)


# ----------------------------------------------------------------------
# the composed hybrid step
# ----------------------------------------------------------------------
def _single_step(setup, physics):
    """The port's single-device hybrid step on the composed inputs."""
    c = setup["cfg"]["composed"]
    hm = convert.hybrid_model(setup["jhm"], CPU)
    fc = SpeedyForecaster(setup["tm"], hours=hm.rcfg.timestep,
                          physics=physics)
    out = single_device_step(
        hm, fc, torch.as_tensor(c["x0"]),
        *(torch.as_tensor(c[k]) for k in ("atmo", "logp", "precip_t")),
        c["sst"], c["tisr"], setup["surf"], setup["forcing"])
    return dict(zip(NAMES, (t.numpy() for t in out[:4])),
                safe=bool(out[4]), steps=fc.nsteps_window + 1)


NAMES = ("x", "atmo", "logp", "precip_t")


def _close_outputs(got, want, rel, label):
    for name in NAMES:
        scale = np.abs(want[name]).max()
        np.testing.assert_allclose(got[name], want[name], rtol=rel,
                                   atol=rel * max(scale, 1e-30),
                                   err_msg=f"{label} {name}")


def test_composed_dry_step(setup, rank_out, lat_mesh):
    """The composed dry step against the port's single-device step and
    JAX's composed step; its collectives: one all-reduce per forward
    transform (5 for the injection, 4 per dycore step), one of the safety
    flags, the forecast grid's all-gather and the outputs'."""
    got = rank_out[0]["composed_dry"]
    want = _single_step(setup, physics=False)
    assert got["safe"] and want["safe"]
    _close_outputs(got, want, COMPOSED_TOL, "port")
    assert got["comm"]["all_reduce"]["calls"] == 5 + 4 * want["steps"] + 1
    assert got["comm"]["all_gather"]["calls"] == 2

    c = setup["cfg"]["composed"]
    jm = JaxSpeedy(JaxConfig(dtype="float64"), bindir=setup["bindir"])
    comp = JaxComposed(setup["jhm"], jm, lat_mesh, physics=False)
    jsurf = jdrv.SurfaceDailyState(*c["surf"])
    out = comp.step(jnp.asarray(c["x0"]), c["atmo"], c["logp"],
                    c["precip_t"], c["sst"], c["tisr"],
                    comp.shard_surface(jsurf), JaxForcing(*c["forcing"]))
    jwant = dict(zip(NAMES, (np.asarray(a) for a in out[:4])))
    assert bool(np.asarray(out[4]))
    _close_outputs(got, jwant, COMPOSED_TOL, "jax")


def test_composed_physics_step(setup, rank_out):
    """With full physics: the global gate holds, every output is finite,
    and within 1e-5 of scale of the port's single-device step."""
    got = rank_out[0]["composed_physics"]
    assert got["safe"]
    for name in NAMES:
        assert np.isfinite(got[name]).all(), name
    assert got["precip_t"].min() >= 0.0
    want = _single_step(setup, physics=True)
    assert want["safe"]
    _close_outputs(got, want, COMPOSED_TOL, "port")


def test_safety_gate_is_global(setup, rank_out):
    """Temperatures out of the safety bounds in one rank's latitude rows
    only: the all-reduced flag is False on every rank, as the
    single-device gate is on the whole grid."""
    assert [r["composed_unsafe_safe"] for r in rank_out] == [False] * W
    c = setup["cfg"]["composed"]
    bad = torch.as_tensor(c["atmo"]).clone()
    jl = setup["tm"].config.il // W
    bad[0, :, jl:2 * jl] = 400.0
    fc = SpeedyForecaster(setup["tm"], physics=False)
    res = fc.window(atmo_to_grid(bad, torch.as_tensor(c["logp"])),
                    setup["surf"], setup["forcing"])
    assert not bool(res.safe)


def test_replicated_results_agree_across_ranks(rank_out):
    """What every rank holds whole is the same on every rank, bitwise:
    the all-reduces and all-gathers hand each rank the same values."""
    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        else:
            np.testing.assert_array_equal(a, b, path)
    for r in range(1, W):
        walk(rank_out[0], rank_out[r], f"rank {r}")


# ----------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------
def test_a_failing_rank_fails_the_run():
    """A rank that raises makes run_ranks raise, with that rank's
    traceback, whether or not the rank waiting for it in a collective
    fails first; the waiting rank is stopped."""
    with pytest.raises(RuntimeError, match="rank 1 failed on purpose"):
        run_ranks(ranks.failing_rank, 2, "gloo", [CPU] * 2, args=(1,),
                  threads=1)


def test_nccl_is_not_replaced_by_gloo():
    """NCCL asked for where it cannot run fails: no rank carries on over
    gloo, or on another device."""
    if torch.distributed.is_nccl_available() and torch.cuda.is_available():
        pytest.skip("NCCL can run here")
    with pytest.raises(RuntimeError, match="1 of 1 ranks failed \\(nccl\\)"):
        run_ranks(ranks.failing_rank, 1, "nccl", [CPU], args=(-1,),
                  threads=1)
