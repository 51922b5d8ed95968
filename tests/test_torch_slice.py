"""The port's main path against the JAX package's: two closed-loop dry
hybrid steps, and one full-physics hybrid step, at the full T30L8 grid (1152
regions) with a narrow reservoir (m_target = n_in, deg 4, as
tests/test_fastloop.py:36-37).

The JAX side is the composition of bench.py:288-304 (window, pack,
standardize, ESN step, scatter) on the dry window; the port side is
speedyml_torch's HybridRunner.run. Both windows run in float64, the ESN in
float32, from the same numpy-seeded weights, standardizer and state.

Tolerances: grid fields to 2e-4 of each field's range and reservoir states
to 1e-5. The windows agree to float64 rounding; what remains is float32
rounding of the packed values (~3e-5 K on 300 K) carried through the
standardized readout. The full-physics step starts from a spun-up model
state on seeded stand-in boundary files and takes the runner's defaults
(climatological SST, analytic diurnal TISR); it is one step, since a second
would start its window from a float32-rounded state on each side, and the
moist schemes' triggers amplify that (tests/test_fused_datagen.py:25-29).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.core.calendar import ModelDate as JaxDate
from speedyml.core.config import ModelConfig, ReservoirConfig
from speedyml.coupler.daily import init_coupler_state as jax_init_coupler
from speedyml.domain import decomposition as jdec
from speedyml.domain import standardize as jstd
from speedyml.dynamics.core import Dycore as JaxDycore
from speedyml.hybrid.forecast import SpeedyForecaster as JaxForecaster
from speedyml.hybrid.state_io import GridState as JaxGridState
from speedyml.model import Speedy as JaxSpeedy
from speedyml.physics.radiation import diurnal_tisr as jax_diurnal_tisr
from speedyml.reservoir import esn as jesn
import speedyml_torch
from speedyml_torch import convert
from speedyml_torch.dynamics.core import Dycore
from speedyml_torch.hybrid.experiment import HybridModel, HybridRunner
from speedyml_torch.hybrid.forecast import SpeedyForecaster
from speedyml_torch.hybrid.state_io import extract
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.model import Speedy
from speedyml_torch.reservoir.generate import generate_esn

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

# the port's entry points build on the card unless told otherwise; these
# tests run on the CPU and say so
CPU = "cpu"


def to_cpu(a, dtype=None):
    return convert.tensor(a, CPU, dtype)

QMIN = 1e-6
N_STEPS = 2


def _smooth_state(jd, seed=0):
    rng = np.random.default_rng(seed)
    mx, nx, kx = jd.config.mx, jd.config.nx, jd.config.kx

    def smooth_spec(scale):
        sp = rng.normal(size=(mx, 2, nx)) * np.exp(
            -0.1 * (np.arange(nx)[None, None, :]
                    + np.arange(mx)[:, None, None]))
        return jd.T.host_trunct(sp) * scale

    def smooth2d(scale):
        return jd.T.host_spec_to_grid(smooth_spec(scale))

    t = 250.0 + np.stack([smooth2d(0.8) for _ in range(kx)])
    u, v = (np.asarray(a) for a in jd.T.uv_grid(
        jnp.asarray(np.stack([smooth_spec(1e-7) for _ in range(kx)])),
        jnp.asarray(np.stack([smooth_spec(5e-8) for _ in range(kx)]))))
    q = 5.0 + np.stack([smooth2d(0.1) for _ in range(kx)])
    atmo = np.stack([t, u, v, np.maximum(q, QMIN)]).astype(np.float32)
    return atmo, smooth2d(0.005).astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    cfg = ModelConfig(dtype="float64")
    jd = JaxDycore(cfg)
    L = jdec.build_layout(radang_deg=np.degrees(np.asarray(jd.tables.radang)))
    rng = np.random.default_rng(0)
    # the port draws the reservoir from the same numpy helpers and finds
    # its radius in torch, which is quicker here at 1152 regions
    tp = generate_esn(0, L.R, L.n_in, L.n_out, n_model=L.n_out,
                      m_target=L.n_in, deg=4, device=CPU)
    na = L.n_out + tp.n
    params = jesn.EsnParams(
        a_idx=jnp.asarray(tp.a_idx.numpy(), jnp.int32),
        a_val=jnp.asarray(tp.a_val.numpy()), win=jnp.asarray(tp.win.numpy()),
        wout=jnp.asarray(
            0.003 * rng.standard_normal((L.R, L.n_out, na), np.float32)),
        node_map=jnp.asarray(tp.node_map.numpy(), jnp.int32),
        leakage=tp.leakage, a_shift=jnp.asarray(tp.a_shift, jnp.int32))
    atmo, logp = _smooth_state(jd)
    lat = np.asarray(jd.tables.radang)[:, None]
    sst = np.broadcast_to(272.0 + 28.0 * np.cos(lat) ** 2,
                          (L.il, L.ix)).astype(np.float32)
    tisr = np.broadcast_to(1361.0 * np.maximum(np.cos(lat), 0.0),
                           (L.il, L.ix)).astype(np.float32)
    pr0 = np.zeros_like(logp)
    # standardizer anchored to the initial state (tests/test_fastloop.py:59)
    gv0 = np.asarray(jdec.pack_global(L, *map(jnp.asarray, (
        atmo, logp, pr0, sst, tisr))))
    stz = jstd.Standardizer(
        in_mean=jnp.asarray(gv0[L.input_index]),
        in_std=jnp.asarray(np.full((L.R, L.n_in), 5.0, np.float32)),
        out_mean=jnp.asarray(gv0[L.target_index]),
        out_std=jnp.asarray(np.ones((L.R, L.n_out), np.float32)))
    x0 = (0.1 * rng.standard_normal((L.R, params.n))).astype(np.float32)
    return jd, L, params, stz, atmo, logp, pr0, sst, tisr, x0


def _jax_steps(problem):
    """bench.py:288-304 on the dry window."""
    jd, L, params, stz, atmo, logp, pr_t, sst, tisr, x = problem
    sp = SimpleNamespace(config=jd.config, dy=jd, phys=None)
    win_fn = JaxForecaster(sp, physics=False)._window_fn()
    eps = ReservoirConfig().precip_epsilon
    f32 = jnp.float32
    idx, tidx = jnp.asarray(L.input_index), jnp.asarray(L.target_index)

    @jax.jit
    def hybrid_step(params, stz, x, atmo, logp, precip_t, forcing):
        gs = JaxGridState(t=atmo[0], u=atmo[1], v=atmo[2],
                          q=jnp.maximum(atmo[3], 0.0), logp=logp)
        res = win_fn(gs, None, forcing)
        f_atmo = jnp.stack([res.gs.t, res.gs.u, res.gs.v,
                            jnp.maximum(res.gs.q, QMIN)]).astype(f32)
        f_pr = jnp.log1p(jnp.maximum(res.precip_mm, 0.0) / eps).astype(f32)
        model_gv = jdec.pack_global(L, f_atmo, res.gs.logp.astype(f32), f_pr,
                                    sst, tisr)
        gv = jdec.pack_global(L, atmo, logp, precip_t, sst, tisr)
        u = jstd.standardize_in(stz, gv[idx])
        mv = jstd.standardize_out(stz, model_gv[tidx])
        x, out_std = jesn.predict_step(params, x, u, mv)
        out = jstd.unstandardize_out(stz, out_std)
        a2, logp2, pr2 = jdec.scatter_outputs(L, out)
        a2 = a2.at[3].set(jnp.maximum(a2[3], QMIN))
        return x, a2, logp2, jnp.maximum(pr2, 0.0), res.safe

    outs = []
    for _ in range(N_STEPS):
        x, atmo, logp, pr_t, safe = hybrid_step(params, stz, x, atmo, logp,
                                                pr_t, jd.zero_forcing())
        assert bool(safe)
        outs.append((np.asarray(atmo), np.asarray(logp)))
    return outs, np.asarray(x)


def test_two_dry_hybrid_steps(problem):
    jd, L, params, stz, atmo, logp, pr0, sst, tisr, x0 = problem
    ref, x_ref = _jax_steps(problem)

    td = Dycore(convert.model_config(ModelConfig(dtype="float64")),
                device=CPU)
    hm = HybridModel(layout=convert.region_layout(L),
                     params=convert.esn_params(params, CPU),
                     stz=convert.standardizer(stz, CPU),
                     rcfg=convert.reservoir_config(ReservoirConfig()))
    runner = HybridRunner(hm, SpeedyForecaster.dry(td))
    out = runner.run(to_cpu(x0), atmo, logp, pr0,
                     speedyml_torch.ModelDate(1982, 1, 15, 0), N_STEPS,
                     sst_fn=lambda d: sst, tisr_fn=lambda d: tisr)
    assert not out["aborted"]
    assert out["atmo"].shape == (N_STEPS, 4, L.kx, L.il, L.ix)
    d = out["date"]
    assert (d.iyear, d.imonth, d.iday, d.ihour) == (1982, 1, 15, 12)
    for i, (a_ref, lp_ref) in enumerate(ref):
        a = out["atmo"][i].numpy()
        assert np.isfinite(a).all()
        for v in range(4):
            np.testing.assert_allclose(a[v], a_ref[v], rtol=0,
                                       atol=2e-4 * np.ptp(a_ref[v]),
                                       err_msg=f"step {i} var {v}")
        np.testing.assert_allclose(out["logp"][i].numpy(), lp_ref, rtol=0,
                                   atol=2e-4 * np.ptp(lp_ref))
    np.testing.assert_allclose(out["x"].numpy(), x_ref, rtol=0, atol=1e-5)


def test_step_split_and_writers(problem, tmp_path):
    """HybridModel.step_split against the JAX package's (the fields to 2e-4
    of range as above, the components alike), atmo == atmo_ml + atmo_p to
    float32 rounding; then one dry step of the runner with a writer and the
    component writers: what lands in the files is what run() returns."""
    from speedyml.hybrid.experiment import HybridModel as JaxHybridModel
    from speedyml_torch.io.output import ForecastWriter, read_forecast
    jd, L, params, stz, atmo, logp, pr0, sst, tisr, x0 = problem
    rng = np.random.default_rng(4)
    gv = np.asarray(jdec.pack_global(L, *map(jnp.asarray, (
        atmo, logp, pr0, sst, tisr))))
    mgv = (gv + 0.05 * rng.standard_normal(gv.shape)).astype(np.float32)
    hj = JaxHybridModel(layout=L, params=params, stz=stz,
                        rcfg=ReservoirConfig(), ml_only=False)
    hm = HybridModel(layout=convert.region_layout(L),
                     params=convert.esn_params(params, CPU),
                     stz=convert.standardizer(stz, CPU),
                     rcfg=convert.reservoir_config(ReservoirConfig()))
    want = hj.step_split(jnp.asarray(x0), jnp.asarray(gv), jnp.asarray(mgv))
    got = hm.step_split(to_cpu(x0), to_cpu(gv), to_cpu(mgv))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-5)
    for g, w in zip(got[1:4], want[1:4]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-4 * np.ptp(w))
    comp, jcomp = got[4], want[4]
    assert sorted(comp) == sorted(jcomp)
    for k in comp:
        w = np.asarray(jcomp[k])
        np.testing.assert_allclose(comp[k].numpy(), w, rtol=0,
                                   atol=2e-4 * max(np.ptp(w), 1.0))
    # the parts add up to the whole (q above its floor everywhere here)
    total = comp["atmo_ml"] + comp["atmo_p"]
    np.testing.assert_allclose(total.numpy(), got[1].numpy(), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose((comp["logp_ml"] + comp["logp_p"]).numpy(),
                               got[2].numpy(), rtol=1e-6, atol=1e-6)
    # step() is the same step
    plain = hm.step(to_cpu(x0), to_cpu(gv), to_cpu(mgv))
    assert torch.equal(plain[0], got[0])
    np.testing.assert_allclose(plain[1].numpy(), got[1].numpy(), rtol=1e-6,
                               atol=1e-4)
    with pytest.raises(ValueError):
        dataclasses.replace(hm, ml_only=True).step_split(
            to_cpu(x0), to_cpu(gv), to_cpu(mgv))

    td = Dycore(convert.model_config(ModelConfig(dtype="float64")),
                device=CPU)
    runner = HybridRunner(hm, SpeedyForecaster.dry(td))
    paths = [str(tmp_path / f"{n}.nc") for n in ("all", "ml", "p")]
    # the component files hold the 3-D fields and logp only
    writers = [ForecastWriter(p, L.kx, L.il, L.ix, with_precip=i == 0,
                              with_sst=i == 0)
               for i, p in enumerate(paths)]
    out = runner.run(to_cpu(x0), atmo, logp, pr0,
                     speedyml_torch.ModelDate(1982, 1, 15, 0), 2,
                     sst_fn=lambda d: sst, tisr_fn=lambda d: tisr,
                     writer=writers[0], component_writers=writers[1:])
    for w in writers:
        w.close()
    whole, ml, p = (read_forecast(q) for q in paths)
    assert whole["Temperature"].shape == (2, L.kx, L.il, L.ix)
    np.testing.assert_array_equal(whole["Temperature"],
                                  out["atmo"][:, 0].numpy())
    np.testing.assert_array_equal(whole["p6hr"], out["precip_mm"].numpy())
    np.testing.assert_array_equal(whole["SST"], out["sst"].numpy())
    np.testing.assert_allclose(ml["U-wind"] + p["U-wind"], whole["U-wind"],
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(ml["logp"] + p["logp"], whole["logp"],
                               rtol=1e-6, atol=1e-6)


def test_full_physics_hybrid_step(problem, tmp_path):
    """One hybrid step whose window is the full-physics one: the port's
    HybridRunner.run with its default SST and TISR against the JAX
    composition (forecast with sst_hybrid, pack, standardize, ESN step,
    scatter), from a spun-up state."""
    _, L, params, _, _, _, _, _, _, x0 = problem
    bindir = write_synthetic_boundary(str(tmp_path / "bc"), seed=2)
    tm = Speedy(convert.model_config(ModelConfig(dtype="float64")), bindir,
                device=CPU)
    tm.initialize(1982, 1)
    tm.run_days(1)
    gs = extract(tm.dy, tm.state)
    atmo = torch.stack([gs.t, gs.u, gs.v, torch.clamp(gs.q, min=QMIN)]) \
        .to(torch.float32).numpy()
    logp = gs.logp.to(torch.float32).numpy()
    pr0 = np.zeros_like(logp)
    when = (1982, 1, 2, 0)

    # the JAX side: its own climatological SST and diurnal TISR, its own
    # full-physics window
    jm = JaxSpeedy(ModelConfig(dtype="float64"), bindir=bindir)
    sst = np.asarray(jax_init_coupler(jm.clim, JaxDate(*when)).sst_am)
    tisr = jax_diurnal_tisr(JaxDate(*when).tyear, 0, jm.dy.tables.gsin,
                            jm.dy.tables.gcos, L.ix)
    f32 = jnp.float32
    gv0 = np.asarray(jdec.pack_global(L, *(jnp.asarray(a, f32) for a in (
        atmo, logp, pr0, np.maximum(sst, 272.0), tisr))))
    stz = jstd.Standardizer(
        in_mean=jnp.asarray(gv0[L.input_index]),
        in_std=jnp.asarray(np.full((L.R, L.n_in), 5.0, np.float32)),
        out_mean=jnp.asarray(gv0[L.target_index]),
        out_std=jnp.asarray(np.ones((L.R, L.n_out), np.float32)))
    res = JaxForecaster(jm).forecast(
        JaxGridState(t=atmo[0], u=atmo[1], v=atmo[2],
                     q=np.maximum(atmo[3], 0.0), logp=logp),
        JaxDate(*when), sst_hybrid=sst)
    assert bool(res.safe)
    assert float(res.precip_mm.max()) > 0.0
    eps = ReservoirConfig().precip_epsilon
    f_atmo = jnp.stack([res.gs.t, res.gs.u, res.gs.v,
                        jnp.maximum(res.gs.q, QMIN)]).astype(f32)
    f_pr = jnp.log1p(jnp.maximum(res.precip_mm, 0.0) / eps).astype(f32)
    bnd = (jnp.maximum(jnp.asarray(sst, f32), 272.0), jnp.asarray(tisr, f32))
    model_gv = jdec.pack_global(L, f_atmo, res.gs.logp.astype(f32), f_pr,
                                *bnd)
    gv = jdec.pack_global(L, jnp.asarray(atmo), jnp.asarray(logp),
                          jnp.asarray(pr0), *bnd)
    u = jstd.standardize_in(stz, gv[jnp.asarray(L.input_index)])
    mv = jstd.standardize_out(stz, model_gv[jnp.asarray(L.target_index)])
    x_ref, out_std = jesn.predict_step(params, jnp.asarray(x0), u, mv)
    a_ref, lp_ref, pr_ref = (np.asarray(v) for v in jdec.scatter_outputs(
        L, jstd.unstandardize_out(stz, out_std)))

    hm = HybridModel(layout=convert.region_layout(L),
                     params=convert.esn_params(params, CPU),
                     stz=convert.standardizer(stz, CPU),
                     rcfg=convert.reservoir_config(ReservoirConfig()))
    runner = HybridRunner(hm, SpeedyForecaster(tm))
    out = runner.run(to_cpu(x0), atmo, logp, pr0,
                     speedyml_torch.ModelDate(*when), 1)
    assert not out["aborted"]
    # the defaults are the climatological SST and the diurnal TISR
    np.testing.assert_allclose(out["sst"][0].numpy(), sst.astype(np.float32))
    a = out["atmo"][0].numpy()
    for v in range(3):
        np.testing.assert_allclose(a[v], a_ref[v], rtol=0,
                                   atol=2e-4 * np.ptp(a_ref[v]),
                                   err_msg=f"var {v}")
    np.testing.assert_allclose(a[3], np.maximum(a_ref[3], QMIN), rtol=0,
                               atol=2e-4 * np.ptp(a_ref[3]))
    np.testing.assert_allclose(out["logp"][0].numpy(), lp_ref, rtol=0,
                               atol=2e-4 * np.ptp(lp_ref))
    # the precipitation channel (log1p units, clamped to its support)
    cap = np.log1p(ReservoirConfig().precip_cap_mm / eps)
    np.testing.assert_allclose(out["precip_t"].numpy(),
                               np.clip(pr_ref, 0.0, cap), rtol=0, atol=2e-3)
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(x_ref), rtol=0,
                               atol=1e-5)
    # an ML-only runner has no forecaster and takes the climatology and the
    # dycore's latitudes directly; its defaults are the same fields
    ml = HybridRunner(dataclasses.replace(hm, ml_only=True), None,
                      clim=tm.clim, dy=tm.dy)
    np.testing.assert_array_equal(
        ml._sst(speedyml_torch.ModelDate(*when)), sst)
    np.testing.assert_array_equal(
        ml._tisr(speedyml_torch.ModelDate(*when)), tisr)
    with pytest.raises(ValueError):
        SpeedyForecaster(None, physics=True, dy=tm.dy)
    # without a climatology the runner says what it needs
    bare = HybridRunner(hm, SpeedyForecaster.dry(tm.dy))
    with pytest.raises(ValueError):
        bare.run(to_cpu(x0), atmo, logp, pr0,
                 speedyml_torch.ModelDate(*when), 1)
