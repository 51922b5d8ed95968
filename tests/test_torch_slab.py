"""speedyml_torch.reservoir.slab against speedyml.reservoir.slab.

The host functions (layout, weekly series, statistics, compose_sst,
training_anomaly_std) are the same numpy code and must agree exactly. The
device functions are held to the JAX package's on an ocean model that the
JAX package trained and convert.ocean_model carried over: float32, rtol
1e-5 (the same elementwise ops; the readout's dot product summed in another
order). train_ocean is held to the JAX one without training noise: the
active mask equal, the standardizer to 1e-6, and the fitted one-week
predictions to 0.5% of their range, the tolerance
tests/test_torch_training.py uses for trained readouts (float32 normal
equations rounded in another order, amplified by the ill-conditioned solve
in the readout's poorly determined directions only).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.coupler import climatology as jclim
from speedyml.domain.decomposition import build_layout as jax_build_layout
from speedyml.hybrid.experiment import transform_and_pack
from speedyml.reservoir import slab as jslab
from speedyml_torch import convert
from speedyml_torch.coupler import climatology as tclim
from speedyml_torch.hybrid import experiment as texp
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.reservoir import slab as tslab
from speedyml_torch.transforms.tables import build_tables
from tests.test_hybrid import _small_layout, _small_rcfg, _synthetic_truth

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

CPU = "cpu"


def to_cpu(a, dtype=None):
    return convert.tensor(a, CPU, dtype)


def _ocean_rcfg(**kw):
    # fast weekly cadence: 4 atmosphere steps per "week"; no training noise,
    # which the two packages draw from different generators
    return _small_rcfg(timestep_slab=24, slab_nodes=400, slab_noise_std=0.0,
                       sst_variance_threshold=0.2, **kw)


@pytest.mark.parametrize("ohtc", [False, True])
def test_build_ocean_layout(ohtc):
    L = jax_build_layout(ix=12, il=6, kx=2, nvars=4, resx=2, resy=2,
                         overlap=1, use_ohtc=ohtc)
    want = jslab.build_ocean_layout(L)
    got = tslab.build_ocean_layout(convert.region_layout(L))
    assert (got.n_in, got.n_out, got.R) == (want.n_in, want.n_out, want.R)
    assert got.sections == want.sections
    assert ("ohtc" in got.sections) == ohtc
    for f in ("input_index", "target_index"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tslab.build_ocean_layout(convert.region_layout(L), 0).input_index,
        jslab.build_ocean_layout(L, 0).input_index)
    back = convert.ocean_layout(want)
    assert type(back) is tslab.OceanLayout and back.sections == want.sections


def test_weekly_series_and_section_stats():
    L = _small_layout()
    rng = np.random.default_rng(0)
    s = rng.normal(size=(11, L.gv_len)).astype(np.float32)
    np.testing.assert_array_equal(tslab.weekly_average(s, 4),
                                  jslab.weekly_average(s, 4))
    w = tslab.weekly_ocean_inputs(s, 4, convert.region_layout(L))
    np.testing.assert_array_equal(w, jslab.weekly_ocean_inputs(s, 4, L))
    assert w.shape == (2, L.gv_len)
    ol = jslab.build_ocean_layout(L)
    series = rng.normal(size=(9, ol.R, ol.n_in))
    kw = dict(groups={"atmo_bot": L.nvars}, std_floors={"sst": 0.3})
    for a, b in zip(tslab._section_stats(series, ol.sections, **kw),
                    jslab._section_stats(series, ol.sections, **kw)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_compose_week_inputs():
    """float32, rtol 1e-5: one division by the week's length."""
    L = _small_layout()
    rng = np.random.default_rng(1)
    s = rng.normal(size=(4, L.gv_len)).astype(np.float32)
    want = np.asarray(jslab.compose_week_inputs(
        jnp.asarray(s[-1]), jnp.asarray(s.sum(axis=0)), 4, L))
    end = to_cpu(s[-1])
    got = tslab.compose_week_inputs(end, to_cpu(s.sum(axis=0)), 4,
                                    convert.region_layout(L))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_array_equal(end.numpy(), s[-1])      # out of place
    # and it agrees with weekly_ocean_inputs, which makes the training series
    np.testing.assert_allclose(
        got.numpy(), tslab.weekly_ocean_inputs(s, 4, L)[0], rtol=1e-5,
        atol=1e-6)


@pytest.fixture(scope="module")
def trained():
    """One truth series; the JAX package's trained ocean, the same model
    carried over, and the port's own training on the same series."""
    L = _small_layout()
    rcfg = _ocean_rcfg()
    atmo, logp, precip, sst, tisr = _synthetic_truth(L, 480, seed=21)
    gv = transform_and_pack(L, atmo, logp, precip, sst, tisr,
                            rcfg.precip_epsilon)
    om_j = jslab.train_ocean(L, rcfg, gv, seed=5)
    return L, rcfg, gv, om_j, convert.ocean_model(om_j, CPU)


def test_convert_ocean_model(trained):
    L, rcfg, gv, om_j, om_c = trained
    assert type(om_c) is tslab.OceanModel
    assert om_c.steps_per_week == om_j.steps_per_week == 4
    assert om_c.device == torch.device(CPU)
    assert om_c.params.wout.shape == om_j.params.wout.shape
    assert om_c.params.a_shift is not None
    np.testing.assert_array_equal(om_c.active, om_j.active)
    assert dataclasses.asdict(om_c.rcfg) == dataclasses.asdict(om_j.rcfg)
    assert om_c.maps().dtype == torch.int64 and om_c.maps() is om_c.maps()


def test_step_synchronize_open_loop(trained):
    L, rcfg, gv, om_j, om_c = trained
    gv_w = jslab.weekly_ocean_inputs(gv, 4, L)
    xj = om_j.synchronize(gv_w[:20])
    xt = om_c.synchronize(gv_w[:20])
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-6)
    xj2, sj = om_j.step(xj, gv_w[20])
    xt2, st = om_c.step(xt, to_cpu(gv_w[20]))
    np.testing.assert_allclose(xt2.numpy(), np.asarray(xj2), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5)
    assert st.shape == (om_c.ol.R, om_c.ol.n_out)
    xj3, oj = om_j.open_loop(gv_w[:6])
    xt3, ot = om_c.open_loop(gv_w[:6])
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5)
    np.testing.assert_allclose(xt3.numpy(), np.asarray(xj3), rtol=1e-5,
                               atol=1e-6)
    # open_loop is step() with the truth fed every week
    x = om_c.zero_state()
    for t in range(6):
        x, o = om_c.step(x, gv_w[t])
    np.testing.assert_allclose(ot[5].numpy(), o.numpy(), rtol=1e-6)


@pytest.mark.parametrize("with_train_std", [False, True])
def test_calibrate_gate(trained, with_train_std):
    """The gate grid is a float64 std of residuals between float32 values
    near 290 K, whose ulp is 3e-5 K: the two packages' predictions differ by
    an ulp here and there, so the stds agree to 1e-5 K, whatever their own
    size (1e-3 K on this wave)."""
    L, rcfg, gv, om_j, om_c = trained
    om_j = dataclasses.replace(om_j)
    om_c = dataclasses.replace(om_c)
    rng = np.random.default_rng(4)
    ts = np.abs(rng.normal(size=(L.il, L.ix))) if with_train_std else None
    gj, olj, pj = om_j.calibrate_gate(gv, L, train_anom_std=ts)
    gt, olt, pt = om_c.calibrate_gate(to_cpu(gv), convert.region_layout(L),
                                      train_anom_std=ts)
    assert gt.shape == (L.il, L.ix) and gt.dtype == np.float64
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-5)
    np.testing.assert_allclose([olt, pt], [olj, pj], rtol=0, atol=1e-5)
    assert om_c.anom_std is gt
    assert 0.0 < olt < 2.0          # skill on the synthetic wave
    if with_train_std:
        assert np.all(gt >= ts)


def test_compose_sst(trained):
    """Host float64 in both packages: exact. With and without the gate
    scale, on a climatology whose first rows are ice-blended (237 K, far
    below the open-water freezing point) and must stay so."""
    L, rcfg, gv, om_j, om_c = trained
    rng = np.random.default_rng(7)
    clim = np.full((L.il, L.ix), 290.0)
    clim[:2] = 237.0
    pred = clim.reshape(-1)[om_j.ol.target_index - L.gv_sizes["sst"][0]] \
        + rng.normal(0.0, 4.0, (om_j.ol.R, om_j.ol.n_out))
    Lt = convert.region_layout(L)
    for anom_std in (None, np.abs(rng.normal(0.0, 0.5, (L.il, L.ix)))):
        oj = dataclasses.replace(om_j, anom_std=anom_std)
        ot = dataclasses.replace(om_c, anom_std=anom_std)
        want = oj.compose_sst(pred, clim, L)
        np.testing.assert_array_equal(ot.compose_sst(pred, clim, Lt), want)
        np.testing.assert_array_equal(
            ot.compose_sst(to_cpu(pred), to_cpu(clim), Lt), want)
        assert want.min() < 271.0
        assert np.abs(want - clim).max() <= rcfg.slab_anom_clip + 1e-9
    assert om_j.active.any() and not np.array_equal(want, clim)
    off = dataclasses.replace(om_c, rcfg=dataclasses.replace(
        om_c.rcfg, slab_anom_clip=0.0))
    ungated = off.compose_sst(pred, clim, Lt)
    assert np.abs(ungated - clim).max() > rcfg.slab_anom_clip


def test_training_anomaly_std(tmp_path):
    bindir = write_synthetic_boundary(str(tmp_path / "bc"), seed=3)
    tb = build_tables()
    cj = jclim.build_climatology(bindir, tb.gcos, tb.radang)
    ct = tclim.build_climatology(bindir, tb.gcos, tb.radang)
    rng = np.random.default_rng(5)
    hours = 8760 + 6 * np.arange(40)
    sst = 285.0 + rng.normal(0.0, 1.0, (40, 48, 96))
    want = jslab.training_anomaly_std(cj, hours, sst)
    np.testing.assert_array_equal(
        tslab.training_anomaly_std(ct, hours, sst), want)
    np.testing.assert_array_equal(
        tslab.training_anomaly_std(ct, hours, to_cpu(sst)), want)
    assert want.shape == (48, 96) and (want == 0.0).any() and want.max() > 0


def _one_week_prediction(om, gv_w):
    x = om.synchronize(gv_w[:-2])
    return np.asarray(om.step(x, gv_w[-2])[1])


def test_train_ocean(trained, tmp_path):
    L, rcfg, gv, om_j, _ = trained
    Lt, rt = convert.region_layout(L), convert.reservoir_config(rcfg)
    om_t = tslab.train_ocean(Lt, rt, to_cpu(gv), seed=5)
    assert om_t.device == torch.device(CPU)
    np.testing.assert_array_equal(om_t.active, om_j.active)
    assert om_t.active.any() and om_t.anom_std is None
    for f in om_j.stz._fields:
        np.testing.assert_allclose(getattr(om_t.stz, f).numpy(),
                                   np.asarray(getattr(om_j.stz, f)),
                                   rtol=1e-6)
    np.testing.assert_array_equal(om_t.params.a_idx.numpy(),
                                  np.asarray(om_j.params.a_idx))
    np.testing.assert_allclose(om_t.params.a_val.numpy(),
                               np.asarray(om_j.params.a_val), rtol=1e-6)
    assert om_t.params.a_shift == tuple(
        int(s) for s in np.asarray(om_j.params.a_shift))
    assert om_t.params.wout.shape == om_j.params.wout.shape
    assert bool(torch.isfinite(om_t.params.wout).all())
    gv_w = jslab.weekly_ocean_inputs(gv, 4, L)
    pj = _one_week_prediction(om_j, gv_w)
    pt = _one_week_prediction(om_t, gv_w)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=5e-3 * np.ptp(pj))
    # a numpy series goes to the named device
    om_n = tslab.train_ocean(Lt, rt, gv, seed=5, device=CPU)
    assert torch.equal(om_n.params.wout, om_t.params.wout)

    # in blocks, with per-block checkpoints: a run that finds the first
    # blocks finished gives the uninterrupted run's model bitwise
    ckdir = str(tmp_path / "ck")
    whole = tslab.train_ocean(Lt, rt, to_cpu(gv), seed=5, region_block=7,
                              checkpoint_dir=ckdir)
    names = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert names == [f"ocean_block_{i:04d}.npz" for i in range(3)]
    (tmp_path / "ck" / names[-1]).unlink()
    stamp = (tmp_path / "ck" / names[0]).stat().st_mtime_ns
    again = tslab.train_ocean(Lt, rt, to_cpu(gv), seed=5, region_block=7,
                              checkpoint_dir=ckdir)
    assert (tmp_path / "ck" / names[0]).stat().st_mtime_ns == stamp
    for f in ("a_idx", "a_val", "win", "wout", "node_map"):
        assert torch.equal(getattr(again.params, f), getattr(whole.params, f))
    assert again.params.a_shift == whole.params.a_shift
    assert whole.params.wout.shape == om_t.params.wout.shape

    with pytest.raises(ValueError):
        tslab.train_ocean(Lt, rt, to_cpu(gv[:16]), seed=5)


def test_ocean_with_ohtc():
    """tests/test_slab.py test_ocean_with_ohtc against the JAX package: the
    OHTC channel packed bitwise as the JAX transform_and_pack packs it (a
    layout section without its array raises), and the ocean trained on it
    held to the JAX one as test_train_ocean holds it."""
    L = jax_build_layout(ix=12, il=6, kx=2, nvars=4, resx=2, resy=2,
                         overlap=1, use_ohtc=True)
    Lt = convert.region_layout(L)
    rcfg = _ocean_rcfg()
    T = 600
    atmo, logp, precip, sst, tisr = _synthetic_truth(L, T, seed=41)
    ohtc = 1.5e9 + 1e8 * np.sin(
        np.linspace(0, 20, T)[:, None, None]
        + np.linspace(0, 3, L.il)[None, :, None])
    ohtc = np.broadcast_to(ohtc, (T, L.il, L.ix))
    eps = rcfg.precip_epsilon
    gv = transform_and_pack(L, atmo, logp, precip, sst, tisr, eps, ohtc=ohtc)
    fields = [to_cpu(a) for a in (atmo, logp, precip, sst, tisr)]
    gvt = texp.transform_and_pack(Lt, *fields, eps, ohtc=to_cpu(ohtc))
    assert gvt.dtype == torch.float32
    np.testing.assert_array_equal(gvt.numpy(), gv)
    with pytest.raises(ValueError, match="ohtc"):
        texp.transform_and_pack(Lt, *fields, eps)

    rt = convert.reservoir_config(rcfg)
    om_j = jslab.train_ocean(L, rcfg, gv, seed=8)
    om_t = tslab.train_ocean(Lt, rt, gvt, seed=8)
    ncore = L.resy * L.resx
    assert om_t.ol.n_out == om_j.ol.n_out == 2 * ncore
    assert om_t.ol.sections == om_j.ol.sections
    np.testing.assert_array_equal(om_t.active, om_j.active)
    gv_w = jslab.weekly_ocean_inputs(gv, om_j.steps_per_week, L)
    pj = _one_week_prediction(om_j, gv_w)
    pt = _one_week_prediction(om_t, gv_w)
    assert np.isfinite(pt).all()
    # ohtc predictions come back in physical units (~1.5e9)
    assert 1e9 < np.abs(pt[:, ncore:]).mean() < 2e9
    for sl in (slice(0, ncore), slice(ncore, None)):
        np.testing.assert_allclose(pt[:, sl], pj[:, sl], rtol=0,
                                   atol=5e-3 * np.ptp(pj[:, sl]))
