"""speedyml_torch.hybrid.ensemble (EnsembleHybrid) against speedyml's and
against the port's own single-member step, at the full T30L8 grid (1152
regions) with a narrow reservoir (m_target = n_in), on seeded stand-in
boundary files, with the window in float64.

Tolerances:
  * dry window, E = 2, against the JAX EnsembleHybrid: rtol 3e-4 on the
    fields, the bounds of tests/test_composed.py:117-150 (float32 packing
    and readout rounding carried through the standardized readout: atmo
    atol 3e-4, logp and precip atol 1e-5, x atol 1e-4);
  * full physics, E = 2, against two single-member port steps (the
    HybridRunner's pack, forecast_gv and HybridModel.step): the window is
    the same float64 arithmetic, vmapped or not (1e-13 relative); the
    readout sums the same float32 products as one (R, n_out, na) x
    (R, na, E) product instead of E matrix-vector products, so fields agree
    to float32 rounding of the readout: atol 1e-6 of each field's largest
    value, the safety flags and x to atol 1e-6;
  * the batched readout against E single readouts: atol 1e-6 of the
    readout's scale in f32 and in bf16 wout (both sum in f32), the advance
    bitwise (the same elementwise ops, broadcast).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.core.config import ModelConfig as JaxConfig
from speedyml.core.config import ReservoirConfig as JaxReservoirConfig
from speedyml.domain import decomposition as jdec
from speedyml.domain import standardize as jstd
from speedyml.dynamics.core import Forcing as JaxForcing
from speedyml.hybrid.ensemble import EnsembleHybrid as JaxEnsemble
from speedyml.hybrid.experiment import HybridModel as JaxHybridModel
from speedyml.hybrid.forecast import SpeedyForecaster as JaxForecaster
from speedyml.model import Speedy as JaxSpeedy
from speedyml.reservoir import esn as jesn
from speedyml_torch import ModelConfig, ModelDate, convert
from speedyml_torch.coupler.daily import init_coupler_state
from speedyml_torch.hybrid.ensemble import EnsembleHybrid
from speedyml_torch.hybrid.experiment import HybridModel, HybridRunner
from speedyml_torch.hybrid.forecast import SpeedyForecaster
from speedyml_torch.hybrid.state_io import extract
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.model import Speedy
from speedyml_torch.physics.radiation import diurnal_tisr
from speedyml_torch.reservoir import esn as tesn
from speedyml_torch.reservoir.generate import generate_esn

torch.set_num_threads(1)

CPU = "cpu"
QMIN = 1e-6
WHEN = (1982, 1, 2, 0)
E = 2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The port's model spun up a day, a small random readout around
    physical means (as tests/test_torch_fastloop_window.py builds it) in
    both packages, and two members: the spun-up state and a perturbed
    copy, with two reservoir states."""
    bindir = write_synthetic_boundary(
        str(tmp_path_factory.mktemp("bc")), seed=7)
    tm = Speedy(ModelConfig(dtype="float64"), bindir, device=CPU)
    tm.initialize(1982, 1)
    tm.run_days(1)
    L = jdec.build_layout(radang_deg=np.degrees(np.asarray(
        tm.dy.tables.radang)))
    rng = np.random.default_rng(0)
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
    gs = extract(tm.dy, tm.state)
    atmo = torch.stack([gs.t, gs.u, gs.v, torch.clamp(gs.q, min=QMIN)]) \
        .to(torch.float32).numpy()
    logp = gs.logp.to(torch.float32).numpy()
    date = ModelDate(*WHEN)
    sst = np.asarray(init_coupler_state(tm.clim, date).sst_am)
    tisr = diurnal_tisr(date.tyear, date.ihour, tm.dy.tables.gsin,
                        tm.dy.tables.gcos, tm.config.ix)
    f32 = jnp.float32
    gv0 = np.asarray(jdec.pack_global(
        L, jnp.asarray(atmo), jnp.asarray(logp),
        jnp.zeros_like(jnp.asarray(logp)),
        jnp.maximum(jnp.asarray(sst, f32), 272.0), jnp.asarray(tisr, f32)))
    stz = jstd.Standardizer(
        in_mean=jnp.asarray(gv0[L.input_index]),
        in_std=jnp.asarray(np.full((L.R, L.n_in), 5.0, np.float32)),
        out_mean=jnp.asarray(gv0[L.target_index]),
        out_std=jnp.asarray(np.ones((L.R, L.n_out), np.float32)))
    hj = JaxHybridModel(layout=L, params=params, stz=stz,
                        rcfg=JaxReservoirConfig(), ml_only=False)
    ht = HybridModel(layout=convert.region_layout(L),
                     params=convert.esn_params(params, CPU),
                     stz=convert.standardizer(stz, CPU),
                     rcfg=convert.reservoir_config(JaxReservoirConfig()))
    atmo_e = np.stack([atmo, atmo + 0.1 * rng.standard_normal(
        atmo.shape).astype(np.float32)])
    logp_e = np.stack([logp, logp])
    pr_e = np.zeros_like(logp_e)
    x0 = (0.1 * rng.standard_normal((L.R, tp.n))).astype(np.float32)
    x_e = np.stack([x0, 0.5 * x0])
    return dict(bindir=bindir, tm=tm, hj=hj, ht=ht, date=date, sst=sst,
                tisr=tisr, members=(x_e, atmo_e, logp_e, pr_e))


def _tensors(members):
    return [convert.tensor(a, CPU) for a in members]


def test_dry_step_against_jax(setup):
    s = setup
    tm, date = s["tm"], s["date"]
    surf, forcing = SpeedyForecaster(tm)._surf_forcing(date, s["sst"])
    got = EnsembleHybrid(s["ht"], SpeedyForecaster(tm, physics=False)).step(
        *_tensors(s["members"]), s["sst"], s["tisr"], surf, forcing)

    jm = JaxSpeedy(JaxConfig(dtype="float64"), bindir=s["bindir"])
    jf = JaxForcing(tcorh=forcing.tcorh.numpy(), qcorh=forcing.qcorh.numpy())
    want = JaxEnsemble(s["hj"], JaxForecaster(jm, physics=False)).step(
        jnp.asarray(s["members"][0]), *s["members"][1:], s["sst"],
        s["tisr"], None, jf)
    xe, ae, le, pe, safe = got
    assert safe.shape == (E,) and bool(safe.all())
    np.testing.assert_array_equal(safe.numpy(), np.asarray(want[4]))
    assert ae.shape == (E, 4, 8, 48, 96) and ae.dtype == torch.float32
    np.testing.assert_allclose(ae.numpy(), np.asarray(want[1]), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(le.numpy(), np.asarray(want[2]), rtol=3e-4,
                               atol=1e-5)
    np.testing.assert_allclose(pe.numpy(), np.asarray(want[3]), rtol=3e-4,
                               atol=1e-5)
    np.testing.assert_allclose(xe.numpy(), np.asarray(want[0]), rtol=3e-4,
                               atol=1e-4)
    # the members differ, and the step moved them
    assert float((ae[1] - ae[0]).abs().max()) > 1e-2
    assert float((ae[0] - torch.as_tensor(s["members"][1][0])).abs()
                 .max()) > 1e-2


def test_full_physics_step_against_single_steps(setup):
    s = setup
    tm, ht, date = s["tm"], s["ht"], s["date"]
    fc = SpeedyForecaster(tm)
    surf, forcing = fc._surf_forcing(date, s["sst"])
    xe, ae, le, pe, safe = EnsembleHybrid(ht, fc).step(
        *_tensors(s["members"]), s["sst"], s["tisr"], surf, forcing)
    runner = HybridRunner(ht, fc)
    for m, (x, atmo, logp, pr) in enumerate(zip(*_tensors(s["members"]))):
        gv = runner.pack(atmo, logp, pr, s["sst"], s["tisr"])
        model_gv, ok = runner.forecast_gv(atmo, logp, s["sst"], s["tisr"],
                                          date)
        assert bool(ok) == bool(safe[m])
        x1, a1, l1, p1 = ht.step(x, gv, model_gv)
        for got, want in ((xe[m], x1), (ae[m], a1), (le[m], l1),
                          (pe[m], p1)):
            assert got.shape == want.shape
            scale = float(want.abs().max())
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-6 * max(scale, 1.0))
    assert bool(safe.all()) and bool(torch.isfinite(ae).all())


def test_run_collects_and_aborts_on_an_unsafe_member(setup):
    s = setup
    tm, ht = s["tm"], s["ht"]
    eh = EnsembleHybrid(ht, SpeedyForecaster(tm, physics=False))
    x_e, atmo_e, logp_e, pr_e = _tensors(s["members"])
    out = eh.run(x_e, atmo_e, logp_e, pr_e, s["date"], 2)
    assert not out["aborted"]
    assert out["atmo"].shape == (2, E, 4, 8, 48, 96)
    assert out["logp"].shape == out["precip_t"].shape == (2, E, 48, 96)
    d = out["date"]
    assert (d.iyear, d.imonth, d.iday, d.ihour) == (1982, 1, 2, 12)
    np.testing.assert_array_equal(out["atmo"][-1], out["final"][0].numpy())
    assert out["x"].shape == x_e.shape
    # one member far outside the safety gate: the run stops after the
    # first step, collects nothing and returns the date it reached
    hot = atmo_e.clone()
    hot[1, 0] += 200.0
    out = eh.run(x_e, hot, logp_e, pr_e, s["date"], 3)
    assert out["aborted"] and out["atmo"] is None
    d = out["date"]
    assert (d.iyear, d.imonth, d.iday, d.ihour) == (1982, 1, 2, 6)
    with pytest.raises(ValueError, match="ML-only"):
        EnsembleHybrid(HybridModel(layout=ht.layout, params=ht.params,
                                   stz=ht.stz, rcfg=ht.rcfg, ml_only=True),
                       None)


@pytest.mark.parametrize("wout_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [True, False])
def test_readout_of_members_against_single_readouts(wout_dtype, shifted):
    """advance and readout on (E, R, ...) against each member alone."""
    p = generate_esn(3, 5, 6, 4, 4, m_target=48, deg=3, device=CPU,
                     topology="ring" if shifted else "er")
    g = torch.Generator().manual_seed(1)
    p = tesn.cast_wout(
        tesn.EsnParams(**{**p.__dict__, "wout": 0.1 * torch.randn(
            p.wout.shape, generator=g)}), wout_dtype)
    x = torch.randn(3, 5, p.n, generator=g)
    u = torch.randn(3, 5, 6, generator=g)
    mv = torch.randn(3, 5, 4, generator=g)
    xb, yb = tesn.predict_step(p, x, u, mv)
    assert xb.shape == x.shape and yb.shape == (3, 5, 4)
    assert yb.dtype == torch.float32
    for e in range(3):
        xs, ys = tesn.predict_step(p, x[e], u[e], mv[e])
        assert torch.equal(xb[e], xs)
        np.testing.assert_allclose(yb[e].numpy(), ys.numpy(), rtol=0,
                                   atol=1e-6 * float(ys.abs().max()))
