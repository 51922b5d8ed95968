"""The full-physics model of speedyml_torch against speedyml's: one
physics-coupled dycore step, one 6-h window, and the truth runner across a
day boundary, all in float64 from the same spun-up state on the same
stand-in boundary files; then what a float32 window returns.

Tolerances. One step: 1e-10 of each field's scale (the transforms sum in
another order; everything else is the same float64 arithmetic). One window
is 25 such steps and two windows 50; float64 rounding stays near 1e-13
relative over them, as it does over the dry window, unless a difference of
1e-16 flips a discrete trigger of the moist schemes (a convection top, the
6 K SST gate), which no column of this state does: 1e-9 of each field's
scale. In float32 such flips do happen, so the float32 window is held to
its dtype, the safety bounds and the float64 window within a loose bound
only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.core.calendar import ModelDate as JaxDate
from speedyml.core.config import ModelConfig as JaxConfig
from speedyml.dynamics.core import Forcing as JaxForcing
from speedyml.dynamics.state import SpectralState as JaxState
from speedyml.hybrid.forecast import SpeedyForecaster as JaxForecaster
from speedyml.hybrid.forecast import TrajectoryRunner as JaxTrajectory
from speedyml.hybrid.state_io import GridState as JaxGridState
from speedyml.model import Speedy as JaxSpeedy
from speedyml.physics import driver as jdrv
from speedyml_torch import ModelConfig, ModelDate, convert
from speedyml_torch.hybrid.forecast import (SpeedyForecaster,
                                            TrajectoryRunner)
from speedyml_torch.hybrid.state_io import SAFE_BOUNDS, extract
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.model import DailyFluxes, Speedy

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

CPU = "cpu"
STEP_TOL = 1e-10
WINDOW_TOL = 1e-9


def close(got, want, tol, name=""):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300),
                               err_msg=name)


def jax_state(state):
    return JaxState(*(jnp.asarray(getattr(state, n).numpy())
                      for n in JaxState._fields))


def jax_grid(gs):
    return JaxGridState(*(np.asarray(v.numpy()) for v in gs))


@pytest.fixture(scope="module")
def bindir(tmp_path_factory):
    return write_synthetic_boundary(str(tmp_path_factory.mktemp("bc")),
                                    seed=5)


@pytest.fixture(scope="module")
def models(bindir):
    """Both packages' float64 model on the same files. The port's runs one
    day from rest (its own day loop, flux means and coupler update); both
    then hold that state."""
    jm = JaxSpeedy(JaxConfig(dtype="float64"), bindir=bindir)
    tm = Speedy(ModelConfig(dtype="float64"), bindir, device=CPU)
    tm.initialize(1982, 1)
    acc = tm.run_days(1)
    assert isinstance(acc, DailyFluxes)
    assert (tm.date.iyear, tm.date.imonth, tm.date.iday) == (1982, 1, 2)
    assert all(bool(torch.isfinite(f).all()) for f in acc)
    assert float(acc.precip.min()) >= 0.0 < float(acc.precip.max())
    return jm, tm


def test_grid_view(models):
    _, tm = models
    view = tm.grid_view()
    assert sorted(view) == ["ps", "q", "t", "u", "v"]
    gs = extract(tm.dy, tm.state)
    np.testing.assert_array_equal(view["t"], gs.t.numpy())
    np.testing.assert_array_equal(view["u"], gs.u.numpy())
    assert 900.0 < view["ps"].mean() < 1030.0 and view["ps"].min() > 500.0


@pytest.mark.parametrize("lradsw", [True, False])
def test_dycore_step_with_physics(models, lradsw):
    """Dycore.step through the grtend physics hook: the new state and the
    extras (radiation carry, fluxes) it hands back."""
    jm, tm = models
    surf, forcing = tm.surf_forcing(tm.date)
    jsurf = jdrv.SurfaceDailyState(*(np.asarray(v.numpy()) for v in surf))
    jforc = JaxForcing(*(np.asarray(v.numpy()) for v in forcing))
    jrad = jdrv.RadCarry(*(jnp.asarray(v.numpy()) for v in tm.rad))

    def jstep(state, surf, rad, forcing):
        return jm.dy.step(state, forcing, 1, 1, "delt2",
                          jm._phys_fn(surf, rad, jnp.asarray(lradsw)))

    want, (want_rad, want_fx) = jax.jit(jstep)(jax_state(tm.state), jsurf,
                                               jrad, jforc)
    got, (got_rad, got_fx) = tm.dy.step(
        tm.state, forcing, 1, 1, "delt2",
        tm._phys_fn(surf, tm.rad, lradsw))
    for n in want._fields:
        close(getattr(got, n), getattr(want, n), STEP_TOL, n)
    for n in want_rad._fields:
        close(getattr(got_rad, n), getattr(want_rad, n), STEP_TOL, n)
    for n in want_fx._fields:
        close(getattr(got_fx, n), getattr(want_fx, n), STEP_TOL, n)
    # physics moved the step: it differs from the dry step of the same state
    dry = tm.dy.step(tm.state, forcing, 1, 1, "delt2")
    assert float((dry.t - got.t).abs().max()) > 1e-4


@pytest.fixture(scope="module")
def forecasters(models):
    jm, tm = models
    return JaxForecaster(jm), SpeedyForecaster(tm)


def test_full_physics_window(models, forecasters):
    """One 6-h window from the same grid state, date and hybrid SST:
    forecast state, precipitation, the coupler's flux sums, the gate."""
    jm, tm = models
    jfc, tfc = forecasters
    gs = extract(tm.dy, tm.state)
    when = (1982, 1, 2, 0)
    rng = np.random.default_rng(0)
    clim_sst = tfc._surf_forcing(ModelDate(*when))[0].sst_am.numpy()
    # a hybrid SST inside the 6 K gate in most cells, outside it in others
    sst = clim_sst + rng.normal(0.0, 3.0, clim_sst.shape)
    assert 0.01 < (np.abs(clim_sst - sst) >= 6.0).mean() < 0.2

    want = jfc.forecast(jax_grid(gs), JaxDate(*when), sst_hybrid=sst)
    got = tfc.forecast(gs, ModelDate(*when), sst_hybrid=sst)
    assert tfc.nsteps_window == jfc.nsteps_window == 24
    assert bool(want.safe) and bool(got.safe)
    for n in want.gs._fields:
        close(getattr(got.gs, n), getattr(want.gs, n), WINDOW_TOL, n)
    close(got.precip_mm, want.precip_mm, WINDOW_TOL, "precip_mm")
    for i, name in enumerate(("hflux_l", "hflux_s", "hflux_i")):
        close(got.flux_sums[i], want.flux_sums[i], WINDOW_TOL, name)
    pr = got.precip_mm.numpy()
    assert pr.min() >= 0.0 and 0.02 < (pr > 0.0).mean() < 1.0
    # the hybrid SST reached the window: the same call without it differs
    plain = tfc.forecast(gs, ModelDate(*when))
    assert float((plain.gs.t - got.gs.t).abs().max()) > 1e-3
    # a tensor SST is taken as well as a numpy one
    again = tfc.forecast(gs, ModelDate(*when),
                         sst_hybrid=torch.as_tensor(sst))
    assert torch.equal(again.gs.t, got.gs.t)
    with pytest.raises(ValueError):
        tfc.forecast(gs)                      # full physics needs its date


def test_trajectory_runner_across_a_day(models, forecasters):
    """Two consecutive truth windows, 18 h -> 24 h -> 30 h: the first ends a
    day, so the slab models take their daily step between the two and the
    second window runs on the updated coupler state."""
    jm, tm = models
    jfc, _ = forecasters
    gs0 = extract(tm.dy, tm.state)
    tm.coupler = convert.coupler_state(tm.coupler)      # a private copy
    jr, tr = JaxTrajectory(jm), TrajectoryRunner(tm)
    jr.fc = jfc                                   # share the compiled window
    jr.date, tr.date = JaxDate(1982, 1, 2, 18), ModelDate(1982, 1, 2, 18)
    jr.cs = convert.coupler_state(tm.coupler)     # same fields, own arrays
    tr.cs = tm.coupler
    jr.gs, tr.gs = jax_grid(gs0), gs0
    jr._hour = tr._hour = 18
    stl_before = tr.cs.stl_am.copy()

    first = tr.current_sample()
    assert float(first.precip_mm.abs().max()) == 0.0
    for k in range(2):
        want, got = jr.advance(), tr.advance()
        for n in want.gs._fields:
            close(getattr(got.gs, n), getattr(want.gs, n), WINDOW_TOL,
                  f"window {k} {n}")
        close(got.precip_mm, want.precip_mm, WINDOW_TOL, f"precip {k}")
        np.testing.assert_array_equal(got.tisr, want.tisr)
        close(got.sst, want.sst, 1e-12, f"sst {k}")
        assert (tr.date.iday, tr.date.ihour) == (jr.date.iday, jr.date.ihour)
    assert (tr.date.iday, tr.date.ihour) == (3, 6) and tr._hour == 6
    # the land slab moved at the day boundary, and alike in both
    assert np.abs(tr.cs.stl_am - stl_before).max() > 1e-3
    for n in ("stl_am", "sst_am", "tice_am", "sst_om"):
        close(getattr(tr.cs, n), getattr(jr.cs, n), WINDOW_TOL, n)


def test_trajectory_runner_sst_anomaly(models, forecasters):
    """TrajectoryRunner(sst_anom_fn=...): the seeded ENSO anomaly is imposed
    on the coupler's SST after the daily update, alike in both packages,
    and the truth's SST sample then leaves the climatology."""
    from speedyml.coupler.anomaly import SyntheticEnso as JaxEnso
    from speedyml_torch.coupler.anomaly import SyntheticEnso
    jm, tm = models
    jfc, _ = forecasters
    gs0 = extract(tm.dy, tm.state)
    args = (np.degrees(tm.dy.tables.radang),
            np.arange(96) * 360.0 / 96, tm.clim.fmask_s)
    kw = dict(seed=3, t0=(1982, 1, 1), ramp_days=1.0, period_days=8.0)
    jr = JaxTrajectory(jm, sst_anom_fn=JaxEnso(*args, **kw).sst_anom_fn)
    tr = TrajectoryRunner(tm, sst_anom_fn=SyntheticEnso(*args, **kw)
                          .sst_anom_fn)
    jr.fc = jfc                                   # share the compiled window
    jr.date, tr.date = JaxDate(1982, 1, 2, 18), ModelDate(1982, 1, 2, 18)
    jr.cs = convert.coupler_state(tm.coupler)
    tr.cs = convert.coupler_state(tm.coupler)
    jr.gs, tr.gs = jax_grid(gs0), gs0
    jr._hour = tr._hour = 18
    want, got = jr.advance(), tr.advance()
    close(got.sst, want.sst, 1e-12, "sst")
    close(got.gs.t, want.gs.t, WINDOW_TOL, "t")
    plain = TrajectoryRunner(tm)
    plain.date, plain.cs = ModelDate(1982, 1, 2, 18), \
        convert.coupler_state(tm.coupler)
    plain.gs, plain._hour = gs0, 18
    assert np.abs(plain.advance().sst - got.sst).max() > 0.3


def test_float32_window(bindir, models):
    """A float32 model hands only float32 out of a window (the float64
    coupler fields are pinned once, where they are uploaded), stays inside
    the safety bounds, and tracks the float64 window."""
    _, tm = models
    m32 = Speedy(ModelConfig(), bindir, device=CPU)
    fc = SpeedyForecaster(m32)
    gs = extract(tm.dy, tm.state)
    when = ModelDate(1982, 1, 2, 0)
    sst = np.asarray(tm.coupler.sst_am, np.float64)
    surf, forcing = fc._surf_forcing(when, sst)
    assert all(v.dtype == torch.float32 for v in (*surf, *forcing))
    res = fc.forecast(gs, when, sst_hybrid=sst)
    for v in (*res.gs, res.precip_mm, *res.flux_sums):
        assert v.dtype == torch.float32
        assert bool(torch.isfinite(v).all())
    assert bool(res.safe)
    for name, (lo, hi) in SAFE_BOUNDS.items():
        f = getattr(res.gs, name)
        assert lo <= float(f.min()) and float(f.max()) <= hi, name
    ref = SpeedyForecaster(tm).forecast(gs, when, sst_hybrid=sst)
    assert float((res.gs.t.double() - ref.gs.t).abs().max()) < 1.0
    assert float((res.gs.u.double() - ref.gs.u).abs().max()) < 1.0


def test_dry_forecaster_from_a_speedy_or_a_dycore(models):
    _, tm = models
    gs = extract(tm.dy, tm.state)
    a = SpeedyForecaster(tm, physics=False).forecast(gs)
    b = SpeedyForecaster.dry(tm.dy).forecast(gs)
    assert torch.equal(a.gs.t, b.gs.t) and torch.equal(a.gs.q, b.gs.q)
    assert float(a.precip_mm.abs().max()) == 0.0
    assert SpeedyForecaster.dry(tm.dy, hours=5).nsteps_window == 20


@pytest.mark.parametrize("option", ["rdf_on", "sppt_on", "time_means_on"])
def test_unported_options_raise(bindir, option):
    with pytest.raises(NotImplementedError):
        Speedy(ModelConfig(**{option: True}), bindir, device=CPU)


def test_bf16_grid_compute_raises(bindir):
    """bf16 grid compute is ported (tests/test_torch_bf16.py holds it to
    the JAX package): a Speedy builds with it; a grid dtype that neither
    package has raises."""
    sp = Speedy(ModelConfig(grid_compute="bfloat16"), bindir, device=CPU)
    assert sp.dy.grid_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="grid_compute"):
        Speedy(ModelConfig(grid_compute="float16"), bindir, device=CPU)


def test_run_day_needs_initialize(bindir):
    with pytest.raises(RuntimeError):
        Speedy(ModelConfig(), bindir, device=CPU).run_day()
