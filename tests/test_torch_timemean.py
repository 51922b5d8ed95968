"""Time means with GrADS output, and a model day with the options on, of
speedyml_torch against speedyml, in float64 on the same stand-in boundary
files.

Tolerances:
  * tm_update, tm_update_fluxes and finalize on the same state and fluxes:
    1e-12 of each field's scale (the fields come through each package's
    transforms); a central moment E[x^2] - E[x]^2 of finalize to 1e-12 of
    the E[x^2] it cancels against;
  * the accumulator algebra of tests/test_timemean.py on the port alone:
    constant samples give zero central moments (1e-9 of the squared mean),
    the counters count samples and steps;
  * GrADS files that both packages write from the same accumulators: byte
    for byte;
  * one full-physics day with random diabatic forcing and time means, from
    the port's bootstrapped state in both packages: 1e-12 of each field's
    scale, state, daily fluxes and accumulators (float64 rounding stays near
    1e-13 relative over the day's 96 steps, as over the windows of
    tests/test_torch_fullwindow.py, unless a difference flips a discrete
    trigger of the moist schemes, which no column of this day does); the
    time means the day wrote, read back
    from both packages' GrADS files: the same to float32 rounding (two
    ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.core.calendar import ModelDate as JaxDate
from speedyml.core.config import ModelConfig as JaxConfig
from speedyml.coupler.daily import init_coupler_state as jinit_coupler
from speedyml.dynamics.state import PrognosticFields as JaxFields
from speedyml.dynamics.state import SpectralState as JaxState
from speedyml.io.grads import read_grads as jread_grads
from speedyml.model import Speedy as JaxSpeedy
from speedyml.physics import driver as jdrv
from speedyml.utils import timemean as jtm
from speedyml_torch import ModelConfig
from speedyml_torch.io.grads import read_grads
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.model import Speedy
from speedyml_torch.physics.driver import StepFluxes
from speedyml_torch.utils import timemean as ttm

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

CPU = "cpu"
TM_RTOL = 1e-12
DAY_TOL = 1e-12
N3D = len(ttm.MEAN3D_NAMES) + len(ttm.VAR3D_NAMES)
N2D = len(ttm.MEAN2D_NAMES) + len(ttm.FLUX2D_NAMES)


def close(got, want, tol, name="", rel_to_scale=True):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    atol = tol * max(np.abs(want).max(), 1e-300) if rel_to_scale else 0.0
    np.testing.assert_allclose(got, want, rtol=0 if rel_to_scale else tol,
                               atol=atol, err_msg=name)


def jax_tm(tm):
    return jtm.TimeMeanState(*(jnp.asarray(v.numpy()) for v in tm))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Both packages' float64 model with random diabatic forcing and time
    means on the same files; the port's is initialized (rest start and the
    stepone bootstrap, with the forcing)."""
    bindir = write_synthetic_boundary(str(tmp_path_factory.mktemp("bc")),
                                      seed=6)
    cfg = dict(dtype="float64", rdf_on=True, time_means_on=True)
    jm = JaxSpeedy(JaxConfig(**cfg), bindir=bindir)
    tm = Speedy(ModelConfig(**cfg), bindir, device=CPU)
    tm.initialize(1982, 1)
    return jm, tm


def _fluxes(seed):
    rng = np.random.default_rng(seed)
    return StepFluxes(*(torch.as_tensor(rng.standard_normal((48, 96)))
                        for _ in StepFluxes._fields))


def test_tm_update_parity(models):
    jm, tm = models
    t = ttm.init_timemean(8, 48, 96, torch.float64, CPU)
    j = jtm.init_timemean(8, 48, 96, jnp.float64)
    for level in (0, 1):
        f = tm.state.at_level(level)
        jf = JaxFields(*(jnp.asarray(v.numpy()) for v in f))
        t = ttm.tm_update(tm.dy, tm.st, f, t)
        j = jtm.tm_update(jm.dy, jm.st, jf, j)
    for seed in (0, 1, 2):
        fx = _fluxes(seed)
        t = ttm.tm_update_fluxes(fx, t)
        j = jtm.tm_update_fluxes(
            jdrv.StepFluxes(*(jnp.asarray(v.numpy()) for v in fx)), j)
    for name in j._fields:
        close(getattr(t, name), getattr(j, name), TM_RTOL, name)
    got, want = ttm.finalize(t), jtm.finalize(j)
    assert sorted(got) == sorted(want)
    assert len(got) == N3D + N2D
    second = dict(zip(ttm.VAR3D_NAMES, np.asarray(j.var3d) / 2.0))
    for name in want:
        if name in second:
            np.testing.assert_allclose(
                got[name], want[name], rtol=0, err_msg=name,
                atol=TM_RTOL * np.abs(second[name]).max())
        else:
            close(got[name], want[name], TM_RTOL, name)


def test_constant_samples_zero_variance(models):
    """N identical samples: mean == instantaneous, variance == 0."""
    _, tm = models
    t = ttm.init_timemean(8, 48, 96, tm.dy.dtype, CPU)
    f = tm.state.at_level(0)
    for _ in range(3):
        t = ttm.tm_update(tm.dy, tm.st, f, t)
    out = ttm.finalize(t)
    assert float(t.rnsave) == 3.0 and float(t.nstep) == 0.0
    for name in ttm.MEAN3D_NAMES + ttm.MEAN2D_NAMES:
        assert np.isfinite(out[name]).all(), name
    for name in ("u2", "v2", "t2", "q2"):
        scale = max(1.0, float(np.abs(out[name[0]]).max()) ** 2)
        assert np.abs(out[name]).max() / scale < 1e-9, name
    assert 150.0 < out["t"].min() and out["t"].max() < 350.0
    assert 0.5 < out["mslp"].mean() < 1.2   # p/p0 units


def test_flux_accumulation_counts(models):
    _, tm = models
    t = ttm.init_timemean(8, 48, 96, tm.dy.dtype, CPU)
    two = torch.full((48, 96), 2.0, dtype=tm.dy.dtype)
    fx = StepFluxes(*(two for _ in StepFluxes._fields))
    t = ttm.tm_update_fluxes(fx, ttm.tm_update_fluxes(fx, t))
    out = ttm.finalize(t)
    assert float(t.nstep) == 2.0 and sorted(out) == sorted(
        ttm.FLUX2D_NAMES)
    for n in ttm.FLUX2D_NAMES:
        np.testing.assert_array_equal(out[n], 2.0)


def test_write_grads_byte_identical(models, tmp_path):
    """The port's accumulators written by each package's write_grads."""
    jm, tm = models
    t = ttm.init_timemean(8, 48, 96, torch.float64, CPU)
    t = ttm.tm_update(tm.dy, tm.st, tm.state.at_level(0), t)
    t = ttm.tm_update_fluxes(_fluxes(4), t)
    lat = np.degrees(np.asarray(tm.dy.tables.radang))
    sig = np.asarray(tm.st.sig)
    for name, fn, acc in (("port", ttm.write_grads, t),
                          ("jax", jtm.write_grads, jax_tm(t))):
        (tmp_path / name).mkdir()
        fn(acc, str(tmp_path / name / "tm"), lat, sig, year=1983, month=4)
    for ext in (".grd", ".ctl"):
        assert (tmp_path / "port" / f"tm{ext}").read_bytes() == \
            (tmp_path / "jax" / f"tm{ext}").read_bytes(), ext


@pytest.fixture(scope="module")
def day(models, tmp_path_factory):
    """One day of each package from the port's bootstrapped state; both
    write their time means to GrADS files."""
    jm, tm = models
    jm.date = JaxDate(1982, 1, 1, 0)
    jm.coupler = jinit_coupler(jm.clim, jm.date)
    jm.state = JaxState(*(jnp.asarray(v.numpy()) for v in tm.state))
    jm.rad = jdrv.RadCarry(*(jnp.asarray(v.numpy()) for v in tm.rad))
    jm._bootstrapped = True
    jacc = jm.run_day()
    tacc = tm.run_day()
    d = tmp_path_factory.mktemp("tm")
    jtm_before = jm.time_means
    t_before = tm.time_means
    fields = {"jax": jm.write_time_means(str(d / "jax")),
              "port": tm.write_time_means(str(d / "port"))}
    return dict(jacc=jacc, tacc=tacc, fields=fields, dir=d,
                jtm=jtm_before, ttm=t_before)


def test_day_state(models, day):
    jm, tm = models
    for name in JaxState._fields:
        close(getattr(tm.state, name), getattr(jm.state, name), DAY_TOL,
              name)
    for name in day["jacc"]._fields:
        close(getattr(day["tacc"], name), getattr(day["jacc"], name),
              DAY_TOL, name)
    assert (tm.date.iyear, tm.date.imonth, tm.date.iday) == \
        (jm.date.iyear, jm.date.imonth, jm.date.iday) == (1982, 1, 2)


def test_day_time_means(models, day):
    """The day's accumulators, their counters, and the fields read back."""
    jm, tm = models
    t, j = day["ttm"], day["jtm"]
    assert float(t.nstep) == float(j.nstep) == tm.config.nsteps
    assert float(t.rnsave) == float(j.rnsave) == \
        tm.config.nsteps // tm.config.nstppr
    for name in ("mean3d", "var3d", "mean2d", "flux2d"):
        close(getattr(t, name), getattr(j, name), DAY_TOL, name)
    # write_time_means resets the accumulators
    assert float(tm.time_means.rnsave) == 0.0 == float(tm.time_means.nstep)
    got, want = day["fields"]["port"], day["fields"]["jax"]
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.isfinite(got[name]).all(), name
    g3, g2 = read_grads(str(day["dir"] / "port"), 8, 48, 96, N3D, N2D)
    w3, w2 = jread_grads(str(day["dir"] / "jax"), 8, 48, 96, N3D, N2D)
    assert g3.shape == (1, N3D, 8, 48, 96) and g2.shape == (1, N2D, 48, 96)
    eps = 2 * np.finfo(np.float32).eps
    for g, w in ((g3, w3), (g2, w2)):
        scale = np.abs(w).max(axis=(-2, -1), keepdims=True)
        assert np.all(np.abs(g - w) <= eps * np.maximum(np.abs(w), scale))
    ctl = (day["dir"] / "port.ctl").read_text()
    assert ctl == (day["dir"] / "jax.ctl").read_text().replace("^jax",
                                                               "^port")
    assert "mslp" in ctl and f"vars {N3D + N2D}" in ctl


def test_accumulators_default_to_the_card():
    """Without `device` the accumulators are built on the card; without one
    that fails with torch's own error rather than falling back to the
    CPU."""
    if torch.cuda.is_available():
        assert ttm.init_timemean(8, 4, 8).mean3d.is_cuda
        return
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        ttm.init_timemean(8, 4, 8)
