"""Random diabatic forcing and SPPT of speedyml_torch against speedyml, in
float64 on the same stand-in boundary files.

Tolerances:
  * make_randfh: rtol 1e-12 (the same numpy draws and bilinear map; the T18
    truncation goes through each package's own transforms, which sum in
    another order); xs_rdf and tt_rdf on the same inputs: rtol 1e-13;
  * one step_physics with the pattern: 1e-10 of each output's scale, as
    tests/test_torch_physics.py holds step_physics (its fields come through
    the spectral transforms);
  * SPPT, with the noise given to both (the port draws it from torch
    generators, the JAX package from jax.random): phi, sigma and mu to
    1e-15, the AR(1) state and pattern over three steps to 1e-12, the
    tendency scaling 1 + pattern * mu to 1e-13;
  * SPPT on the port's own generator, 400 steps from the stationary
    initial sample: the pattern within [-1, 1]; the lag-1 autocorrelation
    of the spectral state within 0.01 of phi (pooled over every mode, ~1e6
    products); the grid pattern's standard deviation before clipping within
    5% of the JAX package's over 400 steps of its own generator. Both are
    near STDDEV / sqrt(2), not STDDEV: sigma scales the real and the
    imaginary part of each mode alike, as the JAX package does;
  * a model day with SPPT (float32): finite, different from the day
    without it, and bitwise the same over two runs with the same seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.core.config import ModelConfig as JaxConfig
from speedyml.dynamics.state import SpectralState as JaxState
from speedyml.model import Speedy as JaxSpeedy
from speedyml.physics import driver as jdrv
from speedyml.physics import randfor as jrf
from speedyml.physics import sppt as jsppt
from speedyml_torch import ModelConfig
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.model import Speedy
from speedyml_torch.physics import randfor as trf
from speedyml_torch.physics.sppt import Sppt

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

CPU = "cpu"
RDF_INDEX = 7


def close(got, want, rtol, name=""):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300),
                               err_msg=name)


@pytest.fixture(scope="module")
def bindir(tmp_path_factory):
    return write_synthetic_boundary(str(tmp_path_factory.mktemp("bc")),
                                    seed=4)


@pytest.fixture(scope="module")
def models(bindir):
    """Both packages' float64 model with random diabatic forcing on; the
    port's is initialized (rest start and the stepone bootstrap)."""
    cfg = dict(dtype="float64", rdf_on=True, rdf_index=RDF_INDEX)
    jm = JaxSpeedy(JaxConfig(**cfg), bindir=bindir)
    tm = Speedy(ModelConfig(**cfg), bindir, device=CPU)
    tm.initialize(1982, 1)
    return jm, tm


# ----------------------------------------------------------------------
# random diabatic forcing
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [RDF_INDEX, -3])
def test_make_randfh(models, seed):
    jm, tm = models
    gsin = np.asarray(tm.dy.tables.gsin)
    got = trf.make_randfh(tm.dy.T, gsin, 96, seed=seed)
    close(got, np.asarray(jrf.make_randfh(jm.dy.T, gsin, 96, seed=seed)),
          1e-12, "randfh")
    assert got.shape == (2, 48, 96) and np.abs(got).max() > 0.01
    np.testing.assert_array_equal(got, trf.make_randfh(tm.dy.T, gsin, 96,
                                                       seed=seed))
    np.testing.assert_array_equal(
        -got, trf.make_randfh(tm.dy.T, gsin, 96, seed=-seed))
    # T18 truncation: no spectral power above total wavenumber 18
    spec = tm.dy.T.host_grid_to_spec(got[0])
    ll = np.add.outer(np.arange(spec.shape[0]), np.arange(spec.shape[2]))
    hi = np.abs(spec[:, 0][ll > 18]).max() + np.abs(spec[:, 1][ll > 18]).max()
    assert hi < 1e-10 * np.abs(spec[:, 0][ll <= 18]).max()


def test_model_pattern(models):
    jm, tm = models
    assert tm._randfh.dtype == torch.float64
    close(tm._randfh, np.asarray(jm._randfh), 1e-12, "model randfh")


@pytest.mark.parametrize("ivm", [1, 2])
def test_xs_rdf(models, ivm):
    _, tm = models
    rng = np.random.default_rng(ivm)
    a, b = (rng.standard_normal((8, 48, 96)) * 1e-5 for _ in range(2))
    sig = np.asarray(tm.st.sig)
    got = trf.xs_rdf(torch.as_tensor(a), torch.as_tensor(b),
                     torch.as_tensor(sig), ivm)
    close(got, np.asarray(jrf.xs_rdf(jnp.asarray(a), jnp.asarray(b), sig,
                                     ivm)), 1e-13, "xs_rdf")
    # a latitude-constant profile survives the smoothing exactly
    c = torch.full((8, 48, 96), 0.5, dtype=torch.float64)
    p = trf.xs_rdf(c, torch.zeros_like(c), sig, ivm)
    want = 0.5 * (np.sin(2.0 * np.pi * sig) if ivm == 2 else np.ones(8))
    np.testing.assert_allclose(p.numpy(), np.broadcast_to(
        want[:, None], (8, 48)), rtol=1e-12, atol=1e-15)


def test_tt_rdf(models):
    rng = np.random.default_rng(0)
    rh = rng.standard_normal((2, 48, 96))
    v1, v2 = rng.standard_normal((8, 48)), rng.standard_normal((8, 48))
    got = trf.tt_rdf(*(torch.as_tensor(x) for x in (rh, v1, v2)))
    close(got, np.asarray(jrf.tt_rdf(*(jnp.asarray(x) for x in (rh, v1,
                                                                 v2)))),
          1e-13, "tt_rdf")
    # bilinear: the first pattern alone against a unit second profile
    one = np.zeros((2, 48, 96))
    one[0] = 1.0
    out = trf.tt_rdf(torch.as_tensor(one), torch.as_tensor(v1),
                     torch.ones(8, 48, dtype=torch.float64))
    np.testing.assert_array_equal(out.numpy(), np.broadcast_to(
        v1[:, :, None], (8, 48, 96)))


def test_step_physics_with_randfh(models):
    """One step of the physics with the pattern against the JAX step, and
    the forcing perturbs only the temperature tendency."""
    jm, tm = models
    f = tm.state.at_level(0)
    jstate = JaxState(*(jnp.asarray(getattr(tm.state, n).numpy())
                        for n in JaxState._fields))
    jsurf = jdrv.SurfaceDailyState(*(np.asarray(v.numpy()) for v in tm.surf))
    jrad = jdrv.RadCarry(*(jnp.asarray(v.numpy()) for v in tm.rad))
    step = jax.jit(lambda s, surf, rad, rh: jm.phys.step_physics(
        jm.dy, s.at_level(0), surf, rad, jnp.asarray(True), randfh=rh))
    want_t, want_rad, want_fx = step(jstate, jsurf, jrad,
                                     jnp.asarray(jm._randfh))
    got_t, got_rad, got_fx = tm.phys.step_physics(
        tm.dy, f, tm.surf, tm.rad, True, randfh=tm._randfh)
    tol = 1e-10
    for name, g, w in zip(("du", "dv", "dtt", "dqt"), got_t, want_t):
        close(g, w, tol, name)
    for name in want_fx._fields:
        close(getattr(got_fx, name), getattr(want_fx, name), tol, name)

    base, _, _ = tm.phys.step_physics(tm.dy, f, tm.surf, tm.rad, True)
    d = [float((p - b).abs().max()) for p, b in zip(got_t, base)]
    assert d[0] == d[1] == d[3] == 0.0
    assert 0.0 < d[2] < 1e-2 and bool(torch.isfinite(got_t[2]).all())


# ----------------------------------------------------------------------
# SPPT
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def sppts(models):
    jm, tm = models
    return jsppt.Sppt(jm.dy), Sppt(tm.dy)


def test_sppt_constants(sppts):
    js, ts = sppts
    assert abs(ts.phi - js.phi) <= 1e-15 * js.phi
    close(ts.sigma, js.sigma, 1e-15, "sigma")
    close(ts.mu, js.mu, 1e-15, "mu")
    assert ts.sigma.shape == (31, 1, 32)


def test_sppt_given_noise(sppts):
    """init and three steps with the same noise in both packages."""
    js, ts = sppts
    rng = np.random.default_rng(2)
    etas = [np.clip(rng.standard_normal((8, 31, 2, 32)), -10, 10)
            for _ in range(4)]
    js._noise = lambda key, shape: jnp.asarray(etas[int(key)])
    ts.noise = lambda day, step: torch.as_tensor(etas[step])
    jst, tst = js.init(0), ts.init()
    close(tst.spec, np.asarray(jst.spec), 1e-12, "init")
    for j in range(3):
        jst, jpat = js.step(jst, j + 1)
        tst, tpat = ts.step(tst, 1, j)
        close(tst.spec, np.asarray(jst.spec), 1e-12, f"spec {j}")
        close(tpat, np.asarray(jpat), 1e-12, f"pattern {j}")


def test_sppt_tendency_scaling(sppts):
    """1 + pattern * mu on every tendency, as speedyml/model.py scales
    them, for a given pattern and tapered mu."""
    js, ts = sppts
    rng = np.random.default_rng(3)
    mu = np.linspace(0.2, 1.0, 8)
    js.mu, ts_mu = mu, Sppt(ts.dy, mu=mu)
    pattern = np.clip(rng.standard_normal((8, 48, 96)), -1, 1)
    tends = [rng.standard_normal((8, 48, 96)) for _ in range(3)] \
        + [rng.standard_normal((1, 8, 48, 96))]
    s = 1.0 + jnp.asarray(pattern) * jnp.asarray(js.mu)[:, None, None]
    want = [jnp.asarray(t) * s for t in tends]
    got = ts_mu.perturb([torch.as_tensor(t) for t in tends],
                        torch.as_tensor(pattern))
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, np.asarray(w), 1e-13, f"tendency {i}")


def _jax_sppt_spread(jm, n_steps):
    """The JAX package's grid pattern std before clipping, over n_steps of
    its own generator from its initial sample."""
    sp = jsppt.Sppt(jm.dy)
    key = jax.random.PRNGKey(0)
    st = sp.init(key)
    step = jax.jit(lambda st, k: sp.step(st, k)[0])
    var = 0.0
    for j in range(n_steps):
        st = step(st, jax.random.fold_in(key, j + 1))
        var += float((jm.dy.T.spec_to_grid(st.spec) ** 2).mean())
    return (var / n_steps) ** 0.5


def test_sppt_statistics(models):
    """The port's own noise: a pure function of (seed, day, step), and an
    AR(1) pattern with the reference's correlation and spread."""
    jm, tm = models
    sp = Sppt(tm.dy)
    np.testing.assert_array_equal(sp.noise(3, 5).numpy(),
                                  sp.noise(3, 5).numpy())
    assert not torch.equal(sp.noise(3, 5), sp.noise(3, 6))
    assert not torch.equal(sp.noise(3, 5), sp.noise(4, 5))
    st = sp.init()
    num = den = 0.0
    grid_var, n_steps = 0.0, 400
    for j in range(n_steps):
        prev = st.spec
        st, pattern = sp.step(st, 1 + j // 96, j % 96)
        assert float(pattern.abs().max()) <= 1.0
        num += float((prev * st.spec).sum())
        den += float((prev * prev).sum())
        grid_var += float((tm.dy.T.spec_to_grid(st.spec) ** 2).mean())
    assert abs(num / den - sp.phi) < 0.01, (num / den, sp.phi)
    std = (grid_var / n_steps) ** 0.5
    want = _jax_sppt_spread(jm, n_steps)
    assert abs(want - Sppt.STDDEV / 2 ** 0.5) < 0.1 * Sppt.STDDEV, want
    assert abs(std - want) < 0.05 * want, (std, want)


@pytest.fixture(scope="module")
def sppt_days(bindir):
    """One float32 day from rest with SPPT (twice) and without it."""
    out = {}
    for key, on in (("a", True), ("b", True), ("off", False)):
        m = Speedy(ModelConfig(sppt_on=on), bindir, device=CPU)
        m.initialize(1982, 1)
        m.run_day()
        out[key] = m
    return out


def test_sppt_day(sppt_days):
    a, b, off = (sppt_days[k] for k in ("a", "b", "off"))
    for name in a.state._fields:
        fa, fb = getattr(a.state, name), getattr(b.state, name)
        assert bool(torch.isfinite(fa).all()), name
        assert torch.equal(fa, fb), f"{name} differs between two runs"
    assert torch.equal(a._sppt_state.spec, b._sppt_state.spec)
    assert a._sppt_day == 1
    d = float((a.state.t - off.state.t).abs().max())
    assert d > 1e-3, "SPPT did not perturb the day"
    g = a.grid_view()
    assert 150.0 < g["t"].min() and g["t"].max() < 350.0
