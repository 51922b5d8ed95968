"""speedyml_torch.hybrid.state_io and the dry window against speedyml.

The JAX reference window is the physics=False branch of
SpeedyForecaster._window_fn (speedyml/hybrid/forecast.py:140-148) on a
float64 dycore, built without a Speedy object or boundary files.
Tolerances: 1e-10 of each field's scale at float64. The window is 25 dycore
steps of the same arithmetic in another summation order; float64 rounding
stays near 1e-13 relative over it.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.core.config import ModelConfig
from speedyml.dynamics.core import Dycore as JaxDycore
from speedyml.hybrid import state_io as jio
from speedyml.hybrid.forecast import SpeedyForecaster as JaxForecaster
from speedyml_torch import convert
from speedyml_torch.dynamics.core import Dycore
from speedyml_torch.hybrid import state_io as tio
from speedyml_torch.hybrid.forecast import SpeedyForecaster

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

# the port's entry points build on the card unless told otherwise; these
# tests run on the CPU and say so
CPU = "cpu"


def to_cpu(a, dtype=None):
    return convert.tensor(a, CPU, dtype)

REL = 1e-10


@pytest.fixture(scope="module")
def dycores():
    cfg = ModelConfig(dtype="float64")
    return JaxDycore(cfg), Dycore(convert.model_config(cfg), device=CPU)


def _gridstate(jd, seed=0):
    """A smooth, physical grid state (as tests/test_hybrid.py:23-49)."""
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
    vor = np.stack([smooth_spec(1e-7) for _ in range(kx)])
    div = np.stack([smooth_spec(5e-8) for _ in range(kx)])
    u, v = (np.asarray(a) for a in jd.T.uv_grid(jnp.asarray(vor),
                                                jnp.asarray(div)))
    q = 5.0 + np.stack([smooth2d(0.1) for _ in range(kx)])
    return jio.GridState(t=t, u=u, v=v, q=q, logp=smooth2d(0.005))


def _assert_close(a, b, rel=REL):
    a = np.asarray(a)
    b = b.numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=rel * np.abs(a).max())


def test_inject_extract_safety(dycores):
    jd, td = dycores
    gs = _gridstate(jd)
    js, jsafe = jio.inject(jd, jio.GridState(*map(jnp.asarray, gs)))
    ts, tsafe = tio.inject(td, convert.grid_state(gs, CPU))
    assert bool(jsafe) and bool(tsafe)
    for name in js._fields:
        _assert_close(getattr(js, name), getattr(ts, name))
    jg, tg = jio.extract(jd, js), tio.extract(td, ts)
    for name in jg._fields:
        _assert_close(getattr(jg, name), getattr(tg, name))
    # the gate trips on the same out-of-bounds states
    for bad in (gs._replace(u=gs.u + 200.0), gs._replace(t=gs.t * 0 + 100.0),
                gs._replace(q=gs.q + 40.0), gs._replace(v=gs.v - 130.0)):
        assert not bool(jio.safety_check(bad))
        assert not bool(tio.safety_check(convert.grid_state(bad, CPU)))
        assert bool(jio.inject(jd, jio.GridState(*map(jnp.asarray, bad)))[1]) \
            == bool(tio.inject(td, convert.grid_state(bad, CPU))[1])


def test_dry_window(dycores):
    jd, td = dycores
    gs = _gridstate(jd, seed=1)
    sp = SimpleNamespace(config=jd.config, dy=jd, phys=None)
    window = jax.jit(JaxForecaster(sp, physics=False)._window_fn())
    ref = window(jio.GridState(*map(jnp.asarray, gs)), None,
                 jd.zero_forcing())
    fc = SpeedyForecaster.dry(td)
    assert fc.nsteps_window == 24
    out = fc.forecast(convert.grid_state(gs, CPU))
    assert bool(ref.safe) and bool(out.safe)
    for name in ref.gs._fields:
        _assert_close(getattr(ref.gs, name), getattr(out.gs, name))
    assert float(out.precip_mm.abs().max()) == 0.0
