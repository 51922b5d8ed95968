"""bfloat16 grid compute (ModelConfig.grid_compute="bfloat16") and the
dycore's multi-step runner of speedyml_torch, against speedyml.

Tolerances:
  * one grtend in bf16 against the JAX package's bf16 grtend on the same
    float32 state: each tendency to GRTEND_TOL of its largest value. Both
    cast the same grid fields at the same points, but XLA fuses the
    elementwise chains and may round once per fusion where eager torch
    rounds every op to bf16 (relative 2^-8 each). On this state the port
    and JAX differ by (vordt, divdt, tdt, psdt, trdt) 1.6e-4, 1.3e-4,
    1.5e-4, 8.6e-4, 4.9e-5 of scale, and the port's bf16 and float32
    tendencies by 2.1e-3, 1.9e-3, 2.8e-4, 2.2e-3, 1.4e-3. Each limit lies
    between the two, and every tendency must also stand further than its
    limit from the float32 one: a tendency left in float32, or cast at
    other points, fails one of the two.
  * one day of the dry core from rest over the stand-in orography, bf16
    against float32: rms < 0.2 K and max < 2 K of temperature, the bounds
    of tests/test_dynamics.py:116-141 (TestBf16GridCompute).
  * run_steps against repeated step: bitwise (the same calls).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.core.config import ModelConfig as JaxConfig
from speedyml.dynamics.core import Dycore as JaxDycore
from speedyml.dynamics.tendencies import grtend as jax_grtend
from speedyml_torch import ModelConfig, convert
from speedyml_torch.dynamics.core import Dycore
from speedyml_torch.dynamics.initial import rest_state
from speedyml_torch.dynamics.tendencies import grtend
from speedyml_torch.io.synthetic_boundary import synthetic_fields
from tests.test_torch_dynamics import _seeded_state

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

CPU = "cpu"
GRTEND_TOL = dict(vordt=5e-4, divdt=5e-4, tdt=2e-4, psdt=1.3e-3,
                  trdt=2.5e-4)


@pytest.fixture(scope="module")
def orog():
    return synthetic_fields(seed=5)["fort.20"][0]


def test_grtend_bf16_against_jax(orog):
    jcfg = JaxConfig(grid_compute="bfloat16")
    jd = JaxDycore(jcfg, orog=orog)
    td = Dycore(convert.model_config(jcfg), orog=orog, device=CPU)
    t32 = Dycore(ModelConfig(), orog=orog, device=CPU)
    assert td.grid_dtype == torch.bfloat16 and t32.grid_dtype is None
    js = _seeded_state(jd, seed=2)
    ts = convert.spectral_state(js, CPU)
    jt, _ = jax.jit(lambda f: jax_grtend(jd, f, f))(js.at_level(0))
    tt, _ = grtend(td, ts.at_level(0), ts.at_level(0))
    tf, _ = grtend(t32, ts.at_level(0), ts.at_level(0))
    assert set(jt._fields) == set(GRTEND_TOL)
    for name in jt._fields:
        a = np.asarray(getattr(jt, name))
        b = getattr(tt, name)
        assert b.dtype == torch.float32, name     # spectral stays float32
        scale = np.abs(a).max()
        tol = GRTEND_TOL[name] * scale
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=tol,
                                   err_msg=name)
        # the bf16 path is not the float32 one
        assert float((b - getattr(tf, name)).abs().max()) > tol, name


def test_bf16_day_tracks_f32(orog):
    """One day (4 x 24 steps) of the dry core from rest over the stand-in
    orography in each grid dtype."""
    tgs = {}
    for gc in ("bfloat16", "float32"):
        dy = Dycore(ModelConfig(grid_compute=gc), orog=orog, device=CPU)
        f = dy.zero_forcing()
        s = dy.run_steps(dy.stepone(rest_state(dy), f), f, 96)
        tg = dy.T.spec_to_grid(s.t[0]).numpy()
        assert np.isfinite(tg).all()
        tgs[gc] = tg
    d = tgs["bfloat16"] - tgs["float32"]
    assert np.sqrt((d ** 2).mean()) < 0.2
    assert np.abs(d).max() < 2.0
    assert np.abs(d).max() > 0.0


def test_run_steps_equals_step_loop():
    """run_steps == repeated step() calls: no hidden state
    (tests/test_determinism.py:29-35); and make_scan_step is that step."""
    dy = Dycore(ModelConfig(dtype="float64"), device=CPU)
    forcing = dy.zero_forcing()
    s0 = dy.stepone(rest_state(dy), forcing)
    s_run = dy.run_steps(s0, forcing, 5)
    s_loop = s0
    f = dy.make_scan_step()
    for _ in range(5):
        s_loop = f(s_loop, forcing)
    for a, b in zip(s_run, s_loop):
        assert torch.equal(a, b)
    s_one = dy.step(s0, forcing, 1, 1, "delt2")
    for a, b in zip(dy.run_steps(s0, forcing, 1), s_one):
        assert torch.equal(a, b)


@pytest.mark.parametrize("gc", ["float16", "bf16"])
def test_unknown_grid_compute_raises(gc):
    with pytest.raises(ValueError, match="grid_compute"):
        Dycore(ModelConfig(grid_compute=gc), device=CPU)
