"""speedyml_torch.dynamics against speedyml.dynamics (mirrors the dry-core
gate of tests/test_dynamics.py:64-101, on flat orography).

A seeded state goes through stepone and 10 filtered leapfrog steps in both
packages. Tolerances:
  * float64: 1e-10 of each field's scale. The two evaluate the same
    arithmetic in another order (einsum and matmul reductions), so they
    differ by float64 rounding, which 12 steps of a damped, semi-implicit
    scheme do not amplify past ~1e-13 relative.
  * float32: 1e-5 of each field's scale, float32 rounding (~6e-8 per
    operation) through the same 4 steps.
The host-built tables must agree exactly: they are the same numpy code.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.core.config import ModelConfig
from speedyml.dynamics import implicit as jimp
from speedyml.dynamics.core import Dycore as JaxDycore
from speedyml.dynamics.initial import rest_state as jax_rest_state
from speedyml.dynamics.state import SpectralState as JaxState
from speedyml_torch import convert
from speedyml_torch.dynamics import implicit as timp
from speedyml_torch.dynamics.core import Dycore
from speedyml_torch.dynamics.initial import rest_state

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

# the port's entry points build on the card unless told otherwise; these
# tests run on the CPU and say so
CPU = "cpu"


def to_cpu(a, dtype=None):
    return convert.tensor(a, CPU, dtype)

N_LEAPFROG = 10


def _orography(il=48, ix=96):
    """A smooth synthetic mountain range [m] (no boundary files needed)."""
    lat = np.linspace(-1.5, 1.5, il)[:, None]
    lon = np.linspace(0, 2 * np.pi, ix, endpoint=False)[None, :]
    return 2000.0 * np.exp(-((lat - 0.6) / 0.3) ** 2
                           - ((lon - 1.5) / 0.4) ** 2)


def _seeded_state(jd, seed=0):
    """Rest state plus band-limited perturbations of vor, div and T."""
    rng = np.random.default_rng(seed)
    s0 = jax_rest_state(jd)
    decay = np.exp(-0.1 * np.arange(jd.config.nx))

    def pert(x, scale):
        x = np.asarray(x)
        return x + scale * jd.T.host_trunct(rng.normal(size=x.shape) * decay)

    dt = s0.vor.dtype
    return JaxState(vor=jnp.asarray(pert(s0.vor, 1e-6), dt),
                    div=jnp.asarray(pert(s0.div, 5e-7), dt),
                    t=jnp.asarray(pert(s0.t, 0.5), dt), ps=s0.ps, tr=s0.tr)


def _run_pair(dtype, nsteps):
    cfg = ModelConfig(dtype=dtype)
    jd = JaxDycore(cfg)
    td = Dycore(convert.model_config(cfg), device=CPU)
    js = _seeded_state(jd)
    ts = convert.spectral_state(js, CPU)
    jf, tf = jd.zero_forcing(), td.zero_forcing()
    jstep = jax.jit(lambda s, f: jd.step(s, f, 1, 1, "delt2"))
    js = jax.jit(jd.stepone)(js, jf)
    ts = td.stepone(ts, tf)
    for _ in range(nsteps):
        js = jstep(js, jf)
        ts = td.step(ts, tf, 1, 1, "delt2")
    return js, ts


def _assert_state_close(js, ts, rel):
    for name in js._fields:
        a = np.asarray(getattr(js, name))
        b = getattr(ts, name).numpy()
        assert a.dtype == b.dtype, name
        scale = np.abs(a).max()
        np.testing.assert_allclose(b, a, rtol=0, atol=rel * scale,
                                   err_msg=name)


def test_leapfrog_float64():
    js, ts = _run_pair("float64", N_LEAPFROG)
    _assert_state_close(js, ts, 1e-10)
    # the (0,0) coefficient of log-ps is conserved exactly
    # (psdt(0,0)=0 each step, dyn_grtend.f90:103)
    assert float(ts.ps[0, 0, 0, 0]) == float(js.ps[0, 0, 0, 0])


def test_leapfrog_float32():
    js, ts = _run_pair("float32", 2)
    _assert_state_close(js, ts, 1e-5)


@pytest.mark.parametrize("orog", [None, "mountain"])
def test_rest_state_and_tables(orog):
    orog = None if orog is None else _orography()
    cfg = ModelConfig(dtype="float64")
    jd = JaxDycore(cfg, orog=orog)
    td = Dycore(convert.model_config(cfg), orog=orog, device=CPU)
    _assert_state_close(jax_rest_state(jd), rest_state(td), 0.0)
    np.testing.assert_array_equal(td.phis.numpy(), np.asarray(jd.phis))
    for key in ("half", "delt", "delt2"):
        jt = jimp.build_implicit(jd.vg, td._dt[key], cfg.alph, cfg.mx,
                                 cfg.nx)
        tt = timp.build_implicit(td.vg, td._dt[key], cfg.alph, cfg.mx,
                                 cfg.nx)
        for f in ("xc", "xd", "dhsx", "elz", "xj_mn", "tref"):
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f))


def test_geopotential_and_implicit_correction():
    cfg = ModelConfig(dtype="float64")
    orog = _orography()
    jd = JaxDycore(cfg, orog=orog)
    td = Dycore(convert.model_config(cfg), orog=orog, device=CPU)
    js = _seeded_state(jd, seed=4)
    t_spec = np.array(js.t[0])
    phi_j = jimp.geopotential(jnp.asarray(t_spec), jd.phis, jd.vg_jnp)
    phi_t = timp.geopotential(to_cpu(t_spec), td.phis, td.vg_np,
                              td.geop_corrections)
    scale = np.abs(np.asarray(phi_j)).max()
    np.testing.assert_allclose(phi_t.numpy(), np.asarray(phi_j), rtol=0,
                               atol=1e-13 * scale)

    rng = np.random.default_rng(5)
    kx, mx, nx = cfg.kx, cfg.mx, cfg.nx
    divdt, tdt = (rng.normal(size=(kx, mx, 2, nx)) for _ in range(2))
    psdt = rng.normal(size=(mx, 2, nx))
    out_j = jimp.implicit_correction(jd.imp_main, jnp.asarray(divdt),
                                     jnp.asarray(tdt), jnp.asarray(psdt))
    out_t = timp.implicit_correction(td.imp_main, to_cpu(divdt),
                                     to_cpu(tdt),
                                     to_cpu(psdt))
    for a, b in zip(out_j, out_t):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-13 * np.abs(a).max())
