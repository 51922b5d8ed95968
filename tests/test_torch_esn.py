"""speedyml_torch.reservoir.esn and generate against speedyml.

Inputs come from numpy seeds and cross with speedyml_torch.convert.
Tolerances:
  * float32 state updates: rtol 1e-6 / atol 1e-6. Both compute the same
    elementwise float32 ops; only the deg-term sums and tanh may round in
    another order (a few float32 ulps, ~1e-7).
  * float32 readout: 1e-5 of the output scale; a 5896-term float32 dot
    product summed in another order.
  * bf16 wout: the JAX package's own bound, < 2% of the output scale
    (tests/test_reservoir.py:67-82).
  * generate_esn: the numpy draws are shared; only the power iteration
    runs in torch (float64), so the radius scaling agrees to 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.reservoir import esn as jesn
from speedyml.reservoir.generate import generate_esn as jax_generate_esn
from speedyml.reservoir.generate import make_ring_adjacency
from speedyml_torch import convert
from speedyml_torch.reservoir import esn as tesn
from speedyml_torch.reservoir.generate import generate_esn

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

# the port's entry points build on the card unless told otherwise; these
# tests run on the CPU and say so
CPU = "cpu"


def to_cpu(a, dtype=None):
    return convert.tensor(a, CPU, dtype)


@pytest.fixture(scope="module")
def esn_pair():
    """The same seeded reservoir (ring topology) in both packages, with a
    random readout."""
    rng = np.random.default_rng(21)
    p = jax_generate_esn(seed=5, R=3, n_in=6, n_out=4, n_model=4,
                         m_target=60, deg=5)
    p = p._replace(wout=jnp.asarray(rng.normal(size=p.wout.shape) * 0.1,
                                    jnp.float32))
    return p, convert.esn_params(p, CPU)


@pytest.mark.parametrize("ring", [True, False])
def test_spmv_paths(ring):
    rng = np.random.default_rng(7)
    R, n, deg = 3, 24, 5
    if ring:
        idx, val, shifts = make_ring_adjacency(rng, R, n, deg)
    else:
        idx = rng.integers(0, n, (R, n, deg)).astype(np.int32)
        val, shifts = rng.normal(size=(R, n, deg)), None
    x = rng.normal(size=(R, n))
    want = np.asarray(jesn.spmv_ell(
        jnp.asarray(idx), jnp.asarray(val), jnp.asarray(x),
        None if shifts is None else jnp.asarray(shifts)))
    got = tesn.spmv_ell(to_cpu(idx, dtype=torch.int64),
                        to_cpu(val), to_cpu(x),
                        None if shifts is None
                        else tuple(int(s) for s in shifts))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    if ring:    # the shifted-slice path == the generic gather
        generic = tesn.spmv_ell(to_cpu(idx, dtype=torch.int64),
                                to_cpu(val), to_cpu(x))
        np.testing.assert_allclose(got.numpy(), generic.numpy(), rtol=1e-12)


def test_generate_esn_same_reservoir():
    for topology in ("ring", "er"):
        jp = jax_generate_esn(seed=3, R=4, n_in=8, n_out=3, n_model=3,
                              m_target=40, deg=4, topology=topology)
        tp = generate_esn(seed=3, R=4, n_in=8, n_out=3, n_model=3,
                          m_target=40, deg=4, topology=topology, device=CPU)
        np.testing.assert_array_equal(tp.a_idx.numpy(), np.asarray(jp.a_idx))
        np.testing.assert_array_equal(tp.win.numpy(), np.asarray(jp.win))
        np.testing.assert_array_equal(tp.node_map.numpy(),
                                      np.asarray(jp.node_map))
        np.testing.assert_allclose(tp.a_val.numpy(), np.asarray(jp.a_val),
                                   rtol=1e-6)
        assert tp.wout.shape == jp.wout.shape and tp.n_in == jp.n_in == 8
        assert (tp.a_shift is None) == (jp.a_shift is None)
        if tp.a_shift is not None:
            assert tp.a_shift == tuple(np.asarray(jp.a_shift).tolist())


def test_generate_esn_radius_float64():
    """The torch power iteration reproduces the numpy one in float64."""
    jp = jax_generate_esn(seed=9, R=2, n_in=4, n_out=2, n_model=0,
                          m_target=32, deg=3, dtype=np.float64)
    tp = generate_esn(seed=9, R=2, n_in=4, n_out=2, n_model=0, m_target=32,
                      deg=3, dtype=torch.float64, device=CPU)
    np.testing.assert_allclose(tp.a_val.numpy(), np.asarray(jp.a_val),
                               rtol=1e-12)


def test_advance_synchronize_predict(esn_pair):
    jp, tp = esn_pair
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, tp.n)).astype(np.float32)
    us = rng.normal(size=(5, 3, 6)).astype(np.float32)
    mv = rng.normal(size=(3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tesn.advance(tp, to_cpu(x), to_cpu(us[0])).numpy(),
        np.asarray(jax.jit(jesn.advance)(jp, jnp.asarray(x),
                                         jnp.asarray(us[0]))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tesn.synchronize(tp, to_cpu(x), to_cpu(us)).numpy(),
        np.asarray(jesn.synchronize(jp, jnp.asarray(x), jnp.asarray(us))),
        rtol=1e-6, atol=1e-6)
    xj, oj = jesn.predict_step(jp, jnp.asarray(x), jnp.asarray(us[1]),
                               jnp.asarray(mv))
    xt, ot = tesn.predict_step(tp, to_cpu(x),
                               to_cpu(us[1]), to_cpu(mv))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(oj)).max())
    np.testing.assert_array_equal(
        tesn.nonlinear_state(to_cpu(x)).numpy(),
        np.asarray(jesn.nonlinear_state(jnp.asarray(x))))


def test_readout_dtypes(esn_pair):
    jp, tp = esn_pair
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, tp.n)).astype(np.float32)
    mv = rng.normal(size=(3, 4)).astype(np.float32)
    xt, mvt = to_cpu(x), to_cpu(mv)
    full_j = np.asarray(jesn.readout(jp, jnp.asarray(x), jnp.asarray(mv)))
    full_t = tesn.readout(tp, xt, mvt)
    assert full_t.dtype == torch.float32
    scale = np.abs(full_j).mean()
    np.testing.assert_allclose(full_t.numpy(), full_j, rtol=0,
                               atol=1e-5 * max(scale, 1.0))
    # bf16 storage, f32 output: held to the JAX package's bound against the
    # f32 readout, and against the JAX bf16 readout to 1e-5 of the scale
    # (both sum the same exact products of bf16 values in f32)
    fast_t = tesn.readout(tesn.cast_wout(tp), xt, mvt)
    assert fast_t.dtype == torch.float32
    assert np.abs(fast_t.numpy() - full_j).max() < 0.02 * max(scale, 1.0)
    fast_j = np.asarray(jesn.readout(jesn.cast_wout(jp), jnp.asarray(x),
                                     jnp.asarray(mv)))
    np.testing.assert_allclose(fast_t.numpy(), fast_j, rtol=0,
                               atol=1e-5 * max(scale, 1.0))
    # an f64 readout stays f64
    tp64 = tesn.cast_wout(tp, torch.float64)
    out64 = tesn.readout(tp64, xt.double(), mvt.double())
    assert out64.dtype == torch.float64
    np.testing.assert_allclose(out64.numpy(), full_j, rtol=0,
                               atol=1e-5 * max(scale, 1.0))
    # ml-only: no model block
    jp0 = jp._replace(wout=jp.wout[..., 4:])
    tp0 = convert.esn_params(jp0, CPU)
    np.testing.assert_allclose(
        tesn.readout(tp0, xt).numpy(),
        np.asarray(jesn.readout(jp0, jnp.asarray(x))), rtol=0,
        atol=1e-5 * max(scale, 1.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_readout_split(esn_pair, dtype):
    """(outvec, v_ml, v_p) against the JAX package's, f32 and bf16 wout, to
    1e-5 of the output scale; the parts add up to the whole readout."""
    jp, tp = esn_pair
    if dtype == "bfloat16":
        jp, tp = jesn.cast_wout(jp), tesn.cast_wout(tp)
    rng = np.random.default_rng(13)
    x = rng.normal(size=(3, tp.n)).astype(np.float32)
    mv = rng.normal(size=(3, 4)).astype(np.float32)
    want = [np.asarray(v, np.float32) for v in jesn.readout_split(
        jp, jnp.asarray(x), jnp.asarray(mv))]
    got = tesn.readout_split(tp, to_cpu(x), to_cpu(mv))
    scale = max(np.abs(want[0]).mean(), 1.0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (3, 4)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * scale)
    out, v_ml, v_p = got
    assert torch.equal(out, v_p + v_ml)
    np.testing.assert_allclose(
        out.numpy(), tesn.readout(tp, to_cpu(x), to_cpu(mv)).numpy(),
        rtol=0, atol=1e-5 * scale)
    assert float(v_ml.abs().max()) > 0 and float(v_p.abs().max()) > 0


@pytest.mark.cuda
def test_bf16_readout_on_the_card(esn_pair):
    """cuBLAS's bf16 x bf16 -> f32 batched product against the CPU's
    widened one, to 1e-5 of the output scale (f32 sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, tp = esn_pair
    rng = np.random.default_rng(11)
    x = to_cpu(rng.normal(size=(3, tp.n)).astype(np.float32))
    mv = to_cpu(rng.normal(size=(3, 4)).astype(np.float32))
    p16 = tesn.cast_wout(tp)
    want = tesn.readout(p16, x, mv)
    p16_gpu = dataclasses.replace(p16, **{
        f: getattr(p16, f).cuda()
        for f in ("a_idx", "a_val", "win", "wout", "node_map")})
    got = tesn.readout(p16_gpu, x.cuda(), mv.cuda())
    assert got.dtype == torch.float32
    scale = max(float(want.abs().mean()), 1.0)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * scale)
