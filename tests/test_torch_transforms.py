"""speedyml_torch.transforms.spectral against speedyml.transforms.spectral.

Both run in float64 on the CPU from the same numpy inputs. Tolerance: 1e-12
of the field's scale. The two evaluate the same einsums and matmuls in
another summation order, so they differ by float64 rounding (~1e-16 per
operation, a few hundred operations deep).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from speedyml.transforms.spectral import SpectralTransform as JaxTransform
from speedyml_torch import convert
from speedyml_torch.transforms.spectral import SpectralTransform

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

# the port's entry points build on the card unless told otherwise; these
# tests run on the CPU and say so
CPU = "cpu"


def to_cpu(a, dtype=None):
    return convert.tensor(a, CPU, dtype)

RTOL = 1e-12


@pytest.fixture(scope="module")
def transforms():
    return (JaxTransform(dtype=jnp.float64),
            SpectralTransform(dtype=torch.float64, device=CPU))


def _spec(jt, rng, lead=(3,)):
    """Truncated spectral fields with decaying coefficients."""
    mx, nx = jt.mx, jt.nx
    decay = np.exp(-0.1 * (np.arange(mx)[:, None, None]
                           + np.arange(nx)[None, None, :]))
    sp = rng.normal(size=lead + (mx, 2, nx)) * decay
    sp[..., 0, 1, :] = 0.0      # a real field has no imaginary zonal mean
    return jt.host_trunct(sp)


def _close(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    scale = max(np.abs(a).max(), 1e-300)
    np.testing.assert_allclose(b, a, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("kcos", [1, 2])
def test_spec_to_grid_and_back(transforms, kcos):
    jt, tt = transforms
    sp = _spec(jt, np.random.default_rng(kcos))
    g_j = jt.spec_to_grid(jnp.asarray(sp), kcos=kcos)
    g_t = tt.spec_to_grid(to_cpu(sp), kcos=kcos)
    _close(g_j, g_t)
    _close(jt.grid_to_spec(g_j), tt.grid_to_spec(g_t))
    if kcos == 1:
        # the round trip of a truncated field is the identity
        _close(sp, tt.grid_to_spec(g_t))


def test_spectral_operators(transforms):
    jt, tt = transforms
    rng = np.random.default_rng(7)
    a, b = _spec(jt, rng), _spec(jt, rng)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    at, bt = to_cpu(a), to_cpu(b)
    for name in ("lap", "invlap", "trunct"):
        _close(getattr(jt, name)(aj), getattr(tt, name)(at))
    for j_out, t_out in ((jt.grad(aj), tt.grad(at)),
                         (jt.uvspec(aj, bj), tt.uvspec(at, bt)),
                         (jt.vds(aj, bj), tt.vds(at, bt)),
                         (jt.uv_grid(aj, bj), tt.uv_grid(at, bt))):
        for x, y in zip(j_out, t_out):
            _close(x, y)


@pytest.mark.parametrize("kcos", [1, 2])
def test_vdspec(transforms, kcos):
    jt, tt = transforms
    rng = np.random.default_rng(11 + kcos)
    ug, vg = (rng.normal(size=(2, jt.il, jt.ix)) for _ in range(2))
    for x, y in zip(jt.vdspec(jnp.asarray(ug), jnp.asarray(vg), kcos=kcos),
                    tt.vdspec(to_cpu(ug), to_cpu(vg),
                              kcos=kcos)):
        _close(x, y)


def test_host_helpers(transforms):
    jt, tt = transforms
    rng = np.random.default_rng(3)
    grid = rng.normal(size=(jt.il, jt.ix))
    sp = _spec(jt, rng, lead=())
    _close(jt.host_grid_to_spec(grid), tt.host_grid_to_spec(grid))
    for kcos in (1, 2):
        _close(jt.host_spec_to_grid(sp, kcos), tt.host_spec_to_grid(sp, kcos))
    _close(jt.host_trunct(grid[:jt.mx, :jt.nx][:, None, :]),
           tt.host_trunct(grid[:jt.mx, :jt.nx][:, None, :]))


def test_float32_tables_match(transforms):
    """The float32 operators are the float64 tables rounded once, as the JAX
    package rounds them."""
    jt = JaxTransform(dtype=jnp.float32)
    tt = SpectralTransform(dtype=torch.float32, device=CPU)
    for name in ("leg_inv", "leg_fwd", "dft_inv", "dft_fwd", "el2", "uvdym",
                 "gradx", "cosgr"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, name)),
                                      getattr(tt, name).numpy())
