"""speedyml_torch.ops.accum (compensated normal-equation accumulation).

On the CPU the wrappers take the plain PyTorch version, which is held to the
JAX package's XLA form and to its Pallas kernels in interpret mode at the
shapes of tests/test_ops.py. The CUDA kernel is held to the plain version
on the card (rtol 1e-5: split-precision tensor-core products, another
summation order); that test skips where there is no GPU.

Tolerances: rtol 1e-6 / atol 1e-5 on hi+lo in float64, as
tests/test_ops.py: each chunk's product is an f32 sum of up to 24 terms of
size ~1 taken in another order (rounding ~1e-7 relative per term); the
two-sum itself is exact in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.ops import accum as jacc
from speedyml_torch import convert
from speedyml_torch.ops import accum

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

# the port's entry points build on the card unless told otherwise; these
# tests run on the CPU and say so
CPU = "cpu"


def to_cpu(a, dtype=None):
    return convert.tensor(a, CPU, dtype)


def _tot(hi, lo):
    if isinstance(hi, torch.Tensor):
        return hi.double().cpu().numpy() + lo.double().cpu().numpy()
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def test_chunk_matches_xla_and_pallas():
    rng = np.random.default_rng(0)
    R, chunk, na = 3, 24, 200           # na not a tile multiple on purpose
    P = jacc.pad_to_tile(na)
    aug = rng.normal(size=(chunk, R, na)).astype(np.float32)
    hi0 = (rng.normal(size=(R, P, P)) * 10).astype(np.float32)
    lo0 = np.zeros((R, P, P), np.float32)

    hi, lo = to_cpu(hi0[:, :na, :na]), to_cpu(lo0[:, :na, :na])
    before = accum.accumulate_ss.launches
    out = accum.accumulate_ss(hi, lo, to_cpu(aug))
    assert out[0] is hi and out[1] is lo            # updated in place
    tot = _tot(hi, lo)
    for ref in (jacc.accumulate_ss_xla(jnp.asarray(hi0), jnp.asarray(lo0),
                                       jnp.asarray(aug)),
                jacc.accumulate_ss(jnp.asarray(hi0), jnp.asarray(lo0),
                                   jnp.asarray(aug), interpret=True)):
        np.testing.assert_allclose(tot, _tot(*ref)[:, :na, :na], rtol=1e-6,
                                   atol=1e-5)
    assert accum.accumulate_ss.launches == before   # CPU: no kernel


def test_scan_matches_pallas_interpret():
    """The whole-series fold == the Pallas scan kernel (T not a chunk
    multiple) == an f64 einsum."""
    rng = np.random.default_rng(2)
    R, T, na, chunk = 2, 20, 136, 8
    P = jacc.pad_to_tile(na)
    aug = rng.normal(size=(T, R, na)).astype(np.float32)
    hi0 = rng.normal(size=(R, P, P)).astype(np.float32)
    lo0 = np.zeros((R, P, P), np.float32)
    hi, lo = to_cpu(hi0[:, :na, :na]), to_cpu(lo0[:, :na, :na])
    accum.accumulate_ss_scan(hi, lo, to_cpu(aug), chunk)
    ref = jacc.accumulate_ss_scan(jnp.asarray(hi0), jnp.asarray(lo0),
                                  jnp.asarray(aug), chunk=chunk,
                                  interpret=True)
    np.testing.assert_allclose(_tot(hi, lo), _tot(*ref)[:, :na, :na],
                               rtol=1e-6, atol=1e-5)
    a64 = aug.astype(np.float64)
    want = hi0[:, :na, :na] + np.einsum("tra,trb->rab", a64, a64)
    np.testing.assert_allclose(_tot(hi, lo), want, rtol=1e-5, atol=1e-4)


def test_compensation_improves_precision():
    """The hi/lo pair tracks many tiny increments that plain f32 loses
    (tests/test_ops.py:95-114)."""
    rng = np.random.default_rng(1)
    P = 128
    hi = torch.full((1, P, P), 1e6)
    lo = torch.zeros((1, P, P))
    ref64 = np.full((P, P), 1e6)
    plain = np.full((P, P), 1e6, np.float32)
    for _ in range(20):
        a = (rng.normal(size=(8, 1, P)) * 0.01).astype(np.float32)
        accum.accumulate_ss(hi, lo, to_cpu(a))
        d = np.einsum("tra,trb->rab", a.astype(np.float64),
                      a.astype(np.float64))[0]
        ref64 += d
        plain = (plain + d.astype(np.float32)).astype(np.float32)
    err_comp = np.abs(_tot(hi, lo)[0] - ref64).max()
    err_plain = np.abs(plain.astype(np.float64) - ref64).max()
    assert err_comp < err_plain / 4, (err_comp, err_plain)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    aug = torch.zeros(4, 2, 8)
    ss = torch.zeros(2, 8, 8)
    with pytest.raises(TypeError):
        accum.accumulate_ss_scan(ss.double(), ss.double(), aug.double(), 2)
    with pytest.raises(ValueError):
        accum.accumulate_ss_scan(torch.zeros(2, 9, 9), torch.zeros(2, 9, 9),
                                 aug, 2)
    with pytest.raises(ValueError):
        accum.accumulate_ss_scan(ss, ss.clone(), aug[0], 2)
    with pytest.raises(ValueError):
        accum.accumulate_ss_scan(ss, ss.clone(), aug, 0)
    with pytest.raises(ValueError):
        accum.accumulate_ss_scan(ss, ss.clone(), aug.to("meta"), 2)


# the slab ocean's training series are a few weeks long: T below one 32-step
# stage of the kernel and below one 8-step product block, at a width that is
# a whole number of 64-row tiles (na = 4032 = 63 x 64 at reference width)
SHORT_SERIES = [1, 3, 7, 8, 9, 33]


@pytest.mark.parametrize("T", SHORT_SERIES)
def test_short_series_plain(T):
    """The plain version at the ocean's short series, chunk = min(16, T) as
    train_ocean sets it, from nonzero hi and lo, against an f64 product."""
    rng = np.random.default_rng(T)
    R, na = 2, 192
    aug = rng.normal(size=(T, R, na)).astype(np.float32)
    hi0 = (rng.normal(size=(R, na, na)) * 10).astype(np.float32)
    lo0 = (rng.normal(size=(R, na, na)) * 1e-6).astype(np.float32)
    hi, lo = to_cpu(hi0), to_cpu(lo0)
    accum.accumulate_ss_scan(hi, lo, to_cpu(aug), min(16, T))
    a64 = aug.astype(np.float64)
    want = hi0.astype(np.float64) + lo0 + np.einsum("tra,trb->rab", a64, a64)
    np.testing.assert_allclose(_tot(hi, lo), want, rtol=1e-6, atol=1e-5)
    ref = jacc.accumulate_ss_scan(jnp.asarray(hi0), jnp.asarray(lo0),
                                  jnp.asarray(aug), chunk=min(16, T),
                                  interpret=True) if T in (3, 9) else None
    if ref is not None:
        np.testing.assert_allclose(_tot(hi, lo), _tot(*ref), rtol=1e-6,
                                   atol=1e-5)


@pytest.mark.parametrize("tf32", [True, False])
def test_plain_restores_the_tf32_flag(tf32):
    """The plain version takes its products without TF32 and hands the
    caller's setting back, on any device."""
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        hi, lo = torch.zeros(1, 4, 4), torch.zeros(1, 4, 4)
        accum.accumulate_ss_plain(hi, lo, torch.ones(3, 1, 4), 2)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert float(hi[0, 0, 0] + lo[0, 0, 0]) == 3.0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,R,na,chunk", [
    (20, 2, 136, 8), (37, 3, 200, 16), (256, 2, 700, 128),
    (45, 2, 137, 8),        # odd na: rows of aug and hi/lo start on 4 bytes
                            # only; 6 chunks; T not a multiple of the 32-step
                            # stage nor of the 2-stage ring
    (333, 2, 201, 64),      # 11 stages, the last ragged; odd na
    (100, 1, 64, 100),      # one tile, one chunk, 4 stages
    (96, 3, 2048, 32),      # 1536 blocks: several waves over the card, so
                            # tiles start and end beside running ones
    (64, 4, 5896, 64),      # the training pipeline's series: 64 pairs in
                            # one chunk at reference width (fewer regions)
])
def test_kernel_matches_plain(cuda_device, T, R, na, chunk):
    """The CUDA kernel against the plain version on the card, with ragged
    na and T edges, aug read through strides (a (R, T, na) buffer seen as
    (T, R, na)), and an unsymmetric hi with a nonzero lo to start from.
    rtol 1e-5: the kernel forms each product from three TF32 tensor-core
    products of split operands and folds every 32 steps; the plain version
    sums each chunk in f32, in another order."""
    g = torch.Generator(device=cuda_device).manual_seed(T)
    aug = torch.randn(R, T, na, device=cuda_device, generator=g)
    aug = aug.transpose(0, 1)
    hi0 = torch.randn(R, na, na, device=cuda_device, generator=g) * 10
    lo0 = torch.randn(R, na, na, device=cuda_device, generator=g) * 1e-6
    assert not torch.equal(hi0, hi0.mT)
    hk, lk = hi0.clone(), lo0.clone()
    before = accum.accumulate_ss_scan.launches
    accum.accumulate_ss_scan(hk, lk, aug, chunk)
    assert accum.accumulate_ss_scan.launches == before + 1
    hp, lp = hi0.clone(), lo0.clone()
    accum.accumulate_ss_plain(hp, lp, aug, chunk)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_tot(hk, lk), _tot(hp, lp), rtol=1e-5,
                               atol=1e-4)
    hk1, lk1 = hi0.clone(), lo0.clone()
    accum.accumulate_ss(hk1, lk1, aug[:chunk])
    hp1, lp1 = hi0.clone(), lo0.clone()
    accum.accumulate_ss_plain(hp1, lp1, aug[:chunk], chunk)
    np.testing.assert_allclose(_tot(hk1, lk1), _tot(hp1, lp1), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("T", SHORT_SERIES)
@pytest.mark.parametrize("R,na", [(2, 192), (3, 4032)])
def test_kernel_matches_plain_short_series(cuda_device, T, R, na):
    """The kernel at the ocean's shapes: series shorter than one stage (and
    than one 8-step product block), padded by the pre-pass, and a width
    without a ragged tile. Same tolerance as test_kernel_matches_plain."""
    g = torch.Generator(device=cuda_device).manual_seed(100 + T)
    aug = torch.randn(T, R, na, device=cuda_device, generator=g)
    hi0 = torch.randn(R, na, na, device=cuda_device, generator=g) * 10
    lo0 = torch.randn(R, na, na, device=cuda_device, generator=g) * 1e-6
    hk, lk = hi0.clone(), lo0.clone()
    before = accum.accumulate_ss_scan.launches
    accum.accumulate_ss_scan(hk, lk, aug, min(16, T))
    assert accum.accumulate_ss_scan.launches == before + 1
    hp, lp = hi0.clone(), lo0.clone()
    accum.accumulate_ss_plain(hp, lp, aug, min(16, T))
    torch.cuda.synchronize()
    np.testing.assert_allclose(_tot(hk, lk), _tot(hp, lp), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
def test_launches_count_segments(cuda_device):
    """A series longer than the kernel's segment goes through in several
    launches, and the counter counts each: ceil(T / 448) at R=48, na=5896.
    The result is held to the plain version in the first 8 regions at rtol
    1e-5, with 1e-5 of the mean entry as the absolute floor for entries that
    cancel to near zero (the rule chip_smoke.py holds the kernel to at
    training shapes: a 936-step sum has entries of ~30 off the diagonal)."""
    R, na, T, chunk = 48, 5896, 2 * 448 + 40, 64
    seg = accum.segment_steps(R, na)
    assert seg == 448
    g = torch.Generator(device=cuda_device).manual_seed(7)
    aug = torch.randn(T, R, na, device=cuda_device, generator=g)
    hk = torch.zeros(R, na, na, device=cuda_device)
    lk = torch.zeros_like(hk)
    before = accum.accumulate_ss_scan.launches
    accum.accumulate_ss_scan(hk, lk, aug, chunk)
    assert accum.accumulate_ss_scan.launches == before + -(-T // seg) == \
        before + 3
    before = accum.accumulate_ss.launches
    accum.accumulate_ss(hk, lk, aug)
    assert accum.accumulate_ss.launches == before + 3
    hp = torch.zeros(8, na, na, device=cuda_device)
    lp = torch.zeros_like(hp)
    accum.accumulate_ss_plain(hp, lp, aug[:, :8], chunk)
    accum.accumulate_ss_plain(hp, lp, aug[:, :8], T)
    torch.cuda.synchronize()
    want = _tot(hp, lp)
    np.testing.assert_allclose(_tot(hk[:8], lk[:8]), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).mean())
