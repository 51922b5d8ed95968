"""speedyml_torch.reservoir.training and hybrid.experiment.train_hybrid
against speedyml, with no training noise.

Tolerances:
  * reservoir states: rtol 1e-6 / atol 1e-6 (the same float32 elementwise
    ops; a few ulps from sums taken in another order);
  * normal equations: rtol 1e-5 / atol 1e-4 on hi+lo, as
    tests/test_ops.py:50 (float32 chunk products summed in another order);
  * ridge_solve from the SAME normal equations: 1e-9 of the readout's
    scale. Both solve in float64 (LU in the JAX package, Cholesky here), so
    they differ by float64 rounding times the system's condition number.
  * train_hybrid readouts: relative Frobenius distance per region < 0.05,
    the bound tests/test_hybrid.py:324 sets for training-input
    perturbations. The float32 accumulation rounds differently
    (~1e-7 relative) and the ill-conditioned solve amplifies that into
    the readout's poorly determined directions; the fitted PREDICTIONS,
    which the ridge fit pins, agree to 0.5% of each field's range.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.core.config import ReservoirConfig
from speedyml.domain.decomposition import build_layout
from speedyml.hybrid import experiment as jexp
from speedyml.reservoir import training as jtr
from speedyml.reservoir.generate import generate_esn as jax_generate_esn
from speedyml_torch import convert
from speedyml_torch.hybrid import experiment as texp
from speedyml_torch.reservoir import training as ttr

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
        return hi.double().numpy() + lo.double().numpy()
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


@pytest.fixture(scope="module")
def driven():
    """The same reservoir driven over the same series in both packages."""
    rng = np.random.default_rng(3)
    jp = jax_generate_esn(1, R=3, n_in=8, n_out=4, n_model=4, m_target=16,
                          deg=3)
    tp = convert.esn_params(jp, CPU)
    T = 40
    u, y, m = (rng.normal(size=(T, 3, k)).astype(np.float32)
               for k in (8, 4, 4))
    x0 = np.zeros((3, tp.n), np.float32)
    xj = jtr.drive_discard(jp, jnp.asarray(x0), jnp.asarray(u[:6]))
    xt = ttr.drive_discard(tp, to_cpu(x0), to_cpu(u[:6]))
    accj = jtr.init_normal_eq(jp, 4)._replace(x=xj)
    acct = ttr.init_normal_eq(tp, 4)._replace(x=xt)
    accj = jtr.drive_and_accumulate(jp, accj, jnp.asarray(u[6:]),
                                    jnp.asarray(y[6:]), jnp.asarray(m[6:]),
                                    chunk=8, use_pallas=False)
    acct = ttr.drive_and_accumulate(tp, acct, to_cpu(u[6:]),
                                    to_cpu(y[6:]),
                                    to_cpu(m[6:]), chunk=8)
    return (xj, xt), accj, acct


def test_drive_discard(driven):
    (xj, xt), _, _ = driven
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6,
                               atol=1e-6)


def test_drive_and_accumulate(driven):
    _, accj, acct = driven
    # T = 34 pairs, chunk 8: both fold the first 32 and drop the rest
    np.testing.assert_allclose(acct.x.numpy(), np.asarray(accj.x),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_tot(acct.ss_hi, acct.ss_lo),
                               _tot(accj.ss_hi, accj.ss_lo),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_tot(acct.sy_hi, acct.sy_lo),
                               _tot(accj.sy_hi, accj.sy_lo),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("noise_mag", [0.0, 0.1])
def test_segmented_fold_bitwise(driven, noise_mag, monkeypatch):
    """Driven and folded two chunks at a time, the series gives the
    one-segment result bitwise: the plain fold goes chunk by chunk, and a
    segment of whole chunks changes no chunk (the noise is drawn for the
    whole series first, so it is the same too). Without noise it is held to
    the JAX drive_and_accumulate as test_drive_and_accumulate holds it."""
    _, accj, _ = driven
    rng = np.random.default_rng(3)
    jp = jax_generate_esn(1, R=3, n_in=8, n_out=4, n_model=4, m_target=16,
                          deg=3)
    tp = convert.esn_params(jp, CPU)
    u, y, m = (to_cpu(rng.normal(size=(40, 3, k)).astype(np.float32))
               for k in (8, 4, 4))
    x = ttr.drive_discard(tp, torch.zeros((3, tp.n)), u[:6])
    na = 4 + tp.n
    assert ttr.fold_segment(3, na, 8, CPU) >= 34   # one segment by default
    res = []
    for segmented in (False, True):
        if segmented:
            monkeypatch.setattr(ttr, "fold_segment", lambda *a: 16)
        acc = ttr.init_normal_eq(tp, 4)._replace(x=x)
        res.append(ttr.drive_and_accumulate(
            tp, acc, u[6:], y[6:], m[6:], noise_mag=noise_mag,
            generator=torch.Generator().manual_seed(4), chunk=8))
    for a, b in zip(*res):
        assert torch.equal(a, b)
    if noise_mag == 0.0:
        np.testing.assert_allclose(_tot(res[1].ss_hi, res[1].ss_lo),
                                   _tot(accj.ss_hi, accj.ss_lo),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(_tot(res[1].sy_hi, res[1].sy_lo),
                                   _tot(accj.sy_hi, accj.sy_lo),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(res[1].x.numpy(), np.asarray(accj.x),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prior_val", [0.0, 0.5])
def test_ridge_solve(driven, prior_val):
    _, accj, _ = driven
    acc = ttr.NormalEq(*(to_cpu(a) for a in accj))
    kw = dict(n_model=4, beta_res=1e-3, beta_model=1.0, prior_val=prior_val,
              use_prior=prior_val != 0.0)
    wj = np.asarray(jtr.ridge_solve(accj, **kw))
    wt = ttr.ridge_solve(acc, **kw)
    assert wt.dtype == torch.float64 and wt.shape == wj.shape
    np.testing.assert_allclose(wt.numpy(), wj, rtol=0,
                               atol=1e-9 * np.abs(wj).max())


def _small_problem(T=160, seed=5):
    """The small synthetic grid of tests/test_hybrid.py:96-129."""
    L = build_layout(ix=12, il=6, kx=2, nvars=4, resx=2, resy=2, overlap=1)
    rcfg = ReservoirConfig(nodes_per_input=600, degree=4, sigma=0.5,
                           leakage=1.0, beta_res=1e-3, beta_model=1.0,
                           noise_std=0.0, timestep=6, discardlength=60,
                           synclength=36)
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None, None]
    yy = np.linspace(0, 2 * np.pi, L.il)[None, :, None]
    xx = np.linspace(0, 2 * np.pi, L.ix, endpoint=False)[None, None, :]

    def wave(a, ky, kxw, om, ph):
        return a * np.sin(ky * yy + kxw * xx - om * t + ph)

    atmo = np.empty((T, L.nvars, L.kx, L.il, L.ix))
    for v in range(L.nvars):
        base = 250.0 if v == 0 else (5.0 if v == 3 else 0.0)
        for k in range(L.kx):
            atmo[:, v, k] = base + wave(2.0 + 0.2 * k, 1 + (v % 2), 2,
                                        0.35 + 0.05 * v, rng.uniform(0, 6))
    logp = 0.02 * np.sin(yy + xx - 0.3 * t)
    precip = np.maximum(0.0, wave(0.4, 1, 3, 0.5, 1.0))
    sst = 290.0 + wave(3.0, 1, 1, 0.1, 0.3)
    tisr = np.maximum(0.0, 300.0 * np.cos(yy) + wave(30.0, 1, 1, 0.9, 0.0))
    fields = (atmo, logp, precip, sst, tisr)
    gv = jexp.transform_and_pack(L, *fields, rcfg.precip_epsilon)
    gv_t = texp.transform_and_pack(convert.region_layout(L),
                                   *map(to_cpu, fields),
                                   rcfg.precip_epsilon)
    np.testing.assert_array_equal(gv_t.numpy(), gv)
    gv_model = (gv + 0.3 * np.sin(gv)
                + 0.05 * rng.normal(size=gv.shape)).astype(np.float32)
    return L, rcfg, gv, gv_model


@pytest.mark.parametrize("mode", ["ml_only", "hybrid"])
def test_train_hybrid(mode):
    L, rcfg, gv, gv_model = _small_problem()
    ml = mode == "ml_only"
    hj = jexp.train_hybrid(L, rcfg, gv, None if ml else gv_model, seed=2,
                           region_block=7)
    ht = texp.train_hybrid(convert.region_layout(L),
                           convert.reservoir_config(rcfg),
                           to_cpu(gv),
                           None if ml else to_cpu(gv_model),
                           seed=2, region_block=7)
    assert ht.ml_only == hj.ml_only == ml
    assert dataclasses.asdict(ht.rcfg) == dataclasses.asdict(hj.rcfg)
    np.testing.assert_array_equal(ht.params.a_val.numpy(),
                                  np.asarray(hj.params.a_val))
    for f in hj.stz._fields:
        np.testing.assert_allclose(getattr(ht.stz, f).numpy(),
                                   np.asarray(getattr(hj.stz, f)), rtol=1e-6)
    wj = np.asarray(hj.params.wout)
    wt = ht.params.wout.numpy()
    assert wt.shape == wj.shape and np.isfinite(wt).all()
    rel = (np.linalg.norm((wt - wj).reshape(L.R, -1), axis=1)
           / np.linalg.norm(wj.reshape(L.R, -1), axis=1))
    assert rel.max() < 0.05, rel.max()

    # one step from synchronized reservoirs: the fits predict the same
    xj = hj.synchronize(gv[100:140])
    xt = ht.synchronize(to_cpu(gv[100:140]))
    mj = None if ml else jnp.asarray(gv_model[141])
    mt = None if ml else to_cpu(gv_model[141])
    out_j = hj.step(xj, jnp.asarray(gv[140]), mj)
    out_t = ht.step(xt, to_cpu(gv[140]), mt)
    for a, b in zip(out_j, out_t):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=5e-3 * np.ptp(a))


@pytest.mark.cuda
def test_drive_and_accumulate_through_kernel(driven):
    """On the card drive_and_accumulate folds ss through the CUDA kernel;
    the result matches the CPU run through the plain twin (rtol 1e-5 on
    hi+lo: f32 chunk sums in another order; the states are f32 elementwise
    ops, 1e-5 allows for the card's tanh)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from speedyml_torch.ops import accum

    _, _, acct = driven
    rng = np.random.default_rng(3)
    jp = jax_generate_esn(1, R=3, n_in=8, n_out=4, n_model=4, m_target=16,
                          deg=3)
    dev = torch.device("cuda")
    tp = convert.esn_params(jp, dev)
    T = 40
    u, y, m = (convert.tensor(rng.normal(size=(T, 3, k)).astype(np.float32),
                              dev) for k in (8, 4, 4))
    x = ttr.drive_discard(tp, torch.zeros((3, tp.n), device=dev), u[:6])
    acc = ttr.init_normal_eq(tp, 4)._replace(x=x)
    before = accum.accumulate_ss_scan.launches
    acc = ttr.drive_and_accumulate(tp, acc, u[6:], y[6:], m[6:], chunk=8)
    assert accum.accumulate_ss_scan.launches == before + 1
    np.testing.assert_allclose(_tot(acc.ss_hi.cpu(), acc.ss_lo.cpu()),
                               _tot(acct.ss_hi, acct.ss_lo), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(acc.x.cpu().numpy(), acct.x.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_segmented_fold_on_the_card(cuda_device, monkeypatch):
    """On the card the segmented drive folds through the kernel one segment
    at a time, with the launches and the result (bitwise) of one call over
    the whole series: at R=48, na=5896 a segment is the kernel's own 448
    steps, and 1000 pairs are 3 launches."""
    from speedyml_torch.ops import accum
    from speedyml_torch.reservoir.generate import generate_esn

    R, n_in, n_out, T = 48, 16, 136, 1000
    tp = generate_esn(1, R, n_in, n_out, n_out, m_target=5760, deg=3,
                      radii=np.full(R, 0.9), device=cuda_device)
    na = n_out + tp.n
    assert na == 5896 and accum.segment_steps(R, na) == 448
    assert ttr.fold_segment(R, na, 64, cuda_device) == 448
    g = torch.Generator(device=cuda_device).manual_seed(0)
    u, y, m = (torch.randn(T, R, k, device=cuda_device, generator=g)
               for k in (n_in, n_out, n_out))
    res = []
    for whole in (False, True):
        if whole:   # one segment over the whole series
            monkeypatch.setattr(ttr, "fold_segment", lambda *a: 960)
        acc = ttr.init_normal_eq(tp, n_out)
        before = accum.accumulate_ss_scan.launches
        res.append(ttr.drive_and_accumulate(tp, acc, u, y, m, chunk=64))
        assert accum.accumulate_ss_scan.launches == before + 3
        del acc
    for a, b in zip(*res):
        assert torch.equal(a, b)
