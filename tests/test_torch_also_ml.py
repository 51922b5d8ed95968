"""train_hybrid(also_ml=True), ml_variant and the block checkpoints of
speedyml_torch against speedyml, on the small layout and synthetic truth of
tests/test_also_ml.py.

Tolerances:
  * port against JAX (no training noise: the two packages draw it from
    different generators): readouts, hybrid and ML-only, within 5% relative
    Frobenius distance per region, and one ML-only step within 0.5% of each
    field's range, as tests/test_torch_training.py states for train_hybrid
    (float32 normal equations summed in another order, amplified by the
    ill-conditioned solve in the readout's poorly determined directions);
  * the inline ML-only readout against a separate ML-only pass of the port
    (the same reservoirs and noise): 2e-2 of the readout's scale, one step
    1e-3, as tests/test_also_ml.py holds the JAX package;
  * a resume, and a directory the other package wrote: bitwise.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.hybrid import experiment as jexp
from speedyml_torch import convert
from speedyml_torch.hybrid import experiment as texp
from tests.test_hybrid import _small_layout, _small_rcfg, _synthetic_truth

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

CPU = "cpu"
# 18 regions in blocks of one shape, so that the JAX drive compiles once:
# 3 blocks of 6 for the runs of both packages, 6 of 3 for the resume
BLOCK = 6
RESUME_BLOCK = 3


def to_cpu(a):
    return convert.tensor(a, CPU)


@pytest.fixture(scope="module")
def problem():
    L = _small_layout()
    rcfg = _small_rcfg(noise_std=0.0)
    atmo, logp, precip, sst, tisr = _synthetic_truth(L, 400)
    gv = jexp.transform_and_pack(L, atmo, logp, precip, sst, tisr,
                                 rcfg.precip_epsilon)
    rng = np.random.default_rng(3)
    gv_model = (gv + 0.3 * np.sin(gv)
                + 0.05 * rng.normal(size=gv.shape)).astype(np.float32)
    return L, rcfg, gv, gv_model


def train_port(problem, gv_model="hybrid", **kw):
    L, rcfg, gv, gm = problem
    kw.setdefault("seed", 2)
    kw.setdefault("region_block", BLOCK)
    return texp.train_hybrid(
        convert.region_layout(L), convert.reservoir_config(kw.pop("rcfg",
                                                                  rcfg)),
        to_cpu(gv), None if gv_model is None else to_cpu(gm), **kw)


@pytest.fixture(scope="module")
def jax_trained(problem, tmp_path_factory):
    """The JAX also_ml run, writing its block directory."""
    L, rcfg, gv, gm = problem
    ck = str(tmp_path_factory.mktemp("jax_blocks"))
    hj = jexp.train_hybrid(L, rcfg, gv, gm, seed=2, region_block=BLOCK,
                           also_ml=True, checkpoint_dir=ck)
    return hj, ck


@pytest.fixture(scope="module")
def port_trained(problem, tmp_path_factory):
    """The port's also_ml run, writing its block directory."""
    ck = str(tmp_path_factory.mktemp("port_blocks"))
    return train_port(problem, also_ml=True, checkpoint_dir=ck), ck


def rel_frobenius(got, want):
    R = want.shape[0]
    return (np.linalg.norm((got - want).reshape(R, -1), axis=1)
            / np.linalg.norm(want.reshape(R, -1), axis=1))


def test_also_ml_against_jax(problem, jax_trained, port_trained):
    L, rcfg, gv, _ = problem
    hj, _ = jax_trained
    ht, _ = port_trained
    for name, wt, wj in (("wout", ht.params.wout, hj.host_np["wout"]),
                         ("wout_ml", ht.wout_ml, hj.host_np["wout_ml"])):
        wt = wt.numpy()
        assert wt.shape == wj.shape and np.isfinite(wt).all(), name
        assert rel_frobenius(wt, wj).max() < 0.05, name

    mj, mt = jexp.ml_variant(hj), texp.ml_variant(ht)
    assert mt.ml_only and not ht.ml_only
    assert mt.params.n_model == 0 and mt.params.wout is ht.wout_ml
    assert mt.params.win is ht.params.win and mt.stz is ht.stz
    out_j = mj.step(mj.synchronize(gv[100:140]), jnp.asarray(gv[140]))
    out_t = mt.step(mt.synchronize(to_cpu(gv[100:140])), to_cpu(gv[140]))
    for a, b in zip(out_j, out_t):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=5e-3 * np.ptp(a))


def test_inline_ml_matches_separate_pass(problem):
    """With training noise on: the port's inline ML readout against a
    separate ML-only pass of the port with the same seed."""
    rcfg = _small_rcfg(noise_std=0.05)
    both = train_port(problem, also_ml=True, rcfg=rcfg)
    sep = train_port(problem, gv_model=None, rcfg=rcfg)
    assert sep.ml_only and sep.wout_ml is None
    w_in, w_sep = both.wout_ml.numpy(), sep.params.wout.numpy()
    assert w_in.shape == w_sep.shape
    scale = np.abs(w_sep).max()
    np.testing.assert_allclose(w_in, w_sep, rtol=0, atol=2e-2 * scale)
    gv = to_cpu(problem[2])
    ml = texp.ml_variant(both)
    _, a1, _, _ = ml.step(ml.synchronize(gv[:60]), gv[60])
    _, a2, _, _ = sep.step(sep.synchronize(gv[:60]), gv[60])
    np.testing.assert_allclose(a1.numpy(), a2.numpy(), rtol=0, atol=1e-3)


def _weights(hm):
    p = hm.params
    return dict(wout=p.wout, wout_ml=hm.wout_ml, win=p.win, a_idx=p.a_idx,
                a_val=p.a_val)


def test_resume_is_bitwise(problem, tmp_path):
    """Delete the last two block files and the ML readout of the last one
    left: the resumed run trains those three blocks again, reads the other
    three, and gives the uninterrupted run's model bitwise."""
    ck, res_dir = str(tmp_path / "full"), str(tmp_path / "resumed")
    ht = train_port(problem, also_ml=True, checkpoint_dir=ck,
                    region_block=RESUME_BLOCK)
    os.makedirs(res_dir)
    names = sorted(os.listdir(ck))
    assert names == [f"block_{i:04d}.npz" for i in range(6)]
    for name in names[:-2]:
        with np.load(os.path.join(ck, name)) as z:
            keep = {k: z[k] for k in z.files
                    if not (name == names[-3] and k == "wout_ml")}
        np.savez(os.path.join(res_dir, name), **keep)
    hr = train_port(problem, also_ml=True, checkpoint_dir=res_dir,
                    region_block=RESUME_BLOCK)
    assert sorted(os.listdir(res_dir)) == names
    with np.load(os.path.join(res_dir, names[-3])) as z:
        assert "wout_ml" in z.files
    for k, v in _weights(ht).items():
        assert torch.equal(_weights(hr)[k], v), k
    assert hr.params.a_shift == ht.params.a_shift is not None
    # a run without also_ml takes every block from the directory
    ho = train_port(problem, checkpoint_dir=res_dir,
                    region_block=RESUME_BLOCK)
    assert ho.wout_ml is None and torch.equal(ho.params.wout, ht.params.wout)


def test_block_directories_cross_packages(problem, jax_trained,
                                          port_trained):
    """A complete block directory of either package, read by the other,
    gives that package's weights exactly: no block is trained again."""
    L, rcfg, gv, gm = problem
    hj, ck_j = jax_trained
    ht, ck_t = port_trained
    hp = train_port(problem, also_ml=True, checkpoint_dir=ck_j)
    for k in ("wout", "wout_ml", "win", "a_idx", "a_val"):
        np.testing.assert_array_equal(_weights(hp)[k].numpy(),
                                      hj.host_np[k], err_msg=k)
    assert hp.params.a_shift == tuple(int(s) for s in hj.params.a_shift)

    hj2 = jexp.train_hybrid(L, rcfg, gv, gm, seed=2, region_block=BLOCK,
                            also_ml=True, checkpoint_dir=ck_t)
    for k, v in _weights(ht).items():
        np.testing.assert_array_equal(hj2.host_np[k], v.numpy(), err_msg=k)


def test_also_ml_needs_the_model_series(problem):
    with pytest.raises(ValueError, match="also_ml"):
        train_port(problem, gv_model=None, also_ml=True)
    with pytest.raises(ValueError, match="also_ml"):
        texp.ml_variant(train_port(problem, gv_model=None))
