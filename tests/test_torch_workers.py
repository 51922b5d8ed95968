"""The reference-worker weight files (speedyml_torch/io/weights.py
ell_to_coo, coo_to_ell, export_worker_files, import_worker_files) and
scripts_torch/export_workers.py, held against the JAX package on the CPU.

The model is the small trained one of tests/test_io.py (18 regions of 576
nodes, a hybrid readout), trained by the JAX package and carried into the
port with convert.hybrid_model. What is held:
  * ell_to_coo and coo_to_ell: exact copies (array_equal, dtypes too);
  * the worker_*.nc files and the controller file the two packages write
    from the same model: byte-identical;
  * each package's import_worker_files reads the other's files: a_idx
    exactly, win, wout and the standardizer to float32 (exactly: both
    narrow the same f8 values), a_shift recovered;
  * a regions= subset: the same rows as the whole set;
  * synchronize + 3 steps of the imported port model against the original
    port model, to 1e-6 of each field's scale;
  * a bf16 readout is written widened to f32 exactly;
  * both packages' export_workers.py on one model file: the same files
    (byte for byte) and the same results JSON but for the seconds.
"""

import json
import os

import numpy as np
import pytest
import torch

from speedyml.io import weights as jw
from speedyml_torch import convert
from speedyml_torch.io import weights as tw

from tests.test_io import _trained_model
from tests.test_torch_analysis import run_jax_script, run_port_script

torch.set_num_threads(1)

CPU = torch.device("cpu")
STEP_TOL = 1e-6
TRIAL = "t1"


@pytest.fixture(scope="module")
def models():
    hm_j, gv = _trained_model(ml_only=False, seed=13)
    return hm_j, convert.hybrid_model(hm_j, CPU), np.asarray(gv)


@pytest.fixture(scope="module")
def exported(models, tmp_path_factory):
    hm_j, hm_t, _ = models
    d = tmp_path_factory.mktemp("workers")
    jdir, tdir = str(d / "jax"), str(d / "torch")
    jw.export_worker_files(jdir, hm_j, trial_name=TRIAL)
    tw.export_worker_files(tdir, hm_t, trial_name=TRIAL)
    return jdir, tdir


def _files(d):
    return sorted(os.listdir(d))


def test_coo_copies_exact(models):
    rng = np.random.default_rng(0)
    n, deg = 16, 3
    a_idx = rng.integers(0, n, (n, deg)).astype(np.int32)
    a_val = rng.uniform(0.1, 1.0, (n, deg)).astype(np.float32)
    a_val[2, 1] = 0.0                       # a padding entry is dropped
    hm_j = models[0]
    cases = [(a_idx, a_val),
             (np.asarray(hm_j.params.a_idx)[3], np.asarray(
                 hm_j.params.a_val)[3])]
    for idx, val in cases:
        want, got = jw.ell_to_coo(idx, val), tw.ell_to_coo(idx, val)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(w, g)
        for deg_arg in (None, idx.shape[1], idx.shape[1] + 2):
            want2 = jw.coo_to_ell(*want, idx.shape[0], deg_arg)
            got2 = tw.coo_to_ell(*got, idx.shape[0], deg_arg)
            for w, g in zip(want2, got2):
                assert w.dtype == g.dtype
                np.testing.assert_array_equal(w, g)


def test_files_byte_identical(models, exported):
    hm_j = models[0]
    jdir, tdir = exported
    names = _files(jdir)
    assert names == _files(tdir)
    assert len(names) == hm_j.layout.R + 1
    assert f"{TRIAL}_controller_file.txt" in names
    for name in names:
        with open(os.path.join(jdir, name), "rb") as f:
            want = f.read()
        with open(os.path.join(tdir, name), "rb") as f:
            assert f.read() == want, name


def _assert_models_equal(a, b):
    """Two imported models (either package): a_idx exactly, the float32
    weights and standardizer exactly, the circulant shifts recovered."""
    pa, pb = a.params, b.params
    np.testing.assert_array_equal(np.asarray(pa.a_idx), np.asarray(pb.a_idx))
    for f in ("a_val", "win", "wout"):
        x, y = np.asarray(getattr(pa, f)), np.asarray(getattr(pb, f))
        assert x.dtype == y.dtype == np.float32, f
        np.testing.assert_array_equal(x, y, f)
    for f in ("in_mean", "in_std", "out_mean", "out_std"):
        np.testing.assert_array_equal(np.asarray(getattr(a.stz, f)),
                                      np.asarray(getattr(b.stz, f)), f)
    assert pa.a_shift is not None and pb.a_shift is not None
    np.testing.assert_array_equal(np.asarray(pa.a_shift),
                                  np.asarray(pb.a_shift))


def test_each_reads_the_other(models, exported):
    hm_j, hm_t, _ = models
    jdir, tdir = exported
    L, rcfg = hm_j.layout, hm_j.rcfg
    tL, trcfg = hm_t.layout, hm_t.rcfg
    j_of_t = jw.import_worker_files(tdir, L, rcfg, trial_name=TRIAL)
    t_of_j = tw.import_worker_files(jdir, tL, trcfg, trial_name=TRIAL,
                                    device=CPU)
    j_of_j = jw.import_worker_files(jdir, L, rcfg, trial_name=TRIAL)
    _assert_models_equal(j_of_t, j_of_j)
    _assert_models_equal(t_of_j, j_of_j)
    assert t_of_j.params.a_idx.dtype == torch.int64
    assert t_of_j.params.wout.device == CPU
    # the round trip returns the model's own weights
    np.testing.assert_array_equal(t_of_j.params.a_idx.numpy(),
                                  hm_t.params.a_idx.numpy())
    for f in ("win", "wout"):
        np.testing.assert_array_equal(getattr(t_of_j.params, f).numpy(),
                                      getattr(hm_t.params, f).numpy())


def test_region_subset(models, exported):
    hm_t = models[1]
    tdir = exported[1]
    regions = [0, 5, 11]
    full = tw.import_worker_files(tdir, hm_t.layout, hm_t.rcfg,
                                  trial_name=TRIAL, device=CPU)
    part = tw.import_worker_files(tdir, hm_t.layout, hm_t.rcfg,
                                  trial_name=TRIAL, regions=regions,
                                  device=CPU)
    for f in ("a_idx", "a_val", "win", "wout"):
        np.testing.assert_array_equal(getattr(part.params, f).numpy(),
                                      getattr(full.params, f)[regions]
                                      .numpy(), f)
    for f in ("in_mean", "in_std", "out_mean", "out_std"):
        np.testing.assert_array_equal(getattr(part.stz, f).numpy(),
                                      getattr(full.stz, f)[regions].numpy())


def test_imported_model_steps_as_the_original(models, exported):
    _, hm_t, gv = models
    imp = tw.import_worker_files(exported[1], hm_t.layout, hm_t.rcfg,
                                 trial_name=TRIAL, device=CPU)
    gv = torch.as_tensor(gv)
    xa, xb = hm_t.synchronize(gv[:50]), imp.synchronize(gv[:50])
    np.testing.assert_allclose(xb.numpy(), xa.numpy(), rtol=0,
                               atol=STEP_TOL * float(xa.abs().max()))
    for k in range(3):
        xa, *outa = hm_t.step(xa, gv[50 + k], gv[51 + k] + 0.1)
        xb, *outb = imp.step(xb, gv[50 + k], gv[51 + k] + 0.1)
        for a, b in zip([xa] + outa, [xb] + outb):
            scale = float(a.abs().max())
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=STEP_TOL * scale)


def test_bf16_readout_written_as_f32(models, tmp_path):
    import dataclasses
    hm_t = models[1]
    p16 = dataclasses.replace(hm_t.params,
                              wout=hm_t.params.wout.to(torch.bfloat16))
    hm16 = dataclasses.replace(hm_t, params=p16)
    d = str(tmp_path / "bf16")
    tw.export_worker_files(d, hm16, trial_name=TRIAL)
    imp = tw.import_worker_files(d, hm_t.layout, hm_t.rcfg,
                                 trial_name=TRIAL, device=CPU)
    np.testing.assert_array_equal(imp.params.wout.numpy(),
                                  p16.wout.to(torch.float32).numpy())


def test_export_workers_scripts(models, tmp_path):
    """Both packages' export_workers.py on one model file: the same files,
    and the same results JSON but for the seconds."""
    hm_j = models[0]
    model = str(tmp_path / "model.nc")
    jw.save_model(model, hm_j)
    res = {}
    for pkg, run, more in (("scripts", run_jax_script, []),
                           ("scripts_torch", run_port_script, ["--cpu"])):
        out, results = str(tmp_path / pkg), str(tmp_path / f"{pkg}.json")
        rc, text = run("export_workers", [
            "--weights", model, "--out", out, "--trial", "tr",
            "--keep-samples", "3", "--results", results] + more)
        assert rc == 0 and "EXPORT OK" in text
        with open(results) as f:
            res[pkg] = json.load(f)
        assert json.loads(text.splitlines()[-2]) == res[pkg]
    names = _files(str(tmp_path / "scripts"))
    assert names == _files(str(tmp_path / "scripts_torch"))
    assert len(names) == 3 + 1                     # kept samples, controller
    for name in names:
        with open(str(tmp_path / "scripts" / name), "rb") as f:
            want = f.read()
        with open(str(tmp_path / "scripts_torch" / name), "rb") as f:
            assert f.read() == want, name
    for r in res.values():
        for k in ("export_s", "import_sample_s"):
            r.pop(k)
    assert res["scripts"] == res["scripts_torch"]
    assert res["scripts"]["files"] == hm_j.layout.R
