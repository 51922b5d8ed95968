"""scripts_torch/reference_scale.py end to end on the CPU (--cpu), on seeded
stand-in boundary files: data -> train -> coupled --ocean-train-only ->
coupled, then predict on what they wrote, each phase through the script's
own entry point, at the reference grid (1152 regions) and the smallest sizes
that still give the ocean its training weeks:

  --samples 14 --holdout 4 --spinup-days 0: 10 training samples, 4 held out;
  --m 60 --discard 6 --ml-only: n = 576 nodes (one per input), 1-step
  discard, the ML-only configuration (na = n: the f64 ridge systems of all
  1152 regions are what costs on the CPU, and the hybrid's are 712 wide;
  the smoke run on the card trains the hybrid and both readouts at
  reference width); --chunk 16 --region-block 192 (6 blocks);
  --slab-hours 12 --ocean-m 60 --ocean-block 0: 5 ocean weeks of 2 steps;
  --fc-steps 4 for predict and for the coupled run (two ocean weeks),
  streamed.

What is held: each phase's exit code and the files it promises; the cache's
keys, shapes and dtypes (the JAX data phase's); the model files read by the
JAX package's loader (speedyml.io.weights.load_model) equal to what the
port reads; one predict step (the per-step runner, --no-fast-loop) against
HybridRunner on the loaded model to 1e-6 of each field's scale; the coupled
run's forecast file read by both packages' readers; finite fields inside the
safety bounds.

The phases' files are made once per session (script_files) and shared with
the test modules of the other scripts (test_torch_demo, test_torch_diag).
"""

import contextlib
import fcntl
import functools
import importlib.util
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from speedyml.io.output import read_forecast as jread_forecast
from speedyml.io.weights import load_model as jload_model
from speedyml_torch.hybrid.state_io import SAFE_BOUNDS
from speedyml_torch.io.output import read_forecast
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N_SAMPLES, HOLDOUT, FC_STEPS, COUPLED_STEPS = 14, 4, 4, 4
STEP_TOL = 1e-6
# the ocean of the coupled phases: 12-hour weeks of 2 steps, n=60
OCEAN_ARGS = ["--slab-hours", "12", "--ocean-m", "60", "--ocean-block", "0"]


def load_script(name):
    path = os.path.join(REPO, "scripts_torch", name + ".py")
    spec = importlib.util.spec_from_file_location(f"_port_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_phases(d):
    """data -> train -> coupled --ocean-train-only -> coupled into `d`:
    the phases' exit codes and output, the files' paths, and the arguments
    every phase shares."""
    bindir = write_synthetic_boundary(str(d / "bc"), seed=8)
    rs = load_script("reference_scale")
    p = {k: str(d / v) for k, v in (
        ("cache", "cache.npz"), ("weights", "w.nc"), ("ml", "w_ml.nc"),
        ("coupled", "coupled.json"), ("out", "run.nc"))}
    common = ["--bindir", bindir, "--cache", p["cache"], "--cpu",
              "--holdout", str(HOLDOUT), "--m", "60", "--discard", "6",
              "--weights", p["weights"], "--ml-weights", p["ml"],
              "--ml-only"]
    phases = [
        ("data", ["data", "--samples", str(N_SAMPLES), "--spinup-days", "0",
                  "--enso-amp", "1.2"]),
        ("train", ["train", "--chunk", "16", "--region-block", "192"]),
        ("ocean", ["coupled", "--ocean-train-only", "--results",
                   p["coupled"]] + OCEAN_ARGS),
        ("coupled", ["coupled", "--fc-steps", str(COUPLED_STEPS), "--out",
                     p["out"], "--results", p["coupled"], "--stream"]
         + OCEAN_ARGS),
    ]
    out = {"paths": p, "rc": {}, "stdout": {}, "bindir": bindir,
           "common": common}
    for label, argv in phases:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out["rc"][label] = rs.main(argv + common)
        out["stdout"][label] = buf.getvalue()
    return out


@contextlib.contextmanager
def jax_speedy_on(bindir):
    """Inside this block the JAX scripts' `Speedy(ModelConfig(...))`, which
    builds on a fixed boundary directory, builds on `bindir` instead: the
    name `speedyml.model.Speedy` is patched for the block, and the JAX
    package is not otherwise touched."""
    import speedyml.model as jmodel
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "Speedy",
                   functools.partial(jmodel.Speedy, bindir=bindir))
        yield


def _decimals(x):
    text = repr(float(x))
    return 0 if "e" in text else len(text.split(".")[1])


def same_rounded(got, want):
    """The same JSON object, every number equal to one unit in the last
    decimal place either side shows: the scripts round their numbers, and
    two packages' floats may fall either side of a rounding boundary."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            same_rounded(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            same_rounded(a, b)
    elif isinstance(want, float):
        unit = 10.0 ** -max(_decimals(got), _decimals(want))
        assert abs(got - want) <= unit * (1 + 1e-9), (got, want)
    else:
        assert got == want


def script_files(tmp_path_factory):
    """The files reference_scale.py's phases write (the cache, the model
    file, the ocean's blocks and the coupled run's forecast file), made once
    per test session: the test modules that read them share one set. Under
    pytest-xdist the workers share the session's temporary root, one of
    them makes the files and the others wait on a lock. Returns
    _run_phases' record."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / "refscale_files"
    record = d / "phases.json"
    with open(str(root / "refscale_files.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not record.exists():
            shutil.rmtree(d, ignore_errors=True)   # an earlier failed try
            d.mkdir()
            record.write_text(json.dumps(_run_phases(d)))
        return json.loads(record.read_text())


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    out = script_files(tmp_path_factory)
    rs = load_script("reference_scale")
    results = str(tmp_path_factory.mktemp("predict") / "predict.json")
    out["paths"]["results"] = results
    # predict through the phase function that main() calls, which hands
    # back the trajectory
    args = rs.parse_args(["predict", "--fc-steps", str(FC_STEPS),
                          "--no-fast-loop", "--results", results]
                         + out["common"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["predict"] = rs.phase_predict(args, CPU)
    out["stdout"]["predict"] = buf.getvalue()
    return out


def test_phases_run(pipeline):
    assert pipeline["rc"] == {"data": 0, "train": 0, "ocean": 0,
                              "coupled": 0}
    s = pipeline["stdout"]
    assert "DATA PHASE OK" in s["data"] and "TRAIN PHASE OK" in s["train"]
    assert "PREDICT PHASE OK" in s["predict"]
    assert "OCEAN TRAIN OK" in s["ocean"]
    assert "COUPLED PHASE OK" in s["coupled"]
    ck = pipeline["paths"]["cache"]
    assert len(os.listdir(ck + ".ml_ckpt")) == 6
    assert len(os.listdir(ck + ".ocean_ckpt")) == 1


def test_cache_schema(pipeline):
    """The data phase's cache in the JAX script's keys, shapes and dtypes,
    its fields finite and inside the safety bounds."""
    z = np.load(pipeline["paths"]["cache"])
    n = N_SAMPLES
    want = {"atmo": ((n, 4, 8, 48, 96), np.float32),
            "m_atmo": ((n, 4, 8, 48, 96), np.float32),
            "logp": ((n, 48, 96), np.float32),
            "m_logp": ((n, 48, 96), np.float32),
            "precip": ((n, 48, 96), np.float32),
            "m_precip": ((n, 48, 96), np.float32),
            "sst": ((n, 48, 96), np.float64),
            "tisr": ((n, 48, 96), np.float64),
            "hours": ((n,), np.int64)}
    assert sorted(z.files) == sorted(want)
    for k, (shape, dtype) in want.items():
        assert z[k].shape == shape and z[k].dtype == dtype, k
        assert np.isfinite(z[k]).all(), k
    assert np.all(np.diff(z["hours"]) == 6)
    for i, name in enumerate(("t", "u", "v", "q")):
        lo, hi = SAFE_BOUNDS[name]
        assert lo <= z["atmo"][:, i].min() and z["atmo"][:, i].max() <= hi
    assert z["precip"].min() >= 0.0 and not z["m_precip"].any()


def test_model_file_read_by_jax(pipeline):
    """The weight file, read by the JAX package's loader, holds what the
    port reads from it; no second ML-only file from an ML-only run."""
    from speedyml_torch.io.weights import load_model
    path = pipeline["paths"]["weights"]
    jm, tm = jload_model(path), load_model(path, device="cpu")
    assert jm.ml_only and tm.ml_only
    assert jm.layout.R == tm.layout.R == 1152
    assert tm.params.wout.shape == (1152, 136, 576)
    for f in ("wout", "win", "a_val"):
        np.testing.assert_array_equal(np.asarray(getattr(jm.params, f)),
                                      getattr(tm.params, f).numpy(), f)
    assert jm.rcfg.nodes_per_input == tm.rcfg.nodes_per_input == 60
    assert not os.path.exists(pipeline["paths"]["ml"])


def test_predict_step_matches_runner(pipeline):
    """The predict phase's first step against HybridRunner on the model
    read back, from the same synchronized state and start."""
    p = pipeline["paths"]
    want = _runner_step(p, pipeline["bindir"])
    got = pipeline["predict"]["run"]
    assert not got["aborted"] and got["atmo"].shape == (FC_STEPS, 4, 8, 48,
                                                        96)
    w = want["atmo"][0].numpy()
    for i in range(4):
        scale = np.abs(w[i]).max()
        np.testing.assert_allclose(got["atmo"][0, i], w[i], rtol=0,
                                   atol=STEP_TOL * scale)
    res = pipeline["predict"]["results"]
    with open(p["results"]) as f:
        assert json.load(f) == res
    n_train = N_SAMPLES - HOLDOUT
    assert res["n_train"] == n_train and res["n_fc"] == FC_STEPS
    assert res["regions"] == 1152 and res["ml_only"]
    assert sorted(res["leads"]) == ["24h", "6h"]


def _runner_step(p, bindir):
    """One HybridRunner step of the written model from the predict phase's
    start."""
    from speedyml_torch import ModelConfig
    from speedyml_torch.core.calendar import ModelDate, datetime_from_hours
    from speedyml_torch.hybrid.experiment import (HybridRunner,
                                                  transform_and_pack)
    from speedyml_torch.hybrid.forecast import SpeedyForecaster
    from speedyml_torch.io.weights import load_model
    from speedyml_torch.model import Speedy
    sp = Speedy(ModelConfig(dtype="float32"), bindir, device="cpu")
    hm = load_model(p["weights"], np.degrees(np.asarray(
        sp.dy.tables.radang)), device="cpu")
    z = np.load(p["cache"])
    L = hm.layout
    gv = transform_and_pack(L, *(torch.as_tensor(z[k]) for k in (
        "atmo", "logp", "precip", "sst", "tisr")), hm.rcfg.precip_epsilon)
    n_train = N_SAMPLES - HOLDOUT
    n_sync = hm.rcfg.synclength // hm.rcfg.timestep
    x = hm.synchronize(gv[n_train - n_sync:n_train])
    s = L.gv_sizes
    last = gv[n_train - 1]
    date = ModelDate(*datetime_from_hours(int(z["hours"][n_train - 1])))
    return HybridRunner(hm, SpeedyForecaster(sp, hours=6)).run(
        x, last[s["atmo3d"][0]:s["atmo3d"][1]].reshape(4, 8, 48, 96),
        last[s["logp"][0]:s["logp"][1]].reshape(48, 96),
        last[s["precip"][0]:s["precip"][1]].reshape(48, 96), date, 1)


def test_coupled_run(pipeline):
    """The streamed coupled run: its results, its forecast file (read by
    both packages), its checkpoint."""
    p = pipeline["paths"]
    with open(p["coupled"]) as f:
        res = json.load(f)
    assert res["steps"] == COUPLED_STEPS and not res["aborted"]
    assert res["loop"] == "fast" and res["streamed"]
    lo, hi = SAFE_BOUNDS["t"]
    assert lo <= res["T_range"][0] <= res["T_range"][1] <= hi
    assert all(np.isfinite(v) for v in res["sst_range"])
    for reader in (read_forecast, jread_forecast):
        fc = reader(p["out"])
        assert fc["Temperature"].shape == (COUPLED_STEPS, 8, 48, 96)
        assert fc["SST"].shape == (COUPLED_STEPS, 48, 96)
        for k in ("Temperature", "U-wind", "logp", "SST", "p6hr"):
            assert np.isfinite(fc[k]).all(), k
        np.testing.assert_allclose(fc["Temperature"].min(), res["T_range"][0],
                                   rtol=1e-6)
