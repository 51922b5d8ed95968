"""scripts_torch/demo_hybrid.py and scripts_torch/diag_wetbias.py on the
CPU (--cpu), on the files of reference_scale.py's phases (the session's
shared set, tests/test_torch_scripts.py: a 14-sample cache in the JAX data
phase's keys, which are the demo's cache keys, and a 4-step coupled run).

The port's demo is held to its own contract, not against the JAX demo: on
these 14 samples the JAX demo cannot train its slab ocean (its 168-hour
week is fixed in the script), and without the ocean it would train a
second 1152-region hybrid and compile the JAX full-physics window, minutes
on the CPU. The port's demo runs at its own width (1152 regions of 576
nodes, the hybrid readout 712 wide), with --ocean, --out, --grads and
--components, and the ML-only branch left out (--skip-ml-only; on the CPU
its second 1152-region training would double the test's cost; the smoke
run on the card drives it). Its slab ocean steps every 168 hours, and the
14 samples hold no such week: the test gives it 12-hour weeks (two steps),
as the shared coupled run has, through the script's OCEAN test seam, so
that the ocean trains on 7 weeks and steps once in --fc-steps 2. What is
held: exit 0 and "DEMO OK"; the forecast file read equal by both packages'
read_forecast, finite and inside the safety bounds; the GrADS file read
back equal to it; atmo = atmo_ml + atmo_p across the two component files to
1e-5 of each field's scale (q after the floor both apply).

diag_wetbias on the coupled run and the demo's forecast file: exit 0, a
JSON with the keys of results/wetbias_diag.json and finite numbers, and the
JAX script's JSON on the same files (its Speedy built on the same stand-in
boundary files) to one unit of each number's rounding.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from speedyml.io.output import read_forecast as jread_forecast
from speedyml_torch.hybrid.experiment import QMIN
from speedyml_torch.hybrid.state_io import SAFE_BOUNDS
from speedyml_torch.io.grads import read_grads
from speedyml_torch.io.output import read_forecast

from tests.test_torch_analysis import run_jax_script
from tests.test_torch_scripts import (jax_speedy_on, load_script,
                                      same_rounded, script_files)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FC_STEPS = 2
COMPONENT_TOL = 1e-5
VARS = ("Temperature", "U-wind", "V-wind", "Specific-Humidity")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return script_files(tmp_path_factory)


@pytest.fixture(scope="module")
def demo(files, tmp_path_factory):
    d = tmp_path_factory.mktemp("demo")
    mod = load_script("demo_hybrid")
    # 12-hour ocean weeks: see the module docstring
    mod.OCEAN = dict(mod.OCEAN, timestep_slab=12)
    p = {"out": str(d / "demo.nc"), "grads": str(d / "demo"),
         "components": str(d / "comp")}
    argv = ["--bindir", files["bindir"], "--cpu", "--cache",
            files["paths"]["cache"], "--ocean", "--fc-steps", str(FC_STEPS),
            "--skip-ml-only", "--out", p["out"], "--grads", p["grads"],
            "--components", p["components"]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return {"rc": rc, "stdout": buf.getvalue(), "paths": p}


def test_demo_runs(demo):
    assert demo["rc"] == 0
    out = demo["stdout"]
    assert out.rstrip().endswith("DEMO OK")
    assert "cache loaded: (14, 4, 8, 48, 96)" in out
    assert "slab-ocean trained" in out and "SST forecast range" in out


def test_demo_forecast_file(demo):
    path = demo["paths"]["out"]
    fc, jfc = read_forecast(path), jread_forecast(path)
    assert sorted(fc) == sorted(jfc)
    for k in fc:
        np.testing.assert_array_equal(fc[k], jfc[k], k)
    assert fc["Temperature"].shape == (FC_STEPS, 8, 48, 96)
    for k, b in zip(VARS + ("logp",), ("t", "u", "v", "q", "logp")):
        assert np.isfinite(fc[k]).all(), k
        if b in SAFE_BOUNDS:
            lo, hi = SAFE_BOUNDS[b]
            assert lo <= fc[k].min() and fc[k].max() <= hi, k
    for k in ("SST", "p6hr"):
        assert fc[k].shape == (FC_STEPS, 48, 96) and np.isfinite(fc[k]).all()
    assert fc["p6hr"].min() >= 0.0


def test_demo_grads_file(demo):
    fc = read_forecast(demo["paths"]["out"])
    a3, a2 = read_grads(demo["paths"]["grads"], 8, 48, 96)
    assert a3.shape == (FC_STEPS, 4, 8, 48, 96)
    for v, k in enumerate(VARS):
        np.testing.assert_array_equal(a3[:, v], fc[k], k)
    np.testing.assert_array_equal(a2[:, 0], fc["logp"])
    assert os.path.exists(demo["paths"]["grads"] + ".ctl")


def test_demo_components_sum(demo):
    """The ML increment and the SPEEDY part add up to the forecast."""
    fc = read_forecast(demo["paths"]["out"])
    ml = read_forecast(demo["paths"]["components"] + "_ml.nc")
    sp = read_forecast(demo["paths"]["components"] + "_p.nc")
    assert "p6hr" not in ml and "p6hr" not in sp
    for k in VARS + ("logp",):
        total = ml[k].astype(np.float64) + sp[k]
        if k == "Specific-Humidity":
            total = np.maximum(total, QMIN)
        scale = np.abs(fc[k]).max()
        np.testing.assert_allclose(total, fc[k], rtol=0,
                                   atol=COMPONENT_TOL * scale, err_msg=k)
        assert np.abs(ml[k]).max() > 0.0, k


def _finite_numbers(obj):
    """Every number in a JSON object."""
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in _finite_numbers(v)]
    if isinstance(obj, list):
        return [x for v in obj for x in _finite_numbers(v)]
    return [obj] if isinstance(obj, (int, float)) else []


def _wetbias_argv(files, demo, out):
    return ["--coupled", files["paths"]["out"], "--hybrid",
            demo["paths"]["out"], "--cache", files["paths"]["cache"],
            "--holdout", "4", "--skip-days", "0", "--out", out]


@pytest.fixture(scope="module")
def wetbias(files, demo, tmp_path_factory):
    """diag_wetbias.py of the port on the coupled run and the demo's
    forecast file."""
    out = str(tmp_path_factory.mktemp("wetbias") / "wetbias.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = load_script("diag_wetbias").main(
            ["--bindir", files["bindir"], "--cpu"]
            + _wetbias_argv(files, demo, out))
    with open(out) as f:
        res = json.load(f)
    return {"rc": rc, "stdout": buf.getvalue(), "json": res}


def test_diag_wetbias(wetbias):
    assert wetbias["rc"] == 0
    res = wetbias["json"]
    assert json.loads(wetbias["stdout"]) == res
    with open(os.path.join(REPO, "results", "wetbias_diag.json")) as f:
        ref = json.load(f)

    def keys(o):
        return {k: keys(v) for k, v in o.items()} \
            if isinstance(o, dict) else None

    assert keys(res) == keys(ref)
    nums = _finite_numbers(res)
    assert nums and np.isfinite(nums).all()
    assert res["windows"]["matched_steps"] == FC_STEPS


def test_diag_wetbias_against_jax(files, demo, wetbias, tmp_path):
    """The JAX script on the same files, its Speedy on the same boundary
    files: the same JSON, every number within one unit of its rounding."""
    out = str(tmp_path / "wetbias.json")
    with jax_speedy_on(files["bindir"]):
        rc, _ = run_jax_script("diag_wetbias",
                               _wetbias_argv(files, demo, out))
    assert rc == 0
    with open(out) as f:
        want = json.load(f)
    same_rounded(wetbias["json"], want)
