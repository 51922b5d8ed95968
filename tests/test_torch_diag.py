"""The port's diagnostic scripts and the precip-debias chain on the CPU
(--cpu), on the files of reference_scale.py's phases (the session's shared
set, tests/test_torch_scripts.py: a 14-sample cache, an ML-only model file
of 1152 regions at n=576, the ocean's blocks and a 4-step coupled run), and
scripts_torch/pipeline.sh.

  * diag_precip_bias.py: its log-residual mean and std against a loop of
    HybridModel.step calls on the same model and series, to 1e-6 of each
    field's scale; the JSON has the keys of results/precip_bias.json; and
    against the JAX script on the same files (its Speedy built on the same
    stand-in boundary files): the npz's fields to 1e-6 of each field's
    scale, its latitudes exactly, the JSON to one unit of each number's
    rounding;
  * make_precip_debias.py, the port's and the JAX package's on the same run
    file and cache, --validate on the same file: the debias field exactly
    equal, the printed JSON equal; then reference_scale.py coupled
    --precip-debias reads the field: the run is the shared coupled run but
    for the written precip (every other field bitwise), which is the debias
    applied to it;
  * coupled_probe.py and coupled_probe2.py, with the working directory a
    temporary data/ tree over the shared files: exit 0, every run finite
    and unaborted. Their fixed lengths (32 per-step steps, a 124-sample
    holdout) and the JAX probe's ocean (500 nodes, 168-hour weeks, blocks
    of 64) are set by the test, through the scripts' test seams, to what
    these files hold: 4 steps, a 4-sample holdout, and the shared run's
    ocean (60 nodes, 12-hour weeks, one block), whose trained blocks both
    probes then read; coupled_probe's chunked runs take their three ocean
    weeks, here 6 steps in chunks of 2. Neither is held against the JAX
    probe: that ocean cannot train on 14 samples, and the JAX probes
    compile the chunked and per-step full-physics loops, minutes on the
    CPU;
  * diag_hybrid.py at 26 samples (the fewest that leave its 16 test steps
    and its 10-step synchronization): the three trainings finish and every
    printed error is finite. Its 5-day spin-up is cut to none (the test
    patches TrajectoryRunner.initialize). At the script's width its three
    1152-region hybrid trainings (712 wide) take ~50 s each on one CPU
    thread, so the test trains them on a narrower layout (no overlap: 144
    inputs a region, n=144, 280 wide) through the script's RESERVOIR test
    seam and a patched build_layout;
  * pipeline.sh: `bash -n`; the same phases as scripts/r5_pipeline.sh in
    the same order with the same arguments, --bindir added where the port
    script builds a model; every script it names is a port script and
    every flag it passes is one of that script's arguments.
"""

import contextlib
import functools
import io
import json
import os
import re
import shlex
import shutil
import subprocess

import numpy as np
import pytest
import torch

from speedyml_torch.core.config import ReservoirConfig
from speedyml_torch.domain import decomposition
from speedyml_torch.hybrid.forecast import TrajectoryRunner
from speedyml_torch.io.output import read_forecast

from tests.test_torch_analysis import run_jax_script
from tests.test_torch_scripts import (COUPLED_STEPS, HOLDOUT, N_SAMPLES,
                                      OCEAN_ARGS, jax_speedy_on, load_script,
                                      same_rounded, script_files)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
RESID_TOL = 1e-6
SYNC = 8
PROBE_STEPS = 4
DIAG_HYBRID_SAMPLES = 26


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return script_files(tmp_path_factory)


def run_port(name, argv, cwd=None):
    """A port script's main(argv), in `cwd` if given: (exit code, stdout)."""
    mod = load_script(name)
    buf = io.StringIO()
    here = os.getcwd()
    try:
        if cwd:
            os.chdir(cwd)
        with contextlib.redirect_stdout(buf):
            rc = mod.main(list(argv))
    finally:
        os.chdir(here)
    return rc, buf.getvalue()


def run_jax(name, argv, bindir, cwd):
    """A JAX script's main() in `cwd`, its Speedy built on `bindir`:
    (exit code, stdout)."""
    here = os.getcwd()
    try:
        os.chdir(cwd)
        with jax_speedy_on(bindir):
            return run_jax_script(name, argv)
    finally:
        os.chdir(here)


def _json_printed(text):
    return json.loads(text[text.index("{"):text.rindex("}") + 1])


def _precip_bias_argv(files, d):
    p = files["paths"]
    return ["--cache", p["cache"], "--weights", p["weights"], "--n",
            str(N_SAMPLES), "--holdout", str(HOLDOUT), "--sync", str(SYNC),
            "--out", str(d / "pb.json")]


@pytest.fixture(scope="module")
def precip_bias(files, tmp_path_factory):
    """diag_precip_bias.py run in a working directory of its own."""
    d = tmp_path_factory.mktemp("precip_bias")
    (d / "data").mkdir()
    rc, out = run_port("diag_precip_bias", [
        "--bindir", files["bindir"], "--cpu"] + _precip_bias_argv(files, d),
        cwd=str(d))
    return {"rc": rc, "stdout": out, "dir": d}


def test_diag_precip_bias(files, precip_bias):
    from speedyml_torch.hybrid.experiment import transform_and_pack
    from speedyml_torch.io.weights import load_model
    assert precip_bias["rc"] == 0
    assert "PRECIP BIAS DIAG OK" in precip_bias["stdout"]
    d = precip_bias["dir"]
    with open(d / "pb.json") as f:
        res = json.load(f)
    with open(os.path.join(REPO, "results", "precip_bias.json")) as f:
        ref = json.load(f)
    assert sorted(res) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            assert sorted(res[k]) == sorted(v), k
    assert res["n_eval"] == N_SAMPLES - SYNC - 1
    z = np.load(d / "data" / "precip_bias.npz")
    assert sorted(z.files) == ["lat", "log_resid_mean", "log_resid_std"]

    # the same residuals from HybridModel.step, one step at a time
    p = files["paths"]
    hm = load_model(p["weights"], device=CPU)
    c = np.load(p["cache"])
    L, eps = hm.layout, hm.rcfg.precip_epsilon

    def pack(prefix):
        return transform_and_pack(L, *(torch.as_tensor(c[k]) for k in (
            prefix + "atmo", prefix + "logp", prefix + "precip", "sst",
            "tisr")), eps)

    gv_t, gv_m = pack(""), pack("m_")
    p0, p1 = L.gv_sizes["precip"]
    x = hm.synchronize(gv_t[:SYNC])
    resid = []
    for t in range(SYNC, N_SAMPLES - 1):
        x, _, _, pr_t = hm.step(x, gv_t[t], gv_m[t + 1])
        resid.append((pr_t - gv_t[t + 1, p0:p1].reshape(L.il, L.ix))
                     .numpy())
    resid = np.stack(resid)
    for key, want in (("log_resid_mean", resid.mean(axis=0)),
                      ("log_resid_std", resid.std(axis=0))):
        np.testing.assert_allclose(z[key], want, rtol=0,
                                   atol=RESID_TOL * np.abs(want).max(),
                                   err_msg=key)
    assert np.abs(z["log_resid_std"]).max() > 0.0


def test_diag_precip_bias_against_jax(files, precip_bias, tmp_path):
    """The JAX script on the same model file, cache and boundary files:
    the npz's residual fields within RESID_TOL of each field's scale
    (both packages step the readout in float32), its latitudes
    exactly, and the JSON's numbers within one unit of their rounding."""
    (tmp_path / "data").mkdir()
    rc, _ = run_jax("diag_precip_bias", _precip_bias_argv(files, tmp_path),
                    files["bindir"], str(tmp_path))
    assert rc == 0 and precip_bias["rc"] == 0
    zj = np.load(tmp_path / "data" / "precip_bias.npz")
    zt = np.load(precip_bias["dir"] / "data" / "precip_bias.npz")
    assert sorted(zt.files) == sorted(zj.files)
    np.testing.assert_array_equal(zt["lat"], zj["lat"])
    for k in ("log_resid_mean", "log_resid_std"):
        want = zj[k]
        np.testing.assert_allclose(
            zt[k], want, rtol=0,
            atol=RESID_TOL * np.abs(want).max(), err_msg=k)
    with open(tmp_path / "pb.json") as f:
        want = json.load(f)
    with open(precip_bias["dir"] / "pb.json") as f:
        got = json.load(f)
    same_rounded(got, want)


@pytest.fixture(scope="module")
def debias(files, precip_bias, tmp_path_factory):
    """make_precip_debias.py of both packages on the shared coupled run,
    each into its own copy of diag_precip_bias's npz."""
    d = tmp_path_factory.mktemp("debias")
    p = files["paths"]
    src = str(precip_bias["dir"] / "data" / "precip_bias.npz")
    out = {}
    for pkg, run in (("jax", run_jax_script), ("torch", run_port)):
        npz = str(d / f"{pkg}.npz")
        shutil.copy(src, npz)
        rc, text = run("make_precip_debias", [
            "--run", p["out"], "--cache", p["cache"], "--skip", "0",
            "--npz", npz, "--validate", p["out"]])
        out[pkg] = {"rc": rc, "stdout": text, "npz": npz}
    return out


def test_make_precip_debias_exact(debias):
    j, t = debias["jax"], debias["torch"]
    assert j["rc"] == t["rc"] == 0
    assert "PRECIP DEBIAS OK" in t["stdout"]
    assert _json_printed(t["stdout"]) == _json_printed(j["stdout"])
    zj, zt = np.load(j["npz"]), np.load(t["npz"])
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype, k
        np.testing.assert_array_equal(zt[k], zj[k], k)
    assert zt["debias"].shape == (48, 96) and zt["debias"].min() >= 0.0


def test_coupled_reads_the_debias(files, debias, tmp_path):
    """The coupled run with --precip-debias is the shared coupled run but
    for its written precip."""
    p = files["paths"]
    out = str(tmp_path / "run_debiased.nc")
    rc, text = run_port("reference_scale", [
        "coupled", "--fc-steps", str(COUPLED_STEPS), "--out", out,
        "--results", str(tmp_path / "coupled.json"), "--stream",
        "--precip-debias", debias["torch"]["npz"]] + OCEAN_ARGS
        + files["common"])
    assert rc == 0 and "precip output debias on" in text
    with open(tmp_path / "coupled.json") as f:
        assert json.load(f)["precip_debias"]
    base, deb = read_forecast(p["out"]), read_forecast(out)
    assert sorted(base) == sorted(deb)
    for k in base:
        if k != "p6hr":
            np.testing.assert_array_equal(deb[k], base[k], k)
    d = np.load(debias["torch"]["npz"])["debias"]
    eps = ReservoirConfig().precip_epsilon      # the model file's
    want = eps * np.expm1(np.maximum(
        np.log1p(base["p6hr"].astype(np.float64) / eps) - d, 0.0))
    np.testing.assert_allclose(deb["p6hr"], want, rtol=1e-4, atol=1e-7)
    assert np.all(deb["p6hr"] <= base["p6hr"] + 1e-6)
    assert (deb["p6hr"] < base["p6hr"]).any() or not d.any()


@pytest.fixture(scope="module")
def probe_dir(files, tmp_path_factory):
    """A working directory whose data/ holds the shared cache, model file
    and ocean blocks under the probes' fixed names."""
    d = tmp_path_factory.mktemp("probe")
    (d / "data").mkdir()
    p = files["paths"]
    for src, name in ((p["cache"], "refscale.npz"),
                      (p["weights"], "refscale_weights.nc"),
                      (p["cache"] + ".ocean_ckpt",
                       "refscale.npz.ocean_ckpt")):
        os.symlink(src, d / "data" / name)
    return d


def _probe_settings(mod):
    """The probes' lengths and ocean set to the shared files (see the
    module docstring); OCEAN_ARGS is --slab-hours 12 --ocean-m 60
    --ocean-block 0 at the default ocean beta."""
    mod.OCEAN = dict(slab_nodes=60, slab_beta_res=1e-4, timestep_slab=12)
    mod.OCEAN_REGION_BLOCK = 0
    for name, value in (("PER_STEP_STEPS", PROBE_STEPS),
                        ("HOLDOUT", HOLDOUT), ("N_STEPS", PROBE_STEPS)):
        if hasattr(mod, name):
            setattr(mod, name, value)


def _run_probe(name, argv, cwd):
    mod = load_script(name)
    _probe_settings(mod)
    buf = io.StringIO()
    here = os.getcwd()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
    finally:
        os.chdir(here)
    return rc, buf.getvalue()


def test_coupled_probe(files, probe_dir):
    blocks = sorted(os.listdir(probe_dir / "data" /
                               "refscale.npz.ocean_ckpt"))
    rc, text = _run_probe("coupled_probe", [
        "--bindir", files["bindir"], "--cpu", "--holdout", str(HOLDOUT)],
        str(probe_dir))
    assert rc == 0 and "PROBE DONE" in text
    # the shared ocean was read, not trained again
    assert sorted(os.listdir(probe_dir / "data" /
                             "refscale.npz.ocean_ckpt")) == blocks
    with open(probe_dir / "data" / "coupled_probe.json") as f:
        res = json.load(f)
    assert res == json.loads(text.splitlines()[-2])
    assert sorted(res) == ["A_uncoupled", "B_gate0", "C_gated",
                           "D_perstep"]
    for label, r in res.items():
        # the chunked runs take three 2-step ocean weeks
        steps = PROBE_STEPS if label == "D_perstep" else 6
        assert not r["aborted"] and r["steps"] == steps, label
        assert len(r["tmax"]) == (steps + 3) // 4, label
        assert np.isfinite(r["tmax"]).all(), label
        assert all(150.0 < t < 350.0 for t in r["tmax"]), label


def test_coupled_probe2(files, probe_dir):
    rc, text = _run_probe("coupled_probe2", [
        "--bindir", files["bindir"], "--cpu"], str(probe_dir))
    assert rc == 0 and "PROBE2 DONE" in text
    steps = [ln for ln in text.splitlines() if " i= " in ln or " i=" in ln]
    steps = [ln for ln in steps if "safe=" in ln]
    assert len(steps) == PROBE_STEPS
    for ln in steps:
        assert "safe=True" in ln, ln
        nums = [float(v) for v in re.findall(
            r"(?:winTmax|outTmax|outTmin|qmax)=\s*(\S+)", ln)]
        assert len(nums) == 4 and np.isfinite(nums).all(), ln
    # the ocean steps every 2 steps: twice in 4, anomalies finite
    ocean = [ln for ln in text.splitlines() if "OCEAN step" in ln]
    assert len(ocean) == PROBE_STEPS // 2
    for ln in ocean:
        assert "nan" not in ln.lower(), ln
    # the deltas of the last steps are printed, and finite
    assert any("dgv=" in ln for ln in steps)
    assert "nan" not in text.lower()


def test_diag_hybrid(files, monkeypatch):
    """The three fits at 26 samples on a narrower layout (see the module
    docstring): every printed error finite."""
    mod = load_script("diag_hybrid")
    init = TrajectoryRunner.initialize
    monkeypatch.setattr(
        TrajectoryRunner, "initialize",
        lambda self, year, month, spinup_days: init(self, year, month, 0))
    monkeypatch.setattr(mod, "RESERVOIR",
                        dict(mod.RESERVOIR, nodes_per_input=144))
    monkeypatch.setattr(decomposition, "build_layout", functools.partial(
        decomposition.build_layout, overlap=0))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main([str(DIAG_HYBRID_SAMPLES), "--bindir",
                       files["bindir"], "--cpu"])
    text = buf.getvalue()
    assert rc == 0
    assert len(re.findall(r"trained prior=", text)) == 3
    errs = re.findall(r"teacher-forced oos T RMS: \[(.*)\] mean (\S+)", text)
    assert len(errs) == 3
    for listed, mean in errs:
        vals = [float(v.strip(" '")) for v in listed.split(",")]
        assert len(vals) == 6 and np.isfinite(vals + [float(mean)]).all()
    for key in ("dry model 6h T RMS error", "persistence 6h T RMS"):
        m = re.search(key + r"\s*: (\S+) K", text)
        assert m and np.isfinite(float(m.group(1))), key


def _commands(path, python_dir):
    """Every `python <python_dir>/X.py ...` command of a shell script, its
    continuation lines joined: (script name, argument tokens)."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    cmds = []
    for line in text.splitlines():
        m = re.search(r"python (%s/\w+\.py)(.*)" % python_dir, line)
        if not m:
            continue
        rest = re.split(r"\|\||>>|>|&&", m.group(2))[0]
        cmds.append((os.path.basename(m.group(1))[:-3],
                     shlex.split(rest)))
    return cmds


def test_pipeline_script():
    path = os.path.join(REPO, "scripts_torch", "pipeline.sh")
    res = subprocess.run(["bash", "-n", path], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr
    port = _commands(path, "scripts_torch")
    ref = _commands(os.path.join(REPO, "scripts", "r5_pipeline.sh"),
                    "scripts")
    assert len(port) == len(ref) > 20

    def without_bindir(args):
        out, skip = [], False
        for a in args:
            if skip:
                skip = False
            elif a == "--bindir":
                skip = True
            else:
                out.append(a)
        return out

    assert [(n, without_bindir(a)) for n, a in port] == ref
    for name, args in port:
        src_path = os.path.join(REPO, "scripts_torch", name + ".py")
        assert os.path.exists(src_path), name
        with open(src_path) as f:
            src = f.read()
        for a in args:
            if a.startswith("--"):
                assert f'add_argument("{a}"' in src, (name, a)
        builds_model = 'required=True' in src and '"--bindir"' in src
        assert ("--bindir" in args) == builds_model, name
        if "--bindir" in args:
            assert args[args.index("--bindir") + 1] == "$BINDIR"
