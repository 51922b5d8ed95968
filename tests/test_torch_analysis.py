"""The port's analysis copies and file-reading scripts against speedyml's.

`utils/analysis.py`, `utils/climate.py` and `io/grads.py` are the port's own
copies of host numpy modules: held to exact equality on the inputs of
tests/test_analysis.py and tests/test_climate.py, and the GrADS files both
packages write from the same arrays byte for byte. `analyze_forecast`,
`score_run`, `decade_table` and `climate_check cache` of scripts_torch run
beside the JAX scripts on the same stand-in files: their outputs agree,
numbers to 1e-12 relative, everything else equal. `enso_eval` and
`climate_check run` need the model's boundary files (the JAX scripts build
a model on the reference's), so they run on the port alone, on seeded
stand-in files, and are held to their own contract: the JSON is written,
every score is finite, and the verdict printed is the JSON's.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from speedyml.io import grads as jgrads
from speedyml.io.output import ForecastWriter as JaxForecastWriter
from speedyml.utils import analysis as jan
from speedyml.utils import climate as jcl
from speedyml_torch.io import grads as tgrads
from speedyml_torch.io.output import ForecastWriter
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.utils import analysis as tan
from speedyml_torch.utils import climate as tcl

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_RTOL = 1e-12
LAT = np.linspace(-87, 87, 48)
LON = np.arange(0, 360, 3.75)


def load_script(pkg, name):
    """A script of scripts/ or scripts_torch/ as a module (not run)."""
    path = os.path.join(REPO, pkg, name + ".py")
    spec = importlib.util.spec_from_file_location(f"_{pkg}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_script(name, argv):
    """A JAX script's main() with sys.argv set: (exit code, stdout)."""
    mod = load_script("scripts", name)
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [name + ".py"] + list(argv)
    try:
        with contextlib.redirect_stdout(buf):
            try:
                rc = mod.main()
            except SystemExit as e:
                rc = e.code
    finally:
        sys.argv = saved
    return rc or 0, buf.getvalue()


def run_port_script(name, argv):
    """A port script's main(argv): (exit code, stdout)."""
    mod = load_script("scripts_torch", name)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    return rc, buf.getvalue()


_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|[-+]?nan")


def same_text(got, want):
    """Equal text with every number equal to NUM_RTOL relative."""
    g_nums, w_nums = _NUM.findall(got), _NUM.findall(want)
    assert _NUM.sub("#", got) == _NUM.sub("#", want)
    assert len(g_nums) == len(w_nums)
    np.testing.assert_allclose(np.array(g_nums, float),
                               np.array(w_nums, float), rtol=NUM_RTOL,
                               equal_nan=True)


def same_json(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            same_json(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            same_json(a, b)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=NUM_RTOL)
    else:
        assert got == want


def json_of(stdout):
    """The JSON object a script prints (its first '{' to its last '}')."""
    return json.loads(stdout[stdout.index("{"):stdout.rindex("}") + 1])


# ----------------------------------------------------------------------
# utils/analysis.py, utils/climate.py: the same numpy code
# ----------------------------------------------------------------------
def _analysis_cases():
    rng = np.random.default_rng(0)
    months48 = np.tile(np.arange(1, 13), 4)
    sst = np.full((60, 48, 96), 300.0)
    sst[30:42, 22:26, 50:65] += 2.0
    clim = rng.standard_normal((48, 96))
    truth = clim + rng.standard_normal((48, 96))
    logp = rng.standard_normal((3, 6, 8)) * 0.05
    var = 250.0 + rng.standard_normal((3, 8, 6, 8))
    series = np.sin(np.arange(200) / 10.0) + 0.1 * rng.standard_normal(200)
    return {
        "rms": ("rms", (np.zeros((4, 5)), rng.standard_normal((4, 5))), {}),
        "weighted_rms": ("weighted_rms", (np.zeros((48, 96)),
                                          rng.standard_normal((48, 96)),
                                          LAT), {}),
        "sigma_to_pressure": ("sigma_to_pressure",
                              (var, logp, np.array([100.0, 500.0, 900.0])),
                              {}),
        "monthly_climatology": ("monthly_climatology",
                                (rng.standard_normal((48, 3)), months48),
                                {}),
        "anomalies": ("anomalies", (rng.standard_normal((48, 3)), months48),
                      {}),
        "anomaly_correlation": ("anomaly_correlation",
                                (truth, 2 * clim - truth, clim, LAT), {}),
        "box_mean": ("box_mean", (rng.standard_normal((12, 12)),
                                  np.linspace(-85, 85, 12),
                                  np.arange(0, 360, 30.0), (-90, 90),
                                  (330.0, 30.0)), {}),
        "nino34_index": ("nino34_index", (sst, LAT, LON,
                                          (np.arange(60) % 12) + 1), {}),
        "power_spectrum": ("power_spectrum",
                           (np.sin(2 * np.pi * np.arange(512) / 16.0),),
                           {"dt": 1.0}),
        "return_period_maxima": ("return_period_maxima",
                                 (rng.standard_normal((20, 2)), 5), {}),
        "global_total_precip": ("global_total_precip",
                                (np.abs(rng.standard_normal((2, 48, 96))),
                                 LAT), {}),
        "total_atmosphere_mass": ("total_atmosphere_mass",
                                  (rng.standard_normal((3, 48, 96)) * 0.01,
                                   LAT), {}),
        "running_mean": ("running_mean", (series, 11), {}),
        "linear_trend": ("linear_trend",
                         (np.stack([0.5 * np.arange(60.0),
                                    -np.arange(60.0) + 4.0], axis=1),),
                         {"dt": 0.25}),
    }


def _assert_identical(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_identical(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(_analysis_cases()))
def test_analysis_exact(case):
    fn, args, kw = _analysis_cases()[case]
    _assert_identical(getattr(tan, fn)(*args, **kw),
                      getattr(jan, fn)(*args, **kw))


def test_analysis_constants():
    np.testing.assert_array_equal(tan.SPEEDY_SIGMA, jan.SPEEDY_SIGMA)
    assert tcl.BANDS == jcl.BANDS and tcl.JET_LEVELS == jcl.JET_LEVELS


def _healthy():
    """tests/test_climate.py's healthy synthetic climatology."""
    uz = 30.0 * np.exp(-((np.abs(LAT) - 40.0) / 12.0) ** 2)
    u = np.zeros((8, 48, 96))
    u[1:4] = uz[:, None]
    u[4:] = 0.3 * uz[:, None]
    t = np.zeros((8, 48, 96))
    for k in range(8):
        t[k] = 210.0 + (85.0 * (k + 1) / 8) * np.cos(
            np.radians(LAT))[:, None] ** 0.5
    t[-1] = 288.0 * np.ones((48, 96)) - 30 * (
        1 - np.cos(np.radians(LAT))[:, None])
    pr = 2.0 + 6.0 * np.exp(-(LAT / 10.0) ** 2)[:, None] * np.ones((1, 96))
    return u, t, pr


@pytest.mark.parametrize("case", ["healthy", "jet_collapse",
                                  "inverted_precip", "runaway"])
def test_climate_exact(case):
    u, t, pr = _healthy()
    hours = np.arange(90) * 24.0
    kw = {"healthy": dict(u_mean=u, t_mean=t, precip_mm_day=pr, tsr=240.0,
                          olr=238.0,
                          t_low_series=285.0 + 0.2 * np.sin(hours / 500.0),
                          hours=hours),
          "jet_collapse": dict(u_mean=np.zeros_like(u)),
          "inverted_precip": dict(precip_mm_day=np.broadcast_to(
              (8.0 - 6.0 * np.exp(-(LAT / 10.0) ** 2))[:, None], (48, 96))),
          "runaway": dict(t_low_series=285.0 + hours / 216.0,
                          hours=hours)}[case]
    got, want = tcl.climate_scores(LAT, **kw), jcl.climate_scores(LAT, **kw)
    assert got == want
    assert tcl.climate_check(got) == jcl.climate_check(want)
    assert tcl.climate_check(got)[0] == (case == "healthy")


# ----------------------------------------------------------------------
# io/grads.py: byte-identical files, each package reads the other's
# ----------------------------------------------------------------------
def test_grads_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    sigma = np.linspace(0.05, 0.95, 8)
    f3 = [rng.standard_normal((8, 48, 96)) for _ in range(2)]
    f2 = [rng.standard_normal((48, 96))]
    paths = {}
    for name, mod in (("jax", jgrads), ("port", tgrads)):
        os.makedirs(tmp_path / name)
        base = str(tmp_path / name / "means")     # the .ctl names its .grd
        with mod.GradsWriter(base, LAT, sigma, 96, var3d=("TEMP", "U"),
                             var2d=("LNPS",), year0=1990, month0=3) as w:
            for step in range(3):
                w.append([a + step for a in f3], [a - step for a in f2])
        paths[name] = base
    for ext in (".grd", ".ctl"):
        with open(paths["jax"] + ext, "rb") as a, \
                open(paths["port"] + ext, "rb") as b:
            assert a.read() == b.read(), ext
    for reader, path in ((tgrads.read_grads, paths["jax"]),
                         (jgrads.read_grads, paths["port"])):
        g3, g2 = reader(path, 8, 48, 96, n3d=2, n2d=1)
        w3, w2 = jgrads.read_grads(paths["jax"], 8, 48, 96, n3d=2, n2d=1)
        assert g3.shape == (3, 2, 8, 48, 96) and g2.shape == (3, 1, 48, 96)
        np.testing.assert_array_equal(g3, w3)
        np.testing.assert_array_equal(g2, w2)
        np.testing.assert_array_equal(g3[1, 0], np.float32(f3[0] + 1))


# ----------------------------------------------------------------------
# the scripts that read only files, both packages on the same files
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def forecasts(tmp_path_factory):
    """A prediction and a truth file (6 steps, tests/test_analysis.py's
    recipe) and a longer run with a secular pressure trend (48 steps, its
    decade-table recipe), written by the JAX package's ForecastWriter and,
    for the run, also by the port's: the port's scripts read both."""
    d = tmp_path_factory.mktemp("fc")
    rng = np.random.default_rng(1)

    def atmo():
        return np.stack([np.full((8, 48, 96), 260.0),
                         rng.standard_normal((8, 48, 96)),
                         rng.standard_normal((8, 48, 96)),
                         np.abs(rng.standard_normal((8, 48, 96)))])

    paths = {k: str(d / f"{k}.nc") for k in ("pred", "truth", "run",
                                            "run_port")}
    for k in ("pred", "truth"):
        with JaxForecastWriter(paths[k], 8, 48, 96, lat=LAT, lon=LON,
                               with_sst=True) as w:
            for _ in range(6):
                w.append(atmo(), rng.standard_normal((48, 96)) * 0.01,
                         precip_mm=np.abs(rng.standard_normal((48, 96))),
                         sst=np.full((48, 96), 300.0))
    steps = [(atmo(), np.full((48, 96), 1e-4 * i, np.float32),
              np.abs(rng.standard_normal((48, 96))),
              300.0 + rng.standard_normal((48, 96))) for i in range(48)]
    for k, writer in (("run", JaxForecastWriter), ("run_port",
                                                   ForecastWriter)):
        with writer(paths[k], 8, 48, 96, lat=LAT, lon=LON,
                    with_sst=True) as w:
            for a, lp, pr, ss in steps:
                w.append(a, lp, precip_mm=pr, sst=ss)
    return paths


def test_analyze_forecast_script(forecasts):
    argv = [forecasts["pred"], "--truth", forecasts["truth"], "--pressure",
            "500", "850"]
    rc_j, out_j = run_jax_script("analyze_forecast", argv)
    rc_t, out_t = run_port_script("analyze_forecast", argv)
    assert rc_j == rc_t == 0
    assert "RMS vs truth" in out_t and "Nino-3.4 index" in out_t
    same_text(out_t, out_j)


@pytest.mark.parametrize("nc", ["run", "run_port"])
def test_score_run_script(forecasts, tmp_path, nc):
    outs = {}
    for pkg, run in (("jax", run_jax_script), ("port", run_port_script)):
        path = str(tmp_path / f"{pkg}.json")
        rc, out = run("score_run", ["--nc", forecasts[nc], "--out", path,
                                    "--skip-days", "1"])
        with open(path) as f:
            outs[pkg] = (rc, out, json.load(f))
    (rc_j, out_j, js_j), (rc_t, out_t, js_t) = outs["jax"], outs["port"]
    assert rc_t == rc_j and rc_t in (0, 1)
    js_j["nc"] = js_t["nc"]
    same_json(js_t, js_j)
    assert "sst" in js_t and js_t["ok"] == (rc_t == 0)
    assert out_t.splitlines()[-1] == out_j.splitlines()[-1]


def test_decade_table_script(forecasts, tmp_path):
    outs = {}
    for pkg, run in (("jax", run_jax_script), ("port", run_port_script)):
        path = str(tmp_path / f"{pkg}.json")
        rc, out = run("decade_table", ["--nc", forecasts["run"],
                                       forecasts["run_port"],
                                       "--steps-per-year", "32", "--out",
                                       path])
        with open(path) as f:
            outs[pkg] = (rc, json_of(out), json.load(f))
    (rc_j, pr_j, js_j), (rc_t, pr_t, js_t) = outs["jax"], outs["port"]
    assert rc_t == 0 and rc_j == 0
    assert len(js_t["years"]) == 3 and js_t["atmosphere_mass"] is not None
    same_json(js_t, js_j)
    same_json(pr_t, js_t)


@pytest.fixture(scope="module")
def small_cache(tmp_path_factory):
    """A small stand-in truth cache in the data phase's schema: 40 samples
    of a seeded smooth climate, 6-hourly from 1 March 1983 (within the
    imposed ENSO forcing's record, which starts in February 1982)."""
    from speedyml_torch.core.calendar import hours_since_epoch
    rng = np.random.default_rng(5)
    n = 40
    coslat = np.cos(np.radians(LAT))[:, None]
    ones = np.ones((8, 48, 96))
    t = 220.0 + 60.0 * coslat * np.linspace(0.6, 1.0, 8)[:, None, None] \
        * ones
    u = 25.0 * np.exp(-((np.abs(LAT) - 40.0) / 12.0) ** 2)[:, None] * ones
    atmo = np.stack([np.stack([t, u, 0.1 * u, 5.0 * coslat * ones])
                     + rng.standard_normal((4, 8, 48, 96)) for _ in
                     range(n)]).astype(np.float32)
    h0 = hours_since_epoch(1983, 3, 1, 0)
    path = str(tmp_path_factory.mktemp("cache") / "cache.npz")
    np.savez(path, atmo=atmo,
             logp=rng.standard_normal((n, 48, 96)).astype(np.float32) * 0.01,
             precip=np.abs(rng.standard_normal((n, 48, 96))).astype(
                 np.float32),
             sst=np.full((n, 48, 96), 290.0), tisr=np.zeros((n, 48, 96)),
             hours=h0 + 6 * np.arange(1, n + 1))
    return path


def test_climate_check_cache_script(small_cache):
    argv = ["cache", "--cache", small_cache, "--no-lat-from-model",
            "--skip", "4"]
    rc_j, out_j = run_jax_script("climate_check", argv)
    rc_t, out_t = run_port_script("climate_check", argv)
    assert rc_t == rc_j
    same_json(json_of(out_t), json_of(out_j))
    assert out_t.splitlines()[-1] == out_j.splitlines()[-1]


def test_climate_check_lat_from_model():
    """--lat-from-model reads the latitudes of the model grid, which are
    the JAX model's (its tables; no boundary files needed)."""
    from speedyml.transforms.tables import build_tables
    mod = load_script("scripts_torch", "climate_check")
    np.testing.assert_array_equal(
        mod._model_lat(), np.degrees(np.asarray(build_tables().radang)))


# ----------------------------------------------------------------------
# the port alone on stand-in boundary files
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def bindir(tmp_path_factory):
    return write_synthetic_boundary(str(tmp_path_factory.mktemp("bc")),
                                    seed=11)


def _verdict_matches(out, js, word):
    last = out.strip().splitlines()[-1]
    assert last == f"{word} " + ("OK" if js["ok"] else "FAILED")


def test_enso_eval_script(bindir, small_cache, tmp_path):
    """A coupled-run file of 5 days after the cache's last training sample,
    its SST the imposed forcing's continuation plus noise."""
    from speedyml_torch.coupler.anomaly import SyntheticEnso
    from speedyml_torch.coupler.climatology import build_climatology
    from speedyml_torch.transforms.tables import build_tables
    tb = build_tables()
    clim = build_climatology(bindir, tb.gcos, tb.radang)
    lat = np.degrees(np.asarray(tb.radang))
    enso = SyntheticEnso(lat, LON, clim.fmask_s, amp=1.2)
    hours = np.load(small_cache)["hours"]
    h0 = int(hours[len(hours) - 8 - 1])
    rng = np.random.default_rng(9)
    nc = str(tmp_path / "enso_run.nc")
    with ForecastWriter(nc, 8, 48, 96, lat=lat, lon=LON, with_sst=True) as w:
        for i in range(60):
            w.append(np.zeros((4, 8, 48, 96)), np.zeros((48, 96)),
                     precip_mm=np.zeros((48, 96)),
                     sst=290.0 + enso.index_at(h0 + 6 * (i + 1))
                     * enso.pattern + 0.05 * rng.standard_normal((48, 96)))
    out_path = str(tmp_path / "enso.json")
    rc, out = run_port_script("enso_eval", [
        "--nc", nc, "--cache", small_cache, "--holdout", "8",
        "--skip-days", "1", "--bindir", bindir, "--out", out_path])
    assert rc == 0
    with open(out_path) as f:
        js = json.load(f)
    assert js == json_of(out)
    assert js["steps"] == 60
    for k in ("nino34_run_anom_std_K", "nino34_imposed_train_std_K",
              "phase_corr_first_20wk_vs_imposed", "subseasonal_std_run_K",
              "subseasonal_ratio"):
        assert np.isfinite(js[k]), k
    _verdict_matches(out, js, "ENSO EVAL")


def test_climate_check_run_script(bindir, tmp_path):
    """`run` on the port's model, two days from a rest start on the CPU
    (the drift score's trend needs two days)."""
    out_path = str(tmp_path / "climate.json")
    rc, out = run_port_script("climate_check", [
        "run", "--spinup", "0", "--days", "2", "--bindir", bindir, "--cpu",
        "--out", out_path])
    with open(out_path) as f:
        js = json.load(f)
    assert js == json_of(out)
    assert rc == (0 if js["ok"] else 1)
    assert js["mode"] == "run" and js["days"] == 2
    assert set(js["scores"]) >= {"jet_speed_nh", "t_low_global",
                                 "precip_global_mm_day", "toa_net_w_m2"}
    assert all(np.isfinite(v) for v in js["scores"].values())
    _verdict_matches(out, js, "CLIMATE CHECK")


def test_scripts_need_the_card_or_cpu(bindir, tmp_path):
    """Without a card and without --cpu a script that computes on the
    device stops with a nonzero exit code; it does not carry on on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        run_port_script("climate_check", [
            "run", "--spinup", "0", "--days", "1", "--bindir", bindir,
            "--out", str(tmp_path / "c.json")])
    assert e.value.code not in (0, None)
    assert not os.path.exists(tmp_path / "c.json")
