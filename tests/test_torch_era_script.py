"""scripts_torch/train_from_era.py end to end on the CPU (--cpu): ERA-schema
files of one stand-in year at the model grid (24 six-hourly records of a
seeded smooth climate, q in kg/kg, SST, precipitation and TISR companions),
seeded stand-in boundary files for the model, ML-only training of all 1152
regions at the smallest reservoir (--nodes 60: one node per input, n=576)
and a two-step prediction written to a forecast file.

What is held: the exit code and the line the script ends with; the weight
file, read back by the port and by the JAX package's loader, is the model
the script trained (1152 regions, ML-only, finite readouts); the forecast
file holds the two steps, finite and inside the safety bounds. The ML-only
configuration is the one without --model-dir; training the hybrid one at
this grid costs several times more on the CPU and runs through the same
`train_from_era` call, which tests/test_torch_era.py holds against the JAX
package.
"""

import contextlib
import importlib.util
import io
import os

import numpy as np
import torch

from speedyml.io.weights import load_model as jload_model
from speedyml_torch.hybrid.state_io import SAFE_BOUNDS
from speedyml_torch.io import era
from speedyml_torch.io.output import read_forecast
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.io.weights import load_model

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YEAR, RECORDS, PREDICT = 1990, 24, 2


def _era_year(rng):
    """(atmo (T, 4, 8, 48, 96) with q in kg/kg, logp, sst, precip, tisr)."""
    lat = np.radians(np.linspace(-87, 87, 48))
    ones = np.ones((8, 48, 96))
    coslat = np.cos(lat)[:, None]
    t = 220.0 + 60.0 * coslat * np.linspace(0.6, 1.0, 8)[:, None, None]
    u = 20.0 * np.exp(-((np.abs(np.degrees(lat)) - 40.0) / 12.0) ** 2)
    base = np.stack([t * ones, u[:, None] * ones, 0.0 * ones,
                     5e-3 * coslat * np.linspace(1.0, 0.1, 8)[:, None, None]
                     * ones])
    scale = np.array([1.0, 2.0, 2.0, 2e-4])[:, None, None, None]
    atmo = np.stack([base + scale * rng.standard_normal(base.shape)
                     for _ in range(RECORDS)])
    atmo[:, 3] = np.abs(atmo[:, 3])
    f32 = np.float32
    logp = (0.01 * rng.standard_normal((RECORDS, 48, 96))).astype(f32)
    sst = (275.0 + 25.0 * coslat * np.ones((RECORDS, 48, 96))).astype(f32)
    precip = np.abs(rng.standard_normal((RECORDS, 48, 96))).astype(f32)
    tisr = (400.0 * np.abs(rng.standard_normal((RECORDS, 48, 96)))).astype(
        f32)
    return atmo.astype(f32), logp, sst, precip, tisr


def test_train_from_era_script(tmp_path):
    era_dir = str(tmp_path / "era")
    os.makedirs(era_dir)
    atmo, logp, sst, precip, tisr = _era_year(np.random.default_rng(4))
    era.write_era_year(era.era_file_name(era_dir, YEAR), atmo, logp,
                       sst=sst, p6hr=precip)
    era.write_tisr_year(era.tisr_file_name(era_dir, YEAR), tisr)
    bindir = write_synthetic_boundary(str(tmp_path / "bc"), seed=2)
    weights, fc_path = str(tmp_path / "w.nc"), str(tmp_path / "fc.nc")

    path = os.path.join(REPO, "scripts_torch", "train_from_era.py")
    spec = importlib.util.spec_from_file_location("_port_tfe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main([
            "--era-dir", era_dir, "--years", str(YEAR), str(YEAR),
            "--bindir", bindir, "--cpu", "--nodes", "60", "--discard", "6",
            "--sync", "24", "--region-block", "384", "--chunk", "32",
            "--out", weights, "--predict", str(PREDICT),
            "--forecast-out", fc_path])
    out = buf.getvalue()
    assert rc == 0 and out.strip().splitlines()[-1] == "TRAIN_FROM_ERA OK"
    assert f"steps={PREDICT}" in out and "aborted=False" in out

    tm, jm = load_model(weights, device="cpu"), jload_model(weights)
    assert tm.ml_only and jm.ml_only and tm.layout.R == 1152
    assert tuple(tm.params.wout.shape) == (1152, 136, 576)
    assert bool(torch.isfinite(tm.params.wout).all())
    np.testing.assert_array_equal(np.asarray(jm.params.wout),
                                  tm.params.wout.numpy())

    fc = read_forecast(fc_path)
    assert fc["Temperature"].shape == (PREDICT, 8, 48, 96)
    for i, (k, name) in enumerate((("Temperature", "t"), ("U-wind", "u"),
                                   ("V-wind", "v"),
                                   ("Specific-Humidity", "q"))):
        lo, hi = SAFE_BOUNDS[name]
        assert np.isfinite(fc[k]).all(), k
        assert lo <= fc[k].min() and fc[k].max() <= hi, k
