"""FusedDataGenerator of speedyml_torch against speedyml's, in float64 on
the stand-in boundary files.

Tolerances. With a dry truth (truth_physics=False) both packages run the
same float64 arithmetic up to summation order in the transforms: over two
days (8 truth and 8 forecast windows of 24 steps, one daily coupler update
and SST anomaly between them) rounding stays near 1e-13 relative, held to
1e-9 of each field's scale as tests/test_torch_fullwindow.py holds its
windows; the host fields (TISR, hours) are exact. A full-physics truth
amplifies rounding through its discrete triggers (ROADMAP Queue 3 note (c)),
so the full-physics day is held to structure, the safety bounds and the
precipitation oracles, and its forecasts to the port's own dry forecaster,
exactly.
"""

import numpy as np
import pytest
import torch

from speedyml.core.calendar import ModelDate as JaxDate
from speedyml.core.config import ModelConfig as JaxConfig
from speedyml.coupler.anomaly import SyntheticEnso as JaxEnso
from speedyml.hybrid.forecast import FusedDataGenerator as JaxGenerator
from speedyml.hybrid.state_io import GridState as JaxGridState
from speedyml.model import Speedy as JaxSpeedy
from speedyml_torch import FusedDataGenerator, ModelConfig, ModelDate, convert
from speedyml_torch.core.calendar import datetime_from_hours
from speedyml_torch.coupler.anomaly import SyntheticEnso
from speedyml_torch.hybrid.experiment import atmo_to_grid
from speedyml_torch.hybrid.forecast import SpeedyForecaster
from speedyml_torch.hybrid.state_io import SAFE_BOUNDS
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.model import Speedy

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

CPU = "cpu"
TOL = 1e-9
KEYS = ("atmo", "logp", "precip", "sst", "tisr", "hours", "m_atmo",
        "m_logp", "m_precip")


@pytest.fixture(scope="module")
def bindir(tmp_path_factory):
    return write_synthetic_boundary(str(tmp_path_factory.mktemp("bc")),
                                    seed=5)


def enso_kw(tm):
    args = (np.degrees(tm.dy.tables.radang), np.arange(96) * 360.0 / 96,
            tm.clim.fmask_s)
    return args, dict(seed=3, t0=(1982, 1, 1), ramp_days=1.0,
                      period_days=8.0)


def test_dry_truth_against_jax(bindir):
    """Two days of 6-h windows (a daily coupler update and the SST anomaly
    crossed) from the same spun-up state and coupler."""
    tm = Speedy(ModelConfig(dtype="float64"), bindir, device=CPU)
    args, kw = enso_kw(tm)
    gen = FusedDataGenerator(tm, hours=6, truth_physics=False,
                             sst_anom_fn=SyntheticEnso(*args, **kw)
                             .sst_anom_fn)
    gen.initialize(1982, 1, spinup_days=1)
    assert (gen.date.iday, gen.date.ihour) == (2, 0)
    jm = JaxSpeedy(JaxConfig(dtype="float64"), bindir=bindir)
    jg = JaxGenerator(jm, hours=6, truth_physics=False,
                      sst_anom_fn=JaxEnso(*args, **kw).sst_anom_fn)
    # the port's spun-up state (anomaly imposed) in the JAX generator
    jg.date = JaxDate(gen.date.iyear, gen.date.imonth, gen.date.iday,
                      gen.date.ihour)
    jg.cs = convert.coupler_state(gen.cs)
    jg.gs = JaxGridState(*(np.asarray(v.numpy()) for v in gen.gs))

    n = 8
    got, want = gen.generate(n), jg.generate(n)
    assert sorted(got) == sorted(want) == sorted(KEYS)
    for k in ("tisr", "hours", "m_precip"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("atmo", "logp", "sst", "m_atmo", "m_logp"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape == (n,) + w.shape[1:], k
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=TOL * np.abs(w).max(), err_msg=k)
    assert not np.any(got["precip"]) and not np.any(got["m_precip"])
    # the coupler crossed a day: the last sample of day one carries the
    # updated SST, and the anomaly moved it
    assert np.abs(got["sst"][3] - got["sst"][2]).max() > 0.1
    assert (gen.date.iday, gen.date.ihour) == (4, 0)
    np.testing.assert_allclose(gen.cs.sst_am, jg.cs.sst_am, rtol=0,
                               atol=1e-12 * 300.0)


def test_generate_log(bindir, capsys):
    """generate(verbose=, log=) hands its progress lines to `log`, in the
    JAX package's words (speedyml/hybrid/forecast.py generate), one every
    `verbose` days, and nothing reaches stdout."""
    import re
    tm = Speedy(ModelConfig(), bindir, device=CPU)
    gen = FusedDataGenerator(tm, hours=6, truth_physics=False)
    gen.initialize(1982, 1, spinup_days=0)
    lines = []
    res = gen.generate(4, verbose=1, log=lines.append)
    assert res["atmo"].shape[0] == 4 and len(lines) == 1
    assert re.fullmatch(r"  day 1/1 \(\d+s, \d+\.\d\ds/sample\)",
                        lines[0]), lines
    assert capsys.readouterr().out == ""


def test_full_physics_structure(bindir):
    """Five samples (a second day, trimmed) with the full-physics truth:
    shapes, finite fields inside the safety bounds, 6-hourly dates, rain in
    some cells of every window and not in all; every forecast is the port's
    dry forecaster launched from the q-clamped truth state before it under
    a fresh coupler with that sample's SST."""
    tm = Speedy(ModelConfig(dtype="float64"), bindir, device=CPU)
    gen = FusedDataGenerator(tm, hours=6)
    gen.initialize(1982, 3, spinup_days=1)
    date0 = ModelDate(gen.date.iyear, gen.date.imonth, gen.date.iday,
                      gen.date.ihour)
    sst0 = np.array(gen.cs.sst_am)
    gs0 = gen.gs
    n = 5
    res = gen.generate(n)
    kx, il, ix = 8, 48, 96
    for k in ("atmo", "m_atmo"):
        assert res[k].shape == (n, 4, kx, il, ix), k
    for k in ("logp", "precip", "sst", "tisr", "m_logp", "m_precip"):
        assert res[k].shape == (n, il, ix), k
    for k in KEYS:
        assert np.all(np.isfinite(res[k])), k
    assert res["atmo"].dtype == np.float64
    np.testing.assert_array_equal(np.diff(res["hours"]), 6)
    for a in (res["atmo"], res["m_atmo"]):
        for i, name in enumerate(("t", "u", "v", "q")):
            lo, hi = SAFE_BOUNDS[name]
            assert lo <= a[:, i].min() and a[:, i].max() <= hi, name
    pr = res["precip"]
    assert pr.min() >= 0.0
    wet = (pr > 0.0).mean(axis=(1, 2))
    assert np.all((0.0 < wet) & (wet < 1.0)), wet
    assert not np.any(res["m_precip"])
    assert np.abs(res["atmo"][1] - res["atmo"][0]).max() > 1e-3
    assert np.abs(res["m_atmo"][2] - res["atmo"][2]).max() > 1e-4

    dry = SpeedyForecaster(tm, hours=6, physics=False)
    for t in range(n):
        if t == 0:
            start, date, sst = gs0._replace(
                q=torch.clamp(gs0.q, min=0.0)), date0, sst0
        else:
            start = atmo_to_grid(torch.as_tensor(res["atmo"][t - 1]),
                                 torch.as_tensor(res["logp"][t - 1]))
            date = ModelDate(*datetime_from_hours(int(res["hours"][t - 1])))
            sst = res["sst"][t - 1]
        fc = dry.forecast(start, date, sst_hybrid=sst)
        m = np.stack([v.numpy() for v in fc.gs[:4]])
        np.testing.assert_array_equal(res["m_atmo"][t], m, err_msg=str(t))
        np.testing.assert_array_equal(res["m_logp"][t], fc.gs.logp.numpy())
