"""The chunked hybrid loop with the real 6-h window, in float64 on seeded
stand-in boundary files, at the full T30L8 grid (1152 regions) with a narrow
reservoir (m_target = n_in, deg 4, as tests/test_fastloop.py:36-37):

  * dry window, K=2, 4 steps: speedyml_torch's ScanHybridRunner against its
    own per-step HybridRunner and against speedyml's ScanHybridRunner;
  * full-physics window, one chunk of 2 steps, against speedyml's.

Tolerances are those of tests/test_fastloop.py:84-113. Both windows run in
float64 and agree to rounding; the packed supervector and the reservoir are
float32, so what remains is float32 rounding of the packed values carried
through the standardized readout (dry: atmo rtol/atol 3e-4, logp atol 1e-5,
x atol 1e-4). With full physics a float32-rounded start state can flip a
discrete trigger of the moist schemes in the second step: atmo rtol/atol
2e-3, precipitation atol 5e-3 mm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.core.calendar import ModelDate as JaxDate
from speedyml.core.config import ModelConfig as JaxConfig
from speedyml.core.config import ReservoirConfig as JaxReservoirConfig
from speedyml.coupler.daily import init_coupler_state as jax_init_coupler
from speedyml.domain import decomposition as jdec
from speedyml.domain import standardize as jstd
from speedyml.hybrid.experiment import HybridModel as JaxHybridModel
from speedyml.hybrid.fastloop import ScanHybridRunner as JaxScanRunner
from speedyml.model import Speedy as JaxSpeedy
from speedyml.reservoir import esn as jesn
from speedyml_torch import ModelConfig, ModelDate, ScanHybridRunner, convert
from speedyml_torch.hybrid.experiment import HybridModel, HybridRunner
from speedyml_torch.hybrid.forecast import SpeedyForecaster
from speedyml_torch.hybrid.state_io import extract
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.model import Speedy
from speedyml_torch.reservoir.generate import generate_esn

torch.set_num_threads(1)

CPU = "cpu"
QMIN = 1e-6
WHEN = (1982, 1, 2, 0)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    bindir = write_synthetic_boundary(
        str(tmp_path_factory.mktemp("bc")), seed=7)
    tm = Speedy(ModelConfig(dtype="float64"), bindir, device=CPU)
    tm.initialize(1982, 1)
    tm.run_days(1)
    jm = JaxSpeedy(JaxConfig(dtype="float64"), bindir=bindir)
    L = jdec.build_layout(radang_deg=np.degrees(np.asarray(
        jm.dy.tables.radang)))
    rng = np.random.default_rng(0)
    tp = generate_esn(0, L.R, L.n_in, L.n_out, n_model=L.n_out,
                      m_target=L.n_in, deg=4, device=CPU)
    na = L.n_out + tp.n
    # a tiny random readout around PHYSICAL means, so that the closed loop
    # stays inside the safety gate over several steps
    params = jesn.EsnParams(
        a_idx=jnp.asarray(tp.a_idx.numpy(), jnp.int32),
        a_val=jnp.asarray(tp.a_val.numpy()), win=jnp.asarray(tp.win.numpy()),
        wout=jnp.asarray(
            0.003 * rng.standard_normal((L.R, L.n_out, na), np.float32)),
        node_map=jnp.asarray(tp.node_map.numpy(), jnp.int32),
        leakage=tp.leakage, a_shift=jnp.asarray(tp.a_shift, jnp.int32))
    gs = extract(tm.dy, tm.state)
    atmo = torch.stack([gs.t, gs.u, gs.v, torch.clamp(gs.q, min=QMIN)]) \
        .to(torch.float32).numpy()
    logp = gs.logp.to(torch.float32).numpy()
    pr0 = np.zeros_like(logp)
    sst = np.asarray(jax_init_coupler(jm.clim, JaxDate(*WHEN)).sst_am)
    f32 = jnp.float32
    gv0 = np.asarray(jdec.pack_global(
        L, jnp.asarray(atmo), jnp.asarray(logp), jnp.asarray(pr0),
        jnp.maximum(jnp.asarray(sst, f32), 272.0),
        jnp.zeros((L.il, L.ix), f32)))
    stz = jstd.Standardizer(
        in_mean=jnp.asarray(gv0[L.input_index]),
        in_std=jnp.asarray(np.full((L.R, L.n_in), 5.0, np.float32)),
        out_mean=jnp.asarray(gv0[L.target_index]),
        out_std=jnp.asarray(np.ones((L.R, L.n_out), np.float32)))
    hj = JaxHybridModel(layout=L, params=params, stz=stz,
                        rcfg=JaxReservoirConfig(), ml_only=False)
    ht = HybridModel(layout=convert.region_layout(L),
                     params=convert.esn_params(params, CPU),
                     stz=convert.standardizer(stz, CPU),
                     rcfg=convert.reservoir_config(JaxReservoirConfig()))
    x0 = (0.1 * rng.standard_normal((L.R, tp.n))).astype(np.float32)
    return jm, tm, hj, ht, (atmo, logp, pr0), x0


def test_dry_chunks_match_the_runner_and_jax(setup):
    jm, tm, hj, ht, start, x0 = setup
    n = 4
    fast = ScanHybridRunner(ht, tm, physics=False, chunk=2).run(
        x0, *start, ModelDate(*WHEN), n)
    assert not fast["aborted"] and fast["steps_done"] == n
    assert fast["atmo"].shape == (n, 4, 8, 48, 96)
    d = fast["date"]
    assert (d.iyear, d.imonth, d.iday, d.ihour) == (1982, 1, 3, 0)

    # the port's per-step runner: the same window, boundary state rebuilt on
    # the host each step
    fc = SpeedyForecaster(tm, hours=ht.rcfg.timestep, physics=False)
    ref = HybridRunner(ht, fc).run(convert.tensor(x0, CPU), *start,
                                   ModelDate(*WHEN), n)
    assert not ref["aborted"]
    np.testing.assert_allclose(fast["sst"], ref["sst"].numpy(), rtol=0,
                               atol=2e-5)      # the runner keeps f32 SST
    np.testing.assert_allclose(fast["atmo"], ref["atmo"].numpy(), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(fast["logp"], ref["logp"].numpy(), rtol=3e-4,
                               atol=1e-5)
    np.testing.assert_allclose(fast["x"].numpy(), ref["x"].numpy(),
                               rtol=3e-4, atol=1e-4)
    # the date's diffusion corrections reach the dry window of a Speedy
    bare = HybridRunner(ht, SpeedyForecaster.dry(tm.dy)).run(
        convert.tensor(x0, CPU), *start, ModelDate(*WHEN), 1,
        sst_fn=lambda d: fast["sst"][0],
        tisr_fn=HybridRunner(ht, fc)._tisr)
    assert float((bare["atmo"][0] - ref["atmo"][0]).abs().max()) > 1e-3

    # the JAX package's chunked loop
    jfast = JaxScanRunner(hj, jm, physics=False, chunk=2).run(
        x0, *start, JaxDate(*WHEN), n)
    assert not jfast["aborted"]
    np.testing.assert_allclose(fast["sst"], jfast["sst"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(fast["atmo"], jfast["atmo"], rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(fast["logp"], jfast["logp"], rtol=3e-4,
                               atol=1e-5)
    np.testing.assert_allclose(fast["x"].numpy(), np.asarray(jfast["x"]),
                               rtol=3e-4, atol=1e-4)


def test_full_physics_chunk_matches_jax(setup):
    jm, tm, hj, ht, start, x0 = setup
    n = 2
    fast = ScanHybridRunner(ht, tm, physics=True, chunk=2).run(
        x0, *start, ModelDate(*WHEN), n)
    assert not fast["aborted"] and np.isfinite(fast["atmo"]).all()
    assert fast["precip_mm"].max() > 0.0
    jfast = JaxScanRunner(hj, jm, physics=True, chunk=2).run(
        x0, *start, JaxDate(*WHEN), n)
    assert not jfast["aborted"]
    np.testing.assert_allclose(fast["sst"], jfast["sst"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(fast["atmo"], jfast["atmo"], rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(fast["precip_mm"], jfast["precip_mm"],
                               rtol=0, atol=5e-3)
    # and the port's per-step runner, first step (same float32 start)
    ref = HybridRunner(ht, SpeedyForecaster(tm)).run(
        convert.tensor(x0, CPU), *start, ModelDate(*WHEN), 1)
    np.testing.assert_allclose(fast["atmo"][0], ref["atmo"][0].numpy(),
                               rtol=3e-4, atol=3e-4)
