"""The coupled closed loop of speedyml_torch against speedyml's: the
per-step HybridRunner.run(ocean=...) and the chunked ScanHybridRunner on
the small synthetic grid (ml_only, stubbed boundary fields, two 4-step
"weeks", as tests/test_fastloop.py:140-171), on weights that the JAX package
trained and `convert` carried over; then the chunked loop's own semantics
(stream mode, abort, absolute checkpoint steps, precip_debias, resume), and
checkpoints written by one package resumed by the other.

Tolerances of the closed loops: sst atol 1e-4 K (host float64 in both, but
the fed-back SST comes out of a float32 ocean readout near 290 K, where one
float32 ulp is 3.05e-5 K: the two packages' readouts differ by an ulp in a
cell here and there), atmo rtol/atol 1e-4 (the same float32
elementwise ops; dot products summed in another order, carried through 8
closed-loop steps), and x_ocean atol 1e-4: the ocean reservoirs are driven
by the week-mean of that atmosphere trajectory, so their states (tanh
outputs of size 1) are held to what drives them; the largest difference seen
is 1.1e-5, in one of 8064 states.
"""

import numpy as np
import pytest
import torch

from speedyml.core.calendar import ModelDate as JaxDate
from speedyml.hybrid import experiment as jexp
from speedyml.hybrid.fastloop import ScanHybridRunner as JaxScanRunner
from speedyml.io.checkpoint import load_prediction as jax_load_prediction
from speedyml.reservoir.slab import train_ocean as jax_train_ocean
from speedyml_torch import (ModelConfig, ModelDate, ReservoirConfig,
                            ScanHybridRunner, convert)
from speedyml_torch.coupler.daily import fordate, init_coupler_state
from speedyml_torch.domain.decomposition import build_layout, pack_global
from speedyml_torch.domain.standardize import Standardizer
from speedyml_torch.hybrid import fastloop
from speedyml_torch.hybrid.experiment import HybridModel, HybridRunner
from speedyml_torch.hybrid.fastloop import (ML_FIELDS, StepFields, _ml_sane,
                                            _qsat_dev)
from speedyml_torch.hybrid.state_io import extract
from speedyml_torch.io.checkpoint import load_prediction
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.model import Speedy
from speedyml_torch.physics.radiation import diurnal_tisr
from speedyml_torch.reservoir.esn import EsnParams
from tests.test_hybrid import _small_layout, _small_rcfg, _synthetic_truth

torch.set_num_threads(1)

CPU = "cpu"
START = (1999, 1, 1, 0)


@pytest.fixture(scope="module")
def setup():
    """tests/test_fastloop.py:_ocean_setup, once: an ml_only hybrid and an
    ocean trained by the JAX package, the same two carried over, and the
    state to start from."""
    L = _small_layout()
    rcfg = _small_rcfg(timestep_slab=24, slab_nodes=400, slab_noise_std=0.02,
                       sst_variance_threshold=0.2)
    atmo, logp, precip, sst, tisr = _synthetic_truth(L, 600, seed=22)
    gv = jexp.transform_and_pack(L, atmo, logp, precip, sst, tisr,
                                 rcfg.precip_epsilon)
    hj = jexp.train_hybrid(L, rcfg, gv, None, seed=9)
    oj = jax_train_ocean(L, rcfg, gv, seed=6)
    ht = HybridModel(layout=convert.region_layout(L),
                     params=convert.esn_params(hj.params, CPU),
                     stz=convert.standardizer(hj.stz, CPU),
                     rcfg=convert.reservoir_config(hj.rcfg), ml_only=True)
    ot = convert.ocean_model(oj, CPU)
    x = np.array(hj.synchronize(gv[-40:]))
    s = L.gv_sizes
    last = gv[-1]

    def field(name, shape):
        return last[s[name][0]:s[name][1]].reshape(shape)

    start = (field("atmo3d", (4, L.kx, L.il, L.ix)),
             field("logp", (L.il, L.ix)), field("precip", (L.il, L.ix)))
    clim = field("sst", (L.il, L.ix)).astype(np.float64)
    assert oj.active.any()
    return L, (hj, oj), (ht, ot), x, start, clim


def _jax_runner(hj, L, clim):
    class Runner(jexp.HybridRunner):
        def _sst_tisr(self, date):
            return clim.copy(), np.zeros((L.il, L.ix))
    return Runner(hj, None, clim=object(), dy=object())


def _runner(ht, L, clim):
    class Runner(HybridRunner):
        def _sst(self, date):
            return clim.copy()

        def _tisr(self, date):
            return np.zeros((L.il, L.ix))
    return Runner(ht, None)


def _scan(ht, L, clim, chunk=28, tisr_spike_at=None):
    """ml_only ScanHybridRunner with stubbed boundary fields in float64 (the
    per-step runner's host path); optionally a huge TISR at one global step
    index (the abort test's forcing)."""
    calls = {"n": 0}

    class Scan(ScanHybridRunner):
        def _host_step_fields(self, date):
            i = calls["n"]
            calls["n"] += 1
            tisr = np.zeros((L.il, L.ix))
            if tisr_spike_at is not None and i == tisr_spike_at:
                tisr = np.full((L.il, L.ix), 1e6)
            return dict(sst_clim=clim, tisr=tisr)

    s = Scan(ht, None, chunk=chunk)
    s.dtype = torch.float64
    return s


def _close(out, ref):
    def host(v):
        return v.numpy() if torch.is_tensor(v) else np.asarray(v)
    np.testing.assert_allclose(host(out["sst"]), host(ref["sst"]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(host(out["atmo"]), host(ref["atmo"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(host(out["x_ocean"]), host(ref["x_ocean"]),
                               rtol=0, atol=1e-4)


def test_runner_with_ocean_matches_jax(setup):
    L, (hj, oj), (ht, ot), x, start, clim = setup
    n = 8       # two "weeks" of 4 steps
    ref = _jax_runner(hj, L, clim).run(
        x, *start, JaxDate(*START), n, ocean=oj,
        sst_anom0=np.zeros_like(clim))
    out = _runner(ht, L, clim).run(
        convert.tensor(x, CPU), *start, ModelDate(*START), n, ocean=ot,
        sst_anom0=np.zeros_like(clim))
    assert not out["aborted"] and out["sst"].shape == ref["sst"].shape
    _close(out, ref)
    np.testing.assert_allclose(out["precip_mm"].numpy(), ref["precip_mm"],
                               rtol=1e-3, atol=1e-5)
    # the first week rides the climatology; then the ocean moved the SST
    np.testing.assert_allclose(out["sst"][0].numpy(), clim, atol=1e-12)
    assert not np.allclose(out["sst"][5].numpy(), clim)
    assert np.abs(out["sst"].numpy() - clim).max() <= \
        ot.rcfg.slab_anom_clip + 1e-9
    with pytest.raises(ValueError, match="mutually"):
        _runner(ht, L, clim).run(convert.tensor(x, CPU), *start,
                                 ModelDate(*START), 2, ocean=ot,
                                 sst_fn=lambda d: clim)


def test_scan_runner_with_ocean_matches_jax_and_the_runner(setup):
    L, (hj, oj), (ht, ot), x, start, clim = setup
    n = 8

    class JaxScan(JaxScanRunner):
        def _host_step_fields(self, date):
            return dict(sst_clim=clim, tisr=np.zeros((L.il, L.ix)))

    js = JaxScan(hj, None)
    js._np_dtype = np.float64
    ref = js.run(x, *start, JaxDate(*START), n, ocean=oj,
                 sst_anom0=np.zeros_like(clim))
    out = _scan(ht, L, clim).run(x, *start, ModelDate(*START), n, ocean=ot,
                                 sst_anom0=np.zeros_like(clim))
    assert out["steps_done"] == ref["steps_done"] == n
    assert not out["aborted"] and out["chunk_ms"] == []
    assert out["sst"].shape == ref["sst"].shape == (n, L.il, L.ix)
    _close(out, ref)
    np.testing.assert_allclose(out["x"].numpy(), np.asarray(ref["x"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["sst_anom"], ref["sst_anom"], rtol=0,
                               atol=1e-4)
    d = out["date"]
    assert (d.iyear, d.imonth, d.iday, d.ihour) == (1999, 1, 3, 0)
    assert not np.allclose(out["sst"][5], out["sst"][0])
    # and the port's per-step runner took the same trajectory
    per_step = _runner(ht, L, clim).run(
        convert.tensor(x, CPU), *start, ModelDate(*START), n, ocean=ot,
        sst_anom0=np.zeros_like(clim))
    _close(out, per_step)
    assert torch.allclose(out["atmo_end"], per_step["atmo"][-1], rtol=1e-4,
                          atol=1e-4)


def test_stream_mode(setup):
    """stream=True: every step reaches the writer, the host keeps only the
    summary and the tail, and the summary is the kept trajectory's."""
    L, _, (ht, ot), x, start, clim = setup
    n = 8
    kept = _scan(ht, L, clim, chunk=4).run(x, *start, ModelDate(*START), n)
    writes = []

    class Writer:
        def append(self, atmo, logp, precip_mm=None, sst=None):
            writes.append((atmo.copy(), sst.copy()))

    out = _scan(ht, L, clim, chunk=4).run(
        x, *start, ModelDate(*START), n, writer=Writer(), stream=True)
    assert out["atmo"] is None and out["steps_done"] == n
    assert len(writes) == n
    s = out["summary"]
    ka = kept["atmo"]
    assert s["steps"] == n
    assert np.isclose(s["t_min"], ka[:, 0].min())
    assert np.isclose(s["t_max"], ka[:, 0].max())
    assert np.isclose(s["u_min"], ka[:, 1].min())
    assert np.isclose(s["sst_max"], kept["sst"].max())
    assert np.isclose(s["precip_mm_max"], kept["precip_mm"].max())
    assert np.isclose(s["sst_drift_K"],
                      np.abs(kept["sst"][-1] - kept["sst"][0]).max())
    np.testing.assert_array_equal(writes[-1][0], ka[-1])
    np.testing.assert_array_equal(out["atmo_end"].numpy(), ka[-1])
    # fetch_traj=False: nothing comes down, nothing is written
    quiet = _scan(ht, L, clim, chunk=4).run(
        x, *start, ModelDate(*START), n, writer=Writer(), fetch_traj=False)
    assert quiet["atmo"] is None and len(writes) == n
    assert torch.equal(quiet["x"], out["x"])


@pytest.mark.parametrize("stream", [False, True])
def test_abort_semantics(setup, stream):
    """A mid-chunk safety abort: steps_done, date and trajectory stop AT the
    abort step, every carried state is withheld, and the last state handed
    back is the last SAFE step's."""
    L, _, (ht, ot), x, start, clim = setup
    n, j = 8, 5                              # abort at global step index 5
    s = _scan(ht, L, clim, chunk=8, tisr_spike_at=j)
    s._ml_safe_fn = lambda a, lp, xs: xs.tisr.max() < 1e5
    ref = _scan(ht, L, clim, chunk=8).run(x, *start, ModelDate(*START), n)
    out = s.run(x, *start, ModelDate(*START), n, stream=stream)
    assert out["aborted"] and out["steps_done"] == j
    assert out["x"] is None and out["x_ocean"] is None
    assert out["atmo_end"] is None and out["precip_t"] is None
    d = out["date"]                          # the start + j * 6 h
    assert (d.iyear, d.imonth, d.iday, d.ihour) == (1999, 1, 2, 6)
    np.testing.assert_array_equal(out["atmo_last"], ref["atmo"][j - 1])
    assert np.isfinite(out["atmo_last"]).all()
    if stream:
        assert out["atmo"] is None and out["summary"]["steps"] == j
    else:
        assert len(out["atmo"]) == j         # the unsafe step never surfaces
        np.testing.assert_array_equal(out["atmo"], ref["atmo"][:j])


def test_default_ml_gate_and_qsat():
    """The ml_only gate: finite and inside the physical bounds. The device
    qsat is the coupler's."""
    from speedyml_torch.coupler.daily import _qsat_np
    a = torch.zeros(4, 2, 3, 4)
    a[0] = 250.0
    lp = torch.zeros(3, 4)
    assert bool(_ml_sane(a, lp))
    for v, bad in ((0, 100.0), (0, 450.0), (1, 600.0), (2, -600.0),
                   (3, float("nan"))):
        b = a.clone()
        b[v, 0, 0, 0] = bad
        assert not bool(_ml_sane(b, lp)), (v, bad)
    assert not bool(_ml_sane(a, lp + float("inf")))
    ta = np.linspace(200.0, 320.0, 25)
    ps = np.linspace(0.5, 1.0, 25)
    np.testing.assert_allclose(
        _qsat_dev(torch.as_tensor(ta), torch.as_tensor(ps)).numpy(),
        _qsat_np(ta, ps), rtol=1e-14)


def test_checkpoint_absolute_step_and_chunk_rounding(setup, tmp_path):
    L, _, (ht, ot), x, start, clim = setup
    ck = str(tmp_path / "abs.npz")
    _scan(ht, L, clim, chunk=4).run(
        x, *start, ModelDate(*START), 4, checkpoint_path=ck,
        checkpoint_every=4, step0=100)
    st = load_prediction(ck)
    assert st["step"] == 104 and "x_ocean" not in st["extra"]
    # checkpoint_every rounds down to a multiple of the chunk
    _scan(ht, L, clim, chunk=4).run(
        x, *start, ModelDate(*START), 12, checkpoint_path=ck,
        checkpoint_every=9)
    assert load_prediction(ck)["step"] == 8
    with pytest.raises(ValueError):
        _scan(ht, L, clim, chunk=4).run(x, *start, ModelDate(*START), 3)


def test_precip_debias_output_only(setup):
    """precip_debias shifts ONLY the written mm; what is fed back is
    bit-identical. Both runners apply it alike."""
    L, _, (ht, ot), x, start, clim = setup
    base = _scan(ht, L, clim, chunk=4).run(x, *start, ModelDate(*START), 4)
    s = _scan(ht, L, clim, chunk=4)
    d = np.full((L.il, L.ix), 0.5)
    s.precip_debias = d
    out = s.run(x, *start, ModelDate(*START), 4)
    np.testing.assert_array_equal(out["atmo"], base["atmo"])
    eps = ht.rcfg.precip_epsilon
    base_log = np.log1p(base["precip_mm"] / eps)
    expect = eps * np.expm1(np.maximum(base_log - d, 0.0))
    np.testing.assert_allclose(out["precip_mm"], expect, rtol=1e-5,
                               atol=1e-9)
    assert np.all(out["precip_mm"] <= base["precip_mm"] + 1e-12)
    r = _runner(ht, L, clim)
    r.precip_debias = d
    per_step = r.run(convert.tensor(x, CPU), *start, ModelDate(*START), 4)
    np.testing.assert_allclose(per_step["precip_mm"].numpy(),
                               out["precip_mm"], rtol=1e-4, atol=1e-7)


def test_resume_from_either_loop_and_either_package(setup, tmp_path):
    """Chunk-boundary checkpoints and mid-week per-step checkpoints share
    one format: each loop resumes the other's, and each package the
    other's, on the uninterrupted run's tail."""
    L, (hj, oj), (ht, ot), x, start, clim = setup
    zero = np.zeros_like(clim)
    scan = _scan(ht, L, clim)
    full = scan.run(x, *start, ModelDate(*START), 8, ocean=ot,
                    sst_anom0=zero)

    def tail(res, k):
        def host(v):
            return v.numpy() if torch.is_tensor(v) else np.asarray(v)
        np.testing.assert_allclose(host(res["atmo"]), full["atmo"][k:],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(host(res["sst"]), full["sst"][k:],
                                   rtol=0, atol=1e-4)

    # the chunked loop writes at the week boundary (ocean state included)
    ck = str(tmp_path / "scan.npz")
    scan.run(x, *start, ModelDate(*START), 4, ocean=ot, sst_anom0=zero,
             checkpoint_path=ck, checkpoint_every=4)
    st = load_prediction(ck)
    assert st["step"] == 4 and int(st["extra"]["n_accum"]) == 0
    assert st["extra"]["x_ocean"].shape == (ot.ol.R, ot.params.n)
    tail(_runner(ht, L, clim).resume_from(ck, 4, device=CPU, ocean=ot), 4)
    tail(_jax_runner(hj, L, clim).resume_from(ck, 4, ocean=oj), 4)
    # ... and resumes its own, with absolute steps
    st2 = load_prediction(ck)
    again = scan.run(st2["x"], st2["atmo"], st2["logp"], st2["precip_t"],
                     st2["date"], 4, ocean=ot,
                     x_ocean=torch.as_tensor(st2["extra"]["x_ocean"]),
                     sst_anom0=st2["extra"]["sst_anom"],
                     checkpoint_path=ck, checkpoint_every=4,
                     step0=st2["step"])
    tail(again, 4)
    assert load_prediction(ck)["step"] == 8

    # the per-step runner writes mid-week: the week's sum and count go along
    ck2 = str(tmp_path / "step.npz")
    _runner(ht, L, clim).run(
        convert.tensor(x, CPU), *start, ModelDate(*START), 6, ocean=ot,
        sst_anom0=zero, checkpoint_path=ck2, checkpoint_every=6)
    st = jax_load_prediction(ck2)
    assert st["step"] == 6 and int(st["extra"]["n_accum"]) == 2
    assert st["extra"]["gv_sum"].shape == (L.gv_len,)
    tail(_runner(ht, L, clim).resume_from(ck2, 2, device=CPU, ocean=ot), 6)
    tail(_jax_runner(hj, L, clim).resume_from(ck2, 2, ocean=oj), 6)
    # a checkpoint the JAX runner wrote, resumed by the port
    ck3 = str(tmp_path / "jax.npz")
    _jax_runner(hj, L, clim).run(
        x, *start, JaxDate(*START), 6, ocean=oj, sst_anom0=zero,
        checkpoint_path=ck3, checkpoint_every=6)
    tail(_runner(ht, L, clim).resume_from(ck3, 2, device=CPU, ocean=ot), 6)

    # an old checkpoint holds the absolute fed-back SST: the anomaly against
    # the climatology at its date is recovered
    st = load_prediction(ck2)
    extra = dict(st["extra"])
    extra["sst_cur"] = clim + extra.pop("sst_anom")
    from speedyml_torch.io.checkpoint import save_prediction
    save_prediction(ck2, st["x"], st["atmo"], st["logp"], st["precip_t"],
                    st["date"], step=6, extra=extra)
    tail(_runner(ht, L, clim).resume_from(ck2, 2, device=CPU, ocean=ot), 6)


def test_upload_fields_groups_by_shape(setup):
    L, _, (ht, ot), x, start, clim = setup
    s = _scan(ht, L, clim)
    s.dtype = torch.float32
    xs = s._precompute(ModelDate(*START), 3)
    assert isinstance(xs, StepFields) and xs.sst_clim.shape == (3, L.il, L.ix)
    xs = xs._replace(fsol=np.ones((3, L.il)), zenit=np.full((3, L.il), 2.0))
    dev = s._upload_fields(xs)
    # the fields that are None stay None and go nowhere
    up = {k: v for k, v in dev._asdict().items() if v is not None}
    assert set(up) == {"sst_clim", "tisr", "fsol", "zenit"}
    assert all(v.dtype == torch.float32 for v in up.values())
    np.testing.assert_array_equal(dev.sst_clim.numpy(),
                                  clim.astype(np.float32)[None].repeat(3, 0))
    assert dev.fsol.shape == (3, L.il) and float(dev.zenit.max()) == 2.0
    # fields of one shape share one buffer: one copy per shape
    assert dev.sst_clim.untyped_storage().data_ptr() == \
        dev.tisr.untyped_storage().data_ptr()
    assert dev.fsol.untyped_storage().data_ptr() != \
        dev.tisr.untyped_storage().data_ptr()


# ----------------------------------------------------------------------
# the ML-only chunk's boundary fields on a real Speedy

def _full_fields(sp, date):
    """The 17 fields a step that ScanHybridRunner built for every model,
    ML-only ones too, before it built for an ML-only model only the two its
    step reads."""
    cs = init_coupler_state(sp.clim, date)
    rad, _, _ = fordate(sp.dy, sp.clim, cs, date)
    tisr = diurnal_tisr(date.tyear, date.ihour, sp.dy.tables.gsin,
                        sp.dy.tables.gcos, sp.config.ix)
    return dict(sst_clim=cs.sst_am, sstcl=cs.sstcl_ob, sicecl=cs.sice_am,
                ticecl=cs.tice_am, stl_am=cs.stl_am, snowd_am=cs.snowd_am,
                soilw_am=cs.soilw_am, tisr=tisr,
                **{k: rad[k] for k in ("alb_l", "alb_s", "albsfc", "snowc",
                                       "fsol", "ozupp", "ozone", "zenit",
                                       "stratz")})


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    """A float64 SPEEDY on stand-in files, its start state, and an ML-only
    model over its 1152 regions (n = n_in, a seeded small readout)."""
    sp = Speedy(ModelConfig(dtype="float64"),
                write_synthetic_boundary(str(tmp_path_factory.mktemp("bc")),
                                         4), device=CPU)
    sp.initialize(1982, 1)
    L = build_layout(radang_deg=np.degrees(np.asarray(sp.dy.tables.radang)))
    gs = extract(sp.dy, sp.state)
    atmo = torch.stack([gs.t, gs.u, gs.v,
                        torch.clamp(gs.q, min=1e-6)]).float()
    logp = gs.logp.float()
    gv0 = pack_global(L, atmo, logp, torch.zeros_like(logp),
                      torch.full_like(logp, 280.0), torch.zeros_like(logp))
    idx, tidx = L.maps(CPU)
    stz = Standardizer(in_mean=gv0[idx], in_std=torch.full((L.R, L.n_in), 5.0),
                       out_mean=gv0[tidx], out_std=torch.ones(L.R, L.n_out))
    g = torch.Generator().manual_seed(8)
    n, shifts = L.n_in, (1, 2)
    params = EsnParams(
        a_idx=((torch.arange(n)[:, None] + torch.tensor(shifts)) % n)[
            None].expand(L.R, n, len(shifts)),
        a_val=0.3 * torch.randn((L.R, n, len(shifts)), generator=g),
        win=0.5 * torch.randn((L.R, n), generator=g),
        wout=0.003 * torch.randn((L.R, L.n_out, n), generator=g),
        node_map=torch.arange(n), leakage=1.0, a_shift=shifts)
    hm = HybridModel(layout=L, params=params, stz=stz,
                     rcfg=ReservoirConfig(), ml_only=True)
    return sp, hm, torch.zeros(L.R, n), atmo, logp


@pytest.fixture
def no_window_fields(monkeypatch):
    """The window-only fields' builders raise if the chunk calls them."""
    def called(*a, **k):
        raise AssertionError("an ML-only chunk built a window-only field")
    monkeypatch.setattr(fastloop, "fordate", called)
    monkeypatch.setattr(fastloop, "init_coupler_state", called)


def test_ml_only_chunk_builds_and_uploads_only_what_its_step_reads(
        real, no_window_fields):
    sp, hm, *_ = real
    runner = ScanHybridRunner(hm, sp)
    K = 8                       # Jan 31 00 h to Feb 1 18 h
    d0 = ModelDate(1982, 1, 31, 0)
    xs = runner._precompute(d0, K)
    assert all(getattr(xs, k) is None for k in StepFields._fields
               if k not in ML_FIELDS)
    d = ModelDate(1982, 1, 31, 0)
    months = set()
    for k in range(K):
        months.add(d.imonth)
        np.testing.assert_array_equal(
            xs.sst_clim[k], init_coupler_state(sp.clim, d).sst_am)
        np.testing.assert_array_equal(
            xs.tisr[k], diurnal_tisr(d.tyear, d.ihour, sp.dy.tables.gsin,
                                     sp.dy.tables.gcos, sp.config.ix))
        d.advance_hours(hm.rcfg.timestep)
    assert months == {1, 2}
    dev = runner._upload_fields(xs)
    assert all(getattr(dev, k) is None for k in StepFields._fields
               if k not in ML_FIELDS)
    # one buffer holds the two fields
    store = dev.sst_clim.untyped_storage()
    assert store.data_ptr() == dev.tisr.untyped_storage().data_ptr()
    assert store.nbytes() == 2 * xs.sst_clim.nbytes
    assert torch.equal(dev.sst_clim, torch.from_numpy(xs.sst_clim)) and \
        torch.equal(dev.tisr, torch.from_numpy(xs.tisr))


def test_ml_only_run_bitwise_that_on_all_seventeen_fields(real):
    """The chunked ML-only run on the two fields its step reads gives
    bitwise the run on all 17, and the safety predicate sees None for the
    window-only fields."""
    sp, hm, x0, atmo, logp = real

    class Full(ScanHybridRunner):
        def _host_step_fields(self, date):
            return _full_fields(self.speedy, date)

    seen = []

    def sane(atmo2, logp2, xs):
        seen.append(xs)
        return _ml_sane(atmo2, logp2)

    K, chunks = 4, 2
    date = ModelDate(1982, 1, 31, 0)
    runner = ScanHybridRunner(hm, sp, chunk=K)
    runner._ml_safe_fn = sane
    two = runner.run(x0, atmo, logp, None, date, K * chunks, stream=True)
    full = Full(hm, sp, chunk=K).run(x0, atmo, logp, None, date, K * chunks,
                                     stream=True)
    assert two["steps_done"] == full["steps_done"] == K * chunks
    for key in ("x", "atmo_end", "logp_end", "precip_t"):
        assert torch.equal(two[key], full[key]), key
    assert two["summary"].keys() == full["summary"].keys()
    for key, v in two["summary"].items():
        np.testing.assert_array_equal(v, full["summary"][key], err_msg=key)
    assert len(seen) == K * chunks
    assert all(xs.tisr.shape == atmo.shape[-2:] and xs.sstcl is None
               and xs.fsol is None for xs in seen)
