"""File-based training and observed boundaries of speedyml_torch against
speedyml, on the synthetic ERA-schema tree of tests/test_era_training.py
(12x8 grid, 2 levels, two "years" of 24 six-hourly records).

Tolerances:
  * what is read from the files (load_era_training, ObservedBoundary): exact;
    the packed series within two float32 ulps (numpy's and torch's float32
    log1p of the precipitation differ by one ulp in a few cells);
  * train_from_era, hybrid and ML-only, without training noise (the
    packages draw it from different generators): readouts within 5%
    relative Frobenius distance per region (float32 normal equations summed
    in another order, amplified by the ill-conditioned solve; see
    tests/test_torch_training.py);
  * the per-step runner on an ObservedBoundary, one model's weights in
    both packages: 2e-4 of each field's range, as tests/test_torch_slice.py
    holds a step (float32 readout sums in another order), and the SST it
    uses equal to the file's at each step's date.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from speedyml.core.calendar import ModelDate as JaxDate
from speedyml.core.config import ReservoirConfig as JaxRcfg
from speedyml.domain.decomposition import build_layout
from speedyml.hybrid import era_training as jet
from speedyml.hybrid import experiment as jexp
from speedyml.io import era as jera
from speedyml_torch import ModelDate, ObservedBoundary, convert
from speedyml_torch.hybrid import era_training as tet
from speedyml_torch.hybrid.experiment import HybridRunner
from tests.test_era_training import IL, IX, KX, T_PER_YEAR, _make_year

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

CPU = "cpu"
YEARS = (1990, 1991)


@pytest.fixture(scope="module")
def era_tree(tmp_path_factory):
    """Truth year files with SST and p6hr, TISR companions, and the model
    states (the truth shifted and damped) in q of g/kg, as read_model_states
    hands them on unconverted."""
    root = tmp_path_factory.mktemp("era")
    era_dir, model_dir, bare = (str(root / d) for d in ("era", "model",
                                                         "bare"))
    for d in (era_dir, model_dir, bare):
        os.makedirs(d)
    rng = np.random.default_rng(7)
    for y in YEARS:
        atmo, logp, sst, precip, tisr = _make_year(rng)
        jera.write_era_year(jera.era_file_name(era_dir, y), atmo, logp,
                            sst=sst, p6hr=precip)
        jera.write_tisr_year(jera.tisr_file_name(era_dir, y), tisr)
        m_atmo = np.roll(atmo, 1, axis=0) * 0.98
        m_atmo[:, 3] *= 1000.0
        jera.write_era_year(os.path.join(model_dir, f"restart_6hour_y{y}.nc"),
                            m_atmo, np.roll(logp, 1, axis=0) * 0.98,
                            p6hr=np.roll(precip, 1, axis=0))
        shutil.copy(jera.era_file_name(era_dir, y),
                    jera.era_file_name(bare, y))
    return era_dir, model_dir, bare


def _layout():
    return build_layout(ix=IX, il=IL, kx=KX, resx=2, resy=2, overlap=1)


def _rcfg(L):
    return JaxRcfg(nodes_per_input=2 * L.n_in, degree=4, noise_std=0.0,
                   discardlength=24, synclength=24)


def _lat():
    lat = np.deg2rad(np.linspace(-80, 80, IL))
    return dict(slat=np.sin(lat), clat=np.cos(lat))


@pytest.mark.parametrize("case", ["files", "bare"])
def test_load_era_training(era_tree, case):
    """Truth (with TISR files, or the analytic cycle where none exist) and
    model states, read by both packages: equal, on the asked device."""
    era_dir, model_dir, bare = era_tree
    kw = dict(model_dir=model_dir) if case == "files" else _lat()
    path = era_dir if case == "files" else bare
    want = jet.load_era_training(path, *YEARS, **kw)
    got = tet.load_era_training(path, *YEARS, device=CPU, **kw)
    for f in want.truth._fields:
        w = np.asarray(getattr(want.truth, f))
        g = getattr(got.truth, f)
        g = g.numpy() if torch.is_tensor(g) else g
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.truth.atmo.shape[0] == 2 * T_PER_YEAR
    for f in ("model_atmo", "model_logp", "model_precip"):
        w, g = getattr(want, f), getattr(got, f)
        if case == "bare":
            assert w is None and g is None
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f)


def _case(era_tree, case):
    era_dir, model_dir, bare = era_tree
    if case == "hybrid":
        return era_dir, dict(model_dir=model_dir, seed=0)
    return bare, dict(seed=1, **_lat())     # no TISR files, no model states


@pytest.fixture(scope="module")
def jax_ml_only(era_tree):
    """The JAX package's ML-only train_from_era, trained once for the two
    tests that read it."""
    path, kw = _case(era_tree, "ml_only")
    return jet.train_from_era(_layout(), _rcfg(_layout()), path, *YEARS,
                              **kw)


@pytest.mark.parametrize("case", ["hybrid", "ml_only"])
def test_train_from_era(era_tree, jax_ml_only, case):
    L = _layout()
    rcfg = _rcfg(L)
    path, kw = _case(era_tree, case)
    hj, dj, gj = jax_ml_only if case == "ml_only" else \
        jet.train_from_era(L, rcfg, path, *YEARS, **kw)
    ht, dt, gt = tet.train_from_era(convert.region_layout(L),
                                    convert.reservoir_config(rcfg), path,
                                    *YEARS, device=CPU, **kw)
    assert ht.ml_only == hj.ml_only == (case == "ml_only")
    # float32 log1p of the precipitation, one ulp apart here and there
    np.testing.assert_allclose(gt.numpy(), gj, rtol=2.4e-7, atol=0)
    wj, wt = np.asarray(hj.params.wout), ht.params.wout.numpy()
    assert wt.shape == wj.shape and np.isfinite(wt).all()
    rel = (np.linalg.norm((wt - wj).reshape(L.R, -1), axis=1)
           / np.linalg.norm(wj.reshape(L.R, -1), axis=1))
    assert rel.max() < 0.05, rel.max()


@pytest.fixture(scope="module")
def boundaries(era_tree):
    era_dir = era_tree[0]
    return (jera.ObservedBoundary(era_dir, *YEARS, tisr_dir=era_dir),
            ObservedBoundary(era_dir, *YEARS, tisr_dir=era_dir))


def test_observed_boundary(era_tree, boundaries):
    """SST and TISR by date, exactly the JAX package's; a date outside the
    loaded years and a missing year file raise in both."""
    jo, to = boundaries
    for when in [(1990, 1, 1, 0), (1990, 1, 3, 18), (1990, 1, 6, 18),
                 (1990, 1, 9, 6), (1990, 1, 12, 18)]:
        np.testing.assert_array_equal(to.sst_fn(ModelDate(*when)),
                                      jo.sst_fn(JaxDate(*when)))
        np.testing.assert_array_equal(to.tisr_fn(ModelDate(*when)),
                                      jo.tisr_fn(JaxDate(*when)))
    # the files hold 6 days a "year" and are served by date from 1 January
    # of the first: record 24, the second file's first, is 1990-01-07 00h
    np.testing.assert_array_equal(to.sst_fn(ModelDate(1990, 1, 7, 0)),
                                  to.sst[T_PER_YEAR])
    for ob, date in ((jo, JaxDate(1990, 1, 13, 0)),
                     (to, ModelDate(1990, 1, 13, 0))):
        with pytest.raises(IndexError):
            ob.sst_fn(date)
    with pytest.raises(FileNotFoundError):
        ObservedBoundary(era_tree[0], 1990, 1992)


def test_runner_on_observed_boundary(era_tree, boundaries, jax_ml_only):
    """The JAX ML-only model trained from the files, in both packages'
    per-step runner, fed the observed SST and TISR of the files: two steps
    agree, and the SST each step packs is the file's at that step's date."""
    jo, to = boundaries
    L = _layout()
    hj, _, gv = jax_ml_only
    ht = convert.hybrid_model(hj, CPU)
    i0 = 30                                   # 1990-01-08 12h
    start = JaxDate(1990, 1, 8, 12)
    atmo = gv[i0, :4 * KX * IL * IX].reshape(4, KX, IL, IX)

    def field(name):
        s0, s1 = L.gv_sizes[name]
        return gv[i0, s0:s1].reshape(IL, IX)

    logp, precip_t = field("logp"), field("precip")
    jr = jexp.HybridRunner(hj, None)
    jr._sst_tisr = lambda date: (None, None)  # both come from the files
    want = jr.run(hj.synchronize(gv[i0 - 8:i0]), atmo, logp, precip_t,
                  start, 2, sst_fn=jo.sst_fn, tisr_fn=jo.tisr_fn)
    got = HybridRunner(ht, None).run(
        ht.synchronize(convert.tensor(gv[i0 - 8:i0], CPU)),
        *(convert.tensor(a, CPU) for a in (atmo, logp, precip_t)),
        ModelDate(1990, 1, 8, 12), 2, sst_fn=to.sst_fn, tisr_fn=to.tisr_fn)
    assert not got["aborted"] and not want["aborted"]
    assert (got["date"].iday, got["date"].ihour) == (9, 0)
    for k in ("atmo", "logp", "precip_mm"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=2e-4 * np.ptp(w), err_msg=k)
    for k, date in enumerate((ModelDate(1990, 1, 8, 12),
                              ModelDate(1990, 1, 8, 18))):
        np.testing.assert_array_equal(got["sst"][k].numpy(),
                                      to.sst_fn(date))
        np.testing.assert_array_equal(to.sst_fn(date),
                                      jera.read_sst_year(jera.era_file_name(
                                          era_tree[0], 1991))[i0 + k - 24])
