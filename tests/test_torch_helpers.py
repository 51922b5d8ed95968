"""The public helpers of speedyml that the port's modules lacked until now,
and speedyml_torch.utils.diag, against their speedyml originals.

The numpy and host helpers (calendar, config, spectral_radius_ell,
to_real/to_complex) are the same code and must agree exactly; zero_state
exactly; invert_precip in float64 to 1 ulp (expm1 of two libraries);
compute_stats to float32 rounding (rtol 1e-6: the same float64 means and
standard deviations reduced in another order); spectral_rms to 1e-12
relative (float64 sums in another order).
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.core import calendar as jcal
from speedyml.core import config as jcfg
from speedyml.domain import standardize as jstd
from speedyml.dynamics import state as jstate
from speedyml.hybrid import experiment as jexp
from speedyml.reservoir import generate as jgen
from speedyml.transforms import spectral as jspec
from speedyml.utils import diag as jdiag
from speedyml_torch import convert
from speedyml_torch.core import calendar as tcal
from speedyml_torch.core import config as tcfg
from speedyml_torch.domain import standardize as tstd
from speedyml_torch.dynamics import state as tstate
from speedyml_torch.hybrid import experiment as texp
from speedyml_torch.reservoir import generate as tgen
from speedyml_torch.transforms import spectral as tspec
from speedyml_torch.utils import diag as tdiag
from tests.test_hybrid import _small_layout

torch.set_num_threads(1)

CPU = "cpu"


@pytest.mark.parametrize("when", [(1982, 1, 1, 0), (1984, 3, 1, 18),
                                  (1999, 12, 31, 6)])
def test_hours_into_year_and_prediction_markers(when):
    assert tcal.hours_into_year(*when) == jcal.hours_into_year(*when)
    jm = jcal.prediction_markers(jcal.ModelDate(*when), 5, 30)
    tm = tcal.prediction_markers(tcal.ModelDate(*when), 5, 30)
    assert [dataclasses.astuple(d) for d in tm] == \
        [dataclasses.astuple(d) for d in jm]
    assert all(type(d) is tcal.ModelDate for d in tm)


def test_hybrid_config():
    jc, tc = jcfg.HybridConfig(), tcfg.HybridConfig()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert type(tc.model) is tcfg.ModelConfig
    assert type(tc.reservoir) is tcfg.ReservoirConfig


def test_spectral_radius_ell():
    rng = np.random.default_rng(2)
    idx, val = jgen.make_ell_adjacency(rng, 3, 40, 4)
    np.testing.assert_array_equal(tgen.spectral_radius_ell(idx, val, 50, 1),
                                  jgen.spectral_radius_ell(idx, val, 50, 1))


def test_to_real_to_complex():
    rng = np.random.default_rng(3)
    c = rng.normal(size=(2, 4, 5)) + 1j * rng.normal(size=(2, 4, 5))
    r = tspec.to_real(c)
    np.testing.assert_array_equal(r, jspec.to_real(c))
    np.testing.assert_array_equal(tspec.to_complex(r), jspec.to_complex(r))
    np.testing.assert_array_equal(tspec.to_complex(torch.as_tensor(r)), c)


def test_zero_state():
    j = jstate.zero_state(3, 4, 5, 2, jnp.float32)
    t = tstate.zero_state(3, 4, 5, 2, torch.float32, device=CPU)
    assert type(t) is tstate.SpectralState
    for a, b in zip(j, t):
        assert b.dtype == torch.float32 and b.device == torch.device(CPU)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_invert_precip():
    pt = np.linspace(-1.0, 9.0, 41)
    got = texp.invert_precip(torch.as_tensor(pt), 1e-3).numpy()
    want = np.asarray(jexp.invert_precip(jnp.asarray(pt), 1e-3))
    np.testing.assert_allclose(got, want, rtol=4e-16, atol=0)


def test_compute_stats():
    """The dense statistics of a gathered series, against the JAX
    compute_stats and against the port's streamed compute_stats_gv."""
    L = _small_layout()
    rng = np.random.default_rng(4)
    gv = (rng.normal(size=(30, L.gv_len)) * 3.0 + 280.0).astype(np.float32)
    inputs = gv[:, L.input_index]
    want = jstd.compute_stats(L, inputs)
    Lt = convert.region_layout(L)
    got = tstd.compute_stats(Lt, torch.as_tensor(inputs))
    streamed = tstd.compute_stats_gv(Lt, torch.as_tensor(gv))
    for a, b, c in zip(want, got, streamed):
        assert b.dtype == torch.float32 and b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
        np.testing.assert_allclose(b.numpy(), c.numpy(), rtol=1e-5)


def test_spectral_rms():
    rng = np.random.default_rng(5)
    st = jstate.SpectralState(*(jnp.asarray(rng.normal(size=s)) for s in (
        (2, 8, 31, 2, 32),) * 3 + ((2, 31, 2, 32), (2, 1, 8, 31, 2, 32))))
    want = jdiag.spectral_rms(st.at_level(0))
    got = tdiag.spectral_rms(convert.spectral_state(st, CPU).at_level(0))
    assert sorted(got) == sorted(want) == ["div", "ps", "q", "t", "vor"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12)


def test_check_finite_and_nan_guard(caplog, capsys):
    tree = {"a": torch.ones(3), "b": (torch.tensor([1.0, np.nan]),
                                      torch.zeros(2))}
    jtree = {"a": np.ones(3), "b": (np.array([1.0, np.nan]), np.zeros(2))}
    with caplog.at_level(logging.ERROR):
        assert tdiag.check_finite(tree, "w") is False
        assert jdiag.check_finite(jtree, "w") is False
    t_msg, j_msg = (r.getMessage() for r in caplog.records)
    assert t_msg == j_msg == "non-finite values at w['b'][0] (1 bad of 2)"
    assert tdiag.check_finite(tree["a"]) is True
    x = torch.tensor([1.0, np.inf, -2.0, np.nan])
    np.testing.assert_array_equal(
        tdiag.nan_guard(x, "x").numpy(),
        np.asarray(jdiag.nan_guard(jnp.asarray(x.numpy()), "x")))
    assert "NaN guard [x]: 2 non-finite" in capsys.readouterr().out


def test_phase_and_profile_to(tmp_path):
    """A phase of the program is a span: under profile_to it is a range of
    its name in the written trace and a record of the tracer."""
    tdiag.clear()
    with tdiag.profile_to(str(tmp_path)):
        with tdiag.span("scope"):
            torch.ones(4).add_(1.0)
    with tdiag.span("untraced"):
        pass
    assert [r["name"] for r in tdiag.spans()] == ["scope"]
    tdiag.clear()
    traces = list(tmp_path.iterdir())
    assert len(traces) == 1 and traces[0].name.endswith(".json")
    assert '"scope"' in traces[0].read_text()
