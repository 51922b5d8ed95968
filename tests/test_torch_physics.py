"""speedyml_torch.physics against speedyml.physics, scheme by scheme and
through `Physics.step_physics`.

Each scheme gets the same seeded numpy inputs (float64) through the JAX
function and through the port's; `step_physics` gets the same spun-up model
state, with and without the shortwave step.

Tolerances. The two sides do the same float64 arithmetic in the same order
but for the reductions and the transcendental functions (exp, sqrt, pow) of
two libraries: outputs agree to rtol 1e-12, with an absolute floor of 1e-12
of each output's largest value for entries that cancel to near zero. Integer
outputs (cloud and convection tops) and masks are exactly equal.
`step_physics` reads its fields through the spectral transforms (einsum and
matmul, summed in another order): 1e-10 of each output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.core.config import ModelConfig as JaxConfig
from speedyml.model import Speedy as JaxSpeedy
from speedyml.dynamics.state import SpectralState as JaxState
from speedyml.physics import condensation as jcond
from speedyml.physics import convection as jconv
from speedyml.physics import driver as jdrv
from speedyml.physics import humidity as jhum
from speedyml.physics import radiation as jrad
from speedyml.physics import surface as jsurf
from speedyml.physics import vdiff as jvd
from speedyml.physics.constants import PP, make_sigma_tables
from speedyml_torch import ModelConfig, convert
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.model import Speedy
from speedyml_torch.physics import condensation as tcond
from speedyml_torch.physics import convection as tconv
from speedyml_torch.physics import humidity as thum
from speedyml_torch.physics import radiation as trad
from speedyml_torch.physics import surface as tsurf
from speedyml_torch.physics import vdiff as tvd
from speedyml_torch.physics.constants import DeviceTables

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

CPU = "cpu"
KX, IL, IX = 8, 24, 32
RTOL = 1e-12
HSG = np.array([0.000, 0.050, 0.140, 0.260, 0.420, 0.600, 0.770, 0.900,
                1.000])


def tt(a, dtype=None):
    return convert.tensor(a, CPU, dtype)


def close(got, want, rtol=RTOL, name=""):
    """got (tensor) against want (jax/numpy): rtol, floored at rtol of the
    largest entry; integer and bool outputs exactly."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype.kind in "iub":
        assert got.dtype.kind == want.dtype.kind, (name, got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_allclose(
            got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300),
            err_msg=name)


def active_share(mask):
    return float(np.asarray(mask, float).mean())


@pytest.fixture(scope="module")
def tables():
    st = make_sigma_tables(HSG)
    return st, DeviceTables(st, torch.float64, CPU)


@pytest.fixture(scope="module")
def cols(tables):
    """Seeded columns (numpy float64): a warm moist lower troposphere under
    a cold dry top, humid enough in places to convect, condense and cloud,
    dry enough elsewhere not to."""
    st, _ = tables
    rng = np.random.default_rng(11)
    sig = st.sig
    psa = 1.0 + 0.05 * rng.normal(size=(IL, IX))
    psa[0, :6] = 0.7 + 0.05 * rng.uniform(size=6)     # below psmin: no conv
    warm = rng.uniform(0.0, 1.0, size=(IL, IX))       # 0 polar .. 1 tropical
    # T = Ts sigma^e: e from stable (0.17) to near the dry adiabat (0.286)
    lapse = rng.uniform(0.17, 0.28, size=(IL, IX))
    tprof = ((255.0 + 45.0 * warm)[None] * sig[:, None, None] ** lapse[None]
             + 1.0 * rng.normal(size=(KX, IL, IX)))
    ta = np.maximum(tprof, 205.0)
    # a surface inversion in a fifth of the columns (a stable surface layer)
    ta[KX - 1] -= 8.0 * (rng.uniform(size=(IL, IX)) < 0.2)
    pres = sig[:, None, None] * psa[None]
    qsat = np.asarray(jhum.qsat_gkg(jnp.asarray(ta), jnp.asarray(pres)))
    moist = rng.uniform(0.0, 1.0, size=(IL, IX))      # per-column humidity
    rh = np.clip(0.15 + 0.85 * moist[None]
                 + 0.12 * rng.normal(size=(KX, IL, IX)), 0.02, 1.1)
    rh[:2] = 0.01
    qa = rh * qsat
    phi0 = np.maximum(0.0, 300.0 * PP.gg * rng.normal(size=(IL, IX)))
    # hydrostatic-like geopotential: thickness ~ R T dln(sigma)
    dlns = np.diff(np.log(np.concatenate([sig, [1.0]])))
    phig = phi0[None] + np.cumsum((PP.rd * ta * dlns[:, None, None])[::-1],
                                  axis=0)[::-1]
    se = PP.cp * ta + phig
    ua = 8.0 * rng.normal(size=(KX, IL, IX))
    va = 5.0 * rng.normal(size=(KX, IL, IX))
    return dict(psa=psa, ta=ta, qa=qa, qsat=qsat, rh=qa / qsat, phig=phig,
                se=se, phi0=phi0, ua=ua, va=va, rng_seed=11)


def both(cols, *names):
    """The named inputs as (jax arrays, tensors)."""
    return ([jnp.asarray(cols[n]) for n in names],
            [tt(cols[n]) for n in names])


# ----------------------------------------------------------------------
# the schemes
# ----------------------------------------------------------------------
def test_qsat_rel_hum(cols):
    (ta, qa), (ta_t, qa_t) = both(cols, "ta", "qa")
    pres = HSG[1:, None, None] * cols["psa"][None]
    assert (cols["ta"] >= 273.16).mean() > 0.05      # both branches of es
    assert (cols["ta"] < 273.16).mean() > 0.05
    close(thum.qsat_gkg(ta_t, tt(pres)), jhum.qsat_gkg(ta, jnp.asarray(pres)))
    for got, want in zip(thum.rel_hum(qa_t, ta_t, tt(pres)),
                         jhum.rel_hum(qa, ta, jnp.asarray(pres))):
        close(got, want)


@pytest.fixture(scope="module")
def conv_out(tables, cols):
    st, dt = tables
    j, t = both(cols, "psa", "se", "qa", "qsat")
    return jconv.convmf(st, *j), tconv.convmf(dt, *t)


def test_convmf(conv_out):
    want, got = conv_out
    for name, g, w in zip(("itop", "cbmf", "precnv", "dfse", "dfqa"), got,
                          want):
        close(g, w, name=name)
    itop = np.asarray(want[0])
    assert got[0].dtype == torch.int32
    assert 0.05 < active_share(itop < KX) < 0.95
    # several cloud-top levels, and both the entrainment and the top branch
    assert len(np.unique(itop[itop < KX])) >= 3
    assert float(np.asarray(want[2]).max()) > 0.0


@pytest.fixture(scope="module")
def lsc_out(tables, cols, conv_out):
    st, dt = tables
    j, t = both(cols, "psa", "qa", "qsat")
    return (jcond.lscond(st, *j, conv_out[0][0]),
            tcond.lscond(dt, *t, conv_out[1][0]))


def test_lscond(lsc_out, conv_out):
    want, got = lsc_out
    for name, g, w in zip(("itop", "precls", "dtlsc", "dqlsc"), got, want):
        close(g, w, name=name)
    assert got[0].dtype == torch.int32
    assert 0.05 < active_share(np.asarray(want[1]) > 0.0) < 0.95
    # condensation lowers some tops below convection's, and not all
    lowered = np.asarray(want[0]) < np.asarray(conv_out[0][0])
    assert 0.02 < active_share(lowered) < 0.98
    # the top level never condenses
    assert float(got[3][0].abs().max()) == 0.0


@pytest.fixture(scope="module")
def cloud_out(tables, cols, conv_out, lsc_out):
    st, dt = tables
    rng = np.random.default_rng(12)
    fmask = np.clip(rng.uniform(-0.5, 1.5, size=(IL, IX)), 0.0, 1.0)
    se, phig = cols["se"], cols["phig"]
    gse = (se[KX - 2] - se[KX - 1]) / (phig[KX - 2] - phig[KX - 1])
    (qa, rh), (qa_t, rh_t) = both(cols, "qa", "rh")
    want = jrad.cloud(st, qa, rh, conv_out[0][2], lsc_out[0][1],
                      lsc_out[0][0], jnp.asarray(gse), jnp.asarray(fmask))
    got = trad.cloud(dt, qa_t, rh_t, conv_out[1][2], lsc_out[1][1],
                     lsc_out[1][0], tt(gse), tt(fmask))
    return want, got, fmask


def test_cloud(cloud_out):
    want, got, _ = cloud_out
    for name, g, w in zip(("icltop", "cloudc", "clstr", "qcloud"), got, want):
        close(g, w, name=name)
    assert got[0].dtype == torch.int32
    icltop = np.asarray(want[0])
    assert 0.05 < active_share(icltop < KX) < 0.95
    assert len(np.unique(icltop)) >= 4
    assert 0.05 < active_share(np.asarray(want[2]) > 0.0) < 0.95


@pytest.fixture(scope="module")
def sw_out(tables, cols, cloud_out):
    st, dt = tables
    rng = np.random.default_rng(13)
    lat = np.linspace(-80, 80, IL)
    sol = jrad.sol_oz(0.45, np.sin(np.deg2rad(lat)), np.cos(np.deg2rad(lat)))
    alb = rng.uniform(0.05, 0.7, size=(IL, IX))
    (psa, qa), (psa_t, qa_t) = both(cols, "psa", "qa")
    cw, cg, _ = cloud_out
    want = jrad.radsw(st, jrad.SolarFields(*map(jnp.asarray, sol)), psa, qa,
                      cw[0], cw[1], cw[2], jnp.asarray(alb))
    got = trad.radsw(dt, trad.SolarFields(*map(tt, sol)), psa_t, qa_t,
                     cg[0], cg[1], cg[2], tt(alb))
    return want, got


def test_radsw(sw_out):
    want, got = sw_out
    assert want._fields == got._fields
    for name in want._fields:
        close(getattr(got, name), getattr(want, name), name=name)
    # the polar-night rows get no sun, the others do
    tsr = np.asarray(want.tsr)
    assert tsr.max() > 200.0 and 0.0 < active_share(tsr == 0.0) < 0.5


@pytest.fixture(scope="module")
def lw_down_out(tables, cols, sw_out):
    st, dt = tables
    (ta,), (ta_t,) = both(cols, "ta")
    return (jrad.radlw_down(st, sw_out[0].tau2_lw, ta),
            trad.radlw_down(dt, sw_out[1].tau2_lw, ta_t))


def test_radlw_down(tables, lw_down_out, cols):
    want, got = lw_down_out
    for name, g, w in zip(("slrd", "dfabs", "flux", "st4a1", "st4a2"), got,
                          want):
        close(g, w, name=name)
    # the band table is read on both sides of its clipped range's interior
    t = np.round(cols["ta"])
    assert t.min() < 215 and t.max() > 295
    # temperatures that end in .5 round to even on both sides
    half = np.array([[[200.5]], [[201.5]], [[250.5]], [[299.5]]])
    np.testing.assert_array_equal(
        trad._fband_lookup(tables[1], tt(half)).numpy(),
        np.asarray(jrad._fband_lookup(jnp.asarray(half), jnp.float64)))


def test_radlw_up(tables, cols, sw_out, lw_down_out):
    st, dt = tables
    rng = np.random.default_rng(14)
    ts = cols["ta"][KX - 1] + rng.normal(1.0, 2.0, size=(IL, IX))
    fsfcu = PP.emisfc * PP.sbc * ts ** 4
    (ta,), (ta_t,) = both(cols, "ta")
    wd, gd = lw_down_out
    want = jrad.radlw_up(st, sw_out[0].tau2_lw, sw_out[0].stratc, ta,
                         jnp.asarray(ts), wd[0], jnp.asarray(fsfcu), wd[2],
                         wd[1], wd[3], wd[4])
    got = trad.radlw_up(dt, sw_out[1].tau2_lw, sw_out[1].stratc, ta_t,
                        tt(ts), gd[0], tt(fsfcu), gd[2], gd[1], gd[3], gd[4])
    for name, g, w in zip(("slr", "olr", "dfabs"), got, want):
        close(g, w, name=name)
    assert 100.0 < float(np.asarray(want[1]).mean()) < 350.0


def test_suflux(tables, cols, cloud_out):
    st, dt = tables
    rng = np.random.default_rng(15)
    fmask = cloud_out[2]
    lat = np.linspace(-80, 80, IL)
    clat = np.cos(np.deg2rad(lat))
    forog = jsurf.sflset(cols["phi0"])
    extra = dict(
        clat=clat, forog=forog, fmask=fmask,
        tland=cols["ta"][KX - 1] + rng.normal(0.0, 4.0, size=(IL, IX)),
        tsea=cols["ta"][KX - 1] + rng.normal(0.0, 4.0, size=(IL, IX)),
        swav=rng.uniform(0.0, 1.0, size=(IL, IX)),
        ssrd=rng.uniform(0.0, 400.0, size=(IL, IX)),
        slrd=rng.uniform(200.0, 420.0, size=(IL, IX)),
        alb_l=rng.uniform(0.1, 0.6, size=(IL, IX)),
        alb_s=rng.uniform(0.07, 0.6, size=(IL, IX)),
        snowc=np.clip(rng.uniform(-1.0, 1.0, size=(IL, IX)), 0.0, 1.0))
    names = ("clat", "forog", "psa", "ua", "va", "ta", "qa", "rh", "phig",
             "phi0", "fmask", "tland", "tsea", "swav", "ssrd", "slrd",
             "alb_l", "alb_s", "snowc")
    j, t = both({**cols, **extra}, *names)
    want = jsurf.suflux(st, *j)
    got = tsurf.suflux(dt, *t)
    assert want._fields == got._fields
    for name in want._fields:
        close(getattr(got, name), getattr(want, name), name=name)
    # stable and unstable surface layers, wet and dry land, both signs of
    # the land and sea temperature contrasts
    unstable = cols["ta"][KX - 1] > cols["ta"][KX - 2]
    assert 0.05 < active_share(unstable) < 0.95
    assert 0.05 < active_share(np.asarray(want.evap_l) > 0.0) < 0.999
    assert 0.05 < active_share(np.asarray(want.hfluxn_s) > 0.0) < 0.95


def test_vdifsc(tables, cols, conv_out):
    st, dt = tables
    j, t = both(cols, "ua", "va", "se", "rh", "qa", "qsat", "phig")
    icnv_j = (KX - 1) - conv_out[0][0]
    icnv_t = (KX - 1) - conv_out[1][0]
    want = jvd.vdifsc(st, *j, icnv_j)
    got = tvd.vdifsc(dt, *t, icnv_t)
    for name, g, w in zip(("ut", "vt", "tt", "qt"), got, want):
        close(g, w, name=name)
    se, qa, qsat = cols["se"], cols["qa"], cols["qsat"]
    dmse = (se[KX - 1] - se[KX - 2]) + PP.alhc * (qa[KX - 1] - qsat[KX - 2])
    assert 0.05 < active_share(dmse >= 0.0) < 0.95     # shallow convection
    assert float(np.abs(np.asarray(want[3])[2:KX - 2]).max()) > 0.0


# ----------------------------------------------------------------------
# step_physics, from a spun-up state of the full model
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Both packages' float64 model on the same stand-in boundary files; the
    port's is run two days from rest and its state handed to both."""
    bindir = write_synthetic_boundary(
        str(tmp_path_factory.mktemp("bc")), seed=3)
    jm = JaxSpeedy(JaxConfig(dtype="float64"), bindir=bindir)
    tm = Speedy(ModelConfig(dtype="float64"), bindir, device=CPU)
    tm.initialize(1982, 1)
    tm.run_days(2)
    return jm, tm


@pytest.mark.parametrize("lradsw", [True, False])
def test_step_physics(models, lradsw):
    jm, tm = models
    level = 0
    f_t = tm.state.at_level(level)
    jstate = JaxState(*(jnp.asarray(getattr(tm.state, n).numpy())
                        for n in JaxState._fields))
    jsurf_ = jdrv.SurfaceDailyState(*(np.asarray(v.numpy())
                                      for v in tm.surf))
    jrad_ = jdrv.RadCarry(*(jnp.asarray(v.numpy()) for v in tm.rad))

    step = jax.jit(lambda s, surf, rad, flag: jm.phys.step_physics(
        jm.dy, s.at_level(level), surf, rad, flag))
    want_t, want_rad, want_fx = step(jstate, jsurf_, jrad_,
                                     jnp.asarray(lradsw))
    rad_before = [v.clone() for v in tm.rad]
    got_t, got_rad, got_fx = tm.phys.step_physics(tm.dy, f_t, tm.surf,
                                                  tm.rad, lradsw)
    tol = 1e-10
    for name, g, w in zip(("du", "dv", "dtt", "dqt"), got_t, want_t):
        close(g, w, rtol=tol, name=name)
    for name in want_rad._fields:
        close(getattr(got_rad, name), getattr(want_rad, name), rtol=tol,
              name=name)
    for name in want_fx._fields:
        close(getattr(got_fx, name), getattr(want_fx, name), rtol=tol,
              name=name)
    # the carry the caller holds is never written in place; without a
    # shortwave step it is handed back as it came
    for before, now in zip(rad_before, tm.rad):
        assert torch.equal(before, now)
    if not lradsw:
        assert all(a is b for a, b in zip(got_rad, tm.rad))
    # the moist schemes are at work in this state
    assert 0.02 < active_share(np.asarray(want_fx.precnv) > 0.0) < 0.95
    assert float(np.asarray(want_fx.precls).max()) > 0.0
