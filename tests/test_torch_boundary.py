"""The seeded stand-in boundary files, and the port's host-side copies of the
boundary reader, the climatology, the daily coupler and the solar functions
against the originals in speedyml on those files.

The copies are the same numpy code on the same float64 inputs, so every
comparison is exact (assert_array_equal) unless it says otherwise.
"""

import dataclasses
import os

import numpy as np
import pytest

from speedyml.core.calendar import ModelDate as JaxDate
from speedyml.core.config import ModelConfig as JaxConfig
from speedyml.coupler import climatology as jclim
from speedyml.coupler import daily as jdaily
from speedyml.dynamics.core import Dycore as JaxDycore
from speedyml.io import boundary as jbound
from speedyml.physics import radiation as jrad
from speedyml.physics import surface as jsurf
from speedyml_torch import ModelConfig, ModelDate, convert
from speedyml_torch.coupler import climatology as tclim
from speedyml_torch.coupler import daily as tdaily
from speedyml_torch.dynamics.core import Dycore, Forcing
from speedyml_torch.io import boundary as tbound
from speedyml_torch.io.synthetic_boundary import (synthetic_fields,
                                                  write_synthetic_boundary)
from speedyml_torch.physics import radiation as trad
from speedyml_torch.physics import surface as tsurf
from speedyml_torch.physics.constants import PP

SEED = 7
FILES = {"fort.20": 5, "fort.21": 12, "fort.22": 12, "fort.23": 12,
         "fort.24": 12, "fort.26": 36}
DATES = [(1982, 1, 1, 0), (1982, 3, 17, 6), (1983, 7, 31, 18),
         (1984, 12, 16, 12)]


@pytest.fixture(scope="module")
def bindir(tmp_path_factory):
    return write_synthetic_boundary(str(tmp_path_factory.mktemp("bc")), SEED)


@pytest.fixture(scope="module")
def clims(bindir):
    """(speedyml Climatology, the port's) from the same files."""
    jd = JaxDycore(JaxConfig(dtype="float64"))
    return (jclim.build_climatology(bindir, jd.tables.gcos, jd.tables.radang),
            tclim.build_climatology(bindir, jd.tables.gcos, jd.tables.radang))


def _same_dataclass(a, b):
    names = [f.name for f in dataclasses.fields(a)]
    assert names == [f.name for f in dataclasses.fields(b)]
    for n in names:
        np.testing.assert_array_equal(getattr(a, n), getattr(b, n), err_msg=n)


# ----------------------------------------------------------------------
# the files
# ----------------------------------------------------------------------
def test_files_have_the_record_layout(bindir):
    for name, nrec in FILES.items():
        assert os.path.getsize(os.path.join(bindir, name)) \
            == nrec * 48 * 96 * 4, name
    # rows are stored north to south: the reader's row 0 (south) is the
    # file's last row
    raw = np.fromfile(os.path.join(bindir, "fort.20"), "<f4").reshape(
        5, 48, 96)
    np.testing.assert_array_equal(
        raw[1, ::-1], synthetic_fields(SEED)["fort.20"][1].astype("<f4"))


def test_same_seed_same_bytes(bindir, tmp_path):
    again = write_synthetic_boundary(str(tmp_path / "again"), SEED)
    other = write_synthetic_boundary(str(tmp_path / "other"), SEED + 1)
    differs = False
    for name in FILES:
        with open(os.path.join(bindir, name), "rb") as f:
            ref = f.read()
        with open(os.path.join(again, name), "rb") as f:
            assert f.read() == ref, name
        with open(os.path.join(other, name), "rb") as f:
            differs |= f.read() != ref
    assert differs


def test_both_readers_read_the_same(bindir):
    for name in FILES:
        path = os.path.join(bindir, name)
        np.testing.assert_array_equal(jbound.read_boundary_records(path),
                                      tbound.read_boundary_records(path))
    jb, tb = jbound.BoundaryData(bindir), tbound.BoundaryData(bindir)
    assert sorted(vars(jb)) == sorted(vars(tb))
    for n, v in vars(jb).items():
        np.testing.assert_array_equal(v, getattr(tb, n), err_msg=n)


def test_reader_refuses_a_truncated_file(bindir, tmp_path):
    with open(os.path.join(bindir, "fort.21"), "rb") as f:
        data = f.read()
    bad = tmp_path / "fort.21"
    bad.write_bytes(data[:-4])
    with pytest.raises(ValueError):
        tbound.read_boundary_records(str(bad))


def test_fields_are_plausible(bindir):
    """What the physics needs to run for days from rest: see the module
    docstring of io/synthetic_boundary.py."""
    bd = tbound.BoundaryData(bindir)
    lat = -90.0 + (np.arange(48) + 0.5) * 3.75
    # orography: zero over sea, a few broad mountains below 4000 m
    assert bd.orog.min() == 0.0 and 1500.0 < bd.orog.max() < 4000.0
    assert (bd.orog[bd.fmask == 0.0] == 0.0).all()
    # broad: no grid step climbs half the highest peak
    assert np.abs(np.diff(bd.orog, axis=1)).max() < 0.5 * bd.orog.max()
    assert np.abs(np.diff(bd.orog, axis=0)).max() < 0.5 * bd.orog.max()
    # land fraction: pure sea, pure land, and a fractional coast on both
    # sides of both 0.1 thresholds (coupler/climatology.py:87-98)
    fm = bd.fmask
    assert fm.min() == 0.0 and fm.max() == 1.0
    assert (fm == 0.0).mean() > 0.4 and (fm == 1.0).mean() > 0.1
    for lo, hi in ((0.0, 0.1), (0.1, 0.5), (0.5, 0.9), (0.9, 1.0)):
        assert ((fm > lo) & (fm < hi)).sum() >= 10, (lo, hi)
    # albedo over land 0.1..0.45, higher toward the poles
    land = fm == 1.0
    assert 0.1 <= bd.alb0[land].min() and bd.alb0[land].max() <= 0.45
    polar = land & (np.abs(lat)[:, None] > 60)
    tropic = land & (np.abs(lat)[:, None] < 25)
    assert bd.alb0[polar].mean() > bd.alb0[tropic].mean() + 0.1
    for veg in (bd.veg_low, bd.veg_high):
        assert veg.min() >= 0.0 and veg.max() <= 1.0 and veg.max() > 0.3
    # SST 271..302 K over sea, seasonal cycle of opposite phase north/south
    sea = fm == 0.0
    sst = bd.sst12[:, sea]
    assert 270.9 < sst.min() < 272.0 and 299.0 < sst.max() < 302.5
    zonal = np.stack([np.where(sea, m, np.nan) for m in bd.sst12])
    north = np.nanmean(zonal[:, 34:40], axis=(1, 2))     # ~40-60 N
    south = np.nanmean(zonal[:, 8:14], axis=(1, 2))
    assert north[7] - north[1] > 3.0 and south[1] - south[7] > 3.0
    # sea ice in [0, 1], only where the SST climatology is near freezing
    assert bd.sice12.min() >= 0.0 and bd.sice12.max() == 1.0
    assert bd.sst12[bd.sice12 > 0.0].max() < 274.0
    # land temperature: a larger seasonal cycle than the sea's
    stl = np.stack([np.where(land, m, np.nan) for m in bd.stl12])
    stl_n = np.nanmean(stl[:, 34:40], axis=(1, 2))
    assert stl_n[6] - stl_n[0] > 2.0 * (north[7] - north[1]) > 0.0
    # snow in the winter months at high latitudes, none in the tropics
    assert bd.snowd12[0, 36:44][land[36:44]].mean() > 50.0
    assert bd.snowd12[6, 36:42][land[36:42]].max() == 0.0
    assert bd.snowd12[:, 20:28].max() == 0.0
    # soil wetness between the wilting point and field capacity over land
    for sw in (bd.swl1_12, bd.swl2_12):
        assert PP.swwil - 1e-6 <= sw[:, land].min()
        assert sw[:, land].max() <= PP.swcap + 1e-6


def test_missing_values_give_fillsf_and_forchk_work(bindir, clims):
    """The files flag the surface type a field does not describe; the
    reader zeroes the -999s, fillsf fills the kept flags from zonal means,
    forchk sets the masked-out cells. No flag survives into the model."""
    raw = {n: np.fromfile(os.path.join(bindir, n), "<f4") for n in FILES}
    assert (raw["fort.22"] <= -999).sum() > 100       # zeroed by the reader
    assert (raw["fort.24"] <= -999).sum() > 100
    bd = tbound.BoundaryData(bindir)
    for unfilled in (bd.sst12, bd.stl12):
        flagged = unfilled < 0.0
        assert flagged.sum() > 100
        # fillsf changes exactly the flagged cells, and fills all of them
        # but rows without one valid cell (the polar cap, the open ocean),
        # which it leaves to forchk
        filled = np.stack([tclim.fillsf(m) for m in unfilled])
        fillable = flagged & ~flagged.all(axis=2, keepdims=True)
        assert fillable.sum() > 100
        assert (filled[fillable] > 200.0).all()
        np.testing.assert_array_equal(filled[~flagged], unfilled[~flagged])
    _, clim = clims
    # coastal flagged cells the model reads hold filled, physical values
    coast_sst = (bd.sst12 < 0.0) & (clim.bmask_s > 0)[None]
    coast_stl = (bd.stl12 < 0.0) & (clim.bmask_l > 0)[None]
    assert coast_sst.sum() > 12 and coast_stl.sum() > 12
    assert clim.sst12[coast_sst].min() > 260.0
    assert clim.stl12[coast_stl].min() > 200.0
    for f in (clim.sst12, clim.stl12, clim.sice12, clim.snowd12,
              clim.soilw12):
        assert np.isfinite(f).all() and f.min() >= 0.0
    assert clim.sst12.min() >= 271.0 and clim.stl12.min() > 200.0
    assert (clim.sst12[:, clim.bmask_s == 0] == 273.0).all()
    assert (clim.stl12[:, clim.bmask_l == 0] == 273.0).all()
    assert 0.0 < clim.soilw12[:, clim.bmask_l > 0].max() <= 1.0


# ----------------------------------------------------------------------
# the host copies against the originals
# ----------------------------------------------------------------------
def test_build_climatology(clims):
    jc, tc = clims
    _same_dataclass(jc, tc)
    # convert carries a speedyml climatology into the port's type
    got = convert.climatology(jc)
    assert type(got) is tclim.Climatology
    _same_dataclass(jc, got)


def test_fillsf_forchk_sflset():
    rng = np.random.default_rng(0)
    sf = rng.normal(280.0, 10.0, (48, 96))
    sf[rng.uniform(size=sf.shape) < 0.2] = -99.0
    sf[5] = -99.0                              # a row with no valid cell
    np.testing.assert_array_equal(jclim.fillsf(sf), tclim.fillsf(sf))
    mask = (rng.uniform(size=sf.shape) < 0.5).astype(float)
    np.testing.assert_array_equal(jclim.forchk(mask, sf, 0, 400, 273.0),
                                  tclim.forchk(mask, sf, 0, 400, 273.0))
    phi0 = 9.81 * rng.normal(500.0, 800.0, (48, 96))
    np.testing.assert_array_equal(jsurf.sflset(phi0), tsurf.sflset(phi0))


@pytest.mark.parametrize("imon,fmon", [(1, 0.1), (1, 0.9), (6, 0.5),
                                       (12, 0.2), (12, 0.97)])
def test_forint_forin5(imon, fmon):
    for12 = np.random.default_rng(imon).normal(size=(12, 4, 5))
    np.testing.assert_array_equal(jdaily.forint(imon, fmon, for12),
                                  tdaily.forint(imon, fmon, for12))
    np.testing.assert_array_equal(jdaily.forin5(imon, fmon, for12),
                                  tdaily.forin5(imon, fmon, for12))


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("when", DATES)
def test_init_coupler_state(clims, when, hybrid):
    jc, tc = clims
    sst_hybrid = None
    if hybrid:
        # within 6 K of the climatology in most cells, beyond it in some:
        # both sides of the acceptance gate (cpl_sea.f90:38-44)
        rng = np.random.default_rng(when[1])
        base = tdaily.init_coupler_state(tc, ModelDate(*when)).sst_am
        sst_hybrid = base + rng.normal(0.0, 4.0, base.shape)
        far = np.abs(base - sst_hybrid) >= 6.0
        assert 0.02 < far.mean() < 0.5
    js = jdaily.init_coupler_state(jc, JaxDate(*when), sst_hybrid=sst_hybrid)
    ts = tdaily.init_coupler_state(tc, ModelDate(*when),
                                   sst_hybrid=sst_hybrid)
    _same_dataclass(js, ts)
    got = convert.coupler_state(js)
    assert type(got) is tdaily.CouplerState
    _same_dataclass(js, got)
    assert got.sst_am is not js.sst_am          # a copy: the coupler mutates


def test_daily_coupler_update(clims):
    """Ten days of the slab land/sea/ice models under seeded heat fluxes,
    across a month boundary."""
    jc, tc = clims
    jdate, tdate = JaxDate(1982, 1, 27, 0), ModelDate(1982, 1, 27, 0)
    js = jdaily.init_coupler_state(jc, jdate)
    ts = tdaily.init_coupler_state(tc, tdate)
    rng = np.random.default_rng(3)
    for _ in range(10):
        flux = rng.normal(0.0, 80.0, (3, 48, 96))
        jdate.advance_day()
        tdate.advance_day()
        jdaily.daily_coupler_update(jc, js, jdate, *flux)
        tdaily.daily_coupler_update(tc, ts, tdate, *flux)
        _same_dataclass(js, ts)
    assert (tdate.imonth, tdate.iday) == (2, 6)
    assert np.abs(ts.stl_lm - ts.stlcl_ob).max() > 0.1   # the slab moved


@pytest.mark.parametrize("when", DATES)
def test_fordate(bindir, clims, when):
    """fordate's surface fields and the two spectral diffusion corrections;
    the corrections come out in the layout of the JAX package's Forcing."""
    jc, tc = clims
    orog = tbound.BoundaryData(bindir).orog
    jd = JaxDycore(JaxConfig(dtype="float64"), orog=orog)
    td = Dycore(ModelConfig(dtype="float64"), orog=orog, device="cpu")
    js = jdaily.init_coupler_state(jc, JaxDate(*when))
    ts = tdaily.init_coupler_state(tc, ModelDate(*when))
    jf, jt, jq = jdaily.fordate(jd, jc, js, JaxDate(*when))
    tf, tt, tq = tdaily.fordate(td, tc, ts, ModelDate(*when))
    assert sorted(jf) == sorted(tf)
    for k in jf:
        np.testing.assert_array_equal(jf[k], tf[k], err_msg=k)
    # the host transforms of the two packages sum in another order: 1e-12
    # of the field's scale
    for a, b in ((jt, tt), (jq, tq)):
        assert a.shape == b.shape == jd.zero_forcing().tcorh.shape \
            == tuple(td.zero_forcing().tcorh.shape)
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-12 * np.abs(a).max())
    assert Forcing._fields == type(jd.zero_forcing())._fields
    assert np.abs(tt).max() > 0.0 and np.abs(tq).max() > 0.0


@pytest.mark.parametrize("tyear", [0.0, 0.21, 0.47, 0.74, 0.999])
def test_solar_functions(tyear):
    jd = JaxDycore(JaxConfig(dtype="float64"))
    slat, clat = jd.tables.gsin, jd.tables.gcos
    for a, b in zip(jrad.sol_oz(tyear, slat, clat),
                    trad.sol_oz(tyear, slat, clat)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jrad.solar(tyear, 1368.0, slat, clat),
                                  trad.solar(tyear, 1368.0, slat, clat))
    for hour in (0, 6, 13.5):
        a = jrad.diurnal_tisr(tyear, hour, slat, clat, 96)
        np.testing.assert_array_equal(
            a, trad.diurnal_tisr(tyear, hour, slat, clat, 96))
        assert a.shape == (48, 96) and a.min() == 0.0 and a.max() > 1000.0
    np.testing.assert_array_equal(
        jdaily._qsat_np(np.linspace(200, 320, 50), 0.9),
        tdaily._qsat_np(np.linspace(200, 320, 50), 0.9))
