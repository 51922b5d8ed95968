"""The port's own copies of speedyml's host modules give what the originals
give on the same inputs: exact equality, since they are the same numpy code.
"""

import dataclasses
import os

import numpy as np
import pytest

from speedyml.core import calendar as jcal
from speedyml.core import config as jcfg
from speedyml.core import constants as jconst
from speedyml.core import vertical as jvert
from speedyml.coupler import anomaly as janom
from speedyml.physics import constants as jphys
from speedyml.reservoir import generate as jgen
from speedyml.transforms import tables as jtab
from speedyml_torch import convert
from speedyml_torch.core import calendar as tcal
from speedyml_torch.core import config as tcfg
from speedyml_torch.core import constants as tconst
from speedyml_torch.core import vertical as tvert
from speedyml_torch.coupler import anomaly as tanom
from speedyml_torch.physics import constants as tphys
from speedyml_torch.reservoir import generate as tgen
from speedyml_torch.transforms import tables as ttab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_fields(a, b):
    fa, fb = dataclasses.fields(a), dataclasses.fields(b)
    assert [f.name for f in fa] == [f.name for f in fb]
    for f in fa:
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("args", [(), (5, 16, 8)])
def test_tables(args):
    _assert_same_fields(jtab.build_tables(*args), ttab.build_tables(*args))


def test_gauss_legendre():
    for a, b in zip(jtab.gauss_legendre(24), ttab.gauss_legendre(24)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kx", sorted(jvert._HSG_TABLES))
def test_vertical_grid(kx):
    _assert_same_fields(jvert.make_vertical_grid(kx),
                        tvert.make_vertical_grid(kx))


@pytest.mark.parametrize("name", ["DYN", "PHYS"])
def test_constants(name):
    _assert_same_fields(getattr(jconst, name), getattr(tconst, name))


@pytest.mark.parametrize("name", ["ModelConfig", "ReservoirConfig"])
def test_config_defaults_and_conversion(name):
    jc, tc = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    # derived properties too
    for prop in ("mx", "nx", "nsteps", "delt"):
        if hasattr(jc, prop):
            assert getattr(jc, prop) == getattr(tc, prop)
    # convert builds the port's own type, field by field
    changed = dataclasses.replace(jc, **{
        "ModelConfig": dict(dtype="float64"),
        "ReservoirConfig": dict(nodes_per_input=7, ml_only=True)}[name])
    fn = {"ModelConfig": convert.model_config,
          "ReservoirConfig": convert.reservoir_config}[name]
    got = fn(changed)
    assert type(got) is getattr(tcfg, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(changed)


@pytest.mark.parametrize("start,hours", [((1982, 12, 31, 18), 12),
                                         ((1984, 2, 28, 0), 48),
                                         ((1983, 2, 28, 6), 24 * 400)])
def test_model_date(start, hours):
    """advance_hours over a year boundary, a leap day and a long stretch."""
    jd, td = jcal.ModelDate(*start), tcal.ModelDate(*start)
    for _ in range(hours // 6):
        jd.advance_hours(6)
        td.advance_hours(6)
        assert dataclasses.asdict(jd) == dataclasses.asdict(td)
        assert (jd.tmonth, jd.tyear) == (td.tmonth, td.tyear)
    if start[:3] == (1982, 12, 31):
        assert (td.iyear, td.imonth, td.iday, td.ihour) == (1983, 1, 1, 6)


@pytest.mark.parametrize("n,deg", [(40, 4), (5760, 6), (3, 6)])
def test_ring_helpers(n, deg):
    np.testing.assert_array_equal(jgen.ring_shifts(n, deg),
                                  tgen.ring_shifts(n, deg))
    a = jgen.make_ring_adjacency(np.random.default_rng(3), 2, n, deg)
    b = tgen.make_ring_adjacency(np.random.default_rng(3), 2, n, deg)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_ell_adjacency_and_win():
    """The same numpy seed gives the same draws, in the same order."""
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    for x, y in zip(jgen.make_ell_adjacency(jr, 3, 24, 4),
                    tgen.make_ell_adjacency(tr, 3, 24, 4)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(jgen.make_win(jr, 3, 24, 6, 0.5),
                                  tgen.make_win(tr, 3, 24, 6, 0.5))


def test_radius_by_lat():
    lo = np.array([-90.0, -50.0, -10.0, 40.0, 45.0])
    hi = np.array([-80.0, -40.0, 10.0, 50.0, 60.0])
    np.testing.assert_array_equal(jgen.radius_by_lat(lo, hi),
                                  tgen.radius_by_lat(lo, hi))
    np.testing.assert_array_equal(
        jgen.radius_by_lat(lo, hi, 30.0, 0.9, 0.3),
        tgen.radius_by_lat(lo, hi, 30.0, 0.9, 0.3))


@pytest.mark.parametrize("when", [(1981, 1, 1, 0), (1984, 2, 29, 18),
                                  (1979, 12, 31, 6), (2001, 7, 4, 12)])
def test_hour_calendar(when):
    """hours_since_epoch and its inverse, before and after the epoch and on
    a leap day."""
    h = jcal.hours_since_epoch(*when)
    assert tcal.hours_since_epoch(*when) == h
    assert tcal.datetime_from_hours(h) == jcal.datetime_from_hours(h) == when
    assert tcal.is_leap(when[0]) == jcal.is_leap(when[0])
    assert tcal.days_in_month(*when[:2]) == jcal.days_in_month(*when[:2])


def test_physics_params():
    _assert_same_fields(jphys.PP, tphys.PP)


@pytest.mark.parametrize("kx", sorted(jvert._HSG_TABLES))
def test_sigma_tables(kx):
    hsg = jvert.make_vertical_grid(kx).hsg
    _assert_same_fields(jphys.make_sigma_tables(hsg),
                        tphys.make_sigma_tables(hsg))


def test_fband():
    np.testing.assert_array_equal(jphys.make_fband(), tphys.make_fband())


def test_device_tables_hold_the_sigma_tables():
    """The floats and tensors the tensor physics reads are the host tables'
    values, and Python floats, not numpy scalars."""
    import torch
    st = tphys.make_sigma_tables(tvert.make_vertical_grid(8).hsg)
    dt = tphys.DeviceTables(st, torch.float64, "cpu")
    for name in ("sig", "sigl", "sigh", "dsig"):
        got = getattr(dt, name)
        assert all(type(v) is float for v in got), name
        np.testing.assert_array_equal(np.array(got), getattr(st, name))
    assert type(dt.wvi[3][1]) is float
    np.testing.assert_array_equal(np.array(dt.wvi), st.wvi)
    np.testing.assert_array_equal(dt.sig_col[:, 0, 0].numpy(), st.sig)
    np.testing.assert_array_equal(dt.grdscp_col[:, 0, 0].numpy(), st.grdscp)
    np.testing.assert_array_equal(dt.fband.numpy(), tphys.make_fband())
    assert abs(sum(dt.entr) - tphys.PP.entmax) < 1e-15


def test_shifts_from_ell():
    idx, _, shifts = tgen.make_ring_adjacency(np.random.default_rng(0), 3,
                                              40, 4)
    np.testing.assert_array_equal(tgen.shifts_from_ell(idx), shifts)
    np.testing.assert_array_equal(tgen.shifts_from_ell(idx),
                                  jgen.shifts_from_ell(idx))
    for bad in (idx + 1, np.where(idx == idx[1, 2, 3], 0, idx),
                idx[:, :0]):
        assert tgen.shifts_from_ell(bad) is None
        assert jgen.shifts_from_ell(bad) is None
    er, _ = tgen.make_ell_adjacency(np.random.default_rng(0), 3, 40, 4)
    assert tgen.shifts_from_ell(er) is None


@pytest.mark.parametrize("kw", [{}, dict(seed=3, amp=2.0, period_days=200.0,
                                         ar_std=0.5, ar_tau_days=10.0,
                                         t0=(1982, 1, 6), ramp_days=0.0)])
def test_synthetic_enso(kw):
    """The seeded SST anomaly is a pure function of (seed, date): the same
    field in both packages, bit for bit."""
    tb = ttab.build_tables()
    lat = np.degrees(tb.radang)
    lon = np.arange(tb.ix) * 360.0 / tb.ix
    fmask_s = np.random.default_rng(1).random((tb.il, tb.ix))
    np.testing.assert_array_equal(tanom.enso_pattern(lat, lon, fmask_s),
                                  janom.enso_pattern(lat, lon, fmask_s))
    je = janom.SyntheticEnso(lat, lon, fmask_s, **kw)
    te = tanom.SyntheticEnso(lat, lon, fmask_s, **kw)
    np.testing.assert_array_equal(te.ar, je.ar)
    for when in [(1981, 12, 31, 18), (1982, 2, 1, 0), (1982, 2, 9, 6),
                 (1983, 7, 4, 12), (2020, 1, 1, 0)]:
        jd, td = jcal.ModelDate(*when), tcal.ModelDate(*when)
        assert te.index(td) == je.index(jd)
        np.testing.assert_array_equal(te.sst_anom_fn(td), je.anomaly(jd))
    assert te.index(tcal.ModelDate(1981, 1, 1, 0)) == 0.0     # before t0
    assert np.abs(te.anomaly(tcal.ModelDate(1982, 6, 1, 0))).max() > 0.1


def test_apply_sst_anomaly():
    from types import SimpleNamespace
    rng = np.random.default_rng(2)

    def state():
        r = np.random.default_rng(5)
        return SimpleNamespace(sstcl_ob=280.0 + r.random((4, 6)),
                               sice_am=r.random((4, 6)),
                               tice_am=260.0 + r.random((4, 6)), sst_am=None)

    anom = rng.normal(size=(4, 6))
    a, b = state(), state()
    tanom.apply_sst_anomaly(a, anom)
    janom.apply_sst_anomaly(b, anom)
    np.testing.assert_array_equal(a.sst_am, b.sst_am)
    assert np.abs(a.sst_am - a.sstcl_ob).max() > 0.5


@pytest.mark.parametrize("perm,dims", [
    ((0, 1, 2, 3), ("Timestep", "Sigma_Level", "Lat", "Lon")),
    ((3, 1, 0, 2), ("lon", "lev", "time", "lat")),     # named, permuted
    ((3, 2, 1, 0), ("a", "b", "c", "d")),              # by the shape alone
])
def test_era_orientation(perm, dims):
    """io.era reorients a field exactly as speedyml.io.era does, and both
    refuse an ambiguous one."""
    from speedyml.io import era as jera
    from speedyml_torch.io import era as tera
    a = np.random.default_rng(3).normal(size=(5, 3, 4, 8)).astype(np.float32)
    got = tera._to_tzyx(np.transpose(a, perm), dims)
    np.testing.assert_array_equal(got, jera._to_tzyx(np.transpose(a, perm),
                                                     dims))
    np.testing.assert_array_equal(got, a)
    for era in (jera, tera):
        with pytest.raises(ValueError):
            era._to_tzyx(np.zeros((8, 3, 4, 8)), ("a", "b", "c", "d"))


def test_era_files(tmp_path):
    """The writers of both packages give the same bytes; every reader gives
    the same arrays from either file; the file names agree."""
    from speedyml.io import era as jera
    from speedyml_torch.io import era as tera
    rng = np.random.default_rng(0)
    T, kx, il, ix = 5, 3, 4, 8
    atmo = rng.normal(size=(T, 4, kx, il, ix)).astype(np.float32)
    atmo[:, 3] = np.abs(atmo[:, 3]) * 1e-2          # q in kg/kg, some > 25 g
    logp, sst, p6hr, tisr = (rng.normal(size=(T, il, ix)).astype(np.float32)
                             for _ in range(4))
    for pkg in ("j", "t"):
        d = tmp_path / pkg
        d.mkdir()
        era = jera if pkg == "j" else tera
        era.write_era_year(era.era_file_name(str(d), 1990), atmo, logp,
                           sst=sst, p6hr=p6hr)
        era.write_tisr_year(era.tisr_file_name(str(d), 1990), tisr)
    assert tera.era_file_name("x", 1990) == jera.era_file_name("x", 1990)
    assert tera.tisr_file_name("x", 1990) == jera.tisr_file_name("x", 1990)
    for name in ("era_5_y1990_regridded_mpi_fixed_var_gcc.nc",
                 "toa_incident_solar_radiation_1990_regridded_classic4.nc"):
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes(), name
    path = tera.era_file_name(str(tmp_path / "j"), 1990)
    for fn in ("read_era_year", "read_model_states"):
        got, want = getattr(tera, fn)(path), getattr(jera, fn)(path)
        assert sorted(got) == sorted(want) == ["atmo", "logp", "p6hr", "sst"]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(tera.read_sst_year(path),
                                  jera.read_sst_year(path))
    tp = tera.tisr_file_name(str(tmp_path / "t"), 1990)
    np.testing.assert_array_equal(tera.read_tisr_year(tp),
                                  jera.read_tisr_year(tp))
    got = tera.read_era_range(str(tmp_path / "t"), 1990, 1990,
                              tisr_dir=str(tmp_path / "t"))
    want = jera.read_era_range(str(tmp_path / "t"), 1990, 1990,
                               tisr_dir=str(tmp_path / "t"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_native_source_copy():
    """The port's copy of the native IO runtime is byte for byte the
    repository's native/speedy_io.cpp."""
    with open(os.path.join(REPO, "native", "speedy_io.cpp"), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "speedyml_torch", "io", "csrc",
                           "speedy_io.cpp"), "rb") as f:
        assert f.read() == want
