"""The port's files are the JAX package's files: a model, a checkpoint or a
forecast written by either package is read by the other, with equal arrays
(float32 and int32 values cross a file exactly).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.core.calendar import ModelDate as JaxDate
from speedyml.core.config import ReservoirConfig as JaxReservoirConfig
from speedyml.domain.decomposition import build_layout as jax_build_layout
from speedyml.domain.standardize import Standardizer as JaxStandardizer
from speedyml.hybrid.experiment import HybridModel as JaxHybridModel
from speedyml.io import checkpoint as jck
from speedyml.io import ncstream as jnc
from speedyml.io import output as jout
from speedyml.io import weights as jwt
from speedyml.reservoir.generate import generate_esn as jax_generate_esn
from speedyml_torch import ModelDate, convert, load_model, save_model
from speedyml_torch.dynamics.state import SpectralState
from speedyml_torch.hybrid.experiment import HybridModel
from speedyml_torch.io import checkpoint as tck
from speedyml_torch.io import ncstream as tnc
from speedyml_torch.io import output as tout

torch.set_num_threads(1)

CPU = "cpu"


def _jax_model(ml_only, topology="ring"):
    """A small JAX HybridModel with seeded random readout and statistics."""
    L = jax_build_layout(ix=12, il=6, kx=2, nvars=4, resx=2, resy=2,
                         overlap=1)
    rng = np.random.default_rng(8)
    n_model = 0 if ml_only else L.n_out
    p = jax_generate_esn(4, L.R, L.n_in, L.n_out, n_model,
                         m_target=2 * L.n_in, deg=3, topology=topology)
    p = p._replace(wout=jnp.asarray(rng.normal(size=p.wout.shape),
                                    jnp.float32))
    stz = JaxStandardizer(
        in_mean=jnp.asarray(rng.normal(size=(L.R, L.n_in)), jnp.float32),
        in_std=jnp.asarray(1.0 + rng.random((L.R, L.n_in)), jnp.float32),
        out_mean=jnp.asarray(rng.normal(size=(L.R, L.n_out)), jnp.float32),
        out_std=jnp.asarray(1.0 + rng.random((L.R, L.n_out)), jnp.float32))
    rcfg = JaxReservoirConfig(nodes_per_input=2 * L.n_in, degree=3,
                              precip_cap_mm=12.5, leakage=0.8)
    return JaxHybridModel(layout=L, params=p, stz=stz, rcfg=rcfg,
                          ml_only=ml_only)


def _to_port(hj):
    return HybridModel(layout=convert.region_layout(hj.layout),
                       params=convert.esn_params(hj.params, CPU),
                       stz=convert.standardizer(hj.stz, CPU),
                       rcfg=convert.reservoir_config(hj.rcfg),
                       ml_only=hj.ml_only)


def _same_model(ht, hj):
    assert ht.ml_only == hj.ml_only
    assert dataclasses.asdict(ht.rcfg) == dataclasses.asdict(hj.rcfg)
    for f in ("a_idx", "a_val", "win", "wout", "node_map"):
        np.testing.assert_array_equal(getattr(ht.params, f).numpy(),
                                      np.asarray(getattr(hj.params, f)), f)
    assert ht.params.leakage == hj.params.leakage
    if hj.params.a_shift is None:
        assert ht.params.a_shift is None
    else:
        assert ht.params.a_shift == tuple(
            int(s) for s in np.asarray(hj.params.a_shift))
    for f in hj.stz._fields:
        np.testing.assert_array_equal(getattr(ht.stz, f).numpy(),
                                      np.asarray(getattr(hj.stz, f)), f)
    for f in ("ix", "il", "kx", "R", "n_in", "n_out", "gv_len"):
        assert getattr(ht.layout, f) == getattr(hj.layout, f)
    np.testing.assert_array_equal(ht.layout.input_index,
                                  hj.layout.input_index)


@pytest.mark.parametrize("ml_only,topology", [(False, "ring"), (True, "er")])
def test_model_file_either_way(tmp_path, ml_only, topology):
    hj = _jax_model(ml_only, topology)
    # the JAX package writes, the port reads
    pj = str(tmp_path / "jax.nc")
    jwt.save_model(pj, hj)
    ht = load_model(pj, device=CPU)
    assert ht.params.wout.device == torch.device(CPU)
    assert ht.params.a_idx.dtype == torch.int64
    _same_model(ht, hj)
    # the port writes, the JAX package reads; and the port reads its own
    pt = str(tmp_path / "torch.nc")
    save_model(pt, _to_port(hj))
    back = jwt.load_model(pt)
    _same_model(ht, back)
    _same_model(load_model(pt, device=CPU), hj)
    # the loaded model steps as the one that was saved, bitwise
    rng = np.random.default_rng(1)
    x = convert.tensor(rng.normal(size=(hj.layout.R, ht.params.n))
                       .astype(np.float32), CPU)
    gv = convert.tensor(rng.normal(size=hj.layout.gv_len)
                        .astype(np.float32), CPU)
    mgv = None if ml_only else gv + 0.1
    for a, b in zip(ht.step(x, gv, mgv), _to_port(hj).step(x, gv, mgv)):
        assert torch.equal(a, b)


def test_model_file_bf16_readout_and_latitudes(tmp_path):
    """A bf16 readout is written as f32, exactly; radang_deg reaches the
    layout; an old file's collapsed SST std is floored on load."""
    hj = _jax_model(False)
    ht = _to_port(hj)
    s0, s1 = ht.layout.sizes["sst"]
    in_std = ht.stz.in_std.clone()
    in_std[:, s0:s1] = 1e-8
    ht16 = dataclasses.replace(
        ht, stz=ht.stz._replace(in_std=in_std),
        params=dataclasses.replace(ht.params,
                                   wout=ht.params.wout.to(torch.bfloat16)))
    path = str(tmp_path / "m.nc")
    save_model(path, ht16)
    lat = np.linspace(-80.0, 80.0, ht.layout.il)
    back = load_model(path, radang_deg=lat, device=CPU)
    assert torch.equal(back.params.wout, ht16.params.wout.float())
    assert float(back.stz.in_std[:, s0:s1].min()) == pytest.approx(0.3)
    assert back.layout.lat_region_deg[0, 0] == -80.0


def test_prediction_checkpoint_either_way(tmp_path):
    rng = np.random.default_rng(2)
    x, atmo, logp, pr = (rng.normal(size=s).astype(np.float32)
                         for s in ((5, 7), (4, 2, 6, 12), (6, 12), (6, 12)))
    extra = dict(sst_anom=rng.normal(size=(6, 12)), n_accum=3,
                 x_ocean=rng.normal(size=(3, 4)).astype(np.float32))
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tck.save_prediction(pt, torch.as_tensor(x), torch.as_tensor(atmo), logp,
                        torch.as_tensor(pr), ModelDate(1999, 12, 31, 18),
                        step=12, extra={k: torch.as_tensor(v)
                                        for k, v in extra.items()})
    jck.save_prediction(pj, x, atmo, logp, pr, JaxDate(1999, 12, 31, 18),
                        step=12, extra=extra)
    for got in (jck.load_prediction(pt), tck.load_prediction(pj),
                tck.load_prediction(pt)):
        assert got["step"] == 12
        d = got["date"]
        assert (d.iyear, d.imonth, d.iday, d.ihour) == (1999, 12, 31, 18)
        for k, v in (("x", x), ("atmo", atmo), ("logp", logp),
                     ("precip_t", pr)):
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)
        assert sorted(got["extra"]) == sorted(extra)
        for k, v in extra.items():
            np.testing.assert_array_equal(got["extra"][k], v)
    assert type(tck.load_prediction(pj)["date"]) is ModelDate
    # no precip channel, no extras; nothing but the checkpoint is left
    tck.save_prediction(pt, x, atmo, logp, None, ModelDate(1982, 1, 1, 0))
    got = jck.load_prediction(pt)
    assert got["precip_t"] is None and got["extra"] == {} \
        and got["step"] == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["j.npz", "t.npz"]


def test_speedy_restart_either_way(tmp_path):
    from speedyml.coupler.daily import CouplerState as JaxCouplerState
    rng = np.random.default_rng(3)
    shapes = dict(vor=(2, 2, 4, 2, 5), div=(2, 2, 4, 2, 5), t=(2, 2, 4, 2, 5),
                  ps=(2, 4, 2, 5), tr=(2, 1, 2, 4, 2, 5))
    state = SpectralState(**{k: torch.as_tensor(rng.normal(size=s))
                             for k, s in shapes.items()})
    names = [f.name for f in dataclasses.fields(JaxCouplerState)]
    cs = JaxCouplerState(**{n: rng.normal(size=(3, 4)) for n in names})
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tck.save_speedy_restart(pt, state, convert.coupler_state(cs),
                            ModelDate(1983, 2, 3, 6))
    jck.save_speedy_restart(
        pj, type(state)(*(v.numpy() for v in state)), cs,
        JaxDate(1983, 2, 3, 6))
    sj, cj, dj = jck.load_speedy_restart(pt)
    st, ct, dt = tck.load_speedy_restart(pj, device=CPU)
    assert (dj.iyear, dj.imonth, dj.iday, dj.ihour) == (1983, 2, 3, 6)
    assert (dt.iyear, dt.imonth, dt.iday, dt.ihour) == (1983, 2, 3, 6)
    assert type(st) is SpectralState and sorted(ct) == sorted(cj) \
        == sorted(names)
    for k in shapes:
        np.testing.assert_array_equal(getattr(sj, k),
                                      getattr(state, k).numpy())
        assert torch.equal(getattr(st, k), getattr(state, k))
    for n in names:
        np.testing.assert_array_equal(ct[n], getattr(cs, n))
        np.testing.assert_array_equal(cj[n], getattr(cs, n))


@pytest.mark.parametrize("with_sst", [False, True])
def test_forecast_file_either_way(tmp_path, with_sst):
    rng = np.random.default_rng(5)
    kx, il, ix, n = 2, 6, 12, 5
    atmo = rng.normal(size=(n, 4, kx, il, ix)).astype(np.float32)
    logp, pr, sst = (rng.normal(size=(n, il, ix)).astype(np.float32)
                     for _ in range(3))
    sigma = np.array([0.3, 0.8])
    paths = {}
    for tag, mod in (("t", tout), ("j", jout)):
        paths[tag] = str(tmp_path / f"{tag}.nc")
        with mod.ForecastWriter(paths[tag], kx, il, ix, sigma=sigma,
                                with_sst=with_sst) as w:
            for i in range(n):
                w.append(atmo[i], logp[i], precip_mm=pr[i], sst=sst[i])
    # the two writers give the same bytes
    with open(paths["t"], "rb") as a, open(paths["j"], "rb") as b:
        assert a.read() == b.read()
    for got in (jout.read_forecast(paths["t"]),
                tout.read_forecast(paths["j"])):
        for i, name in enumerate(tout.VAR3D):
            np.testing.assert_array_equal(got[name], atmo[:, i])
        np.testing.assert_array_equal(got["logp"], logp)
        np.testing.assert_array_equal(got["p6hr"], pr)
        np.testing.assert_array_equal(got["Sigma_Level"],
                                      sigma.astype(np.float32))
        assert ("SST" in got) == with_sst
        if with_sst:
            np.testing.assert_array_equal(got["SST"], sst)
        assert got["Temperature"].dtype.isnative


def test_record_appender_keeps_what_a_crash_leaves(tmp_path):
    """A writer that is never closed leaves every flushed record readable,
    and the header parser agrees with the JAX package's."""
    path = str(tmp_path / "c.nc")
    w = tout.ForecastWriter(path, 2, 3, 4)
    a = np.ones((4, 2, 3, 4), np.float32)
    for i in range(3):
        w.append(a * i, np.zeros((3, 4), np.float32),
                 precip_mm=np.zeros((3, 4), np.float32))
    got = jout.read_forecast(path)              # no close()
    assert got["Temperature"].shape == (3, 2, 3, 4)
    assert float(got["Temperature"][2].max()) == 2.0
    hj, ht = jnc._parse_header(path), tnc._parse_header(path)
    assert hj[0] == ht[0] and hj[2] == ht[2] and hj[1] == ht[1]
    with pytest.raises(AssertionError):
        w._rec.write("logp", 3, np.zeros((2, 2), np.float32))
    w.close()
    w.close()                                   # idempotent
