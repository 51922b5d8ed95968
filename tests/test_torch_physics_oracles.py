"""Quantitative per-scheme physics oracles, aimed at speedyml_torch.physics
(the closures of tests/test_physics_oracles.py on the port's functions; they
need no JAX and no boundary files but the last, which runs the full model on
the seeded stand-in boundary files).

Each test pins a conservation identity or closed-form value that a sign,
indexing, or unit error in a single scheme would break — the quantitative
complement to tests/test_physics.py's stability checks (VERDICT r1 item 5):

  * qsat vs the analytic formula + literature anchors (phy_shtorh.f90:36-56)
  * convection: column moist-static-energy + water closure (phy_convmf.f90)
  * large-scale condensation: latent heating = L * moisture sink
  * SW: TOA net input = column absorption + surface absorption
  * LW: column absorption = surface net upward - OLR
  * surface energy balance closure over sea and land (phy_suflux.f90)
  * global water budget over a multi-day full-model run: E - P = dW/dt
"""

import math

import numpy as np
import pytest
import torch

from speedyml_torch.physics.constants import (PP, DeviceTables,
                                              make_sigma_tables)

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

KX, IL, IX = 8, 6, 8
CPU = "cpu"


def tens(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _sigma_tables():
    # reference half levels (mod_dyncon1-style T30L8 distribution)
    hsg = np.array([0.000, 0.050, 0.140, 0.260, 0.420, 0.600, 0.770,
                    0.900, 1.000])
    return make_sigma_tables(hsg)


def _device_tables():
    return DeviceTables(_sigma_tables(), torch.float64, CPU)


def _columns(seed=0):
    """Physically plausible (kx, il, ix) columns."""
    rng = np.random.default_rng(seed)
    st = _sigma_tables()
    sig = st.sig
    psa = 1.0 + 0.05 * rng.normal(size=(IL, IX))
    # temperature: warm surface, cold top, small noise
    tprof = 210.0 + 85.0 * sig**0.8
    ta = (tprof[:, None, None]
          + 3.0 * rng.normal(size=(KX, IL, IX))).astype(np.float64)
    from speedyml_torch.physics.humidity import rel_hum
    pres = sig[:, None, None] * psa[None]
    rh = np.clip(0.5 + 0.35 * rng.normal(size=(KX, IL, IX)), 0.02, 1.15)
    rh[:2] = 0.01
    _, qsat = rel_hum(torch.zeros((KX, IL, IX), dtype=torch.float64),
                      tens(ta), tens(pres))
    qa = rh * qsat.numpy()
    return st, tens(psa), tens(ta), tens(qa), qsat, tens(rh)


def _heights(ta):
    """Geopotential of evenly spaced layers, 1500 m^2/s^2 apart, top first."""
    return torch.flip(torch.cumsum(torch.ones_like(ta) * 1500.0, dim=0), [0])


class TestQsat:
    def test_analytic_formula(self):
        """qsat_gkg == the August-Roche-Magnus form with SPEEDY constants,
        computed independently with math.exp (phy_shtorh.f90:36-56)."""
        from speedyml_torch.physics.humidity import qsat_gkg

        for t, p in ((300.0, 1.0), (273.16, 1.0), (250.0, 0.5),
                     (220.0, 0.2), (310.0, 1.05)):
            if t >= 273.16:
                e = 6.108e-3 * math.exp(17.269 * (t - 273.16) / (t - 35.86))
            else:
                e = 6.108e-3 * math.exp(21.875 * (t - 273.16) / (t - 7.66))
            want = 622.0 * e / (p - 0.378 * e)
            got = float(qsat_gkg(tens(t), tens(p)))
            assert abs(got - want) < 1e-6 * want, (t, p, got, want)

    def test_literature_anchors(self):
        """Magnitude anchors that catch unit errors: ~3.8 g/kg at 0C/1000hPa,
        ~22 g/kg at 300K/1000hPa (Wallace & Hobbs tables)."""
        from speedyml_torch.physics.humidity import qsat_gkg

        q0 = float(qsat_gkg(tens(273.16), tens(1.0)))
        q300 = float(qsat_gkg(tens(300.0), tens(1.0)))
        assert 3.6 < q0 < 4.0, q0
        assert 21.0 < q300 < 24.0, q300
        # monotone in T, decreasing in p
        assert q300 > q0
        assert float(qsat_gkg(tens(300.0), tens(0.8))) > q300


class TestConvectionClosure:
    def test_mse_and_water_closure(self):
        """convmf's flux differences must telescope: column water change
        = -precnv and moist static energy is conserved
        (sum dfse = alhc * precnv), phy_convmf.f90 detrainment design."""
        from speedyml_torch.physics.convection import convmf

        st, psa, ta, qa, qsat, rh = _columns(1)
        phig = _heights(ta)
        se = PP.cp * ta + phig
        itop, cbmf, precnv, dfse, dfqa = convmf(_device_tables(), psa, se,
                                                qa, qsat)
        precnv = np.asarray(precnv)
        assert precnv.max() > 0.0, "no convection triggered: test is vacuous"
        col_q = np.asarray(torch.sum(dfqa, dim=0))
        col_se = np.asarray(torch.sum(dfse, dim=0))
        scale = max(precnv.max(), 1e-12)
        np.testing.assert_allclose(col_q, -precnv, atol=1e-8 * scale)
        np.testing.assert_allclose(col_se, PP.alhc * precnv,
                                   atol=1e-8 * PP.alhc * scale)


class TestLscondClosure:
    def test_latent_heating_matches_moisture_sink(self):
        """Away from the dqmax cap, dtlsc = -(alhc/cp) dqlsc level by level,
        and precls equals the column moisture sink (phy_lscond.f90)."""
        from speedyml_torch.physics.condensation import lscond

        st, psa, ta, qa, qsat, rh = _columns(2)
        qa = qa * 1.4          # force supersaturation vs rhref somewhere
        itop0 = torch.full((IL, IX), KX, dtype=torch.int32)
        itop, precls, dtlsc, dqlsc = lscond(_device_tables(), psa, qa,
                                            qsat, itop0)
        precls = np.asarray(precls)
        assert precls.max() > 0.0, "no condensation: test is vacuous"

        # column budget: precls = -sum_k dsig*p0/g * dqlsc * psa
        pfact = st.dsig * PP.p0 / PP.gg
        want = -np.asarray(
            torch.sum(tens(pfact)[:, None, None] * dqlsc, dim=0)) \
            * np.asarray(psa)
        np.testing.assert_allclose(precls, want, rtol=1e-6,
                                   atol=1e-9 * precls.max())

        # level-wise energy consistency where the cap is slack
        dql = np.asarray(dqlsc)
        dtl = np.asarray(dtlsc)
        cap = 10.0 * st.sig[:, None, None] ** 2 \
            / (PP.trlsc * 3600.0) * np.asarray(psa) ** 2
        slack = (-dql) < 0.99 * cap
        lhs = dtl[slack]
        rhs = (PP.alhc / PP.cp) * (-dql[slack])
        np.testing.assert_allclose(lhs, rhs, rtol=1e-6, atol=1e-12)


class TestRadiationConservation:
    def _sw(self, seed=3):
        from speedyml_torch.physics.radiation import SolarFields, radsw

        st, psa, ta, qa, qsat, rh = _columns(seed)
        rng = np.random.default_rng(seed)
        lat = np.linspace(-75, 75, IL)
        slat = np.sin(np.deg2rad(lat))
        clat = np.cos(np.deg2rad(lat))
        from speedyml_torch.physics.radiation import sol_oz
        sol = sol_oz(0.4, slat, clat)
        sol = SolarFields(*(tens(f) for f in sol))
        icltop = torch.as_tensor(rng.integers(2, KX, size=(IL, IX)),
                                 dtype=torch.int32)
        cloudc = tens(rng.uniform(0, 1, size=(IL, IX)))
        clstr = tens(rng.uniform(0, 0.3, size=(IL, IX)))
        alb = tens(rng.uniform(0.05, 0.7, size=(IL, IX)))
        out = radsw(_device_tables(), sol, psa, qa, icltop, cloudc, clstr,
                    alb)
        return st, psa, ta, out

    def test_sw_column_conservation(self):
        """Net TOA input = atmospheric absorption + net surface absorption
        (every reflection/transmission in radsw must be accounted)."""
        st, psa, ta, out = self._sw()
        tsr = np.asarray(out.tsr)
        assert tsr.max() > 100.0
        lhs = tsr
        rhs = np.asarray(torch.sum(out.dfabs, dim=0)) + np.asarray(out.ssr)
        np.testing.assert_allclose(lhs, rhs, rtol=1e-6,
                                   atol=1e-6 * tsr.max())
        # absorbed SW is non-negative in every layer
        assert float(torch.min(out.dfabs)) > -1e-8 * tsr.max()

    def test_lw_column_conservation(self):
        """Column LW absorption = net surface upward LW - OLR
        (radlw down+up passes, incl. the epslw corrections)."""
        from speedyml_torch.physics.radiation import radlw_down, radlw_up

        st, psa, ta, out = self._sw(4)
        slrd, dfabs, flux_bands, st4a1, st4a2 = radlw_down(
            _device_tables(), out.tau2_lw, ta)
        ts = ta[KX - 1] + 2.0                    # a plausible skin temp
        fsfcu = PP.emisfc * PP.sbc * ts**4
        slr, olr, dfabs = radlw_up(_device_tables(), out.tau2_lw,
                                   out.stratc, ta, ts, slrd, fsfcu,
                                   flux_bands, dfabs, st4a1, st4a2)
        lhs = np.asarray(torch.sum(dfabs, dim=0))
        rhs = np.asarray(slr) - np.asarray(olr)
        scale = float(np.abs(np.asarray(olr)).max())
        assert scale > 100.0
        np.testing.assert_allclose(lhs, rhs, atol=1e-6 * scale)

    def test_olr_physical_range(self):
        """OLR magnitude anchor (Earth ~ 240 W/m2; broad band here)."""
        from speedyml_torch.physics.radiation import radlw_down, radlw_up

        st, psa, ta, out = self._sw(5)
        slrd, dfabs, flux_bands, st4a1, st4a2 = radlw_down(
            _device_tables(), out.tau2_lw, ta)
        ts = ta[KX - 1] + 1.0
        fsfcu = PP.emisfc * PP.sbc * ts**4
        _, olr, _ = radlw_up(_device_tables(), out.tau2_lw, out.stratc, ta,
                             ts, slrd, fsfcu, flux_bands, dfabs, st4a1,
                             st4a2)
        olr = np.asarray(olr)
        assert 100.0 < olr.mean() < 350.0, olr.mean()


class TestSurfaceEnergyBalance:
    def _suflux(self, fmask_val, seed=6):
        from speedyml_torch.physics.surface import sflset, suflux

        st, psa, ta, qa, qsat, rh = _columns(seed)
        rng = np.random.default_rng(seed)
        lat = np.linspace(-75, 75, IL)
        clat = tens(np.cos(np.deg2rad(lat)))
        phi0 = tens(np.maximum(
            0.0, 500.0 * PP.gg * rng.normal(size=(IL, IX))))
        forog = tens(sflset(np.asarray(phi0)))
        ua = tens(5.0 * rng.normal(size=(KX, IL, IX)))
        va = tens(5.0 * rng.normal(size=(KX, IL, IX)))
        phig = _heights(ta) + phi0[None]
        fmask = torch.full((IL, IX), fmask_val, dtype=torch.float64)
        tland = ta[KX - 1] + 1.5
        tsea = ta[KX - 1] + 0.5
        swav = torch.full((IL, IX), 0.6, dtype=torch.float64)
        ssrd = tens(rng.uniform(50, 400, size=(IL, IX)))
        slrd = tens(rng.uniform(200, 420, size=(IL, IX)))
        alb_l = torch.full((IL, IX), 0.2, dtype=torch.float64)
        alb_s = torch.full((IL, IX), 0.07, dtype=torch.float64)
        snowc = torch.zeros((IL, IX), dtype=torch.float64)
        fx = suflux(_device_tables(), clat, forog, psa, ua, va, ta, qa, rh,
                    phig, phi0, fmask, tland, tsea, swav, ssrd, slrd, alb_l,
                    alb_s, snowc)
        return fx, dict(ssrd=ssrd, slrd=slrd, alb_l=alb_l, alb_s=alb_s,
                        tland=tland, tsea=tsea)

    def test_sea_balance_closure(self):
        """hfluxn_s = SW absorbed + LW down - LW up - SHF - L*E exactly
        (phy_suflux.f90 sea branch)."""
        fx, d = self._suflux(0.0)
        slru_s = PP.emisfc * PP.sbc * np.asarray(d["tsea"]) ** 4
        want = (np.asarray(d["ssrd"]) * (1.0 - np.asarray(d["alb_s"]))
                + np.asarray(d["slrd"])
                - (slru_s + np.asarray(fx.shf_s)
                   + PP.alhc * np.asarray(fx.evap_s)))
        np.testing.assert_allclose(np.asarray(fx.hfluxn_s), want,
                                   rtol=1e-6, atol=1e-6)

    def test_land_balance_closure(self):
        """After the skin-temperature solve, the full land balance closes:
        SW + LWd - LWu - SHF - L*E - G = 0 with G = hfluxn_l (the
        linearized system is solved exactly)."""
        fx, d = self._suflux(1.0)
        resid = (np.asarray(d["ssrd"]) * (1.0 - np.asarray(d["alb_l"]))
                 + np.asarray(d["slrd"])
                 - np.asarray(fx.slru) - np.asarray(fx.shf)
                 - PP.alhc * np.asarray(fx.evap)
                 - np.asarray(fx.hfluxn_l))
        scale = float(np.asarray(d["ssrd"]).max())
        np.testing.assert_allclose(resid, 0.0, atol=1e-6 * scale)


class TestGlobalWaterBudget:
    @pytest.fixture(scope="class")
    def model(self, tmp_path_factory):
        from speedyml_torch import ModelConfig
        from speedyml_torch.io.synthetic_boundary import \
            write_synthetic_boundary
        from speedyml_torch.model import Speedy

        bindir = write_synthetic_boundary(
            str(tmp_path_factory.mktemp("bc")), seed=1)
        m = Speedy(ModelConfig(dtype="float64"), bindir, device=CPU)
        m.initialize(year=1981, month=1)
        m.run_days(2)          # leave the rest state
        return m

    def _column_water(self, m):
        """Global-mean column water [g/m^2] from the current state."""
        T = m.dy.T
        f = m.state.at_level(0)
        qg = torch.clamp(T.spec_to_grid(f.tr[0]), min=0.0)   # g/kg
        psg = torch.exp(T.spec_to_grid(f.ps))
        dsig = tens(m.st.dsig)[:, None, None]
        # q [g/kg] x column air mass [kg/m^2] = column water [g/m^2]
        w = (torch.sum(qg * dsig, dim=0) * psg * PP.p0 / PP.gg).numpy()
        wt_full = np.concatenate([m.dy.tables.wt, m.dy.tables.wt[::-1]]) / 2.0
        return float((w.mean(axis=-1) * wt_full).sum(axis=-1))

    def test_evap_minus_precip_closes(self, model):
        """Global mean E - P over 2 days matches the column-water change to
        ~15% of P (residual: spectral advection aliasing + q>=0 clamp)."""
        m = model
        wt_full = np.concatenate([m.dy.tables.wt, m.dy.tables.wt[::-1]]) / 2.0

        def gmean(g):
            return float((np.asarray(g).mean(axis=-1) * wt_full).sum(-1))

        w0 = self._column_water(m)
        ndays = 2
        e_sum, p_sum = 0.0, 0.0
        for _ in range(ndays):
            acc = m.run_day()
            e_sum += gmean(acc.evap)
            p_sum += gmean(acc.precip)
        w1 = self._column_water(m)

        seconds = ndays * 86400.0
        dw_dt = (w1 - w0) / seconds        # w is g/m^2
        e_mean = e_sum / ndays
        p_mean = p_sum / ndays
        assert p_mean > 0.0 and e_mean > 0.0
        resid = dw_dt - (e_mean - p_mean)
        assert abs(resid) < 0.15 * max(p_mean, e_mean), (
            dw_dt, e_mean, p_mean, resid)
