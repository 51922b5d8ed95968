"""The check's control and faults at a small size on the CPU: with the
program's lower-precision path switched on, or with the timed path broken
underneath, a run drives through its loop and the check and `correct`
comes out false. (The exchange between chips is no fault these cells can
have: each runs on one card.)"""

from __future__ import annotations

import pytest
import torch

from conftest import run_small

SEED = 2_900_000_321


@pytest.mark.parametrize("name,variant", [("hybrid_ens256", "bf16_grid"),
                                          ("hybrid_ens256", "bf16_wout"),
                                          ("mlonly_loop", "bf16_wout")])
def test_control_is_not_correct(name, variant, tmp_path):
    run, correct = run_small(name, SEED, tmp_path, variant=variant)
    assert not correct, run.numbers


def _unchanged_ensemble(monkeypatch):
    from speedyml_torch.hybrid.ensemble import EnsembleHybrid

    def step(self, x_e, atmo_e, logp_e, pr_e, *rest):
        return (x_e, atmo_e, logp_e, pr_e,
                torch.ones(x_e.shape[0], dtype=torch.bool))
    monkeypatch.setattr(EnsembleHybrid, "step", step)


def _half_ensemble(monkeypatch):
    """The second half of the members left out: returned as they came."""
    from speedyml_torch.hybrid.ensemble import EnsembleHybrid

    orig = EnsembleHybrid.step

    def step(self, x_e, atmo_e, logp_e, pr_e, *rest):
        h = x_e.shape[0] // 2
        out = orig(self, x_e[:h], atmo_e[:h], logp_e[:h], pr_e[:h], *rest)
        return tuple(torch.cat([o, i[h:]]) for o, i in zip(
            out, (x_e, atmo_e, logp_e, pr_e,
                  torch.ones(x_e.shape[0], dtype=torch.bool))))
    monkeypatch.setattr(EnsembleHybrid, "step", step)


def _altered_ensemble(monkeypatch):
    """One grid column's temperature 1 K off where the exchange makes it."""
    from speedyml_torch.hybrid.ensemble import EnsembleHybrid

    orig = EnsembleHybrid.exchange

    def exchange(self, *a):
        x, atmo, logp, pr = orig(self, *a)
        atmo = atmo.clone()
        atmo[:, 0, :, 10, 20] += 1.0
        return x, atmo, logp, pr
    monkeypatch.setattr(EnsembleHybrid, "exchange", exchange)


def _precip_eps_ensemble(monkeypatch):
    """The window forecast's precipitation transform log1p(P / eps), and
    the clamp after the readout, with eps doubled."""
    from speedyml_torch.hybrid.ensemble import EnsembleHybrid

    orig = EnsembleHybrid.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        self.eps = 2.0 * self.eps
    monkeypatch.setattr(EnsembleHybrid, "__init__", init)


def _precip_scaled_ensemble(monkeypatch):
    """The window's summed precipitation 5% high where it is made."""
    from speedyml_torch.hybrid.forecast import SpeedyForecaster

    orig = SpeedyForecaster.window

    def window(self, *a, **k):
        res = orig(self, *a, **k)
        return res._replace(precip_mm=1.05 * res.precip_mm)
    monkeypatch.setattr(SpeedyForecaster, "window", window)


def _unpack(L, gv):
    s0, s1 = L.gv_sizes["atmo3d"]
    atmo = gv[s0:s1].reshape(L.nvars, L.kx, L.il, L.ix)
    two = [gv[slice(*L.gv_sizes[k])].reshape(L.il, L.ix)
           for k in ("logp", "precip")]
    return atmo, *two


def _unchanged_ml(monkeypatch):
    from speedyml_torch.hybrid.experiment import HybridModel

    def step(self, x, gv, model_gv=None):
        return (x, *_unpack(self.layout, gv))
    monkeypatch.setattr(HybridModel, "step", step)


def _half_ml(monkeypatch):
    """The readout of the second half of the regions left out: their
    outputs are the standardizer's means."""
    import speedyml_torch.hybrid.experiment as ex

    orig = ex.predict_step

    def predict_step(params, x, u, model_vec=None):
        x, out = orig(params, x, u, model_vec)
        out = out.clone()
        out[out.shape[0] // 2:] = 0.0
        return x, out
    monkeypatch.setattr(ex, "predict_step", predict_step)


def _altered_ml(monkeypatch):
    from speedyml_torch.hybrid.experiment import HybridModel

    orig = HybridModel.step

    def step(self, x, gv, model_gv=None):
        x, atmo, logp, pr = orig(self, x, gv, model_gv)
        atmo = atmo.clone()
        atmo[0, :, 10, 20] += 1.0
        return x, atmo, logp, pr
    monkeypatch.setattr(HybridModel, "step", step)


@pytest.mark.parametrize("name,fault", [
    ("hybrid_ens256", _unchanged_ensemble),
    ("hybrid_ens256", _half_ensemble),
    ("hybrid_ens256", _altered_ensemble),
    ("mlonly_loop", _unchanged_ml),
    ("mlonly_loop", _half_ml),
    ("mlonly_loop", _altered_ml),
], ids=["ens-unchanged", "ens-half", "ens-altered", "ml-unchanged",
        "ml-half", "ml-altered"])
def test_fault_is_not_correct(name, fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    run, correct = run_small(name, SEED, tmp_path)
    assert not correct, run.numbers


@pytest.mark.parametrize("fault", [_precip_eps_ensemble,
                                   _precip_scaled_ensemble],
                         ids=["ens-precip-eps", "ens-precip-scaled"])
def test_precip_fault_fails_precip_gap(fault, monkeypatch, tmp_path):
    """A fault in the precipitation alone, which feeds nothing else back
    within a step: `precip_gap` has to catch it by itself."""
    fault(monkeypatch)
    run, correct = run_small("hybrid_ens256", SEED, tmp_path)
    assert not correct, run.numbers
    assert run.numbers["precip_gap"] > run.cell.limits["precip_gap"], \
        run.numbers
