"""The plain reference against the port at a small size on the CPU, and
both cells' runs at that size: the port in float32 against the reference
in float64 must come out correct."""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from conftest import BENCH, run_small, small_cell

CPU = torch.device("cpu")
SEED = 2_900_000_123


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    from harness import inputs

    cell = small_cell("hybrid_ens256")
    bindir = inputs.write_boundary(cell.config, SEED,
                                   str(tmp_path_factory.mktemp("bc")))
    start = inputs.Start(cell.config, bindir, CPU)
    w = inputs.make_weights(cell.config, start.L, SEED, CPU)
    return cell, bindir, start, w


def _f64(d):
    return {k: (v.double() if torch.is_tensor(v) and v.is_floating_point()
                else v) for k, v in d.items()}


def test_weights_repeat_from_the_seed(parts):
    from harness import inputs

    cell, _, start, w = parts
    again = inputs.make_weights(cell.config, start.L, SEED, CPU)
    other = inputs.make_weights(cell.config, start.L, SEED + 1, CPU)
    for k in ("a_val", "win", "wout", "x0"):
        assert torch.equal(w[k], again[k])
        assert not torch.equal(w[k], other[k])
    # every row of the adjacency sums to the spectral radius
    assert torch.allclose(w["a_val"].sum(-1), torch.tensor(0.9), atol=1e-6)


def test_exchange_matches_the_port(parts):
    """The reference's reservoir step against HybridModel.step, both in
    float64 on the same inputs."""
    from harness import program
    from reference.hybrid import ReferenceEsn
    from reference.speedy.domain.decomposition import pack_global

    cell, bindir, start, w = parts
    sp = program.speedy(cell.config, bindir, CPU)
    w64 = _f64(w)
    stz64 = _f64(start.stz)
    hm = program.hybrid_model(cell.config, sp, w64, stz64)
    ref = ReferenceEsn(w64, stz64, start.L, 0.001, 40.0)
    g = torch.Generator().manual_seed(5)
    atmo = start.atmo.double() + 0.3 * torch.randn(start.atmo.shape,
                                                   generator=g,
                                                   dtype=torch.float64)
    ss = 280.0 + torch.zeros_like(start.logp, dtype=torch.float64)
    gv = pack_global(start.L, atmo, start.logp.double(),
                     start.pr.double(), ss, 100.0 + ss)
    model_gv = gv + 0.01
    got = hm.step(w64["x0"], gv, model_gv)
    want = ref.exchange(w64["x0"], gv, model_gv)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_window_matches_the_port(parts):
    """The reference's window against SpeedyForecaster.window, float64."""
    from reference.hybrid import ReferenceHybrid
    from reference.speedy.core.calendar import ModelDate
    from reference.speedy.hybrid.state_io import GridState
    from speedyml_torch import ModelConfig
    from speedyml_torch.hybrid.forecast import SpeedyForecaster
    from speedyml_torch.hybrid.state_io import GridState as PortState
    from speedyml_torch.model import Speedy

    cell, bindir, start, w = parts
    ref = ReferenceHybrid(cell.config, bindir, w, start.stz, CPU)
    date = ModelDate(1982, 1, 2, 6)
    a = start.atmo.double()
    gs = GridState(a[0], a[1], a[2], a[3], start.logp.double())
    sst, _, _ = ref.boundary(date)
    want, want_pr, want_safe = ref.window(gs, date, sst)
    sp = Speedy(ModelConfig(dtype="float64"), bindir, device=CPU)
    fc = SpeedyForecaster(sp)
    surf, forcing = fc._surf_forcing(date, sst_hybrid=sst)
    got = fc.window(PortState(*gs), surf, forcing)
    assert bool(got.safe) == bool(want_safe)
    for name in ("t", "u", "v", "q", "logp"):
        torch.testing.assert_close(getattr(got.gs, name),
                                   getattr(want, name), rtol=0, atol=1e-9)
    torch.testing.assert_close(got.precip_mm, want_pr, rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", ["hybrid_ens256", "mlonly_loop"])
def test_small_run_is_correct(name, tmp_path):
    run, correct = run_small(name, SEED, tmp_path, seconds=1.0)
    assert correct, run.numbers
    assert run.attempted > 0 and run.failed == 0


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import reference.hybrid; "
            "import harness.inputs; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('speedyml', 'speedyml_torch', 'jax', 'jaxlib', 'flax')]; "
            "print(bad)" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
