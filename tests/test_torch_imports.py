"""speedyml_torch stands alone: it imports torch, never jax and nothing of
speedyml, directly or through what it imports (the host modules it needs
are its own copies); and its entry points build on the card by default."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "core.calendar", "core.config", "core.constants", "core.vertical",
    "transforms.tables", "device",
    "transforms.spectral", "dynamics.state", "dynamics.hdiff",
    "dynamics.implicit", "dynamics.tendencies", "dynamics.initial",
    "dynamics.core", "hybrid.state_io", "hybrid.forecast",
    "domain.decomposition", "domain.standardize", "reservoir.esn",
    "reservoir.generate", "ops.accum", "reservoir.training",
    "hybrid.experiment", "convert",
    "physics.constants", "physics.humidity", "physics.convection",
    "physics.condensation", "physics.radiation", "physics.surface",
    "physics.vdiff", "physics.driver", "io.boundary",
    "io.synthetic_boundary", "coupler.climatology", "coupler.daily", "model",
    "coupler.anomaly", "reservoir.slab", "io.checkpoint", "io.ncstream",
    "io.output", "io.weights", "hybrid.fastloop",
    "io.era", "hybrid.era_training", "hybrid.ensemble", "utils.diag",
    "utils.analysis", "utils.climate", "utils.timemean", "io.grads",
    "physics.randfor", "physics.sppt", "io.native_loader",
    "reservoir.linalg",
]

# the scripts of scripts_torch that the source scan must reach
SCRIPTS = ["accum_accuracy", "profile_slice", "analyze_forecast",
           "score_run", "decade_table", "climate_check", "enso_eval",
           "train_from_era", "reference_scale", "export_workers",
           "demo_hybrid", "diag_precip_bias", "make_precip_debias",
           "diag_wetbias", "diag_hybrid", "coupled_probe", "coupled_probe2"]

_PROBE = """
import importlib, pkgutil, sys
import speedyml_torch
names = sys.argv[1:]
for name in names:
    importlib.import_module("speedyml_torch." + name)
found = sorted(m.name for m in pkgutil.walk_packages(
    speedyml_torch.__path__, "speedyml_torch."))
for name in found:
    importlib.import_module(name)
print(len(found), [m for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "speedyml")])
"""

# an import statement that names speedyml itself (not speedyml_torch)
_IMPORTS_SPEEDYML = re.compile(
    r"^\s*(from|import)\s+speedyml(\.|\s)", re.MULTILINE)


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for top in ("speedyml_torch", "scripts_torch"):
        for root, dirs, files in os.walk(os.path.join(REPO, top)):
            dirs[:] = [d for d in dirs if d != "build"]   # build outputs
            paths += [os.path.join(root, f) for f in files
                      if f.endswith(".py")]
    return paths


def test_port_imports_no_jax():
    """After importing every module of the package, neither jax nor any
    speedyml module is loaded."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE, *SLICE_MODULES],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    count, loaded = res.stdout.strip().split(" ", 1)
    assert loaded == "[]", f"jax or speedyml was imported: {loaded}"
    # every slice module exists (the package also holds its __init__ files)
    assert int(count) >= len(SLICE_MODULES)


def test_port_sources_name_no_speedyml_import():
    """No source of the port, the smoke script included, imports speedyml
    or jax."""
    paths = _port_sources()
    assert any(p.endswith("chip_smoke.py") for p in paths)
    for name in SCRIPTS:
        assert os.path.join(REPO, "scripts_torch", name + ".py") in paths
    assert len(paths) > 20
    for path in paths:
        with open(path) as f:
            src = f.read()
        assert not _IMPORTS_SPEEDYML.search(src), path
        assert not re.search(r"^\s*(from|import)\s+jax\b", src,
                             re.MULTILINE), path


_ENTRY_POINTS = {
    "Dycore": "from speedyml_torch.dynamics.core import Dycore; Dycore()",
    "SpectralTransform": ("from speedyml_torch.transforms.spectral import "
                          "SpectralTransform; SpectralTransform()"),
    "generate_esn": ("from speedyml_torch.reservoir.generate import "
                     "generate_esn; generate_esn(0, 2, 4, 2, 2, m_target=8)"),
    "convert.tensor": ("from speedyml_torch import convert; "
                       "convert.tensor([1.0, 2.0])"),
    "Speedy": ("import tempfile; from speedyml_torch import ModelConfig; "
               "from speedyml_torch.model import Speedy; "
               "from speedyml_torch.io.synthetic_boundary import "
               "write_synthetic_boundary as w; "
               "Speedy(ModelConfig(), w(tempfile.mkdtemp()))"),
    "Physics": ("import numpy as np; "
                "from speedyml_torch.physics.driver import Physics; "
                "from speedyml_torch.physics.constants import "
                "make_sigma_tables as m; z = np.zeros((4, 8)); "
                "Physics(m(np.linspace(0, 1, 9)), np.ones(4), z, z, z)"),
    "train_ocean": ("import numpy as np; from speedyml_torch import "
                    "train_ocean, ReservoirConfig; "
                    "from speedyml_torch.domain.decomposition import "
                    "build_layout; L = build_layout(12, 6, 2); "
                    "train_ocean(L, ReservoirConfig(slab_nodes=56), "
                    "np.ones((140, L.gv_len), np.float32))"),
    "load_model": ("import os, tempfile, torch; from speedyml_torch import "
                   "load_model, save_model, ReservoirConfig; "
                   "from speedyml_torch.domain.decomposition import "
                   "build_layout; from speedyml_torch.domain.standardize "
                   "import Standardizer; from speedyml_torch.hybrid."
                   "experiment import HybridModel; from speedyml_torch."
                   "reservoir.generate import generate_esn; "
                   "L = build_layout(12, 6, 2); p = generate_esn(0, L.R, "
                   "L.n_in, L.n_out, 0, m_target=L.n_in, device='cpu'); "
                   "s = Standardizer(*(torch.ones(L.R, n) for n in "
                   "(L.n_in, L.n_in, L.n_out, L.n_out))); "
                   "path = os.path.join(tempfile.mkdtemp(), 'm.nc'); "
                   "save_model(path, HybridModel(L, p, s, ReservoirConfig(), "
                   "True)); print('saved', flush=True); load_model(path)"),
    "load_speedy_restart": ("import numpy as np, tempfile, os; "
                            "from speedyml_torch.io.checkpoint import "
                            "load_speedy_restart; "
                            "p = os.path.join(tempfile.mkdtemp(), 'r.npz'); "
                            "z = np.zeros((2, 2)); np.savez(p, spec_vor=z, "
                            "spec_div=z, spec_t=z, spec_ps=z, spec_tr=z, "
                            "date=np.array([1982, 1, 1, 0])); "
                            "load_speedy_restart(p)"),
    "FusedDataGenerator": ("import tempfile; from speedyml_torch import "
                           "FusedDataGenerator, ModelConfig; "
                           "from speedyml_torch.model import Speedy; "
                           "from speedyml_torch.io.synthetic_boundary import "
                           "write_synthetic_boundary as w; "
                           "FusedDataGenerator(Speedy(ModelConfig(), "
                           "w(tempfile.mkdtemp()))).initialize(1982, 1, 0)"),
    "train_from_era": ("import tempfile, numpy as np; from speedyml_torch "
                       "import train_from_era, ReservoirConfig; "
                       "from speedyml_torch.io import era; "
                       "from speedyml_torch.domain.decomposition import "
                       "build_layout; d = tempfile.mkdtemp(); "
                       "L = build_layout(12, 6, 2); "
                       "z = np.ones((40, 6, 12), np.float32); "
                       "era.write_era_year(era.era_file_name(d, 1990), "
                       "np.ones((40, 4, 2, 6, 12), np.float32), z, sst=z, "
                       "p6hr=z); era.write_tisr_year(era.tisr_file_name(d, "
                       "1990), z); print('written', flush=True); "
                       "train_from_era(L, ReservoirConfig(discardlength=24), "
                       "d, 1990, 1990)"),
    "init_rad_carry": ("import torch; from speedyml_torch.physics.driver "
                       "import init_rad_carry; "
                       "init_rad_carry(8, 4, 8, torch.float32)"),
    "zero_state": ("import torch; from speedyml_torch.dynamics.state "
                   "import zero_state; zero_state(8, 31, 32, 1, "
                   "torch.float32)"),
    "import_worker_files": (
        "import tempfile, torch; from speedyml_torch import ReservoirConfig; "
        "from speedyml_torch.domain.decomposition import build_layout; "
        "from speedyml_torch.domain.standardize import Standardizer; "
        "from speedyml_torch.hybrid.experiment import HybridModel; "
        "from speedyml_torch.io.weights import export_worker_files, "
        "import_worker_files; "
        "from speedyml_torch.reservoir.generate import generate_esn; "
        "L = build_layout(12, 6, 2); p = generate_esn(0, L.R, L.n_in, "
        "L.n_out, 0, m_target=L.n_in, device='cpu'); "
        "s = Standardizer(*(torch.ones(L.R, n) for n in "
        "(L.n_in, L.n_in, L.n_out, L.n_out))); d = tempfile.mkdtemp(); "
        "export_worker_files(d, HybridModel(L, p, s, ReservoirConfig(), "
        "True)); print('written', flush=True); "
        "import_worker_files(d, L, ReservoirConfig())"),
    "mldivide": ("import numpy as np; from speedyml_torch.reservoir.linalg "
                 "import mldivide; mldivide(np.eye(3), np.ones((2, 3)))"),
}


# runs every entry point's snippet in one fresh interpreter, each in a
# namespace of its own; prints {name: the traceback it raised, or None}
_ENTRY_PROBE = """
import json, sys, traceback
out = {}
for name, code in json.loads(sys.argv[1]).items():
    try:
        exec(code, {})
        out[name] = None
    except BaseException:
        out[name] = traceback.format_exc()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def entry_point_errors():
    """What each entry point raised without `device`, from one subprocess
    (a process without jax or a card: torch starts there once for all)."""
    import json
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _ENTRY_PROBE,
                          json.dumps(_ENTRY_POINTS)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_without_device_needs_the_card(name, entry_point_errors):
    """On a machine without a card an entry point called without `device`
    raises torch's own error; it does not fall back to the CPU. (With a card
    the same call succeeds and this test has nothing to show.)"""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    err = entry_point_errors[name]
    assert err is not None, f"{name} ran without a card"
    assert "cuda" in err.lower(), err[-400:]


@pytest.mark.cuda
def test_entry_points_default_to_the_card():
    """With a card, every entry point called without `device` builds there."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from speedyml_torch import convert
    from speedyml_torch.dynamics.core import Dycore
    from speedyml_torch.dynamics.hdiff import DiffusionCoefs, build_diffusion
    from speedyml_torch.reservoir.generate import generate_esn
    from speedyml_torch.transforms.spectral import SpectralTransform

    dy = Dycore()
    assert dy.device.type == "cuda" and dy.phis.is_cuda
    assert dy.imp_main.tref.is_cuda          # the implicit tables
    assert SpectralTransform().device.type == "cuda"
    assert DiffusionCoefs(build_diffusion(30, 31, 32), 2400.0).dmp.is_cuda
    p = generate_esn(0, 2, 4, 2, 2, m_target=8)
    assert all(getattr(p, f).is_cuda
               for f in ("a_idx", "a_val", "win", "wout", "node_map"))
    assert convert.tensor(np.ones(3)).is_cuda

    import tempfile
    from speedyml_torch import ModelConfig
    from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
    from speedyml_torch.model import Speedy
    with tempfile.TemporaryDirectory() as tmp:
        sp = Speedy(ModelConfig(), write_synthetic_boundary(tmp))
    assert sp.device.type == "cuda" and sp.phys.fmask1.is_cuda
    assert sp.phys.st.fband.is_cuda and sp.phys.st.sig_col.is_cuda
    sp.initialize(1982, 1)
    assert all(v.is_cuda for v in (*sp.surf, *sp.forcing, *sp.rad,
                                   *sp.state))


def test_resolve_device():
    import torch
    from speedyml_torch.device import resolve_device
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
