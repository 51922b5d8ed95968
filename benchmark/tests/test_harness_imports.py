"""What a run loads: no module whose top-level name is jax, jaxlib, flax or
speedyml (the JAX package), compared whole, so that speedyml_torch passes;
and what a run does where it cannot measure."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH

ROOT = os.path.dirname(BENCH)


def test_whole_name_comparison(monkeypatch):
    from harness.cli import loaded_forbidden

    for name in ("speedyml_torch", "speedyml_torch.hybrid", "jaxtyping",
                 "flaxen", "jax_free"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert loaded_forbidden() == []
    for name in ("speedyml", "speedyml.hybrid.ensemble", "jax.numpy",
                 "jaxlib", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert loaded_forbidden() == sorted(
        ["speedyml", "speedyml.hybrid.ensemble", "jax.numpy", "jaxlib",
         "flax.linen"])


def test_the_run_path_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import harness.cli, harness.loops.ensemble, "
            "harness.loops.chunked, harness.program; "
            "import speedyml_torch.hybrid.ensemble, "
            "speedyml_torch.hybrid.fastloop, speedyml_torch.model; "
            "from harness.cli import loaded_forbidden; "
            "print(loaded_forbidden())" % (BENCH, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "mlonly_loop",
         "--seed", "3000000019", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def _printed_a_result(out):
    for line in out.stdout.splitlines():
        try:
            json.loads(line)
            return True
        except ValueError:
            pass
    return False


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT)
    assert out.returncode != 0 and not _printed_a_result(out)
    assert "no CUDA device" in out.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", ".scratch",
                                                  "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not _printed_a_result(out)
    assert "speedyml_torch" in out.stderr


@pytest.mark.cuda
def test_a_run_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _run(ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
