"""Shared pieces of the harness's CPU tests: a cell's run at a size the
CPU holds (reservoirs of n = 576 nodes, a few members or chunks), driven
through the same loops and check as a run on the card."""

from __future__ import annotations

import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))

SMALL = {
    "hybrid_ens256": dict(config={"reservoir": {"nodes_per_input": 576}},
                          traffic={"members": 2, "segment_steps": 1,
                                   "check_steps": 1, "check_members": 2}),
    "mlonly_loop": dict(config={"reservoir": {"nodes_per_input": 576}},
                        traffic={"chunk": 2, "check_chunks": 1}),
}


def small_cell(name: str, root=None, size=None):
    """The cell `name` (of the checkout at `root`) at the CPU tests'
    size (`size`: a key of SMALL)."""
    from harness.cell import ROOT, Cell

    cell = Cell(name, root or ROOT)
    size = SMALL[size or name]
    cell.config = copy.deepcopy(cell.config)
    for section, kv in size["config"].items():
        cell.config[section].update(kv)
    cell.traffic = dict(cell.traffic, **size["traffic"])
    return cell


def run_small(name, seed, tmp, seconds=1.0, variant=None, root=None,
              size=None):
    """Drive one small run of `name` on the CPU through its loop and the
    check. Returns (run, correct)."""
    import torch
    from harness.cell import Run
    from harness.checks import verdict
    from harness.cli import execute

    cell = small_cell(name, root, size)
    run = Run(cell, seed, seconds, False, torch.device("cpu"), str(tmp),
              variant)
    execute(run)
    return run, verdict(run.numbers, cell.limits) and run.failed == 0


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")
