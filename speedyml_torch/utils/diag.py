"""Diagnostics and observability (PyTorch port of speedyml/utils/diag.py).

The reference's only observability is wall-of-print logging with sentinel
regions and an RMS printout (ppo_diagns.f90:1; SURVEY.md section 5.1/5.5).
Here: structured RMS diagnostics over the spectral state, torch.profiler
named scopes for the hot phases, a NaN guard, and a trace of a block.
"""

from __future__ import annotations

import contextlib
import logging
import time

import torch

log = logging.getLogger("speedyml_torch")


def spectral_rms(state, vg_dhs=None) -> dict:
    """Global RMS of each prognostic field from spectral coefficients
    (diagns, ppo_diagns.f90: sum of |coeff|^2 with m>0 doubled).

    state: SpectralState or PrognosticFields-like with (kx, mx, 2, nx)
    tensors (pass one time level). Returns python floats.
    """
    def rms(spec):
        # real-pair layout (..., mx, 2, nx): m=0 counted once, m>0 twice
        w = torch.full((spec.shape[-3],), 2.0, dtype=spec.dtype,
                       device=spec.device)
        w[0] = 1.0
        s2 = torch.sum(spec * spec, dim=-2)        # re^2+im^2: (..., mx, nx)
        tot = torch.sum(s2 * w[:, None], dim=(-2, -1))
        return torch.sqrt(torch.mean(tot))

    out = {}
    for name in ("vor", "div", "t", "ps"):
        out[name] = float(rms(getattr(state, name)))
    if hasattr(state, "tr"):
        out["q"] = float(rms(state.tr[0] if state.tr.dim() > 4
                             else state.tr))
    return out


def _leaves(tree, path=""):
    """(path, tensor) of every tensor in nested named tuples, dicts, lists
    and tuples; paths read as jax.tree_util.keystr writes them."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, torch.as_tensor(tree)


def check_finite(tree, where: str = "") -> bool:
    """NaN/Inf sweep over a tree of tensors (one read of each); logs
    offenders."""
    ok = True
    for path, leaf in _leaves(tree):
        good = torch.isfinite(leaf)
        n_bad = int((~good).sum())
        if n_bad:
            log.error("non-finite values at %s%s (%d bad of %d)", where,
                      path, n_bad, leaf.numel())
            ok = False
    return ok


def nan_guard(x: torch.Tensor, label: str) -> torch.Tensor:
    """Replace non-finite values with 0 and report how many there were (the
    analog of the reference's IEEE_IS_NAN sentinels, mod_reservoir.f90:
    1302-1305). The count is read back to the host: one synchronisation per
    call, so keep it out of loops that must not sync."""
    good = torch.isfinite(x)
    bad = int((~good).sum())
    if bad:
        print(f"NaN guard [{label}]: {bad} non-finite", flush=True)
    return torch.where(good, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


@contextlib.contextmanager
def phase(name: str, log_time: bool = False):
    """Named profiler scope + optional wall-time logging. Shows up in
    torch.profiler traces under the given name."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if log_time:
        log.info("%s: %.3fs", name, time.perf_counter() - t0)


@contextlib.contextmanager
def profile_to(logdir: str):
    """Capture a torch.profiler trace of the enclosed block (host, and the
    card where there is one) into a Chrome-trace JSON file in logdir."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
