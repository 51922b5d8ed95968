"""Diagnostics and observability (PyTorch port of speedyml/utils/diag.py).

The reference's only observability is wall-of-print logging with sentinel
regions and an RMS printout (ppo_diagns.f90:1; SURVEY.md section 5.1/5.5).
Here: structured RMS diagnostics over the spectral state, a NaN guard, the
program's tracer (span, tracing, spans) and a trace of a block
(profile_to).

The tracer. The loops mark their layers with `span(name)`. Tracing is on
while a `tracing()` block is open or while a torch profiler records (so
under `profile_to(logdir)` the spans appear in the same timeline as the
kernels). Off, a span costs one flag check: it enters no profiler range,
reads no clock and records no CUDA event. On, a span is a host range in
the profiler's timeline and leaves a record in a bounded in-memory store
(`spans()`): its name, its id and its parent's (per thread), the loop run
it belongs to, its step or chunk index, its host start and end on the
profiler's clock (epoch nanoseconds, `time.time_ns`), with `device=True`
its device time by CUDA events on the current stream, and its counts.

    with diag.tracing():
        ens.run(x_e, atmo_e, logp_e, pr_e, date, 8)
    for r in diag.spans():
        print(r["name"], r["index"], r["host_ms"], r["device_ms"])

The range is torch's `_RecordFunctionFast`, a host range alone:
`torch.profiler.record_function` also opens a range on the device's
timeline, from the first to the last kernel launched inside it, which a
reader of the trace takes for device activity, and costs 12.4 us an entry
against 0.8 us (torch 2.11, the host of an NVIDIA H100 machine).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import logging
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler

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


# ----------------------------------------------------------------------
# The tracer (see the module's docstring).

CAPACITY = 65536        # records the store keeps; the oldest go first

_range = torch._C._profiler._RecordFunctionFast
_lock = threading.Lock()
_local = threading.local()      # per thread: open spans, open loop runs
_store = deque(maxlen=CAPACITY)
_dropped = 0
_depth = 0                      # open tracing() blocks
_ids = itertools.count(1)
_run_ids = itertools.count(1)


def _thread_list(name: str) -> list:
    """This thread's list `name` ("spans" or "runs")."""
    found = getattr(_local, name, None)
    if found is None:
        found = []
        setattr(_local, name, found)
    return found


class _NullSpan:
    """The span of a block entered while tracing was off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, name: str, n: int = 1):
        pass

    def timed_by(self, start, end):
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "id", "parent", "run", "loop", "index", "start_ns",
                 "end_ns", "counts", "_device", "_events", "_device_ms",
                 "_range")

    def __init__(self, name, device, index, run):
        self.name = name
        self.index = index
        self.run, self.loop = run if run is not None else current_run()
        self._device = device and torch.cuda.is_initialized()
        self._events = None
        self._device_ms = None
        self.counts = {}

    def __enter__(self):
        stack = _thread_list("spans")
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        if self.index is None and parent is not None:
            self.index = parent.index
        self._range = _range(self.name)
        self._range.__enter__()
        if self._device:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self.start_ns = time.time_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._device:
            self._events[1].record()
        _thread_list("spans").pop()
        self._range.__exit__(*exc)
        _keep(self)
        return False

    def count(self, name: str, n: int = 1):
        """Add n to this span's count `name`."""
        self.counts[name] = self.counts.get(name, 0) + n

    def timed_by(self, start, end):
        """Take this span's device time from the caller's own pair of
        recorded CUDA events."""
        self._events = (start, end)

    def record(self) -> dict:
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return dict(name=self.name, id=self.id, parent=self.parent,
                    run=self.run, loop=self.loop, index=self.index,
                    start_ns=self.start_ns, end_ns=self.end_ns,
                    host_ms=1e-6 * (self.end_ns - self.start_ns),
                    device_ms=self._device_ms, counts=dict(self.counts))


def _keep(rec: _Span):
    global _dropped
    with _lock:
        if len(_store) == _store.maxlen:
            _dropped += 1
        _store.append(rec)


def span(name: str, device: bool = False, index=None, run=None):
    """A context manager that makes the block one span named `name`.

    device: also time the block on the device by CUDA events on the current
    stream (where CUDA is in use). index: the step or chunk the block
    belongs to (by default its parent span's). run: the (run id, loop name)
    of `current_run()`, for a block that another thread runs on that run's
    behalf. Entering it gives the span, whose `count(name, n)` and
    `timed_by(start, end)` do nothing when tracing is off."""
    if not (_depth or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, device, index, run)


def count(name: str, n: int = 1):
    """Add n to the count `name` of this thread's innermost open span that
    keeps a record (none while tracing is off)."""
    stack = _thread_list("spans")
    if stack:
        stack[-1].count(name, n)


def loop(name: str):
    """Decorator of a loop's run method: each call is one run of the loop
    `name`, with an id of its own that the spans opened inside it carry.
    The id is taken whether or not tracing is on, so that a call inside
    which tracing starts still groups its spans."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            runs = _thread_list("runs")
            runs.append((next(_run_ids), name))
            try:
                return fn(*args, **kwargs)
            finally:
                runs.pop()
        return run
    return wrap


def current_run() -> tuple:
    """(run id, loop name) of this thread's innermost loop run, or
    (None, None) outside any."""
    runs = _thread_list("runs")
    return runs[-1] if runs else (None, None)


@contextlib.contextmanager
def tracing():
    """Switch tracing on inside the block (a profiler need not run)."""
    global _depth
    with _lock:
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1


def spans() -> list:
    """The kept records, in the order the spans ended, as dicts: name, id,
    parent (its parent span's id or None), run and loop (of the loop run it
    belongs to, or None), index, start_ns and end_ns (epoch nanoseconds,
    the profiler's clock), host_ms, device_ms (None for a span timed on the
    host alone; reading it waits for the span's end on the device) and
    counts."""
    with _lock:
        return [r.record() for r in _store]


def dropped() -> int:
    """Records dropped from the full store since the last clear()."""
    return _dropped


def clear():
    """Empty the store."""
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0
