"""The pace of a window, step by step, for telling whether a run's drift
follows the host or the card.

Each step (or chunk) of the window gets the host clock at its start, the
host time of the call that enqueues its work (`launch_ms`, which returns
before the card has finished), and CUDA events at the start and the end of
that call (`device_ms`: the stream's time from the step's start to its
last kernel's end). Where the host paces the loop, `launch_ms` tracks
`period_ms` and the card finishes soon after the last launch; where the
card paces it, the launches run ahead and the wait grows. Garbage
collections inside the window are timed through `gc.callbacks`.
"""

from __future__ import annotations

import gc
import statistics
import time
from collections import defaultdict

import torch


class Pace:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks = []                   # host clock at each step's start
        self.host = defaultdict(list)     # name -> host ms a step
        self.events = []                  # (start, end) CUDA events a step
        self.on = False
        self.gc_s = 0.0
        self.gc_n = 0
        self._gc_t = None

    def start(self):
        self.on = True
        gc.callbacks.append(self._gc)

    def stop(self):
        self.on = False
        if self._gc in gc.callbacks:
            gc.callbacks.remove(self._gc)

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t
            self.gc_n += 1
            self._gc_t = None

    def wrap_step(self, fn):
        """`fn` with its start marked and its call timed, on the host and
        by CUDA events, while the window runs."""
        def wrapped(*a, **k):
            if not self.on:
                return fn(*a, **k)
            t0 = time.perf_counter()
            self.marks.append(t0)
            if self.cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            out = fn(*a, **k)
            if self.cuda:
                e1.record()
                self.events.append((e0, e1))
            self.host["launch_ms"].append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapped

    def wrap_host(self, name, fn):
        """`fn` with its host time summed under `name` for the step that
        is running."""
        def wrapped(*a, **k):
            if not self.on:
                return fn(*a, **k)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            ms = 1e3 * (time.perf_counter() - t0)
            i = len(self.marks)
            h = self.host[name]
            h.extend([0.0] * (i + 1 - len(h)))
            h[i] += ms
            return out
        return wrapped

    def summary(self) -> dict:
        """Medians a step, the mean period of the window's first and second
        half, and the collections' pauses, all in ms."""
        self.stop()
        if self.cuda:
            torch.cuda.synchronize()
        periods = [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]
        out = {"steps": len(self.marks)}
        if periods:
            h = len(periods) // 2 or 1
            out["period_ms"] = statistics.median(periods)
            out["first_half_ms"] = statistics.fmean(periods[:h])
            out["second_half_ms"] = statistics.fmean(periods[h:] or
                                                     periods[:h])
        for name, v in sorted(self.host.items()):
            if v:
                out[name] = statistics.median(v)
        if self.events:
            out["device_ms"] = statistics.median(
                a.elapsed_time(b) for a, b in self.events)
        out["gc_ms"] = 1e3 * self.gc_s
        out["gc_n"] = self.gc_n
        return out
