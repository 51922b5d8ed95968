"""The profiler's view of a traced slice: device busy time, idle gaps and
what the host did in them, and device time by kernel name.

The arithmetic follows the program's own profiling script
(scripts_torch/profile_slice.py): torch.profiler with CPU and CUDA
activities over a short steady slice. Here the busy time is the union of
the device's activity intervals (kernels, copies, sets), so overlapping
streams are not counted twice, and each idle gap is put down to the
innermost host operation that was running at its middle ("python" where
none was).
"""

from __future__ import annotations

import heapq
import sys
import time
from collections import Counter

NAME_CHARS = 120       # kernel and host-operation names are cut to this


def profiled(fn, host: bool):
    """Run fn(start) under torch.profiler: fn calls start() where the
    reading begins; the reading ends when fn returns and the device has
    finished. Returns the profiler. With host=False only the device's
    activity is recorded: recording every host operation about doubles a
    launch-bound host's time and so widens the device's idle gaps, so the
    busy share is read from such a slice and the host's part in the gaps
    from a second one with host=True."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    prof = profile(activities=acts)
    fn(prof.start)
    torch.cuda.synchronize()
    prof.stop()
    return prof


def read_slices(fn) -> dict:
    """Profile fn(start) twice (see profiled()): once for the device alone
    (busy_s, window_s, time by kernel), once with the host's operations
    (the idle gaps by what the host was doing)."""
    dev = _timed("device", lambda: profiled(fn, False))
    host = _timed("host", lambda: profiled(fn, True))
    if dev is None or host is None:
        return None
    dev["gaps"], dev["idle_gaps"] = host["gaps"], host["idle_gaps"]
    return dev


def _timed(name, run):
    """summarize(run()), with the seconds the slice took to run and to be
    read on standard error."""
    t0 = time.perf_counter()
    prof = run()
    t1 = time.perf_counter()
    out = summarize(prof)
    print(f"trace {name} slice: ran {t1 - t0:.1f} s, read "
          f"{time.perf_counter() - t1:.1f} s", file=sys.stderr)
    return out


def _intervals(prof):
    """(start_us, end_us, name) lists of the device's and the host's
    events, read from the profiler's raw results: building its parsed
    event tree takes minutes for the ~10^5 launches of a window."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name())
        if e.device_type() == DeviceType.CUDA:
            dev.append(row)
        elif e.device_type() == DeviceType.CPU:
            host.append(row)
    return dev, host


def summarize(prof, top: int = 10) -> dict:
    """busy_s, window_s, kernels {name: s}, gaps {name: s} and the top
    entries of each, over the slice from its first event to its last."""
    dev, host = _intervals(prof)
    return summarize_intervals(dev, host, top)


def summarize_intervals(dev, host, top=10) -> dict:
    """summarize() on (start_us, end_us, name) lists of device and host
    events."""
    if not dev:
        return None
    t0 = min(min(d[0] for d in dev), min((h[0] for h in host),
                                           default=dev[0][0]))
    t1 = max(max(d[1] for d in dev), max((h[1] for h in host), default=0))
    kernels = Counter()
    spans = []
    for s, e, name in dev:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            kernels[name] += (e - s) * 1e-6
            spans.append((s, e))
    spans.sort()
    busy = 0.0
    gaps = []
    cur_s, cur_e = None, None
    prev_end = t0
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > prev_end:
                gaps.append((prev_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        prev_end = max(prev_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if t1 > prev_end:
        gaps.append((prev_end, t1))
    gap_by = Counter()
    for (s, e), name in zip(gaps, _innermost(host, [0.5 * (s + e)
                                                     for s, e in gaps])):
        gap_by[name] += (e - s) * 1e-6
    return dict(busy_s=busy * 1e-6, window_s=(t1 - t0) * 1e-6,
                kernels=dict(kernels), gaps=dict(gap_by),
                device_ops=[[k[:NAME_CHARS], v]
                            for k, v in kernels.most_common(top)],
                idle_gaps=[[k[:NAME_CHARS], v]
                           for k, v in gap_by.most_common(top)])


def _innermost(host, times):
    """For each of `times` (ascending), the name of the innermost host
    event running then: of those that started at or before it and end
    after it, the one that started last; "python" where none runs. One
    sweep over the events by their start, with a heap of those begun."""
    ops = sorted(host, key=lambda h: h[0])
    heap, names, i = [], [], 0
    for t in times:
        while i < len(ops) and ops[i][0] <= t:
            heapq.heappush(heap, (-ops[i][0], -i, ops[i][1], ops[i][2]))
            i += 1
        # an event that has ended before t has ended for every later time
        while heap and heap[0][2] <= t:
            heapq.heappop(heap)
        names.append(heap[0][3] if heap else "python")
    return names


def kernel_seconds(summary: dict, *needles: str) -> float:
    """Device seconds of the kernels whose name holds one of `needles`
    (case-insensitive)."""
    low = [n.lower() for n in needles]
    return sum(v for k, v in summary["kernels"].items()
               if any(n in k.lower() for n in low))
