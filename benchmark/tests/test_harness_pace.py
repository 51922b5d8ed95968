"""The pace readings of a window on the host clock: steps marked and timed
only while the window runs, host spans summed to the step that runs them,
and collections timed."""

from __future__ import annotations

import gc
import time

from harness.pace import Pace


def test_pace_marks_steps_only_inside_the_window():
    pace = Pace(cuda=False)
    step = pace.wrap_step(lambda: time.sleep(0.002))
    field = pace.wrap_host("precompute_ms", lambda: time.sleep(0.001))
    step()                       # before the window: not marked
    pace.start()
    for _ in range(4):
        field()
        step()
        gc.collect()
    s = pace.summary()
    step()                       # after the window: not marked
    assert s["steps"] == 4
    assert s["launch_ms"] >= 2.0
    assert s["period_ms"] >= s["launch_ms"]
    assert s["precompute_ms"] >= 1.0
    assert s["first_half_ms"] > 0 and s["second_half_ms"] > 0
    assert s["gc_n"] >= 4 and s["gc_ms"] > 0
    assert "device_ms" not in s
    assert pace._gc not in gc.callbacks
