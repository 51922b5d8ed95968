"""span_window_ms.ens: the members' windows under vmap
(EnsembleHybrid.forecast): the program's `ensemble.window` span by CUDA
events, ms, median a step of the traced run's device-only slice (the
program's twin of window_ms.ens)."""

from harness.program_spans import step_median


def read(run):
    return step_median("ensemble.window", "device_ms")
