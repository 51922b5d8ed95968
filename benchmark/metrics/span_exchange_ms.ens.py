"""span_exchange_ms.ens: the reservoir exchange of all members
(EnsembleHybrid.exchange): the program's `ensemble.exchange` span by CUDA
events, ms, median a step of the traced run's device-only slice (the
program's twin of exchange_ms.ens)."""

from harness.program_spans import step_median


def read(run):
    return step_median("ensemble.exchange", "device_ms")
