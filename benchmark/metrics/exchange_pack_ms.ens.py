"""exchange_pack_ms.ens: the exchange's first pass, the gathers of the packed
states and their standardization: the program's `ensemble.exchange.pack`
span by CUDA events, ms, median a step of the traced run's device-only
slice."""

from harness.program_spans import step_median


def read(run):
    return step_median("ensemble.exchange.pack", "device_ms")
