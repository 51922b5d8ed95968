"""exchange_unpack_ms.ens: the exchange's last pass, unstandardize, the
scatter to the grid and the clamps: the program's
`ensemble.exchange.unpack` span by CUDA events, ms, median a step of the
traced run's device-only slice."""

from harness.program_spans import step_median


def read(run):
    return step_median("ensemble.exchange.unpack", "device_ms")
