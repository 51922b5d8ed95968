"""exchange_advance_ms.ens: the reservoirs' advance of all members in the
exchange: the program's `esn.advance` span under `ensemble.exchange` by
CUDA events, ms, median a step of the traced run's device-only slice."""

from harness.program_spans import step_median


def read(run):
    return step_median("esn.advance", "device_ms", under="ensemble.exchange")
