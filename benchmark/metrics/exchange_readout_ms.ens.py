"""exchange_readout_ms.ens: the readout of all members in the exchange (the
augmented states and one product with Wout): the program's `esn.readout`
span under `ensemble.exchange` by CUDA events, ms, median a step of the
traced run's device-only slice."""

from harness.program_spans import step_median


def read(run):
    return step_median("esn.readout", "device_ms", under="ensemble.exchange")
