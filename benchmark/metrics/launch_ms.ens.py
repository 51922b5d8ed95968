"""launch_ms.ens: the host's launch of an ensemble step, from the start of
EnsembleHybrid.step's call to its return: the program's `ensemble.step`
span, host ms, median a step of the traced run's device-only slice."""

from harness.program_spans import step_median


def read(run):
    return step_median("ensemble.step")
