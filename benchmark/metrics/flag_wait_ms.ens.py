"""flag_wait_ms.ens: the host's wait for an ensemble step's safety flags
(`bool(safe.all())`, which waits for the card to finish the step): the
program's `ensemble.flag_wait` span, host ms, median a step of the traced
run's device-only slice."""

from harness.program_spans import step_median


def read(run):
    return step_median("ensemble.flag_wait")
