"""flush_wait_ms.ml: the host's wait for the writer thread's flush of the
chunk before: the program's `fastloop.flush_wait` span, host ms, median
over the complete chunks of the traced run's device-only slice."""

from harness.program_spans import chunk_median


def read(run):
    return chunk_median(run.traffic["chunk"], "fastloop.flush_wait")
