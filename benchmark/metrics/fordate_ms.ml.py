"""fordate_ms.ml: the host's radiation fields of a chunk, which the ML-only
step never reads: the program's `fastloop.fields.host.fordate` spans
(one a step) summed over a chunk, host ms, median over the complete chunks
of the traced run's device-only slice."""

from harness.program_spans import chunk_median


def read(run):
    return chunk_median(run.traffic["chunk"], "fastloop.fields.host.fordate")
