"""chunk_launch_ms.ml: the host's launch of a chunk (run_chunk's call, which
returns before the card has finished): the program's `fastloop.chunk`
span, host ms, median over the complete chunks of the traced run's
device-only slice."""

from harness.program_spans import chunk_median


def read(run):
    return chunk_median(run.traffic["chunk"], "fastloop.chunk")
