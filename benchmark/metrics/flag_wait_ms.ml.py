"""flag_wait_ms.ml: the host's wait for a chunk's K safety flags
(`res.safe_st.cpu()`): the program's `fastloop.flag_wait` span, host ms,
median over the complete chunks of the traced run's device-only slice."""

from harness.program_spans import chunk_median


def read(run):
    return chunk_median(run.traffic["chunk"], "fastloop.flag_wait")
