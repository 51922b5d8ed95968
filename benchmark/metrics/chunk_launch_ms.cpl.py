"""chunk_launch_ms.cpl: the host's launch of a hybrid chunk (run_chunk's
call: 28 windows and reservoir steps, which returns before the card has
finished): the program's `fastloop.chunk` span, host ms, of the traced
chunk."""

from harness.coupled_spans import in_chunks


def read(run):
    return in_chunks(run.traffic["chunk"], "fastloop.chunk")
