"""flush_wait_ms.cpl: the host's wait for the writer thread's flush of an
earlier chunk to the forecast file: the program's `fastloop.flush_wait`
span, host ms, median over the traced run."""

from harness.coupled_spans import in_run


def read(run):
    return in_run("fastloop.flush_wait")
