"""ocean_compose_ms.cpl: the host's blend of the ocean's prediction into
the SST fed back (`compose_sst`, which reads the prediction back, and the
anomaly's upload): the program's `fastloop.ocean.compose` span, host ms,
of the traced chunk."""

from harness.coupled_spans import in_chunks


def read(run):
    return in_chunks(run.traffic["chunk"], "fastloop.ocean.compose")
