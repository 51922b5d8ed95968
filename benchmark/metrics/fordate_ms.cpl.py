"""fordate_ms.cpl: the host's radiation and surface fields of a hybrid chunk
(`fordate`, once a step): the program's `fastloop.fields.host.fordate`
spans summed over the chunk staged beside the traced one, host ms."""

from harness.coupled_spans import in_run


def read(run):
    return in_run("fastloop.fields.host.fordate", summed=True)
