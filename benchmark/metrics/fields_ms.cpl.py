"""fields_ms.cpl: the host's 17 boundary fields of a hybrid chunk
(`_precompute` and `_upload_fields`), staged beside the traced chunk for
the one after it: the program's `fastloop.fields` span, host ms."""

from harness.coupled_spans import in_run


def read(run):
    return in_run("fastloop.fields")
