"""span_fields_ms.ml: the host's boundary fields of a chunk (_precompute and
_upload_fields): the program's `fastloop.fields` span, host ms, median
over the complete chunks of the traced run's device-only slice (the
program's twin of precompute_ms.ml)."""

from harness.program_spans import chunk_median


def read(run):
    return chunk_median(run.traffic["chunk"], "fastloop.fields")
