"""precompute_ms.ml: the median over the traced run's window of the host's
boundary fields of a chunk (_precompute and _upload_fields), host clock,
ms per chunk."""

import statistics


def read(run):
    values = run.spans.get("precompute_ms")
    return statistics.median(values) if values else None
