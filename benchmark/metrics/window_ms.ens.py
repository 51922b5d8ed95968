"""window_ms.ens: the median over the traced run's window of the members'
windows (EnsembleHybrid.forecast) by CUDA events, ms per step."""

import statistics


def read(run):
    values = run.spans.get("window_ms")
    return statistics.median(values) if values else None
