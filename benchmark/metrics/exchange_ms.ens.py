"""exchange_ms.ens: the median over the traced run's window of the
reservoir exchange of all members (EnsembleHybrid.exchange) by CUDA
events, ms per step."""

import statistics


def read(run):
    values = run.spans.get("exchange_ms")
    return statistics.median(values) if values else None
