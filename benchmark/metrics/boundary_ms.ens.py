"""boundary_ms.ens: the median over the traced run's window of the host's
per-date boundary calls of the ensemble loop (SST, TISR, _surf_forcing),
ms per step."""

import statistics


def read(run):
    values = run.spans.get("boundary_ms")
    return statistics.median(values) if values else None
