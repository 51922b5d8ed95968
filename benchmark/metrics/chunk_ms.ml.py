"""chunk_ms.ml: the median over the traced run's window of a 28-step chunk
by the program's own CUDA events (ScanHybridRunner.run's chunk_ms)."""

import statistics


def read(run):
    values = run.spans.get("chunk_ms")
    return statistics.median(values) if values else None
