"""precompute_idle_pct.ml: the share of the card's idle time during which
the host was in its chunk precompute: 100 x the idle seconds of the traced
host slice (harness/trace.py's gaps, each put down to the innermost host
event at its middle) under names that start with `fastloop.fields`, over
all its idle seconds. None where the trace holds none of the program's
`fastloop.` spans."""

PREFIX = "fastloop.fields"


def read(run):
    t = run.trace_summary
    gaps = t.get("gaps") if t else None
    if not gaps or not any(k.startswith("fastloop.") for k in gaps):
        return None
    total = sum(gaps.values())
    if total <= 0:
        return None
    return 100.0 * sum(v for k, v in gaps.items()
                       if k.startswith(PREFIX)) / total
