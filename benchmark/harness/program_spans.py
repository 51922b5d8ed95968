"""The program's own spans (speedyml_torch.utils.diag) in a traced run, for
the per-layer metrics that read them.

The program records its spans while a torch profiler records, so a traced
run holds those of the two slices that harness/trace.py profiles: first the
device-only slice, then the one with the host's operations. The metrics
read the first run of a loop that recorded spans, the device-only slice's,
as medians a step (ensemble) or a chunk (chunked loop; complete chunks
only). A program without the tracer keeps no records, and the readers then
return None.
"""

from __future__ import annotations

import statistics


def records() -> list:
    """Every record the program kept, or [] where it keeps none."""
    try:
        from speedyml_torch.utils import diag
    except ImportError:
        return []
    read = getattr(diag, "spans", None)
    return [] if read is None else read()


def first_run(loop: str, recs=None) -> list:
    """The records of the first run() call of `loop` that recorded spans
    (of `recs`, by default the program's)."""
    recs = [r for r in (records() if recs is None else recs)
            if r["loop"] == loop]
    if not recs:
        return []
    first = min(r["run"] for r in recs)
    return [r for r in recs if r["run"] == first]


def per_index(recs, name: str, field: str = "host_ms",
              under: str | None = None) -> dict:
    """{step or chunk index: `field` summed over the spans named `name`},
    of those whose parent span is named `under` where it is given."""
    names = {r["id"]: r["name"] for r in recs}
    out = {}
    for r in recs:
        if r["name"] != name or r["index"] is None or r[field] is None:
            continue
        if under is not None and names.get(r["parent"]) != under:
            continue
        out[r["index"]] = out.get(r["index"], 0.0) + r[field]
    return out


def step_median(name: str, field: str = "host_ms", under: str | None = None,
                recs=None):
    """The median a step of `name` in the first traced ensemble run, or
    None."""
    values = per_index(first_run("ensemble", recs), name, field, under)
    return statistics.median(values.values()) if values else None


def chunk_median(K: int, name: str, field: str = "host_ms", recs=None):
    """The median a chunk of `name` in the first traced chunked-loop run,
    over the chunks whose `fastloop.chunk` span counted K steps, or None."""
    run = first_run("fastloop", recs)
    done = {r["index"] for r in run if r["name"] == "fastloop.chunk"
            and r["counts"].get("steps") == K}
    values = [v for i, v in per_index(run, name, field).items() if i in done]
    return statistics.median(values) if values else None
