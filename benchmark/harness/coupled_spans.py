"""The program's spans in a traced run of the coupled loop, for the `.cpl`
per-layer metrics.

A traced slice of the coupled loop reads one chunk: the first `fastloop`
run that recorded spans (harness/program_spans.py) holds that chunk, whose
`fastloop.chunk` span counted K steps, with the windows, reservoir steps,
flag wait and ocean step inside it, and the boundary fields of the chunk
after it, which the host stages beside it (their index is that chunk's,
which the slice does not run). A program without a span keeps no record
of it, and the readers then return None.
"""

from __future__ import annotations

import statistics

from .program_spans import first_run


def _run(K: int):
    """(records of the first traced fastloop run, the indices of its
    chunks that ran all K steps)."""
    recs = first_run("fastloop")
    done = {r["index"] for r in recs if r["name"] == "fastloop.chunk"
            and r["counts"].get("steps") == K}
    return recs, done


def _median(values):
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def in_chunks(K: int, name: str, field: str = "host_ms"):
    """The median of one span's `field` over its records in the complete
    chunks (one a step for a span opened each step), or None."""
    recs, done = _run(K)
    return _median(r[field] for r in recs
                   if r["name"] == name and r["index"] in done)


def in_run(name: str, field: str = "host_ms", summed: bool = False):
    """The median of one span's `field` over all its records in the traced
    run, or, with `summed`, over its sums a chunk index; or None."""
    recs = [r for r in first_run("fastloop") if r["name"] == name]
    if not summed:
        return _median(r[field] for r in recs)
    by = {}
    for r in recs:
        if r[field] is not None:
            by[r["index"]] = by.get(r["index"], 0.0) + r[field]
    return _median(by.values())


def exchange_steps(K: int):
    """The reservoirs' advance plus readout of each step of the complete
    chunks (the `esn.advance` and `esn.readout` spans directly under
    `fastloop.chunk`, device ms, paired in order), median, or None."""
    recs, done = _run(K)
    names = {r["id"]: r["name"] for r in recs}

    def of(name):
        return sorted((r for r in recs if r["name"] == name
                       and r["index"] in done
                       and names.get(r["parent"]) == "fastloop.chunk"
                       and r["device_ms"] is not None),
                      key=lambda r: r["start_ns"])
    adv, rd = of("esn.advance"), of("esn.readout")
    if not adv or len(adv) != len(rd):
        return None
    return _median(a["device_ms"] + b["device_ms"] for a, b in zip(adv, rd))
