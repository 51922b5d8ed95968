"""window_graphed_pct.cpl: the share of the traced chunk's steps whose 6-h
window was a replay of the program's captured CUDA graph: 100 x the
`fastloop.window` records of the complete chunks that count `graphed`, over
all of them, in percent. A program whose window runs eagerly counts no
replay and reads 0; one without the span reads None."""

from harness.coupled_spans import _run


def read(run):
    recs, done = _run(run.traffic["chunk"])
    windows = [r for r in recs
               if r["name"] == "fastloop.window" and r["index"] in done]
    if not windows:
        return None
    graphed = sum(1 for r in windows if r["counts"].get("graphed"))
    return 100.0 * graphed / len(windows)
