"""device_idle_pct: the share of the traced slice in which no operation ran
on the card (harness/trace.py), in percent."""


def read(run):
    t = run.trace_summary
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
