"""mfu_pct.cpl: the whole coupled step's share of the chip's peak: the least
time the chip could take for the step's counted work (harness/work.py: the
E=1 window's spectral transforms, the atmosphere reservoirs' advance and
readout, and a 28th of the weekly ocean reservoirs' advance and readout;
the larger of its operations over the float32 peak and its bytes over the
memory bandwidth) over the time of a step in the window by the host's
clock: a share over wall time, which moves with the host where the host
paces the loop."""

from harness.work import bound_seconds, peaks


def read(run):
    peak = peaks(run.values.get("kind", ""))
    step_s = run.values.get("step_s")
    if run.work is None or peak is None or not step_s:
        return None
    return 100.0 * bound_seconds(run.work, peak) / step_s
