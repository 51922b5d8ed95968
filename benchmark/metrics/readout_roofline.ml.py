"""readout_roofline.ml: the readout product's share of its roofline. Its
least time is the larger of 2 R n_out n operations over the float32 peak
and the bytes of Wout, the augmented state and the output, each counted
once, over the memory bandwidth; its time is the device time of the
matrix-product kernels (the only ones in an ML-only step) per step of the
traced slice."""

from harness.trace import kernel_seconds
from harness.work import peaks


def read(run):
    peak = peaks(run.values.get("kind", ""))
    t = run.trace_summary
    if run.work is None or peak is None or not t:
        return None
    per_step = kernel_seconds(t, "gemm", "gemv") / run.values["trace_steps"]
    if per_step <= 0:
        return None
    least = max(run.work["readout_flops"] / peak["float32"],
                run.work["readout_bytes"] / peak["hbm_bytes_per_s"])
    return 100.0 * least / per_step
