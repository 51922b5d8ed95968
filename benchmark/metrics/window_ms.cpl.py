"""window_ms.cpl: the 6-h SPEEDY window of one step inside the hybrid
chunk (`_model_gv`: boundary state under the fed-back SST, window, packing):
the program's `fastloop.window` span by CUDA events, ms, median over the
steps of the traced chunk."""

from harness.coupled_spans import in_chunks


def read(run):
    return in_chunks(run.traffic["chunk"], "fastloop.window", "device_ms")
