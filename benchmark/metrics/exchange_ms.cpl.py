"""exchange_ms.cpl: the atmosphere reservoirs' advance and readout of one
step inside the chunk: the program's `esn.advance` plus `esn.readout` spans
under `fastloop.chunk` by CUDA events, ms, median over the steps of the
traced chunk."""

from harness.coupled_spans import exchange_steps


def read(run):
    return exchange_steps(run.traffic["chunk"])
