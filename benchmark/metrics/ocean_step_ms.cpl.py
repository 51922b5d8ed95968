"""ocean_step_ms.cpl: the weekly slab-ocean step on the card (the week's
input composed from the chunk's supervectors, then the ocean reservoirs'
advance and readout): the program's `fastloop.ocean.step` span by CUDA
events, ms, of the traced chunk."""

from harness.coupled_spans import in_chunks


def read(run):
    return in_chunks(run.traffic["chunk"], "fastloop.ocean.step", "device_ms")
