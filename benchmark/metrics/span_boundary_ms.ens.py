"""span_boundary_ms.ens: the host's per-date boundary state of the ensemble
loop (SST, TISR, _surf_forcing): the program's `ensemble.boundary` span,
host ms, median a step of the traced run's device-only slice (the
program's twin of boundary_ms.ens)."""

from harness.program_spans import step_median


def read(run):
    return step_median("ensemble.boundary")
