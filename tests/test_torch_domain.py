"""speedyml_torch.domain against speedyml.domain.

The layout is host code and must match exactly; pack, gather and scatter
move values without arithmetic and must match bit for bit. The streamed
stats sum float64 moments in another order: 1e-6 relative after the cast
to float32 (one float32 ulp is 6e-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedyml.domain import decomposition as jdec
from speedyml.domain import standardize as jstd
from speedyml_torch import convert
from speedyml_torch.domain import decomposition as tdec
from speedyml_torch.domain import standardize as tstd

# one intra-op thread: the suite runs in parallel workers beside the JAX
# tests, and oversubscribed torch threads stall every worker
torch.set_num_threads(1)

# the port's entry points build on the card unless told otherwise; these
# tests run on the CPU and say so
CPU = "cpu"


def to_cpu(a, dtype=None):
    return convert.tensor(a, CPU, dtype)

LAYOUTS = {
    "reference": dict(),
    "small": dict(ix=12, il=6, kx=2),
    "slabs": dict(ix=12, il=6, kx=4, nz_slabs=2, vert_overlap=1),
}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def layouts(request):
    kw = LAYOUTS[request.param]
    return jdec.build_layout(**kw), tdec.build_layout(**kw)


def test_build_layout_and_convert(layouts):
    jl, tl = layouts
    cl = convert.region_layout(jl)
    for lay in (tl, cl):
        for f in ("R", "n_in", "n_out", "gv_len", "sizes", "out_sizes",
                  "gv_sizes", "inpz", "kz_core"):
            assert getattr(lay, f) == getattr(jl, f), f
        for f in ("input_index", "target_index", "lat_region_deg"):
            np.testing.assert_array_equal(getattr(lay, f), getattr(jl, f))


def test_pack_gather_scatter(layouts):
    jl, tl = layouts
    rng = np.random.default_rng(0)
    atmo = rng.normal(size=(jl.nvars, jl.kx, jl.il, jl.ix)).astype(np.float32)
    f2d = [rng.normal(size=(jl.il, jl.ix)).astype(np.float32)
           for _ in range(4)]
    gv_j = np.asarray(jdec.pack_global(jl, jnp.asarray(atmo),
                                       *map(jnp.asarray, f2d)))
    gv_t = tdec.pack_global(tl, to_cpu(atmo),
                            *map(to_cpu, f2d))
    np.testing.assert_array_equal(gv_t.numpy(), gv_j)
    np.testing.assert_array_equal(
        tdec.gather_inputs(tl, gv_t).numpy(),
        np.asarray(jdec.gather_inputs(jl, jnp.asarray(gv_j))))
    np.testing.assert_array_equal(tdec.gather_targets(tl, gv_t).numpy(),
                                  gv_j[jl.target_index])
    out = rng.normal(size=(jl.R, jl.n_out)).astype(np.float32)
    for a, b in zip(jdec.scatter_outputs(jl, jnp.asarray(out)),
                    tdec.scatter_outputs(tl, to_cpu(out))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # scattering the targets of a packed state gives the state back
    a2, lp2, pr2 = tdec.scatter_outputs(tl, tdec.gather_targets(tl, gv_t))
    if jl.nz == 1:
        np.testing.assert_array_equal(a2.numpy(), atmo)
        np.testing.assert_array_equal(lp2.numpy(), f2d[0])


def test_stats_and_apply(layouts):
    jl, tl = layouts
    rng = np.random.default_rng(1)
    T = 7
    gv = (rng.normal(size=(T, jl.gv_len)) * 3.0 + 280.0).astype(np.float32)
    sj = jstd.compute_stats_gv(jl, gv, chunk=3)
    st = tstd.compute_stats_gv(tl, to_cpu(gv), chunk=4)
    for f in sj._fields:
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(sj, f)), rtol=1e-6)
    sc = convert.standardizer(sj, CPU)
    u = gv[-1][jl.input_index]
    y = gv[-1][jl.target_index]
    for fj, ft, v in ((jstd.standardize_in, tstd.standardize_in, u),
                      (jstd.standardize_out, tstd.standardize_out, y),
                      (jstd.unstandardize_out, tstd.unstandardize_out, y)):
        np.testing.assert_array_equal(ft(sc, to_cpu(v)).numpy(),
                                      np.asarray(fj(sj, jnp.asarray(v))))
    # the SST floor
    low = sj._replace(in_std=jnp.asarray(np.full(sj.in_std.shape, 1e-8),
                                         jnp.float32))
    np.testing.assert_array_equal(
        tstd.floor_sst_std(convert.standardizer(low, CPU), tl).in_std.numpy(),
        np.asarray(jstd.floor_sst_std(low, jl).in_std))
