"""The port's native IO loader (speedyml_torch/io/native_loader.py over its
copy of native/speedy_io.cpp) and its linalg (speedyml_torch/reservoir/
linalg.py), on the CPU.

The four cases of tests/test_native.py, the second on the stand-in fort.2x
files of io/synthetic_boundary.py (the reference files are absent); the
decoder and both gathers against the JAX package's loader on the same
files and arrays, exactly; the boundary reader against its numpy version,
exactly; a failed build raises with the compiler's output (no fallback).
mldivide and pinv_svd against the JAX package's on the inputs of
tests/test_era.py::test_linalg_parity, unbatched and batched, to rtol
1e-12.
"""

import os

import numpy as np
import pytest
import torch

from speedyml.io import native_loader as jnl
from speedyml.reservoir import linalg as jla
from speedyml_torch.io import boundary as tbound
from speedyml_torch.io import native_loader as tnl
from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
from speedyml_torch.reservoir import linalg as tla

torch.set_num_threads(1)

LINALG_RTOL = 1e-12


def test_read_records_matches_numpy(tmp_path):
    rng = np.random.default_rng(0)
    ix, il, nrec = 16, 8, 5
    data = rng.normal(size=(nrec, il, ix)).astype("<f4")
    data[0, 2, 3] = -999.0
    data[1, 0, 0] = -1e4
    p = str(tmp_path / "fort.99")
    data.tofile(p)

    native = tnl.read_records_native(p, ix, il)
    ref = data.astype(np.float64)[:, ::-1, :]
    ref[ref <= -999] = 0.0
    np.testing.assert_array_equal(native, ref)
    np.testing.assert_array_equal(native, jnl.read_records_native(p, ix, il))


def test_boundary_reader_uses_native(tmp_path):
    """The stand-in fort.2x files decode identically through the native
    reader, the model's reader (read_boundary_records, in numpy) and the
    JAX package's native reader."""
    bindir = write_synthetic_boundary(str(tmp_path / "bc"), seed=3)
    names = sorted(os.listdir(bindir))
    assert names
    for name in names:
        path = os.path.join(bindir, name)
        native = tnl.read_records_native(path, 96, 48)
        raw = np.fromfile(path, dtype="<f4").reshape(-1, 48, 96)[:, ::-1, :]
        ref = raw.astype(np.float64)
        ref[ref <= -999] = 0.0
        np.testing.assert_array_equal(native, ref)
        np.testing.assert_array_equal(tbound.read_boundary_records(path),
                                      native)
        np.testing.assert_array_equal(jnl.read_records_native(path, 96, 48),
                                      native)


def test_stream_gather_matches_numpy(tmp_path):
    rng = np.random.default_rng(1)
    T, width = 50, 200
    series = rng.normal(size=(T, width)).astype(np.float32)
    p = str(tmp_path / "gv.cache")
    st = tnl.GvStream.write_cache(p, series)
    jst = jnl.GvStream(p, T, width)
    idx = rng.integers(0, width, size=(7, 13)).astype(np.int32)
    out = st.gather(idx, t0=5, nt=20)
    np.testing.assert_array_equal(out, series[5:25][:, idx])
    np.testing.assert_array_equal(out, jst.gather(idx, t0=5, nt=20))
    with pytest.raises(IndexError):
        st.gather(idx, t0=40, nt=20)
    with pytest.raises(IndexError):             # an index past the width
        st.gather(idx + width, t0=0, nt=1)
    st.close()
    jst.close()
    with pytest.raises(ValueError):
        st.gather(idx, t0=0, nt=1)
    # a cache shorter than asked for is refused, not read through numpy
    with pytest.raises(OSError):
        tnl.GvStream(p, T + 1, width)


def test_mem_gather_matches_numpy():
    rng = np.random.default_rng(2)
    series = np.ascontiguousarray(
        rng.normal(size=(30, 100)).astype(np.float32))
    idx = rng.integers(0, 100, size=(4, 9)).astype(np.int32)
    out = tnl.mem_gather(series, idx, 3, 10)
    np.testing.assert_array_equal(out, series[3:13][:, idx])
    np.testing.assert_array_equal(out, jnl.mem_gather(series, idx, 3, 10))
    # a float64, strided series: the JAX loader's numpy path gives the same
    s64 = rng.normal(size=(30, 200))[:, ::2]
    np.testing.assert_array_equal(tnl.mem_gather(s64, idx, 3, 10),
                                  jnl.mem_gather(s64, idx, 3, 10))
    with pytest.raises(IndexError):
        tnl.mem_gather(series, idx, 25, 10)
    with pytest.raises(IndexError):
        tnl.mem_gather(series, -1 - idx, 0, 1)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that fails stops the loader with its
    output."""
    monkeypatch.setattr(tnl, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "CXXFLAGS",
                        tnl.CXXFLAGS + ("-fno-such-option",))
    with pytest.raises(RuntimeError, match="failed"):
        tnl.get_lib()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tnl.get_lib()
    assert not list((tmp_path / "build").glob("*.so"))


def _era_inputs():
    """The inputs of tests/test_era.py::test_linalg_parity."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(6, 6)) + 6 * np.eye(6)
    X_true = rng.normal(size=(3, 6))
    return A, X_true @ A, np.diag([2.0, 4.0, 8.0])


def test_linalg_against_jax():
    A, B, D = _era_inputs()
    rng = np.random.default_rng(4)
    Ab = np.stack([A, A.T + 2 * np.eye(6), A + rng.normal(size=(6, 6))])
    Bb = rng.normal(size=(3, 4, 6))
    for a, b in ((A, B), (Ab, Bb)):
        got = tla.mldivide(a, b, device="cpu")
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), jla.mldivide(a, b),
                                   rtol=LINALG_RTOL)
    # float32 tensors are solved in float64 on their own device
    got = tla.mldivide(torch.as_tensor(A, dtype=torch.float32),
                       torch.as_tensor(B, dtype=torch.float32))
    np.testing.assert_allclose(
        got.numpy(), jla.mldivide(A.astype(np.float32), B.astype(np.float32)),
        rtol=LINALG_RTOL)
    M = rng.normal(size=(2, 5, 3))
    for a in (D, M[0], M):
        np.testing.assert_allclose(tla.pinv_svd(a, device="cpu").numpy(),
                                   jla.pinv_svd(a), rtol=LINALG_RTOL,
                                   atol=1e-15)
    # rcond is relative to the largest singular value, as numpy's
    S = np.diag([1.0, 1e-3, 1e-9])
    for rcond in (1e-15, 1e-6, 1e-2):
        np.testing.assert_array_equal(
            tla.pinv_svd(S, rcond, device="cpu").numpy() != 0,
            jla.pinv_svd(S, rcond) != 0)
        np.testing.assert_allclose(tla.pinv_svd(S, rcond, device="cpu")
                                   .numpy(), jla.pinv_svd(S, rcond),
                                   rtol=LINALG_RTOL)
