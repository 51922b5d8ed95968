"""ctypes bindings for the native IO runtime (the port's counterpart of
speedyml/io/native_loader.py, over its own copy of the C++ source,
csrc/speedy_io.cpp, byte for byte the repository's native/speedy_io.cpp).

The shared library is compiled at first use with $CXX (default g++) and the
flags of native/Makefile into speedyml_torch/build/, once per source,
compiler, flags and host CPU (the flags build for the host's own
instruction set). The native paths replace the reference's NetCDF-C/MPI-IO
reader stack (mod_io.f90:1905-2282) for the boundary files and the raw
training-series caches.

There is no fallback: a failed build or load raises with the compiler's
output, and no path carries on in numpy in the library's place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "speedy_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall")
LDFLAGS = ("-shared", "-lpthread")

_lock = threading.Lock()
_lib = None


def _cpu_flags() -> bytes:
    """The host CPU's feature flags (what -march=native builds for)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def build() -> Path:
    """Compile csrc/speedy_io.cpp into build/ (once per source, compiler,
    flags and host CPU) and return the library path. Raises RuntimeError
    with the compiler's output when the compiler fails."""
    cxx = os.environ.get("CXX", "g++")
    tag = hashlib.sha256(b"\0".join([
        SOURCE.read_bytes(), cxx.encode(), " ".join(CXXFLAGS + LDFLAGS)
        .encode(), _cpu_flags()])).hexdigest()[:12]
    out = BUILD_DIR / f"libspeedy_io-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXXFLAGS, str(SOURCE), "-o", tmp, *LDFLAGS]
    try:
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
        except OSError as e:
            raise RuntimeError(f"cannot run the C++ compiler {cxx!r}: {e}")
        if res.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):"
                               f"\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)          # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built at the first call. Raises when it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.si_read_records.restype = ctypes.c_int64
        lib.si_read_records.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
        lib.si_stream_open.restype = ctypes.c_void_p
        lib.si_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_int64]
        lib.si_stream_close.restype = None
        lib.si_stream_close.argtypes = [ctypes.c_void_p]
        lib.si_stream_gather.restype = ctypes.c_int
        lib.si_stream_gather.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float)]
        lib.si_mem_gather.restype = ctypes.c_int
        lib.si_mem_gather.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def read_records_native(path: str, ix: int, il: int) -> np.ndarray:
    """Native fort.2x decode: (nrec, il, ix) float64, rows flipped to
    south->north, values <= -999 zeroed."""
    lib = get_lib()
    nbytes = os.path.getsize(path)
    nrec = nbytes // (ix * il * 4)
    if nrec * ix * il * 4 != nbytes:
        raise ValueError(f"{path}: not a whole number of ({il},{ix}) records")
    out = np.empty((nrec, il, ix), np.float64)
    got = lib.si_read_records(
        path.encode(), ix, il,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nrec)
    if got < 0:
        raise OSError(f"si_read_records failed on {path}")
    return out[:got]


def _gather_args(idx: np.ndarray, width: int):
    """The int32 index block and its (rows, per-row) counts. The native
    gathers read series[t, idx] unchecked: an index outside [0, width) is
    refused here."""
    idx32 = np.ascontiguousarray(idx, np.int32)
    if idx32.size and (idx32.min() < 0 or idx32.max() >= width):
        raise IndexError(f"gather index outside [0, {width})")
    return idx32, int(np.prod(idx32.shape[:-1], initial=1)), idx32.shape[-1]


class GvStream:
    """Out-of-core training-series cache: a raw float32 (T, width) file
    served by the native mmap+threads gather (the per-region halo hyperslab
    read, read_era_data_parallel mod_io.f90:1905-2036)."""

    def __init__(self, path: str, T: int, width: int):
        self.path = path
        self.T = T
        self.width = width
        self._h = None
        self._lib = get_lib()
        h = self._lib.si_stream_open(path.encode(), T, width)
        if not h:
            raise OSError(f"si_stream_open failed on {path} "
                          f"(T={T}, width={width})")
        self._h = h

    @staticmethod
    def write_cache(path: str, series: np.ndarray) -> "GvStream":
        series = np.ascontiguousarray(series, np.float32)
        series.tofile(path)
        return GvStream(path, series.shape[0], series.shape[1])

    def gather(self, idx: np.ndarray, t0: int, nt: int) -> np.ndarray:
        """(nt, *idx.shape) float32 block: out[t] = series[t0+t, idx]."""
        if self._h is None:
            raise ValueError(f"{self.path}: the stream is closed")
        idx32, nr, n_idx = _gather_args(idx, self.width)
        out = np.empty((nt,) + idx32.shape, np.float32)
        rc = self._lib.si_stream_gather(
            self._h, idx32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            nr, n_idx, t0, nt,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IndexError(f"gather out of bounds: t0={t0} nt={nt}")
        return out

    def close(self):
        if self._h is not None:
            self._lib.si_stream_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def mem_gather(series: np.ndarray, idx: np.ndarray, t0: int, nt: int
               ) -> np.ndarray:
    """Threaded gather from an in-memory series: (nt, *idx.shape) float32,
    out[t] = series[t0+t, idx]. A series that is not C-contiguous float32
    has its rows t0..t0+nt made so first (values as numpy's cast gives
    them); the gather itself is always the native one."""
    lib = get_lib()
    if t0 < 0 or t0 + nt > series.shape[0]:
        raise IndexError(f"gather out of bounds: t0={t0} nt={nt}")
    if series.dtype != np.float32 or not series.flags.c_contiguous:
        series = np.ascontiguousarray(series[t0:t0 + nt], np.float32)
        t0 = 0
    idx32, nr, n_idx = _gather_args(idx, series.shape[1])
    out = np.empty((nt,) + idx32.shape, np.float32)
    rc = lib.si_mem_gather(
        series.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        series.shape[0], series.shape[1],
        idx32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nr, n_idx, t0, nt,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise IndexError(f"gather out of bounds: t0={t0} nt={nt}")
    return out
