"""Compensated normal-equation accumulation: a CUDA kernel and its plain twin.

The training hot op folds each chunk's `D = aug_c^T aug_c` into the
compensated (hi, lo) f32 pair of every region (reservoir/training.py). The
JAX package writes it as two Pallas TPU kernels (speedyml/ops/accum.py); here
one hand-written CUDA kernel (csrc/accum.cu: a split pre-pass and a wgmma
fold at split TF32 precision) serves both wrappers:

  * `accumulate_ss_scan` folds a whole (T, R, na) series, chunk by chunk;
  * `accumulate_ss` folds one chunk (the same kernel with T == chunk).

Both update `ss_hi`/`ss_lo` IN PLACE and return them. A CUDA tensor always
goes through the kernel (or raises); a CPU tensor goes through the plain
PyTorch version beside it, `accumulate_ss_plain`. Each wrapper counts its
kernel launches in its `launches` attribute: one per segment of
`segment_steps` time steps, each a launch of the pre-pass and of the fold.

On the card the fold is taken every 32 time steps whatever `chunk` says:
two-sum keeps each addition's rounding error exactly, so finer folds lose
nothing, and the result agrees with the plain version to the f32 rounding of
the chunk products (rtol 1e-5).

The kernel is compiled with nvcc at first use, from the source in this
package, into `speedyml_torch/build/` (one shared library with a plain C
interface, loaded with ctypes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "accum.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None
# grid limits of the launches: gridDim.y counts 32-step time blocks (the
# pre-pass) or 64-row tiles (the fold), gridDim.z regions
_MAX_GRID_YZ = 65535
# time steps per shared-memory stage of the kernel (kDepth in accum.cu)
_DEPTH = 32
# the kernel's scratch (both split planes of aug, transposed and padded) is
# held to this many bytes: a longer series goes through in segments, each
# one launch of the pre-pass and of the fold
SCRATCH_BYTES = 1 << 30


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build(verbose: bool = False) -> Path:
    """Compile csrc/accum.cu into build/ (once per source content) and return
    the library path. verbose adds `-Xptxas -v` and prints nvcc's report."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libaccum-{tag}.so"
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr, flush=True)
        os.replace(tmp, out)          # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.accum_ss_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.accum_ss_launch.restype = ctypes.c_int
        lib.accum_ss_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.accum_ss_scratch_floats.restype = ctypes.c_longlong
        lib.accum_error_string.argtypes = [ctypes.c_int]
        lib.accum_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _two_sum_(hi: torch.Tensor, lo: torch.Tensor, d: torch.Tensor) -> None:
    """(hi, lo) += d with the compensated two-sum, in place."""
    s = hi + d
    v = s - hi
    e = (hi - (s - v)) + (d - v)
    hi.copy_(s)
    lo.add_(e)


def accumulate_ss_plain(ss_hi: torch.Tensor, ss_lo: torch.Tensor,
                        aug: torch.Tensor, chunk: int):
    """The plain PyTorch version: per chunk, an f32 einsum then the two-sum
    (speedyml accumulate_ss_xla applied chunk by chunk). In place. The
    products are taken without TF32 (which would round each to ~10 mantissa
    bits); the caller's TF32 setting is restored on return."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        T = aug.shape[0]
        for c0 in range(0, T, chunk):
            blk = aug[c0:c0 + chunk]
            _two_sum_(ss_hi, ss_lo, torch.einsum("tra,trb->rab", blk, blk))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return ss_hi, ss_lo


def _check(ss_hi, ss_lo, aug, chunk):
    if aug.dim() != 3:
        raise ValueError(f"aug must be (T, R, na), got {tuple(aug.shape)}")
    T, R, na = aug.shape
    for name, t in (("ss_hi", ss_hi), ("ss_lo", ss_lo)):
        if tuple(t.shape) != (R, na, na):
            raise ValueError(f"{name} must be {(R, na, na)}, "
                             f"got {tuple(t.shape)}")
    for name, t in (("aug", aug), ("ss_hi", ss_hi), ("ss_lo", ss_lo)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != aug.device:
            raise ValueError(f"{name} is on {t.device}, aug on {aug.device}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def segment_steps(R: int, na: int) -> int:
    """Time steps the kernel folds per launch at (R, na), a multiple of its
    32-step stage: the scratch budget and the pre-pass grid bound it (448 at
    R=48, na=5896). A longer series goes through in launches of this many
    steps."""
    per_block = _load().accum_ss_scratch_floats(_DEPTH, R, na) * 4
    return max(1, min(SCRATCH_BYTES // per_block, _MAX_GRID_YZ)) * _DEPTH


def _launch(ss_hi, ss_lo, aug) -> int:
    """The kernel over aug, one launch per segment; returns the launches."""
    T, R, na = aug.shape
    if aug.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {aug.device}")
    if not (ss_hi.is_contiguous() and ss_lo.is_contiguous()):
        raise ValueError("ss_hi and ss_lo must be contiguous")
    if R > _MAX_GRID_YZ or (na + 63) // 64 > _MAX_GRID_YZ:
        raise ValueError(f"R={R}, na={na} exceed the launch grid")
    if T == 0:
        return 0
    lib = _load()
    seg = segment_steps(R, na)
    planes = torch.empty(lib.accum_ss_scratch_floats(min(seg, T), R, na),
                         dtype=torch.float32, device=aug.device)
    stream = torch.cuda.current_stream(aug.device).cuda_stream
    for t0 in range(0, T, seg):
        part = aug[t0:t0 + seg]
        st, sr, sa = part.stride()
        err = lib.accum_ss_launch(
            part.data_ptr(), st, sr, sa, ss_hi.data_ptr(), ss_lo.data_ptr(),
            planes.data_ptr(), part.shape[0], R, na, aug.device.index,
            stream)
        if err != 0:
            raise RuntimeError("accum_ss kernel launch failed: "
                               + lib.accum_error_string(err).decode())
    return -(-T // seg)


def accumulate_ss_scan(ss_hi: torch.Tensor, ss_lo: torch.Tensor,
                       aug: torch.Tensor, chunk: int = 128):
    """Fold a whole series into the compensated normal equations, in place.

    ss_hi, ss_lo: (R, na, na) f32; aug: (T, R, na) f32, any strides. Chunks
    are [0, chunk), [chunk, 2 chunk), ...; the last may be shorter (the TPU
    wrapper zero-padded it, which adds nothing). The kernel folds every 32
    steps instead (see the module's note). Returns (ss_hi, ss_lo).
    """
    _check(ss_hi, ss_lo, aug, chunk)
    if aug.device.type == "cpu":
        return accumulate_ss_plain(ss_hi, ss_lo, aug, chunk)
    accumulate_ss_scan.launches += _launch(ss_hi, ss_lo, aug)
    return ss_hi, ss_lo


def accumulate_ss(ss_hi: torch.Tensor, ss_lo: torch.Tensor,
                  aug: torch.Tensor):
    """Fold ONE chunk aug (chunk, R, na) into (ss_hi, ss_lo), in place."""
    _check(ss_hi, ss_lo, aug, 1)
    chunk = max(aug.shape[0], 1)
    if aug.device.type == "cpu":
        return accumulate_ss_plain(ss_hi, ss_lo, aug, chunk)
    accumulate_ss.launches += _launch(ss_hi, ss_lo, aug)
    return ss_hi, ss_lo


accumulate_ss_scan.launches = 0
accumulate_ss.launches = 0
