#!/usr/bin/env python3
"""Accuracy and time of the normal-equation kernel on one NVIDIA GPU.

    python3 scripts_torch/accum_accuracy.py [--regions 48] [--reps 5]

Builds speedyml_torch/ops/csrc/accum.cu (printing the compiler's register
and shared-memory report), then

  * holds both wrappers against the plain version at small ragged shapes
    (odd na, strided aug, several chunks, unsymmetric hi with nonzero lo);
  * measures, for one chunk at the training width (na = 5896, T = 128, two
    regions), the error of the kernel's product and of the plain f32 einsum
    against an f64 einsum: the split-precision tensor-core product should
    stay within a small factor of plain f32;
  * times accumulate_ss_scan (T = 256, chunk 128) and accumulate_ss
    (T = 128 and T = 32: one time block, which is nearly the hi/lo pass
    alone) at the training block's shape beside the bound (hi and lo read
    once and written once, plus aug, over 3.35 TB/s), beside torch.bmm for
    the chunk products alone, and beside a plain copy of hi's and lo's
    bytes, which is what the card gives a streaming read and write.

Needs a CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from speedyml_torch.ops import accum  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet


def cuda_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def tot(hi, lo):
    return hi.double() + lo.double()


def small_shapes(dev):
    g = torch.Generator(device=dev).manual_seed(7)
    for T, R, na, chunk in [(8, 1, 64, 8), (32, 1, 128, 32), (20, 2, 136, 8),
                            (37, 3, 137, 16), (256, 2, 700, 128),
                            (333, 2, 201, 64)]:
        aug = torch.randn(R, T, na, device=dev, generator=g).transpose(0, 1)
        hi0 = 10 * torch.randn(R, na, na, device=dev, generator=g)
        lo0 = 1e-6 * torch.randn(R, na, na, device=dev, generator=g)
        hk, lk = hi0.clone(), lo0.clone()
        accum.accumulate_ss_scan(hk, lk, aug, chunk)
        torch.cuda.synchronize()
        hp, lp = hi0.clone(), lo0.clone()
        accum.accumulate_ss_plain(hp, lp, aug, chunk)
        a64 = aug.double()
        want = tot(hi0, lo0) + torch.einsum("tra,trb->rab", a64, a64)
        ek = float((tot(hk, lk) - want).abs().max())
        ep = float((tot(hp, lp) - want).abs().max())
        ok = torch.allclose(tot(hk, lk), tot(hp, lp), rtol=1e-5, atol=1e-4)
        print(f"T={T} R={R} na={na} chunk={chunk}: kernel err {ek:.3e}, "
              f"plain err {ep:.3e} vs f64; kernel ~ plain: {ok}", flush=True)
        if not ok:
            raise AssertionError("kernel != plain")


def product_error(dev, na, T):
    g = torch.Generator(device=dev).manual_seed(11)
    aug = torch.randn(T, 2, na, device=dev, generator=g)
    a64 = aug.double()
    want = torch.einsum("tra,trb->rab", a64, a64)
    hk = torch.zeros(2, na, na, device=dev)
    lk = torch.zeros_like(hk)
    accum.accumulate_ss(hk, lk, aug)
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = torch.einsum("tra,trb->rab", aug, aug).double()
    scale = want.diagonal(dim1=1, dim2=2).mean()
    for name, got in (("kernel", tot(hk, lk)), ("plain f32", plain)):
        err = (got - want).abs()
        diag = (got - want).diagonal(dim1=1, dim2=2)
        print(f"{name}: product error vs f64 at na={na} T={T}: max "
              f"{float(err.max()):.3e}, rms {float(err.pow(2).mean().sqrt()):.3e}"
              f", mean signed on the diagonal {float(diag.mean()):.3e} "
              f"(diagonal entries ~{float(scale):.1f})", flush=True)


def block_margin(dev, na):
    """The smoke run's own criterion at the training width, 8 regions: the
    largest |kernel - plain| in units of its tolerance (rtol 1e-5 plus
    1e-5 of the mean entry size)."""
    g = torch.Generator(device=dev).manual_seed(5)
    aug = torch.randn(256, 8, na, device=dev, generator=g)
    hi0 = 10 * torch.randn(8, na, na, device=dev, generator=g)
    hk, lk = hi0.clone(), torch.zeros_like(hi0)
    accum.accumulate_ss_scan(hk, lk, aug, 128)
    hp, lp = hi0.clone(), torch.zeros_like(hi0)
    accum.accumulate_ss_plain(hp, lp, aug, 128)
    want = hi0.double()
    for c0 in (0, 128):
        a64 = aug[c0:c0 + 128].double()
        want += torch.einsum("tra,trb->rab", a64, a64)
    tp = tot(hp, lp)
    tol = 1e-5 * tp.abs().mean() + 1e-5 * tp.abs()
    for name, got in (("kernel - plain", tot(hk, lk) - tp),
                      ("kernel - f64", tot(hk, lk) - want),
                      ("plain - f64", tp - want)):
        ratio = got.abs() / tol
        print(f"{name}: max |diff| {float(got.abs().max()):.3e}, largest "
              f"share of the tolerance {float(ratio.max()):.3f}", flush=True)


def times(dev, R, na, reps):
    g = torch.Generator(device=dev).manual_seed(3)
    aug = torch.randn(256, R, na, device=dev, generator=g)
    hi = torch.zeros(R, na, na, device=dev)
    lo = torch.zeros_like(hi)
    byts = 2 * 2 * hi.numel() * 4
    for name, a, fn in (
            ("accumulate_ss_scan", aug,
             lambda: accum.accumulate_ss_scan(hi, lo, aug, 128)),
            ("accumulate_ss", aug[:128],
             lambda: accum.accumulate_ss(hi, lo, aug[:128])),
            ("accumulate_ss", aug[:32],
             lambda: accum.accumulate_ss(hi, lo, aug[:32]))):
        fn()
        ms = [cuda_ms(fn, reps) for _ in range(2)]
        bound = (byts + a.numel() * 4) / HBM_BYTES_PER_S * 1e3
        flop = 2.0 * a.shape[0] * na * na * R
        print(f"{name} R={R} T={a.shape[0]} na={na}: "
              f"{' '.join(f'{m:.3f}' for m in ms)} ms; bound {bound:.3f} ms "
              f"(bytes); {flop / min(ms) / 1e9:.1f} TFLOP/s of f32-accurate "
              f"product", flush=True)
    flat_hi, flat_lo = hi.view(-1), lo.view(-1)
    print(f"copy of hi's bytes into lo ({hi.numel() * 4 / 1e9:.2f} GB read, "
          f"as much written; the kernel moves twice that): "
          f"{cuda_ms(lambda: flat_lo.copy_(flat_hi), reps):.3f} ms",
          flush=True)
    del hi, lo, flat_hi, flat_lo
    # the chunk products alone, by the library (no fold): a partial yardstick
    at = aug.permute(1, 2, 0).contiguous()          # (R, na, T)
    out = torch.empty(R, na, na, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False

    def bmm():
        for c0 in (0, 128):
            torch.bmm(at[:, :, c0:c0 + 128],
                      at[:, :, c0:c0 + 128].transpose(1, 2), out=out)
    bmm()
    print(f"torch.bmm, product only, f32, 2 chunks: {cuda_ms(bmm, reps):.3f} "
          f"ms", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--regions", type=int, default=48)
    ap.add_argument("--na", type=int, default=5896)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    accum.build(verbose=True)
    small_shapes(dev)
    product_error(dev, args.na, 128)
    block_margin(dev, args.na)
    times(dev, args.regions, args.na, args.reps)


if __name__ == "__main__":
    main()
