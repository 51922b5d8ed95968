#!/usr/bin/env python3
"""Where the time of speedyml_torch's main path goes, on one NVIDIA GPU.

    python3 scripts_torch/profile_slice.py

Three measurements at the reference width of chip_smoke.py:

  * one dry 6-h window (T30L8, f32) under torch.profiler: its time on the
    host clock, the device time of its kernels, their number, and the kernels
    that take the most device time;
  * the same for one full-physics window (seeded stand-in boundary files,
    the model spun up two days from rest), beside the host time of
    `_surf_forcing`, which builds the window's boundary state;
  * one training block (the regions chip_smoke.py trains at a time, n=5760,
    na=5896, 256 training pairs) split by phase, with a synchronize between
    phases: reservoir generation, discard, drive + accumulation, the
    accumulation kernel alone (CUDA events, same shapes), and the f64 ridge
    solve. The series is random and standardized, so the block's numbers do
    not depend on a truth series. The block runs three times; the first
    includes the kernel build and the first CUDA calls.

Needs a CUDA device; exits nonzero without one.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (SEED, TRAIN_CHUNK, TRAIN_SAMPLES,  # noqa: E402
                        phase_device, region_block_for, smooth_gridstate)


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_window(label, run, nsteps):
    """One call of run() (a window) timed without the profiler and then
    under it: host clock, device time, launches, the top device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()                                        # warm-up
    torch.cuda.synchronize()

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    print(f"{label} window: {host_ms:.2f} ms host clock, "
          f"{start.elapsed_time(stop):.2f} ms CUDA events (no profiler)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_host_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    n_launch = sum(e.count for e in kernels)
    dev_ms = sum(_self_device_us(e) for e in kernels) / 1e3
    if n_launch == 0 or dev_ms == 0.0:
        raise RuntimeError("the profiler recorded no device kernels")
    print(f"{label} window under the profiler: {prof_host_ms:.2f} ms host "
          f"clock, {dev_ms:.3f} ms device time in {n_launch} kernel launches "
          f"({n_launch / nsteps:.0f} per dycore step); device idle "
          f"{100 * (1 - dev_ms / prof_host_ms):.1f}% of the profiled host "
          f"time, {100 * (1 - dev_ms / host_ms):.1f}% of the unprofiled")
    for e in sorted(kernels, key=_self_device_us, reverse=True)[:8]:
        us = _self_device_us(e)
        print(f"  {us / 1e3:8.3f} ms {e.count:6d} x {us / e.count:7.2f} us  "
              f"{e.key[:90]}")


def profile_dry_window():
    import torch
    from speedyml_torch import ModelConfig
    from speedyml_torch.dynamics.core import Dycore
    from speedyml_torch.hybrid.forecast import SpeedyForecaster

    dy = Dycore(ModelConfig(), device=torch.device("cuda"))
    fc = SpeedyForecaster.dry(dy)
    gs = smooth_gridstate(dy, SEED)
    profile_window("dry", lambda: fc.forecast(gs), fc.nsteps_window + 1)


def profile_full_physics_window():
    import numpy as np
    import torch
    from speedyml_torch import ModelConfig, ModelDate
    from speedyml_torch.hybrid.forecast import SpeedyForecaster
    from speedyml_torch.hybrid.state_io import extract
    from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
    from speedyml_torch.model import Speedy

    with tempfile.TemporaryDirectory() as bindir:
        sp = Speedy(ModelConfig(), write_synthetic_boundary(bindir, SEED))
    sp.initialize(1982, 1)
    sp.run_days(2)
    gs = extract(sp.dy, sp.state)
    date = ModelDate(sp.date.iyear, sp.date.imonth, sp.date.iday, 0)
    sst = np.asarray(sp.coupler.sst_am)
    fc = SpeedyForecaster(sp)

    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        surf, forcing = fc._surf_forcing(date, sst)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    print(f"_surf_forcing (coupler init, fordate with two host transforms, "
          f"upload): {sorted(times)[len(times) // 2]:.2f} ms median on the "
          f"host clock [{' '.join(f'{t:.2f}' for t in times)}]")
    profile_window("full-physics", lambda: fc.window(gs, surf, forcing),
                   fc.nsteps_window + 1)


def profile_train_block():
    import numpy as np
    import torch
    from speedyml_torch import ReservoirConfig
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.ops.accum import accumulate_ss_scan
    from speedyml_torch.reservoir.generate import generate_esn
    from speedyml_torch.reservoir.training import (drive_and_accumulate,
                                                   drive_discard,
                                                   init_normal_eq,
                                                   ridge_solve)

    dev = torch.device("cuda")
    L, rcfg = build_layout(), ReservoirConfig()
    n = rcfg.nodes_per_input // L.n_in * L.n_in
    na = L.n_out + n
    Rb = region_block_for(na, torch.cuda.mem_get_info()[0], L.R)
    discard = max(1, rcfg.discardlength // rcfg.timestep)
    T = discard + 1 + TRAIN_SAMPLES
    g = torch.Generator(device=dev).manual_seed(SEED)
    u = torch.randn(T, Rb, L.n_in, device=dev, generator=g)
    y = torch.randn(T, Rb, L.n_out, device=dev, generator=g)
    m = torch.randn(T, Rb, L.n_out, device=dev, generator=g)
    radii = np.full(Rb, 0.9)
    print(f"training block: {Rb} regions, n={n}, na={na}, {discard} discard "
          f"+ {TRAIN_SAMPLES} pairs, chunk {TRAIN_CHUNK}")

    for rep in range(3):
        torch.cuda.reset_peak_memory_stats()
        times = {}

        def phase(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            return out

        params = phase("generate", lambda: generate_esn(
            SEED + rep, Rb, L.n_in, L.n_out, L.n_out,
            m_target=rcfg.nodes_per_input, deg=rcfg.degree, sigma=rcfg.sigma,
            leakage=rcfg.leakage, radii=radii, device=dev))
        x = phase("discard", lambda: drive_discard(
            params, torch.zeros((Rb, n), device=dev), u[:discard]))
        acc = init_normal_eq(params, L.n_out)._replace(x=x)
        acc = phase("drive + accumulate", lambda: drive_and_accumulate(
            params, acc, u[discard:-1], y[discard + 1:], m[discard + 1:],
            chunk=TRAIN_CHUNK))
        phase("ridge solve (f64 Cholesky)", lambda: ridge_solve(
            acc, L.n_out, rcfg.beta_res, rcfg.beta_model))

        # the kernel alone at the same shapes, by CUDA events
        aug = torch.randn(TRAIN_SAMPLES, Rb, na, device=dev, generator=g)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        accumulate_ss_scan(acc.ss_hi, acc.ss_lo, aug, TRAIN_CHUNK)
        stop.record()
        torch.cuda.synchronize()
        k_s = start.elapsed_time(stop) / 1e3
        del acc, aug, params
        total = sum(times.values())
        print(f"block repeat {rep + 1}: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in times.items())
            + f"; of the drive + accumulate, the kernel {1e3 * k_s:.2f} ms and the "
            f"drive + sy fold {times['drive + accumulate'] - k_s:.3f} s; "
            f"total {total:.3f} s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        torch.cuda.empty_cache()


def main():
    phase_device()
    profile_dry_window()
    profile_full_physics_window()
    profile_train_block()


if __name__ == "__main__":
    main()
