#!/usr/bin/env python3
"""Where the time of speedyml_torch's main path goes, on one NVIDIA GPU.

    python3 scripts_torch/profile_slice.py

Four measurements at the reference width of chip_smoke.py:

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
    includes the kernel build and the first CUDA calls;
  * one day of the training-data generator (`FusedDataGenerator._run_day`:
    four full-physics truth windows and four dry-core forecasts from the
    spun-up model) under torch.profiler, beside the host time of its day
    inputs (`_day_inputs`: fordate for the truth, four fresh-coupler
    forcings, one upload);
  * one chunk of the coupled closed loop (`ScanHybridRunner.run_chunk`, full
    physics, 4 steps) under torch.profiler, and the coupled step split into
    its parts: the window with its packing, the reservoir step, the weekly
    slab-ocean step with `compose_sst`, the host's precompute and upload of
    a 28-step chunk's boundary fields, and the download and write-out of a
    28-step chunk's trajectory. The hybrid's and the ocean's readouts are
    seeded random weights around the start state, so the numbers do not
    depend on a training run.

Needs a CUDA device; exits nonzero without one.
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (SEED, TRAIN_CHUNK, TRAIN_SAMPLES,  # noqa: E402
                        phase_device, smooth_gridstate)


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_window(label, run, nsteps):
    """One call of run() (a window, or a chunk of them) timed without the
    profiler and then under it: host clock, device time, launches, the top
    device kernels."""
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
    print(f"{label}: {host_ms:.2f} ms host clock, "
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
    print(f"{label} under the profiler: {prof_host_ms:.2f} ms host "
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
    profile_window("dry window", lambda: fc.forecast(gs), fc.nsteps_window + 1)


def spun_up_model():
    """The full-physics model on seeded stand-in boundary files, two days
    from rest."""
    from speedyml_torch import ModelConfig
    from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
    from speedyml_torch.model import Speedy

    with tempfile.TemporaryDirectory() as bindir:
        sp = Speedy(ModelConfig(), write_synthetic_boundary(bindir, SEED))
    sp.initialize(1982, 1)
    sp.run_days(2)
    return sp


def profile_full_physics_window(sp):
    import numpy as np
    import torch
    from speedyml_torch import ModelDate
    from speedyml_torch.hybrid.forecast import SpeedyForecaster
    from speedyml_torch.hybrid.state_io import extract

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
    profile_window("full-physics window", lambda: fc.window(gs, surf, forcing),
                   fc.nsteps_window + 1)


def profile_generator_day(sp):
    from speedyml_torch import FusedDataGenerator, ModelDate
    from speedyml_torch.hybrid.state_io import extract

    gen = FusedDataGenerator(sp)
    gen.date = ModelDate(sp.date.iyear, sp.date.imonth, sp.date.iday,
                         sp.date.ihour)
    gen.cs, gen.gs = sp.coupler, extract(sp.dy, sp.state, level=0)
    ms = _host_ms(gen._day_inputs)
    surf, forcing, dry, _ = gen._day_inputs()
    print(f"generator day inputs (fordate, {gen.wpd} fresh-coupler "
          f"forcings, one upload): {ms:.2f} ms on the host clock")
    nsteps = 2 * gen.wpd * (gen.fc_phys.nsteps_window + 1)
    profile_window(f"generator day ({gen.wpd} full-physics + {gen.wpd} dry "
                   f"windows)",
                   lambda: gen._run_day(gen.gs, surf, forcing, dry), nsteps)


def profile_train_block():
    import numpy as np
    import torch
    from speedyml_torch import ReservoirConfig
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.ops.accum import accumulate_ss_scan
    from speedyml_torch.reservoir.generate import generate_esn
    from speedyml_torch.hybrid.experiment import region_block_for
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


def _host_ms(fn, reps=3):
    """Median ms of fn() on the host clock, device work included."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def profile_coupled_chunk(sp):
    import dataclasses

    import numpy as np
    import torch
    from speedyml_torch import (ModelDate, OceanModel, ReservoirConfig,
                                ScanHybridRunner)
    from speedyml_torch.coupler.daily import init_coupler_state
    from speedyml_torch.domain.decomposition import build_layout, pack_global
    from speedyml_torch.domain.standardize import Standardizer
    from speedyml_torch.hybrid.experiment import HybridModel
    from speedyml_torch.device import Download
    from speedyml_torch.hybrid.state_io import extract
    from speedyml_torch.io.output import ForecastWriter
    from speedyml_torch.physics.radiation import diurnal_tisr
    from speedyml_torch.reservoir.generate import generate_esn
    from speedyml_torch.reservoir.slab import (build_ocean_layout,
                                               compose_week_inputs)

    dev = sp.device
    cfg = sp.config
    rcfg = ReservoirConfig()
    K = 4
    L = build_layout(ix=cfg.ix, il=cfg.il, kx=cfg.kx,
                     radang_deg=np.degrees(np.asarray(sp.dy.tables.radang)))
    ol = build_ocean_layout(L)
    g = torch.Generator(device=dev).manual_seed(SEED)
    date = ModelDate(sp.date.iyear, sp.date.imonth, sp.date.iday, 0)
    gs = extract(sp.dy, sp.state)
    atmo = torch.stack([gs.t, gs.u, gs.v, torch.clamp(gs.q, min=1e-6)])
    pr = torch.zeros_like(gs.logp)

    def model(idx, tidx, n_in, n_out, n_model, m_target, gv0):
        """Reservoirs with a small random readout and a standardizer
        anchored to the start state, so that the closed loop stays
        physical."""
        p = generate_esn(SEED, idx.shape[0], n_in, n_out, n_model,
                         m_target=m_target, deg=rcfg.degree, device=dev)
        p = dataclasses.replace(p, wout=0.003 * torch.randn(
            p.wout.shape, device=dev, generator=g))
        idx, tidx = (torch.as_tensor(a, dtype=torch.int64, device=dev)
                     for a in (idx, tidx))
        return p, Standardizer(
            in_mean=gv0[idx], in_std=torch.full(idx.shape, 5.0, device=dev),
            out_mean=gv0[tidx], out_std=torch.ones(tidx.shape, device=dev))

    def field(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    ss = torch.clamp(field(init_coupler_state(sp.clim, date).sst_am),
                     min=272.0)
    ti = field(diurnal_tisr(date.tyear, date.ihour, sp.dy.tables.gsin,
                            sp.dy.tables.gcos, cfg.ix))
    gv0 = pack_global(L, atmo, gs.logp, pr, ss, ti)
    params, stz = model(L.input_index, L.target_index, L.n_in, L.n_out,
                        L.n_out, rcfg.nodes_per_input, gv0)
    hm = HybridModel(L, params, stz, rcfg)
    o_params, o_stz = model(ol.input_index, ol.target_index, ol.n_in,
                            ol.n_out, 0, rcfg.slab_nodes, gv0)
    ocean = OceanModel(ol, o_params, o_stz, np.ones(ol.R, bool), rcfg)
    scan = ScanHybridRunner(hm, sp, physics=True)
    xs = scan._upload_fields(scan._precompute(date, K))
    x = 0.1 * torch.randn((L.R, params.n), device=dev, generator=g)
    anom = torch.zeros_like(gs.logp)

    def chunk():
        return scan.run_chunk(x, atmo, gs.logp, pr, anom, xs, K)

    res = chunk()
    if not bool(res.safe_st.all()):
        raise RuntimeError("the profiled chunk tripped the safety gate")
    profile_window(f"coupled chunk of {K} steps", chunk,
                   K * (scan.fc.nsteps_window + 1))

    # the coupled step by its parts
    win = _host_ms(lambda: scan._model_gv(atmo, gs.logp, xs.sst_clim[0], ss,
                                          ti, xs, 0))
    model_gv, _ = scan._model_gv(atmo, gs.logp, xs.sst_clim[0], ss, ti, xs, 0)
    esn = _host_ms(lambda: hm.step(x, gv0, model_gv), 5)
    x_oc = ocean.zero_state()
    clim = scan._precompute(date, 1).sst_clim[0]

    def ocean_step():
        gv_week = compose_week_inputs(res.gv_last, res.gv_sum, K, L)
        _, core = ocean.step(x_oc, gv_week)
        return ocean.compose_sst(core, clim, L)

    oc = _host_ms(ocean_step, 5)
    week = rcfg.timestep_slab // rcfg.timestep
    pre = _host_ms(lambda: scan._precompute(date, week))
    xs_week = scan._precompute(date, week)
    up = _host_ms(lambda: scan._upload_fields(xs_week), 5)
    stacks = [torch.randn((week,) + tuple(s), device=dev, generator=g)
              for s in (atmo.shape, pr.shape, pr.shape, pr.shape)]
    with tempfile.TemporaryDirectory() as tmp:
        with ForecastWriter(f"{tmp}/f.nc", cfg.kx, cfg.il, cfg.ix,
                            with_sst=True) as w:
            def flush():
                a, lp, p_log, sst = Download(stacks, week,
                                              scan._side).arrays()
                for j in range(week):
                    w.append(a[j], lp[j], precip_mm=p_log[j], sst=sst[j])

            fl = _host_ms(flush)
    print(f"coupled step by parts (host clock, device work included): window "
          f"+ pack {win:.2f} ms, reservoir step {esn:.2f} ms; once a week of "
          f"{week} steps: ocean step + compose_sst {oc:.2f} ms, host "
          f"precompute of the boundary fields {pre:.2f} ms ({pre / week:.2f} "
          f"a step), their upload {up:.2f} ms, download + write-out of the "
          f"trajectory {fl:.2f} ms ({fl / week:.2f} a step, beside the next "
          f"chunk)")


def main():
    phase_device()
    profile_dry_window()
    sp = spun_up_model()
    profile_full_physics_window(sp)
    profile_generator_day(sp)
    profile_coupled_chunk(sp)
    del sp
    import torch
    torch.cuda.empty_cache()    # the block is sized from the free memory
    profile_train_block()


if __name__ == "__main__":
    main()
