#!/usr/bin/env python3
"""Smoke run of speedyml_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from this checkout, holds it against its plain
PyTorch version at the shapes training gives it, then drives the port's main
path at reference width (T30L8 grid, 1152 region reservoirs of n=5760 nodes,
readout 1152 x 136 x 5896): it makes a dry-dycore truth series and an
imperfect-model series, trains every region's readout through `train_hybrid`
(whose normal equations go through the kernel), and runs closed-loop
dry-window hybrid steps with the readout in f32 and in bf16.

Every phase raises on failure, so any fault ends the run with a nonzero exit.
The line before the last is a JSON object with one entry per kernel wrapper
(its launches on the main path, its error against the plain version, its
time beside the plain version's, the card's bound for the same work and the
library's time for the product alone); the last line is
{"ok": true, "device": {...}}. There is no CPU
fallback: without a CUDA device the script exits nonzero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import time

SEED = 20240101
TRAIN_CHUNK = 128          # time steps per normal-equation fold
TRAIN_SAMPLES = 2 * TRAIN_CHUNK   # training pairs after the discard
PREDICT_STEPS = 6
N_SYNC = 40
# NVIDIA's data sheet for the H100 SXM: HBM bytes/s, dense TF32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12


def _cuda_ms(fn, reps):
    """Mean ms per call of fn() on the current stream, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_device():
    # the run drives one card: the first visible one
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0")
    os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0]
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}")
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    return name


def phase_build():
    from speedyml_torch.ops import accum
    t0 = time.perf_counter()
    path = accum.build(verbose=True)
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s")


def phase_kernel(R, T, chunk, na):
    """Both wrappers of the kernel against the plain version at the shapes
    one training block gives them (accumulate_ss_scan: the block's T-step
    series; accumulate_ss: its first chunk), the compensation property
    through the kernel, and the times of each beside the plain version's,
    the card's bound and torch.bmm for the chunk products alone."""
    import numpy as np
    import torch
    from speedyml_torch.ops import accum

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    aug = torch.randn(T, R, na, device=dev, generator=g)
    hi0 = 10.0 * torch.randn(R, na, na, device=dev, generator=g)
    wrappers = (
        ("accumulate_ss_scan", aug,
         lambda hi, lo: accum.accumulate_ss_scan(hi, lo, aug, chunk)),
        ("accumulate_ss", aug[:chunk],
         lambda hi, lo: accum.accumulate_ss(hi, lo, aug[:chunk])),
    )
    res = {}
    for name, a, kern in wrappers:
        hi_k, lo_k = hi0.clone(), torch.zeros_like(hi0)
        kern(hi_k, lo_k)
        # the plain version a few regions at a time, which keeps its
        # (R, na, na) temporaries small beside the full block's accumulators
        err = 0.0
        for r0 in range(0, R, 8):
            sl = slice(r0, r0 + 8)
            hi_p, lo_p = hi0[sl].clone(), torch.zeros_like(hi0[sl])
            accum.accumulate_ss_plain(hi_p, lo_p, a[:, sl], chunk)
            tot_k = hi_k[sl].double() + lo_k[sl].double()
            tot_p = hi_p.double() + lo_p.double()
            err = max(err, float((tot_k - tot_p).abs().max()))
            # rtol 1e-5: the kernel forms each product from three TF32
            # tensor-core products of split operands and folds every 32
            # steps, the plain version sums a chunk in f32 FMA order
            # (relative rounding ~6e-8 per term, growing with the term
            # count); entries that cancel to near zero get the same 1e-5 as
            # an absolute floor, scaled by the mean entry size
            scale = float(tot_p.abs().mean())
            if not torch.allclose(tot_k, tot_p, rtol=1e-5,
                                  atol=1e-5 * scale):
                raise AssertionError(f"{name} != plain in regions {r0}..: "
                                     f"max abs err {err:.3e} (entry scale "
                                     f"{scale:.3e})")
            del hi_p, lo_p, tot_k, tot_p
        print(f"{name} vs plain, R={R} T={a.shape[0]} na={na}: max |diff| "
              f"{err:.3e} over entries of mean size {scale:.3e} (rtol 1e-5)")

        # times, in turns (plain, kernel, kernel, plain) on one card; both
        # fold on into the same accumulators
        def run_p():
            accum.accumulate_ss_plain(hi_k, lo_k, a, chunk)

        def run_k():
            kern(hi_k, lo_k)

        run_k(), run_p()
        reps = 5
        p1 = _cuda_ms(run_p, reps)
        k1 = _cuda_ms(run_k, reps)
        k2 = _cuda_ms(run_k, reps)
        p2 = _cuda_ms(run_p, reps)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        flop = 2.0 * a.shape[0] * na * na * R
        print(f"{name} R={R} T={a.shape[0]} chunk={chunk} na={na}: kernel "
              f"{k_ms:.3f} ms ({flop / k_ms / 1e9:.2f} TFLOP/s), plain "
              f"{p_ms:.3f} ms ({flop / p_ms / 1e9:.2f} TFLOP/s) "
              f"[turns {p1:.3f} {k1:.3f} {k2:.3f} {p2:.3f}]")

        # the least time the card could take: hi and lo read once and
        # written once plus aug read once, over the HBM rate; against the
        # three TF32 products of the split operands over the tensor cores'
        # dense TF32 rate. The larger of the two is the bound.
        byte_ms = 1e3 * 4 * (4 * hi0.numel() + a.numel()) / HBM_BYTES_PER_S
        op_ms = 1e3 * 3 * flop / TF32_FLOP_PER_S

        # the library's time for the chunk products alone (no fold; the port
        # never calls it): torch.bmm in f32 on a (R, na, T) copy, into hi_k
        at = a.permute(1, 2, 0).contiguous()

        def run_l():
            for c0 in range(0, at.shape[2], chunk):
                blk = at[:, :, c0:c0 + chunk]
                torch.bmm(blk, blk.transpose(1, 2), out=hi_k)

        run_l()
        l_ms = _cuda_ms(run_l, reps)
        print(f"{name}: bound {max(byte_ms, op_ms):.3f} ms (bytes "
              f"{byte_ms:.3f}, operations {op_ms:.3f}); torch.bmm f32, "
              f"product only, {l_ms:.3f} ms")
        res[name] = dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms,
            bound_ms=max(byte_ms, op_ms),
            bound_by="bytes" if byte_ms >= op_ms else "operations",
            bound_bytes_ms=byte_ms, bound_operations_ms=op_ms,
            library_ms=l_ms, library_computes="product only")
        del hi_k, lo_k, at
    del hi0, aug

    # the compensation property (tests/test_ops.py:95-114) through the
    # single-chunk wrapper
    rng = np.random.default_rng(1)
    P = 128
    hi = torch.full((1, P, P), 1e6, device=dev)
    lo = torch.zeros_like(hi)
    ref64 = np.full((P, P), 1e6)
    plain = np.full((P, P), 1e6, np.float32)
    for _ in range(20):
        a = (rng.normal(size=(8, 1, P)) * 0.01).astype(np.float32)
        accum.accumulate_ss(hi, lo, torch.as_tensor(a, device=dev))
        d = np.einsum("tra,trb->rab", a.astype(np.float64),
                      a.astype(np.float64))[0]
        ref64 += d
        plain = (plain + d.astype(np.float32)).astype(np.float32)
    tot = hi.double().cpu().numpy()[0] + lo.double().cpu().numpy()[0]
    err_comp = float(np.abs(tot - ref64).max())
    err_plain = float(np.abs(plain.astype(np.float64) - ref64).max())
    if not err_comp < err_plain / 4:
        raise AssertionError(f"compensation lost: {err_comp} vs plain f32 "
                             f"{err_plain}")
    print(f"compensation: error {err_comp:.3e} vs plain f32 {err_plain:.3e}")
    return res


# ----------------------------------------------------------------------
# the main path
# ----------------------------------------------------------------------
def smooth_gridstate(dy, seed):
    """A smooth, physical grid state (tests/test_hybrid.py:23-49): T ~ 250 K,
    q ~ 5 g/kg, winds from band-limited vorticity and divergence."""
    import numpy as np
    import torch
    from speedyml_torch.hybrid.state_io import GridState

    rng = np.random.default_rng(seed)
    cfg = dy.config
    mx, nx, kx = cfg.mx, cfg.nx, cfg.kx

    def smooth_spec(scale):
        sp = rng.normal(size=(mx, 2, nx)) * np.exp(
            -0.1 * (np.arange(nx)[None, None, :]
                    + np.arange(mx)[:, None, None]))
        return dy.T.host_trunct(sp) * scale

    def smooth2d(scale):
        return dy.T.host_spec_to_grid(smooth_spec(scale))

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dy.dtype,
                               device=dy.device)

    t = 250.0 + np.stack([smooth2d(0.8) for _ in range(kx)])
    vor = np.stack([smooth_spec(1e-7) for _ in range(kx)])
    div = np.stack([smooth_spec(5e-8) for _ in range(kx)])
    u, v = dy.T.uv_grid(dev(vor), dev(div))
    q = 5.0 + np.stack([smooth2d(0.1) for _ in range(kx)])
    return GridState(t=dev(t), u=u, v=v, q=dev(q), logp=dev(smooth2d(0.005)))


def boundary_fns(dy):
    """sst_fn, tisr_fn for the dry window, which has no climatology: a
    zonal SST profile (272..300 K) and top-of-atmosphere insolation with its
    diurnal and seasonal cycle (0..1361 W/m^2), both analytic."""
    import numpy as np

    lat = np.asarray(dy.tables.radang)[:, None]                  # (il, 1)
    lon = 2.0 * np.pi * np.arange(dy.config.ix)[None, :] / dy.config.ix
    sst = np.broadcast_to(272.0 + 28.0 * np.cos(lat) ** 2,
                          (dy.config.il, dy.config.ix)).copy()

    def sst_fn(date):
        return sst

    def tisr_fn(date):
        doy = 30.4 * (date.imonth - 1) + date.iday
        dec = np.radians(23.44) * np.sin(2.0 * np.pi * (doy - 81) / 365.0)
        hour_angle = 2.0 * np.pi * (date.ihour - 12) / 24.0 + lon
        cosz = (np.sin(lat) * np.sin(dec)
                + np.cos(lat) * np.cos(dec) * np.cos(hour_angle))
        return 1361.0 * np.maximum(cosz, 0.0)

    return sst_fn, tisr_fn


def make_series(dy, fc, n_samples, seed, date0):
    """Truth: a smooth state chained through the dry 6-h window. Model: the
    same window from each truth state plus a small seeded perturbation,
    aligned so that index t is the forecast valid at t (index 0 = truth).
    Returns (atmo, logp, model_atmo, model_logp, precip, sst, tisr) series
    on the device; the dry window has no precipitation."""
    import torch
    from speedyml_torch import ModelDate
    from speedyml_torch.hybrid.experiment import atmo_to_grid, grid_to_atmo

    g = torch.Generator(device=dy.device).manual_seed(seed)
    atmo, logp, m_atmo, m_logp = [], [], [], []
    gs = smooth_gridstate(dy, seed)
    sst_fn, tisr_fn = boundary_fns(dy)
    sst, tisr = [], []
    date = ModelDate(date0.iyear, date0.imonth, date0.iday, date0.ihour)
    for t in range(n_samples):
        atmo.append(grid_to_atmo(gs))
        logp.append(gs.logp)
        sst.append(torch.as_tensor(sst_fn(date), device=dy.device))
        tisr.append(torch.as_tensor(tisr_fn(date), device=dy.device))
        if t == 0:
            m_atmo.append(atmo[0])
            m_logp.append(logp[0])
        if t + 1 == n_samples:
            break
        noise = [0.3, 0.3, 0.3, 0.05]      # T [K], u, v [m/s], q [g/kg]
        pert = torch.stack([
            atmo[-1][v] + s * torch.randn(atmo[-1][v].shape, generator=g,
                                          device=dy.device, dtype=dy.dtype)
            for v, s in enumerate(noise)])
        res_m = fc.forecast(atmo_to_grid(pert, gs.logp))
        res = fc.forecast(gs)
        if not bool(res.safe & res_m.safe):
            raise AssertionError(f"series left the safety bounds at {t}")
        m_atmo.append(grid_to_atmo(res_m.gs))
        m_logp.append(res_m.gs.logp)
        gs = res.gs
        date.advance_hours(fc.hours)
    precip = torch.zeros((n_samples,) + logp[0].shape, device=dy.device)
    return (torch.stack(atmo), torch.stack(logp), torch.stack(m_atmo),
            torch.stack(m_logp), precip, torch.stack(sst), torch.stack(tisr))


def region_block_for(na, free_bytes, R):
    """Regions per training block: the (Rb, na, na) f32 hi/lo pair plus the
    f64 system and its Cholesky factor at the solve, in half the free
    memory, rounded down to a multiple of 8."""
    per_region = na * na * (2 * 4 + 2 * 8)
    rb = int(0.5 * free_bytes / per_region) // 8 * 8
    return max(1, min(R, rb))


def phase_main_path(region_block):
    """Truth series -> train_hybrid (all regions, region_block at a time) ->
    closed-loop dry hybrid steps in f32 and bf16 wout."""
    import numpy as np
    import torch
    from speedyml_torch import ModelConfig, ModelDate, ReservoirConfig
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.dynamics.core import Dycore
    from speedyml_torch.hybrid.experiment import (HybridRunner,
                                                  transform_and_pack,
                                                  train_hybrid)
    from speedyml_torch.hybrid.forecast import SpeedyForecaster
    from speedyml_torch.hybrid.state_io import GridState, safety_check
    from speedyml_torch.reservoir.esn import cast_wout, readout

    dev = torch.device("cuda")
    rcfg = ReservoirConfig()
    dy = Dycore(ModelConfig())           # no device given: the card
    if dy.device.type != "cuda":
        raise AssertionError(f"Dycore() built on {dy.device}, not the card")
    fc = SpeedyForecaster(dy, hours=rcfg.timestep)
    L = build_layout(ix=dy.config.ix, il=dy.config.il, kx=dy.config.kx,
                     radang_deg=np.degrees(np.asarray(dy.tables.radang)))
    discard = max(1, rcfg.discardlength // rcfg.timestep)
    n_samples = discard + 1 + TRAIN_SAMPLES
    date0 = ModelDate(1982, 1, 1, 0)

    t0 = time.perf_counter()
    atmo, logp, m_atmo, m_logp, precip, sst, tisr = make_series(
        dy, fc, n_samples, SEED, date0)
    eps = rcfg.precip_epsilon
    gv_truth = transform_and_pack(L, atmo, logp, precip, sst, tisr, eps)
    gv_model = transform_and_pack(L, m_atmo, m_logp, precip, sst, tisr, eps)
    torch.cuda.synchronize()
    t_series = time.perf_counter() - t0
    print(f"series: {n_samples} truth + {n_samples - 1} model windows in "
          f"{t_series:.1f} s ({1e3 * t_series / (2 * n_samples - 1):.1f} "
          f"ms/window)")

    n = rcfg.nodes_per_input // L.n_in * L.n_in
    na = L.n_out + n
    nblocks = -(-L.R // region_block)
    t0 = time.perf_counter()
    hm = train_hybrid(L, rcfg, gv_truth, gv_model, seed=SEED,
                      region_block=region_block, chunk=TRAIN_CHUNK,
                      verbose=True)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    w = hm.params.wout
    if tuple(w.shape) != (L.R, L.n_out, na) or \
            not bool(torch.isfinite(w).all()):
        raise AssertionError(f"wout {tuple(w.shape)} is not a finite "
                             f"{(L.R, L.n_out, na)}")
    print(f"train_hybrid: {L.R} regions, na={na}, {nblocks} blocks of "
          f"{region_block}: {t_train:.1f} s total, "
          f"{t_train / nblocks:.2f} s/block")

    # closed loop from the last truth sample, reservoirs synchronized on the
    # samples before it
    x0 = hm.synchronize(gv_truth[-1 - N_SYNC:-1])
    sst_fn, tisr_fn = boundary_fns(dy)
    date = ModelDate(date0.iyear, date0.imonth, date0.iday, date0.ihour)
    date.advance_hours(rcfg.timestep * (n_samples - 1))
    results = {}
    for mode in ("f32", "bf16"):
        hm_m = hm if mode == "f32" else dataclasses.replace(
            hm, params=cast_wout(hm.params))
        runner = HybridRunner(hm_m, fc)
        x, a, lp, pt = x0, atmo[-1], logp[-1], torch.zeros_like(logp[-1])
        d = date
        step_ms = []
        for _ in range(PREDICT_STEPS):
            t1, t2 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t1.record()
            out = runner.run(x, a, lp, pt, d, 1, sst_fn, tisr_fn)
            t2.record()
            torch.cuda.synchronize()
            step_ms.append(t1.elapsed_time(t2))
            if out["aborted"]:
                raise AssertionError(f"{mode}: the safety gate tripped")
            x, a, lp, pt, d = (out["x"], out["atmo"][-1], out["logp"][-1],
                               out["precip_t"], out["date"])
            if not all(bool(torch.isfinite(v).all())
                       for v in (x, a, lp, pt)):
                raise AssertionError(f"{mode}: non-finite state")
        gs = GridState(t=a[0], u=a[1], v=a[2], q=a[3], logp=lp)
        if not bool(safety_check(gs)):
            raise AssertionError(f"{mode}: final state out of bounds")

        # the ESN part alone: pack + standardize + advance + readout +
        # scatter on the last state (the window excluded)
        sst, tisr = sst_fn(d), tisr_fn(d)
        gv = runner.pack(a, lp, pt, sst, tisr)
        model_gv, _ = runner.forecast_gv(a, lp, sst, tisr)
        esn_ms = _cuda_ms(lambda: hm_m.step(x, gv, model_gv), 5)
        win_ms = _cuda_ms(lambda: runner.forecast_gv(a, lp, sst, tisr), 3)
        results[mode] = dict(step_ms=statistics.median(step_ms), final=a)
        print(f"predict {mode} wout: {PREDICT_STEPS} steps, median "
              f"{results[mode]['step_ms']:.2f} ms/step "
              f"[{' '.join(f'{s:.1f}' for s in step_ms)}]; ESN part "
              f"{esn_ms:.2f} ms; window + pack {win_ms:.2f} ms; T "
              f"{float(a[0].min()):.1f}..{float(a[0].max()):.1f} K, "
              f"|u| <= {float(a[1].abs().max()):.1f} m/s")

    # the bf16 readout holds the documented bound against f32 (<2% of the
    # output scale, tests/test_reservoir.py:67-82), at full width
    mv = torch.randn((L.R, L.n_out), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED))
    full = readout(hm.params, x0, mv)
    fast = readout(cast_wout(hm.params), x0, mv)
    dev_rel = float((fast - full).abs().max()) / max(
        float(full.abs().mean()), 1.0)
    if not dev_rel < 0.02:
        raise AssertionError(f"bf16 readout off by {dev_rel:.3e} of scale")
    diff = float((results["bf16"]["final"] - results["f32"]["final"])
                 .abs().amax(dim=(1, 2, 3)).max())
    print(f"bf16 readout vs f32: {dev_rel:.2e} of output scale; after "
          f"{PREDICT_STEPS} steps max |bf16 - f32| {diff:.3e}")


def main():
    name = phase_device()
    phase_build()

    import torch
    from speedyml_torch import ReservoirConfig
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.ops import accum

    # the training block of the main path: every region's normal equations
    # are (na, na); the kernel is checked and timed at that block's shapes
    L, rcfg = build_layout(), ReservoirConfig()
    na = L.n_out + rcfg.nodes_per_input // L.n_in * L.n_in
    region_block = region_block_for(na, torch.cuda.mem_get_info()[0], L.R)
    kres = phase_kernel(region_block, TRAIN_SAMPLES, TRAIN_CHUNK, na)
    torch.cuda.empty_cache()     # hand the check's memory back for training

    # count only the main path's launches
    accum.accumulate_ss_scan.launches = 0
    accum.accumulate_ss.launches = 0
    phase_main_path(region_block)
    launches = accum.accumulate_ss_scan.launches
    if launches < 1:
        raise AssertionError("train_hybrid never launched the kernel")
    print(f"accumulate_ss_scan launches on the main path: {launches}")

    def entry(wrapper, replaces, n):
        return dict(name=wrapper, route="cuda",
                    source="speedyml_torch/ops/csrc/accum.cu",
                    replaces=replaces, launches=n, **kres[wrapper])

    # the single-chunk wrapper is the same kernel with T == chunk; training
    # does not call it, so it is checked and timed above but listed apart
    print(json.dumps({
        "kernels": [entry("accumulate_ss_scan", "speedyml/ops/accum.py:107",
                          launches)],
        "off_path": [entry("accumulate_ss", "speedyml/ops/accum.py:51",
                           accum.accumulate_ss.launches)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
