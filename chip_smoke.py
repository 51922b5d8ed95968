#!/usr/bin/env python3
"""Smoke run of speedyml_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from this checkout, holds it against its plain
PyTorch version at the shapes training gives it, then drives the port's main
paths at reference width (T30L8 grid, 1152 region reservoirs of n=5760 nodes,
readout 1152 x 136 x 5896):

  * the dry path: a dry-dycore truth series and an imperfect-model series,
    every region's readout trained through `train_hybrid` (whose normal
    equations go through the kernel), closed-loop dry-window hybrid steps
    with the readout in f32 and in bf16;
  * the full-physics path, the one the model's users run: seeded stand-in
    boundary files, the full-physics `Speedy` spun up from rest, a truth
    series through `TrajectoryRunner`, the imperfect-model series through a
    full-physics `SpeedyForecaster` with the truth's SST, training of all
    regions, and closed-loop hybrid steps on the runner's own climatological
    SST and diurnal TISR. One window is timed first and the series sized
    from it. The truth carries a seeded ENSO-like SST anomaly, so that the
    ocean has something to learn;
  * the coupled closed loop, on the same truth series: the slab-ocean
    reservoirs of all 1152 horizontal regions trained through `train_ocean`
    (n=4032; its normal equations go through the kernel too, at shapes the
    kernel is first held against its plain version at), the anomaly gate
    calibrated, the trained hybrid saved to a model file and loaded back
    onto the card, two ocean weeks (56 steps) of the full-physics hybrid
    through the chunked `ScanHybridRunner` with the ocean's weekly SST
    feedback, a forecast file and a checkpoint, one chunk under
    `torch.cuda.set_sync_debug_mode("error")`, and the per-step
    `HybridRunner` resuming the chunked loop's checkpoint for a week;
  * the ensemble, on the full-physics path's trained model: `EnsembleHybrid`
    with two members against two single-member steps, every output to the
    float32 readout's rounding (dry window; full-physics window in
    float64), then full-physics steps of 1 to 64 members (ms/step,
    gridpoints/s, peak memory, a guard against a readout that copies wout
    per member), the window/ESN split and bf16 grid with bf16 wout at 64;
  * bf16 grid compute: a day of the dry core in bf16 against f32 (the JAX
    test's bounds), `run_steps` in both, and closed-loop full-physics steps
    with the bf16 grid, beside the f32 steps above;
  * the training pipeline, the way the model's users make a model: a
    full-physics truth with its dry-core forecasts through
    `FusedDataGenerator` (one day of it with host syncs forbidden),
    `train_hybrid(also_ml=True)` over all regions with block checkpoints,
    a resume after deleting blocks (bitwise), the ML-only model
    (`ml_variant`) for one chunk of `ScanHybridRunner`, the series written
    as ERA-schema files, `train_from_era` on them (one step held against
    the in-memory model's), and hybrid steps of that model through
    `HybridRunner` on an `ObservedBoundary` over the files;
  * one training block at the reference's training length (16,060 pairs of
    random standardized series): the drive folds segment by segment, its
    peak memory held to the accumulators plus two segments and the block's
    to its budget plus two segments, the kernel's
    launches counted and its time over the whole series beside its bound.

Before these, the column physics on the card is held against the same code
on the CPU (asked for explicitly) in float64.

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
import tempfile
import time

SEED = 20240101
TRAIN_CHUNK = 128          # time steps per normal-equation fold
TRAIN_SAMPLES = 2 * TRAIN_CHUNK   # training pairs after the discard
PREDICT_STEPS = 3
N_SYNC = 40
# the dry path's training pairs after the discard (the pipeline's length:
# the script's run time is the smoke run's budget)
DRY_PAIRS = 64
# the full-physics path: days of spin-up from rest, the fewest and the most
# training pairs, and the run time [s] the series is sized to stay under.
# The fewest give 141 samples: five ocean weeks of 28, and train_ocean needs
# more than four
SPINUP_DAYS = 5
FULL_PAIRS = (100, 256)
TARGET_SECONDS = 600.0
# the coupled loop: steps of an ocean week, weeks through the chunked loop,
# and the hybrid steps the coupled phases take in all (two weeks chunked, one
# chunked again to the checkpoint, one per step from it), for the sizing
WEEK = 28
COUPLED_WEEKS = 2
COUPLED_STEPS = (2 * COUPLED_WEEKS) * WEEK
# series lengths the ocean's training can hand the kernel, held against the
# plain version at a small R: below one 8-step product block, below and
# just above one 32-step stage
SHORT_SERIES = (1, 3, 7, 8, 9, 33)
# the seeded SST anomaly of the truth [K, days]: large and fast enough to
# lift the weekly SST variance of the tropical Pacific regions over the
# ocean's activity threshold within a five-week series
ENSO = dict(seed=7, amp=2.5, period_days=56.0, ramp_days=3.0)
# chunked loop against the per-step loop over one week from one checkpoint,
# in float32 windows whose moist triggers amplify rounding: the first step's
# largest temperature difference [K] and the week's rms difference [K]
COUPLED_STEP1_TOL = 0.5
COUPLED_WEEK_RMS_TOL = 2.0
# windows inside the series have run up to 1.5 times as long as the one
# timed alone just before them (the host sets the pace, and it varies)
WINDOW_MARGIN = 1.5
# the training pipeline: pairs after the discard of its generated series,
# steps of the ML-only loop (one chunk), hybrid steps on the observed SST,
# the year its ERA-schema files are written for, the file-trained hybrid's
# step against the in-memory one's (of each field's range: the trained
# readouts differ as the float32 normal equations of slightly different q
# series round, PERF.md section 6 and tests/test_torch_training.py), and
# what the phase spends outside its windows [s]: two trainings with also_ml
# and their block files, the resume, train_from_era, the kernel check
PIPELINE_PAIRS = 64
ML_STEPS = 28
OBSERVED_STEPS = 3
PIPELINE_YEAR = 1982
FILE_MODEL_TOL = 5e-3
PIPELINE_FIXED_SECONDS = 150.0
# the ML-only model through the per-step runner against the chunked loop:
# the same float32 arithmetic on the same packed inputs, whose SST and TISR
# reach float32 from float64 host fields on two ways (largest |difference|
# over all fields and steps)
ML_LOOPS_TOL = 1e-3
# device bytes a training block holds per entry of its (na, na) systems at
# the solve: the f32 hi/lo pair (8), the f64 system and its Cholesky factor
# (16), and one for the solver's workspace and the block's other tensors
# (an also_ml block of 48 regions at na=5896 peaked at 24.96 bytes an entry
# on the H100, PERF.md section 5; 24 until then)
SOLVE_BYTES_PER_ENTRY = 25
# card against CPU, float64: of each output's largest value
PHYSICS_TOL = 1e-10
# the share of the free device memory a training block may budget for:
# its (na, na) systems, one drive segment and the series training keeps on
# the card (half, until the segment and the series were counted too)
BLOCK_MEMORY_SHARE = 0.55
# the ensemble on the full-physics path's trained model: members of the
# check against single-member steps, the widths of the sweep, warm-up and
# timed steps at each, and what the peak device memory may grow beyond E
# times one member's working set [bytes] (a readout that copied wout per
# member would add 3.7 GB a member)
ENSEMBLE_CHECK = 2
ENSEMBLE_SIZES = (1, 4, 16, 64)
ENSEMBLE_WARM = 1
ENSEMBLE_STEPS = 3
ENSEMBLE_SLACK_BYTES = 2e9
# the ensemble against single-member steps, every output, on the dry and
# the full-physics window: the bounds of tests/test_composed.py:117-150
# (rtol 3e-4; atmo atol 3e-4, logp and precip 1e-5, x 1e-4), the float32
# readout's rounding. The members' reservoir states differ by a factor 2:
# the check also holds member 0 outside them against member 1's step
ENSEMBLE_RTOL = 3e-4
ENSEMBLE_ATOL = dict(x=1e-4, atmo=3e-4, logp=1e-5, precip_t=1e-5)
# bf16 grid compute: one day of the dry core from rest over the stand-in
# orography in bf16 and in f32, held to tests/test_dynamics.py:116-141 (rms
# and largest temperature difference [K])
BF16_DAY_STEPS = 96
BF16_RMS_TOL = 0.2
BF16_MAX_TOL = 2.0
# one training block at the reference's training length
# (results/refscale_results.json n_train) and fold chunk
# (scripts/reference_scale.py --chunk)
LONG_PAIRS = 16060
LONG_CHUNK = 256
# what that block takes with its checks [s], for the sizing of the series
LONG_TRAINING_SECONDS = 60.0
# NVIDIA's data sheet for the H100 SXM: HBM bytes/s, dense TF32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12
# the card's name and power limit as nvidia-smi gives them (phase_device);
# the lines of the ensemble, bf16-grid and long-training phases carry it
CARD = "not read"


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
    global CARD
    CARD = smi.splitlines()[0]
    print(f"device: {name}")
    print(CARD)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    return name


def phase_build():
    from speedyml_torch.ops import accum
    t0 = time.perf_counter()
    path = accum.build(verbose=True)
    print(f"build: {path.name} in {time.perf_counter() - t0:.2f} s")


def phase_kernel(R, T, chunk, na, only_scan=False):
    """Both wrappers of the kernel against the plain version at the shapes
    one training block gives them (accumulate_ss_scan: the block's T-step
    series; accumulate_ss: its first chunk), the compensation property
    through the kernel, and the times of each beside the plain version's,
    the card's bound and torch.bmm for the chunk products alone. With
    only_scan, the series wrapper alone."""
    import numpy as np
    import torch
    from speedyml_torch.ops import accum

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    aug = torch.randn(T, R, na, device=dev, generator=g)
    hi0 = 10.0 * torch.randn(R, na, na, device=dev, generator=g)
    lo0 = 1e-6 * torch.randn(R, na, na, device=dev, generator=g)
    wrappers = (
        ("accumulate_ss_scan", aug,
         lambda hi, lo: accum.accumulate_ss_scan(hi, lo, aug, chunk)),
        ("accumulate_ss", aug[:chunk],
         lambda hi, lo: accum.accumulate_ss(hi, lo, aug[:chunk])),
    )
    res = {}
    for name, a, kern in wrappers[:1] if only_scan else wrappers:
        hi_k, lo_k = hi0.clone(), lo0.clone()
        kern(hi_k, lo_k)
        # the plain version a few regions at a time, which keeps its
        # (R, na, na) temporaries small beside the full block's accumulators
        err = 0.0
        for r0 in range(0, R, 8):
            sl = slice(r0, r0 + 8)
            hi_p, lo_p = hi0[sl].clone(), lo0[sl].clone()
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
        # aug^T aug is symmetric: the function needs one triangle,
        # na(na+1)/2 products of 2 FLOP a step and region (the kernel
        # computes both triangles)
        flop = 1.0 * a.shape[0] * na * (na + 1) * R
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
    del hi0, lo0, aug
    if only_scan:
        return res

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


def phase_kernel_short(na, R=8):
    """accumulate_ss_scan against the plain version at the short series the
    ocean's training can give it (SHORT_SERIES, chunk = min(16, T)) at the
    ocean's width, from nonzero hi and lo. Returns the largest difference."""
    import torch
    from speedyml_torch.ops import accum

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    hi0 = 10.0 * torch.randn(R, na, na, device=dev, generator=g)
    lo0 = 1e-6 * torch.randn(R, na, na, device=dev, generator=g)
    worst = 0.0
    for T in SHORT_SERIES:
        aug = torch.randn(T, R, na, device=dev, generator=g)
        hi_k, lo_k, hi_p, lo_p = (hi0.clone(), lo0.clone(), hi0.clone(),
                                  lo0.clone())
        accum.accumulate_ss_scan(hi_k, lo_k, aug, min(16, T))
        accum.accumulate_ss_plain(hi_p, lo_p, aug, min(16, T))
        tot_k = hi_k.double() + lo_k.double()
        tot_p = hi_p.double() + lo_p.double()
        err = float((tot_k - tot_p).abs().max())
        scale = float(tot_p.abs().mean())
        if not torch.allclose(tot_k, tot_p, rtol=1e-5, atol=1e-5 * scale):
            raise AssertionError(f"accumulate_ss_scan != plain at T={T}, "
                                 f"R={R}, na={na}: max abs err {err:.3e} "
                                 f"(entry scale {scale:.3e})")
        worst = max(worst, err)
    print(f"accumulate_ss_scan vs plain, R={R} na={na}, T in "
          f"{list(SHORT_SERIES)}: max |diff| {worst:.3e} (rtol 1e-5)")
    return worst


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


def segment_bytes(R, na, chunk):
    """Device bytes of one drive segment of a block of R regions: its
    augmented states (reservoir.training.fold_segment steps) and the
    kernel's scratch for one of its launches."""
    from speedyml_torch.ops import accum
    from speedyml_torch.reservoir.training import fold_segment
    seg = fold_segment(R, na, chunk, "cuda")
    kseg = accum.segment_steps(R, na)
    return 4 * (seg * R * na
                + accum._load().accum_ss_scratch_floats(kseg, R, na))


def region_block_for(na, free_bytes, R, series_bytes=0, chunk=TRAIN_CHUNK):
    """Regions per training block, a multiple of 8: SOLVE_BYTES_PER_ENTRY
    of each (na, na) system per region, one drive segment (segment_bytes)
    and the series training keeps on the card (series_bytes), in
    BLOCK_MEMORY_SHARE of the free memory."""
    per_region = na * na * SOLVE_BYTES_PER_ENTRY
    rb = min(R, int(BLOCK_MEMORY_SHARE * free_bytes / per_region)) // 8 * 8
    while rb > 8 and rb * per_region + segment_bytes(rb, na, chunk) \
            + series_bytes > BLOCK_MEMORY_SHARE * free_bytes:
        rb -= 8
    return max(1, rb)


def phase_main_path(region_block):
    """Truth series -> train_hybrid (all regions, region_block at a time) ->
    closed-loop dry hybrid steps in f32 and bf16 wout."""
    import numpy as np
    import torch
    from speedyml_torch import ModelConfig, ModelDate, ReservoirConfig
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.dynamics.core import Dycore
    from speedyml_torch.hybrid.experiment import (transform_and_pack,
                                                  train_hybrid)
    from speedyml_torch.hybrid.forecast import SpeedyForecaster

    rcfg = ReservoirConfig()
    dy = Dycore(ModelConfig())           # no device given: the card
    if dy.device.type != "cuda":
        raise AssertionError(f"Dycore() built on {dy.device}, not the card")
    fc = SpeedyForecaster.dry(dy, hours=rcfg.timestep)
    L = build_layout(ix=dy.config.ix, il=dy.config.il, kx=dy.config.kx,
                     radang_deg=np.degrees(np.asarray(dy.tables.radang)))
    discard = max(1, rcfg.discardlength // rcfg.timestep)
    n_samples = discard + 1 + DRY_PAIRS
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
    check_trained(hm, L, na)
    print(f"train_hybrid, dry: {L.R} regions, na={na}, {nblocks} blocks of "
          f"{region_block}: {t_train:.1f} s total, "
          f"{t_train / nblocks:.2f} s/block")

    # closed loop from the last truth sample, reservoirs synchronized on the
    # samples before it
    x0 = hm.synchronize(gv_truth[-1 - N_SYNC:-1])
    sst_fn, tisr_fn = boundary_fns(dy)
    date = ModelDate(date0.iyear, date0.imonth, date0.iday, date0.ihour)
    date.advance_hours(rcfg.timestep * (n_samples - 1))
    closed_loop("dry", hm, fc, x0, atmo[-1], logp[-1],
                torch.zeros_like(logp[-1]), date, sst_fn, tisr_fn)


def closed_loop(label, hm, fc, x0, atmo0, logp0, precip_t0, date, sst_fn,
                tisr_fn):
    """PREDICT_STEPS closed-loop hybrid steps with the readout in f32 and in
    bf16, each step timed by CUDA events; every state finite and inside the
    safety bounds, no abort; then the ESN part and the window alone, and the
    bf16 readout against the f32 one at full width. sst_fn/tisr_fn None
    means the runner's defaults. Returns {mode: its numbers}."""
    import torch
    from speedyml_torch.hybrid.experiment import HybridRunner
    from speedyml_torch.hybrid.state_io import GridState, safety_check
    from speedyml_torch.reservoir.esn import cast_wout, readout

    L = hm.layout
    dev = x0.device
    results = {}
    for mode in ("f32", "bf16"):
        hm_m = hm if mode == "f32" else dataclasses.replace(
            hm, params=cast_wout(hm.params))
        runner = HybridRunner(hm_m, fc)
        x, a, lp, pt, d = x0, atmo0, logp0, precip_t0, date
        step_ms = []
        for _ in range(PREDICT_STEPS):
            t1, t2 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t1.record()
            out = runner.run(x, a, lp, pt, d, 1, sst_fn, tisr_fn)
            t2.record()
            torch.cuda.synchronize()
            step_ms.append(t1.elapsed_time(t2))
            if out["aborted"]:
                raise AssertionError(f"{label} {mode}: the safety gate "
                                     f"tripped")
            x, a, lp, pt, d = (out["x"], out["atmo"][-1], out["logp"][-1],
                               out["precip_t"], out["date"])
            if not all(bool(torch.isfinite(v).all())
                       for v in (x, a, lp, pt)):
                raise AssertionError(f"{label} {mode}: non-finite state")
        gs = GridState(t=a[0], u=a[1], v=a[2], q=a[3], logp=lp)
        if not bool(safety_check(gs)):
            raise AssertionError(f"{label} {mode}: final state out of bounds")

        # the ESN part alone: pack + standardize + advance + readout +
        # scatter on the last state (the window excluded)
        sst = sst_fn(d) if sst_fn is not None else runner._sst(d)
        tisr = tisr_fn(d) if tisr_fn is not None else runner._tisr(d)
        gv = runner.pack(a, lp, pt, sst, tisr)
        model_gv, _ = runner.forecast_gv(a, lp, sst, tisr, d)
        esn_ms = _cuda_ms(lambda: hm_m.step(x, gv, model_gv), 5)
        win_ms = _cuda_ms(lambda: runner.forecast_gv(a, lp, sst, tisr, d), 3)
        results[mode] = dict(step_ms=statistics.median(step_ms),
                             step_min=min(step_ms), step_max=max(step_ms),
                             esn_ms=esn_ms, window_ms=win_ms, final=a)
        print(f"predict {label}, {mode} wout: {PREDICT_STEPS} steps, median "
              f"{results[mode]['step_ms']:.2f} ms/step "
              f"[{' '.join(f'{s:.1f}' for s in step_ms)}]; ESN part "
              f"{esn_ms:.2f} ms; window + pack {win_ms:.2f} ms; T "
              f"{float(a[0].min()):.1f}..{float(a[0].max()):.1f} K, "
              f"|u| <= {float(a[1].abs().max()):.1f} m/s, q <= "
              f"{float(a[3].max()):.1f} g/kg")

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
    print(f"{label}: bf16 readout vs f32: {dev_rel:.2e} of output scale; "
          f"after {PREDICT_STEPS} steps max |bf16 - f32| {diff:.3e}")
    return results


def check_trained(hm, L, na):
    import torch
    w = hm.params.wout
    if tuple(w.shape) != (L.R, L.n_out, na) or \
            not bool(torch.isfinite(w).all()):
        raise AssertionError(f"wout {tuple(w.shape)} is not a finite "
                             f"{(L.R, L.n_out, na)}")


# ----------------------------------------------------------------------
# the column physics, card against CPU
# ----------------------------------------------------------------------
def phase_physics_card_vs_cpu(bindir):
    """The float64 model on the card and on the CPU (asked for explicitly),
    from one state spun up on the card: `step_physics` with and without the
    shortwave step, and one physics-coupled `dy.step`. Every float output
    within PHYSICS_TOL of its largest value, every integer output equal."""
    import torch
    from speedyml_torch import ModelConfig, convert
    from speedyml_torch.dynamics.state import SpectralState
    from speedyml_torch.model import Speedy
    from speedyml_torch.physics.driver import RadCarry

    cfg = ModelConfig(dtype="float64")
    card = Speedy(cfg, bindir)
    host = Speedy(cfg, bindir, device="cpu")
    if card.device.type != "cuda" or host.device.type != "cpu":
        raise AssertionError(f"models on {card.device} and {host.device}")
    card.initialize(1982, 1)
    card.run_days(1)
    torch.cuda.synchronize()

    def to_host(tup):
        return type(tup)(*(v.cpu() for v in tup))

    host.coupler = convert.coupler_state(card.coupler)
    surf_c, forc_c = card.surf_forcing(card.date)
    surf_h, forc_h = host.surf_forcing(card.date)
    state_h, rad_h = to_host(card.state), to_host(card.rad)
    if not isinstance(state_h, SpectralState) or \
            not isinstance(rad_h, RadCarry):
        raise AssertionError("state types lost on the way to the host")

    worst = {}

    def compare(label, got, want):
        """got (card) against want (CPU), leaf by leaf."""
        for name, g, w in zip(want._fields, got, want):
            g = g.cpu()
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"{label}.{name}: {g.dtype} {g.shape} "
                                     f"against {w.dtype} {w.shape}")
            if not g.dtype.is_floating_point:
                if not torch.equal(g, w):
                    raise AssertionError(f"{label}.{name}: integers differ")
                continue
            scale = max(float(w.abs().max()), 1e-300)
            rel = float((g - w).abs().max()) / scale
            worst[f"{label}.{name}"] = rel
            if not rel <= PHYSICS_TOL:
                raise AssertionError(f"{label}.{name}: card and CPU differ "
                                     f"by {rel:.3e} of scale {scale:.3e}")

    from typing import NamedTuple

    class Tends(NamedTuple):
        du: torch.Tensor
        dv: torch.Tensor
        dtt: torch.Tensor
        dqt: torch.Tensor

    for lradsw in (True, False):
        tag = f"step_physics[sw={int(lradsw)}]"
        t_c, rad_c, fx_c = card.phys.step_physics(
            card.dy, card.state.at_level(0), surf_c, card.rad, lradsw)
        t_h, rad_n, fx_h = host.phys.step_physics(
            host.dy, state_h.at_level(0), surf_h, rad_h, lradsw)
        compare(tag + ".tend", Tends(*t_c), Tends(*t_h))
        compare(tag + ".rad", rad_c, rad_n)
        compare(tag + ".flux", fx_c, fx_h)
        conv = float((fx_h.precnv > 0).double().mean())
        if not 0.0 < conv < 1.0:
            raise AssertionError(f"convection active in {conv:.0%} of the "
                                 f"columns: the state does not exercise it")
    new_c, (rad_c, fx_c) = card.dy.step(
        card.state, forc_c, 1, 1, "delt2",
        card._phys_fn(surf_c, card.rad, True))
    new_h, (rad_n, fx_h) = host.dy.step(
        state_h, forc_h, 1, 1, "delt2", host._phys_fn(surf_h, rad_h, True))
    compare("dy.step.state", new_c, new_h)
    compare("dy.step.rad", rad_c, rad_n)
    compare("dy.step.flux", fx_c, fx_h)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:6]
    print(f"physics, card against CPU, float64: {len(worst)} outputs within "
          f"{PHYSICS_TOL:g} of scale, integers equal; convection in "
          f"{conv:.0%} of the columns; largest: "
          + ", ".join(f"{k} {v:.1e}" for k, v in top))


# ----------------------------------------------------------------------
# the full-physics path
# ----------------------------------------------------------------------
def phase_full_physics_path(bindir, region_block, t_run0):
    """Spin-up -> one timed window -> truth series (TrajectoryRunner) ->
    model series (full-physics forecaster, the truth's SST) -> train_hybrid
    over all regions -> closed-loop hybrid steps on the default SST and
    TISR. Returns the numbers it printed."""
    import numpy as np
    import torch
    from speedyml_torch import ModelConfig, ModelDate, ReservoirConfig
    from speedyml_torch.core.calendar import datetime_from_hours
    from speedyml_torch.coupler.anomaly import SyntheticEnso
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.hybrid.experiment import (collect_forecasts,
                                                  collect_truth,
                                                  transform_and_pack,
                                                  train_hybrid)
    from speedyml_torch.hybrid.forecast import (SpeedyForecaster,
                                                TrajectoryRunner)
    from speedyml_torch.hybrid.state_io import SAFE_BOUNDS
    from speedyml_torch.model import Speedy

    rcfg = ReservoirConfig()
    sp = Speedy(ModelConfig(), bindir)         # no device given: the card
    if sp.device.type != "cuda":
        raise AssertionError(f"Speedy() built on {sp.device}, not the card")
    cfg = sp.config
    L = build_layout(ix=cfg.ix, il=cfg.il, kx=cfg.kx,
                     radang_deg=np.degrees(np.asarray(sp.dy.tables.radang)))
    # the truth's SST carries a seeded anomaly from the series' first day on
    enso = SyntheticEnso(np.degrees(np.asarray(sp.dy.tables.radang)),
                         np.arange(cfg.ix) * 360.0 / cfg.ix,
                         sp.clim.fmask_s, t0=(1982, 1, 1 + SPINUP_DAYS),
                         **ENSO)
    runner = TrajectoryRunner(sp, hours=rcfg.timestep,
                              sst_anom_fn=enso.sst_anom_fn)
    fc = SpeedyForecaster(sp, hours=rcfg.timestep)

    t0 = time.perf_counter()
    runner.initialize(1982, 1, spinup_days=SPINUP_DAYS)
    torch.cuda.synchronize()
    t_spin = time.perf_counter() - t0
    print(f"full physics: rest start + {SPINUP_DAYS} days in {t_spin:.1f} s "
          f"({1e3 * t_spin / (SPINUP_DAYS * cfg.nsteps + 2):.1f} ms/step)")

    # one window first: its time sizes the series
    date = ModelDate(runner.date.iyear, runner.date.imonth, runner.date.iday,
                     runner.date.ihour)
    sst0 = np.asarray(runner.cs.sst_am)
    fc.forecast(runner.gs, date, sst_hybrid=sst0)            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    surf, forcing = fc._surf_forcing(date, sst0)
    torch.cuda.synchronize()
    sf_ms = 1e3 * (time.perf_counter() - t0)
    win_ms = [_cuda_ms(lambda: fc.window(runner.gs, surf, forcing), 1)
              for _ in range(3)]
    print(f"full-physics window: median {statistics.median(win_ms):.1f} ms "
          f"[{' '.join(f'{w:.1f}' for w in win_ms)}] by CUDA events; "
          f"_surf_forcing {sf_ms:.1f} ms on the host")
    discard = max(1, rcfg.discardlength // rcfg.timestep)
    per_window = WINDOW_MARGIN * (statistics.median(win_ms) + sf_ms) / 1e3
    # what the phases after the series take: the coupled loop's hybrid steps,
    # the ocean's training, the model file, the closed-loop steps; then the
    # pipeline phase: its spin-up, one day checked for host syncs, its series
    # (a full-physics and a dry window, a quarter of the time, a sample) and
    # its observed-SST steps
    pipeline = (4 * (SPINUP_DAYS + 1) + 1.25 * (discard + 1 + PIPELINE_PAIRS)
                + OBSERVED_STEPS) * per_window + PIPELINE_FIXED_SECONDS
    # the ensemble (its checks, sweep, split and bf16 steps, in windows of
    # one member: a step of 64 members took about one window, PERF.md
    # section 5) and the bf16-grid steps; the long training block
    ensemble = (3 * ENSEMBLE_CHECK + 2 + (len(ENSEMBLE_SIZES) + 1)
                * (ENSEMBLE_WARM + ENSEMBLE_STEPS) + 2 * (2 * PREDICT_STEPS
                                                          + 2)) * per_window
    reserve = (COUPLED_STEPS * per_window + 120.0 + pipeline + ensemble
               + LONG_TRAINING_SECONDS)
    left = TARGET_SECONDS - (time.perf_counter() - t_run0) - reserve
    pairs = FULL_PAIRS[0]
    for cand in FULL_PAIRS[1:]:
        if 2 * (discard + 1 + cand) * per_window < left:
            pairs = cand
    n_samples = discard + 1 + pairs
    print(f"series sized to {n_samples} samples ({discard} discard + "
          f"{pairs} pairs): {left:.0f} s left of {TARGET_SECONDS:.0f}, "
          f"{per_window:.2f} s a window allowed for")

    t0 = time.perf_counter()
    truth = collect_truth(runner, n_samples)
    torch.cuda.synchronize()
    t_truth = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_atmo, m_logp, m_precip = collect_forecasts(fc, truth)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    print(f"truth: {n_samples} samples in {t_truth:.1f} s "
          f"({t_truth / n_samples:.3f} s/sample); model: {n_samples - 1} "
          f"windows in {t_model:.1f} s ({t_model / (n_samples - 1):.3f} "
          f"s/window)")

    # what came out is weather: finite, inside the safety bounds, rain
    # somewhere and not everywhere
    for label, atmo, precip in (("truth", truth.atmo, truth.precip),
                                ("model", m_atmo, m_precip)):
        if not all(bool(torch.isfinite(v).all()) for v in (atmo, precip)):
            raise AssertionError(f"{label} series has non-finite values")
        for i, name in enumerate(("t", "u", "v", "q")):
            lo, hi = SAFE_BOUNDS[name]
            vmin, vmax = float(atmo[:, i].min()), float(atmo[:, i].max())
            if not (lo <= vmin and vmax <= hi):
                raise AssertionError(f"{label} {name} in {vmin:.1f}.."
                                     f"{vmax:.1f} leaves {lo}..{hi}")
        if float(precip.min()) < 0.0:
            raise AssertionError(f"{label} precipitation below zero")
    wet = float((truth.precip > 0.0).double().mean())
    if not 0.0 < wet < 1.0:
        raise AssertionError(f"rain in {wet:.0%} of the truth series: the "
                             f"moist schemes never fired, or always did")
    # convection in some columns and not in all, read from one physics step
    # on the model's last state
    _, _, fx = sp.phys.step_physics(sp.dy, inject_state(sp, runner.gs),
                                    surf, sp.rad, True)
    conv = float((fx.precnv > 0.0).double().mean())
    if not 0.0 < conv < 1.0:
        raise AssertionError(f"convection active in {conv:.0%} of columns")
    print(f"truth series: T {float(truth.atmo[:, 0].min()):.1f}.."
          f"{float(truth.atmo[:, 0].max()):.1f} K, |u| <= "
          f"{float(truth.atmo[:, 1].abs().max()):.1f} m/s, q <= "
          f"{float(truth.atmo[:, 3].max()):.1f} g/kg; rain in {wet:.0%} of "
          f"cells and windows, mean {float(truth.precip.mean()) * 4:.2f} "
          f"mm/day, max {float(truth.precip.max()):.1f} mm/6h; convection "
          f"in {conv:.0%} of the columns")

    eps = rcfg.precip_epsilon
    gv_truth = transform_and_pack(L, truth.atmo, truth.logp, truth.precip,
                                  truth.sst, truth.tisr, eps)
    gv_model = transform_and_pack(L, m_atmo, m_logp, m_precip, truth.sst,
                                  truth.tisr, eps)
    del m_atmo, m_logp, m_precip
    n = rcfg.nodes_per_input // L.n_in * L.n_in
    na = L.n_out + n
    nblocks = -(-L.R // region_block)
    t0 = time.perf_counter()
    hm = train_hybrid(L, rcfg, gv_truth, gv_model, seed=SEED,
                      region_block=region_block,
                      chunk=min(TRAIN_CHUNK, pairs), verbose=True)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    check_trained(hm, L, na)
    print(f"train_hybrid, full physics: {L.R} regions, na={na}, {pairs} "
          f"pairs, {nblocks} blocks of {region_block}: {t_train:.1f} s "
          f"total, {t_train / nblocks:.2f} s/block")

    # closed loop from the last truth sample on the runner's defaults:
    # climatological SST, analytic diurnal TISR
    x0 = hm.synchronize(gv_truth[-1 - N_SYNC:-1])
    date = ModelDate(*datetime_from_hours(int(truth.hours[-1])))
    precip_t = torch.log1p(torch.clamp(truth.precip[-1], min=0.0) / eps)
    res = closed_loop("full physics", hm, fc, x0, truth.atmo[-1],
                      truth.logp[-1], precip_t, date, None, None)
    del res["f32"]["final"], res["bf16"]["final"]
    torch.cuda.empty_cache()
    coupled = coupled_loop(sp, fc, hm, enso, truth, gv_truth, gv_model, x0,
                           precip_t, date)
    del gv_truth, gv_model
    torch.cuda.empty_cache()
    # the ensemble and bf16 grid compute on the same model and state
    sp16 = Speedy(ModelConfig(grid_compute="bfloat16"), bindir)
    sp64 = Speedy(ModelConfig(dtype="float64"), bindir)
    t0 = time.perf_counter()
    ens = phase_ensemble(sp, sp16, sp64, hm, x0, truth.atmo[-1],
                         truth.logp[-1], precip_t, date)
    del sp64
    print(f"phase ensemble: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bf16 = phase_bf16_grid(sp, sp16, hm, x0, truth.atmo[-1], truth.logp[-1],
                           precip_t, date)
    print(f"phase bf16 grid: {time.perf_counter() - t0:.1f} s")
    return dict(window_ms=statistics.median(win_ms), surf_forcing_ms=sf_ms,
                s_per_truth_sample=t_truth / n_samples, train_s=t_train,
                pairs=pairs, step_ms={m: r["step_ms"] for m, r in res.items()},
                coupled=coupled, ensemble=ens, bf16_grid=bf16)


# ----------------------------------------------------------------------
# the ensemble and bf16 grid compute, on the full-physics path's model
# ----------------------------------------------------------------------
def ensemble_members(x0, atmo0, logp0, precip_t0, E, seed):
    """E members around one state: the reservoir state and the fields
    repeated, every field but the first member's perturbed by 0.01 (seeded;
    q kept at or above QMIN), as bench.py:350-377 builds them."""
    import torch
    from speedyml_torch.hybrid.experiment import QMIN

    g = torch.Generator(device=x0.device).manual_seed(seed)
    atmo = atmo0.float()[None].repeat(E, 1, 1, 1, 1)
    atmo[1:] += 0.01 * torch.randn(atmo[1:].shape, device=x0.device,
                                   generator=g)
    atmo[:, 3] = torch.clamp(atmo[:, 3], min=QMIN)
    return (x0[None].repeat(E, 1, 1), atmo,
            logp0.float()[None].repeat(E, 1, 1),
            precip_t0.float()[None].repeat(E, 1, 1))


def phase_ensemble(sp, sp16, sp64, hm, x0, atmo0, logp0, precip_t0, date):
    """EnsembleHybrid at reference width on the full-physics path's trained
    model: E=2 against two single-member steps, every output held to
    ENSEMBLE_RTOL and ENSEMBLE_ATOL (the dry window of sp; the full-physics
    window of sp64, also held to the safety flags, finiteness and the
    safety bounds); the full-physics sweep
    over ENSEMBLE_SIZES (f32 grid, f32 wout; ms/step, gridpoints/s, peak
    memory, held to the wout guard); at the largest E the window/ESN split
    and the bf16-grid, bf16-wout setting. Returns the numbers."""
    import torch
    from speedyml_torch import EnsembleHybrid
    from speedyml_torch.hybrid.experiment import HybridRunner
    from speedyml_torch.hybrid.forecast import SpeedyForecaster
    from speedyml_torch.hybrid.state_io import SAFE_BOUNDS
    from speedyml_torch.reservoir.esn import cast_wout

    cfg = sp.config
    hours = hm.rcfg.timestep
    fc = SpeedyForecaster(sp, hours=hours)
    runner = HybridRunner(hm, fc)
    sst, tisr = runner._sst(date), runner._tisr(date)
    surf, forcing = fc._surf_forcing(date, sst)
    out = {}

    # E = 2 against two single-member steps of the port
    members = ensemble_members(x0, atmo0, logp0, precip_t0, ENSEMBLE_CHECK,
                               SEED + 5)
    members[0][1] *= 0.5
    # the full-physics window in float64, as tests/test_torch_ensemble.py
    # checks it: in float32 its moist triggers turn a rounding difference
    # into differences of whole fields (COUPLED_STEP1_TOL), which no bound
    # near the readout's rounding holds and a member mix-up could hide in
    for label, physics, sp_m in (("dry", False, sp),
                                 ("full physics", True, sp64)):
        fc_m = SpeedyForecaster(sp_m, hours=hours, physics=physics)
        run_m = HybridRunner(hm, fc_m)
        surf_m, forcing_m = fc_m._surf_forcing(date, sst)
        xe, ae, le, pe, safe = EnsembleHybrid(hm, fc_m).step(
            *members, sst, tisr, surf_m, forcing_m)
        atols = ENSEMBLE_ATOL
        names = ("x", "atmo", "logp", "precip_t")

        def off(got, want, name):
            # the largest difference over its bound
            return float(((got - want).abs() / (
                atols[name] + ENSEMBLE_RTOL * want.abs())).max())

        worst, singles = {}, []
        for m in range(ENSEMBLE_CHECK):
            x, a, lp, pt = (t[m] for t in members)
            gv = run_m.pack(a, lp, pt, sst, tisr)
            model_gv, ok = run_m.forecast_gv(a, lp, sst, tisr, date)
            singles.append(hm.step(x, gv, model_gv)[:4])
            if bool(ok) != bool(safe[m]):
                raise AssertionError(f"ensemble {label}: member {m}'s "
                                     f"safety flag differs")
            for name, got, want in zip(names, (xe[m], ae[m], le[m], pe[m]),
                                       singles[m]):
                worst[name] = max(worst.get(name, 0.0),
                                  float((got - want).abs().max()))
                if off(got, want, name) > 1.0:
                    raise AssertionError(
                        f"ensemble {label}: member {m} {name} off by "
                        f"{float((got - want).abs().max()):.3e} (rtol "
                        f"{ENSEMBLE_RTOL}, atol {atols[name]})")
        # the bounds tell the members apart: member 0's outputs against
        # member 1's single step lie outside them in every output
        mixed = {name: off(got, want, name) for name, got, want in zip(
            names, (xe[0], ae[0], le[0], pe[0]), singles[1])}
        if min(mixed.values()) <= 1.0:
            raise AssertionError(f"ensemble {label}: the bounds do not tell "
                                 f"the members apart: {mixed}")
        del singles
        if physics:
            if not (bool(safe.all()) and all(bool(torch.isfinite(t).all())
                                             for t in (xe, ae, le, pe))):
                raise AssertionError("ensemble full physics: unsafe or "
                                     "non-finite members")
            for i, name in enumerate(("t", "u", "v", "q")):
                lo, hi = SAFE_BOUNDS[name]
                if not (lo <= float(ae[:, i].min())
                        and float(ae[:, i].max()) <= hi):
                    raise AssertionError(f"ensemble {name} leaves {lo}..{hi}")
        out[f"check_{label.replace(' ', '_')}_max_abs"] = worst
        out[f"check_{label.replace(' ', '_')}_mixed_over_bound"] = mixed
        print(f"ensemble E={ENSEMBLE_CHECK}, {label} window, against "
              f"single-member steps: max |diff| " + ", ".join(
                  f"{k} {v:.3e} (atol {atols[k]})" for k, v in worst.items())
              + f", rtol {ENSEMBLE_RTOL}; member 0 against member 1's step "
              f"over the bound by " + ", ".join(
                  f"{k} {v:.3g}x" for k, v in mixed.items()))
    del members, xe, ae, le, pe

    # the sweep: full physics, f32 grid and f32 wout
    gp = cfg.ix * cfg.il * cfg.kx
    sweep = {}
    eh = EnsembleHybrid(hm, fc)
    R, n = hm.params.win.shape
    for E in ENSEMBLE_SIZES:
        members = ensemble_members(x0, atmo0, logp0, precip_t0, E, SEED + E)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state = members
        for _ in range(ENSEMBLE_WARM):
            *state, safe = eh.step(*state, sst, tisr, surf, forcing)
        ms = []
        for _ in range(ENSEMBLE_STEPS):
            t1, t2 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t1.record()
            *state, safe = eh.step(*state, sst, tisr, surf, forcing)
            t2.record()
            torch.cuda.synchronize()
            ms.append(t1.elapsed_time(t2))
        if not bool(safe.all()) or not all(bool(torch.isfinite(t).all())
                                           for t in state):
            raise AssertionError(f"ensemble E={E}: unsafe or non-finite")
        peak = torch.cuda.max_memory_allocated()
        step_ms = statistics.median(ms)
        sweep[E] = dict(step_ms=step_ms, steps_ms=ms,
                        gridpoints_per_s=E * gp / (step_ms / 1e3),
                        peak_gib=peak / 2**30, own_bytes=peak - before)
        print(f"ensemble E={E}: median {step_ms:.2f} ms/step "
              f"[{' '.join(f'{t:.1f}' for t in ms)}] by CUDA events, "
              f"{sweep[E]['gridpoints_per_s']:.4e} gridpoints/s, peak device "
              f"memory {peak / 2**30:.2f} GiB ({(peak - before) / 2**30:.3f} "
              f"GiB over what the run held) [{CARD}]")
        del members, state
        torch.cuda.empty_cache()
    # the readout must read wout once for all members: beyond one member,
    # the step may hold no more than E times one member's working set
    # (measured at E=1, the window's temporaries included) plus
    # ENSEMBLE_SLACK_BYTES; a wout copied per member adds 3.7 GB each
    one = sweep[ENSEMBLE_SIZES[0]]["own_bytes"]
    for E, r in sweep.items():
        allowed = E * one + ENSEMBLE_SLACK_BYTES
        if r["own_bytes"] > allowed:
            raise AssertionError(f"ensemble E={E} held {r['own_bytes']:.3e} "
                                 f"bytes, over {allowed:.3e}: is wout copied "
                                 f"per member?")
    Emax = ENSEMBLE_SIZES[-1]
    print(f"ensemble memory guard: at E={Emax} the step held "
          f"{sweep[Emax]['own_bytes'] / 1e9:.3f} GB against "
          f"{(Emax * one + ENSEMBLE_SLACK_BYTES) / 1e9:.3f} allowed "
          f"({one / 1e6:.1f} MB a member at E=1, + "
          f"{ENSEMBLE_SLACK_BYTES / 1e9:.0f} GB); a wout per member would "
          f"add {hm.params.wout.numel() * 4 / 1e9:.2f} GB each")

    # the window/ESN split at the largest E (bench.py:380-449)
    x_e, a_e, l_e, p_e = ensemble_members(x0, atmo0, logp0, precip_t0, Emax,
                                          SEED + Emax)
    gv, model_gv, _ = eh.forecast(a_e, l_e, p_e, sst, tisr, surf, forcing)
    win_ms = _cuda_ms(lambda: eh.forecast(a_e, l_e, p_e, sst, tisr, surf,
                                          forcing), ENSEMBLE_STEPS)
    esn_ms = _cuda_ms(lambda: eh.exchange(x_e, gv, model_gv),
                      ENSEMBLE_STEPS)
    print(f"ensemble E={Emax} split: window + packs {win_ms:.2f} ms, ESN "
          f"part (standardize, advance, one readout for all members, "
          f"scatter) {esn_ms:.2f} ms, by CUDA events [{CARD}]")

    # the reference ensemble's setting: bf16 grid compute, bf16 wout
    hm16 = dataclasses.replace(hm, params=cast_wout(hm.params))
    fc16 = SpeedyForecaster(sp16, hours=hours)
    surf16, forcing16 = fc16._surf_forcing(date, sst)
    eh16 = EnsembleHybrid(hm16, fc16)
    state = (x_e, a_e, l_e, p_e)
    *state, safe = eh16.step(*state, sst, tisr, surf16, forcing16)
    ms16 = []
    for _ in range(ENSEMBLE_STEPS):
        t1, t2 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t1.record()
        *state, safe = eh16.step(*state, sst, tisr, surf16, forcing16)
        t2.record()
        torch.cuda.synchronize()
        ms16.append(t1.elapsed_time(t2))
    if not bool(safe.all()) or not all(bool(torch.isfinite(t).all())
                                       for t in state):
        raise AssertionError("ensemble bf16: unsafe or non-finite")
    step16 = statistics.median(ms16)
    print(f"ensemble E={Emax}, bf16 grid + bf16 wout: median {step16:.2f} "
          f"ms/step [{' '.join(f'{t:.1f}' for t in ms16)}], "
          f"{Emax * gp / (step16 / 1e3):.4e} gridpoints/s [{CARD}]")
    del hm16, state, x_e, a_e, l_e, p_e, gv, model_gv
    torch.cuda.empty_cache()
    for r in sweep.values():
        del r["own_bytes"]
    out.update(sweep=sweep, split_E=Emax, window_ms=win_ms, esn_ms=esn_ms,
               bf16_step_ms=step16, bf16_steps_ms=ms16)
    return out


def phase_bf16_grid(sp, sp16, hm, x0, atmo0, logp0, precip_t0, date):
    """bf16 grid compute: one day of the dry core from rest over the
    stand-in orography in bf16 and in f32 (held to BF16_RMS_TOL and
    BF16_MAX_TOL), run_steps ms/step in each, and closed-loop full-physics
    hybrid steps with the bf16 grid (f32 and bf16 wout; closed_loop).
    Returns the numbers."""
    import torch
    from speedyml_torch.dynamics.initial import rest_state
    from speedyml_torch.hybrid.forecast import SpeedyForecaster

    out = {}
    tg = {}
    for dy in (sp16.dy, sp.dy):
        tag = "bf16" if dy.grid_dtype is not None else "f32"
        f = dy.zero_forcing()
        s1 = dy.stepone(rest_state(dy), f)
        s = dy.run_steps(s1, f, BF16_DAY_STEPS)
        tg[tag] = dy.T.spec_to_grid(s.t[0])
        if not bool(torch.isfinite(tg[tag]).all()):
            raise AssertionError(f"the {tag} dry day is not finite")
        dy.run_steps(s1, f, 2)                                   # warm-up
        out[f"run_steps_ms_{tag}"] = _cuda_ms(
            lambda: dy.run_steps(s1, f, 24), 1) / 24
    d = (tg["bf16"] - tg["f32"]).double()
    rms, mx = float(d.square().mean().sqrt()), float(d.abs().max())
    if not (rms < BF16_RMS_TOL and mx < BF16_MAX_TOL):
        raise AssertionError(f"bf16 dry day off f32 by rms {rms:.3f} K, max "
                             f"{mx:.3f} K (bounds {BF16_RMS_TOL}, "
                             f"{BF16_MAX_TOL})")
    print(f"bf16 grid, dry day from rest ({BF16_DAY_STEPS} steps): T against "
          f"f32 rms {rms:.4f} K, max {mx:.4f} K (bounds {BF16_RMS_TOL}, "
          f"{BF16_MAX_TOL}); run_steps {out['run_steps_ms_bf16']:.3f} "
          f"ms/step bf16, {out['run_steps_ms_f32']:.3f} f32, by CUDA events "
          f"[{CARD}]")
    out.update(dry_day_rms_k=rms, dry_day_max_k=mx)
    fc16 = SpeedyForecaster(sp16, hours=hm.rcfg.timestep)
    res = closed_loop("full physics, bf16 grid", hm, fc16, x0, atmo0, logp0,
                      precip_t0, date, None, None)
    out["step_ms"] = {"bf16_grid": res["f32"]["step_ms"],
                      "bf16_grid_bf16_wout": res["bf16"]["step_ms"]}
    return out


# ----------------------------------------------------------------------
# one training block at the reference's training length
# ----------------------------------------------------------------------
def phase_long_training(region_block):
    """One training block of region_block regions over LONG_PAIRS pairs of
    random standardized series (as scripts_torch/profile_slice.py builds
    them), chunk LONG_CHUNK: the drive folds segment by segment, so its
    peak device memory stays within the accumulators plus two segments, and
    the block's (drive and solve) within its hi/lo/solver budget plus two
    segments. Then the kernel alone over the whole series (by CUDA events,
    beside its bound), held against the plain version over its first two
    kernel segments, and torch.bmm for one segment's chunk products.
    Returns the numbers."""
    import numpy as np
    import torch
    from speedyml_torch import ReservoirConfig
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.ops import accum
    from speedyml_torch.reservoir.generate import generate_esn
    from speedyml_torch.reservoir.training import (drive_and_accumulate,
                                                   drive_discard,
                                                   fold_segment,
                                                   init_normal_eq,
                                                   ridge_solve)

    dev = torch.device("cuda")
    L, rcfg = build_layout(), ReservoirConfig()
    n = rcfg.nodes_per_input // L.n_in * L.n_in
    na = L.n_out + n
    Rb = region_block
    discard = max(1, rcfg.discardlength // rcfg.timestep)
    T = discard + 1 + LONG_PAIRS
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    u = torch.randn(T, Rb, L.n_in, device=dev, generator=g)
    y = torch.randn(T, Rb, L.n_out, device=dev, generator=g)
    m = torch.randn(T, Rb, L.n_out, device=dev, generator=g)
    params = generate_esn(SEED, Rb, L.n_in, L.n_out, L.n_out,
                          m_target=rcfg.nodes_per_input, deg=rcfg.degree,
                          sigma=rcfg.sigma, leakage=rcfg.leakage,
                          radii=np.full(Rb, 0.9), device=dev)
    x = drive_discard(params, torch.zeros((Rb, n), device=dev), u[:discard])
    seg = fold_segment(Rb, na, LONG_CHUNK, dev)
    kseg = accum.segment_steps(Rb, na)
    # the block's own memory, from its accumulators on: over the drive
    # alone (the series' augmented states held one segment at a time), and
    # over the drive and the solve (which sets the block's peak)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    acc = init_normal_eq(params, L.n_out)._replace(x=x)
    acc_b = sum(t.numel() * t.element_size() for t in acc)
    torch.cuda.reset_peak_memory_stats()
    launches = accum.accumulate_ss_scan.launches
    t0 = time.perf_counter()
    acc = drive_and_accumulate(params, acc, u[discard:-1], y[discard + 1:],
                               m[discard + 1:], chunk=LONG_CHUNK)
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    drive_peak = torch.cuda.max_memory_allocated() - before
    after = accum.accumulate_ss_scan.launches
    n_launch = after - launches
    t0 = time.perf_counter()
    wout = ridge_solve(acc, L.n_out, rcfg.beta_res, rcfg.beta_model)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    if not bool(torch.isfinite(wout).all()):
        raise AssertionError("long training: the readout is not finite")
    pairs = LONG_PAIRS // LONG_CHUNK * LONG_CHUNK
    # each drive segment is one call of the kernel's wrapper, one launch per
    # kernel segment of it (one call over the whole series, where seg is a
    # multiple of kseg)
    want_launches = pairs // seg * -(-seg // kseg) + -(-(pairs % seg) // kseg)
    if n_launch != want_launches:
        raise AssertionError(f"long training: {n_launch} launches counted, "
                             f"{want_launches} expected")
    seg_b = segment_bytes(Rb, na, LONG_CHUNK)
    # the drive holds the accumulators and a segment: the whole series'
    # augmented states would add 4 * pairs * Rb * na bytes
    if drive_peak > acc_b + 2 * seg_b:
        raise AssertionError(f"long training: the drive's peak "
                             f"{drive_peak / 2**30:.2f} GiB over the "
                             f"accumulators {acc_b / 2**30:.2f} + two "
                             f"segments {2 * seg_b / 2**30:.2f} GiB")
    budget = Rb * na * na * SOLVE_BYTES_PER_ENTRY
    if peak > budget + 2 * seg_b:
        raise AssertionError(f"long training: peak {peak / 2**30:.2f} GiB "
                             f"over the budget {budget / 2**30:.2f} + two "
                             f"segments {2 * seg_b / 2**30:.2f} GiB")
    del wout, u, y, m
    torch.cuda.empty_cache()

    # the kernel alone over the whole series, into the block's hi/lo
    aug = torch.randn(pairs, Rb, na, device=dev, generator=g)
    accum.accumulate_ss_scan(acc.ss_hi, acc.ss_lo, aug, LONG_CHUNK)
    k_ms = _cuda_ms(lambda: accum.accumulate_ss_scan(
        acc.ss_hi, acc.ss_lo, aug, LONG_CHUNK), 2)
    flop = 1.0 * pairs * na * (na + 1) * Rb   # one triangle (phase_kernel)
    byte_ms = 1e3 * 4 * (4 * acc.ss_hi.numel() + aug.numel()) \
        / HBM_BYTES_PER_S
    op_ms = 1e3 * 3 * flop / TF32_FLOP_PER_S
    # what the segments add: hi and lo read and written once per launch
    seg_byte_ms = 1e3 * 4 * (4 * acc.ss_hi.numel() * want_launches
                             + aug.numel()) / HBM_BYTES_PER_S
    # torch.bmm for one kernel segment's chunk products (no fold)
    at = aug[:kseg].permute(1, 2, 0).contiguous()

    def run_l():
        for c0 in range(0, kseg, LONG_CHUNK):
            blk = at[:, :, c0:c0 + LONG_CHUNK]
            torch.bmm(blk, blk.transpose(1, 2), out=acc.ss_hi)

    run_l()
    l_ms = _cuda_ms(run_l, 3)
    del at, aug, acc
    torch.cuda.empty_cache()
    print(f"long training: {Rb} regions, na={na}, {discard} discard + "
          f"{pairs} pairs folded (chunk {LONG_CHUNK}, drive segments of "
          f"{seg}, kernel segments of {kseg}): drive + fold {drive_s:.2f} s, "
          f"ridge solve {solve_s:.2f} s; {n_launch} kernel launches; peak "
          f"device memory over the drive {drive_peak / 2**30:.2f} GiB "
          f"(accumulators {acc_b / 2**30:.2f} + two segments "
          f"{2 * seg_b / 2**30:.2f}; the whole series' augmented states "
          f"would add {4 * pairs * Rb * na / 2**30:.2f}), over drive and "
          f"solve {peak / 2**30:.2f} GiB (budget {budget / 2**30:.2f} + two "
          f"segments) [{CARD}]")
    print(f"long training kernel: R={Rb} T={pairs} na={na}: {k_ms:.2f} ms "
          f"by CUDA events ({flop / k_ms / 1e9:.2f} TFLOP/s), bound "
          f"{max(byte_ms, op_ms):.2f} ms (bytes {byte_ms:.2f}, operations "
          f"{op_ms:.2f}; hi/lo re-read and re-written by each of the "
          f"{want_launches} launches: {seg_byte_ms:.2f}); torch.bmm f32, "
          f"product only, one segment of {kseg}: {l_ms:.3f} ms [{CARD}]")
    # the kernel against the plain version over the first two segments
    first = phase_kernel(Rb, 2 * kseg, LONG_CHUNK, na, only_scan=True)
    res = first["accumulate_ss_scan"]
    # the launches of the checks are not the path's
    accum.accumulate_ss_scan.launches = after
    return dict(T=pairs, R=Rb, na=na, launches=n_launch, drive_s=drive_s,
                solve_s=solve_s, drive_peak_gib=drive_peak / 2**30,
                accumulators_gib=acc_b / 2**30, peak_gib=peak / 2**30,
                budget_gib=budget / 2**30, segment_gib=seg_b / 2**30,
                ms=k_ms, bound_ms=max(byte_ms, op_ms),
                bound_by="bytes" if byte_ms >= op_ms else "operations",
                bound_bytes_ms=byte_ms, bound_operations_ms=op_ms,
                segment_bytes_ms=seg_byte_ms,
                library_ms_one_segment=l_ms,
                checked_T=2 * kseg, max_abs_err=res["max_abs_err"],
                plain_ms_checked_T=res["plain_ms"], ms_checked_T=res["ms"])


# ----------------------------------------------------------------------
# the coupled closed loop
# ----------------------------------------------------------------------
def coupled_loop(sp, fc, hm, enso, truth, gv_truth, gv_model, x0, precip_t0,
                 date):
    """On the full-physics path's truth series and trained hybrid: the
    kernel at the ocean's shapes, train_ocean over all regions, the gate,
    the model file there and back, COUPLED_WEEKS ocean weeks through the
    chunked loop with a writer and a checkpoint, one chunk with host syncs
    forbidden, a week chunked again to a checkpoint, and the per-step runner
    resuming that checkpoint. Returns the numbers it printed."""
    import numpy as np
    import torch
    from speedyml_torch import (ScanHybridRunner, load_model, save_model,
                                train_ocean)
    from speedyml_torch.hybrid.experiment import HybridRunner
    from speedyml_torch.hybrid.state_io import SAFE_BOUNDS
    from speedyml_torch.io.checkpoint import load_prediction
    from speedyml_torch.io.output import ForecastWriter, read_forecast
    from speedyml_torch.ops import accum
    from speedyml_torch.reservoir.slab import (build_ocean_layout,
                                               training_anomaly_std,
                                               weekly_ocean_inputs)

    L, rcfg = hm.layout, hm.rcfg
    cfg = sp.config
    out = {}
    spw = rcfg.timestep_slab // rcfg.timestep
    if spw != WEEK:
        raise AssertionError(f"an ocean week is {spw} steps, not {WEEK}")
    ol = build_ocean_layout(L)
    n_o = round(rcfg.slab_nodes / ol.n_in) * ol.n_in
    weeks = gv_truth.shape[0] // spw
    discard = max(1, min(weeks // 4, 8))
    T_o = weeks - discard - 1             # the pairs train_ocean folds
    rb = region_block_for(n_o, torch.cuda.mem_get_info()[0], ol.R)

    # the kernel at the shapes the ocean's training gives it, before the
    # training; these launches are not the path's
    launches = accum.accumulate_ss_scan.launches
    at_ocean = phase_kernel(rb, T_o, min(16, T_o), n_o, only_scan=True)
    out["at_ocean_shape"] = dict(T=T_o, R=rb, na=n_o,
                                 **at_ocean["accumulate_ss_scan"])
    out["short_series_max_abs_err"] = phase_kernel_short(n_o)
    accum.accumulate_ss_scan.launches = launches
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ocean = train_ocean(L, rcfg, gv_truth, seed=SEED, region_block=rb)
    torch.cuda.synchronize()
    out["ocean_train_s"] = time.perf_counter() - t0
    out["launches_ocean_training"] = \
        accum.accumulate_ss_scan.launches - launches
    w = ocean.params.wout
    if tuple(w.shape) != (ol.R, ol.n_out, n_o) or \
            not bool(torch.isfinite(w).all()) or not w.is_cuda:
        raise AssertionError(f"ocean wout {tuple(w.shape)} on {w.device} is "
                             f"not a finite {(ol.R, ol.n_out, n_o)} on the "
                             f"card")
    n_active = int(ocean.active.sum())
    if n_active < 1:
        raise AssertionError("no ocean region passed the SST variance "
                             "threshold")
    train_std = training_anomaly_std(sp.clim, truth.hours, truth.sst)
    gate, ol_rms, pers_rms = ocean.calibrate_gate(
        gv_truth, L, discard=discard, train_anom_std=train_std)
    if not np.isfinite(gate).all():
        raise AssertionError("the anomaly gate is not finite")
    out.update(ocean_regions=ol.R, ocean_active=n_active,
               ocean_blocks=-(-ol.R // rb), ocean_region_block=rb,
               ocean_weeks=weeks, ocean_pairs=T_o)
    print(f"train_ocean: {ol.R} regions, n={n_o}, {weeks} weeks "
          f"({T_o} pairs after {discard} discarded), "
          f"{out['ocean_blocks']} blocks of {rb}: {out['ocean_train_s']:.1f}"
          f" s, {out['launches_ocean_training']} kernel launches; "
          f"{n_active} active regions; gate: training anomaly std <= "
          f"{train_std.max():.2f} K, open-loop rms {ol_rms:.3f} K against "
          f"persistence {pers_rms:.3f} K")

    with tempfile.TemporaryDirectory() as tmp:
        # the trained hybrid to a file and back onto the card
        path = os.path.join(tmp, "hybrid.nc")
        t0 = time.perf_counter()
        save_model(path, hm)
        out["model_save_s"] = time.perf_counter() - t0
        out["model_file_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = load_model(path, radang_deg=np.degrees(
            np.asarray(sp.dy.tables.radang)))
        torch.cuda.synchronize()
        out["model_load_s"] = time.perf_counter() - t0
        os.remove(path)
        if not loaded.params.wout.is_cuda:
            raise AssertionError("load_model did not put the model on the "
                                 "card")
        for a, b in zip(hm.step(x0, gv_truth[-1], gv_model[-1]),
                        loaded.step(x0, gv_truth[-1], gv_model[-1])):
            if not torch.equal(a, b):
                raise AssertionError("the loaded model's first step is not "
                                     "the trained model's")
        del loaded
        torch.cuda.empty_cache()
        print(f"model file: {out['model_file_bytes'] / 1e9:.3f} GB, saved "
              f"in {out['model_save_s']:.1f} s, loaded onto the card in "
              f"{out['model_load_s']:.1f} s; first step bitwise equal")

        # COUPLED_WEEKS ocean weeks through the chunked loop
        scan = ScanHybridRunner(hm, sp, physics=True)
        x_ocean0 = ocean.synchronize(weekly_ocean_inputs(
            gv_truth.cpu().numpy(), spw, L))
        anom0 = enso.anomaly(date)
        start = (x0, truth.atmo[-1], truth.logp[-1], precip_t0, date)
        n_steps = COUPLED_WEEKS * spw
        fpath = os.path.join(tmp, "forecast.nc")
        ck_a = os.path.join(tmp, "a.npz")
        t0 = time.perf_counter()
        with ForecastWriter(fpath, cfg.kx, cfg.il, cfg.ix,
                            with_sst=True) as writer:
            run_a = scan.run(*start, n_steps, ocean=ocean, x_ocean=x_ocean0,
                             sst_anom0=anom0, writer=writer, stream=True,
                             checkpoint_path=ck_a, checkpoint_every=n_steps)
        torch.cuda.synchronize()
        out["coupled_run_s"] = time.perf_counter() - t0
        if run_a["aborted"] or run_a["steps_done"] != n_steps:
            raise AssertionError(f"the coupled run stopped after "
                                 f"{run_a['steps_done']} of {n_steps} steps")
        summ = run_a["summary"]
        for name in ("t", "u", "q"):
            lo, hi = SAFE_BOUNDS[name]
            if not (lo <= summ[f"{name}_min"] and summ[f"{name}_max"] <= hi):
                raise AssertionError(
                    f"coupled {name} in {summ[f'{name}_min']:.1f}.."
                    f"{summ[f'{name}_max']:.1f} leaves {lo}..{hi}")
        if not all(np.isfinite(v) for v in summ.values()):
            raise AssertionError(f"non-finite summary: {summ}")
        if len(run_a["chunk_ms"]) != COUPLED_WEEKS:
            raise AssertionError(f"chunk times: {run_a['chunk_ms']}")
        out["chunk_step_ms"] = [ms / spw for ms in run_a["chunk_ms"]]
        out["summary"] = summ
        # the forecast file and the checkpoint, read back
        fa = read_forecast(fpath)
        temp = fa["Temperature"]
        if temp.shape != (n_steps, cfg.kx, cfg.il, cfg.ix) or \
                not np.isfinite(temp).all() or "SST" not in fa:
            raise AssertionError(f"forecast file holds {temp.shape}")
        np.testing.assert_array_equal(temp[-1],
                                      run_a["atmo_end"][0].cpu().numpy())
        st = load_prediction(ck_a)
        if st["step"] != n_steps:
            raise AssertionError(f"checkpoint step {st['step']}")
        np.testing.assert_array_equal(st["x"], run_a["x"].cpu().numpy())
        np.testing.assert_array_equal(st["extra"]["x_ocean"],
                                      run_a["x_ocean"].cpu().numpy())
        print(f"coupled run: {n_steps} steps in {out['coupled_run_s']:.1f} "
              f"s, chunks of {spw} at "
              + ", ".join(f"{ms:.1f}" for ms in out["chunk_step_ms"])
              + f" ms/step by CUDA events; T {summ['t_min']:.1f}.."
              f"{summ['t_max']:.1f} K, |u| <= "
              f"{max(-summ['u_min'], summ['u_max']):.1f} m/s, q <= "
              f"{summ['q_max']:.1f} g/kg, SST drift <= "
              f"{summ['sst_drift_K']:.2f} K, rain <= "
              f"{summ['precip_mm_max']:.1f} mm/6h; forecast file "
              f"{os.path.getsize(fpath) / 1e6:.1f} MB and checkpoint read "
              f"back")

        # one chunk with host syncs forbidden: what a CUDA graph would need
        xs = scan._upload_fields(scan._precompute(date, 2))
        args = [torch.as_tensor(v, dtype=torch.float32, device=scan.device)
                for v in start[:4]]
        anom_dev = torch.as_tensor(anom0, dtype=scan.dtype,
                                   device=scan.device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = scan.run_chunk(*args, anom_dev, xs, 2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not bool(res.safe_st.all()):
            raise AssertionError("the sync-free chunk tripped the gate")
        print("one chunk of 2 steps under set_sync_debug_mode('error'): no "
              "host sync between its first launch and the read of safe")
        del res, xs

        # the first week again, to a checkpoint: the same launches give the
        # same week
        ck_b = os.path.join(tmp, "b.npz")
        run_b = scan.run(*start, spw, ocean=ocean, x_ocean=x_ocean0,
                         sst_anom0=anom0, checkpoint_path=ck_b,
                         checkpoint_every=spw)
        if run_b["aborted"]:
            raise AssertionError("the one-week run tripped the gate")
        again = float(np.abs(run_b["atmo"][:, 0] - temp[:spw]).max())
        anom1 = run_b["sst_anom"]
        clip = rcfg.slab_anom_clip
        if not (0.0 < np.abs(anom1).max() <= clip + 1e-6):
            raise AssertionError(f"fed-back anomaly after week one: max "
                                 f"{np.abs(anom1).max():.3e} K (clip {clip})")
        if again > COUPLED_STEP1_TOL:
            raise AssertionError(f"the same week twice differs by {again}")
        out.update(anom_week1_max_K=float(np.abs(anom1).max()),
                   anom_week1_cells=int((np.abs(anom1) > 1e-6).sum()),
                   same_week_twice_max_K=again)

        # the per-step runner resumes the chunked loop's checkpoint for the
        # second week, beside the chunked loop's own second week
        per_step = HybridRunner(hm, fc)
        t1, t2 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t1.record()
        run_c = per_step.resume_from(ck_b, spw, ocean=ocean)
        t2.record()
        torch.cuda.synchronize()
        out["per_step_ms"] = t1.elapsed_time(t2) / spw
        if run_c["aborted"] or not run_c["x"].is_cuda:
            raise AssertionError("the resumed run tripped the gate, or left "
                                 "the card")
        d = run_c["atmo"][:, 0].cpu().numpy() - temp[spw:]
        step1, rms = float(np.abs(d[0]).max()), float(np.sqrt((d**2).mean()))
        out.update(resume_step1_max_K=step1, resume_week_rms_K=rms,
                   resume_week_max_K=float(np.abs(d).max()))
        if step1 > COUPLED_STEP1_TOL or rms > COUPLED_WEEK_RMS_TOL:
            raise AssertionError(
                f"resumed per-step week against the chunked loop's second "
                f"week: first step {step1:.3e} K (bound {COUPLED_STEP1_TOL}"
                f"), week rms {rms:.3e} K (bound {COUPLED_WEEK_RMS_TOL})")
        print(f"after week one the fed-back anomaly reaches "
              f"{out['anom_week1_max_K']:.3f} K in "
              f"{out['anom_week1_cells']} cells (clip {clip} K); the same "
              f"week twice: max |dT| {again:.3e} K; per-step runner resumed "
              f"from the chunked loop's checkpoint: {out['per_step_ms']:.1f} "
              f"ms/step beside {out['chunk_step_ms'][-1]:.1f} chunked; "
              f"against the chunked second week: first step max |dT| "
              f"{step1:.3e} K (bound {COUPLED_STEP1_TOL}), week rms "
              f"{rms:.3e} K (bound {COUPLED_WEEK_RMS_TOL}), max "
              f"{out['resume_week_max_K']:.2f} K")
    return out


# ----------------------------------------------------------------------
# the training pipeline
# ----------------------------------------------------------------------
def phase_pipeline(bindir, region_block):
    """The pipeline the model's users run to make a model: FusedDataGenerator
    for a full-physics truth with its dry-core forecasts (one day of it with
    host syncs forbidden first) -> train_hybrid(also_ml=True) over all
    regions with block checkpoints -> a resume from a directory missing
    blocks, bitwise -> ml_variant through ScanHybridRunner for one chunk ->
    the series as ERA-schema files -> train_from_era on them, one step held
    against the in-memory model's -> hybrid steps of the file-trained model
    on an ObservedBoundary over the files. Returns the numbers it printed."""
    import numpy as np
    import torch
    from speedyml_torch import (FusedDataGenerator, ModelConfig, ModelDate,
                                ObservedBoundary, ReservoirConfig,
                                ScanHybridRunner, ml_variant, train_from_era,
                                train_hybrid)
    from speedyml_torch.core.calendar import (datetime_from_hours,
                                              hours_since_epoch)
    from speedyml_torch.coupler.anomaly import SyntheticEnso
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.hybrid.experiment import (HybridRunner,
                                                  transform_and_pack)
    from speedyml_torch.hybrid.forecast import SpeedyForecaster
    from speedyml_torch.hybrid.state_io import SAFE_BOUNDS
    from speedyml_torch.io import era
    from speedyml_torch.model import Speedy
    from speedyml_torch.ops import accum

    out = {}
    rcfg = ReservoirConfig()
    sp = Speedy(ModelConfig(), bindir)         # no device given: the card
    dev = sp.device
    cfg = sp.config
    radang_deg = np.degrees(np.asarray(sp.dy.tables.radang))
    L = build_layout(ix=cfg.ix, il=cfg.il, kx=cfg.kx, radang_deg=radang_deg)
    enso = SyntheticEnso(radang_deg, np.arange(cfg.ix) * 360.0 / cfg.ix,
                         sp.clim.fmask_s,
                         t0=(PIPELINE_YEAR, 1, 1 + SPINUP_DAYS), **ENSO)
    gen = FusedDataGenerator(sp, hours=rcfg.timestep,
                             sst_anom_fn=enso.sst_anom_fn)
    t0 = time.perf_counter()
    gen.initialize(PIPELINE_YEAR, 1, spinup_days=SPINUP_DAYS)
    torch.cuda.synchronize()
    print(f"pipeline: rest start + {SPINUP_DAYS} days in "
          f"{time.perf_counter() - t0:.1f} s")

    # one generator day with host syncs forbidden between its first launch
    # and the read of its flux sums (its result is dropped: the day body
    # changes no state of the generator)
    surf, forcing, dry, _ = gen._day_inputs()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        day = gen._run_day(gen.gs, surf, forcing, dry)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not bool(day[3]):
        raise AssertionError("the sync-free generator day tripped the gate")
    del day, surf, forcing, dry
    print("one generator day under set_sync_debug_mode('error'): no host "
          "sync between its first launch and the read of its flux sums")

    discard = max(1, rcfg.discardlength // rcfg.timestep)
    n_samples = discard + 1 + PIPELINE_PAIRS
    t0 = time.perf_counter()
    series = gen.generate(n_samples)
    t_gen = time.perf_counter() - t0
    out.update(samples=n_samples, generate_s=t_gen,
               s_per_sample=t_gen / n_samples)
    shape = (n_samples, 4, cfg.kx, cfg.il, cfg.ix)
    for k in ("atmo", "m_atmo"):
        if series[k].shape != shape:
            raise AssertionError(f"{k} {series[k].shape}, not {shape}")
    for k, v in series.items():
        if not np.isfinite(v).all():
            raise AssertionError(f"generated {k} has non-finite values")
    ranges = {}
    for label, a in (("truth", series["atmo"]), ("model", series["m_atmo"])):
        for i, name in enumerate(("t", "u", "v", "q")):
            lo, hi = SAFE_BOUNDS[name]
            vmin, vmax = float(a[:, i].min()), float(a[:, i].max())
            if not (lo <= vmin and vmax <= hi):
                raise AssertionError(f"generated {label} {name} in "
                                     f"{vmin:.1f}..{vmax:.1f} leaves "
                                     f"{lo}..{hi}")
            ranges[f"{label}_{name}"] = (vmin, vmax)
    pr = series["precip"]
    wet = float((pr > 0.0).mean())
    if pr.min() < 0.0 or not 0.0 < wet < 1.0:
        raise AssertionError(f"generated rain in {wet:.0%} of the cells, "
                             f"min {pr.min()}")
    if np.any(series["m_precip"]):
        raise AssertionError("the dry-core forecasts carry precipitation")
    if not np.all(np.diff(series["hours"]) == rcfg.timestep):
        raise AssertionError("generated samples are not 6-hourly")
    print(f"FusedDataGenerator: {n_samples} samples ({discard} discard + 1 + "
          f"{PIPELINE_PAIRS} pairs) in {t_gen:.1f} s: "
          f"{out['s_per_sample']:.3f} s/sample (a full-physics and a dry "
          f"window each; device idle share: scripts_torch/profile_slice.py); "
          + "; ".join(f"{lab} T {ranges[lab + '_t'][0]:.1f}.."
                      f"{ranges[lab + '_t'][1]:.1f} K, |u| <= "
                      f"{max(map(abs, ranges[lab + '_u'])):.1f} m/s, q <= "
                      f"{ranges[lab + '_q'][1]:.1f} g/kg"
                      for lab in ("truth", "model"))
          + f"; rain in {wet:.0%} of cells and windows, max "
          f"{pr.max():.1f} mm/6h; model precipitation all zero")

    def up(k):
        return torch.as_tensor(series[k], device=dev)

    eps = rcfg.precip_epsilon
    gv_truth = transform_and_pack(L, up("atmo"), up("logp"), up("precip"),
                                  up("sst"), up("tisr"), eps)
    gv_model = transform_and_pack(L, up("m_atmo"), up("m_logp"),
                                  up("m_precip"), up("sst"), up("tisr"), eps)
    n = rcfg.nodes_per_input // L.n_in * L.n_in
    na = L.n_out + n
    nblocks = -(-L.R // region_block)
    chunk = min(TRAIN_CHUNK, PIPELINE_PAIRS)
    train_kw = dict(seed=SEED, region_block=region_block, chunk=chunk)

    with tempfile.TemporaryDirectory() as tmp:
        ckdir = os.path.join(tmp, "blocks")
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        launches = accum.accumulate_ss_scan.launches
        t0 = time.perf_counter()
        hm = train_hybrid(L, rcfg, gv_truth, gv_model, verbose=True,
                          checkpoint_dir=ckdir, also_ml=True, **train_kw)
        torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        out["launches_train"] = accum.accumulate_ss_scan.launches - launches
        peak = torch.cuda.max_memory_allocated()
        # a block's own working set: the peak over what the run held before
        # it and the two readouts it fills block by block
        held = 4 * L.R * L.n_out * (na + n)
        budget = region_block * na * na * SOLVE_BYTES_PER_ENTRY
        out.update(peak_gib=peak / 2**30,
                   block_peak_gib=(peak - before - held) / 2**30,
                   budget_gib=budget / 2**30)
        check_trained(hm, L, na)
        w = hm.wout_ml
        if w is None or tuple(w.shape) != (L.R, L.n_out, n) or \
                not bool(torch.isfinite(w).all()) or \
                w.device != hm.params.wout.device or w.device.type != dev.type:
            raise AssertionError(f"no finite ML-only readout on {dev}")
        ck_bytes = sum(os.path.getsize(os.path.join(ckdir, f))
                       for f in os.listdir(ckdir))
        print(f"train_hybrid(also_ml=True, checkpoint_dir): {L.R} regions, "
              f"na={na}, {PIPELINE_PAIRS} pairs, {nblocks} blocks of "
              f"{region_block}: {out['train_s']:.1f} s, "
              f"{out['launches_train']} kernel launches; peak device memory "
              f"{out['peak_gib']:.2f} GiB, of it an also_ml block's own "
              f"{out['block_peak_gib']:.2f} GiB (region_block_for budgets "
              f"{out['budget_gib']:.2f} GiB); block files "
              f"{ck_bytes / 1e9:.2f} GB")

        # resume: the last two blocks gone, the ML readout of the last one
        # left gone too; those three are trained again, bitwise the same
        names = sorted(os.listdir(ckdir))
        for name in names[-2:]:
            os.remove(os.path.join(ckdir, name))
        path = os.path.join(ckdir, names[-3])
        with np.load(path) as z:
            keep = {k: z[k] for k in z.files if k != "wout_ml"}
        np.savez(path, **keep)
        launches = accum.accumulate_ss_scan.launches
        t0 = time.perf_counter()
        hr = train_hybrid(L, rcfg, gv_truth, gv_model, checkpoint_dir=ckdir,
                          also_ml=True, **train_kw)
        torch.cuda.synchronize()
        out["resume_s"] = time.perf_counter() - t0
        out["launches_resume"] = accum.accumulate_ss_scan.launches - launches
        for k, a, b in (("wout", hm.params.wout, hr.params.wout),
                        ("wout_ml", hm.wout_ml, hr.wout_ml),
                        ("win", hm.params.win, hr.params.win),
                        ("a_idx", hm.params.a_idx, hr.params.a_idx),
                        ("a_val", hm.params.a_val, hr.params.a_val)):
            if not torch.equal(a, b):
                raise AssertionError(f"resumed {k} differs from the "
                                     f"uninterrupted run's")
        if out["launches_resume"] != 3:
            raise AssertionError(f"the resume trained "
                                 f"{out['launches_resume']} blocks, not 3")
        del hr
        torch.cuda.empty_cache()
        print(f"resume: {len(names) - 3} blocks read, 3 trained again (2 "
              f"files deleted, 1 without wout_ml) in {out['resume_s']:.1f} "
              f"s; wout, wout_ml, win, a_idx, a_val bitwise equal")

        # the ML-only model for one chunk of the chunked loop, from the last
        # sample with the reservoirs synchronized on the samples before it
        ml = ml_variant(hm)
        x0 = ml.synchronize(gv_truth[-1 - N_SYNC:-1])
        torch.cuda.synchronize()
        p0, p1 = L.gv_sizes["precip"]
        date_last = ModelDate(*datetime_from_hours(int(series["hours"][-1])))
        scan = ScanHybridRunner(ml, sp, chunk=ML_STEPS)
        run = scan.run(x0, up("atmo")[-1], up("logp")[-1],
                       gv_truth[-1, p0:p1].reshape(cfg.il, cfg.ix),
                       date_last, ML_STEPS)
        if run["aborted"] or run["steps_done"] != ML_STEPS:
            raise AssertionError(f"the ML-only loop stopped after "
                                 f"{run['steps_done']} of {ML_STEPS} steps")
        a = run["atmo"]
        if not (np.isfinite(a).all() and np.isfinite(run["logp"]).all()):
            raise AssertionError("the ML-only loop gave non-finite values")
        for i, name in enumerate(("t", "u", "v", "q")):
            lo, hi = SAFE_BOUNDS[name]
            if not (lo <= a[:, i].min() and a[:, i].max() <= hi):
                raise AssertionError(f"ML-only {name} in {a[:, i].min():.1f}"
                                     f"..{a[:, i].max():.1f} leaves "
                                     f"{lo}..{hi}")
        out["ml_step_ms"] = run["chunk_ms"][0] / ML_STEPS
        print(f"ML-only loop (ml_variant through ScanHybridRunner): "
              f"{ML_STEPS} steps, gate held, {out['ml_step_ms']:.2f} ms/step "
              f"by CUDA events; T {a[:, 0].min():.1f}..{a[:, 0].max():.1f} K, "
              f"|u| <= {np.abs(a[:, 1]).max():.1f} m/s, q <= "
              f"{a[:, 3].max():.1f} g/kg")
        # the same steps through the per-step runner, which skips the window
        t0 = time.perf_counter()
        per_step = HybridRunner(ml, None, clim=sp.clim, dy=sp.dy).run(
            x0, up("atmo")[-1], up("logp")[-1],
            gv_truth[-1, p0:p1].reshape(cfg.il, cfg.ix), date_last, ML_STEPS)
        torch.cuda.synchronize()
        out["ml_per_step_ms"] = 1e3 * (time.perf_counter() - t0) / ML_STEPS
        d_ps = float(np.abs(per_step["atmo"].cpu().numpy() - a).max())
        if per_step["aborted"] or not d_ps <= ML_LOOPS_TOL:
            raise AssertionError(f"per-step ML-only run against the chunked "
                                 f"one: max |diff| {d_ps:.3e}")
        out["ml_loops_max_abs_diff"] = d_ps
        print(f"ML-only, the per-step HybridRunner over the same {ML_STEPS} "
              f"steps: {out['ml_per_step_ms']:.2f} ms/step on the host clock; "
              f"max |diff| to the chunked loop {d_ps:.3e} (bound "
              f"{ML_LOOPS_TOL:g})")
        del scan, run, ml, per_step

        # the series as ERA-schema files: record 0 dated 1 January 00h of
        # the year (the files' own calendar), q in kg/kg in the truth file
        # and in g/kg in the model-state file, as the readers expect
        era_dir = os.path.join(tmp, "era")
        os.makedirs(era_dir)
        y = PIPELINE_YEAR
        atmo_f = series["atmo"].astype(np.float32)
        atmo_f[:, 3] /= 1000.0
        t0 = time.perf_counter()
        era.write_era_year(era.era_file_name(era_dir, y), atmo_f,
                           series["logp"], sst=series["sst"],
                           p6hr=series["precip"])
        era.write_tisr_year(era.tisr_file_name(era_dir, y), series["tisr"])
        era.write_era_year(os.path.join(era_dir, f"restart_6hour_y{y}.nc"),
                           series["m_atmo"], series["m_logp"],
                           p6hr=series["m_precip"])
        out["files_write_s"] = time.perf_counter() - t0
        offset_h = int(series["hours"][0]) - hours_since_epoch(y, 1, 1, 0)

        t0 = time.perf_counter()
        hf, data, gv_f = train_from_era(L, rcfg, era_dir, y, y,
                                        model_dir=era_dir, device=dev,
                                        **train_kw)
        torch.cuda.synchronize()
        out["train_from_era_s"] = time.perf_counter() - t0
        check_trained(hf, L, na)
        if not (torch.equal(hf.params.win, hm.params.win)
                and torch.equal(hf.params.a_val, hm.params.a_val)):
            raise AssertionError("train_from_era built other reservoirs")
        out["gv_file_max_abs_diff"] = float((gv_f - gv_truth).abs().max())
        # one hybrid step of each model from the same synchronized state
        a_m, lp_m, pt_m = hm.step(x0, gv_truth[-1], gv_model[-1])[1:]
        a_f, lp_f, pt_f = hf.step(x0, gv_truth[-1], gv_model[-1])[1:]
        worst = 0.0
        for name, g, w in (("t", a_f[0], a_m[0]), ("u", a_f[1], a_m[1]),
                           ("v", a_f[2], a_m[2]), ("q", a_f[3], a_m[3]),
                           ("logp", lp_f, lp_m), ("precip", pt_f, pt_m)):
            rel = float((g - w).abs().max()) / float(w.max() - w.min())
            worst = max(worst, rel)
            if not rel <= FILE_MODEL_TOL:
                raise AssertionError(f"train_from_era step: {name} differs "
                                     f"by {rel:.2e} of its range")
        out["file_step_rel"] = worst
        del hm, gv_model
        torch.cuda.empty_cache()
        print(f"ERA-schema files ({len(os.listdir(era_dir))}) written in "
              f"{out['files_write_s']:.1f} s; train_from_era: "
              f"{out['train_from_era_s']:.1f} s, the same reservoirs, packed "
              f"series within {out['gv_file_max_abs_diff']:.2e} of the "
              f"in-memory one (q through kg/kg in float32); one step against "
              f"the in-memory hybrid's: largest difference {worst:.2e} of a "
              f"field's range (bound {FILE_MODEL_TOL:g})")

        # hybrid steps of the file-trained model on the observed SST and
        # TISR: the files' calendar runs offset_h hours behind the series'
        ob = ObservedBoundary(era_dir, y, tisr_dir=era_dir)
        i0 = n_samples - OBSERVED_STEPS
        date = ModelDate(y, 1, 1, 0)
        date.advance_hours(rcfg.timestep * i0)
        x = hf.synchronize(gv_f[i0 - N_SYNC:i0])
        t = data.truth
        runner = HybridRunner(hf, SpeedyForecaster(sp, hours=rcfg.timestep))
        t0 = time.perf_counter()
        res = runner.run(x, t.atmo[i0], t.logp[i0],
                         gv_f[i0, p0:p1].reshape(cfg.il, cfg.ix), date,
                         OBSERVED_STEPS, sst_fn=ob.sst_fn, tisr_fn=ob.tisr_fn)
        torch.cuda.synchronize()
        out["observed_s"] = time.perf_counter() - t0
        if res["aborted"] or len(res["atmo"]) != OBSERVED_STEPS:
            raise AssertionError("the observed-SST run tripped the gate")
        a = res["atmo"]
        for i, name in enumerate(("t", "u", "v", "q")):
            lo, hi = SAFE_BOUNDS[name]
            if not (bool(torch.isfinite(a[:, i]).all())
                    and lo <= float(a[:, i].min())
                    and float(a[:, i].max()) <= hi):
                raise AssertionError(f"observed-SST run: {name} out of "
                                     f"bounds")
        d = ModelDate(date.iyear, date.imonth, date.iday, date.ihour)
        for k in range(OBSERVED_STEPS):
            file_sst = ob.sst_fn(d)
            if not (np.array_equal(res["sst"][k].cpu().numpy(), file_sst)
                    and np.array_equal(file_sst,
                                       series["sst"][i0 + k].astype(
                                           np.float32))):
                raise AssertionError(f"observed-SST step {k}: the SST is "
                                     f"not the file's at its date")
            d.advance_hours(rcfg.timestep)
        print(f"observed SST: {OBSERVED_STEPS} hybrid steps of the "
              f"file-trained model through HybridRunner.run with an "
              f"ObservedBoundary in {out['observed_s']:.1f} s, gate held; "
              f"each step's SST is the file's at its date (the files' "
              f"calendar {offset_h} h behind the series'); T "
              f"{float(a[:, 0].min()):.1f}..{float(a[:, 0].max()):.1f} K")
    return out


def inject_state(sp, gs):
    """The physics time level of a grid state, through the safety gate."""
    from speedyml_torch.hybrid.state_io import inject
    state, safe = inject(sp.dy, gs)
    if not bool(safe):
        raise AssertionError("the state left the safety bounds")
    return state.at_level(0)


def main():
    t_run0 = time.perf_counter()
    seconds = {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t0
        print(f"phase {label}: {seconds[label]:.1f} s")
        return out

    name = timed("device", phase_device)
    timed("build", phase_build)

    import torch
    from speedyml_torch import ReservoirConfig
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.io.synthetic_boundary import write_synthetic_boundary
    from speedyml_torch.ops import accum

    # the training block of the main path: every region's normal equations
    # are (na, na); the kernel is checked and timed at that block's shapes
    L, rcfg = build_layout(), ReservoirConfig()
    na = L.n_out + rcfg.nodes_per_input // L.n_in * L.n_in
    # the packed truth and model series of the longest path stay on the card
    # beside the block
    discard = max(1, rcfg.discardlength // rcfg.timestep)
    series = 2 * 4 * L.gv_len * (discard + 1 + max(FULL_PAIRS))
    region_block = region_block_for(na, torch.cuda.mem_get_info()[0], L.R,
                                    series)
    kres = timed("kernel", phase_kernel, region_block, TRAIN_SAMPLES,
                 TRAIN_CHUNK, na)
    torch.cuda.empty_cache()     # hand the check's memory back for training

    def counted(label, fn, *args):
        """fn's phase with the launch counts set to 0 just before it and
        read just after: only that path's launches."""
        accum.accumulate_ss_scan.launches = 0
        accum.accumulate_ss.launches = 0
        out = timed(label, fn, *args)
        n = accum.accumulate_ss_scan.launches
        if n < 1:
            raise AssertionError(f"{label}: train_hybrid never launched "
                                 f"the kernel")
        print(f"accumulate_ss_scan launches on the {label}: {n}")
        torch.cuda.empty_cache()
        return out, n, accum.accumulate_ss.launches

    with tempfile.TemporaryDirectory() as bindir:
        write_synthetic_boundary(bindir, SEED)
        timed("physics, card against CPU", phase_physics_card_vs_cpu, bindir)
        torch.cuda.empty_cache()
        _, n_dry, n_dry_single = counted("dry path", phase_main_path,
                                         region_block)
        full, n_full, n_full_single = counted(
            "full-physics path", phase_full_physics_path, bindir,
            region_block, t_run0)
        pipe, n_pipe, n_pipe_single = counted(
            "pipeline", phase_pipeline, bindir, region_block)
    long_tr, n_long, n_long_single = counted(
        "long training", phase_long_training, region_block)
    # the paths give the kernel other series lengths than the one timed
    # above: hold it against the plain version at each of them too
    at_len = {}
    for T in sorted({DRY_PAIRS, full["pairs"], PIPELINE_PAIRS}):
        res = timed(f"kernel at T={T}", phase_kernel, region_block, T,
                    min(TRAIN_CHUNK, T), na, True)
        at_len[T] = dict(T=T, R=region_block, na=na,
                         **res["accumulate_ss_scan"])
    at_dry, at_full, at_pipe = (at_len[DRY_PAIRS], at_len[full["pairs"]],
                                at_len[PIPELINE_PAIRS])
    coupled = full["coupled"]
    n_ocean = coupled["launches_ocean_training"]
    n_full -= n_ocean

    def entry(wrapper, replaces, n, **more):
        return dict(name=wrapper, route="cuda",
                    source="speedyml_torch/ops/csrc/accum.cu",
                    replaces=replaces, launches=n, **kres[wrapper], **more)

    total = time.perf_counter() - t_run0
    print("seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()) + f"; total {total:.1f}")
    # the single-chunk wrapper is the same kernel with T == chunk; training
    # does not call it, so it is checked and timed above but listed apart
    print(json.dumps({
        "kernels": [entry("accumulate_ss_scan", "speedyml/ops/accum.py:107",
                          n_dry + n_full + n_ocean + n_pipe + n_long,
                          launches_dry_path=n_dry,
                          launches_full_physics_path=n_full,
                          launches_ocean_training=n_ocean,
                          launches_pipeline=n_pipe,
                          launches_long_training=n_long,
                          at_long_shape=long_tr,
                          at_dry_shape=at_dry,
                          at_full_physics_shape=at_full,
                          at_ocean_shape=coupled.pop("at_ocean_shape"),
                          at_pipeline_shape=at_pipe)],
        "off_path": [entry("accumulate_ss", "speedyml/ops/accum.py:51",
                           n_dry_single + n_full_single + n_pipe_single
                           + n_long_single)],
        "full_physics": full, "pipeline": pipe}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
