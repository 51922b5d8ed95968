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
    onto the card, one ocean week (28 steps) of the full-physics hybrid
    through the chunked `ScanHybridRunner` with the ocean's weekly SST
    feedback, a forecast file and a checkpoint, one chunk under
    `torch.cuda.set_sync_debug_mode("error")`, and the next week from that
    checkpoint twice: the chunked loop and the per-step `HybridRunner`
    each resuming it;
  * the ensemble, on the full-physics path's trained model: `EnsembleHybrid`
    with two members against two single-member steps, every output to the
    float32 readout's rounding (dry window; full-physics window in
    float64), then full-physics steps of 1 to 64 members (ms/step,
    gridpoints/s, peak memory, a guard against a readout that copies wout
    per member), the window/ESN split and bf16 grid with bf16 wout at 64;
  * bf16 grid compute: a day of the dry core in bf16 against f32 (the JAX
    test's bounds), `run_steps` in both, and closed-loop full-physics steps
    with the bf16 grid, beside the f32 steps above;
  * the scripts of scripts_torch as users run them, through their
    main(argv) at reference width on the stand-in files: reference_scale.py
    data (with the ENSO-like anomaly), train (both readouts, block files),
    predict, coupled --ocean-train-only and a one-week coupled run with its
    forecast file (the kernel held against its plain version at the train
    and ocean shapes first), then score_run, decade_table,
    analyze_forecast, enso_eval and climate_check cache on what they
    wrote;
  * the tools users run, on the files the scripts wrote: the reference-
    worker weight files of the trained model's first regions at reference
    width, written and read back onto the card equal; demo_hybrid.py with
    the slab ocean, its forecast, GrADS and component files and its
    ML-only branch (the kernel held against its plain version at the
    demo's shapes first); diag_precip_bias.py, make_precip_debias.py and
    diag_wetbias.py; mldivide card against CPU; the native IO loader built
    on the machine, its decoder and gathers against numpy;
  * the training pipeline, the way the model's users make a model, on the
    series and block files the scripts leave: one `FusedDataGenerator` day
    with host syncs forbidden, the series checked,
    `train_hybrid(also_ml=True)` reading the block files, a resume after
    deleting blocks (bitwise), the ML-only model (`ml_variant`) for one
    chunk of `ScanHybridRunner`, the series written as ERA-schema files,
    `train_from_era` on them (one step held against the block-file
    model's), and hybrid steps of that model through `HybridRunner` on an
    `ObservedBoundary` over the files;
  * the model's options: two days of the full-physics model with SPPT,
    random diabatic forcing and time means, their GrADS file read back,
    each mean inside the range of its samples, ms per day with and without
    the options, and climate_check run;
  * one training block at the reference's training length (16,060 pairs of
    random standardized series): the drive folds segment by segment, its
    peak memory held to the accumulators plus two segments and the block's
    to its budget plus two segments, the kernel's
    launches counted and its time over the whole series beside its bound;
  * the multi-device layer (speedyml_torch.parallel), its ranks processes
    of their own on the one card: the composed hybrid step at reference
    width with one rank over NCCL and four ranks over gloo (NCCL refuses
    two ranks on one GPU), dry and with full physics, held against the
    single-device step on the card, with its collectives per step; the
    sharded training drive at dp=4 and at dp=2 with tp=2, gathered and
    held bitwise against the single-device fold; the dry run's six phases
    on the four ranks.

Before these, the column physics on the card (with the random diabatic
forcing, and a time-mean sample) is held against the same code on the CPU
(asked for explicitly) in float64.

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
from pathlib import Path

SEED = 20240101
TRAIN_CHUNK = 128          # time steps per normal-equation fold
TRAIN_SAMPLES = 2 * TRAIN_CHUNK   # training pairs after the discard
PREDICT_STEPS = 3
N_SYNC = 40
# the dry path's training pairs after the discard
DRY_PAIRS = 64
# the full-physics path: days of spin-up from rest, the fewest and the most
# training pairs, and the run time [s] the series is sized to stay under.
# The fewest give 141 samples: five ocean weeks of 28, and train_ocean needs
# more than four
SPINUP_DAYS = 5
FULL_PAIRS = (100, 256)
TARGET_SECONDS = 600.0
# the coupled loop: steps of an ocean week, weeks through the chunked loop,
# and the hybrid steps the coupled phases take in all (the chunked weeks to
# a checkpoint, then the next week twice: chunked on from the carry in
# memory, and per step from the checkpoint file), for the sizing
WEEK = 28
COUPLED_WEEKS = 1
COUPLED_STEPS = (COUPLED_WEEKS + 2) * WEEK
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
# the training pipeline, on the series and block files of the scripts
# phase: steps of the ML-only loop (one chunk), hybrid steps on the observed
# SST, the year of the scripts' series and of the ERA-schema files (1983:
# its days lie inside the ENSO-like anomaly's record, which starts in
# February 1982 and ramps up over 30 days), the file-trained hybrid's step
# against the block-file one's (of each field's range: the trained readouts
# differ as the float32 normal equations of slightly different q series
# round, PERF.md section 6 and tests/test_torch_training.py), and what the
# phase spends outside its windows [s]: reading the block files, the
# resume, train_from_era
ML_STEPS = 28
OBSERVED_STEPS = 3
PIPELINE_YEAR = 1983
FILE_MODEL_TOL = 5e-3
PIPELINE_FIXED_SECONDS = 80.0
# the ML-only model through the per-step runner against the chunked loop:
# the same float32 arithmetic on the same packed inputs, whose SST and TISR
# reach float32 from float64 host fields on two ways (largest |difference|
# over all fields and steps)
ML_LOOPS_TOL = 1e-3
# card against CPU, float64: of each output's largest value
PHYSICS_TOL = 1e-10
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
# the scripts users run (scripts_torch), at reference width on stand-in
# boundary files: days of spin-up of the data phase, samples held out (the
# predict phase's steps), the ocean weeks of the training series (five:
# train_ocean needs more than four), the coupled run's ocean weeks, the
# decade table's "year" in steps, and what the phase takes [s], for the
# sizing of the full-physics series
SCRIPTS_SPINUP_DAYS = 2
SCRIPTS_HOLDOUT = 4
SCRIPTS_OCEAN_WEEKS = 5
SCRIPTS_COUPLED_WEEKS = 1
SCRIPTS_STEPS_PER_YEAR = 28
SCRIPTS_SECONDS = 420.0
# the model's options (SPPT, random diabatic forcing, time means): days run
# with them, and what the phase takes [s]
OPTIONS_DAYS = 2
OPTIONS_SECONDS = 60.0
# the tools users run on the scripts' files: the regions of the reference-
# width model written as worker files (33.5 MB a file; the whole set of 1152
# is ~39 GB), the demo's forecast steps, the demo's reservoirs (n=576, one
# node per input; its slab ocean n=448 in blocks of 576) and training
# discard [h], the steps diag_precip_bias synchronizes on (its default),
# the run steps make_precip_debias skips, mldivide card against CPU
# (relative, float64), and what the phase takes [s]
WORKER_REGIONS = 24
DEMO_FC_STEPS = 4
DEMO_NODES = 576
DEMO_OCEAN_BLOCK = 576
DEMO_DISCARD_H = 24
DEMO_CHUNK = 64
PRECIP_SYNC = 56
DEBIAS_SKIP = 4
LINALG_TOL = 1e-10
TOOLS_SECONDS = 150.0
# the multi-device layer (speedyml_torch.parallel) on the one card: the
# composed hybrid step at reference width with 1 rank over NCCL and 4 ranks
# over gloo (NCCL refuses two ranks on one GPU), its warm-up and timed
# steps, its bounds against the single-device step on the card (of each
# output's largest magnitude: the dry step's largest difference,
# tests/test_composed.py:110-113; the full-physics step's rms difference,
# tests/test_composed.py:169-172's 2e-3, since in float32 the window's
# moist triggers can turn the sharded transforms' rounding into a whole
# column's difference, ROADMAP note (c)); the sharded training drive's
# regions, pairs and fold chunk (bitwise against the single-device fold);
# and what the phase takes [s]
MD_WORLD = 4
MD_WARM = 1
MD_STEPS = 2
MD_DRY_REL = 3e-4
MD_PHYSICS_RMS = 2e-3
MD_TRAIN_REGIONS = 8
MD_TRAIN_PAIRS = 64
MD_TRAIN_CHUNK = 32
MD_SECONDS = 240.0
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
    shortwave step and with the random diabatic forcing, one time-mean
    sample, and one physics-coupled `dy.step`. Every float output within
    PHYSICS_TOL of its largest value, every integer output equal."""
    import numpy as np
    import torch
    from speedyml_torch import ModelConfig, convert
    from speedyml_torch.dynamics.state import SpectralState
    from speedyml_torch.model import Speedy
    from speedyml_torch.physics.driver import RadCarry
    from speedyml_torch.physics.randfor import make_randfh
    from speedyml_torch.utils.timemean import init_timemean, tm_update

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
    # the random diabatic forcing and the time-mean accumulators, built on
    # the host in float64 and handed to both
    randfh = make_randfh(card.dy.T, np.asarray(card.dy.tables.gsin),
                         card.config.ix, seed=card.config.rdf_index)
    t_c, _, _ = card.phys.step_physics(
        card.dy, card.state.at_level(0), surf_c, card.rad, True,
        randfh=torch.as_tensor(randfh, device=card.device))
    t_h, _, _ = host.phys.step_physics(
        host.dy, state_h.at_level(0), surf_h, rad_h, True,
        randfh=torch.as_tensor(randfh))
    compare("step_physics[randfh].tend", Tends(*t_c), Tends(*t_h))
    tm_c = tm_update(card.dy, card.st, card.state.at_level(0),
                     init_timemean(8, 48, 96, torch.float64, card.device))
    tm_h = tm_update(host.dy, host.st, state_h.at_level(0),
                     init_timemean(8, 48, 96, torch.float64, "cpu"))
    compare("tm_update", tm_c, tm_h)
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
    # pipeline phase: one generator day checked for host syncs (four
    # full-physics and four dry windows) and its observed-SST steps
    pipeline = (5 + OBSERVED_STEPS) * per_window + PIPELINE_FIXED_SECONDS
    # the ensemble (its checks, sweep, split and bf16 steps, in windows of
    # one member: a step of 64 members took about one window, PERF.md
    # section 5) and the bf16-grid steps; the long training block
    ensemble = (3 * ENSEMBLE_CHECK + 2 + (len(ENSEMBLE_SIZES) + 1)
                * (ENSEMBLE_WARM + ENSEMBLE_STEPS) + 2 * (2 * PREDICT_STEPS
                                                          + 2)) * per_window
    reserve = (COUPLED_STEPS * per_window + 120.0 + pipeline + ensemble
               + LONG_TRAINING_SECONDS + SCRIPTS_SECONDS + OPTIONS_SECONDS
               + TOOLS_SECONDS)
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
    from speedyml_torch.hybrid.experiment import (SOLVE_BYTES_PER_ENTRY,
                                                  segment_bytes)
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
    forbidden (held against the run's first steps), and the next week
    twice: the chunked loop carrying on from the run's carry in memory and
    the per-step runner resuming the checkpoint file, the second held
    against the first. Returns the numbers it printed."""
    import numpy as np
    import torch
    from speedyml_torch import (ScanHybridRunner, load_model, save_model,
                                train_ocean)
    from speedyml_torch.hybrid.experiment import (HybridRunner,
                                                  region_block_for)
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
        # the same launches from the same start give the coupled run's first
        # two steps again
        again = float(np.abs(res.atmo_st[:, 0].cpu().numpy()
                             - temp[:2]).max())
        if again > COUPLED_STEP1_TOL:
            raise AssertionError(f"the first two steps run twice differ by "
                                 f"{again}")
        out["same_steps_twice_max_K"] = again
        print(f"one chunk of 2 steps under set_sync_debug_mode('error'): no "
              f"host sync between its first launch and the read of safe; "
              f"against the coupled run's first two steps max |dT| "
              f"{again:.3e} K")
        del res, xs

        # the ocean's feedback after the chunked weeks, in its clip
        anom1 = run_a["sst_anom"]
        clip = rcfg.slab_anom_clip
        if not (0.0 < np.abs(anom1).max() <= clip + 1e-6):
            raise AssertionError(f"fed-back anomaly after the chunked weeks: "
                                 f"max {np.abs(anom1).max():.3e} K (clip "
                                 f"{clip})")
        out.update(anom_week1_max_K=float(np.abs(anom1).max()),
                   anom_week1_cells=int((np.abs(anom1) > 1e-6).sum()))

        # the next week: the chunked loop carries on from run_a's carry in
        # memory, and the per-step runner resumes the checkpoint file; the
        # file-resumed week is held against the uninterrupted one
        run_b = scan.run(run_a["x"], run_a["atmo_end"], run_a["logp_end"],
                         run_a["precip_t"], run_a["date"], spw, ocean=ocean,
                         x_ocean=run_a["x_ocean"],
                         sst_anom0=run_a["sst_anom"], step0=n_steps)
        if run_b["aborted"]:
            raise AssertionError("the second chunked week tripped the gate")
        per_step = HybridRunner(hm, fc)
        t1, t2 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t1.record()
        run_c = per_step.resume_from(ck_a, spw, ocean=ocean)
        t2.record()
        torch.cuda.synchronize()
        out["per_step_ms"] = t1.elapsed_time(t2) / spw
        if run_c["aborted"] or not run_c["x"].is_cuda:
            raise AssertionError("the resumed run tripped the gate, or left "
                                 "the card")
        d = run_c["atmo"][:, 0].cpu().numpy() - run_b["atmo"][:, 0]
        step1, rms = float(np.abs(d[0]).max()), float(np.sqrt((d**2).mean()))
        out.update(resume_step1_max_K=step1, resume_week_rms_K=rms,
                   resume_week_max_K=float(np.abs(d).max()),
                   week2_chunk_step_ms=run_b["chunk_ms"][0] / spw)
        if step1 > COUPLED_STEP1_TOL or rms > COUPLED_WEEK_RMS_TOL:
            raise AssertionError(
                f"per-step week resumed from the checkpoint against the "
                f"chunked loop's uninterrupted second week: first step "
                f"{step1:.3e} K (bound {COUPLED_STEP1_TOL}), week rms "
                f"{rms:.3e} K (bound {COUPLED_WEEK_RMS_TOL})")
        print(f"after the chunked week the fed-back anomaly reaches "
              f"{out['anom_week1_max_K']:.3f} K in "
              f"{out['anom_week1_cells']} cells (clip {clip} K); the second "
              f"week: chunked from the carry in memory "
              f"{out['week2_chunk_step_ms']:.1f} ms/step, per step from the "
              f"checkpoint file {out['per_step_ms']:.1f} ms/step; the two "
              f"apart by first step max |dT| {step1:.3e} K (bound "
              f"{COUPLED_STEP1_TOL}), week rms {rms:.3e} K (bound "
              f"{COUPLED_WEEK_RMS_TOL}), max {out['resume_week_max_K']:.2f} "
              f"K")
    return out


# ----------------------------------------------------------------------
# the training pipeline
# ----------------------------------------------------------------------
def phase_pipeline(bindir, work):
    """The pipeline the model's users run to make a model, on what the
    scripts phase left in `work` (its reference_scale.py cache and the train
    phase's block files): one FusedDataGenerator day with host syncs
    forbidden -> the cached truth and dry-core forecasts checked -> the
    trained model read back from its block files (train_hybrid with
    also_ml=True and the script's seed, blocks and chunk) -> a resume from
    a directory missing blocks, bitwise -> ml_variant through
    ScanHybridRunner for one chunk -> the series as ERA-schema files ->
    train_from_era on them, one step held against the block-file model's
    -> hybrid steps of the file-trained model on an ObservedBoundary over
    the files. Returns the numbers it printed."""
    import numpy as np
    import torch
    from speedyml_torch import (FusedDataGenerator, ModelConfig, ModelDate,
                                ObservedBoundary, ReservoirConfig,
                                ScanHybridRunner, ml_variant, train_from_era,
                                train_hybrid)
    from speedyml_torch.core.calendar import (datetime_from_hours,
                                              hours_since_epoch)
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

    # one generator day from rest with host syncs forbidden between its
    # first launch and the read of its flux sums (its result is dropped:
    # the day body changes no state of the generator)
    gen = FusedDataGenerator(sp, hours=rcfg.timestep)
    gen.initialize(PIPELINE_YEAR, 1, spinup_days=0)
    surf, forcing, dry, _ = gen._day_inputs()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        day = gen._run_day(gen.gs, surf, forcing, dry)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not bool(day[3]):
        raise AssertionError("the sync-free generator day tripped the gate")
    del day, surf, forcing, dry, gen
    print("one generator day under set_sync_debug_mode('error'): no host "
          "sync between its first launch and the read of its flux sums")

    # the series reference_scale.py data generated, and its training part
    with np.load(os.path.join(work, "cache.npz")) as z:
        series = {k: z[k] for k in z.files}
    n_samples = series["atmo"].shape[0]
    n_train = n_samples - SCRIPTS_HOLDOUT
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
    print(f"FusedDataGenerator series of reference_scale.py data: "
          f"{n_samples} samples, "
          + "; ".join(f"{lab} T {ranges[lab + '_t'][0]:.1f}.."
                      f"{ranges[lab + '_t'][1]:.1f} K, |u| <= "
                      f"{max(map(abs, ranges[lab + '_u'])):.1f} m/s, q <= "
                      f"{ranges[lab + '_q'][1]:.1f} g/kg"
                      for lab in ("truth", "model"))
          + f"; rain in {wet:.0%} of cells and windows, max "
          f"{pr.max():.1f} mm/6h; model precipitation all zero")

    # what the train phase trained on: all but the held-out samples
    series = {k: v[:n_train] for k, v in series.items()}
    n_samples = n_train

    def up(k):
        return torch.as_tensor(series[k], device=dev)

    eps = rcfg.precip_epsilon
    gv_truth = transform_and_pack(L, up("atmo"), up("logp"), up("precip"),
                                  up("sst"), up("tisr"), eps)
    gv_model = transform_and_pack(L, up("m_atmo"), up("m_logp"),
                                  up("m_precip"), up("sst"), up("tisr"), eps)
    n = rcfg.nodes_per_input // L.n_in * L.n_in
    na = L.n_out + n
    # the train phase's seed, blocks and fold chunk: what its block files
    # were trained with
    ckdir = os.path.join(work, "cache.npz.train_ckpt")
    with np.load(os.path.join(ckdir, sorted(os.listdir(ckdir))[0])) as z:
        region_block = z["wout"].shape[0]
    train_kw = dict(seed=0, region_block=region_block, chunk=256)

    with tempfile.TemporaryDirectory() as tmp:
        launches = accum.accumulate_ss_scan.launches
        t0 = time.perf_counter()
        hm = train_hybrid(L, rcfg, gv_truth, gv_model, checkpoint_dir=ckdir,
                          also_ml=True, **train_kw)
        torch.cuda.synchronize()
        out["read_blocks_s"] = time.perf_counter() - t0
        if accum.accumulate_ss_scan.launches != launches:
            raise AssertionError("reading the block files trained a block")
        check_trained(hm, L, na)
        w = hm.wout_ml
        if w is None or tuple(w.shape) != (L.R, L.n_out, n) or \
                not bool(torch.isfinite(w).all()) or \
                w.device != hm.params.wout.device or w.device.type != dev.type:
            raise AssertionError(f"no finite ML-only readout on {dev}")
        print(f"train_hybrid(also_ml=True, checkpoint_dir) over the train "
              f"phase's {len(os.listdir(ckdir))} block files: "
              f"{out['read_blocks_s']:.1f} s, no block trained")

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


# ----------------------------------------------------------------------
# the scripts users run, and the model's options
# ----------------------------------------------------------------------
def _script(name):
    """A script of scripts_torch as a module: its main(argv) is what a user
    runs from the command line."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts_torch", name + ".py")
    spec = importlib.util.spec_from_file_location(f"scripts_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(name, argv, ok_codes=(0,)):
    """name's main(argv) in this process, its output echoed: (exit code,
    seconds, the kernel's launches in it, what it printed)."""
    import contextlib
    import io

    import torch
    from speedyml_torch.ops import accum
    buf = io.StringIO()
    n0 = accum.accumulate_ss_scan.launches
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = _script(name).main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = accum.accumulate_ss_scan.launches - n0
    text = buf.getvalue()
    print(text, end="")
    print(f"script {name} {argv[0]}: exit {rc} in {secs:.1f} s, {n} kernel "
          f"launches [{CARD}]")
    if rc not in ok_codes:
        raise AssertionError(f"{name} {argv}: exit code {rc}")
    torch.cuda.empty_cache()
    return rc, secs, n, text


def _json_printed(text):
    """The JSON object a script printed (its first '{' to its last '}')."""
    return json.loads(text[text.index("{"):text.rindex("}") + 1])


def _check_fields(label, arrays):
    """Finite, and inside the safety bounds where the field has one."""
    import numpy as np
    from speedyml_torch.hybrid.state_io import SAFE_BOUNDS
    for name, a in arrays.items():
        a = np.asarray(a)
        if not np.isfinite(a).all():
            raise AssertionError(f"{label}: {name} has non-finite values")
        if name in SAFE_BOUNDS:
            lo, hi = SAFE_BOUNDS[name]
            if not (lo <= a.min() and a.max() <= hi):
                raise AssertionError(f"{label}: {name} in {a.min():.2f}.."
                                     f"{a.max():.2f} leaves {lo}..{hi}")


def _check_kernel(R, T, chunk, na):
    """accumulate_ss_scan against its plain version and timed at one shape
    (phase_kernel), its launches left out of the path's count."""
    import torch
    from speedyml_torch.ops import accum
    launches = accum.accumulate_ss_scan.launches
    res = phase_kernel(R, T, chunk, na, only_scan=True)["accumulate_ss_scan"]
    accum.accumulate_ss_scan.launches = launches
    torch.cuda.empty_cache()
    return res


def phase_scripts(bindir, work):
    """The scripts of scripts_torch as users run them, each through its
    main(argv) in this process, at reference width (--m 6000: n=5760, 1152
    regions, na=5896) on the stand-in boundary files: reference_scale data
    (with the ENSO-like anomaly), train (both readouts, block
    checkpoints), predict, coupled --ocean-train-only and coupled (the
    chunked loop with the slab ocean, a forecast file); then score_run,
    decade_table, analyze_forecast and enso_eval on its forecast file and
    cache, and climate_check cache on the cache. The kernel is held against
    its plain version at the train and ocean-train phases' first shapes
    just before each. Stand-in boundaries and a few weeks are no climate:
    the climate bands are printed, not asserted. Everything is written to
    `work`, where the pipeline phase reads the cache and the block files.
    Returns the numbers it printed."""
    import numpy as np
    import torch
    from speedyml_torch import ReservoirConfig
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.hybrid.experiment import (SOLVE_BYTES_PER_ENTRY,
                                                  region_block_for)
    from speedyml_torch.io.output import read_forecast
    from speedyml_torch.reservoir.slab import build_ocean_layout

    rcfg = ReservoirConfig()
    L = build_layout()
    n = round(rcfg.nodes_per_input / L.n_in) * L.n_in
    na = L.n_out + n
    week = rcfg.timestep_slab // rcfg.timestep
    n_train = SCRIPTS_OCEAN_WEEKS * week
    samples = n_train + SCRIPTS_HOLDOUT
    pairs = n_train - rcfg.discardlength // rcfg.timestep - 1
    chunk = 256                                   # the script's --chunk
    ocean_block, ocean_m = 64, 2000               # its ocean defaults
    ol = build_ocean_layout(L)
    na_o = ol.n_out + round(ocean_m / ol.n_in) * ol.n_in
    discard_o = max(1, min(SCRIPTS_OCEAN_WEEKS // 4, 8))
    pairs_o = SCRIPTS_OCEAN_WEEKS - discard_o - 1
    coupled_steps = SCRIPTS_COUPLED_WEEKS * week
    enso = ["--enso-seed", str(ENSO["seed"]), "--enso-amp",
            str(ENSO["amp"]), "--enso-period-days", str(ENSO["period_days"])]
    out = {"samples": samples, "pairs": pairs, "na": na}

    def f(name):
        return os.path.join(work, name)

    common = ["--bindir", bindir, "--cache", f("cache.npz"), "--holdout",
              str(SCRIPTS_HOLDOUT), "--weights", f("w.nc"),
              "--ml-weights", f("w_ml.nc")]
    # the data phase, in a year whose days lie inside the anomaly's record
    _, out["data_s"], _, _ = _run_script("reference_scale", [
        "data", "--samples", str(samples), "--spinup-days",
        str(SCRIPTS_SPINUP_DAYS), "--year", str(PIPELINE_YEAR)] + enso
        + common)
    with np.load(f("cache.npz")) as z:
        keys = sorted(z.files)
        if keys != sorted(["atmo", "logp", "precip", "sst", "tisr",
                           "hours", "m_atmo", "m_logp", "m_precip"]):
            raise AssertionError(f"cache keys {keys}")
        if z["atmo"].shape != (samples, 4, L.kx, L.il, L.ix):
            raise AssertionError(f"cache atmo {z['atmo'].shape}")
        for label, key in (("truth", "atmo"), ("model", "m_atmo")):
            _check_fields(f"cache {label}", {
                k: z[key][:, i] for i, k in enumerate("tuvq")})
        _check_fields("cache", {k: z[k] for k in (
            "logp", "precip", "sst", "tisr")})
        sst_var = float(z["sst"].std(axis=0).max())
    print(f"cache: {samples} samples, largest SST std over the series "
          f"{sst_var:.2f} K (the imposed anomaly)")

    # train: the block the card's free memory holds beside the series,
    # and the kernel at its shape first
    series_bytes = 2 * 4 * L.gv_len * samples
    rb = region_block_for(na, torch.cuda.mem_get_info()[0], L.R,
                          series_bytes, chunk)
    out["region_block"] = rb
    out["at_train_shape"] = dict(T=pairs, R=rb, na=na, **_check_kernel(
        rb, pairs, min(chunk, pairs), na))
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, out["train_s"], out["launches_train"], _ = _run_script(
        "reference_scale", ["train", "--region-block", str(rb)] + common)
    # a block's own working set: the train phase's peak over what this
    # process held before it, the packed series and the two readouts it
    # fills block by block
    peak = torch.cuda.max_memory_allocated()
    held = series_bytes + 4 * L.R * L.n_out * (na + n)
    out.update(train_peak_gib=peak / 2**30,
               block_peak_gib=(peak - before - held) / 2**30,
               budget_gib=rb * na * na * SOLVE_BYTES_PER_ENTRY / 2**30)
    print(f"train phase: peak device memory {out['train_peak_gib']:.2f} GiB, "
          f"of it a block's own {out['block_peak_gib']:.2f} GiB "
          f"(region_block_for budgets {out['budget_gib']:.2f} GiB) [{CARD}]")
    for name in ("w.nc", "w_ml.nc"):
        if not os.path.getsize(f(name)) > 0:
            raise AssertionError(f"the train phase wrote no {name}")
    blocks = os.listdir(f("cache.npz.train_ckpt"))
    if len(blocks) != -(-L.R // rb) or out["launches_train"] < 1:
        raise AssertionError(f"{len(blocks)} block files, "
                             f"{out['launches_train']} launches")
    _, out["predict_s"], _, _ = _run_script("reference_scale", [
        "predict", "--fc-steps", str(SCRIPTS_HOLDOUT), "--results",
        f("predict.json")] + common)
    with open(f("predict.json")) as fh:
        pred = json.load(fh)
    lead = pred["leads"][f"{SCRIPTS_HOLDOUT * rcfg.timestep}h"]
    if not all(np.isfinite(v) for row in lead.values()
               for v in row.values()):
        raise AssertionError(f"predict scores {lead}")
    out["predict_leads"] = pred["leads"]

    # the ocean: the kernel at its training shape, then the phase
    out["at_ocean_shape"] = dict(T=pairs_o, R=ocean_block, na=na_o,
                                 **_check_kernel(ocean_block, pairs_o,
                                                 pairs_o, na_o))
    _, out["ocean_train_s"], out["launches_ocean"], _ = _run_script(
        "reference_scale", ["coupled", "--ocean-train-only",
                            "--results", f("coupled.json")] + common)
    if out["launches_ocean"] < 1 or not os.listdir(
            f("cache.npz.ocean_ckpt")):
        raise AssertionError("the ocean trained without the kernel or "
                             "wrote no block")
    nc = f("run.nc")
    _, out["coupled_s"], _, _ = _run_script("reference_scale", [
        "coupled", "--fc-steps", str(coupled_steps), "--out", nc,
        "--results", f("coupled.json")] + common)
    with open(f("coupled.json")) as fh:
        res = json.load(fh)
    if res["steps"] != coupled_steps or res["aborted"] or \
            res["loop"] != "fast":
        raise AssertionError(f"coupled run: {res}")
    fc = read_forecast(nc)
    _check_fields("forecast file", {
        "t": fc["Temperature"], "u": fc["U-wind"], "v": fc["V-wind"],
        "q": fc["Specific-Humidity"], "logp": fc["logp"],
        "sst": fc["SST"], "p6hr": fc["p6hr"]})
    if fc["Temperature"].shape[0] != coupled_steps:
        raise AssertionError(f"{fc['Temperature'].shape[0]} steps in "
                             f"the forecast file")
    ckpt = os.path.exists(nc + ".ckpt.npz")
    if ckpt != (coupled_steps >= 112):      # the script's cadence
        raise AssertionError(f"run checkpoint present: {ckpt}")
    out["coupled_ms_per_step"] = 1e3 * res["wall_s"] / coupled_steps
    out["coupled"] = {k: res[k] for k in ("T_range", "u_range",
                                          "q_range", "sst_range",
                                          "sst_drift_K")}

    # the scripts that judge the run
    rc, out["score_run_s"], _, text = _run_script(
        "score_run", ["--nc", nc, "--out", f("score.json"),
                      "--skip-days", "1"], ok_codes=(0, 1))
    with open(f("score.json")) as fh:
        score = json.load(fh)
    if score != _json_printed(text) or score["ok"] != (rc == 0):
        raise AssertionError("score_run's JSON and verdict disagree")
    out["score_run"] = score
    _, out["decade_table_s"], _, text = _run_script(
        "decade_table", ["--nc", nc, "--steps-per-year",
                         str(SCRIPTS_STEPS_PER_YEAR), "--out",
                         f("decade.json")])
    with open(f("decade.json")) as fh:
        table = json.load(fh)
    if len(table["years"]) != coupled_steps // SCRIPTS_STEPS_PER_YEAR:
        raise AssertionError(f"decade table: {len(table['years'])} "
                             f"years")
    _, out["analyze_forecast_s"], _, _ = _run_script(
        "analyze_forecast", [nc, "--pressure", "500", "850"])
    _, out["enso_eval_s"], _, text = _run_script(
        "enso_eval", ["--nc", nc, "--cache", f("cache.npz"),
                      "--holdout", str(SCRIPTS_HOLDOUT), "--skip-days",
                      "1", "--bindir", bindir, "--out", f("enso.json")]
        + enso)
    with open(f("enso.json")) as fh:
        ev = json.load(fh)
    if ev != _json_printed(text) or not np.isfinite(
            ev["nino34_run_anom_std_K"]):
        raise AssertionError(f"enso_eval: {ev}")
    out["enso_eval"] = ev
    rc, out["climate_check_s"], _, text = _run_script(
        "climate_check", ["cache", "--cache", f("cache.npz")],
        ok_codes=(0, 1))
    cc = _json_printed(text)
    if cc["ok"] != (rc == 0) or not all(
            np.isfinite(v) for v in cc["scores"].values()):
        raise AssertionError(f"climate_check cache: {cc}")
    out["climate_check_cache"] = cc["scores"]
    print(f"scripts at reference width [{CARD}]: data {out['data_s']:.1f} "
          f"s ({samples} samples), train {out['train_s']:.1f} s "
          f"({out['launches_train']} launches, blocks of {rb}), predict "
          f"{out['predict_s']:.1f} s, ocean train {out['ocean_train_s']:.1f} "
          f"s ({out['launches_ocean']} launches), coupled "
          f"{out['coupled_s']:.1f} s ({coupled_steps} steps, "
          f"{out['coupled_ms_per_step']:.1f} ms/step on the host clock "
          f"with its load and ocean set-up); score_run ok={score['ok']}, "
          f"enso_eval ok={ev['ok']}, climate_check cache ok={cc['ok']} "
          f"(bands printed above, not asserted)")
    return out


def _worker_files(work):
    """The reference-worker files at reference width: the first
    WORKER_REGIONS regions of the scripts' trained model (a view of its
    tensors and of its layout, made here) written by export_worker_files,
    read back onto the card by import_worker_files equal, the circulant
    shifts recovered, one ESN step of the imported model equal to the
    original's. Returns the numbers it printed."""
    import shutil

    import torch
    from speedyml_torch.domain.standardize import Standardizer
    from speedyml_torch.io.weights import (export_worker_files,
                                           import_worker_files, load_model)
    from speedyml_torch.reservoir.esn import predict_step

    R = WORKER_REGIONS
    hm = load_model(os.path.join(work, "w.nc"))
    p = hm.params
    view = dataclasses.replace(
        hm, layout=dataclasses.replace(hm.layout, R=R),
        params=dataclasses.replace(p, a_idx=p.a_idx[:R], a_val=p.a_val[:R],
                                   win=p.win[:R], wout=p.wout[:R].clone()),
        stz=Standardizer(*(t[:R].clone() for t in hm.stz)))
    del hm, p
    torch.cuda.empty_cache()
    wdir = os.path.join(work, "workers")
    t0 = time.perf_counter()
    export_worker_files(wdir, view, trial_name="smoke")
    export_s = time.perf_counter() - t0
    files = [n for n in os.listdir(wdir) if n.startswith("worker_")]
    nbytes = sum(os.path.getsize(os.path.join(wdir, n)) for n in files)
    t0 = time.perf_counter()
    imp = import_worker_files(wdir, view.layout, view.rcfg,
                              trial_name="smoke", ml_only=view.ml_only)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    if len(files) != R or not imp.params.wout.is_cuda:
        raise AssertionError(f"{len(files)} worker files, imported onto "
                             f"{imp.params.wout.device}")
    a, b = view.params, imp.params
    for name in ("a_idx", "a_val", "win", "wout"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"worker files: {name} read back unequal")
    for x, y in zip(view.stz, imp.stz):
        if not torch.equal(x, y):
            raise AssertionError("worker files: statistics unequal")
    if b.a_shift is None or tuple(b.a_shift) != tuple(a.a_shift):
        raise AssertionError(f"circulant shifts {b.a_shift}, not "
                             f"{a.a_shift}")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    L = view.layout
    u = torch.randn(R, L.n_in, device="cuda", generator=g)
    mv = torch.randn(R, L.n_out, device="cuda", generator=g)
    x = 0.5 * torch.randn(R, a.n, device="cuda", generator=g)
    xa, oa = predict_step(a, x, u, None if view.ml_only else mv)
    xb, ob = predict_step(b, x, u, None if imp.ml_only else mv)
    if not (torch.equal(xa, xb) and torch.equal(oa, ob)):
        raise AssertionError("the imported model's ESN step differs")
    shutil.rmtree(wdir)
    out = dict(worker_regions=R, worker_files_gb=nbytes / 1e9,
               worker_file_mb=nbytes / R / 1e6, worker_export_s=export_s,
               worker_import_s=import_s)
    print(f"worker files at reference width (n={a.n}, na={a.wout.shape[-1]}"
          f"): {R} regions, {nbytes / 1e9:.3f} GB ({nbytes / R / 1e6:.1f} "
          f"MB a file) written in {export_s:.1f} s, read back onto the card "
          f"in {import_s:.1f} s: equal, shifts recovered, one ESN step "
          f"bitwise [{CARD}]")
    return out


def phase_tools(bindir, work):
    """The tools users run on the files the scripts phase left in `work`
    (cache.npz, w.nc, run.nc), each through its main(argv) in this process
    where it is a script: the reference-worker files at reference width
    (the library functions, on a cut of WORKER_REGIONS regions);
    demo_hybrid.py on the cache with --ocean, --out, --grads, --components
    and its ML-only branch, the kernel held against its plain version at
    the demo's training shapes first; diag_precip_bias.py then
    make_precip_debias.py with `work` as the working directory;
    diag_wetbias.py on the scripts' run and the demo's forecast; mldivide on
    one region's float64 system, card against CPU; the native IO loader
    built here, its decoder against numpy on the stand-in boundary files
    and its gathers against numpy on the cache's packed series. Returns the
    numbers it printed."""
    import numpy as np
    import torch
    from speedyml_torch import ReservoirConfig
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.hybrid.experiment import QMIN, transform_and_pack
    from speedyml_torch.io import boundary, native_loader
    from speedyml_torch.io.output import read_forecast
    from speedyml_torch.io.grads import read_grads
    from speedyml_torch.reservoir.linalg import mldivide
    from speedyml_torch.reservoir.slab import build_ocean_layout

    def f(name):
        return os.path.join(work, name)

    out = _worker_files(work)
    torch.cuda.empty_cache()

    # the demo: the kernel at its training shapes, then the script
    with np.load(f("cache.npz")) as z:
        samples = z["atmo"].shape[0]
    L = build_layout()
    rcfg = ReservoirConfig()
    ol = build_ocean_layout(L)
    pairs = samples - DEMO_DISCARD_H // rcfg.timestep - 1
    weeks = samples // (rcfg.timestep_slab // rcfg.timestep)
    pairs_o = weeks - max(1, min(weeks // 4, 8)) - 1
    na_o = ol.n_out + round(500 / ol.n_in) * ol.n_in
    block = 192
    shapes = {"demo_hybrid": (block, pairs, DEMO_CHUNK, L.n_out + DEMO_NODES),
              "demo_ml_only": (block, pairs, DEMO_CHUNK, DEMO_NODES),
              "demo_ocean": (DEMO_OCEAN_BLOCK, pairs_o,
                             min(16, pairs_o), na_o),
              # diag_hybrid.py at its default 120 samples: 104 for
              # training, 4 discarded (it runs on the CPU tests alone)
              "diag_hybrid": (block, 120 - 16 - 4 - 1, DEMO_CHUNK,
                              L.n_out + DEMO_NODES)}
    for name, (R, T, chunk, na) in shapes.items():
        out[f"at_{name}_shape"] = dict(T=T, R=R, na=na, chunk=chunk,
                                       **_check_kernel(R, T, chunk, na))
    argv = ["--bindir", bindir, "--cache", f("cache.npz"), "--ocean",
            "--fc-steps", str(DEMO_FC_STEPS), "--out", f("demo.nc"),
            "--grads", f("demo"), "--components", f("comp")]
    _, out["demo_s"], out["launches_demo"], text = _run_script(
        "demo_hybrid", argv)
    if "DEMO OK" not in text or "ml-only forecast ok" not in text:
        raise AssertionError("the demo did not finish both forecasts")
    fc = read_forecast(f("demo.nc"))
    names = ("Temperature", "U-wind", "V-wind", "Specific-Humidity")
    _check_fields("demo forecast", dict(
        zip("tuvq", (fc[k] for k in names)), logp=fc["logp"],
        sst=fc["SST"], p6hr=fc["p6hr"]))
    if fc["Temperature"].shape[0] != DEMO_FC_STEPS:
        raise AssertionError(f"{fc['Temperature'].shape[0]} demo steps")
    a3, a2 = read_grads(f("demo"), *fc["Temperature"].shape[1:])
    if not (np.array_equal(a3[:, 0], fc["Temperature"])
            and np.array_equal(a2[:, 0], fc["logp"])):
        raise AssertionError("the demo's GrADS file is not its forecast")
    ml, sp = read_forecast(f("comp_ml.nc")), read_forecast(f("comp_p.nc"))
    worst = 0.0
    for k in names + ("logp",):
        total = ml[k].astype(np.float64) + sp[k]
        if k == "Specific-Humidity":
            total = np.maximum(total, QMIN)
        err = float(np.abs(total - fc[k]).max() / np.abs(fc[k]).max())
        worst = max(worst, err)
        if not err <= 1e-5:
            raise AssertionError(f"demo components: {k} off by {err:.2e} "
                                 f"of its scale")
    out["demo_components_err"] = worst
    print(f"demo: {DEMO_FC_STEPS} hybrid steps with the ocean and the "
          f"ML-only branch in {out['demo_s']:.1f} s, {out['launches_demo']} "
          f"kernel launches; forecast, GrADS and component files read back, "
          f"components sum to the forecast to {worst:.2e} of scale [{CARD}]")

    # the precip-debias chain, in `work` as users run it
    os.makedirs(f("data"), exist_ok=True)
    here = os.getcwd()
    os.chdir(work)
    try:
        _, out["diag_precip_bias_s"], _, text = _run_script(
            "diag_precip_bias", [
                "--bindir", bindir, "--cache", f("cache.npz"), "--weights",
                f("w.nc"), "--n", str(samples), "--holdout",
                str(SCRIPTS_HOLDOUT), "--sync", str(PRECIP_SYNC), "--out",
                f("precip_bias.json")])
        _, out["make_precip_debias_s"], _, text = _run_script(
            "make_precip_debias", [
                "--run", f("run.nc"), "--cache", f("cache.npz"), "--skip",
                str(DEBIAS_SKIP), "--validate", f("run.nc")])
    finally:
        os.chdir(here)
    with np.load(f("data/precip_bias.npz")) as z:
        debias = z["debias"]
        sig = z["log_resid_std"]
    if debias.shape != (L.il, L.ix) or not np.isfinite(debias).all() \
            or debias.min() < 0.0 or not np.isfinite(sig).all():
        raise AssertionError(f"debias field {debias.shape}, range "
                             f"{debias.min()}..{debias.max()}")
    deb = _json_printed(text)
    out.update(debias_max=float(debias.max()),
               debias_cells=int((debias > 0).sum()),
               run_mm_day=deb["run_mm_day"],
               run_mm_day_corrected=deb["run_mm_day_corrected"])
    rc, out["diag_wetbias_s"], _, text = _run_script("diag_wetbias", [
        "--bindir", bindir, "--coupled", f("run.nc"), "--hybrid",
        f("demo.nc"), "--cache", f("cache.npz"), "--holdout",
        str(SCRIPTS_HOLDOUT), "--skip-days", "0"])
    wet = _json_printed(text)

    def numbers(o):
        if isinstance(o, dict):
            return [x for v in o.values() for x in numbers(v)]
        if isinstance(o, list):
            return [x for v in o for x in numbers(v)]
        return [o] if isinstance(o, (int, float)) else []

    if not np.isfinite(numbers(wet)).all():
        raise AssertionError(f"diag_wetbias: {wet}")
    print(f"precip debias: field up to {out['debias_max']:.3f} in "
          f"{out['debias_cells']} cells, run {deb['run_mm_day']} -> "
          f"{deb['run_mm_day_corrected']} mm/day; diag_precip_bias "
          f"{out['diag_precip_bias_s']:.1f} s, make_precip_debias "
          f"{out['make_precip_debias_s']:.1f} s, diag_wetbias "
          f"{out['diag_wetbias_s']:.1f} s [{CARD}]")

    # mldivide on one region's system, card against CPU
    na = L.n_out + round(rcfg.nodes_per_input / L.n_in) * L.n_in
    g = torch.Generator(device="cuda").manual_seed(SEED)
    m = torch.randn(na, na, device="cuda", generator=g, dtype=torch.float64)
    A = m @ m.mT / na + 0.5 * torch.eye(na, device="cuda",
                                        dtype=torch.float64)
    B = torch.randn(L.n_out, na, device="cuda", generator=g,
                    dtype=torch.float64)
    mldivide(A, B)
    out["mldivide_ms"] = _cuda_ms(lambda: mldivide(A, B), 3)
    X = mldivide(A, B).cpu()
    t0 = time.perf_counter()
    Xc = mldivide(A.cpu(), B.cpu())
    out["mldivide_cpu_s"] = time.perf_counter() - t0
    rel = float((X - Xc).norm() / Xc.norm())
    if not rel <= LINALG_TOL:
        raise AssertionError(f"mldivide card against CPU: {rel:.2e}")
    out["mldivide_rel_err"] = rel
    del m, A, B
    print(f"mldivide ({na}, {na}) float64 with {L.n_out} right-hand sides:"
          f" {out['mldivide_ms']:.2f} ms on the card by CUDA events, "
          f"{out['mldivide_cpu_s']:.2f} s on the host; relative difference "
          f"{rel:.2e} (bound {LINALG_TOL}) [{CARD}]")

    # the native loader: built on this machine (get_lib); its build timed
    # once more into a directory of its own
    native_loader.get_lib()
    build_dir = native_loader.BUILD_DIR
    with tempfile.TemporaryDirectory() as d:
        native_loader.BUILD_DIR = Path(d)
        try:
            t0 = time.perf_counter()
            native_loader.build()
            out["native_build_s"] = time.perf_counter() - t0
        finally:
            native_loader.BUILD_DIR = build_dir
    # the stand-in boundary files through the native reader and through the
    # model's (numpy) reader: equal, each timed over the whole set
    paths = [os.path.join(bindir, n) for n in sorted(os.listdir(bindir))]
    decoded = {}
    for label, read in (("native", native_loader.read_records_native),
                        ("numpy", boundary.read_boundary_records)):
        t0 = time.perf_counter()
        decoded[label] = [read(p, L.ix, L.il) for p in paths]
        out[f"{label}_decode_ms"] = (time.perf_counter() - t0) * 1e3
    for p, a, b in zip(paths, decoded["native"], decoded["numpy"]):
        if not np.array_equal(a, b):
            raise AssertionError(f"native decode of {p} differs")
    boundary_mb = sum(os.path.getsize(p) for p in paths) / 1e6
    with np.load(f("cache.npz")) as z:
        gv = transform_and_pack(L, *(torch.as_tensor(z[k]) for k in (
            "atmo", "logp", "precip", "sst", "tisr")),
            rcfg.precip_epsilon).numpy()
    idx = L.input_index
    t0 = time.perf_counter()
    stream = native_loader.GvStream.write_cache(f("gv.cache"), gv)
    nt = min(64, samples - 8)
    got = stream.gather(idx, 8, nt)
    out["gv_stream_s"] = time.perf_counter() - t0
    stream.close()
    want = gv[8:8 + nt][:, idx]
    if not (np.array_equal(got, want) and np.array_equal(
            native_loader.mem_gather(gv, idx, 8, nt), want)):
        raise AssertionError("native gathers differ from numpy")
    os.remove(f("gv.cache"))
    print(f"native IO loader built in {out['native_build_s']:.1f} s; the "
          f"stand-in boundary files ({len(paths)}, {boundary_mb:.2f} MB) "
          f"decode as numpy does: {out['native_decode_ms']:.2f} ms native, "
          f"{out['numpy_decode_ms']:.2f} ms numpy on the host; GvStream and "
          f"mem_gather give numpy's ({nt}, {idx.shape[0]}, {idx.shape[1]}) "
          f"block of the cache's packed series ({gv.nbytes / 1e6:.0f} MB "
          f"written and gathered in {out['gv_stream_s']:.2f} s)")
    return out


def phase_free_options(bindir):
    """The full-physics model with SPPT, random diabatic forcing and time
    means for OPTIONS_DAYS days: its fields finite and in bounds, the GrADS
    file of its time means read back bitwise, each mean inside the range
    of the samples it averaged, the tendencies of a step with SPPT against
    the same step without it; climate_check run on the card; ms per model
    day with the options and without them, by CUDA events."""
    import numpy as np
    import torch
    import speedyml_torch.model as model_mod
    from speedyml_torch import ModelConfig
    from speedyml_torch.io.grads import read_grads
    from speedyml_torch.model import Speedy
    from speedyml_torch.utils import timemean as tmm

    opts = dict(sppt_on=True, rdf_on=True, time_means_on=True)
    out = {}
    # the extremes of every sample the accumulators take
    ext = {}
    orig_update, orig_fluxes = model_mod.tm_update, model_mod.tm_update_fluxes

    def track(key, sample):
        lo, hi = ext.get(key, (sample, sample))
        ext[key] = (torch.minimum(lo, sample), torch.maximum(hi, sample))

    def tm_update(dy, st, fld, tm):
        new = orig_update(dy, st, fld, tm)
        track("mean3d", new.mean3d - tm.mean3d)
        track("mean2d", new.mean2d - tm.mean2d)
        return new

    def tm_update_fluxes(fx, tm):
        new = orig_fluxes(fx, tm)
        track("flux2d", new.flux2d - tm.flux2d)
        return new

    sp = Speedy(ModelConfig(**opts), bindir)
    model_mod.tm_update, model_mod.tm_update_fluxes = (tm_update,
                                                       tm_update_fluxes)
    try:
        sp.initialize(1982, 1)
        sp.run_days(OPTIONS_DAYS)
        torch.cuda.synchronize()
    finally:
        model_mod.tm_update, model_mod.tm_update_fluxes = (orig_update,
                                                           orig_fluxes)
    view = sp.grid_view()
    _check_fields("options run", {k: view[k] for k in ("t", "u", "v", "q")})
    if not all(bool(torch.isfinite(v).all()) for v in sp.state):
        raise AssertionError("options run: non-finite spectral state")
    tm = sp.time_means
    counts = (float(tm.rnsave), float(tm.nstep))
    cfg = sp.config
    if counts != (OPTIONS_DAYS * cfg.nsteps // cfg.nstppr,
                  OPTIONS_DAYS * cfg.nsteps):
        raise AssertionError(f"time-mean counters {counts}")
    sums = {"mean3d": tm.mean3d, "mean2d": tm.mean2d, "flux2d": tm.flux2d}
    worst = 0.0
    for key, total in sums.items():
        n = counts[1] if key == "flux2d" else counts[0]
        lo, hi = ext[key]
        mean = total.double() / n
        # the f32 sums of up to OPTIONS_DAYS * 96 samples round by a few
        # hundred ulps of the field's size
        slack = 1e-5 * torch.maximum(lo.abs(), hi.abs()).double() + 1e-30
        over = torch.maximum(lo.double() - mean, mean - hi.double())
        worst = max(worst, float((over / slack).max()))
        if not bool((over <= slack).all()):
            raise AssertionError(f"time means {key}: a mean leaves the "
                                 f"range of its samples")

    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "means")
        fields = sp.write_time_means(base)
        n3 = [k for k in tmm.MEAN3D_NAMES + tmm.VAR3D_NAMES if k in fields]
        n2 = [k for k in tmm.MEAN2D_NAMES + tmm.FLUX2D_NAMES if k in fields]
        g3, g2 = read_grads(base, cfg.kx, cfg.il, cfg.ix, len(n3), len(n2))
        for g, names in ((g3, n3), (g2, n2)):
            for i, name in enumerate(names):
                if not np.array_equal(g[0, i], fields[name].astype("<f4")):
                    raise AssertionError(f"GrADS {name} does not read back "
                                         f"bitwise")
                if not np.isfinite(g[0, i]).all():
                    raise AssertionError(f"GrADS {name} non-finite")
        with open(base + ".ctl") as fh:
            ctl = fh.read()
        if f"vars {len(n3) + len(n2)}" not in ctl:
            raise AssertionError("the .ctl does not list the variables")
    if float(sp.time_means.rnsave) != 0.0:
        raise AssertionError("write_time_means did not reset the sums")

    # one step's tendencies with the next SPPT pattern and without it
    surf, _ = sp.surf_forcing(sp.date)
    _, pattern = sp._sppt.step(sp._sppt_state, sp._sppt_day + 1, 0)
    f = sp.state.at_level(0)
    on = sp._phys_fn(surf, sp.rad, True, sp._randfh, pattern)(sp.dy, f)[0]
    off = sp._phys_fn(surf, sp.rad, True, sp._randfh)(sp.dy, f)[0]
    no_rdf = sp._phys_fn(surf, sp.rad, True)(sp.dy, f)[0]
    d_sppt = max(float((a - b).abs().max()) for a, b in zip(on, off))
    if not d_sppt > 0.0:
        raise AssertionError("SPPT left the tendencies as they were")
    for a, b in zip(on, off):
        if not torch.allclose(a, b * (1.0 + pattern * sp._sppt.mu_col),
                              rtol=1e-6, atol=0.0):
            raise AssertionError("the SPPT tendencies are not the plain "
                                 "ones times 1 + pattern * mu")
    d_rdf = [float((a - b).abs().max()) for a, b in zip(off, no_rdf)]
    if not (d_rdf[2] > 0.0 and d_rdf[0] == d_rdf[1] == d_rdf[3] == 0.0):
        raise AssertionError(f"random diabatic forcing moved {d_rdf}")
    out.update(sppt_max_tendency_change=d_sppt, rdf_max_dtt=d_rdf[2],
               mean_range_worst=worst)
    del sp

    # ms per model day by CUDA events, in turns (options, plain, plain,
    # options) after a first day of each model
    models = {"options": Speedy(ModelConfig(**opts), bindir),
              "plain": Speedy(ModelConfig(), bindir)}
    for m in models.values():
        m.initialize(1982, 1)
        m.run_day()
    turns = {"options": [], "plain": []}
    for label in ("options", "plain", "plain", "options"):
        turns[label].append(_cuda_ms(models[label].run_day, 1))
    for label, ms in turns.items():
        out[f"day_ms_{label}"] = statistics.mean(ms)
        out[f"day_ms_{label}_turns"] = ms
    del models
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "climate.json")
        rc, out["climate_check_run_s"], _, text = _run_script(
            "climate_check", ["run", "--spinup", "0", "--days", "2",
                              "--bindir", bindir, "--out", path],
            ok_codes=(0, 1))
        with open(path) as fh:
            js = json.load(fh)
    verdict = text.strip().splitlines()[-1]
    if js != _json_printed(text) or js["ok"] != (rc == 0) or \
            verdict != "CLIMATE CHECK " + ("OK" if js["ok"] else "FAILED") \
            or not all(np.isfinite(v) for v in js["scores"].values()):
        raise AssertionError(f"climate_check run: {js}, {verdict!r}")
    out["climate_check_run"] = js["scores"]
    print(f"model options [{CARD}]: {OPTIONS_DAYS} days with SPPT, random "
          f"diabatic forcing and time means: fields in bounds, GrADS read "
          f"back bitwise, every mean inside its samples' range (worst "
          f"{worst:.2f} of the float32 slack), SPPT changes a tendency by "
          f"up to {d_sppt:.3e} (exactly 1 + pattern * mu), the forcing dtt "
          f"by up to {d_rdf[2]:.3e} K/s; ms per model day by CUDA events, "
          f"mean of two turns: {out['day_ms_options']:.1f} with the options "
          f"{turns['options']}, {out['day_ms_plain']:.1f} without "
          f"{turns['plain']}; climate_check run exit {rc}")
    return out



def _md_setup(bindir, dev):
    """The multi-device phase's model, the same in every process from the
    seed: the float32 model on the stand-in files at its first date, the
    reference-width reservoirs (generate_esn) with a 0.003-scale random
    readout and a standardizer anchored to the start state, and the step's
    inputs. Returns (sp, hm, x0, inputs) with inputs (atmo, logp, precip_t,
    sst, tisr)."""
    import numpy as np
    import torch
    from speedyml_torch import ModelConfig, ReservoirConfig
    from speedyml_torch.domain.decomposition import (build_layout,
                                                     pack_global)
    from speedyml_torch.domain.standardize import Standardizer
    from speedyml_torch.hybrid.experiment import HybridModel
    from speedyml_torch.hybrid.state_io import extract
    from speedyml_torch.model import Speedy
    from speedyml_torch.physics.radiation import diurnal_tisr
    from speedyml_torch.reservoir.generate import generate_esn

    sp = Speedy(ModelConfig(), bindir, device=dev)
    sp.initialize(1982, 1)
    rcfg = ReservoirConfig()
    L = build_layout(radang_deg=np.degrees(np.asarray(sp.dy.tables.radang)))
    gs = extract(sp.dy, sp.state)
    atmo = torch.stack([gs.t, gs.u, gs.v, torch.clamp(gs.q, min=1e-6)])
    logp = gs.logp
    pr = torch.zeros_like(logp)
    sst = np.maximum(np.asarray(sp.coupler.sst_am, np.float32), 272.0)
    tisr = np.asarray(diurnal_tisr(sp.date.tyear, sp.date.ihour,
                                   sp.dy.tables.gsin, sp.dy.tables.gcos,
                                   L.ix), np.float32)
    gv0 = pack_global(L, atmo, logp, pr, torch.as_tensor(sst, device=dev),
                      torch.as_tensor(tisr, device=dev))
    params = generate_esn(SEED, L.R, L.n_in, L.n_out, L.n_out,
                          m_target=rcfg.nodes_per_input, deg=rcfg.degree,
                          sigma=rcfg.sigma, leakage=rcfg.leakage,
                          device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    params.wout = 0.003 * torch.randn(params.wout.shape, device=dev,
                                      generator=g)
    idx, tidx = L.maps(dev)
    stz = Standardizer(in_mean=gv0[idx],
                       in_std=torch.full(idx.shape, 5.0, device=dev),
                       out_mean=gv0[tidx],
                       out_std=torch.ones(tidx.shape, device=dev))
    hm = HybridModel(L, params, stz, rcfg)
    x0 = 0.1 * torch.randn((L.R, params.n), device=dev, generator=g)
    return sp, hm, x0, (atmo, logp, pr, sst, tisr)


def _md_composed(sp, hm, x0, inputs, lat, physics):
    """The composed step on this rank: one warm-up, then MD_STEPS timed
    steps from the same inputs (host clock between a barrier and the
    card's synchronization). Returns its ms, collectives per step, flag,
    and (the gathers outside the timed steps) the whole outputs on the
    host."""
    import torch
    import torch.distributed as dist
    from speedyml_torch.parallel.comm import counts
    from speedyml_torch.parallel.composed import ComposedHybridStep
    from speedyml_torch.parallel.mesh import Placement, gather, shard

    comp = ComposedHybridStep(hm, sp, lat, physics=physics)
    regions = Placement(lat, ("lat",))
    x = shard(x0, regions)
    surf = comp.shard_surface(sp.surf)
    for _ in range(MD_WARM):
        comp.step(x, *inputs, surf, sp.forcing)
    comp.comm.reset()
    ms = []
    for _ in range(MD_STEPS):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = comp.step(x, *inputs, surf, sp.forcing)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    per_step = {k: {n: v // MD_STEPS for n, v in c.items()}
                for k, c in counts(comp.comm).items()}
    for k, v in comp.comm.seconds.items():
        per_step[k]["ms"] = 1e3 * v / MD_STEPS
    x1, atmo, logp, pr, safe = out
    return dict(ms=ms, comm=per_step, safe=bool(safe),
                out=[gather(x1, regions).cpu(), atmo.cpu(), logp.cpu(),
                     pr.cpu()])


def _md_training(mesh, dev):
    """The sharded training drive on a block of MD_TRAIN_REGIONS regions at
    reference width, gathered, bitwise against the single-device drive
    (rank 0 holds it); returns the rank's kernel launches."""
    import torch
    from speedyml_torch import ReservoirConfig
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.ops import accum
    from speedyml_torch.parallel import reservoir as pres
    from speedyml_torch.parallel.mesh import (fold_sharding, gather,
                                              series_sharding, shard,
                                              shard_params, state_sharding)
    from speedyml_torch.reservoir.generate import generate_esn
    from speedyml_torch.reservoir.training import (drive_and_accumulate,
                                                   init_normal_eq)

    L, rcfg = build_layout(), ReservoirConfig()
    R, T = MD_TRAIN_REGIONS, MD_TRAIN_PAIRS
    params = generate_esn(SEED, R, L.n_in, L.n_out, L.n_out,
                          m_target=rcfg.nodes_per_input, deg=rcfg.degree,
                          device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    u, y, m = (torch.randn((T, R, k), device=dev, generator=g)
               for k in (L.n_in, L.n_out, L.n_out))
    series = series_sharding(mesh)
    sp = shard_params(params, mesh)
    acc = pres.init_normal_eq(sp, L.n_out, L.n_out, mesh)
    accum.accumulate_ss_scan.launches = 0
    t0 = time.perf_counter()
    acc = pres.drive_and_accumulate(sp, acc, shard(u, series),
                                    shard(y, series), shard(m, series),
                                    mesh, chunk=MD_TRAIN_CHUNK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = accum.accumulate_ss_scan.launches
    whole = [gather(getattr(acc, f), fold_sharding(mesh))
             for f in ("ss_hi", "ss_lo", "sy_hi", "sy_lo")]
    whole.append(gather(acc.x, state_sharding(mesh)))
    del acc
    same = None
    if mesh.coord("dp") == 0 and mesh.coord("tp") == 0:
        ref = drive_and_accumulate(params, init_normal_eq(params, L.n_out),
                                   u, y, m, chunk=MD_TRAIN_CHUNK)
        same = [bool(torch.equal(a, b)) for a, b in zip(whole, ref)]
        del ref
    del whole
    torch.cuda.empty_cache()
    return dict(launches=launches, seconds=seconds, same=same)


def md_rank(rank, world, device, bindir, more):
    """One rank of the multi-device phase: the composed step, dry and with
    full physics; with `more`, also the sharded training drive (dp=world;
    dp=world/2 with tp=2) and the dry run's six phases."""
    import torch
    from speedyml_torch.parallel.dryrun import dryrun_rank
    from speedyml_torch.parallel.mesh import Mesh, make_mesh

    t0 = time.perf_counter()
    sp, hm, x0, inputs = _md_setup(bindir, device)
    out = dict(setup_s=time.perf_counter() - t0)
    lat = Mesh((world,), ("lat",))
    for label, physics in (("dry", False), ("physics", True)):
        out[label] = _md_composed(sp, hm, x0, inputs, lat, physics)
        if rank:
            out[label].pop("out")
    del sp, hm, x0, inputs
    torch.cuda.empty_cache()
    if more:
        out["training"] = {
            f"dp={world // tp}, tp={tp}": _md_training(
                make_mesh(world, tp=tp), device) for tp in (1, 2)}
        t0 = time.perf_counter()
        out["dryrun"] = dryrun_rank(rank, world, device)
        out["dryrun_s"] = time.perf_counter() - t0
    return out


def phase_multi_device(bindir):
    """The multi-device layer on the one card: the composed hybrid step at
    reference width with 1 rank over NCCL and MD_WORLD ranks over gloo,
    every rank on cuda:0, each held against the single-device step there;
    with the MD_WORLD ranks also the sharded training drive (bitwise against
    the single-device fold) and the dry run's six phases. Returns the numbers, the kernel's launches in the
    sharded drives among them."""
    import torch
    from speedyml_torch.hybrid.forecast import SpeedyForecaster
    from speedyml_torch.parallel.composed import single_device_step
    from speedyml_torch.parallel.launch import run_ranks

    dev = torch.device("cuda")
    sp, hm, x0, inputs = _md_setup(bindir, dev)
    want = {}
    for label, physics in (("dry", False), ("physics", True)):
        fc = SpeedyForecaster(sp, hours=hm.rcfg.timestep, physics=physics)
        res = single_device_step(hm, fc, x0, *inputs, sp.surf, sp.forcing)
        if not bool(res[4]):
            raise AssertionError(f"multi-device: the single-device {label} "
                                 f"step tripped the safety gate")
        want[label] = [t.cpu() for t in res[:4]]
    del sp, hm, x0, inputs, res
    torch.cuda.empty_cache()

    out = {"card": CARD}
    names = ("x", "atmo", "logp", "precip_t")
    for world, backend in ((1, "nccl"), (MD_WORLD, "gloo")):
        t0 = time.perf_counter()
        ranks = run_ranks(md_rank, world, backend, ["cuda:0"] * world,
                          args=(bindir, world > 1))
        key = f"W={world} {backend}"
        label_w = ("1 rank" if world == 1
                   else f"{world} ranks sharing one card")
        res = dict(seconds=time.perf_counter() - t0,
                   setup_s=max(r["setup_s"] for r in ranks))
        for label in ("dry", "physics"):
            r0 = ranks[0][label]
            if not all(r[label]["safe"] for r in ranks):
                raise AssertionError(f"multi-device {key} {label}: the "
                                     f"safety gate tripped")
            errs = {}
            for name, got, ref in zip(names, r0["out"], want[label]):
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"multi-device {key} {label} "
                                         f"{name} is not finite")
                d = (got - ref).abs()
                scale = max(float(ref.abs().max()), 1e-30)
                errs[name] = dict(max=float(d.max()) / scale,
                                  rms=float(d.square().mean().sqrt())
                                  / scale)
                err = errs[name]["rms" if label == "physics" else "max"]
                bound = MD_PHYSICS_RMS if label == "physics" else MD_DRY_REL
                if not err <= bound:
                    raise AssertionError(
                        f"multi-device {key} {label} {name}: {err:.3e} of "
                        f"scale from the single-device step (bound "
                        f"{bound})")
            ms = [max(r[label]["ms"][i] for r in ranks)
                  for i in range(MD_STEPS)]
            res[label] = dict(ms=ms, comm=r0["comm"], err=errs)
            comm = ", ".join(f"{k} {v['calls']} ({v['bytes']} bytes, "
                             f"{v['ms']:.1f} ms inside the calls)"
                             for k, v in r0["comm"].items())
            print(f"multi-device, composed {label} step at reference width, "
                  f"{label_w} ({backend}): {statistics.median(ms):.1f} "
                  f"ms/step (steps {', '.join(f'{t:.1f}' for t in ms)}; "
                  f"the slowest rank's); collectives per step and rank: "
                  f"{comm}; against the single-device step, largest / rms "
                  f"of scale: " + ", ".join(
                      f"{n} {e['max']:.2e} / {e['rms']:.2e}"
                      for n, e in errs.items()) + f" [{CARD}]")
        if world > 1:
            res["training"] = {}
            for mesh_label in ranks[0]["training"]:
                per = [r["training"][mesh_label] for r in ranks]
                if per[0]["same"] is None or not all(per[0]["same"]):
                    raise AssertionError(
                        f"multi-device training {mesh_label}: gathered "
                        f"ss/sy/x differ from the single-device fold "
                        f"({per[0]['same']})")
                launches = [p["launches"] for p in per]
                if min(launches) < 1:
                    raise AssertionError(f"multi-device training "
                                         f"{mesh_label}: a rank never "
                                         f"launched the kernel")
                res["training"][mesh_label] = dict(
                    launches=launches,
                    seconds=max(p["seconds"] for p in per))
                print(f"multi-device, sharded training drive at reference "
                      f"width ({MD_TRAIN_REGIONS} regions, na=5896, "
                      f"{MD_TRAIN_PAIRS} pairs, chunk {MD_TRAIN_CHUNK}), "
                      f"{mesh_label}, {label_w} ({backend}): ss/sy/x "
                      f"bitwise the single-device fold; accumulate_ss_scan "
                      f"launches per rank {launches}; "
                      f"{res['training'][mesh_label]['seconds']:.2f} s "
                      f"[{CARD}]")
            dry = [r["dryrun"] for r in ranks]
            res["dryrun"] = dict(seconds=max(r["dryrun_s"] for r in ranks),
                                 phases=dry[0]["seconds"],
                                 ss=dry[0]["training"]["ss"],
                                 accum_launches=[
                                     d["training"]["accum_launches"]
                                     for d in dry],
                                 lat_physics=dry[0]["lat_physics"],
                                 composed=dry[0]["composed"])
            print(f"multi-device, dry run's six phases, {label_w} "
                  f"({backend}): held against the single-device functions "
                  f"in {res['dryrun']['seconds']:.1f} s; accumulate_ss_scan "
                  f"launches per rank {res['dryrun']['accum_launches']} "
                  f"[{CARD}]")
        print(f"multi-device {key}: {res['seconds']:.1f} s (model set-up "
              f"{res['setup_s']:.1f} s a rank); the communicator staged 0 "
              f"bytes (gloo and NCCL take the CUDA tensors themselves)")
        out[key] = res
    gloo = out[f"W={MD_WORLD} gloo"]
    out["launches"] = (sum(sum(t["launches"])
                           for t in gloo["training"].values())
                       + sum(gloo["dryrun"]["accum_launches"]))
    # the kernel against its plain version at what one rank folds: the
    # drive's share of the block, and the dry run's phase 1
    from speedyml_torch import ReservoirConfig
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.parallel import dryrun
    L, rcfg = build_layout(), ReservoirConfig()
    na = L.n_out + rcfg.nodes_per_input // L.n_in * L.n_in
    rf = MD_TRAIN_REGIONS // MD_WORLD
    out["at_multi_device_shape"] = dict(
        T=MD_TRAIN_PAIRS, R=rf, na=na, **phase_kernel(
            rf, MD_TRAIN_PAIRS, MD_TRAIN_CHUNK, na, True)[
                "accumulate_ss_scan"])
    R6, na6, _ = gloo["dryrun"]["ss"]
    out["at_dryrun_shape"] = dict(
        T=dryrun.TN, R=R6 // MD_WORLD, na=na6, **phase_kernel(
            R6 // MD_WORLD, dryrun.TN, dryrun.CHUNK, na6, True)[
                "accumulate_ss_scan"])
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
    from speedyml_torch.hybrid.experiment import region_block_for
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
        # the scripts, then the tools and the pipeline on their cache,
        # model, run and block files
        with tempfile.TemporaryDirectory() as work:
            scripts, n_scripts, n_scripts_single = counted(
                "scripts", phase_scripts, bindir, work)
            tools, n_tools, n_tools_single = counted(
                "tools", phase_tools, bindir, work)
            pipe, n_pipe, n_pipe_single = counted(
                "pipeline", phase_pipeline, bindir, work)
        options = timed("free model options", phase_free_options, bindir)
        torch.cuda.empty_cache()
    long_tr, n_long, n_long_single = counted(
        "long training", phase_long_training, region_block)
    # the ranks are processes of their own: each counts its own launches
    # from 0, and the phase returns their sum
    with tempfile.TemporaryDirectory() as bindir:
        write_synthetic_boundary(bindir, SEED)
        multi = timed("multi-device", phase_multi_device, bindir)
    n_multi = multi.pop("launches")
    # the paths give the kernel other series lengths than the one timed
    # above: hold it against the plain version at each of them too
    at_len = {}
    for T in sorted({DRY_PAIRS, full["pairs"]}):
        res = timed(f"kernel at T={T}", phase_kernel, region_block, T,
                    min(TRAIN_CHUNK, T), na, True)
        at_len[T] = dict(T=T, R=region_block, na=na,
                         **res["accumulate_ss_scan"])
    at_dry, at_full = at_len[DRY_PAIRS], at_len[full["pairs"]]
    # the pipeline trains at the scripts' train shape (checked there)
    at_scripts = scripts.pop("at_train_shape")
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
                          n_dry + n_full + n_ocean + n_pipe + n_scripts
                          + n_tools + n_long + n_multi,
                          launches_dry_path=n_dry,
                          launches_full_physics_path=n_full,
                          launches_ocean_training=n_ocean,
                          launches_pipeline=n_pipe,
                          launches_scripts=n_scripts,
                          launches_scripts_train=scripts["launches_train"],
                          launches_scripts_ocean=scripts["launches_ocean"],
                          launches_tools=n_tools,
                          launches_demo=tools["launches_demo"],
                          launches_long_training=n_long,
                          launches_multi_device=n_multi,
                          at_multi_device_shape=multi.pop(
                              "at_multi_device_shape"),
                          at_dryrun_shape=multi.pop("at_dryrun_shape"),
                          at_long_shape=long_tr,
                          at_dry_shape=at_dry,
                          at_full_physics_shape=at_full,
                          at_ocean_shape=coupled.pop("at_ocean_shape"),
                          at_pipeline_shape=at_scripts,
                          at_scripts_train_shape=at_scripts,
                          at_scripts_ocean_shape=scripts.pop(
                              "at_ocean_shape"),
                          **{k: tools.pop(k) for k in list(tools)
                             if k.startswith("at_")})],
        "off_path": [entry("accumulate_ss", "speedyml/ops/accum.py:51",
                           n_dry_single + n_full_single + n_pipe_single
                           + n_scripts_single + n_tools_single
                           + n_long_single)],
        "full_physics": full, "pipeline": pipe,
        "scripts": {k: v for k, v in scripts.items()
                    if not isinstance(v, dict)},
        "model_options": {k: v for k, v in options.items()
                          if not isinstance(v, dict)},
        "tools": tools,
        "multi_device": multi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
