"""Coupled-instability probe: the port's counterpart of
scripts/coupled_probe.py. Isolates WHAT blows up at the first weekly ocean
feedback.

Runs, with one model load:
  A. uncoupled chunked loop, 3 weeks         (chunk-boundary control)
  B. coupled, gate scaled to ~0 (0.05 K)     (ocean branch, no real anomaly)
  C. coupled, calibrated gate                (the production config)
  D. per-step HybridRunner coupled, 32 steps (cross-check the loop impl)

The ocean is trained at the JAX probe's settings, its blocks kept in
CACHE.ocean_ckpt (so a run after `reference_scale.py coupled` with the same
ocean settings reuses them). Its gate skips min(8, weeks // 4) weeks of
open-loop residuals, as scripts_torch/reference_scale.py does (the same 8
at the reference's length; a short series keeps a residual). Everything
runs on the card unless --cpu is given; without a card and without --cpu
the script stops. Writes data/coupled_probe.json (relative to the working
directory).

Usage: python scripts_torch/coupled_probe.py --bindir B [--skip D]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
T0 = time.time()

# Test seams: the JAX probe's values, which only the CPU tests change to fit
# their small files. The ocean and its training blocks:
OCEAN = dict(slab_nodes=500, slab_beta_res=3e-3, timestep_slab=168)
OCEAN_REGION_BLOCK = 64
# the steps of the per-step run (D); the chunked runs (A-C) take three
# ocean weeks, in chunks of a week
PER_STEP_STEPS = 32


def log(m):
    print(f"[{time.time()-T0:7.1f}s] {m}", flush=True)


def tmax_series(atmo):
    """The largest temperature of every fourth step."""
    if atmo is None or len(atmo) == 0:
        return []
    return [round(float(atmo[i, 0].max()), 2)
            for i in range(0, len(atmo), 4)]


def main(argv=None):
    """Runs the probe; returns the exit code (0; a failure raises)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip", default="")
    ap.add_argument("--cache", default="data/refscale.npz")
    ap.add_argument("--weights", default="data/refscale_weights.nc")
    ap.add_argument("--holdout", type=int, default=124)
    ap.add_argument("--bindir", required=True,
                    help="the directory of the model's boundary files "
                         "(fort.20-26)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    import torch
    from speedyml_torch.core.calendar import ModelDate, datetime_from_hours
    from speedyml_torch.core.config import ModelConfig, ReservoirConfig
    from speedyml_torch.device import script_device, to_host
    from speedyml_torch.hybrid.experiment import (HybridRunner,
                                                  transform_and_pack)
    from speedyml_torch.hybrid.fastloop import ScanHybridRunner
    from speedyml_torch.hybrid.forecast import SpeedyForecaster
    from speedyml_torch.io.weights import load_model
    from speedyml_torch.model import Speedy
    from speedyml_torch.reservoir.slab import train_ocean, weekly_ocean_inputs

    dev = script_device(args.cpu)
    z = np.load(args.cache)
    hours = z["hours"]
    n_train = z["atmo"].shape[0] - args.holdout
    sp = Speedy(ModelConfig(dtype="float32"), args.bindir, device=dev)
    radang_deg = np.degrees(np.asarray(sp.dy.tables.radang))
    hm = load_model(args.weights, radang_deg=radang_deg, device=dev)
    L = hm.layout

    def up(k):
        return torch.as_tensor(z[k], device=dev)

    gv_truth = transform_and_pack(L, up("atmo"), up("logp"), up("precip"),
                                  up("sst"), up("tisr"),
                                  hm.rcfg.precip_epsilon)
    log("weights + gv ready")

    orcfg = ReservoirConfig(discardlength=hm.rcfg.discardlength, **OCEAN)
    ocean = train_ocean(L, orcfg, gv_truth[:n_train], seed=100,
                        region_block=OCEAN_REGION_BLOCK,
                        checkpoint_dir=args.cache + ".ocean_ckpt")
    weeks = n_train // ocean.steps_per_week
    _, ol_rms, p_rms = ocean.calibrate_gate(
        gv_truth[:n_train], L, discard=max(1, min(weeks // 4, 8)))
    gate_grid = np.array(ocean.anom_std)
    log(f"ocean ready (open-loop {ol_rms:.3f} K)")

    spw = ocean.steps_per_week
    gv_w = weekly_ocean_inputs(to_host(gv_truth[:n_train]), spw, L)
    x_ocean0 = ocean.synchronize(gv_w)
    n_sync = hm.rcfg.synclength // hm.rcfg.timestep
    x0 = hm.synchronize(gv_truth[n_train - n_sync:n_train])
    s = L.gv_sizes
    last = gv_truth[n_train - 1]
    atmo0 = last[s["atmo3d"][0]:s["atmo3d"][1]].reshape(4, L.kx, L.il, L.ix)
    logp0 = last[s["logp"][0]:s["logp"][1]].reshape(L.il, L.ix)
    pr0 = last[s["precip"][0]:s["precip"][1]].reshape(L.il, L.ix)
    y, m, d, h = datetime_from_hours(int(hours[n_train - 1]))
    log("synchronized")

    def record(label, out):
        atmo = out["atmo"]
        atmo = None if atmo is None else to_host(atmo)
        results[label] = dict(aborted=bool(out["aborted"]),
                              steps=0 if atmo is None else len(atmo),
                              tmax=tmax_series(atmo))
        log(f"{label}: {results[label]}")

    results = {}
    fast = ScanHybridRunner(hm, sp, physics=True, chunk=spw)
    n_chunked = 3 * spw

    # every run starts from the same states (x0.clone(): a run may update
    # its start in place)
    if "A" not in args.skip:
        record("A_uncoupled", fast.run(x0.clone(), atmo0, logp0, pr0,
                                       ModelDate(y, m, d, h),
                                       n_chunked))

    if "B" not in args.skip:
        ocean.anom_std = np.zeros_like(gate_grid)     # gate -> 0.05 K floor
        record("B_gate0", fast.run(x0.clone(), atmo0, logp0, pr0,
                                   ModelDate(y, m, d, h), n_chunked,
                                   ocean=ocean, x_ocean=x_ocean0.clone()))

    if "C" not in args.skip:
        ocean.anom_std = gate_grid
        record("C_gated", fast.run(x0.clone(), atmo0, logp0, pr0,
                                   ModelDate(y, m, d, h), n_chunked,
                                   ocean=ocean, x_ocean=x_ocean0.clone()))

    if "D" not in args.skip:
        ocean.anom_std = gate_grid
        fc = SpeedyForecaster(sp, hours=6, physics=True)
        hrun = HybridRunner(hm, fc)
        record("D_perstep", hrun.run(x0.clone(), atmo0, logp0, pr0,
                                     ModelDate(y, m, d, h), PER_STEP_STEPS,
                                     ocean=ocean,
                                     x_ocean=x_ocean0.clone()))

    with open("data/coupled_probe.json", "w") as fh:
        json.dump(results, fh, indent=1)
    print(json.dumps(results))
    print("PROBE DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
