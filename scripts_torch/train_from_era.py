"""Train the hybrid model from ERA-schema files and (optionally) predict:
the port's counterpart of scripts/train_from_era.py, on the card (on the
CPU with --cpu).

The file-based production path (reference parallelmain.f90:85-139 training
branch): consumes era_5_y{YYYY}_*.nc truth + TISR companions + precomputed
SPEEDY one-window states (restart_6hour_y{YYYY}.nc), trains all regions'
readouts, persists weights, then optionally synchronizes and runs a
closed-loop forecast.

Usage:
  python scripts_torch/train_from_era.py --era-dir D --years 1990 1991 \
      --bindir B \
      [--model-dir D2] [--tisr-dir D3] [--out weights.nc] \
      [--nodes 6000] [--region-block 32] [--predict N --forecast-out f.nc]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    """Trains, writes what it is asked to, prints a summary; returns the
    exit code (0)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--era-dir", required=True)
    ap.add_argument("--years", type=int, nargs=2, required=True)
    ap.add_argument("--tisr-dir", default=None)
    ap.add_argument("--model-dir", default=None,
                    help="restart_6hour files; omit for ml_only training")
    ap.add_argument("--out", default="", help="weights NetCDF path")
    ap.add_argument("--nodes", type=int, default=6000,
                    help="reservoir size target m (mod_reservoir.f90:91)")
    ap.add_argument("--degree", type=int, default=6)
    ap.add_argument("--noise", type=float, default=0.2)
    ap.add_argument("--beta-res", type=float, default=1e-3)
    ap.add_argument("--beta-model", type=float, default=1.0)
    ap.add_argument("--prior", type=float, default=0.0)
    ap.add_argument("--discard", type=int, default=240)
    ap.add_argument("--sync", type=int, default=336)
    ap.add_argument("--region-block", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--predict", type=int, default=0,
                    help="forecast steps after training (hybrid when "
                         "--model-dir given)")
    ap.add_argument("--forecast-out", default="")
    ap.add_argument("--bindir", required=True,
                    help="the directory of the model's boundary files "
                         "(fort.20-25; stand-in files: "
                         "speedyml_torch.io.synthetic_boundary)")
    ap.add_argument("--cpu", action="store_true",
                    help="train and predict on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from speedyml_torch.core.config import ModelConfig, ReservoirConfig
    from speedyml_torch.device import script_device, to_host
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.hybrid.era_training import train_from_era
    from speedyml_torch.model import Speedy

    dev = script_device(args.cpu)
    t0 = time.time()
    cfg = ModelConfig(dtype=args.dtype)
    sp = Speedy(cfg, args.bindir, device=dev)
    slat, clat = sp.dy.tables.gsin, sp.dy.tables.gcos
    L = build_layout(radang_deg=np.degrees(np.asarray(sp.dy.tables.radang)))
    rcfg = ReservoirConfig(nodes_per_input=args.nodes, degree=args.degree,
                           noise_std=args.noise, beta_res=args.beta_res,
                           beta_model=args.beta_model, prior_val=args.prior,
                           discardlength=args.discard, synclength=args.sync)
    print(f"[{time.time()-t0:7.1f}s] layout R={L.R} n_in={L.n_in} "
          f"n_out={L.n_out}", flush=True)

    hm, data, gv_truth = train_from_era(
        L, rcfg, args.era_dir, args.years[0], args.years[1],
        tisr_dir=args.tisr_dir, model_dir=args.model_dir, seed=args.seed,
        region_block=args.region_block, chunk=args.chunk,
        slat=slat, clat=clat, device=dev)
    print(f"[{time.time()-t0:7.1f}s] trained: wout {hm.params.wout.shape} "
          f"n={hm.params.n} ml_only={hm.ml_only}", flush=True)

    if args.out:
        from speedyml_torch.io.weights import save_model
        save_model(args.out, hm)
        print(f"[{time.time()-t0:7.1f}s] weights -> {args.out}", flush=True)

    if args.predict > 0:
        from speedyml_torch.core.calendar import (ModelDate,
                                                  datetime_from_hours)
        from speedyml_torch.hybrid.experiment import HybridRunner
        from speedyml_torch.hybrid.forecast import SpeedyForecaster

        n_sync = max(1, rcfg.synclength // rcfg.timestep)
        x = hm.synchronize(gv_truth[-n_sync:])
        s = L.gv_sizes
        last = gv_truth[-1]
        atmo0 = last[s["atmo3d"][0]:s["atmo3d"][1]].reshape(
            4, L.kx, L.il, L.ix)
        logp0 = last[s["logp"][0]:s["logp"][1]].reshape(L.il, L.ix)
        pr0 = last[s["precip"][0]:s["precip"][1]].reshape(L.il, L.ix)
        y, m, d, h = datetime_from_hours(int(data.truth.hours[-1]))
        date = ModelDate(y, m, d, h)
        fc = None if hm.ml_only else SpeedyForecaster(sp, hours=6,
                                                      physics=True)
        runner = HybridRunner(hm, fc, clim=sp.clim, dy=sp.dy)
        writer = None
        if args.forecast_out:
            from speedyml_torch.io.output import ForecastWriter
            writer = ForecastWriter(args.forecast_out, L.kx, L.il, L.ix)
        out = runner.run(x, atmo0, logp0, pr0, date, args.predict,
                         writer=writer)
        if writer is not None:
            writer.close()
        a = None if out["atmo"] is None else to_host(out["atmo"])
        print(f"[{time.time()-t0:7.1f}s] forecast aborted={out['aborted']} "
              f"steps={0 if a is None else len(a)}", flush=True)
        if a is not None:
            print(f"  T range {a[:, 0].min():.1f}..{a[:, 0].max():.1f}  "
                  f"u max {np.abs(a[:, 1]).max():.1f}  "
                  f"q range {a[:, 3].min():.2f}..{a[:, 3].max():.2f}",
                  flush=True)
    print("TRAIN_FROM_ERA OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
