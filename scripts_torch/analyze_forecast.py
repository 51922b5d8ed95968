"""Analyze a forecast NetCDF produced by the prediction loop (the port's
counterpart of scripts/analyze_forecast.py; host numpy, no device).

Runnable counterpart of the reference's post-processing scripts
(scripts/hybrid_climo.py, scripts/enso_hybrid.py): prints per-lead RMS vs a
truth file, monthly climatology summaries, and (when SST is present) the
Niño-3.4 index — no plotting dependencies.

Usage:
  python scripts_torch/analyze_forecast.py PRED.nc [--truth TRUTH.nc]
      [--pressure 500 850] [--dt-hours 6] [--start-month 1]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from speedyml_torch.io.output import VAR3D, read_forecast   # noqa: E402
from speedyml_torch.utils import analysis as an             # noqa: E402


def _months_for(T, dt_hours, start_month):
    """Calendar month of each sample (365-day model year approximation)."""
    hours = np.arange(T) * dt_hours
    mlen = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])
    bounds = np.cumsum(np.concatenate([[0], np.tile(mlen, 200)])) * 24.0
    idx = np.searchsorted(bounds, hours, side="right") - 1
    return ((idx + (start_month - 1)) % 12) + 1


def main(argv=None):
    """Prints the analysis; returns the exit code (0)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("pred")
    ap.add_argument("--truth", default=None)
    ap.add_argument("--pressure", type=float, nargs="*", default=[500.0])
    ap.add_argument("--dt-hours", type=int, default=6)
    ap.add_argument("--start-month", type=int, default=1)
    args = ap.parse_args(argv)

    pred = read_forecast(args.pred)
    lat = pred.get("Lat")
    lon = pred.get("Lon")
    # older files wrote INDEX coordinates (0..il-1); substitute the physical
    # T30 Gaussian latitudes / uniform longitudes so area weights and the
    # Nino-3.4 box selection are correct
    if lat is not None and np.array_equal(lat, np.arange(len(lat))):
        from speedyml_torch.transforms.tables import build_tables
        il, ix = len(lat), len(lon)
        lat = np.degrees(np.asarray(
            build_tables(ntrun=il * 2 // 3 - 2, ix=ix, il=il).radang))
        lon = np.arange(ix) * 360.0 / ix
        print("(index coordinates in file; using T30 Gaussian lats)")
    T = pred[VAR3D[0]].shape[0]
    months = _months_for(T, args.dt_hours, args.start_month)
    print(f"forecast: {args.pred}  T={T} steps x {args.dt_hours} h")

    if args.truth:
        truth = read_forecast(args.truth)
        n = min(T, truth[VAR3D[0]].shape[0])
        leads = sorted({1, 2, 4, 8, n - 1} & set(range(n)))
        print("\nRMS vs truth (area-weighted, all levels):")
        print("lead_h  " + "  ".join(f"{v[:12]:>12s}" for v in VAR3D))
        for t in leads:
            row = [an.weighted_rms(truth[v][t], pred[v][t], lat)
                   for v in VAR3D]
            print(f"{t * args.dt_hours:6d}  "
                  + "  ".join(f"{r:12.4f}" for r in row))

    for p in args.pressure:
        tp = an.sigma_to_pressure(pred["Temperature"], pred["logp"],
                                  np.array([p]))[:, 0]
        print(f"\nT @ {p:.0f} hPa: mean {np.nanmean(tp):.2f} K, "
              f"std {np.nanstd(tp):.2f} K")

    clim = an.monthly_climatology(pred["Temperature"][:, -1], months)
    have = [m + 1 for m in range(12) if not np.isnan(clim[m]).all()]
    print(f"\nlowest-level T monthly climatology (months {have}):")
    for m in have:
        print(f"  month {m:2d}: {np.nanmean(clim[m - 1]):7.2f} K")

    # mass conservation + drift (total_atmosphere_weight.py /
    # non_stationary_trends.py capabilities)
    mass = an.total_atmosphere_mass(pred["logp"], lat)
    line = f"\ntotal atmosphere mass: mean {mass.mean():.1f} kg/m^2"
    if T > 10:
        slope, _ = an.linear_trend(mass, dt=args.dt_hours / 8760.0)
        line += (f", drift {slope:+.3f} kg/m^2/yr "
                 f"({slope / mass.mean() * 100:+.4f} %/yr)")
    print(line)

    if "SST" in pred:
        idx = an.nino34_index(pred["SST"], lat, lon, months)
        print(f"\nNino-3.4 index: mean {idx.mean():+.3f} K, "
              f"std {idx.std():.3f} K, extrema [{idx.min():+.2f}, "
              f"{idx.max():+.2f}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
