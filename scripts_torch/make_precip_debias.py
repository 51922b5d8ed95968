"""Build the output-side precip debias field (MOS climatology calibration):
the port's counterpart of scripts/make_precip_debias.py (host numpy, the same
arithmetic; scripts_torch/reference_scale.py coupled --precip-debias reads
the field it writes).

diag_precip_bias.py established that the trained readout is nearly
UNBIASED open-loop (+11% in mm), so the free-run's ~2x precip elevation is
a closed-loop effect: the small wet bias compounds through the
autoregressive precip input channel into a stable elevated operating point
(the 28-day series is flat — bounded by the cap and the reservoir
nonlinearity). The output precip is a pure DIAGNOSTIC variable
(mod_reservoir.f90 output var 5; it feeds back only through its own log
channel, which this correction does NOT touch), so the appropriate fix is
classic model-output-statistics: calibrate a per-gridpoint shift d >= 0 of
the log1p channel such that the corrected free-run MM climatology matches
the truth's MM climatology,

    mean_t expm1(max(c_run(t) - d, 0)) = mean_t expm1(c_truth(t)),

solved by bisection (the left side is monotone in d). Calibrated on the
FULL 1-year coupled run (complete seasonal cycle) against the truth
cache's full record; validated out-of-sample on the 98-day hybrid-only
rerun + the 10-year coupled run. Dynamics are bit-identical with or
without the correction (pinned by test).

Usage (host-only):
  python scripts_torch/make_precip_debias.py \
      --run data/coupled_run.nc --cache data/refscale.npz \
      --npz data/precip_bias.npz
"""

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    """Writes the debias field into --npz; returns the exit code (0)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="data/coupled_run.nc")
    ap.add_argument("--cache", default="data/refscale.npz")
    ap.add_argument("--skip", type=int, default=40,
                    help="run steps excluded (synchronization transient)")
    ap.add_argument("--eps", type=float, default=0.001)
    ap.add_argument("--npz", default="data/precip_bias.npz")
    ap.add_argument("--validate", nargs="*",
                    default=["data/hybrid98_run.nc", "data/coupled_run.nc"],
                    help="independent run NetCDFs scored with the "
                         "correction applied (host-side, exact output-path "
                         "arithmetic)")
    args = ap.parse_args(argv)

    from scipy.io import netcdf_file

    f = netcdf_file(args.run, "r", mmap=False)
    P = np.asarray(f.variables["p6hr"][:], np.float64)       # (T, il, ix) mm
    lat = np.asarray(f.variables["Lat"][:], np.float64)
    f.close()
    c_run = np.log1p(np.maximum(P[args.skip:], 0.0) / args.eps)

    z = np.load(args.cache, mmap_mode="r")
    truth_mm = np.zeros(P.shape[1:], np.float64)             # streamed mean
    Tt = z["precip"].shape[0]
    for a in range(0, Tt, 2048):
        truth_mm += np.asarray(z["precip"][a:a + 2048],
                               np.float64).sum(axis=0)
    truth_mm /= Tt

    # bisection for the per-gridpoint shift: F(d) = mean_t expm1(c-d) is
    # monotone decreasing in d; target = truth mm climatology. The shift is
    # ONE-SIDED (d >= 0): only the wet bias is corrected — a signed
    # mean-mapping was tried first and rejected, because negative shifts
    # turn dry-displacement cells into constant drizzle (rain every step)
    # and a correction calibrated on the annual run then inverts the
    # tropics/midlatitude contrast on other seasonal windows (measured:
    # tropics ratio 0.72 on the 98-day window).
    target = truth_mm / args.eps                             # expm1 units
    lo = np.zeros(P.shape[1:])
    hi = np.full(P.shape[1:], 12.0)
    for _ in range(45):
        mid = 0.5 * (lo + hi)
        val = np.expm1(np.maximum(c_run - mid, 0.0)).mean(axis=0)
        hi = np.where(val < target, mid, hi)
        lo = np.where(val < target, lo, mid)
    debias = np.maximum(0.5 * (lo + hi), 0.0)
    raw = np.expm1(c_run).mean(axis=0)
    debias[raw <= target] = 0.0              # already dry enough: hands off

    try:
        old = dict(np.load(args.npz))
    except Exception:
        old = {}
    old["debias"] = debias.astype(np.float64)
    np.savez(args.npz, **old)

    w = np.cos(np.radians(lat))
    w = w / w.mean()

    def wmean(x):
        return float((x * w[:, None]).mean())

    eps = args.eps
    run_mm = eps * raw * 4
    run_mm_corr = eps * np.expm1(
        np.maximum(c_run - debias, 0.0)).mean(axis=0) * 4
    out = {
        "n_steps_used": int(c_run.shape[0]),
        "debias_max": round(float(debias.max()), 3),
        "debias_globalavg": round(wmean(debias), 3),
        "run_mm_day": round(wmean(run_mm), 3),
        "run_mm_day_corrected": round(wmean(run_mm_corr), 3),
        "truth_clim_mm_day": round(wmean(truth_mm) * 4, 3),
    }

    # out-of-window validation (host): apply the field to independent runs
    # exactly as the output path would, score global mean + tropics ratio
    lt = np.abs(lat)
    trop = lt < 15.0
    midl = (lt > 20.0) & (lt < 50.0)
    for nc in args.validate:
        try:
            g = netcdf_file(nc, "r", mmap=False)
            Pv = np.asarray(g.variables["p6hr"][:], np.float64)
            g.close()
            cv = np.log1p(np.maximum(Pv[args.skip:], 0.0) / eps)
            mm = eps * np.expm1(np.maximum(cv - debias, 0.0)
                                ).mean(axis=0) * 4
            pz = (mm * w[:, None]).mean(axis=1)
            out[f"validate:{nc}"] = {
                "global_mm_day": round(wmean(mm), 3),
                "tropics_ratio": round(
                    float(pz[trop].mean() / max(pz[midl].mean(), 1e-9)), 3),
            }
        except Exception as e:
            out[f"validate:{nc}"] = repr(e)[:80]
    print(json.dumps(out, indent=1))
    print("PRECIP DEBIAS OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
