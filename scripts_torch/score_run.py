"""Score a hybrid/coupled run NetCDF (ForecastWriter schema) against the
climate bands + ocean indices: the port's counterpart of
scripts/score_run.py (host numpy, no device).

Produces: climate-band pass/fail (speedyml_torch.utils.climate, same bands the
truth-cache check uses), SST drift, Niño-3.4 index statistics, and physical
ranges — the coupled-run "Done" record.

Usage:
  python scripts_torch/score_run.py --nc data/coupled_run.nc --out data/coupled_climate.json
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    """Prints (and with --out writes) the scores; returns the exit code:
    0 when every score is inside its band, else 1."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--nc", default="data/coupled_run.nc")
    ap.add_argument("--out", default="")
    ap.add_argument("--skip-days", type=int, default=10,
                    help="initial days excluded from the climate means")
    ap.add_argument("--steps-per-day", type=int, default=4)
    args = ap.parse_args(argv)

    from scipy.io import netcdf_file
    from speedyml_torch.utils.climate import climate_check, climate_scores

    f = netcdf_file(args.nc, "r", mmap=True)
    lat = np.asarray(f.variables["Lat"][:], np.float64)
    lon = np.asarray(f.variables["Lon"][:], np.float64)
    T = f.variables["Temperature"]
    U = f.variables["U-wind"]
    P = f.variables["p6hr"]
    n = T.shape[0]
    spd = args.steps_per_day
    i0 = min(args.skip_days * spd, n // 4)

    # stream means over steps (the full (n,8,48,96) stack is ~1 GB/var)
    t_sum = np.zeros(T.shape[1:], np.float64)
    u_sum = np.zeros_like(t_sum)
    p_sum = 0.0
    w = np.cos(np.radians(lat))
    w = w / w.mean()
    t_low = np.empty(n - i0)
    for i in range(i0, n):
        t = np.asarray(T[i], np.float64)
        t_sum += t
        u_sum += np.asarray(U[i], np.float64)
        p_sum = p_sum + np.asarray(P[i], np.float64)
        t_low[i - i0] = (t[-1] * w[:, None]).mean()
    m = n - i0
    hours = np.arange(n) * (24.0 / spd)
    sc = climate_scores(lat, u_mean=u_sum / m, t_mean=t_sum / m,
                        precip_mm_day=p_sum / m * spd,
                        t_low_series=t_low, hours=hours[i0:])
    ok, failures = climate_check(sc)

    out = dict(nc=args.nc, steps=int(n), sim_days=n / spd,
               scores={k: round(float(v), 3) for k, v in sc.items()},
               ok=bool(ok), failures=failures)

    if "SST" in f.variables:
        from speedyml_torch.utils.analysis import box_mean
        S = f.variables["SST"]
        sst0 = np.asarray(S[0], np.float64)
        sst1 = np.asarray(S[n - 1], np.float64)
        nino = np.empty(n)
        for i in range(n):
            nino[i] = box_mean(np.asarray(S[i], np.float64), lat, lon,
                               (-5.0, 5.0), (190.0, 240.0))
        # variability after removing the (seasonal) 30-day running mean —
        # with a single run year a monthly self-climatology would absorb
        # the signal being measured
        win = min(30 * spd, max(n // 4, 1))
        kernel = np.ones(win) / win
        seasonal = np.convolve(np.pad(nino, win // 2, mode="edge"), kernel,
                               mode="valid")[:n]
        anom = nino - seasonal
        out["sst"] = dict(
            drift_K=round(float(np.abs(sst1 - sst0).max()), 3),
            drift_mean_K=round(float((sst1 - sst0).mean()), 3),
            nino34_mean_K=round(float(nino.mean()), 2),
            nino34_subseasonal_std_K=round(float(anom.std()), 3),
            nino34_range_K=[round(float(nino.min()), 2),
                            round(float(nino.max()), 2)])
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print("SCORE " + ("OK" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
