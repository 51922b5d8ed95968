"""Per-year climate table for the decade-scale coupled run: the port's
counterpart of scripts/decade_table.py (host numpy, no device).

Streams the run NetCDF (never materializes the (T,8,48,96) stacks) and
emits, per 364-day year: lowest-level global T, global precip, NH/SH jet
speed/latitude, SST global mean + Nino-3.4 mean/std/range, plus
whole-run drift lines. Handles a resume leg (--nc accepts several files
concatenated in order).

Usage:
  python scripts_torch/decade_table.py --nc data/coupled10y_run.nc \
      --out data/coupled10y_table.json
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    """Prints (and with --out writes) the table; returns the exit code
    (0)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--nc", nargs="+", default=["data/coupled10y_run.nc"])
    ap.add_argument("--steps-per-year", type=int, default=1456)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from scipy.io import netcdf_file

    from speedyml_torch.utils.analysis import (box_mean, linear_trend,
                                         total_atmosphere_mass)
    from speedyml_torch.utils.climate import JET_LEVELS

    files = [netcdf_file(p, "r", mmap=True) for p in args.nc]
    lat = np.asarray(files[0].variables["Lat"][:], np.float64)
    lon = np.asarray(files[0].variables["Lon"][:], np.float64)
    w = np.cos(np.radians(lat))
    w = w / w.mean()
    lengths = [f.variables["Temperature"].shape[0] for f in files]
    n = sum(lengths)

    def var_at(name, i):
        for f, ln in zip(files, lengths):
            if i < ln:
                return np.asarray(f.variables[name][i], np.float64)
            i -= ln
        raise IndexError(i)

    spy = args.steps_per_year
    years = []
    nino_all = []
    t_low_all = []
    mass_all = []
    for y in range(n // spy + (1 if n % spy >= spy // 2 else 0)):
        i0, i1 = y * spy, min((y + 1) * spy, n)
        if i1 - i0 < spy // 2:
            break
        t_sum = None
        u_sum = None
        p_sum = 0.0
        s_sum = 0.0
        nino = []
        for i in range(i0, i1, 2):          # 12-hourly subsample
            t = var_at("Temperature", i)
            u = var_at("U-wind", i)
            p = var_at("p6hr", i)
            s = var_at("SST", i)
            lp = var_at("logp", i)
            t_sum = t if t_sum is None else t_sum + t
            u_sum = u if u_sum is None else u_sum + u
            p_sum = p_sum + p
            s_sum = s_sum + s
            nino.append(box_mean(s, lat, lon, (-5.0, 5.0), (190.0, 240.0)))
            t_low_all.append(float((t[-1] * w[:, None]).mean()))
            mass_all.append(float(total_atmosphere_mass(lp[None], lat)[0]))
        m = (i1 - i0 + 1) // 2
        t_mean = t_sum / m
        uz = (u_sum / m)[JET_LEVELS].mean(axis=(0, 2))
        nino = np.asarray(nino)
        nino_all.append(nino)

        def jet(mask):
            um = np.where(mask, uz, -np.inf)
            i = int(np.argmax(um))
            return round(float(uz[i]), 1), round(float(abs(lat[i])), 1)

        nh, nh_lat = jet(lat > 15.0)
        sh, sh_lat = jet(lat < -15.0)
        years.append({
            "year": y + 1,
            "t_low_K": round(float((t_mean[-1] * w[:, None]).mean()), 2),
            "precip_mm_day": round(float(((p_sum / m) * 4 * w[:, None])
                                         .mean()), 2),
            "sst_mean_K": round(float(((s_sum / m) * w[:, None]).mean()), 2),
            "jet_nh_ms_at": [nh, nh_lat], "jet_sh_ms_at": [sh, sh_lat],
            "nino34_mean_K": round(float(nino.mean()), 2),
            "nino34_std_K": round(float(nino.std()), 3),
            "nino34_range_K": [round(float(nino.min()), 2),
                               round(float(nino.max()), 2)],
        })

    t_low_all = np.asarray(t_low_all)
    h = np.arange(len(t_low_all)) * 12.0
    drift = float(np.polyfit(h, t_low_all, 1)[0] * 8760.0) \
        if len(t_low_all) > 10 else None
    # mass-conservation diagnostic (total_atmosphere_weight.py capability):
    # trend of area-weighted total mass across the whole run
    mass_all = np.asarray(mass_all)
    mass_drift = None
    if len(mass_all) > 10:
        slope, _ = linear_trend(mass_all, dt=12.0 / 8760.0)  # per year
        mass_drift = {
            "mean_kg_m2": round(float(mass_all.mean()), 1),
            "drift_kg_m2_per_year": round(float(slope), 3),
            "drift_pct_per_year": round(
                float(slope / mass_all.mean() * 100.0), 4),
        }
    nino_cat = np.concatenate(nino_all) if nino_all else np.empty(0)
    out = {
        "files": args.nc, "steps": int(n), "sim_years": round(n / spy, 2),
        "years": years,
        "t_low_drift_K_per_year": round(drift, 4) if drift else None,
        "atmosphere_mass": mass_drift,
        "t_low_year1_vs_last": [years[0]["t_low_K"], years[-1]["t_low_K"]]
        if years else None,
        "sst_year1_vs_last": [years[0]["sst_mean_K"],
                              years[-1]["sst_mean_K"]] if years else None,
        "nino34_whole_run": {
            "mean_K": round(float(nino_cat.mean()), 2),
            "std_K": round(float(nino_cat.std()), 3),
            "range_K": [round(float(nino_cat.min()), 2),
                        round(float(nino_cat.max()), 2)],
        } if len(nino_cat) else None,
    }
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print("DECADE TABLE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
