"""Climate-sanity validation run: score a >=90-day full-physics simulation
(and/or the cached truth trajectory) against the coarse climatology bands
in speedyml_torch.utils.climate. The port's counterpart of
scripts/climate_check.py: `run` integrates the port's `Speedy` on the card
(on the CPU with --cpu) over the boundary files of --bindir.

Modes:
  cache — score data/refscale.npz (multi-year truth trajectory: jets,
          tropical precip, temperature bands, drift; no TOA fluxes there).
  run   — fresh model, spin up, integrate --days days accumulating u/T/
          precip time means AND the TOA budget (tsr/olr from the daily
          flux accumulator), then score everything incl. TOA net.

Usage:
  python scripts_torch/climate_check.py cache
  python scripts_torch/climate_check.py run --days 120 --bindir DIR
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

T0 = time.time()


def log(m):
    print(f"[{time.time()-T0:6.1f}s] {m}", flush=True)


def _model_lat():
    """The model grid's Gaussian latitudes [deg], from the host tables the
    model is built on (no device, no boundary files)."""
    from speedyml_torch.core.config import ModelConfig
    from speedyml_torch.transforms.tables import build_tables
    cfg = ModelConfig()
    return np.degrees(np.asarray(
        build_tables(cfg.ntrun, cfg.ix, cfg.il).radang))


def score_cache(args):
    from speedyml_torch.utils.climate import climate_check, climate_scores

    z = np.load(args.cache)
    lat = _model_lat() if args.lat_from_model else _gauss_lat()
    atmo, precip, hours = z["atmo"], z["precip"], z["hours"]
    n = atmo.shape[0]
    i0 = min(args.skip, n // 4)
    w = np.cos(np.radians(lat))
    w = w / w.mean()
    t_low_series = (atmo[i0:, 0, -1] * w[None, :, None]).mean(axis=(1, 2))
    sc = climate_scores(
        lat,
        u_mean=atmo[i0:, 1].mean(axis=0),
        t_mean=atmo[i0:, 0].mean(axis=0),
        precip_mm_day=precip[i0:].mean(axis=0) * 4.0,   # mm/6h -> mm/day
        t_low_series=t_low_series, hours=hours[i0:])
    ok, failures = climate_check(sc)
    out = dict(mode="cache", samples=int(n - i0),
               sim_days=float((hours[-1] - hours[i0]) / 24.0),
               scores={k: round(v, 3) for k, v in sc.items()},
               ok=bool(ok), failures=failures)
    print(json.dumps(out, indent=1))
    return ok


def _gauss_lat():
    # fallback Gaussian latitudes for T30 (cache mode without model build)
    from numpy.polynomial.legendre import leggauss
    x, _ = leggauss(48)
    return np.degrees(np.arcsin(x))[::-1] * -1.0


def score_run(args):
    from speedyml_torch.core.config import ModelConfig
    from speedyml_torch.device import script_device, to_host
    from speedyml_torch.hybrid.state_io import extract
    from speedyml_torch.model import Speedy
    from speedyml_torch.utils.climate import climate_check, climate_scores

    sp = Speedy(ModelConfig(dtype="float32"), args.bindir,
                device=script_device(args.cpu))
    sp.initialize(year=args.year, month=1)
    log("model built")
    sp.run_days(args.spinup)
    log(f"spin-up {args.spinup} d done")

    lat = np.degrees(np.asarray(sp.dy.tables.radang))
    w = np.cos(np.radians(lat))
    w = w / w.mean()
    sum_u = sum_t = None
    sum_pr = 0.0
    sum_tsr = sum_olr = 0.0
    t_series, hours = [], []
    for d in range(args.days):
        acc = sp.run_day()
        gs = extract(sp.dy, sp.state, level=0)
        gs = gs._make(to_host(f) for f in gs)
        if sum_u is None:
            sum_u = np.zeros_like(gs.u)
            sum_t = np.zeros_like(gs.t)
        sum_u += gs.u
        sum_t += gs.t
        # precip daily mean is g/(m^2 s) = mm/1000s -> mm/day
        sum_pr = sum_pr + to_host(acc.precip) * 86.4
        sum_tsr += float((to_host(acc.tsr) * w[:, None]).mean())
        sum_olr += float((to_host(acc.olr) * w[:, None]).mean())
        t_series.append(float((gs.t[-1] * w[:, None]).mean()))
        hours.append(d * 24.0)
        if (d + 1) % 30 == 0:
            log(f"day {d+1}/{args.days}")
    n = args.days
    sc = climate_scores(lat, u_mean=sum_u / n, t_mean=sum_t / n,
                        precip_mm_day=sum_pr / n,
                        tsr=sum_tsr / n, olr=sum_olr / n,
                        t_low_series=np.asarray(t_series),
                        hours=np.asarray(hours))
    ok, failures = climate_check(sc)
    out = dict(mode="run", days=int(n), spinup=int(args.spinup),
               scores={k: round(v, 3) for k, v in sc.items()},
               ok=bool(ok), failures=failures)
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return ok


def main(argv=None):
    """Prints the scores and the verdict; returns the exit code: 0 when
    every score is inside its band, else 1."""
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["cache", "run"])
    ap.add_argument("--cache", default="data/refscale.npz")
    ap.add_argument("--skip", type=int, default=120,
                    help="cache samples to skip (spin-up tail)")
    ap.add_argument("--lat-from-model", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="read the Gaussian latitudes from a built model "
                         "(--no-lat-from-model uses the analytic fallback)")
    ap.add_argument("--days", type=int, default=120)
    ap.add_argument("--spinup", type=int, default=60)
    ap.add_argument("--year", type=int, default=1985)
    ap.add_argument("--out", default="data/climate_check.json")
    ap.add_argument("--bindir", default=None,
                    help="run mode: the directory of the model's boundary "
                         "files (fort.20-25; stand-in files: "
                         "speedyml_torch.io.synthetic_boundary)")
    ap.add_argument("--cpu", action="store_true",
                    help="run mode: integrate on the CPU (default: the "
                         "card)")
    args = ap.parse_args(argv)
    if args.mode == "run" and args.bindir is None:
        ap.error("run mode needs --bindir")
    ok = score_cache(args) if args.mode == "cache" else score_run(args)
    print("CLIMATE CHECK " + ("OK" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
