"""End-to-end hybrid demo at T30L8: self-generated truth -> train ->
predict. The port's counterpart of scripts/demo_hybrid.py.

Small-scale settings (short training, minimal reservoirs: one node per
input, n=576) so it runs in minutes; the same code path scales to the
reference's settings (scripts_torch/reference_scale.py). Everything runs on
the card unless --cpu is given; without a card and without --cpu the script
stops. --bindir names the model's boundary files
(speedyml_torch.io.synthetic_boundary writes seeded stand-in files).

Usage: python scripts_torch/demo_hybrid.py --bindir B [--samples N]
           [--fc-steps N] [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# The slab ocean's reservoir: weekly cadence gives samples/28 points, so n
# stays modest for the demo's training lengths. A test seam: the JAX demo's
# value, which only the CPU tests change (to weeks their short cache holds).
OCEAN = dict(slab_nodes=500, timestep_slab=168)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bindir", required=True,
                    help="the directory of the model's boundary files "
                         "(fort.20-26)")
    ap.add_argument("--samples", type=int, default=48,
                    help="training samples (6-hourly)")
    ap.add_argument("--fc-steps", type=int, default=4)
    ap.add_argument("--spinup-days", type=int, default=5)
    ap.add_argument("--region-block", type=int, default=192)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--discard", type=int, default=24,
                    help="discard length in hours (reference: 240)")
    ap.add_argument("--prior", type=float, default=0.0)
    ap.add_argument("--beta-res", type=float, default=1e-3)
    ap.add_argument("--skip-ml-only", action="store_true")
    ap.add_argument("--ocean", action="store_true",
                    help="also train + couple the slab-ocean reservoir "
                         "(config 5)")
    ap.add_argument("--cache", default="",
                    help="npz path: reuse/generate truth + model forecasts")
    ap.add_argument("--components", default="",
                    help="path prefix: write v_ml/v_p contribution NetCDF "
                         "(PREFIX_ml.nc + PREFIX_p.nc)")
    ap.add_argument("--out", default="",
                    help="forecast NetCDF output path")
    ap.add_argument("--grads", default="",
                    help="base path: also write GrADS .grd/.ctl output")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    return ap.parse_args(argv)


def main(argv=None):
    """Runs the demo; returns the exit code (0; a failure raises)."""
    args = parse_args(argv)

    import torch
    from speedyml_torch.core.calendar import ModelDate, datetime_from_hours
    from speedyml_torch.core.config import ModelConfig, ReservoirConfig
    from speedyml_torch.coupler.daily import init_coupler_state
    from speedyml_torch.device import script_device, to_host
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.hybrid.experiment import (HybridRunner, TruthSeries,
                                                  atmo_to_grid,
                                                  collect_forecasts,
                                                  collect_truth, train_hybrid,
                                                  transform_and_pack)
    from speedyml_torch.hybrid.forecast import (SpeedyForecaster,
                                                TrajectoryRunner)
    from speedyml_torch.model import Speedy

    dev = script_device(args.cpu)
    t0 = time.time()
    cfg = ModelConfig(dtype=args.dtype)
    sp = Speedy(cfg, args.bindir, device=dev)
    print(f"[{time.time()-t0:6.1f}s] model built", flush=True)

    runner = TrajectoryRunner(sp)
    if args.cache and os.path.exists(args.cache):
        z = np.load(args.cache)

        def up(k):
            return torch.as_tensor(z[k], device=dev)

        truth = TruthSeries(atmo=up("atmo"), logp=up("logp"),
                            precip=up("precip"), sst=up("sst"),
                            tisr=up("tisr"), hours=z["hours"])
        m_atmo, m_logp, m_precip = up("m_atmo"), up("m_logp"), \
            up("m_precip")
        y, m, d, h = datetime_from_hours(int(truth.hours[-1]))
        runner.initialize(year=1982, month=1, spinup_days=0)
        runner.date = ModelDate(y, m, d, h)
        runner.cs = init_coupler_state(sp.clim, runner.date)
        runner.gs = atmo_to_grid(truth.atmo[-1].to(sp.dy.dtype),
                                 truth.logp[-1].to(sp.dy.dtype))
        print(f"[{time.time()-t0:6.1f}s] cache loaded: "
              f"{tuple(truth.atmo.shape)}", flush=True)
    else:
        runner.initialize(year=1982, month=1, spinup_days=args.spinup_days)
        print(f"[{time.time()-t0:6.1f}s] spin-up done", flush=True)

        truth = collect_truth(runner, args.samples)
        print(f"[{time.time()-t0:6.1f}s] truth collected: "
              f"{tuple(truth.atmo.shape)}", flush=True)

        # imperfect model: the DRY core (all physics off) — large, honest
        # model error for the reservoirs to correct
        fc_imperfect = SpeedyForecaster(sp, hours=6, physics=False)
        m_atmo, m_logp, m_precip = collect_forecasts(fc_imperfect, truth)
        print(f"[{time.time()-t0:6.1f}s] imperfect-model forecasts done",
              flush=True)
        if args.cache:
            np.savez(args.cache, atmo=to_host(truth.atmo),
                     logp=to_host(truth.logp), precip=to_host(truth.precip),
                     sst=to_host(truth.sst), tisr=to_host(truth.tisr),
                     hours=truth.hours, m_atmo=to_host(m_atmo),
                     m_logp=to_host(m_logp), m_precip=to_host(m_precip))

    rcfg = ReservoirConfig(nodes_per_input=576, degree=6, noise_std=0.05,
                           discardlength=args.discard, synclength=48,
                           prior_val=args.prior, beta_res=args.beta_res)
    radang_deg = np.degrees(np.asarray(sp.dy.tables.radang))
    L = build_layout(radang_deg=radang_deg)
    gv_truth = transform_and_pack(L, truth.atmo, truth.logp, truth.precip,
                                  truth.sst, truth.tisr, rcfg.precip_epsilon)
    gv_model = transform_and_pack(L, m_atmo, m_logp, m_precip,
                                  truth.sst, truth.tisr, rcfg.precip_epsilon)

    hm = train_hybrid(L, rcfg, gv_truth, gv_model, seed=0,
                      region_block=args.region_block)
    print(f"[{time.time()-t0:6.1f}s] hybrid training done "
          f"(wout {tuple(hm.params.wout.shape)})", flush=True)

    # sync on the last samples, forecast beyond the training set
    n_sync = rcfg.synclength // rcfg.timestep
    x = hm.synchronize(gv_truth[-n_sync:])
    s = L.gv_sizes
    last = gv_truth[-1]
    atmo0 = last[s["atmo3d"][0]:s["atmo3d"][1]].reshape(4, L.kx, L.il, L.ix)
    logp0 = last[s["logp"][0]:s["logp"][1]].reshape(L.il, L.ix)
    pr0 = last[s["precip"][0]:s["precip"][1]].reshape(L.il, L.ix)

    ocean = None
    x_ocean = None
    if args.ocean:
        from speedyml_torch.reservoir.slab import (train_ocean,
                                                   weekly_ocean_inputs)
        om_rcfg = ReservoirConfig(discardlength=args.discard, **OCEAN)
        ocean = train_ocean(L, om_rcfg, gv_truth, seed=100,
                            region_block=576)
        spw = ocean.steps_per_week
        gv_w = weekly_ocean_inputs(to_host(gv_truth), spw, L)
        x_ocean = ocean.synchronize(gv_w)
        print(f"[{time.time()-t0:6.1f}s] slab-ocean trained: "
              f"{int(ocean.active.sum())}/{ocean.ol.R} active regions",
              flush=True)

    fc_speedy = SpeedyForecaster(sp, hours=6, physics=True)
    hrun = HybridRunner(hm, fc_speedy)
    comp_writers = None
    writer = None
    coords = dict(sigma=np.asarray(sp.dy.vg.fsg), lat=radang_deg,
                  lon=np.arange(cfg.ix) * 360.0 / cfg.ix)
    if args.components:
        from speedyml_torch.io.output import ForecastWriter
        comp_writers = (
            ForecastWriter(args.components + "_ml.nc", cfg.kx, cfg.il,
                           cfg.ix, with_precip=False, **coords),
            ForecastWriter(args.components + "_p.nc", cfg.kx, cfg.il,
                           cfg.ix, with_precip=False, **coords))
    if args.out:
        from speedyml_torch.io.output import ForecastWriter
        writer = ForecastWriter(args.out, cfg.kx, cfg.il, cfg.ix,
                                with_sst=True, **coords)
    out = hrun.run(x, atmo0, logp0, pr0, runner.date, args.fc_steps,
                   ocean=ocean, x_ocean=x_ocean, writer=writer,
                   component_writers=comp_writers)
    if comp_writers is not None:
        for w in comp_writers:
            w.close()
        print(f"  components -> {args.components}_ml.nc/_p.nc")
    if writer is not None:
        writer.close()
    a = None if out["atmo"] is None else to_host(out["atmo"])
    if args.grads and a is not None:
        from speedyml_torch.io.grads import GradsWriter
        gw = GradsWriter(args.grads, radang_deg, np.asarray(sp.dy.vg.fsg),
                         cfg.ix)
        logp = to_host(out["logp"])
        for i in range(len(a)):
            gw.append([a[i][v] for v in range(4)], [logp[i]])
        gw.close()
        print(f"  GrADS -> {args.grads}.grd/.ctl")
    print(f"[{time.time()-t0:6.1f}s] hybrid forecast: aborted={out['aborted']}"
          f" steps={0 if a is None else len(a)}", flush=True)
    if a is None or not np.all(np.isfinite(a)):
        raise RuntimeError("non-finite or empty forecast")
    print("  T range:", a[:, 0].min(), a[:, 0].max())
    print("  u range:", a[:, 1].min(), a[:, 1].max())
    print("  q range:", a[:, 3].min(), a[:, 3].max())
    # persistence comparison over the forecast window: continue truth
    truth2 = to_host(collect_truth(runner, args.fc_steps).atmo)
    last_truth = to_host(truth.atmo[-1])
    rms_hyb = [float(np.sqrt(np.mean((a[i, 0] - truth2[i, 0]) ** 2)))
               for i in range(args.fc_steps)]
    rms_per = [float(np.sqrt(np.mean((last_truth[0] -
                                      truth2[i, 0]) ** 2)))
               for i in range(args.fc_steps)]
    print("  T RMS hybrid     :", [f"{r:.3f}" for r in rms_hyb[:10]])
    print("  T RMS persistence:", [f"{r:.3f}" for r in rms_per[:10]])
    if len(rms_hyb) > 10:
        print(f"  T RMS at step {len(rms_hyb)}: hybrid {rms_hyb[-1]:.3f} "
              f"persistence {rms_per[-1]:.3f}")
    if ocean is not None and out["sst"] is not None:
        sst_traj = to_host(out["sst"])
        print("  SST forecast range:", float(sst_traj.min()),
              float(sst_traj.max()),
              " drift vs start:", float(np.abs(sst_traj[-1] -
                                               sst_traj[0]).max()))

    # ml-only from the same start
    if args.skip_ml_only:
        print("DEMO OK")
        return 0
    hm_ml = train_hybrid(L, rcfg, gv_truth, None, seed=0,
                         region_block=args.region_block)
    x_ml = hm_ml.synchronize(gv_truth[-n_sync:])
    hrun_ml = HybridRunner(hm_ml, fc_speedy)
    out_ml = hrun_ml.run(x_ml, atmo0, logp0, pr0, out["date"], args.fc_steps)
    a_ml = None if out_ml["atmo"] is None else to_host(out_ml["atmo"])
    if a_ml is None or not np.all(np.isfinite(a_ml)):
        raise RuntimeError("non-finite or empty ML-only forecast")
    print(f"[{time.time()-t0:6.1f}s] ml-only forecast ok; "
          f"T range {a_ml[:, 0].min():.1f}..{a_ml[:, 0].max():.1f}",
          flush=True)
    print("DEMO OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
