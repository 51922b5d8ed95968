"""Reference-scale hybrid run on one card: m=6000 (n=5760) reservoirs, 1152
regions, n_aug=5896 ridge per region, the production workload of the
reference (src/mod_reservoir.f90:91-93, src/parallelmain.f90:32). The port's
counterpart of scripts/reference_scale.py, over speedyml_torch.

Phases (separate invocations; each reads what the one before it wrote):

  data    - the truth trajectory (full-physics SPEEDY) and the imperfect
            one-window forecasts (dry core) through FusedDataGenerator,
            cached to npz (the JAX script's keys, shapes and dtypes). The
            last --holdout samples are verification-only.
  train   - all regions trained at the reference hyperparameters
            (beta_res=0.001, beta_model=1.0, prior=0.0, noise 0.20, discard
            240 h; mod_reservoir.f90:85-101), with the ML-only readout from
            the same normal equations (--also-ml) and block checkpoints;
            the weights are written as model files both packages read.
  predict - the weights read back, the reservoirs synchronized, a held-out
            hybrid prediction scored against persistence.
  coupled - the slab-ocean reservoirs trained on the cached series
            (--ocean-train-only trains them, writes their blocks and stops),
            then the trained atmosphere + ocean + SPEEDY closed loop with a
            forecast file and exact-resume checkpoints.

Everything runs on the card unless --cpu is given; without a card and
without --cpu the script stops. The ridge systems are solved in f64 on the
device in every phase, so the JAX script's float16 uploads (--upload-f16),
its emulated-f64 device solver and its separate x64 processes are not
ported. --region-block defaults to the block that the card's free memory
holds (hybrid.experiment.region_block_for), 8 on the CPU. --bindir names the
model's boundary files (speedyml_torch.io.synthetic_boundary writes seeded
stand-in files).

Usage:
  python scripts_torch/reference_scale.py data  --bindir B --cache C.npz
  python scripts_torch/reference_scale.py train --bindir B --cache C.npz
  python scripts_torch/reference_scale.py predict --bindir B --cache C.npz
  python scripts_torch/reference_scale.py coupled --bindir B --cache C.npz \
      --ocean-train-only
  python scripts_torch/reference_scale.py coupled --bindir B --cache C.npz
"""

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

T0 = time.time()


def log(msg):
    print(f"[{time.time()-T0:7.1f}s] {msg}", flush=True)


def peak_rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _model(args, dev):
    """The float32 full-physics model on `dev` and its latitudes [deg]."""
    from speedyml_torch.core.config import ModelConfig
    from speedyml_torch.model import Speedy
    sp = Speedy(ModelConfig(dtype="float32"), args.bindir, device=dev)
    return sp, np.degrees(np.asarray(sp.dy.tables.radang))


def _packed_truth(z, L, eps, dev, model=False):
    """The cached truth series (or, with model=True, the cached forecasts)
    packed to (T, gv_len) float32 on `dev`."""
    import torch
    from speedyml_torch.hybrid.experiment import transform_and_pack

    def up(k):
        return torch.as_tensor(z[k], device=dev)

    p = "m_" if model else ""
    return transform_and_pack(L, up(p + "atmo"), up(p + "logp"),
                              up(p + "precip"), up("sst"), up("tisr"), eps)


def _region_block(args, na, R, dev):
    """--region-block, or the block the card's free memory holds (8 on
    the CPU)."""
    import torch
    from speedyml_torch.hybrid.experiment import region_block_for
    if args.region_block is not None:
        return args.region_block
    if dev.type != "cuda":
        return 8
    return region_block_for(na, torch.cuda.mem_get_info(dev)[0], R,
                            chunk=args.chunk)


def phase_data(args, dev):
    """Fused day-batched generation: truth windows + dry-core forecasts."""
    from speedyml_torch.hybrid.forecast import FusedDataGenerator

    sp, radang_deg = _model(args, dev)
    cfg = sp.config
    log("model built")
    anom_fn = None
    if args.enso_amp > 0.0:
        # a deterministic ENSO-like SST anomaly on the truth boundary
        # (coupler.anomaly): the stand-in for the observed SST the
        # reference trains its ocean on
        from speedyml_torch.coupler.anomaly import SyntheticEnso
        enso = SyntheticEnso(
            radang_deg, np.arange(cfg.ix) * 360.0 / cfg.ix, sp.clim.fmask_s,
            seed=args.enso_seed, amp=args.enso_amp,
            period_days=args.enso_period_days)
        anom_fn = enso.sst_anom_fn
        log(f"ENSO forcing on: amp {args.enso_amp} K, period "
            f"{args.enso_period_days} d, seed {args.enso_seed}")
    gen = FusedDataGenerator(sp, sst_anom_fn=anom_fn)
    gen.initialize(year=args.year, month=1, spinup_days=args.spinup_days)
    log(f"spin-up done ({args.spinup_days} days)")

    res = gen.generate(args.samples, verbose=25, log=log)
    log(f"truth+forecasts collected: {res['atmo'].shape}")

    os.makedirs(os.path.dirname(args.cache) or ".", exist_ok=True)
    np.savez(args.cache, **res)
    log(f"cached -> {args.cache} "
        f"({os.path.getsize(args.cache)/1e9:.2f} GB); "
        f"peak rss {peak_rss_gb():.1f} GB")
    print("DATA PHASE OK")
    return {"samples": int(res["atmo"].shape[0])}


def phase_train(args, dev):
    from speedyml_torch.core.config import ReservoirConfig
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.hybrid.experiment import ml_variant, train_hybrid
    from speedyml_torch.io.weights import save_model

    timings = {}
    z = np.load(args.cache)
    n_total = z["atmo"].shape[0]
    n_train = n_total - args.holdout
    log(f"cache loaded: {n_total} samples, {n_train} train / "
        f"{args.holdout} held out")

    sp, radang_deg = _model(args, dev)
    # reference production hyperparameters (mod_reservoir.f90:85-101):
    # m=6000 -> n=5760, deg 6, sigma 0.5, leakage 1, beta_res 1e-3,
    # beta_model 1.0, prior 0, noise 0.20, discard 240 h
    rcfg = ReservoirConfig(nodes_per_input=args.m, prior_val=args.prior,
                           discardlength=args.discard)
    L = build_layout(radang_deg=radang_deg)
    n = max(1, round(args.m / L.n_in)) * L.n_in
    log(f"layout: R={L.R}, n_in={L.n_in}, n_out={L.n_out}, "
        f"n_aug={L.n_out + n}")

    gv_truth = _packed_truth(z, L, rcfg.precip_epsilon, dev)
    gv_model = None if args.ml_only else _packed_truth(
        z, L, rcfg.precip_epsilon, dev, model=True)
    if not args.predict_inline:              # inline scoring needs truth
        del z
    log(f"packed: gv {tuple(gv_truth.shape)}")

    rb = _region_block(args, L.n_out + n, L.R, dev)
    t = time.time()
    ckdir = (args.cache + (".ml_ckpt" if args.ml_only else ".train_ckpt")
             if args.train_ckpt else None)
    also_ml = args.also_ml and not args.ml_only
    hm = train_hybrid(L, rcfg, gv_truth[:n_train],
                      None if args.ml_only else gv_model[:n_train],
                      seed=0, region_block=rb, chunk=args.chunk,
                      verbose=True, checkpoint_dir=ckdir, also_ml=also_ml)
    timings["train_s"] = time.time() - t
    del gv_model
    wout = hm.params.wout
    log(f"TRAIN done in {timings['train_s']:.0f}s ({rb} regions a block): "
        f"wout {tuple(wout.shape)} "
        f"({wout.numel() * wout.element_size() / 1e9:.2f} GB), "
        f"peak rss {peak_rss_gb():.1f} GB")

    if args.weights:
        t = time.time()
        try:
            os.makedirs(os.path.dirname(args.weights) or ".", exist_ok=True)
            save_model(args.weights, hm)
            timings["persist_s"] = time.time() - t
            log(f"weights persisted -> {args.weights} "
                f"({os.path.getsize(args.weights)/1e9:.2f} GB, "
                f"{timings['persist_s']:.0f}s)")
        except Exception as e:       # never lose the run to a write failure
            log(f"WEIGHT PERSISTENCE FAILED ({e!r}); continuing")
        if also_ml:
            try:
                t = time.time()
                save_model(args.ml_weights, ml_variant(hm))
                timings["persist_ml_s"] = time.time() - t
                log(f"ml-only weights persisted -> {args.ml_weights} "
                    f"({os.path.getsize(args.ml_weights)/1e9:.2f} GB, "
                    f"{timings['persist_ml_s']:.0f}s)")
            except Exception as e:
                log(f"ML WEIGHT PERSISTENCE FAILED ({e!r}); continuing")

    out = {"train_s": timings["train_s"], "region_block": rb}
    if not args.predict_inline:
        log("training phase complete (run phase `predict` next)")
        print("TRAIN PHASE OK")
        return out
    out.update(_sync_predict_score(args, hm, sp, z, gv_truth, n_train,
                                   timings, rcfg))
    print("TRAIN PHASE OK")
    return out


def phase_predict(args, dev):
    """Sync + held-out prediction + skill from the written weights."""
    from speedyml_torch.io.weights import load_model

    z = np.load(args.cache)
    n_train = z["atmo"].shape[0] - args.holdout
    sp, radang_deg = _model(args, dev)
    t = time.time()
    hm = load_model(args.weights, radang_deg=radang_deg, device=dev)
    timings = {"load_s": time.time() - t}
    log(f"weights loaded: wout {tuple(hm.params.wout.shape)} "
        f"({timings['load_s']:.0f}s)")
    gv_truth = _packed_truth(z, hm.layout, hm.rcfg.precip_epsilon, dev)
    out = _sync_predict_score(args, hm, sp, z, gv_truth, n_train, timings,
                              hm.rcfg)
    print("PREDICT PHASE OK")
    return out


def _start(L, gv_truth, hours, n_train):
    """The closed loop's start: the last training sample's fields (atmo,
    logp, transformed precip) and its date."""
    from speedyml_torch.core.calendar import ModelDate, datetime_from_hours
    s = L.gv_sizes
    last = gv_truth[n_train - 1]
    atmo0 = last[s["atmo3d"][0]:s["atmo3d"][1]].reshape(4, L.kx, L.il, L.ix)
    logp0 = last[s["logp"][0]:s["logp"][1]].reshape(L.il, L.ix)
    pr0 = last[s["precip"][0]:s["precip"][1]].reshape(L.il, L.ix)
    y, m, d, h = datetime_from_hours(int(hours[n_train - 1]))
    return atmo0, logp0, pr0, ModelDate(y, m, d, h)


def _sync_predict_score(args, hm, sp, z, gv_truth, n_train, timings, rcfg):
    """Synchronize on the last synclength hours of the training window
    (mod_reservoir.f90:940-961), predict the held-out window, score it
    against persistence, write --results. Returns the scores and the
    runner's result (the trajectory as host numpy)."""
    from speedyml_torch.device import to_host
    from speedyml_torch.hybrid.experiment import HybridRunner
    from speedyml_torch.hybrid.forecast import SpeedyForecaster

    L = hm.layout
    n_sync = rcfg.synclength // rcfg.timestep
    t = time.time()
    x = hm.synchronize(gv_truth[n_train - n_sync:n_train])
    timings["sync_s"] = time.time() - t
    log(f"synchronized ({n_sync} steps, {timings['sync_s']:.0f}s)")

    atmo0, logp0, pr0, date0 = _start(L, gv_truth, z["hours"], n_train)
    n_fc = min(args.fc_steps, args.holdout)
    t = time.time()
    if args.fast_loop:
        from speedyml_torch.hybrid.fastloop import ScanHybridRunner
        chunk = n_fc if n_fc <= 32 else 31
        # sp is needed even for ml_only (climatology/solar boundary fields)
        hrun = ScanHybridRunner(hm, sp, chunk=chunk)
        n_fc = (n_fc // chunk) * chunk
        out = hrun.run(x, atmo0, logp0, pr0, date0, n_fc, verbose=chunk)
    else:
        fc_speedy = SpeedyForecaster(sp, hours=6, physics=True)
        hrun = HybridRunner(hm, fc_speedy)
        out = hrun.run(x, atmo0, logp0, pr0, date0, n_fc, verbose=10)
        out["atmo"] = None if out["atmo"] is None else to_host(out["atmo"])
    timings["predict_s"] = time.time() - t
    log(f"prediction: {n_fc} steps in {timings['predict_s']:.0f}s, "
        f"aborted={out['aborted']}")
    a = out["atmo"]
    if a is None or not np.all(np.isfinite(a)):
        raise RuntimeError("non-finite or empty forecast")

    # skill vs persistence on the held-out truth
    truth_atmo = z["atmo"]
    ver = truth_atmo[n_train:n_train + n_fc]
    per = truth_atmo[n_train - 1]
    lat = np.asarray(sp.dy.tables.radang)
    w = np.cos(lat)[None, :, None]
    w = w / w.mean()

    def wrms(x2):   # area-weighted RMS over (kx, il, ix)
        return float(np.sqrt(np.mean(x2 * w)))

    results = {"n_train": int(n_train), "n_fc": int(n_fc),
               "m": args.m, "n": hm.params.n,
               "n_aug": L.n_out + hm.params.n,
               "regions": int(L.R), "prior": args.prior,
               "ml_only": bool(args.ml_only),
               "timings_s": {k: round(v, 1) for k, v in timings.items()},
               "peak_rss_gb": round(peak_rss_gb(), 1), "leads": {}}
    steps_chk = sorted({1, 4, 20, 40, 80, n_fc} & set(range(1, n_fc + 1)))
    names = ["T", "u", "v", "q"]
    for step in steps_chk:
        i = step - 1
        lead_h = step * rcfg.timestep
        row = {}
        for v, nm in enumerate(names):
            rh = wrms((a[i, v] - ver[i, v]) ** 2)
            rp = wrms((per[v] - ver[i, v]) ** 2)
            row[nm] = {"hybrid": round(rh, 4), "persistence": round(rp, 4)}
        results["leads"][f"{lead_h}h"] = row
        log(f"lead {lead_h:5d}h: " + "  ".join(
            f"{nm} {row[nm]['hybrid']:.3f}/{row[nm]['persistence']:.3f}"
            for nm in names) + "  (hybrid/persistence RMS)")
    final = results["leads"][f"{n_fc * rcfg.timestep}h"]
    wins = sum(final[nm]["hybrid"] < final[nm]["persistence"] for nm in names)
    results["beats_persistence_at_final_lead"] = int(wins)
    with open(args.results, "w") as f:
        json.dump(results, f, indent=1)
    log(f"results -> {args.results}; hybrid beats persistence on "
        f"{wins}/4 variables at {n_fc * rcfg.timestep}h")
    return {"results": results, "run": out}


def phase_coupled(args, dev):
    """Trained atmosphere reservoirs + slab-ocean reservoir + SPEEDY, the SST
    fed back to both the reservoirs and SPEEDY's boundary
    (cpl_sea.f90:38-44), with incremental NetCDF output and periodic
    exact-resume checkpoints. --ocean-train-only trains the ocean, writes
    its blocks to the checkpoint directory and stops; the plain run then
    reads them back."""
    import torch
    from speedyml_torch.core.config import ReservoirConfig
    from speedyml_torch.device import to_host
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.hybrid.experiment import HybridRunner
    from speedyml_torch.hybrid.forecast import SpeedyForecaster
    from speedyml_torch.io.output import ForecastWriter
    from speedyml_torch.io.weights import load_model
    from speedyml_torch.reservoir.slab import (train_ocean,
                                               training_anomaly_std,
                                               weekly_ocean_inputs)

    z = np.load(args.cache)
    hours = z["hours"]
    n_train = z["atmo"].shape[0] - args.holdout
    sp, radang_deg = _model(args, dev)
    cfg = sp.config
    if args.ocean_train_only:
        # the atmosphere weights have no role in ocean training
        hm = None
        L = build_layout(radang_deg=radang_deg)
        rcfg = ReservoirConfig()
    else:
        hm = load_model(args.weights, radang_deg=radang_deg, device=dev)
        L = hm.layout
        rcfg = hm.rcfg
        log(f"weights loaded: wout {tuple(hm.params.wout.shape)}")
    gv_truth = _packed_truth(z, L, rcfg.precip_epsilon, dev)

    if args.hybrid_only:
        # climate mode: the trained hybrid atmosphere free-runs on
        # climatological SST (scored by score_run.py)
        ocean = None
    else:
        # slab-ocean reservoir trained on the same cached series
        orcfg = ReservoirConfig(slab_nodes=args.ocean_m,
                                slab_beta_res=args.ocean_beta,
                                discardlength=rcfg.discardlength,
                                timestep_slab=args.slab_hours)
        ocean = train_ocean(L, orcfg, gv_truth[:n_train], seed=100,
                            region_block=args.ocean_block,
                            checkpoint_dir=(args.cache + ".ocean_ckpt"
                                            if args.train_ckpt else None))
        # calibrate the pointwise anomaly gate: 3x max(open-loop residual,
        # training-distribution anomaly scale). The open-loop residuals
        # skip the first weeks as train_ocean's own discard does (8 weeks,
        # fewer on a short series, which would otherwise leave no
        # residual)
        tstd = training_anomaly_std(sp.clim, hours[:n_train],
                                    z["sst"][:n_train])
        weeks = n_train // ocean.steps_per_week
        _, ol_rms, p_rms = ocean.calibrate_gate(
            gv_truth[:n_train], L, discard=max(1, min(weeks // 4, 8)),
            train_anom_std=tstd)
        log(f"slab-ocean trained: {int(ocean.active.sum())}/{ocean.ol.R} "
            f"active; open-loop weekly SST RMS {ol_rms:.3f} K "
            f"(persistence {p_rms:.3f} K); gate = 3x max(residual, "
            f"train-anom) std (train-anom max "
            f"{float(np.nanmax(tstd)):.2f} K, gate max "
            f"{float(np.nanmax(ocean.anom_std)):.2f} K)")
        if args.ocean_train_only:
            log("ocean training blocks persisted; rerun without "
                "--ocean-train-only for the coupled run")
            print("OCEAN TRAIN OK")
            return {"ocean_active": int(ocean.active.sum()),
                    "open_loop_rms": ol_rms, "persistence_rms": p_rms}
    ckpt = args.out + ".ckpt.npz"
    resume = args.fast_loop and args.resume and os.path.exists(ckpt)
    if resume:
        x = x_ocean = None       # the checkpoint supplies the states
    else:
        if ocean is None:        # --hybrid-only: no interactive ocean
            x_ocean = None
        else:
            spw = ocean.steps_per_week
            gv_w = weekly_ocean_inputs(to_host(gv_truth[:n_train]), spw, L)
            x_ocean = ocean.synchronize(gv_w)
        n_sync = rcfg.synclength // rcfg.timestep
        x = hm.synchronize(gv_truth[n_train - n_sync:n_train])
    atmo0, logp0, pr0, date0 = _start(L, gv_truth, hours, n_train)

    t = time.time()
    deadline = time.time() + args.max_wall if args.max_wall else None
    nc_path = args.out if not resume else args.out + ".resume.nc"
    writer = ForecastWriter(nc_path, cfg.kx, cfg.il, cfg.ix,
                            sigma=np.asarray(sp.dy.vg.fsg), lat=radang_deg,
                            lon=np.arange(cfg.ix) * 360.0 / cfg.ix,
                            with_sst=True)
    # stream mode (bounded host memory): climate-length runs write every
    # step to the NetCDF and keep only running summary stats in RAM
    stream = (args.stream if args.stream is not None
              else args.fc_steps >= 1456)

    def _apply_debias(runner):
        if args.precip_debias:
            zb = np.load(args.precip_debias)
            if "debias" in zb:       # calibrated MOS field (signed)
                runner.precip_debias = np.asarray(zb["debias"], np.float64)
            else:                    # fallback: lognormal sigma^2/2
                runner.precip_debias = (
                    0.5 * np.asarray(zb["log_resid_std"], np.float64) ** 2)
            log(f"precip output debias on: range "
                f"[{float(runner.precip_debias.min()):.2f}, "
                f"{float(runner.precip_debias.max()):.2f}] "
                f"({args.precip_debias})")

    if args.fast_loop:
        from speedyml_torch.hybrid.fastloop import ScanHybridRunner
        hrun = ScanHybridRunner(hm, sp, physics=True)
        _apply_debias(hrun)
        if resume:
            from speedyml_torch.io.checkpoint import load_prediction
            st = load_prediction(ckpt)
            ex = st["extra"] or {}
            log(f"resuming from step {st['step']} (absolute)")
            out = hrun.run(torch.as_tensor(st["x"], device=dev), st["atmo"],
                           st["logp"], st["precip_t"], st["date"],
                           args.fc_steps - st["step"], ocean=ocean,
                           x_ocean=ex.get("x_ocean"),
                           sst_anom0=ex.get("sst_anom"), writer=writer,
                           checkpoint_path=ckpt, checkpoint_every=112,
                           verbose=112, deadline=deadline, stream=stream,
                           step0=st["step"])
        else:
            out = hrun.run(x, atmo0, logp0, pr0, date0, args.fc_steps,
                           ocean=ocean, x_ocean=x_ocean, writer=writer,
                           checkpoint_path=ckpt, checkpoint_every=112,
                           verbose=112, deadline=deadline, stream=stream)
    else:
        fc_speedy = SpeedyForecaster(sp, hours=6, physics=True)
        hrun = HybridRunner(hm, fc_speedy)
        _apply_debias(hrun)
        out = hrun.run(x, atmo0, logp0, pr0, date0, args.fc_steps,
                       ocean=ocean, x_ocean=x_ocean, writer=writer,
                       checkpoint_path=ckpt,
                       checkpoint_every=112, verbose=28, deadline=deadline)
        for k in ("atmo", "sst"):
            out[k] = None if out[k] is None else to_host(out[k])
    writer.close()
    dt = time.time() - t
    a = out["atmo"]
    nsteps = out.get("steps_done", 0 if a is None else len(a))
    log(f"coupled run: {nsteps}/{args.fc_steps} steps in {dt:.0f}s "
        f"({dt/max(nsteps,1):.2f}s/step), aborted={out['aborted']}")
    res = {"steps": int(nsteps), "sim_days": nsteps / 4,
           "wall_s": round(dt, 1), "aborted": bool(out["aborted"]),
           "loop": "fast" if args.fast_loop else "perstep",
           "resumed": bool(resume), "streamed": bool(stream),
           "precip_debias": bool(args.precip_debias),
           "s_per_step": round(dt / max(nsteps, 1), 3),
           "peak_rss_gb": round(peak_rss_gb(), 1)}
    if a is not None:
        if not np.all(np.isfinite(a)):
            raise RuntimeError("non-finite state")
        sstt = out["sst"]
        res.update(
            T_range=[float(a[:, 0].min()), float(a[:, 0].max())],
            u_range=[float(a[:, 1].min()), float(a[:, 1].max())],
            q_range=[float(a[:, 3].min()), float(a[:, 3].max())],
            sst_range=[float(sstt.min()), float(sstt.max())],
            sst_drift_K=float(np.abs(sstt[-1] - sstt[0]).max()))
    else:
        s = out.get("summary", {})
        if not (s and all(np.isfinite(v) for v in s.values()
                          if isinstance(v, float))):
            raise RuntimeError("non-finite state")
        res.update(
            T_range=[s.get("t_min"), s.get("t_max")],
            u_range=[s.get("u_min"), s.get("u_max")],
            q_range=[s.get("q_min"), s.get("q_max")],
            sst_range=[s.get("sst_min"), s.get("sst_max")],
            sst_drift_K=s.get("sst_drift_K"),
            sst_drift_mean_K=s.get("sst_drift_mean_K"))
    with open(args.results, "w") as f:
        json.dump(res, f, indent=1)
    log(f"results -> {args.results}: {res}")
    print("COUPLED PHASE OK")
    return res


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("phase", choices=["data", "train", "predict", "coupled"])
    ap.add_argument("--bindir", required=True,
                    help="the directory of the model's boundary files "
                         "(fort.20-25; stand-in files: "
                         "speedyml_torch.io.synthetic_boundary)")
    ap.add_argument("--cache", default="data/refscale.npz")
    ap.add_argument("--samples", type=int, default=2364,
                    help="total truth samples (train + holdout)")
    ap.add_argument("--holdout", type=int, default=124,
                    help="verification-only samples at the end (31 days)")
    ap.add_argument("--spinup-days", type=int, default=30)
    ap.add_argument("--year", type=int, default=1982)
    ap.add_argument("--m", type=int, default=6000,
                    help="target reservoir size (n rounded to mult of n_in)")
    ap.add_argument("--prior", type=float, default=0.0)
    ap.add_argument("--discard", type=int, default=240,
                    help="discard length in hours (reference: 240)")
    ap.add_argument("--ml-only", action="store_true",
                    help="train/predict the ML-only configuration "
                         "(ml_only=.True., mod_reservoir.f90:295-296)")
    ap.add_argument("--also-ml", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="train phase: additionally solve the ML-only "
                         "readout from the hybrid's normal equations (one "
                         "extra ridge factorization per block) and persist "
                         "it to --ml-weights")
    ap.add_argument("--ml-weights", default="data/refscale_weights_ml.nc")
    ap.add_argument("--predict-inline", action="store_true",
                    help="run the prediction inside the training process")
    ap.add_argument("--train-ckpt", action="store_true", default=True,
                    help="persist each trained region block; rerun resumes")
    ap.add_argument("--no-train-ckpt", dest="train_ckpt",
                    action="store_false")
    ap.add_argument("--region-block", type=int, default=None,
                    help="regions per training block (0 = all at once; "
                         "default: what the card's free memory holds, 8 on "
                         "the CPU)")
    ap.add_argument("--chunk", type=int, default=256,
                    help="timesteps per normal-equation fold")
    ap.add_argument("--fc-steps", type=int, default=124)
    ap.add_argument("--weights", default="data/refscale_weights.nc")
    ap.add_argument("--results", default="data/refscale_results.json")
    ap.add_argument("--ocean-m", type=int, default=2000,
                    help="slab-ocean reservoir target size (coupled phase); "
                         "size to the WEEKLY sample count")
    ap.add_argument("--ocean-beta", type=float, default=1e-4,
                    help="ocean ridge beta_res (reference 1e-4 at decades "
                         "of data; raise for short training records)")
    ap.add_argument("--slab-hours", type=int, default=168,
                    help="ocean reservoir cadence in hours (reference: 168)")
    ap.add_argument("--ocean-block", type=int, default=64,
                    help="regions per ocean training block")
    ap.add_argument("--hybrid-only", action="store_true",
                    help="coupled phase: free-run the trained hybrid on "
                         "climatological SST with NO interactive ocean")
    ap.add_argument("--ocean-train-only", action="store_true",
                    help="coupled phase: train and checkpoint the ocean "
                         "reservoir, then exit")
    ap.add_argument("--fast-loop", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="predict and coupled phases: the chunked "
                         "device-resident loop (hybrid.fastloop) instead "
                         "of the per-step runner")
    ap.add_argument("--resume", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="coupled phase: resume from the run checkpoint "
                         "when present")
    ap.add_argument("--precip-debias", default="",
                    help="coupled phase: npz with debias or log_resid_std; "
                         "applies the output-side precip debias to the "
                         "written precip (feedback dynamics untouched)")
    ap.add_argument("--stream", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="coupled phase: stream trajectory chunks to the "
                         "NetCDF and drop them (bounded host memory; "
                         "default: on for runs >= 1 year)")
    ap.add_argument("--max-wall", type=int, default=0,
                    help="coupled phase: stop the step loop cleanly after "
                         "this many seconds (0 = no limit)")
    ap.add_argument("--out", default="data/coupled_run.nc",
                    help="coupled-phase forecast NetCDF output")
    ap.add_argument("--enso-amp", type=float, default=0.0,
                    help="data phase: imposed ENSO-like SST anomaly "
                         "amplitude [K] (0 = off)")
    ap.add_argument("--enso-seed", type=int, default=7)
    ap.add_argument("--enso-period-days", type=float, default=480.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.phase == "coupled" and \
            args.results == "data/refscale_results.json":
        args.results = "data/coupled_results.json"   # don't clobber predict
    return args


PHASES = {"data": phase_data, "train": phase_train,
          "predict": phase_predict, "coupled": phase_coupled}


def main(argv=None):
    """Runs one phase; returns the exit code (0; a failure raises)."""
    from speedyml_torch.device import script_device
    args = parse_args(argv)
    PHASES[args.phase](args, script_device(args.cpu))
    return 0


if __name__ == "__main__":
    sys.exit(main())
