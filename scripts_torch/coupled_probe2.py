"""Instrumented per-step coupled run: the port's counterpart of
scripts/coupled_probe2.py. At each step it prints per-section input deltas
+ window/readout output stats to pinpoint WHAT jumps at the first weekly
ocean feedback (step 28) despite |SST anomaly| <= 0.05 K.

Reads data/refscale.npz and data/refscale_weights.nc (relative to the
working directory), trains (or reads the blocks of) the JAX probe's ocean
in data/refscale.npz.ocean_ckpt. Everything runs on the card unless --cpu
is given; without a card and without --cpu the script stops.

Usage: python scripts_torch/coupled_probe2.py --bindir B [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
T0 = time.time()

CACHE = "data/refscale.npz"
WEIGHTS = "data/refscale_weights.nc"
# Test seams: the JAX probe's values, which only the CPU tests change to fit
# their small files. The samples held out at the end of the cache, the
# probe's steps, the ocean and its training blocks:
HOLDOUT = 124
N_STEPS = 32
OCEAN = dict(slab_nodes=500, slab_beta_res=3e-3, timestep_slab=168)
OCEAN_REGION_BLOCK = 64


def log(m):
    print(f"[{time.time()-T0:7.1f}s] {m}", flush=True)


def main(argv=None):
    """Runs the probe; returns the exit code (0; a failure raises)."""
    ap = argparse.ArgumentParser()
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
    from speedyml_torch.hybrid.experiment import (QMIN, HybridRunner,
                                                  atmo_to_grid,
                                                  transform_and_pack)
    from speedyml_torch.hybrid.forecast import SpeedyForecaster
    from speedyml_torch.io.weights import load_model
    from speedyml_torch.model import Speedy
    from speedyml_torch.reservoir.slab import (compose_week_inputs,
                                               train_ocean,
                                               weekly_ocean_inputs)

    dev = script_device(args.cpu)
    z = np.load(CACHE)
    n_train = z["atmo"].shape[0] - HOLDOUT
    sp = Speedy(ModelConfig(dtype="float32"), args.bindir, device=dev)
    radang_deg = np.degrees(np.asarray(sp.dy.tables.radang))
    hm = load_model(WEIGHTS, radang_deg=radang_deg, device=dev)
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
                        checkpoint_dir=CACHE + ".ocean_ckpt")
    ocean.anom_std = np.zeros((L.il, L.ix))      # gate -> 0.05 K floor
    spw = ocean.steps_per_week
    gv_w = weekly_ocean_inputs(to_host(gv_truth[:n_train]), spw, L)
    x_ocean = ocean.synchronize(gv_w)
    n_sync = hm.rcfg.synclength // hm.rcfg.timestep
    x = hm.synchronize(gv_truth[n_train - n_sync:n_train])
    s = L.gv_sizes
    last = gv_truth[n_train - 1]
    atmo = last[s["atmo3d"][0]:s["atmo3d"][1]].reshape(4, L.kx, L.il, L.ix)
    logp = last[s["logp"][0]:s["logp"][1]].reshape(L.il, L.ix)
    pr_t = last[s["precip"][0]:s["precip"][1]].reshape(L.il, L.ix)
    y, m, d, h = datetime_from_hours(int(z["hours"][n_train - 1]))
    date = ModelDate(y, m, d, h)
    log("synchronized")

    fc = SpeedyForecaster(sp, hours=6, physics=True)
    runner = HybridRunner(hm, fc)
    gv_sum, n_accum = None, 0
    sst_anom = None
    gv_prev = None

    def sec_stats(v, vp):
        out = {}
        for name, (a, b) in s.items():
            if b > a:
                out[name] = round(float(np.abs(v[a:b] - vp[a:b]).max()), 3)
        return out

    for i in range(N_STEPS):
        sst, tisr = runner._sst(date), runner._tisr(date)
        if sst_anom is not None:
            sst = np.clip(sst + sst_anom, 200.0, 306.0)
        gv = runner.pack(atmo, logp, pr_t, sst, tisr)
        gv_h = to_host(gv)
        if ocean is not None:
            gv_sum = gv if gv_sum is None else gv_sum + gv
            n_accum += 1
            if n_accum == spw:
                gv_week = compose_week_inputs(gv, gv_sum, spw, L)
                x_ocean, sst_core = ocean.step(x_ocean, gv_week)
                clim_sst = runner._sst(date)
                sst_core = to_host(sst_core)
                grid = ocean.compose_sst(sst_core, clim_sst, L)
                sst_anom = grid - clim_sst
                log(f"  OCEAN step at i={i}: |anom| max "
                    f"{np.abs(sst_anom).max():.4f}, sst_core range "
                    f"[{sst_core.min():.1f}, {sst_core.max():.1f}]")
                gv_sum, n_accum = None, 0
        gsx = atmo_to_grid(atmo, logp)
        res = fc.forecast(gsx, date, sst_hybrid=sst)
        f_atmo = torch.stack([res.gs.t, res.gs.u, res.gs.v,
                              torch.clamp(res.gs.q, min=QMIN)])
        f_pr = torch.log1p(torch.clamp(res.precip_mm, min=0.0) / runner.eps)
        model_gv = runner.pack(f_atmo, res.gs.logp, f_pr, sst, tisr)
        x, atmo, logp, pr_t = hm.step(x, gv, model_gv)
        date.advance_hours(hm.rcfg.timestep)
        a_h = to_host(atmo)
        wTmax = float(res.gs.t.max())
        msg = (f"i={i:2d} safe={bool(res.safe)} winTmax={wTmax:7.2f} "
               f"outTmax={a_h[0].max():7.2f} outTmin={a_h[0].min():7.2f} "
               f"qmax={a_h[3].max():6.2f}")
        # the deltas of the last seven steps (from step 25 of 32)
        if gv_prev is not None and i >= N_STEPS - 7:
            msg += f" dgv={sec_stats(gv_h, gv_prev)}"
        log(msg)
        gv_prev = gv_h
    print("PROBE2 DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
