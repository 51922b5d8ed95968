"""Open-loop vs closed-loop precip bias attribution: the port's counterpart
of scripts/diag_precip_bias.py.

diag_wetbias.py established that the free-running hybrid carries an
intrinsic ~2x precip overestimate vs its own training truth in BOTH the
coupled and hybrid-only configs. This script separates the remaining
mechanism candidates for the intrinsic bias:

  * OPEN-loop (teacher-forced) readout bias: run the trained readout over
    held-out truth inputs and compare predicted precip against truth in
    both the log1p channel and physical mm/day. If unbiased here, the
    closed-loop inflation comes from feedback distribution shift.
  * Jensen/lognormal inflation: the readout is (near-)unbiased in the
    LOG channel; inverting P = eps*expm1(c) turns symmetric log-residual
    noise of std sigma into a positive physical bias ~exp(sigma^2/2).
    The per-gridpoint log-residual std measured here quantifies exactly
    that factor.

Outputs data/precip_bias.npz (relative to the working directory:
per-gridpoint log-residual mean/std) and a JSON summary. Reference: precip
is output var 5 of the reservoir (mod_reservoir.f90, log(1+P/eps)
transform at mod_reservoir.f90:123-127). The teacher-forced steps run one
by one on the card (on the CPU with --cpu); without a card and without
--cpu the script stops.

Usage:
  python scripts_torch/diag_precip_bias.py --bindir B \
      --out data/precip_bias.json
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

T0 = time.time()


def log(msg):
    print(f"[{time.time()-T0:7.1f}s] {msg}", flush=True)


def open_loop_precip(hm, x, gvs, mgvs, cap):
    """The readout teacher-forced over a truth series: step t advances on
    truth gvs[t] with the model forecast mgvs[t] (valid one step later) and
    reads out the clamped log1p precip channel. Returns (T', il, ix) on the
    weights' device."""
    import torch
    from speedyml_torch.domain.decomposition import (gather_inputs,
                                                     gather_targets,
                                                     scatter_outputs)
    from speedyml_torch.domain.standardize import (standardize_in,
                                                   standardize_out,
                                                   unstandardize_out)
    from speedyml_torch.hybrid.experiment import clamp_precip_t
    from speedyml_torch.reservoir.esn import predict_step

    L, stz = hm.layout, hm.stz
    eps = hm.rcfg.precip_epsilon
    preds = []
    for gv, mgv in zip(gvs, mgvs):
        u = standardize_in(stz, gather_inputs(L, gv))
        mv = standardize_out(stz, gather_targets(L, mgv))
        x, out_std = predict_step(hm.params, x, u, mv)
        _, _, pr_t = scatter_outputs(L, unstandardize_out(stz, out_std))
        preds.append(clamp_precip_t(pr_t, eps, cap))
    return torch.stack(preds)


def main(argv=None):
    """Writes data/precip_bias.npz and --out; returns the exit code (0; a
    failure raises)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--bindir", required=True,
                    help="the directory of the model's boundary files "
                         "(fort.20-26)")
    ap.add_argument("--cache", default="data/refscale.npz")
    ap.add_argument("--weights", default="data/refscale_weights.nc")
    ap.add_argument("--n", type=int, default=2124,
                    help="trailing samples to evaluate (incl. holdout)")
    ap.add_argument("--holdout", type=int, default=124)
    ap.add_argument("--sync", type=int, default=56)
    ap.add_argument("--out", default="data/precip_bias.json")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    import torch
    from speedyml_torch.core.config import ModelConfig
    from speedyml_torch.device import script_device, to_host
    from speedyml_torch.hybrid.experiment import transform_and_pack
    from speedyml_torch.io.weights import load_model
    from speedyml_torch.model import Speedy

    dev = script_device(args.cpu)
    sp = Speedy(ModelConfig(dtype="float32"), args.bindir, device=dev)
    lat = np.degrees(np.asarray(sp.dy.tables.radang))
    hm = load_model(args.weights, radang_deg=lat, device=dev)
    L = hm.layout
    eps = hm.rcfg.precip_epsilon
    cap = getattr(hm.rcfg, "precip_cap_mm", 40.0)
    log(f"weights loaded: wout {tuple(hm.params.wout.shape)}")

    z = np.load(args.cache)
    Tt = z["atmo"].shape[0]
    sl = slice(Tt - args.n, Tt)

    def up(k):
        return torch.as_tensor(np.ascontiguousarray(z[k][sl]), device=dev)

    gv_t = transform_and_pack(L, up("atmo"), up("logp"), up("precip"),
                              up("sst"), up("tisr"), eps)
    gv_m = transform_and_pack(L, up("m_atmo"), up("m_logp"),
                              up("m_precip"), up("sst"), up("tisr"), eps)
    log(f"packed {tuple(gv_t.shape)}")

    s = L.gv_sizes
    p0, p1 = s["precip"]
    x = hm.synchronize(gv_t[:args.sync])
    # teacher-forced prediction at index t is valid at truth index t+1,
    # driven by the model forecast VALID at t+1 (m_* index convention)
    pr_pred = to_host(open_loop_precip(hm, x, gv_t[args.sync:-1],
                                       gv_m[args.sync + 1:], cap))
    log(f"open-loop readout done: {pr_pred.shape}")

    truth_log = to_host(gv_t[args.sync + 1:, p0:p1]).reshape(pr_pred.shape)
    resid = pr_pred - truth_log                         # log1p channel
    sig = resid.std(axis=0)
    mu = resid.mean(axis=0)

    w = np.cos(np.radians(lat))
    w = w / w.mean()

    def wmean(f):
        return float((f * w[:, None]).mean())

    p_pred_mm = eps * np.expm1(pr_pred) * 4.0           # mm/day
    p_true_mm = eps * np.expm1(truth_log) * 4.0
    ho = args.holdout
    out = {
        "n_eval": int(pr_pred.shape[0]), "holdout": ho,
        "open_loop": {
            "pred_mm_day": round(wmean(p_pred_mm.mean(axis=0)), 3),
            "truth_mm_day": round(wmean(p_true_mm.mean(axis=0)), 3),
            "pred_mm_day_holdout": round(
                wmean(p_pred_mm[-ho:].mean(axis=0)), 3),
            "truth_mm_day_holdout": round(
                wmean(p_true_mm[-ho:].mean(axis=0)), 3),
        },
        "log_channel": {
            "resid_mean_globalavg": round(wmean(mu), 4),
            "resid_std_globalavg": round(wmean(sig), 4),
            "resid_std_max": round(float(sig.max()), 3),
            "jensen_factor_globalavg": round(
                wmean(np.exp(0.5 * sig ** 2)), 3),
            "jensen_factor_tropics": round(float(np.exp(
                0.5 * sig[np.abs(lat) < 15.0] ** 2).mean()), 3),
        },
        "closed_loop_reference": {
            "hybrid98_mm_day": 6.701, "coupled_98d_mm_day": 7.199,
            "truth_clim_mm_day": 3.327,
            "note": "from diag_wetbias.json (matched windows)",
        },
    }
    np.savez("data/precip_bias.npz", log_resid_mean=mu, log_resid_std=sig,
             lat=lat)
    print(json.dumps(out, indent=1))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    log("PRECIP BIAS DIAG OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
