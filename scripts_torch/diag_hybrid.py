"""Diagnostic: separate plumbing error from data starvation in the hybrid
fit. The port's counterpart of scripts/diag_hybrid.py.

Trains on synthetic SPEEDY truth, then reports:
  a) the imperfect (dry) model's own one-window error,
  b) in-sample teacher-forced readout error,
  c) out-of-sample teacher-forced readout error,
all in standardized units and in T[K] RMS, plus the same with prior_val=1.

Everything runs on the card unless --cpu is given; without a card and
without --cpu the script stops. --bindir names the model's boundary files.

Usage: python scripts_torch/diag_hybrid.py [samples] --bindir B [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# The reservoirs of the three fits. A test seam: the JAX script's value,
# which only the CPU tests change (to a narrower reservoir).
RESERVOIR = dict(nodes_per_input=576, degree=6, noise_std=0.05,
                 discardlength=24, synclength=48)


def main(argv=None):
    """Prints the errors; returns the exit code (0; a failure raises)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("samples", type=int, nargs="?", default=120)
    ap.add_argument("--bindir", required=True,
                    help="the directory of the model's boundary files "
                         "(fort.20-26)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from speedyml_torch.core.config import ModelConfig, ReservoirConfig
    from speedyml_torch.device import script_device, to_host
    from speedyml_torch.domain.decomposition import build_layout
    from speedyml_torch.hybrid.experiment import (collect_forecasts,
                                                  collect_truth, train_hybrid,
                                                  transform_and_pack)
    from speedyml_torch.hybrid.forecast import (SpeedyForecaster,
                                                TrajectoryRunner)
    from speedyml_torch.model import Speedy

    dev = script_device(args.cpu)
    samples = args.samples
    t0 = time.time()
    sp = Speedy(ModelConfig(dtype="float32"), args.bindir, device=dev)
    runner = TrajectoryRunner(sp)
    runner.initialize(year=1982, month=1, spinup_days=5)
    truth = collect_truth(runner, samples)
    fc = SpeedyForecaster(sp, hours=6, physics=False)
    m_atmo, m_logp, m_precip = collect_forecasts(fc, truth)
    print(f"[{time.time()-t0:.0f}s] data ready")

    # dry-model one-window error in T
    t_truth, t_model = to_host(truth.atmo[:, 0]), to_host(m_atmo[:, 0])
    terr = np.sqrt(np.mean((t_model[1:] - t_truth[1:]) ** 2))
    print(f"dry model 6h T RMS error: {terr:.3f} K")
    perr = np.sqrt(np.mean((t_truth[:-1] - t_truth[1:]) ** 2))
    print(f"persistence 6h T RMS    : {perr:.3f} K")

    L = build_layout(radang_deg=np.degrees(np.asarray(sp.dy.tables.radang)))
    for pv, br in ((0.0, 1e-3), (1.0, 1e-3), (1.0, 1.0)):
        rcfg = ReservoirConfig(prior_val=pv, beta_res=br, **RESERVOIR)
        gv_t = transform_and_pack(L, truth.atmo, truth.logp, truth.precip,
                                  truth.sst, truth.tisr, rcfg.precip_epsilon)
        gv_m = transform_and_pack(L, m_atmo, m_logp, m_precip,
                                  truth.sst, truth.tisr, rcfg.precip_epsilon)
        n_test = 16
        hm = train_hybrid(L, rcfg, gv_t[:-n_test], gv_m[:-n_test], seed=0,
                          region_block=192)
        print(f"[{time.time()-t0:.0f}s] trained prior={pv} beta_res={br}")

        # teacher-forced one-step errors, out of sample
        x = hm.synchronize(gv_t[-n_test - 10:-n_test])
        errs_T = []
        for k in range(n_test - 1):
            i = len(gv_t) - n_test + k
            x, atmo, logp, pr = hm.step(x, gv_t[i], gv_m[i + 1])
            true_T = t_truth[i + 1]
            errs_T.append(float(np.sqrt(np.mean(
                (to_host(atmo[0]) - true_T) ** 2))))
        print("  teacher-forced oos T RMS:",
              [f"{e:.3f}" for e in errs_T[:6]], "mean",
              f"{np.mean(errs_T):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
