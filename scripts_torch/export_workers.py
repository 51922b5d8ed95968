"""Full-scale reference-schema worker-file export: the port's counterpart
of scripts/export_workers.py.

Exports all per-region worker files (write_trained_res schema,
src/mod_reservoir.f90:1703-1738 / mod_io.f90:2938-3036 layout) from a model
file, reads the whole set back through import_worker_files, verifies
round-trip equality, and records wall time and size.

The dense (n, n_in) win block the schema requires is ~26 MB f8 per file at
reference width (~39 GB for the full set): use --keep to retain everything;
the default deletes all but --keep-samples files after verification.

The model is read onto the card and the imported set built there, unless
--cpu is given; without a card and without --cpu the script stops.

Usage:
  python scripts_torch/export_workers.py --weights data/refscale_weights.nc
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    """Exports, verifies and records; returns the exit code (0; a failed
    verification raises)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default="data/refscale_weights.nc")
    ap.add_argument("--out", default="data/worker_files")
    ap.add_argument("--trial", default="refscale")
    ap.add_argument("--keep", action="store_true",
                    help="keep every exported file (needs ~39 GB)")
    ap.add_argument("--keep-samples", type=int, default=2)
    ap.add_argument("--verify-regions", type=int, nargs="*",
                    default=[0, 577, 1151])
    ap.add_argument("--results", default="data/worker_export.json")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from speedyml_torch.device import script_device, to_host
    from speedyml_torch.io.weights import (export_worker_files,
                                           import_worker_files, load_model)

    dev = script_device(args.cpu)
    t0 = time.time()
    hm = load_model(args.weights, device=dev)
    t_load = time.time() - t0
    L = hm.layout
    print(f"model loaded in {t_load:.0f}s: R={L.R}, "
          f"wout {tuple(hm.params.wout.shape)}", flush=True)

    t0 = time.time()
    export_worker_files(args.out, hm, trial_name=args.trial)
    t_export = time.time() - t0
    files = sorted(glob.glob(os.path.join(args.out, "worker_*.nc")))
    total_bytes = sum(os.path.getsize(f) for f in files)
    print(f"exported {len(files)} files, {total_bytes/1e9:.2f} GB "
          f"in {t_export:.0f}s", flush=True)

    # read the FULL set back through the reference-schema importer
    t0 = time.time()
    hm2 = import_worker_files(args.out, L, hm.rcfg, trial_name=args.trial,
                              device=dev)
    t_import = time.time() - t0
    p, p2 = hm.params, hm2.params
    np.testing.assert_allclose(to_host(p2.wout), to_host(p.wout), rtol=1e-6)
    np.testing.assert_allclose(to_host(p2.win), to_host(p.win), rtol=1e-6)
    np.testing.assert_array_equal(to_host(p2.a_idx), to_host(p.a_idx))
    assert p2.a_shift is not None, "circulant structure lost in round trip"
    print(f"full {L.R}-region round trip verified ({t_import:.0f}s)",
          flush=True)

    res = dict(files=len(files), total_gb=round(total_bytes / 1e9, 2),
               export_s=round(t_export, 1), import_sample_s=round(t_import, 1),
               per_file_mb=round(total_bytes / len(files) / 1e6, 2),
               verified_regions=args.verify_regions)
    if not args.keep:
        for f in files[args.keep_samples:]:
            os.unlink(f)
        res["kept_files"] = args.keep_samples
        print(f"cleaned up (kept {args.keep_samples} samples + controller)")
    with open(args.results, "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))
    print("EXPORT OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
