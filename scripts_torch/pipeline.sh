#!/bin/bash
# Reference-scale pipeline on one card: the port's counterpart of
# scripts/r5_pipeline.sh, the recipe that regenerates every results/
# artifact. The same phases in the same order, each skipped when its output
# exists, so a rerun after a failure costs only the failed phase (the data,
# train and coupled phases also resume from their own block and run
# checkpoints). A failed phase stops the pipeline with a nonzero exit code;
# nothing is retried.
#
#   BINDIR=/path/to/boundary/files bash scripts_torch/pipeline.sh \
#       > logs/pipeline.log 2>&1
#
# BINDIR names the model's boundary files (fort.20-26); seeded stand-in
# files come from speedyml_torch.io.synthetic_boundary.
set -u
cd "$(dirname "$0")/.."
: "${BINDIR:?set BINDIR to the directory of the boundary files}"
mkdir -p data logs results

log() { echo "[pipeline $(date +%H:%M:%S)] $*"; }

# phase <output-that-marks-done> <logfile> <ok-marker> cmd...
# Each run's output goes to its own temp file, and ONLY that file is
# searched for the marker (logs/ persists, so the accumulated log could hold
# a stale marker); the temp file is then appended to the phase log.
phase() {
    local done_file=$1 lf=$2 ok=$3; shift 3
    if [ -e "$done_file" ]; then log "skip (exists): $done_file"; return 0; fi
    local tmp
    tmp=$(mktemp)
    log "run: $* (-> $lf)"
    "$@" > "$tmp" 2>&1
    cat "$tmp" >> "$lf"
    if grep -q "$ok" "$tmp"; then rm -f "$tmp"; log "OK: $ok"; return 0; fi
    log "failed (no '$ok'); tail:"; tail -3 "$tmp"
    rm -f "$tmp"
    return 1
}

# ---- climatological-truth line (configs 1-4 + hybrid-only climate) ------
phase data/refscale.npz logs/data_phase.log "DATA PHASE OK" \
    python scripts_torch/reference_scale.py data --samples 16184 \
    --cache data/refscale.npz --bindir "$BINDIR" || exit 1

phase data/refscale_weights.nc logs/train_phase.log "TRAIN PHASE OK" \
    python scripts_torch/reference_scale.py train --cache data/refscale.npz \
    --bindir "$BINDIR" || exit 1

phase data/refscale.npz.ocean_ckpt/ocean_block_0000.npz \
    logs/ocean_train.log "OCEAN TRAIN OK" \
    python scripts_torch/reference_scale.py coupled --ocean-train-only \
    --ocean-m 500 --ocean-beta 3e-3 --bindir "$BINDIR" || exit 1

phase data/coupled_results.json logs/coupled.log "COUPLED PHASE OK" \
    python scripts_torch/reference_scale.py coupled --ocean-m 500 \
    --ocean-beta 3e-3 --fc-steps 1456 --bindir "$BINDIR" || exit 1
[ -e data/coupled_climate.json ] || python scripts_torch/score_run.py \
    --nc data/coupled_run.nc --out data/coupled_climate.json \
    >> logs/coupled.log 2>&1

phase data/refscale_ml_results.json logs/predict_ml.log \
    "PREDICT PHASE OK" \
    python scripts_torch/reference_scale.py predict --ml-only \
    --weights data/refscale_weights_ml.nc \
    --results data/refscale_ml_results.json --fast-loop \
    --bindir "$BINDIR" || exit 1

phase data/refscale_results.json logs/predict_hybrid.log \
    "PREDICT PHASE OK" \
    python scripts_torch/reference_scale.py predict \
    --results data/refscale_results.json --fast-loop \
    --bindir "$BINDIR" || exit 1

# config-3 climate free runs (90 d; 98 d = the hybrid98_* artifacts, 392
# steps, scored the same way)
phase data/hybrid90_results.json logs/hybrid90.log "COUPLED PHASE OK" \
    python scripts_torch/reference_scale.py coupled --hybrid-only \
    --fc-steps 360 --out data/hybrid90_run.nc \
    --results data/hybrid90_results.json --bindir "$BINDIR" || exit 1
[ -e data/hybrid90_climate.json ] || python scripts_torch/score_run.py \
    --nc data/hybrid90_run.nc --out data/hybrid90_climate.json \
    >> logs/hybrid90.log 2>&1
phase data/hybrid98_results.json logs/hybrid98.log "COUPLED PHASE OK" \
    python scripts_torch/reference_scale.py coupled --hybrid-only \
    --fc-steps 392 --out data/hybrid98_run.nc \
    --results data/hybrid98_results.json --bindir "$BINDIR" || exit 1
[ -e data/hybrid98_climate.json ] || python scripts_torch/score_run.py \
    --nc data/hybrid98_run.nc --out data/hybrid98_climate.json \
    >> logs/hybrid98.log 2>&1

# ---- precip MOS calibration (host) + decade run (streamed) --------------
phase data/precip_bias.npz logs/make_debias.log "PRECIP DEBIAS OK" \
    python scripts_torch/make_precip_debias.py || exit 1
phase data/coupled10y_results.json logs/coupled10y.log \
    "COUPLED PHASE OK" \
    python scripts_torch/reference_scale.py coupled --ocean-m 500 \
    --ocean-beta 3e-3 --fc-steps 14560 --out data/coupled10y_run.nc \
    --results data/coupled10y_results.json \
    --precip-debias data/precip_bias.npz --bindir "$BINDIR" || exit 1
[ -e data/coupled10y_climate.json ] || python scripts_torch/score_run.py \
    --nc data/coupled10y_run.nc --out data/coupled10y_climate.json \
    >> logs/coupled10y.log 2>&1
[ -e data/coupled10y_table.json ] || python scripts_torch/decade_table.py \
    --nc data/coupled10y_run.nc --out data/coupled10y_table.json \
    >> logs/coupled10y.log 2>&1

# ---- synthetic-ENSO line (coupled variability) ---------------------------
phase data/refscale_enso.npz logs/enso_data.log "DATA PHASE OK" \
    python scripts_torch/reference_scale.py data --samples 16184 \
    --cache data/refscale_enso.npz --enso-amp 1.2 \
    --bindir "$BINDIR" || exit 1

phase data/refscale_enso_weights.nc logs/enso_train.log \
    "TRAIN PHASE OK" \
    python scripts_torch/reference_scale.py train \
    --cache data/refscale_enso.npz --weights data/refscale_enso_weights.nc \
    --ml-weights data/refscale_enso_weights_ml.nc \
    --bindir "$BINDIR" || exit 1

phase data/refscale_enso.npz.ocean_ckpt/ocean_block_0000.npz \
    logs/enso_ocean.log "OCEAN TRAIN OK" \
    python scripts_torch/reference_scale.py coupled --ocean-train-only \
    --cache data/refscale_enso.npz --ocean-m 500 --ocean-beta 3e-3 \
    --bindir "$BINDIR" || exit 1

phase data/enso_results.json logs/enso_coupled.log "COUPLED PHASE OK" \
    python scripts_torch/reference_scale.py coupled \
    --cache data/refscale_enso.npz --weights data/refscale_enso_weights.nc \
    --ocean-m 500 --ocean-beta 3e-3 --fc-steps 2912 \
    --out data/enso_run.nc --results data/enso_results.json \
    --bindir "$BINDIR" || exit 1
[ -e data/enso_climate.json ] || python scripts_torch/score_run.py \
    --nc data/enso_run.nc --out data/enso_climate.json \
    >> logs/enso_coupled.log 2>&1
[ -e data/enso_eval.json ] || python scripts_torch/enso_eval.py \
    --nc data/enso_run.nc --cache data/refscale_enso.npz \
    --out data/enso_eval.json --bindir "$BINDIR" \
    >> logs/enso_coupled.log 2>&1

# evidence that survives data/ wipes: small JSONs -> results/
cp -f data/refscale_results.json data/refscale_ml_results.json \
      data/coupled_results.json data/coupled_climate.json \
      data/hybrid90_results.json data/hybrid90_climate.json \
      data/hybrid98_results.json data/hybrid98_climate.json \
      data/coupled10y_results.json data/coupled10y_climate.json \
      data/enso_results.json data/enso_climate.json data/enso_eval.json \
      results/ 2>/dev/null
log "PIPELINE DONE"
