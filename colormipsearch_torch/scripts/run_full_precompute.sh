#!/bin/bash
# Full NeuronBridge-style precompute driver of the PyTorch/CUDA port.
#
# Copy of scripts/run_full_precompute.sh (the reference's cluster scripts
# cdsparams.sh, submitCDSBatch.sh, submitCDSJob.sh, submitGAJob.sh): the
# same production arguments, the same restartable static grid blocks and
# the same CMS_GA_PROCS gradient processes over one SQLite store, run by
# `python -m colormipsearch_torch`. The device stages take
# `--device ${CMS_DEVICE:-cuda}`: every visible card, as the port's
# commands default to (CMS_DEVICE=cpu runs them on the CPU).
#
# Usage:
#   CMS_PROCESS_COUNT=<N> ./run_full_precompute.sh <workdir> [process_id]
# With no process_id, runs every block sequentially (single host).

set -euo pipefail

WORKDIR=${1:?usage: run_full_precompute.sh <workdir> [process_id]}
PROCESS_ID=${2:-}
PROCESS_COUNT=${CMS_PROCESS_COUNT:-1}
DEVICE=${CMS_DEVICE:-cuda}

MASKS=${CMS_MASKS:-$WORKDIR/masks.json}
TARGETS=${CMS_TARGETS:-$WORKDIR/targets.json}
DB=${CMS_DB:-$WORKDIR/nb.db}

# production CDS parameters (cdsparams.sh:42-47)
CDS_ARGS=(
  --maskThreshold 20 --dataThreshold 20
  --pixColorFluctuation 1 --xyShift 2 --mirrorMask
  --pctPositivePixels 1
  --processingPartitionSize "${CMS_PARTITION:-256}"
  --array-cache "$WORKDIR/array-cache"
  --db "$DB"
)

run_block() {
  local pid=$1
  echo "=== colorDepthSearch block $pid/$PROCESS_COUNT"
  python -m colormipsearch_torch colorDepthSearch \
    -m "$MASKS" -i "$TARGETS" "${CDS_ARGS[@]}" \
    --process-id "$pid" --process-count "$PROCESS_COUNT" \
    --processing-tag "cds-$(date +%Y%m%d)" --device "$DEVICE"
}

if [[ -n "$PROCESS_ID" ]]; then
  run_block "$PROCESS_ID"
  exit 0
fi

for ((pid = 0; pid < PROCESS_COUNT; pid++)); do
  run_block "$pid"
done

# gradient re-ranking: top 300 lines per mask (cdsparams.sh:50-63),
# sharded over CMS_GA_PROCS mask-mipId grid blocks exactly like the
# reference's GA job arrays (submitGAJob.sh:50-60). Blocks are
# deterministic and restartable; per-mask normalization is block-local
# by construction (each mask's matches live in one block).
GA_PROCS=${CMS_GA_PROCS:-$PROCESS_COUNT}
echo "=== gradientScores ($GA_PROCS blocks)"
pids=()
for ((gid = 0; gid < GA_PROCS; gid++)); do
  python -m colormipsearch_torch gradientScores --db "$DB" \
    --maskThreshold 20 --mirrorMask \
    --nBestLines "${CMS_TOP_LINES:-300}" \
    --array-cache "$WORKDIR/array-cache" \
    --process-id "$gid" --process-count "$GA_PROCS" \
    --computeZGapOnTheFly --device "$DEVICE" &
  pids+=($!)
done
# a failed gradient process fails the run
for p in "${pids[@]}"; do
  wait "$p"
done

echo "=== normalizeGradientScores"
python -m colormipsearch_torch normalizeGradientScores --db "$DB"

echo "=== exportData"
python -m colormipsearch_torch exportData \
  --exported-result-type EM_CD_MATCHES \
  --db "$DB" -od "$WORKDIR/export"
echo "done"
