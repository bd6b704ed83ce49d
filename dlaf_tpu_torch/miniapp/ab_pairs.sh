#!/bin/bash
# Alternating A/B pairs of one miniapp between two checkouts of the repo.
#
#   bash dlaf_tpu_torch/miniapp/ab_pairs.sh DIR_A DIR_B PAIRS MODULE [ARGS...]
#
# runs `python -m dlaf_tpu_torch.miniapp.MODULE ARGS` from the root of
# DIR_A and of DIR_B (each imports the package found there), PAIRS times,
# A first in even pairs and B first in odd ones, and prints one line per
# process: the directory and its fastest timed run in seconds (the
# miniapp's "[i] <t>s ..." lines). Example, BASELINE config #4 on one card:
#
#   bash dlaf_tpu_torch/miniapp/ab_pairs.sh _chipcheck/parent . 10 \
#       miniapp_reduction_to_band -m 16384 -b 512 --band-size 128 \
#       --grid-rows 4 --grid-cols 4 --share-device --type d --nruns 3
set -u
a=$1 b=$2 pairs=$3 module=$4
shift 4

run() {
  local dir=$1 t
  shift
  t=$( (cd "$dir" && python -m "dlaf_tpu_torch.miniapp.$module" "$@") 2>&1 |
       grep -E '^\[[0-9]+\] ' | awk '{print $2}' | tr -d s | sort -g | head -1)
  echo "$dir ${t:-failed}"
}

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null
for ((i = 0; i < pairs; i++)); do
  if ((i % 2 == 0)); then run "$a" "$@"; run "$b" "$@"; else run "$b" "$@"; run "$a" "$@"; fi
done
