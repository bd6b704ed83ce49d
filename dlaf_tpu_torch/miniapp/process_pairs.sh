#!/bin/bash
# A miniapp's distributed run by one controller and by one process per rank,
# alternating, on the cards of one machine.
#
#   bash dlaf_tpu_torch/miniapp/process_pairs.sh NPROC PAIRS MODULE [ARGS...]
#
# runs `python -m dlaf_tpu_torch.miniapp.MODULE ARGS` (one process driving
# every rank) and `torchrun --standalone --nproc-per-node NPROC -m ...
# ARGS` (one process per rank: NCCL with a card each, or gloo with
# --share-device), single controller first in even pairs and second in odd
# ones, and prints each run's lines prefixed by its form ("single" or
# "procs"): the miniapp's "[i] <t>s ..." and "check:" lines. Builds the
# kernels once first, so that the processes do not race to build them.
# Example, dist-L on four cards:
#
#   bash dlaf_tpu_torch/miniapp/process_pairs.sh 4 2 miniapp_cholesky \
#       -m 16384 -b 256 --grid-rows 2 --grid-cols 2 --type s --nruns 3 \
#       --check-result last
set -u
nproc=$1 pairs=$2 module=$3
shift 3
export PYTHONPATH=$PWD GLOO_SOCKET_IFNAME=${GLOO_SOCKET_IFNAME:-lo}

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null
python -c "
from dlaf_tpu_torch.tile_ops import cuda_build, givens_kernels, ozaki_kernels, panel_kernels, update_kernels
libs = [m.LIBRARY for m in (panel_kernels, ozaki_kernels, update_kernels, givens_kernels)]
cuda_build.build_all(libs)
print('kernels built')" 2>&1 | tail -1

single() {
  python -m "dlaf_tpu_torch.miniapp.$module" "$@" 2>/dev/null |
    grep -E '^(\[[0-9]+\] |check:)' | sed 's/^/single /'
}
procs() {
  timeout 900 python -m torch.distributed.run --standalone --nproc-per-node "$nproc" \
    -m "dlaf_tpu_torch.miniapp.$module" "$@" 2>/dev/null |
    grep -E '^(\[[0-9]+\] |check:)' | sed 's/^/procs /'
}
for ((i = 0; i < pairs; i++)); do
  if ((i % 2 == 0)); then single "$@"; procs "$@"; else procs "$@"; single "$@"; fi
done
