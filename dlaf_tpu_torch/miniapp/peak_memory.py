"""Run a miniapp, then print this process's peak device memory.

    python dlaf_tpu_torch/miniapp/peak_memory.py MODULE [ARGS...]
    torchrun --standalone --nproc-per-node 4 dlaf_tpu_torch/miniapp/peak_memory.py \\
        miniapp_gen_eigensolver -m 16384 -b 256 --grid-rows 2 --grid-cols 2 --type d

runs ``dlaf_tpu_torch.miniapp.MODULE`` with ARGS (its ``main``), then
prints, on every process, for the card it allocated most on,

    [peak] process <rank> <device>: max_memory_allocated <GiB> GiB, max_memory_reserved <GiB> GiB
    [peak] process <rank> host: max resident set <GiB> GiB
    [launches] process <rank> {kernel: launches, ...}

(the resident set's high-water mark of the whole process, the kernel's
``VmHWM``; the launches of every hand kernel whose module the run loaded,
since the process started).
It imports the package by absolute name and takes nothing else from it but
program telemetry's peak reader (the allocator's peak, whole across the
resets of ``DLAF_PROGRAM_TELEMETRY``; ``torch.cuda.max_memory_allocated``
in a checkout without it), so the same file measures another checkout of
the package put first on ``PYTHONPATH`` (an older tree beside this one, in
one call).
"""

from __future__ import annotations

import importlib
import os
import resource
import sys

#: The hand kernels' modules, whose ``LAUNCHES`` the run's line reports.
KERNEL_MODULES = tuple(f"dlaf_tpu_torch.tile_ops.{m}" for m in (
    "panel_kernels", "ozaki_kernels", "update_kernels", "givens_kernels"))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    mod = importlib.import_module(f"dlaf_tpu_torch.miniapp.{argv[0]}")
    mod.main(argv[1:])
    rank = int(os.environ.get("RANK", "0"))
    try:
        # whole across program telemetry's resets of the counter
        from dlaf_tpu_torch.obs.telemetry import max_memory_allocated as peak
    except ImportError:     # a checkout from before program telemetry
        peak = torch.cuda.max_memory_allocated
    if torch.cuda.is_available():
        # the card this process allocated most on (its rank's)
        dev = max(range(torch.cuda.device_count()), key=peak)
        print(f"[peak] process {rank} cuda:{dev}: max_memory_allocated "
              f"{peak(dev) / 2 ** 30:.3f} GiB, max_memory_reserved "
              f"{torch.cuda.max_memory_reserved(dev) / 2 ** 30:.3f} GiB", flush=True)
    else:
        print(f"[peak] process {rank} cpu: no device memory", flush=True)
    # ru_maxrss is in KiB on Linux
    print(f"[peak] process {rank} host: max resident set "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20:.3f} GiB", flush=True)
    counts = {k: v for name in KERNEL_MODULES if name in sys.modules
              for k, v in getattr(sys.modules[name], "LAUNCHES", {}).items()}
    print(f"[launches] process {rank} {counts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
