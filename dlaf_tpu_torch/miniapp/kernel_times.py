#!/usr/bin/env python3
"""Time the port's hand-written kernels on one CUDA card at the main paths'
shapes, three ways, and print one JSON line per kernel.

Run the file from the root of a checkout (the ``dlaf_tpu_torch`` found in the
current directory is the one timed, and its kernels are built there):

    python3 dlaf_tpu_torch/miniapp/kernel_times.py --label change

To compare two commits on one card, unpack the other into a directory and
run this file from both roots in one command, in turns: ``(cd parent &&
python3 ../dlaf_tpu_torch/miniapp/kernel_times.py --label parent); python3
dlaf_tpu_torch/miniapp/kernel_times.py --label change`` and so on. Only
wrapper interfaces that every slice of the port keeps are called.

For each kernel: ``device_ms``, the hand kernels' device time per call from
``torch.profiler`` (what the kernel itself costs); ``batch_ms``, CUDA-event
time over 50 back-to-back calls divided by 50 (the card's rate when the host
keeps up); ``single_ms``, the median of 25 single calls timed with CUDA
events, as ``chip_smoke.py`` times them (host work included). Shapes: f32
panels d=256, strip m=16128; Ozaki slices s=8 of (16128, 256) and (256, 256)
float64 operands; the pair product at the distributed Cholesky's first step
on rank (0, 0) of a 2x2 grid (N=16384: 32 x 32 pairs of 256).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="this", help="name printed with every line")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())   # the checkout run from, not this file's
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device visible", file=sys.stderr)
        return 2
    from dlaf_tpu_torch.algorithms.cholesky import _pair_modes
    from dlaf_tpu_torch.tile_ops import cuda_build as cb
    from dlaf_tpu_torch.tile_ops import ozaki as oz
    from dlaf_tpu_torch.tile_ops import ozaki_kernels as ok
    from dlaf_tpu_torch.tile_ops import panel_kernels as pk

    cb.build_all([pk.LIBRARY, ok.LIBRARY])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261016)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    def slices(x, dim, s=8):
        return torch.stack(oz._peel_slices(oz._normalize(x, oz._scale(x, dim)), s))

    d, m = 256, 16128
    x = randn(d, d)
    diag = x @ x.T + d * torch.eye(d, device=dev)
    strip, slab = randn(m, d), randn(m, d)
    ia, ib = slices(randn(m, d, dtype=torch.float64), -1), slices(randn(d, d, dtype=torch.float64), -2)
    g = np.arange(32) * 2
    mode = torch.tensor(_pair_modes(g, g, 0, 64, "L", True), dtype=torch.int32, device=dev)
    pa = slices(randn(32 * d, d, dtype=torch.float64), -1).reshape(8, 32, d, d)
    pb = slices(randn(32 * d, d, dtype=torch.float64), -1).reshape(8, 32, d, d)
    panel = ("potrf_kernel", "trinv_kernel", "gemm_kernel")
    kernels = {
        "potrf": (lambda: pk.potrf("L", diag), ("potrf_kernel",)),
        "factor_solve": (lambda: pk.factor_solve("L", diag, strip), panel),
        "step": (lambda: pk.step("L", diag, strip, slab), panel),
        "ozaki_product": (lambda: ok.ozaki_product(ia, ib), ("slice_fold_kernel",)),
        "ozaki_masked_product": (lambda: ok.ozaki_masked_product(pa, pb, mode),
                                 ("slice_fold_kernel",)),
        "ozaki_syrk": (lambda: ok.ozaki_syrk(ia), ("slice_fold_kernel",)),
    }

    def events(fn, calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    for name, (fn, names) in kernels.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        single = statistics.median(events(fn, 1) for _ in range(25))
        batch = events(fn, 50)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(n in e.name for n in names))
        print(json.dumps({"label": args.label, "kernel": name, "device_ms": us / 10 / 1e3,
                          "batch_ms": batch, "single_ms": single, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
