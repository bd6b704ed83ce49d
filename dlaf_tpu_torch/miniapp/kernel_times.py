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
``torch.profiler`` (what the kernel itself costs), and ``by_kernel``, the
same split by CUDA kernel (the inverse apart from the strip product, say);
``batch_ms``, CUDA-event time over 50 back-to-back calls divided by 50 (the
card's rate when the host keeps up); ``single_ms``, the median of 25 single
calls timed with CUDA events, as ``chip_smoke.py`` times them (host work
included). Shapes: f32 panels d=256, strip m=16128 (also the strip and
slab products alone, through the panel library's C entries, at m=16128
beside the f32 ``torch.matmul`` of the same shapes, TF32 off, and at
m=1000); Ozaki slices s=8 of
(16128, 256) and (256, 256) float64 operands; the pair product and the
trailing update at the distributed Cholesky's first step on rank (0, 0) of a
2x2 grid (N=16384: 32 x 32 pairs of 256), the update in place on a strided
view of a shard, with the uplo 'L' panels and with the uplo 'U' ones (the
row panel a transposed view); the Givens undo at 8192 rotations on 16384
float64 columns, on a seeded list with the Toeplitz merge's structure
(disjoint neighbouring row pairs, last pair first). Each line of a kernel
with a single-call bound carries ``bound_ms`` (the larger of its bytes over
3.35 TB/s and its operations over 67 TFLOP/s float32 or 34 TFLOP/s
float64).

After the kernels it times the f32 paths ``chip_smoke.py`` drives through
``miniapp_cholesky.run`` (main-L, panel-U, scan-f32, dist-L, dist-U, with
the same arguments), one JSON line each with the best of three timed
factorizations, so that walls too compare in one call.
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
    from dlaf_tpu_torch.algorithms.dist_step import pair_modes
    from dlaf_tpu_torch.tile_ops import cuda_build as cb
    from dlaf_tpu_torch.tile_ops import ozaki as oz
    from dlaf_tpu_torch.tile_ops import ozaki_kernels as ok
    from dlaf_tpu_torch.tile_ops import panel_kernels as pk
    from dlaf_tpu_torch.tile_ops import update_kernels as uk

    from dlaf_tpu_torch.tile_ops import givens_kernels as gk

    torch.backends.cuda.matmul.allow_tf32 = False
    cb.build_all([pk.LIBRARY, ok.LIBRARY, uk.LIBRARY, gk.LIBRARY])
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
    fac = torch.linalg.cholesky(diag)
    g = np.arange(32) * 2
    mode = torch.tensor(pair_modes(g, g, 0, 64, "L", True), dtype=torch.int32, device=dev)
    mode_u = torch.tensor(pair_modes(g, g, 0, 64, "U", True), dtype=torch.int32, device=dev)
    block = randn(33, 33, d, d)[1:, 1:]
    vr, vc = randn(32, d, d), randn(32, d, d)
    vr_t = vr.mT.contiguous().mT      # as the uplo 'U' sweep passes its row panel
    pa = slices(randn(32 * d, d, dtype=torch.float64), -1).reshape(8, 32, d, d)
    pb = slices(randn(32 * d, d, dtype=torch.float64), -1).reshape(8, 32, d, d)
    # the strip and slab products: gemm_kernel before their redesign
    panel = ("potrf_kernel", "trinv_kernel", "gemm_kernel", "strip_kernel", "slab_kernel")
    lib, st = pk.LIBRARY.load(), cb.stream(diag)
    inv = torch.empty((d, d), dtype=torch.float32, device=dev)
    cb.check(lib.dlaf_trinv(0, fac.data_ptr(), d, 0, inv.data_ptr(), d, st), "trinv")
    prod, p32 = torch.empty((m, d), device=dev), randn(m, d)

    def strip_product(rows=m):
        cb.check(lib.dlaf_strip(0, strip.data_ptr(), d, inv.data_ptr(), 1, prod.data_ptr(), d,
                                None, 0, rows, d, st), "strip")

    def slab_product(rows=m):
        cb.check(lib.dlaf_slab(0, p32.data_ptr(), d, slab.data_ptr(), d, prod.data_ptr(), d,
                               rows, d, d, st), "slab")

    # the Toeplitz merge's rotations: rows (2k, 2k + 1), the last pair first
    n, nrot = 16384, 8192
    rng = np.random.default_rng(20261016)
    th = rng.uniform(0.0, 2.0 * np.pi, nrot)
    giv = np.column_stack([np.arange(n - 2, -1, -2), np.arange(n - 1, 0, -2), np.cos(th),
                           np.sin(th)])
    u = torch.randn(n, n, generator=gen, device=dev, dtype=torch.float64)
    bounds = {"strip_product": max((d * d + 2 * m * d) * 4 / 3.35e12, m * d * d / 67e12),
              "slab_product": max((m * d + 2 * m * d) * 4 / 3.35e12, 2 * m * d * d / 67e12),
              "givens_undo": max(2 * n * n * 8 / 3.35e12, 6 * nrot * n / 34e12)}
    # the copies the parent's update wrapper made of transposed panels count
    update = ("masked_update_kernel", "plan_kernel", "elementwise_kernel", "Memcpy")
    kernels = {
        "potrf": (lambda: pk.potrf("L", diag), ("potrf_kernel",)),
        "solve": (lambda: pk.panel_solve("R", "L", "C", "N", fac, strip), panel),
        "factor_solve": (lambda: pk.factor_solve("L", diag, strip), panel),
        "step": (lambda: pk.step("L", diag, strip, slab), panel),
        "ozaki_product": (lambda: ok.ozaki_product(ia, ib), ("slice_fold_kernel",)),
        "ozaki_masked_product": (lambda: ok.ozaki_masked_product(pa, pb, mode),
                                 ("slice_fold_kernel",)),
        "ozaki_syrk": (lambda: ok.ozaki_syrk(ia), ("slice_fold_kernel",)),
        "masked_trailing_update": (lambda: uk.masked_trailing_update(block, vr, vc, mode),
                                   update),
        "masked_trailing_update_U": (lambda: uk.masked_trailing_update(block, vr_t, vc, mode_u),
                                     update),
        "strip_product": (strip_product, panel),
        "slab_product": (slab_product, panel),
        # a late step's strip, as the main path's m shrinks
        "strip_product_m1000": (lambda: strip_product(1000), panel),
        "slab_product_m1000": (lambda: slab_product(1000), panel),
        # library yardsticks (every CUDA kernel of the call counts)
        "matmul_f32_strip": (lambda: strip @ inv.T, None),
        "matmul_f32_slab": (lambda: p32 @ p32[:d].T, None),
        "givens_undo": (lambda: gk.givens_undo(u, giv), ("givens_undo_kernel",)),
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
        by = {}
        for e in prof.events():
            hit = e.name[:48] if names is None else next((k for k in names if k in e.name), None)
            if e.device_type == torch.autograd.DeviceType.CUDA and hit:
                by[hit] = by.get(hit, 0.0) + e.time_range.elapsed_us() / 10 / 1e3
        line = {"label": args.label, "kernel": name, "device_ms": sum(by.values()),
                "by_kernel": by, "batch_ms": batch, "single_ms": single, "card": card}
        if name in bounds:
            line["bound_ms"] = bounds[name] * 1e3
        print(json.dumps(line), flush=True)
    walls(args.label, card)
    return 0


def walls(label: str, card: str) -> None:
    import contextlib
    import io

    from dlaf_tpu_torch.miniapp import miniapp_cholesky

    timed = ["--nruns", "3", "--nwarmups", "1"]
    share = ["--share-device", "--grid-rows", "2"]
    paths = {
        "main-L": ["-m", "16384", "--uplo", "L", "--dlaf:step-impl=fused",
                   "--dlaf:cholesky-lookahead=1"],
        "panel-U": ["-m", "8192", "--uplo", "U", "--dlaf:panel-impl=fused",
                    "--dlaf:step-impl=xla"],
        "scan-f32": ["-m", "8192", "--uplo", "L", "--dlaf:cholesky-trailing=scan",
                     "--dlaf:step-impl=fused", "--dlaf:cholesky-lookahead=1"],
        "dist-L": ["-m", "16384", "--uplo", "L", *share, "--grid-cols", "2",
                   "--dlaf:step-impl=fused"],
        "dist-U": ["-m", "8192", "--uplo", "U", *share, "--grid-cols", "4",
                   "--dlaf:panel-impl=fused", "--dlaf:step-impl=xla"],
    }
    for name, argv in paths.items():
        with contextlib.redirect_stdout(io.StringIO()):
            res = miniapp_cholesky.run(["-b", "256", "--type", "s", *argv, *timed])
        print(json.dumps({"label": label, "path": name,
                          "wall_s": min(r["time_s"] for r in res),
                          "walls_s": [r["time_s"] for r in res], "card": card}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
