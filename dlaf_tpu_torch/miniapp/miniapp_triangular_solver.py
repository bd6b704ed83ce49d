"""Triangular-solve benchmark miniapp.

Port of ``dlaf_tpu/miniapp/miniapp_triangular_solver.py`` (reference
``miniapp/miniapp_triangular_solver.cpp``): fenced timing around each
solve ``op(A) X = B`` (``--side L``) or ``X op(A) = B`` (``R``), with
``A`` of order m (side L) or n (side R) and ``B`` m x n, the flop model
``trsm_flops`` (m^2 n / 2 multiplications and as many additions for side
L, m n^2 / 2 for R), and the same per-run line

    [i] <t>s <gflops>GFlop/s <type><side><uplo><op><diag> (m, n) (nb, nb) (P, Q) <threads> <backend>

then ``check: PASSED|FAILED residual=... tol=...``: the residual
``|op(T) X - B|_F / |B|_F`` is estimated on the device where the matrices
lie (:func:`..obs.accuracy.trsm_residual`: the seeded probe under
``DLAF_ACCURACY`` "0" and "1", exact under "full"), ``tol = 60 max(m, n)
eps``; a failed check exits 1. Under ``DLAF_ACCURACY`` "1" or "full" every
unchecked timed run emits its ``accuracy`` record too.

Under ``torchrun`` one process drives each rank of the grid
(:mod:`.options`): process 0 prints, and every process exits 1 when the
check fails.

Run:  python -m dlaf_tpu_torch.miniapp.miniapp_triangular_solver -m 8192 -n 8192 -b 256 \\
          --type d --grid-rows 2 --grid-cols 2 --share-device --check-result last
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .. import config, obs
from ..algorithms.triangular import triangular_solve
from ..comm import multihost
from ..comm.sync import barrier
from ..common.index2d import GlobalElementSize, TileElementSize
from ..matrix.matrix import Matrix
from ..obs import accuracy
from ..types import dtype_name, total_ops, type_letter
from .checks import report
from .options import (CheckIterFreq, add_miniapp_arguments, is_printer, parse_miniapp_options,
                      select_grid)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--m", type=int, default=4096, help="rows of B")
    p.add_argument("-n", "--n", type=int, default=512, help="cols of B")
    p.add_argument("-b", "--block-size", type=int, default=256)
    p.add_argument("--side", choices=["L", "R"], default="L")
    p.add_argument("--uplo", choices=["L", "U"], default="L")
    p.add_argument("--op", choices=["N", "T", "C"], default="N")
    p.add_argument("--diag", choices=["N", "U"], default="N")
    add_miniapp_arguments(p)
    return p


def trsm_flops(dtype, side: str, m: int, n: int) -> float:
    """m^2 n / 2 (side L) or m n^2 / 2 (side R) multiplications and as many
    additions (the reference's model)."""
    mul = m * m * n / 2 if side == "L" else m * n * n / 2
    return total_ops(dtype, mul, mul)


def run(argv=None) -> list[dict]:
    """Run the miniapp; returns one dict per timed run. ``--dlaf:<knob>=``
    arguments reach :mod:`dlaf_tpu_torch.config`."""
    args, extra = build_parser().parse_known_args(argv)
    config.initialize(argv=extra)
    opts = parse_miniapp_options(args)
    grid, device = select_grid(opts, config.get_configuration().grid_ordering)
    use_grid = grid if grid.num_devices > 1 else None
    m, n, nb = args.m, args.n, args.block_size
    adim = m if args.side == "L" else n

    def a_fn(i, j):   # well-conditioned triangles
        return 1.0 / (1.0 + (i - j).abs()) + 2.0 * adim * (i == j)

    def b_fn(i, j):
        return torch.cos(0.001 * (i + 1)) + torch.sin(0.002 * (j + 1))

    am = Matrix.from_element_fn(a_fn, GlobalElementSize(adim, adim), TileElementSize(nb, nb),
                                use_grid, dtype=opts.dtype, device=device)
    bm = Matrix.from_element_fn(b_fn, GlobalElementSize(m, n), TileElementSize(nb, nb),
                                use_grid, dtype=opts.dtype, device=device)
    flops = trsm_flops(opts.dtype, args.side, m, n)
    combo = f"{args.side}{args.uplo}{args.op}{args.diag}"
    results = []
    for run_i in range(-opts.nwarmups, opts.nruns):
        b_in = bm.clone()   # fresh copy per run, solved in place
        barrier(b_in)
        # the run's fenced span: its record derives GFlop/s from the flop model
        with obs.span("miniapp_triangular_solver.run", flops=flops, run=run_i, warmup=run_i < 0,
                      side=args.side, uplo=args.uplo, op=args.op, diag=args.diag, m=m, n=n, nb=nb,
                      dtype=dtype_name(opts.dtype), grid=f"{opts.grid_rows}x{opts.grid_cols}", backend=device.type):
            t0 = time.perf_counter()
            out = triangular_solve(args.side, args.uplo, args.op, args.diag, 1.0, am, b_in,
                                   donate_b=True)
            barrier(out)
            t = time.perf_counter() - t0
        if run_i < 0:
            continue
        gflops = flops / t / 1e9
        if is_printer():
            print(f"[{run_i}] {t:.6f}s {gflops:.2f}GFlop/s {type_letter(opts.dtype)}{combo} "
                  f"({m}, {n}) ({nb}, {nb}) ({opts.grid_rows}, {opts.grid_cols}) "
                  f"{os.cpu_count()} {device.type}", flush=True)
        results.append({"run": run_i, "time_s": t, "gflops": gflops})
        checked = opts.check is CheckIterFreq.ALL or (
            opts.check is CheckIterFreq.LAST and run_i == opts.nruns - 1)
        if checked:
            check(args, am, bm, out)
        elif accuracy.enabled():
            # outside the timed region; a checked run records through its check
            accuracy.emit("miniapp_triangular_solver", "trsm_residual",
                          accuracy.trsm_residual(args.side, args.uplo, args.op, args.diag, 1.0,
                                                 am, bm, out),
                          n=max(m, n), nb=nb, c=60.0, dtype=opts.dtype, of=out,
                          attrs={"side": args.side, "uplo": args.uplo, "op": args.op,
                                 "diag": args.diag, "run": run_i,
                                 "grid": f"{opts.grid_rows}x{opts.grid_cols}"})
    # land the counters and histograms in the artifact now, not at exit
    obs.flush()
    return results


def check(args, am: Matrix, bm: Matrix, out: Matrix) -> None:
    """Print the ``check:`` line (``|op(T) X - B|_F / |B|_F`` below ``60
    max(m, n) eps``, estimated where the matrices lie by
    :func:`..obs.accuracy.trsm_residual`); exit 1 when it fails (every
    process, in the multi-process form; process 0 prints)."""
    resid = accuracy.trsm_residual(args.side, args.uplo, args.op, args.diag, 1.0, am, bm, out)
    if not report("miniapp_triangular_solver", "trsm_residual", resid, n=max(args.m, args.n),
                  nb=args.block_size, c=60.0, dtype=am.dtype, of=out,
                  attrs={"side": args.side, "uplo": args.uplo, "op": args.op,
                         "diag": args.diag}, printer=is_printer()):
        sys.exit(1)


def main(argv=None) -> int:
    try:
        run(argv)
    finally:
        multihost.finalize_multihost()
    return 0


if __name__ == "__main__":
    main()
