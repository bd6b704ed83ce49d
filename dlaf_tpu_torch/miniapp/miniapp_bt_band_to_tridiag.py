"""Chase back-transform benchmark miniapp.

Port of ``dlaf_tpu/miniapp/miniapp_bt_band_to_tridiag.py:1-115`` (reference
``miniapp/miniapp_bt_band_to_tridiag.cpp``): times ``bt_band_to_tridiag``,
the chase's reflectors applied to a random eigenvector matrix (made from a
fixed seed, tiles of the band's size); the chase of ``make_band``'s random
band is untimed set-up. Flop model ``total_ops(2 n^2 m, 2 n^2 m)``; the
per-run line is

    [i] <t>s <gflops>GFlop/s <type> (n, m) band=<b> (P, Q) <threads> <backend>

then ``check: PASSED|FAILED residual=... tol=...``: ``|Q E - out| / |Q E|``
with Q formed by applying the reflectors to the identity, below ``100 n
eps`` (the reference's c = 100), on the device; a failed check exits 1.

Run:  python -m dlaf_tpu_torch.miniapp.miniapp_bt_band_to_tridiag -m 4096 -b 128 \\
          --check-result last
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import config, obs
from ..comm import multihost
from ..comm.sync import barrier
from ..common.index2d import TileElementSize
from ..eigensolver.back_transform import bt_band_to_tridiag
from ..eigensolver.band_to_tridiag import band_to_tridiag, share_tridiag
from ..matrix.matrix import Matrix
from ..types import dtype_name, total_ops, type_letter
from .checks import report
from .miniapp_band_to_tridiag import make_band
from .options import (CheckIterFreq, add_miniapp_arguments, is_printer, parse_miniapp_options,
                      root_verdict, select_grid)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--matrix-size", type=int, default=4096,
                   help="rows of the band matrix and of the eigenvector matrix")
    p.add_argument("-n", "--evec-cols", type=int, default=0,
                   help="eigenvector columns (default: the matrix size)")
    p.add_argument("-b", "--band-size", type=int, default=128)
    add_miniapp_arguments(p)
    return p


def run(argv=None) -> list[dict]:
    args, extra = build_parser().parse_known_args(argv)
    config.initialize(argv=extra)
    opts = parse_miniapp_options(args)
    grid, device = select_grid(opts, config.get_configuration().grid_ordering)
    use_grid = grid if grid.num_devices > 1 else None
    n, b = args.matrix_size, args.band_size
    m = args.evec_cols or n
    # untimed set-up; under torchrun rank (0, 0)'s process chases and the
    # others receive its result
    tri = share_tridiag(band_to_tridiag(make_band(n, b, opts.dtype), b)
                        if grid.is_local(0, 0) else None, grid)
    e0 = np.random.default_rng(1).standard_normal((n, m)).astype(opts.dtype)
    em = Matrix.from_global(e0, TileElementSize(b, b), use_grid, device=device)
    flops = total_ops(opts.dtype, 2.0 * n * n * m, 2.0 * n * n * m)
    results = []
    for run_i in range(-opts.nwarmups, opts.nruns):
        e_in = em.clone()
        barrier(e_in)
        # the run's fenced span: its record derives GFlop/s from the flop model
        with obs.span("miniapp_bt_band_to_tridiag.run", flops=flops, run=run_i, warmup=run_i < 0,
                      n=n, m=m, band=b, dtype=dtype_name(opts.dtype), grid=f"{opts.grid_rows}x{opts.grid_cols}", backend=device.type):
            t0 = time.perf_counter()
            out = bt_band_to_tridiag(tri, e_in)
            barrier(out)
            t = time.perf_counter() - t0
        if run_i < 0:
            continue
        gflops = flops / t / 1e9
        if is_printer():
            print(f"[{run_i}] {t:.6f}s {gflops:.2f}GFlop/s {type_letter(opts.dtype)} ({n}, {m}) "
                  f"band={b} ({opts.grid_rows}, {opts.grid_cols}) {os.cpu_count()} "
                  f"{device.type}", flush=True)
        results.append({"run": run_i, "time_s": t, "gflops": gflops})
        if opts.check is CheckIterFreq.ALL or (
                opts.check is CheckIterFreq.LAST and run_i == opts.nruns - 1):
            check(tri, em, out, grid)
    # land the counters and histograms in the artifact now, not at exit
    obs.flush()
    return results


def check(tri, em: Matrix, out: Matrix, grid=None) -> None:
    """``|Q E - out| / |Q E|`` below ``100 n eps``, Q formed on the device
    by applying the reflectors to the identity (in the multi-process form
    on rank (0, 0)'s process, where E and the result are gathered); exits
    1 (every process) when it fails."""
    n = tri.d.shape[0]
    e, got = em.gather_global(), out.gather_global()
    verdict = None
    if e is not None:
        q = bt_band_to_tridiag(tri, torch.eye(n, dtype=torch.float64, device=e.device))
        qe = q @ e.to(q.dtype)
        resid = float(torch.linalg.matrix_norm(got.to(q.dtype) - qe)
                      / max(float(torch.linalg.matrix_norm(qe)), 1e-30))
        verdict = report("miniapp_bt_band_to_tridiag", "bt_residual", resid, n=n,
                         nb=em.block_size.row, c=100.0, dtype=em.dtype, of=got)
    root_verdict(grid, verdict)


def main(argv=None) -> int:
    try:
        run(argv)
    finally:
        multihost.finalize_multihost()
    return 0


if __name__ == "__main__":
    main()
