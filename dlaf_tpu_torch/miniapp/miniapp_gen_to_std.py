"""HEGST (generalized-to-standard eigenproblem transform) benchmark miniapp.

Port of ``dlaf_tpu/miniapp/miniapp_gen_to_std.py`` (reference
``miniapp/miniapp_gen_to_std.cpp``): B is factored once
(``cholesky(..., donate=True)``), then each timed run transforms a fresh
copy of A (donated) with that factor, fenced; the flop model is the
reference's ``total_ops(n^3/2, n^3/2)`` whatever the route's actual work
(twosolve does about twice as much), and the per-run line is

    [i] <t>s <gflops>GFlop/s <type><uplo> (n, n) (nb, nb) (P, Q) <threads> <backend>

then ``check: PASSED|FAILED residual=... tol=...``: the exact residual
``|L C L^H - A|_F / |A|_F`` (uplo U: ``|U^H C U - A|_F / |A|_F``), A and C
Hermitian-expanded from their ``uplo`` triangles, computed on the
device, against ``tol = 100 n eps`` (the reference's c = 100); a failed
check exits 1. B is :func:`.generators.hpd_element_fn`; A is
:func:`.generators.herm_element_fn` (the reference takes B's function for
A too, which makes the standard matrix the identity).

BASELINE config #3: complex128, N=8192, nb=256, 2x2.

Under ``torchrun`` one process per rank (:mod:`.options`), process 0
printing the run lines and rank (0, 0)'s process the check.

Run:  python -m dlaf_tpu_torch.miniapp.miniapp_gen_to_std -m 8192 -b 256 --type z \\
          --grid-rows 2 --grid-cols 2 --share-device --check-result last
      torchrun --standalone --nproc-per-node 4 -m dlaf_tpu_torch.miniapp.miniapp_gen_to_std \\
          -m 8192 -b 256 --type z --grid-rows 2 --grid-cols 2 --share-device \\
          --check-result last
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import config, obs
from ..algorithms.cholesky import cholesky
from ..algorithms.gen_to_std import gen_to_std
from ..comm import multihost
from ..comm.sync import barrier
from ..common.index2d import GlobalElementSize, TileElementSize
from ..matrix.matrix import Matrix
from ..tile_ops.blas import hermitian_from, tri_mask
from ..types import dtype_name, total_ops, type_letter
from .generators import herm_element_fn, hpd_element_fn
from .options import (CheckIterFreq, add_miniapp_arguments, is_printer, parse_miniapp_options,
                      root_verdict, select_grid)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--matrix-size", type=int, default=4096)
    p.add_argument("-b", "--block-size", type=int, default=256)
    p.add_argument("--uplo", choices=["L", "U"], default="L")
    add_miniapp_arguments(p)
    return p


def run(argv=None) -> list[dict]:
    """Run the miniapp; returns one dict per timed run. ``--dlaf:<knob>=``
    arguments reach :mod:`dlaf_tpu_torch.config`."""
    args, extra = build_parser().parse_known_args(argv)
    config.initialize(argv=extra)
    opts = parse_miniapp_options(args)
    grid, device = select_grid(opts, config.get_configuration().grid_ordering)
    use_grid = grid if grid.num_devices > 1 else None
    n, nb = args.matrix_size, args.block_size
    size, block = GlobalElementSize(n, n), TileElementSize(nb, nb)
    am = Matrix.from_element_fn(herm_element_fn(n, opts.dtype), size, block, use_grid,
                                dtype=opts.dtype, device=device)
    bm = Matrix.from_element_fn(hpd_element_fn(n, opts.dtype), size, block, use_grid,
                                dtype=opts.dtype, device=device)
    # B is dead once factored: the factor takes its storage
    bf = cholesky(args.uplo, bm, donate=True)
    del bm
    barrier(bf)
    flops = total_ops(opts.dtype, n**3 / 2, n**3 / 2)
    results = []
    for run_i in range(-opts.nwarmups, opts.nruns):
        a_in = am.clone()   # fresh copy per run, transformed in place
        barrier(a_in)
        # the run's fenced span: its record derives GFlop/s from the flop model
        with obs.span("miniapp_gen_to_std.run", flops=flops, run=run_i, warmup=run_i < 0,
                      n=n, nb=nb, uplo=args.uplo, dtype=dtype_name(opts.dtype), grid=f"{opts.grid_rows}x{opts.grid_cols}", backend=device.type):
            t0 = time.perf_counter()
            out = gen_to_std(args.uplo, a_in, bf, donate=True)
            barrier(out)
            t = time.perf_counter() - t0
        if run_i < 0:
            continue
        gflops = flops / t / 1e9
        if is_printer():
            print(f"[{run_i}] {t:.6f}s {gflops:.2f}GFlop/s {type_letter(opts.dtype)}{args.uplo} "
                  f"({n}, {n}) ({nb}, {nb}) ({opts.grid_rows}, {opts.grid_cols}) "
                  f"{os.cpu_count()} {device.type}", flush=True)
        results.append({"run": run_i, "time_s": t, "gflops": gflops})
        if opts.check is CheckIterFreq.ALL or (
                opts.check is CheckIterFreq.LAST and run_i == opts.nruns - 1):
            check(args.uplo, am, bf, out, grid)
    # land the counters and histograms in the artifact now, not at exit
    obs.flush()
    return results


def hegst_residual(uplo: str, a: torch.Tensor, bf: torch.Tensor, out: torch.Tensor) -> float:
    """Exact ``|L C L^H - A|_F / |A|_F`` (uplo U: ``|U^H C U - A|_F /
    |A|_F``) of the global matrices, on their device, norms accumulated in
    float64 (complex128)."""
    ag = hermitian_from(a, uplo)
    c = hermitian_from(out, uplo)
    f = tri_mask(bf, uplo)
    r = (f @ c @ f.mH if uplo == "L" else f.mH @ c @ f) - ag
    wide = torch.complex128 if ag.is_complex() else torch.float64
    num = torch.linalg.vector_norm(r, dtype=wide)
    den = torch.linalg.vector_norm(ag, dtype=wide)
    return float(num / den) if float(den) else float(num)


def check(uplo: str, am: Matrix, bf: Matrix, out: Matrix, grid=None) -> None:
    """Print the ``check:`` line; exit 1 when it fails. In the
    multi-process form the matrices are gathered on the process of rank
    (0, 0), which computes the residual and prints; every process exits 1
    on a failure."""
    n = am.size.row
    mats = [m.gather_global() for m in (am, bf, out)]
    verdict = None
    if mats[0] is not None:
        resid = hegst_residual(uplo, *mats)
        tol = 100.0 * max(n, 1) * torch.finfo(am.dtype.to_real()).eps
        verdict = bool(np.isfinite(resid) and resid < tol)
        print(f"check: {'PASSED' if verdict else 'FAILED'} residual={resid:.3e} tol={tol:.3e}",
              flush=True)
    del mats
    root_verdict(grid, verdict)


def main(argv=None) -> int:
    try:
        run(argv)
    finally:
        multihost.finalize_multihost()
    return 0


if __name__ == "__main__":
    main()
