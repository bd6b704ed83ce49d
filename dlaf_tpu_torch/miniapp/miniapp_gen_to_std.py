"""HEGST (generalized-to-standard eigenproblem transform) benchmark miniapp.

Port of ``dlaf_tpu/miniapp/miniapp_gen_to_std.py`` (reference
``miniapp/miniapp_gen_to_std.cpp``): B is factored once
(``cholesky(..., donate=True)``), then each timed run transforms a fresh
copy of A (donated) with that factor, fenced; the flop model is the
reference's ``total_ops(n^3/2, n^3/2)`` whatever the route's actual work
(twosolve does about twice as much), and the per-run line is

    [i] <t>s <gflops>GFlop/s <type><uplo> (n, n) (nb, nb) (P, Q) <threads> <backend>

then ``check: PASSED|FAILED residual=... tol=...``: the residual
``|L C L^H - A|_F / |A|_F`` (uplo U: ``|U^H C U - A|_F / |A|_F``), A and C
Hermitian-expanded from their ``uplo`` triangles, estimated on the device
where the matrices lie (:func:`..obs.accuracy.hegst_residual`: the seeded
probe under ``DLAF_ACCURACY`` "0" and "1", exact under "full"), against
``tol = 100 n eps`` (the reference's c = 100); a failed check exits 1.
Under ``DLAF_ACCURACY`` "1" or "full" every unchecked timed run emits its
``accuracy`` record too. B is :func:`.generators.hpd_element_fn`; A is
:func:`.generators.herm_element_fn` (the reference takes B's function for
A too, which makes the standard matrix the identity).

BASELINE config #3: complex128, N=8192, nb=256, 2x2.

Under ``torchrun`` one process per rank (:mod:`.options`), process 0
printing the run lines and the check.

Run:  python -m dlaf_tpu_torch.miniapp.miniapp_gen_to_std -m 8192 -b 256 --type z \\
          --grid-rows 2 --grid-cols 2 --share-device --check-result last
      torchrun --standalone --nproc-per-node 4 -m dlaf_tpu_torch.miniapp.miniapp_gen_to_std \\
          -m 8192 -b 256 --type z --grid-rows 2 --grid-cols 2 --share-device \\
          --check-result last
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .. import config, obs
from ..algorithms.cholesky import cholesky
from ..algorithms.gen_to_std import gen_to_std
from ..comm import multihost
from ..comm.sync import barrier
from ..common.index2d import GlobalElementSize, TileElementSize
from ..matrix.matrix import Matrix
from ..obs import accuracy
from ..types import dtype_name, total_ops, type_letter
from .checks import report
from .generators import herm_element_fn, hpd_element_fn
from .options import (CheckIterFreq, add_miniapp_arguments, is_printer, parse_miniapp_options,
                      select_grid)


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
        checked = opts.check is CheckIterFreq.ALL or (
            opts.check is CheckIterFreq.LAST and run_i == opts.nruns - 1)
        if checked:
            check(args.uplo, am, bf, out)
        elif accuracy.enabled():
            # outside the timed region; a checked run records through its check
            accuracy.emit("miniapp_gen_to_std", "hegst_residual",
                          accuracy.hegst_residual(args.uplo, am, bf, out), n=n, nb=nb, c=100.0,
                          dtype=opts.dtype, of=out,
                          attrs={"uplo": args.uplo, "run": run_i,
                                 "grid": f"{opts.grid_rows}x{opts.grid_cols}"})
    # land the counters and histograms in the artifact now, not at exit
    obs.flush()
    return results


def check(uplo: str, am: Matrix, bf: Matrix, out: Matrix) -> None:
    """Print the ``check:`` line; exit 1 when it fails. The estimate runs
    where the matrices lie (in the multi-process form on every process):
    process 0 prints, every process exits 1 on a failure."""
    resid = accuracy.hegst_residual(uplo, am, bf, out)
    if not report("miniapp_gen_to_std", "hegst_residual", resid, n=am.size.row,
                  nb=am.block_size.row, c=100.0, dtype=am.dtype, of=out,
                  attrs={"uplo": uplo}, printer=is_printer()):
        sys.exit(1)


def main(argv=None) -> int:
    try:
        run(argv)
    finally:
        multihost.finalize_multihost()
    return 0


if __name__ == "__main__":
    main()
