"""Cholesky benchmark miniapp.

Port of ``dlaf_tpu/miniapp/miniapp_cholesky.py`` (reference
``miniapp/miniapp_cholesky.cpp``): fenced timing around each
factorization, the flop model ``total_ops(n^3/6, n^3/6)``, and the same
per-run line

    [i] <t>s <gflops>GFlop/s <type><uplo> (m, m) (mb, mb) (P, Q) <threads> <backend>

and check line ``check: PASSED|FAILED residual=... tol=...`` with
``tol = 60 n eps``. The residual ``|A - L L^H|_F / |A|_F`` is estimated on
the device, where the matrices lie, by :func:`..obs.accuracy.
cholesky_residual`: the seeded probe under ``DLAF_ACCURACY`` "0" and "1",
exact under "full". Under ``DLAF_ACCURACY`` "1" or "full" every timed run
that is not checked emits its ``accuracy`` record too. Under
``DLAF_AUTOTUNE`` each of these residuals (checked, and the timed runs'
records) is fed to the route table (:func:`..autotune.ingest_result`, the
reference's ``miniapp_cholesky.py:145-150, 179-184``): the timed runs
donate their input, so the entry itself has nothing left to probe.

On a grid (``--grid-rows``, ``--grid-cols``; ``--share-device`` to put
every rank on one device) the matrix is distributed block-cyclically and
factored by the distributed builder; under ``torchrun`` one process per
rank (:mod:`.options`), process 0 printing, every process exiting 1 when
the check fails.

Run:  python -m dlaf_tpu_torch.miniapp.miniapp_cholesky -m 16384 -b 256 --type s \\
          --dlaf:step-impl=fused --check-result last
      python -m dlaf_tpu_torch.miniapp.miniapp_cholesky -m 16384 -b 256 --type s \\
          --grid-rows 2 --grid-cols 2 --share-device --dlaf:step-impl=fused \\
          --check-result last
      torchrun --standalone --nproc-per-node 4 -m dlaf_tpu_torch.miniapp.miniapp_cholesky \\
          -m 16384 -b 256 --type s --grid-rows 2 --grid-cols 2 --share-device \\
          --check-result last
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .. import autotune, config, obs
from ..algorithms.cholesky import cholesky
from ..comm import multihost
from ..comm.sync import barrier
from ..common.index2d import GlobalElementSize, TileElementSize
from ..matrix.matrix import Matrix
from ..obs import accuracy
from ..types import dtype_name, total_ops, type_letter
from .checks import report_result
from .generators import hpd_element_fn
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
    n, nb = args.matrix_size, args.block_size
    ref = Matrix.from_element_fn(hpd_element_fn(n, opts.dtype), GlobalElementSize(n, n),
                                 TileElementSize(nb, nb), grid if grid.num_devices > 1 else None,
                                 dtype=opts.dtype, device=device)
    flops = total_ops(opts.dtype, n**3 / 6, n**3 / 6)
    threads = os.cpu_count()
    results = []
    for run_i in range(-opts.nwarmups, opts.nruns):
        mat = ref.clone()   # fresh copy per run
        barrier(mat)
        # the run's fenced span: its record derives GFlop/s from the flop model
        with obs.span("miniapp_cholesky.run", flops=flops, run=run_i, warmup=run_i < 0,
                      n=n, nb=nb, uplo=args.uplo, dtype=dtype_name(opts.dtype), grid=f"{opts.grid_rows}x{opts.grid_cols}", backend=device.type):
            t0 = time.perf_counter()
            out = cholesky(args.uplo, mat, donate=True)
            barrier(out)
            t = time.perf_counter() - t0
        if run_i < 0:
            continue
        gflops = flops / t / 1e9
        if is_printer():
            print(f"[{run_i}] {t:.6f}s {gflops:.2f}GFlop/s {type_letter(opts.dtype)}{args.uplo} "
                  f"({n}, {n}) ({nb}, {nb}) ({opts.grid_rows}, {opts.grid_cols}) {threads} "
                  f"{device.type}", flush=True)
        results.append({"run": run_i, "time_s": t, "gflops": gflops})
        checked = opts.check is CheckIterFreq.ALL or (
            opts.check is CheckIterFreq.LAST and run_i == opts.nruns - 1)
        if checked:
            check_cholesky(args.uplo, ref, out)
        elif accuracy.enabled():
            # outside the timed region; a checked run records through its check
            res = accuracy.emit("miniapp_cholesky", "cholesky_residual",
                                accuracy.cholesky_residual(args.uplo, ref, out), n=n, nb=nb,
                                c=60.0, dtype=opts.dtype, of=out,
                                attrs={"uplo": args.uplo, "run": run_i,
                                       "grid": f"{opts.grid_rows}x{opts.grid_cols}"})
            # the donated run's feed: the entry could not probe
            autotune.ingest_result("cholesky", res, n=n, nb=nb, dtype=opts.dtype,
                                   platform=device.type,
                                   attrs={"entry": "miniapp_cholesky", "run": run_i})
    # land the counters and histograms in the artifact now, not at exit
    obs.flush()
    return results


def check_cholesky(uplo: str, ref: Matrix, out: Matrix) -> None:
    """Print the ``check:`` line; exit 1 when it fails. The estimate runs
    where the matrices lie (in the multi-process form on every process,
    the partial sums meeting in the grid's collectives): process 0
    prints, every process exits 1 on a failure."""
    resid = accuracy.cholesky_residual(uplo, ref, out)
    res = report_result("miniapp_cholesky", "cholesky_residual", resid, n=ref.size.row,
                        nb=ref.block_size.row, c=60.0, dtype=ref.dtype, of=out,
                        attrs={"uplo": uplo}, printer=is_printer())
    # the donated run's feed (the checked residual steers the route table)
    autotune.ingest_result("cholesky", res, n=ref.size.row, nb=ref.block_size.row,
                           dtype=ref.dtype, platform=out.device.type,
                           attrs={"entry": "miniapp_cholesky", "check": True})
    if not res.passed:
        sys.exit(1)


def main(argv=None) -> int:
    try:
        run(argv)
    finally:
        multihost.finalize_multihost()
    return 0


if __name__ == "__main__":
    main()
