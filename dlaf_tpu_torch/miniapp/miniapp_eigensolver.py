"""Eigensolver benchmark miniapp, standard and generalized.

Port of ``dlaf_tpu/miniapp/miniapp_eigensolver.py:1-198`` (reference
``miniapp/miniapp_eigensolver.cpp`` and ``miniapp_gen_eigensolver.cpp``):
A is the reference's analytic Hermitian setter, B (``--generalized``) its
HPD ``hpd_element_fn``; each timed run solves a fresh copy of A (donated),
fenced; the flop model is the reference's ``total_ops(5n^3/3, 5n^3/3)``,
and the per-run line is

    [i] <t>s <gflops>GFlop/s <type><uplo> evp|gen_evp (n, n) (nb, nb) (P, Q) <threads> <backend>

then ``check: PASSED|FAILED residual=... orthogonality=... tol=...``: the
eigenpair residual ``|A Z - [B] Z diag(lambda)|_F / |A|_F`` and the
orthogonality ``|Z^H [B] Z - I|_F``, both below ``200 n eps`` (the
reference's ``EIGEN_BUDGETS``), estimated on the device where the
matrices lie (:func:`..obs.accuracy.eigen_residuals`, and
:func:`..obs.accuracy.b_orthogonality` with B: the seeded probe under
``DLAF_ACCURACY`` "0" and "1", exact under "full"); a failed check exits
1. The check and, under ``DLAF_ACCURACY`` "1" or "full", every unchecked
timed run emit the reference's three ``accuracy`` records (the sampled
per-pair maximum ``eigenpair_max`` among them); with B the
``orthogonality`` record is the B-orthogonality the check holds.
``--band-size`` (default: the block size) must divide the block size. A
grid (``--grid-rows``, ``--grid-cols``; ``--share-device`` for every rank
on one device) runs the distributed pipeline.

BASELINE config #5: gen_eigensolver, float64, N=32768, nb=512, 8x8.

Under ``torchrun`` one process per rank (:mod:`.options`): process 0
prints the run lines and the check.

Run:  python -m dlaf_tpu_torch.miniapp.miniapp_eigensolver -m 4096 -b 256 --check-result last
      python -m dlaf_tpu_torch.miniapp.miniapp_eigensolver -m 4096 -b 256 --generalized \\
          --grid-rows 2 --grid-cols 2 --share-device --check-result last
      torchrun --standalone --nproc-per-node 4 \\
          -m dlaf_tpu_torch.miniapp.miniapp_gen_eigensolver -m 8192 -b 256 \\
          --grid-rows 2 --grid-cols 2 --share-device --check-result last
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .. import config, obs
from ..comm import multihost
from ..comm.sync import barrier
from ..common.index2d import GlobalElementSize, TileElementSize
from ..eigensolver.eigensolver import eigensolver, gen_eigensolver
from ..matrix.matrix import Matrix
from ..obs import accuracy
from ..types import dtype_name, total_ops, type_letter
from .checks import report
from .generators import hpd_element_fn
from .miniapp_reduction_to_band import herm_setter, wide
from .options import (CheckIterFreq, add_miniapp_arguments, is_printer, parse_miniapp_options,
                      select_grid)

#: Tolerance factors ``c`` of ``c n eps`` (the reference's EIGEN_BUDGETS).
EIGEN_BUDGETS = {"eigen_residual": 200.0, "eigenpair_max": 200.0, "orthogonality": 200.0}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--matrix-size", type=int, default=1024)
    p.add_argument("-b", "--block-size", type=int, default=256)
    p.add_argument("--uplo", choices=["L", "U"], default="L")
    p.add_argument("--generalized", action="store_true",
                   help="solve A x = lambda B x (miniapp_gen_eigensolver)")
    p.add_argument("--band-size", type=int, default=-1,
                   help="reduction bandwidth; negative = the block size (must divide it)")
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
    band = None if args.band_size < 0 else args.band_size
    size, block = GlobalElementSize(n, n), TileElementSize(nb, nb)
    am = Matrix.from_element_fn(herm_setter, size, block, use_grid, dtype=opts.dtype,
                                device=device)
    bm = (Matrix.from_element_fn(hpd_element_fn(n, opts.dtype), size, block, use_grid,
                                 dtype=opts.dtype, device=device) if args.generalized else None)
    flops = total_ops(opts.dtype, 5 * n ** 3 / 3, 5 * n ** 3 / 3)
    name = "gen_evp" if args.generalized else "evp"
    results = []
    for run_i in range(-opts.nwarmups, opts.nruns):
        a_in = am.clone()     # this run's copy, consumed by the solve
        barrier(a_in)
        # the run's fenced span: its record derives GFlop/s from the flop model
        with obs.span("miniapp_eigensolver.run", flops=flops, run=run_i, warmup=run_i < 0,
                      n=n, nb=nb, uplo=args.uplo, generalized=bool(args.generalized),
                      dtype=dtype_name(opts.dtype), grid=f"{opts.grid_rows}x{opts.grid_cols}", backend=device.type):
            t0 = time.perf_counter()
            if args.generalized:
                res = gen_eigensolver(args.uplo, a_in, bm, band_size=band, donate=True)
            else:
                res = eigensolver(args.uplo, a_in, band_size=band, donate=True)
            barrier(res.eigenvectors)
            t = time.perf_counter() - t0
        if run_i < 0:
            continue
        gflops = flops / t / 1e9
        if is_printer():
            print(f"[{run_i}] {t:.6f}s {gflops:.2f}GFlop/s {type_letter(opts.dtype)}{args.uplo} "
                  f"{name} ({n}, {n}) ({nb}, {nb}) ({opts.grid_rows}, {opts.grid_cols}) "
                  f"{os.cpu_count()} {device.type}", flush=True)
        results.append({"run": run_i, "time_s": t, "gflops": gflops})
        checked = opts.check is CheckIterFreq.ALL or (
            opts.check is CheckIterFreq.LAST and run_i == opts.nruns - 1)
        if checked:
            check(am, bm, res, args.uplo)
        elif accuracy.enabled():
            # outside the timed region; a checked run records through its check
            for metric, value in estimates(am, bm, res, args.uplo).items():
                accuracy.emit("miniapp_eigensolver", metric, value, n=n, nb=nb,
                              c=EIGEN_BUDGETS[metric], dtype=opts.dtype, of=res.eigenvectors,
                              attrs={"uplo": args.uplo, "generalized": bool(args.generalized),
                                     "run": run_i,
                                     "grid": f"{opts.grid_rows}x{opts.grid_cols}"})
    # land the counters and histograms in the artifact now, not at exit
    obs.flush()
    return results


def eigen_residuals(a: torch.Tensor, b, lam, z: torch.Tensor) -> dict:
    """``{"eigen_residual": |A Z - [B] Z diag(lam)|_F / |A|_F,
    "orthogonality": |Z^H [B] Z - I|_F}`` of the global matrices ``a``,
    ``b`` (None: the identity) and ``z`` by library products in float64
    (complex128) on ``z``'s device."""
    a, z = wide(a), wide(z)
    lam_t = torch.as_tensor(lam, dtype=torch.float64, device=z.device)
    bz = z if b is None else wide(b) @ z
    resid = torch.linalg.matrix_norm(a @ z - bz * lam_t[None, :]) / torch.linalg.matrix_norm(a)
    gram = z.mH @ bz
    gram.diagonal().sub_(1.0)
    return {"eigen_residual": float(resid), "orthogonality": float(torch.linalg.matrix_norm(gram))}


def estimates(am: Matrix, bm, res, uplo: str) -> dict:
    """The eigenpairs' ``eigen_residual``, ``eigenpair_max`` and
    ``orthogonality`` (with B: ``|Z^H B Z - I|_F``), estimated where the
    matrices lie."""
    vals = accuracy.eigen_residuals(uplo, am, res.eigenvalues, res.eigenvectors, b=bm)
    if bm is not None:
        vals["orthogonality"] = accuracy.b_orthogonality(uplo, bm, res.eigenvectors)
    return vals


def check(am: Matrix, bm, res, uplo: str) -> None:
    """The eigenpair residual and orthogonality below ``200 n eps`` each;
    prints the check line, exits 1 when it fails. The estimates run where
    the matrices lie (in the multi-process form on every process): process
    0 prints, every process exits 1 on a failure."""
    n, nb = am.size.row, am.block_size.row
    vals = estimates(am, bm, res, uplo)
    attrs = {"uplo": uplo, "generalized": bm is not None}
    passed = {k: accuracy.emit("miniapp_eigensolver", k, v, n=n, nb=nb, c=EIGEN_BUDGETS[k],
                               dtype=am.dtype, of=res.eigenvectors,
                               attrs=dict(attrs, check=True)).passed
              for k, v in vals.items() if k != "eigen_residual"}
    verdict = report("miniapp_eigensolver", "eigen_residual", vals["eigen_residual"], n=n,
                     nb=nb, c=EIGEN_BUDGETS["eigen_residual"], dtype=am.dtype,
                     of=res.eigenvectors, attrs=attrs, printer=is_printer(),
                     extra=f" orthogonality={vals['orthogonality']:.3e}")
    if not (verdict and passed["orthogonality"]):
        sys.exit(1)


def main(argv=None) -> int:
    try:
        run(argv)
    finally:
        multihost.finalize_multihost()
    return 0


if __name__ == "__main__":
    main()
