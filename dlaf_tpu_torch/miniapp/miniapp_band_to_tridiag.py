"""Band-to-tridiagonal benchmark miniapp.

Port of ``dlaf_tpu/miniapp/miniapp_band_to_tridiag.py:26-104`` (reference
``miniapp/miniapp_band_to_tridiag.cpp``): times the native host chase of
a random band made from a fixed seed; the flop model is the reference's ``total_ops(3 n^2 b,
3 n^2 b)``, and the per-run line is

    [i] <t>s <gflops>GFlop/s <type> (n, n) band=<b> (P, Q) <threads> host

then ``check: PASSED|FAILED residual=... tol=...``: the eigenvalues of the
tridiagonal T (``scipy.linalg.eigvalsh_tridiagonal``) against the band's
(``torch.linalg.eigvalsh`` on the ``--backend`` device), their drift below
``100 n eps`` (the reference's c = 100); a failed check exits 1.

Run:  python -m dlaf_tpu_torch.miniapp.miniapp_band_to_tridiag -m 4096 -b 128 \\
          --check-result last
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .. import config, obs
from ..eigensolver.band_to_tridiag import band_to_tridiag
from ..types import dtype_name, total_ops, type_letter
from .miniapp_reduction_to_band import band_matrix, eigenvalue_drift, print_check, wide
from .options import CheckIterFreq, add_miniapp_arguments, parse_miniapp_options, select_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--matrix-size", type=int, default=4096)
    p.add_argument("-b", "--band-size", type=int, default=128)
    add_miniapp_arguments(p)
    return p


def make_band(n: int, b: int, dtype, seed: int = 0) -> np.ndarray:
    """A random ``(b+1, n)`` lower 'sb' band (a copy of the reference's):
    standard normal entries, a real diagonal, zero past the matrix."""
    rng = np.random.default_rng(seed)
    band = rng.standard_normal((b + 1, n))
    if np.dtype(dtype).kind == "c":
        band = band + 1j * rng.standard_normal((b + 1, n))
        band[0] = np.real(band[0])
    for r in range(1, b + 1):
        band[r, n - r:] = 0
    return band.astype(dtype)


def run(argv=None) -> list[dict]:
    args, extra = build_parser().parse_known_args(argv)
    config.initialize(argv=extra)
    opts = parse_miniapp_options(args)
    device = select_device(opts)
    n, b = args.matrix_size, args.band_size
    band = make_band(n, b, opts.dtype)
    flops = total_ops(opts.dtype, 3.0 * n * n * b, 3.0 * n * n * b)
    results = []
    for run_i in range(-opts.nwarmups, opts.nruns):
        # the run's fenced span: its record derives GFlop/s from the flop model
        with obs.span("miniapp_band_to_tridiag.run", flops=flops, run=run_i, warmup=run_i < 0,
                      n=n, band=b, dtype=dtype_name(opts.dtype), backend="host"):
            t0 = time.perf_counter()
            res = band_to_tridiag(band, b)
            t = time.perf_counter() - t0
        if run_i < 0:
            continue
        gflops = flops / t / 1e9
        print(f"[{run_i}] {t:.6f}s {gflops:.2f}GFlop/s {type_letter(opts.dtype)} ({n}, {n}) "
              f"band={b} ({opts.grid_rows}, {opts.grid_cols}) {os.cpu_count()} host",
              flush=True)
        results.append({"run": run_i, "time_s": t, "gflops": gflops})
        if opts.check is CheckIterFreq.ALL or (
                opts.check is CheckIterFreq.LAST and run_i == opts.nruns - 1):
            check(band, res, device, opts.dtype)
    # land the counters and histograms in the artifact now, not at exit
    obs.flush()
    return results


def tridiag_drift(w_ref: torch.Tensor, res) -> float:
    """Drift of the eigenvalues of the chase's real tridiagonal ``(d, e)``
    against the sorted ``w_ref``."""
    import scipy.linalg as sla

    w = sla.eigvalsh_tridiagonal(res.d, res.e) if res.d.size else np.zeros(0)
    return eigenvalue_drift(w_ref.cpu(), torch.as_tensor(w))


def check(band: np.ndarray, res, device, dtype) -> None:
    w_ref = torch.linalg.eigvalsh(wide(band_matrix(band, device)))
    if not print_check(tridiag_drift(w_ref, res), band.shape[1], dtype,
                       "miniapp_band_to_tridiag", band.shape[0] - 1, of=w_ref):
        sys.exit(1)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    main()
