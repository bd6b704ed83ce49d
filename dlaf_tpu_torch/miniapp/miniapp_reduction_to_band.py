"""Reduction-to-band benchmark miniapp.

Port of ``dlaf_tpu/miniapp/miniapp_reduction_to_band.py:33-128`` (reference
``miniapp/miniapp_reduction_to_band.cpp``): A is the reference's analytic
Hermitian setter, each timed run reduces a fresh copy of it (donated),
fenced; the flop model is the reference's ``total_ops(2n^3/3, 2n^3/3)``,
and the per-run line is

    [i] <t>s <gflops>GFlop/s <type>L (n, n) (nb, nb) (P, Q) <threads> <backend>

then ``check: PASSED|FAILED residual=... tol=...``: the eigenvalue drift
``max |lambda(B) - lambda(A)| / max |lambda(A)|`` of the band B (read with
``extract_band``) against A, both by ``torch.linalg.eigvalsh`` in float64
(complex128) on the device (A's once per process, size and type), below
``100 n eps`` (the reference's c = 100);
a failed check exits 1. ``--band-size`` (default: the block size) must
divide the block size, on one rank and on a grid (``--grid-rows``,
``--grid-cols``, ``--share-device`` for every rank on one device).

BASELINE config #4: float64, N=16384, nb=512, band 128, 4x4.

Under ``torchrun`` one process per rank (:mod:`.options`), process 0
printing the run lines and rank (0, 0)'s process, where the band is
gathered, the check.

Run:  python -m dlaf_tpu_torch.miniapp.miniapp_reduction_to_band -m 16384 -b 512 \\
          --band-size 128 --grid-rows 4 --grid-cols 4 --share-device --type d \\
          --check-result last
      torchrun --standalone --nproc-per-node 4 \\
          -m dlaf_tpu_torch.miniapp.miniapp_reduction_to_band -m 16384 -b 512 \\
          --band-size 128 --grid-rows 2 --grid-cols 2 --share-device --type d \\
          --check-result last
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch

from .. import config, obs
from ..comm import multihost
from ..comm.sync import barrier
from ..common.index2d import GlobalElementSize, TileElementSize
from ..eigensolver.reduction_to_band import extract_band, reduction_to_band
from ..matrix.matrix import Matrix
from ..types import dtype_name, total_ops, type_letter
from .checks import report
from .options import (CheckIterFreq, add_miniapp_arguments, is_printer, parse_miniapp_options,
                      root_verdict, select_grid)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--matrix-size", type=int, default=4096)
    p.add_argument("-b", "--block-size", type=int, default=256)
    p.add_argument("--band-size", type=int, default=-1,
                   help="bandwidth; negative = the block size (must divide it)")
    add_miniapp_arguments(p)
    return p


def herm_setter(i, j):
    """The reference's analytic Hermitian element function."""
    return torch.cos(0.001 * (i * 31 + j * 17)) + torch.cos(0.001 * (j * 31 + i * 17))


def run(argv=None) -> list[dict]:
    """Run the miniapp; returns one dict per timed run. ``--dlaf:<knob>=``
    arguments reach :mod:`dlaf_tpu_torch.config`."""
    args, extra = build_parser().parse_known_args(argv)
    config.initialize(argv=extra)
    opts = parse_miniapp_options(args)
    grid, device = select_grid(opts, config.get_configuration().grid_ordering)
    use_grid = grid if grid.num_devices > 1 else None
    n, nb = args.matrix_size, args.block_size
    band = nb if args.band_size < 0 else args.band_size
    ref = Matrix.from_element_fn(herm_setter, GlobalElementSize(n, n), TileElementSize(nb, nb),
                                 use_grid, dtype=opts.dtype, device=device)
    flops = total_ops(opts.dtype, 2 * n**3 / 3, 2 * n**3 / 3)
    results = []
    for run_i in range(-opts.nwarmups, opts.nruns):
        mat = ref.clone()   # fresh copy per run, reduced in place
        barrier(mat)
        # the run's fenced span: its record derives GFlop/s from the flop model
        with obs.span("miniapp_reduction_to_band.run", flops=flops, run=run_i, warmup=run_i < 0,
                      n=n, nb=nb, band=band, dtype=dtype_name(opts.dtype), grid=f"{opts.grid_rows}x{opts.grid_cols}", backend=device.type):
            t0 = time.perf_counter()
            red = reduction_to_band(mat, band_size=band, donate=True)
            barrier(red.matrix, red.taus)
            t = time.perf_counter() - t0
        if run_i < 0:
            continue
        gflops = flops / t / 1e9
        if is_printer():
            print(f"[{run_i}] {t:.6f}s {gflops:.2f}GFlop/s {type_letter(opts.dtype)}L ({n}, {n}) "
                  f"({nb}, {nb}) ({opts.grid_rows}, {opts.grid_cols}) {os.cpu_count()} "
                  f"{device.type}", flush=True)
        results.append({"run": run_i, "time_s": t, "gflops": gflops})
        if opts.check is CheckIterFreq.ALL or (
                opts.check is CheckIterFreq.LAST and run_i == opts.nruns - 1):
            check(ref, red, grid)
    # land the counters and histograms in the artifact now, not at exit
    obs.flush()
    return results


def band_matrix(band: np.ndarray, device) -> torch.Tensor:
    """The dense ``(n, n)`` matrix of a ``(b+1, n)`` lower 'sb' band on
    ``device``, its lower triangle filled (what ``eigvalsh`` reads)."""
    b1, n = band.shape
    vals = torch.as_tensor(band).to(device)
    r = torch.arange(b1, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :].expand(b1, n)
    rows = r + j
    keep = rows < n
    out = torch.zeros((n, n), dtype=vals.dtype, device=device)
    out[rows[keep], j[keep]] = vals[keep]
    return out


def eigenvalue_drift(w_ref: torch.Tensor, w: torch.Tensor) -> float:
    """``max |w - w_ref| / max |w_ref|`` of two sorted eigenvalue sets."""
    scale = max(float(w_ref.abs().max()), 1e-30) if w_ref.numel() else 1.0
    return float((w - w_ref).abs().max()) / scale if w_ref.numel() else 0.0


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float64 (complex128 for complex types)."""
    return x.to(torch.complex128 if x.is_complex() else torch.float64)


def print_check(resid: float, n: int, dtype, site: str, nb: int, of=None, attrs=None) -> bool:
    """Print the ``check:`` line of an eigenvalue drift against ``100 n
    eps`` of ``dtype`` and record it (an ``accuracy`` record of metric
    ``eigenvalue_drift`` at ``site``, the reference's); returns whether it
    passed."""
    return report(site, "eigenvalue_drift", resid, n=n, nb=nb, c=100.0, dtype=dtype, of=of,
                  attrs=attrs)


@functools.lru_cache(maxsize=4)
def setter_eigenvalues(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The eigenvalues of the analytic A of order ``n`` in ``dtype``
    (formed on ``device``, computed in float64): the same for every run
    and grid, so a process computes them once per size, type and device."""
    i = torch.arange(n, device=device, dtype=torch.float64)
    return torch.linalg.eigvalsh(wide(herm_setter(i[:, None], i[None, :]).to(dtype)))


def check(ref: Matrix, red, grid=None) -> None:
    """The eigenvalues of the band against A's, on A's device (in the
    multi-process form on rank (0, 0)'s process, where the band is
    gathered); exits 1 (every process) when the check fails."""
    band = extract_band(red)
    verdict = None
    if band is not None:
        dev = ref.device
        resid = eigenvalue_drift(setter_eigenvalues(ref.size.row, ref.dtype, dev),
                                 torch.linalg.eigvalsh(wide(band_matrix(band, dev))))
        verdict = print_check(resid, ref.size.row, ref.dtype, "miniapp_reduction_to_band",
                              ref.block_size.row, of=band, attrs={"band": red.band})
    root_verdict(grid, verdict)


def main(argv=None) -> int:
    try:
        run(argv)
    finally:
        multihost.finalize_multihost()
    return 0


if __name__ == "__main__":
    main()
