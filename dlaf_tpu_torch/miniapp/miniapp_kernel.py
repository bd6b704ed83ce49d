"""Tile-kernel microbenchmark.

Port of ``dlaf_tpu/miniapp/miniapp_kernel.py`` (reference
``miniapp/kernel/miniapp_laset.cpp``, ``kernel_runner.h``,
``work_tiles.h``): times one tile op over a batch of work tiles, fenced,
rotating between two independent work sets
(:class:`..common.round_robin.RoundRobin`) so that a timed run never
re-reads the buffers the previous one just touched. The ops are laset,
lacpy, gemm, trsm and potrf of :mod:`..tile_ops`; the per-run line is

    [i] <t>s <gflops>GFlop/s <kernel> <type> (m, m) x<batch> <threads> <backend>

Each run is a fenced ``miniapp_kernel.run`` span (:mod:`..obs`) with the
flop model, as the reference's, and each call of the op a program
telemetry site ``miniapp_kernel.<kernel>`` (:mod:`..obs.telemetry`).

Run:  python -m dlaf_tpu_torch.miniapp.miniapp_kernel --kernel gemm -m 256 --batch 64
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import config, obs
from ..common.round_robin import RoundRobin
from ..common.sync import hard_fence
from ..tile_ops import blas as tb
from ..tile_ops import lapack as tl
from ..types import dtype_name, total_ops, type_letter
from .options import add_miniapp_arguments, parse_miniapp_options, select_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--kernel", choices=["laset", "lacpy", "gemm", "trsm", "potrf"],
                   default="laset")
    p.add_argument("-m", "--tile-size", type=int, default=256)
    p.add_argument("--batch", type=int, default=64)
    add_miniapp_arguments(p)
    return p


def run(argv=None) -> list[dict]:
    """Run the miniapp; returns one dict per timed run."""
    args, extra = build_parser().parse_known_args(argv)
    config.initialize(argv=extra)
    opts = parse_miniapp_options(args)
    device = select_device(opts)
    m, batch, dtype = args.tile_size, args.batch, opts.dtype
    rng = np.random.default_rng(0)
    work = RoundRobin([
        (torch.as_tensor(rng.standard_normal((batch, m, m)).astype(dtype), device=device),
         torch.as_tensor((rng.standard_normal((batch, m, m)) / m
                          + 2 * np.eye(m)).astype(dtype), device=device))
        for _ in range(2)])
    kernels = {
        "laset": (lambda a, spd: tl.laset("G", 1.0, 2.0, (batch, m, m), dtype, device), 0),
        "lacpy": (lambda a, spd: tl.lacpy("L", a, torch.zeros_like(a)), 0),
        "gemm": (lambda a, spd: tb.gemm(a, a), batch * 2.0 * m**3 / 2),
        "trsm": (lambda a, spd: tb.trsm("L", "L", "N", "N", spd, a), batch * m**3 / 2 / 2),
        "potrf": (lambda a, spd: tl.potrf("L", spd), batch * m**3 / 6),
    }
    fn, half_flops = kernels[args.kernel]
    site = f"miniapp_kernel.{args.kernel}"
    for a, spd in work:    # first calls (library set-up) outside the timing
        # with DLAF_PROGRAM_TELEMETRY the artifact carries this first call
        hard_fence(obs.telemetry.call(site, fn, a, spd))
    flops = total_ops(dtype, half_flops, half_flops)
    results = []
    for run_i in range(-opts.nwarmups, opts.nruns):
        a, spd = work.next_resource()
        # the run's fenced span: its record derives GFlop/s from the flop model
        with obs.span("miniapp_kernel.run", flops=flops, run=run_i, warmup=run_i < 0,
                      kernel=args.kernel, m=m, batch=batch, dtype=dtype_name(dtype)):
            t0 = time.perf_counter()
            hard_fence(obs.telemetry.call(site, fn, a, spd))
            t = time.perf_counter() - t0
        if run_i < 0:
            continue
        gflops = flops / t / 1e9
        print(f"[{run_i}] {t:.6f}s {gflops:.2f}GFlop/s {args.kernel} {type_letter(dtype)} "
              f"({m}, {m}) x{batch} {os.cpu_count()} {device.type}", flush=True)
        results.append({"run": run_i, "time_s": t, "gflops": gflops})
    # land the counters and histograms in the artifact now, not at exit
    obs.flush()
    return results


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    main()
