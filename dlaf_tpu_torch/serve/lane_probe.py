"""Lane-count probe of the batched library calls behind the bucket programs.

A bucket program must give lane i of a B-lane dispatch bitwise the result
of the B=1 dispatch (docs/serving.md). The library's batched Cholesky,
triangular solve and eigh pick their path by the batch count, so the
lanes of a small bare call differ from those of a large one. Two call
forms keep every library call at one batch count or above:

* ``chunked``: cut the batch into 16-lane calls, padding the last one
  with inert lanes;
* ``whole``: pad the batch to at least 16 lanes and make one call.

For each op (cholesky, solve, eigh), dtype and order this probe checks
whether ``whole`` gives bitwise the lanes of ``chunked`` at batch counts
above 16 (so whether one call of B >= 16 lanes is batch-size-invariant),
and times both forms at B = 256 and 4096 (float64, n = 32 and 128), the
median of a few CUDA-event-timed calls each. Run on a CUDA card::

    python -m dlaf_tpu_torch.serve.lane_probe [--out PATH]

It prints one line per cell and writes them as JSON to ``--out``
(default ``chiprun_out/lane_probe.json``). Exit 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

from ..algorithms import batched as bt
from ..tile_ops import blas as tb
from ..tile_ops import lapack as tl


def _chunked(fn, xs, pads):
    """Calls of exactly 16 lanes (the card's ``MIN_LANES``), the last
    padded with inert lanes: the form the batched solve takes."""
    return bt._fixed_lanes(fn, *xs, pads=pads, split=True)


def _whole(fn, xs, pads):
    """One call of at least 16 lanes: the form the batched Cholesky and
    eigh take."""
    return bt._fixed_lanes(fn, *xs, pads=pads)


def _case(op, dt, b, n, gen, dev):
    """``(fn, operands, pads)`` of one op on a seeded well-conditioned batch."""
    x = torch.randn(b, n, n, generator=gen, device=dev, dtype=dt)
    eye = torch.eye(n, device=dev, dtype=dt)
    if op == "cholesky":
        return tl._chol_lower_nan, (x @ x.mH / n + eye,), (eye,)
    if op == "solve":
        rhs = torch.randn(b, n, 4, generator=gen, device=dev, dtype=dt)
        return (lambda a, r: tb._trsm_native("L", "L", "N", "N", a, r),
                (eye + torch.tril(x, -1) / n, rhs), (eye, torch.zeros_like(rhs[0])))
    return torch.linalg.eigh, ((x + x.mH) / 2,), (eye,)


def _same(u, v) -> bool:
    u = u if isinstance(u, tuple) else (u,)
    v = v if isinstance(v, tuple) else (v,)
    return all(torch.equal(torch.nan_to_num(p), torch.nan_to_num(q)) for p, q in zip(u, v))


def _time_ms(fn, reps: int) -> list:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1))
    return out


def run(out_path: str, seed: int = 20261017) -> list:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    names = {torch.float32: "float32", torch.float64: "float64",
             torch.complex128: "complex128"}
    # bitwise: one whole call of B > 16 lanes against 16-lane chunks
    for op in ("cholesky", "solve", "eigh"):
        for dt in names:
            for n in (20, 32, 48, 128, 200):
                for b in (17, 64, 256):
                    fn, xs, pads = _case(op, dt, b, n, gen, dev)
                    same = _same(_whole(fn, xs, pads), _chunked(fn, xs, pads))
                    rows.append(dict(kind="parity", op=op, dtype=names[dt], n=n, B=b,
                                     whole_equals_chunked=same))
                    print(f"[lane_probe] parity {op:8s} {names[dt]:10s} n={n:3d} B={b:4d}: "
                          f"whole {'bitwise' if same else 'DIFFERS from'} 16-lane chunks",
                          flush=True)
    # time: float64, B = 256 and 4096, n = 32 and 128
    for op in ("cholesky", "solve", "eigh"):
        for n in (32, 128):
            for b in (256, 4096):
                fn, xs, pads = _case(op, torch.float64, b, n, gen, dev)
                reps = 3 if op == "eigh" and b * n > 100_000 else 7
                tc = _time_ms(lambda: _chunked(fn, xs, pads), reps)
                tw = _time_ms(lambda: _whole(fn, xs, pads), reps)
                same = _same(_whole(fn, xs, pads), _chunked(fn, xs, pads))
                row = dict(kind="time", op=op, dtype="float64", n=n, B=b, reps=reps,
                           chunked_ms=tc, whole_ms=tw, chunked_median_ms=statistics.median(tc),
                           whole_median_ms=statistics.median(tw), whole_equals_chunked=same)
                rows.append(row)
                print(f"[lane_probe] time {op:8s} float64 n={n:3d} B={b:5d}: chunked "
                      f"{row['chunked_median_ms']:.3f} ms (of {[round(t, 3) for t in tc]}), "
                      f"whole {row['whole_median_ms']:.3f} ms (of {[round(t, 3) for t in tw]}), "
                      f"chunked/whole {row['chunked_median_ms'] / row['whole_median_ms']:.2f}x; "
                      f"lanes {'bitwise' if same else 'DIFFER'}", flush=True)
                del xs
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rows, f, indent=1)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join("chiprun_out", "lane_probe.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("lane_probe: no CUDA device visible", file=sys.stderr)
        return 1
    run(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
