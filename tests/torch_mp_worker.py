"""One process of the multi-process tests' ``torch.distributed`` world.

``tests/test_torch_multiprocess.py`` starts one of these per rank of a
P x Q grid, each with a gloo world over a ``file://`` rendezvous:

    python tests/torch_mp_worker.py <init-url> <rank> <world> <P> <Q> <out-dir> [cases|hang]

In ``cases`` mode it builds the multi-process grid on the CPU
(:func:`dlaf_tpu_torch.comm.multihost.multihost_grid`), runs every case of
:data:`CASES` through the port's entry points and writes what its rank
holds of each result to ``<out-dir>/<case>.r<rank>.pt``; the test
computes the same cases on the single-controller grid and compares. In
``hang`` mode rank 0 waits in a broadcast that rank 1 never joins (the
test of the harness's timeout). This module imports only the port: the
test module imports it for :data:`CASES` and :func:`run_case`.
"""

from __future__ import annotations

import os
import sys
import time
import traceback
import types

import numpy as np
import torch

from dlaf_tpu_torch import config
from dlaf_tpu_torch.algorithms import general, permutations, qr
from dlaf_tpu_torch.algorithms.cholesky import cholesky
from dlaf_tpu_torch.algorithms.gen_to_std import gen_to_std
from dlaf_tpu_torch.algorithms.norm import max_norm
from dlaf_tpu_torch.algorithms.triangular import triangular_multiply, triangular_solve
from dlaf_tpu_torch.comm import collectives as cc
from dlaf_tpu_torch.comm import multihost, sync
from dlaf_tpu_torch.comm.grid import COL_AXIS, ROW_AXIS, Grid
from dlaf_tpu_torch.common.index2d import GlobalElementSize, RankIndex2D, TileElementSize
from dlaf_tpu_torch.eigensolver import back_transform, eigensolver, reduction_to_band
from dlaf_tpu_torch.matrix import ops as mops
from dlaf_tpu_torch.matrix.matrix import Matrix

KNOBS = ("CHOLESKY_TRAILING", "CHOLESKY_LOOKAHEAD", "COMM_LOOKAHEAD", "PANEL_IMPL",
         "STEP_IMPL", "OZAKI_IMPL", "F64_GEMM", "F64_TRSM", "F64_GEMM_MIN_DIM",
         "FORCE_PALLAS_UPDATE", "DIST_STEP_MODE")

#: The grids: (P, Q, source rank, n, nb); n is not a multiple of nb and the
#: tiles spread unevenly over the ranks.
GRIDS = {"2x2": (2, 2, (0, 1), 44, 8), "1x3": (1, 3, (0, 2), 38, 8)}

FORCE = {"force_pallas_update": 1}
OZ7 = {"f64_gemm": "mxu", "f64_trsm": "mixed", "ozaki_impl": "pallas", "f64_gemm_min_dim": 8}
LA = {"cholesky_lookahead": 1, "comm_lookahead": 1}
SCAN = {"cholesky_trailing": "scan"}
F32, F64, C128 = np.float32, np.float64, np.complex128


def _chol(dtype, uplo, knobs=None, fail_col=None, with_info=False):
    return dict(kind="cholesky", dtype=dtype, uplo=uplo, knobs=knobs or {},
                fail_col=fail_col, with_info=with_info)


def _tri(kind, combo, mode, dtype=F64, knobs=None, zero_col=None):
    return dict(kind=kind, combo=combo, dtype=dtype,
                knobs={"dist_step_mode": mode, **(knobs or {})}, zero_col=zero_col)


#: Every case, by name: the Cholesky on each route and knob, the triangular
#: solve and multiply, max_norm, the matrix constructors, the verbs, and
#: the builders that have no multi-process form yet.
CASES = {
    "chol-s-L": _chol(F32, "L"),
    "chol-s-U": _chol(F32, "U"),
    "chol-d-L": _chol(F64, "L"),
    "chol-d-U": _chol(F64, "U"),
    "chol-scan-s-L": _chol(F32, "L", SCAN),
    "chol-scan-s-U": _chol(F32, "U", SCAN),
    "chol-scan-d-L": _chol(F64, "L", SCAN),
    "chol-scan-d-U": _chol(F64, "U", SCAN),
    "chol-update-s-L": _chol(F32, "L", FORCE),
    "chol-update-s-U": _chol(F32, "U", FORCE),
    "chol-ozaki-d-L": _chol(F64, "L", OZ7),
    "chol-ozaki-scan-d-U": _chol(F64, "U", {**OZ7, **SCAN}),
    "chol-mixed-d-L": _chol(F64, "L", {"f64_trsm": "mixed"}),
    "chol-fused-s-L": _chol(F32, "L", {"step_impl": "fused", **FORCE}),
    "chol-fused-s-U": _chol(F32, "U", {"step_impl": "fused", "panel_impl": "fused"}),
    "chol-fused-scan-s-L": _chol(F32, "L", {"step_impl": "fused", **SCAN}),
    "chol-la-d-L": _chol(F64, "L", LA),
    "chol-la-nocomm-d-U": _chol(F64, "U", {"cholesky_lookahead": 1, "comm_lookahead": 0}),
    "chol-la-update-s-L": _chol(F32, "L", {**LA, **FORCE, "step_impl": "fused"}),
    "chol-la-scan-s-U": _chol(F32, "U", {**SCAN, "cholesky_lookahead": 1}),
    "chol-z-U": _chol(C128, "U", LA),
    "chol-info-s-L": _chol(F32, "L", {"cholesky_lookahead": 1}, fail_col=16, with_info=True),
    "chol-info-scan-d-U": _chol(F64, "U", SCAN, fail_col=16, with_info=True),
    "chol-info-ok-d-L": _chol(F64, "L", LA, with_info=True),
    "trsm-LLNN-unrolled": _tri("solve", "LLNN", "unrolled"),
    "trsm-LLNN-scan": _tri("solve", "LLNN", "scan"),
    "trsm-RUCN-unrolled": _tri("solve", "RUCN", "unrolled"),
    "trsm-RUCN-scan": _tri("solve", "RUCN", "scan"),
    "trsm-LUTU-scan-la": _tri("solve", "LUTU", "scan", knobs={"cholesky_lookahead": 1}),
    "trsm-s-LLNN-fused": _tri("solve", "LLNN", "unrolled", F32, {"panel_impl": "fused"}),
    "trsm-info-LLNN": _tri("solve", "LLNN", "unrolled", zero_col=20),
    "trmm-LLNN-unrolled": _tri("multiply", "LLNN", "unrolled"),
    "trmm-LLNN-scan": _tri("multiply", "LLNN", "scan"),
    "trmm-RUTU-unrolled": _tri("multiply", "RUTU", "unrolled"),
    "trmm-RUTU-scan": _tri("multiply", "RUTU", "scan"),
    "norm-G": dict(kind="norm", uplo="G", dtype=F64),
    "norm-L": dict(kind="norm", uplo="L", dtype=F64),
    "norm-z-G": dict(kind="norm", uplo="G", dtype=C128),
    "from_element_fn": dict(kind="element_fn"),
    "sync-gather": dict(kind="sync", what="gather"),
    "sync-gather_shards": dict(kind="sync", what="gather_shards"),
    "sync-gather_shards-nested": dict(kind="sync", what="nested"),
    "to_global": dict(kind="to_global"),
    "verb-sum-row": dict(kind="verb", verb="all_reduce", axis=ROW_AXIS, op="sum"),
    "verb-sum-col": dict(kind="verb", verb="all_reduce", axis=COL_AXIS, op="sum"),
    "verb-max-col": dict(kind="verb", verb="all_reduce", axis=COL_AXIS, op="max"),
    "verb-min-row": dict(kind="verb", verb="all_reduce", axis=ROW_AXIS, op="min"),
    "verb-bcast-z-row": dict(kind="verb", verb="bcast", axis=ROW_AXIS, dtype=C128),
    "verb-bcast-col": dict(kind="verb", verb="bcast", axis=COL_AXIS),
    "verb-bcast2d": dict(kind="verb", verb="bcast2d"),
    "verb-gather-col": dict(kind="verb", verb="all_gather", axis=COL_AXIS),
    "verb-gather-row-tiled": dict(kind="verb", verb="all_gather", axis=ROW_AXIS, tiled=True),
    "verb-all_to_all-col": dict(kind="verb", verb="all_to_all", axis=COL_AXIS),
    "verb-send_recv-col": dict(kind="verb", verb="send_recv", axis=COL_AXIS),
    "verb-reduce-row": dict(kind="verb", verb="reduce", axis=ROW_AXIS),
    "verb-barrier-col": dict(kind="verb", verb="barrier_value", axis=COL_AXIS),
    **{f"unported-{name}": dict(kind="unported", what=name)
       for name in ("gen_to_std", "reduction_to_band", "bt_band_to_tridiag",
                    "bt_reduction_to_band", "permute", "general_sub_multiply", "t_factor",
                    "eigensolver", "gen_eigensolver", "transpose")},
}


def hpd(n, dtype, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((n, n))
    # einsum's own loops: the same bits in every process, whatever the
    # BLAS's thread count
    return (np.einsum("ik,jk->ij", x, x.conj()) + n * np.eye(n)).astype(dtype)


def _rank_value(r, c, Q, dtype, shape):
    """A seeded per-rank value whose entries span 16 decades, so that a sum
    in another order gives other bits."""
    rng = np.random.default_rng(100 + r * Q + c)
    v = rng.standard_normal(shape) * 10.0 ** rng.integers(-8, 9, size=shape)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(shape)
    v.flat[0] = -0.0    # the broadcast's x + 0.0 turns it into +0.0
    return torch.as_tensor(v.astype(dtype))


def _verb(spec, P, Q):
    dtype = spec.get("dtype", F64)
    size = P if spec.get("axis") == ROW_AXIS else Q
    xs = cc.per_rank(P, Q, lambda r, c: _rank_value(r, c, Q, dtype, (2 * size, 3)))
    verb, axis = spec["verb"], spec.get("axis")
    if verb == "all_reduce":
        return cc.all_reduce(xs, axis, spec["op"])
    if verb == "bcast":
        return cc.bcast(xs, axis, size - 1)
    if verb == "bcast2d":
        return cc.bcast2d(xs, P - 1, Q - 1)
    if verb == "all_gather":
        return cc.all_gather(xs, axis, tiled=spec.get("tiled", False),
                             concat_axis=1 if spec.get("tiled") else 0)
    if verb == "all_to_all":
        return cc.all_to_all(xs, axis, split_axis=0, concat_axis=1)
    if verb == "send_recv":
        return cc.send_recv(xs, axis, 0, size - 1)
    if verb == "reduce":
        return cc.reduce(xs, axis, size - 1)
    return cc.barrier_value(xs, axis)


def _unported(what, mat, grid, src, nb):
    """Call ``what`` on a grid matrix (its arguments need not make sense:
    the multi-process form must refuse before reading them)."""
    sr = RankIndex2D(*src)
    if what == "gen_to_std":
        return gen_to_std("L", mat, mat)
    if what == "reduction_to_band":
        return reduction_to_band.reduction_to_band(mat)
    if what == "bt_band_to_tridiag":
        return back_transform.bt_band_to_tridiag(None, mat)
    if what == "bt_reduction_to_band":
        return back_transform.bt_reduction_to_band(types.SimpleNamespace(matrix=mat, band=nb),
                                                   mat)
    if what == "permute":
        return permutations.permute("Row", np.arange(2 * nb)[::-1].copy(), mat, 0, 2)
    if what == "general_sub_multiply":
        return general.general_sub_multiply(1.0, mat, mat, 0.0, mat, 0, 2)
    if what == "t_factor":
        v = Matrix.from_global(np.eye(mat.size.row, nb), TileElementSize(nb, nb), grid,
                               source_rank=sr)
        return qr.t_factor(v, np.ones(nb))
    if what == "eigensolver":
        return eigensolver.eigensolver("L", mat)
    if what == "gen_eigensolver":
        return eigensolver.gen_eigensolver("L", mat, mat)
    return mops.transpose(mat)


def run_case(name, grid, setenv, delenv) -> dict:
    """Run case ``name`` on ``grid`` (a single-controller or a
    multi-process grid on the CPU); knobs go through ``setenv``/``delenv``
    (the caller restores them). Returns ``{"mat": Matrix}``, ``"info"``,
    ``"value"``, ``"array"`` or ``"ranks"`` (a nested per-rank list)."""
    spec = CASES[name]
    P, Q, src, n, nb = GRIDS[f"{grid.size.row}x{grid.size.col}"]
    for knob in KNOBS:
        delenv("DLAF_" + knob)
    for k, v in spec.get("knobs", {}).items():
        setenv("DLAF_" + k.upper(), str(v))
    config.initialize()
    sr = RankIndex2D(*src)
    tile = TileElementSize(nb, nb)
    kind = spec["kind"]
    if kind == "cholesky":
        a = hpd(n, spec["dtype"])
        if spec["fail_col"] is not None:
            a[spec["fail_col"], spec["fail_col"]] = -1000.0
        out = cholesky(spec["uplo"], Matrix.from_global(a, tile, grid, source_rank=sr),
                       with_info=spec["with_info"])
        return {"mat": out[0], "info": int(out[1])} if spec["with_info"] else {"mat": out}
    if kind in ("solve", "multiply"):
        side, uplo, op, diag = spec["combo"]
        rng = np.random.default_rng(5)
        a = rng.standard_normal((n, n)) + 2.0 * n * np.eye(n)
        if spec["zero_col"] is not None:
            a[spec["zero_col"], spec["zero_col"]] = 0.0
        b = rng.standard_normal((n, 19) if side == "L" else (19, n))
        am = Matrix.from_global(a.astype(spec["dtype"]), tile, grid, source_rank=sr)
        bm = Matrix.from_global(b.astype(spec["dtype"]), tile, grid, source_rank=sr)
        if kind == "multiply":
            return {"mat": triangular_multiply(side, uplo, op, diag, 0.5, am, bm)}
        out, info = triangular_solve(side, uplo, op, diag, 0.5, am, bm, with_info=True)
        return {"mat": out, "info": int(info)}
    if kind == "norm":
        a = np.random.default_rng(6).standard_normal((n, n + 5))
        if np.dtype(spec["dtype"]).kind == "c":
            a = a * np.exp(1j * np.arange(n + 5))
        mat = Matrix.from_global(a.astype(spec["dtype"]), tile, grid, source_rank=sr)
        return {"value": max_norm(mat, spec["uplo"])}
    if kind == "element_fn":
        return {"mat": Matrix.from_element_fn(
            lambda i, j: torch.cos(i * 0.37) + 3.0 * j / (1.0 + i), GlobalElementSize(n, n + 3),
            tile, grid, dtype=F32, source_rank=sr)}
    if kind == "to_global":
        a = np.random.default_rng(7).standard_normal((n, n + 3))
        return {"array": Matrix.from_global(a, tile, grid, source_rank=sr).to_global()}
    if kind == "verb":
        return {"ranks": _verb(spec, P, Q)}
    if kind == "sync":
        a = np.random.default_rng(8).standard_normal((n, n + 3))
        mat = Matrix.from_global(a, tile, grid, source_rank=sr)
        if spec["what"] == "gather":
            return {"array": torch.as_tensor(sync.gather(mat))}
        x = (mat if spec["what"] == "gather_shards"
             else cc.per_rank(P, Q, lambda r, c: _rank_value(r, c, Q, F64, (2, 3))))
        got = sync.gather_shards(x)
        # every rank's value, then their host fold
        return {"array": torch.as_tensor(np.stack(got + [sync.all_reduce(got, "sum")]))}
    return _unported(spec["what"], Matrix.from_global(hpd(n, F64), tile, grid, source_rank=sr),
                     grid, src, nb)


def _local_result(res: dict) -> dict:
    """What this process's rank holds of a case's result."""
    out = {k: v for k, v in res.items() if k in ("info", "value", "array")}
    if "mat" in res:
        out["shards"] = {f"{i}": s for i, s in enumerate(res["mat"].storage) if s is not None}
    if "ranks" in res:
        Q = len(res["ranks"][0])
        out["shards"] = {f"{r * Q + c}": v for r, row in enumerate(res["ranks"])
                         for c, v in enumerate(row) if v is not None}
    return out


def main(argv) -> int:
    url, rank, world, P, Q, out_dir = argv[:6]
    rank, world, P, Q = int(rank), int(world), int(P), int(Q)
    mode = argv[6] if len(argv) > 6 else "cases"
    multihost.initialize_multihost(url, world, rank, backend="gloo", timeout=120.0)
    if mode == "hang":
        if rank == 1:
            time.sleep(3600)
        torch.distributed.broadcast(torch.zeros(1), src=1)
        return 0
    grid = multihost.multihost_grid(P, Q, device="cpu")

    def setenv(k, v):
        os.environ[k] = v

    for name, spec in CASES.items():
        try:
            res = {"ok": _local_result(run_case(name, grid, setenv,
                                                lambda k: os.environ.pop(k, None)))}
        except NotImplementedError as e:
            res = {"raised": f"NotImplementedError: {e}"}
        except Exception:
            res = {"error": traceback.format_exc()}
        torch.save(res, os.path.join(out_dir, f"{name}.r{rank}.pt"))
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dlaf_tpu"))
    try:   # the two forms never mix: a single-controller grid must raise here
        Grid(P, Q, devices=["cpu"] * (P * Q))
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    torch.save({"modules": loaded, "single_controller_refused": refused},
               os.path.join(out_dir, f"modules.r{rank}.pt"))
    multihost.finalize_multihost()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
