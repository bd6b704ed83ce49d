"""One process of the multi-process tests' ``torch.distributed`` world.

``tests/test_torch_multiprocess.py`` starts one of these per rank of a
P x Q grid, each with a gloo world over a ``file://`` rendezvous:

    python tests/torch_mp_worker.py <init-url> <rank> <world> <P> <Q> <out-dir> [cases|eigen|a2a|hang]

In ``cases`` mode it builds the multi-process grid on the CPU
(:func:`dlaf_tpu_torch.comm.multihost.multihost_grid`), runs every case of
:data:`CASES` through the port's entry points and writes what its rank
holds of each result to ``<out-dir>/<case>.r<rank>.pt``, with its grid
rank and the verb schedule the process issued in a second run of the
case under an armed tape (``analysis.depgraph.Tape(ops=False)``; the
result comes from the first run, with no tape); the test computes the same cases on the single-controller
grid and compares, and holds the schedules of each group equal. The
``autotune`` mode runs :func:`autotune_probe` (a breach and the next
factor under the route autotuner, ``tests/test_torch_autotune.py``). The
``eigen`` mode does the same for :data:`EIGEN_CASES`
(``tests/test_torch_multiprocess_eigen.py``), after :func:`span_probe`, and
the ``a2a`` mode for :data:`A2A_CASES` (the pairwise all-to-all of the
chase back-transform, on the grids of :data:`A2A_GRIDS`). In
``hang`` mode rank 0 waits in a broadcast that rank 1 never joins (the
test of the harness's timeout). This module imports only the port: the
test module imports it for :data:`CASES` and :func:`run_case`.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

import numpy as np
import torch

from dlaf_tpu_torch import config
from dlaf_tpu_torch.algorithms import general, permutations, qr
from dlaf_tpu_torch.algorithms.cholesky import cholesky
from dlaf_tpu_torch.algorithms.gen_to_std import gen_to_std
from dlaf_tpu_torch.algorithms.norm import max_norm
from dlaf_tpu_torch.algorithms.triangular import triangular_multiply, triangular_solve
from dlaf_tpu_torch.analysis import depgraph
from dlaf_tpu_torch.comm import collectives as cc
from dlaf_tpu_torch.comm import multihost, sync
from dlaf_tpu_torch.comm.grid import COL_AXIS, ROW_AXIS, Grid
from dlaf_tpu_torch.common.index2d import GlobalElementSize, RankIndex2D, TileElementSize
from dlaf_tpu_torch.eigensolver import (back_transform, band_to_tridiag, eigensolver,
                                        reduction_to_band)
from dlaf_tpu_torch.eigensolver import tridiag_solver as tsolv
from dlaf_tpu_torch.matrix import ops as mops
from dlaf_tpu_torch.matrix.matrix import Matrix

KNOBS = ("CHOLESKY_TRAILING", "CHOLESKY_LOOKAHEAD", "COMM_LOOKAHEAD", "PANEL_IMPL",
         "STEP_IMPL", "OZAKI_IMPL", "F64_GEMM", "F64_TRSM", "F64_GEMM_MIN_DIM",
         "FORCE_PALLAS_UPDATE", "DIST_STEP_MODE", "SECULAR_DEVICE_MIN_K")

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


def _g2s(dtype, uplo, impl, knobs=None, zero_col=None):
    return dict(kind="gen_to_std", dtype=dtype, uplo=uplo,
                knobs={"hegst_impl": impl, **(knobs or {})}, zero_col=zero_col)


#: Every case, by name: the Cholesky on each route and knob, the triangular
#: solve and multiply, max_norm, the matrix constructors, the verbs (and
#: the host arrays' broadcast), the transposed tiles, HEGST (both forms,
#: with info), the QR T factor, permute and general_sub_multiply.
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
    "verb-bcast-transposed-row": dict(kind="verb", verb="bcast", axis=ROW_AXIS, transposed=True),
    "verb-sum-transposed-col": dict(kind="verb", verb="all_reduce", axis=COL_AXIS, op="sum",
                                    transposed=True),
    "verb-scatter": dict(kind="verb", verb="scatter"),
    "verb-gather-ragged": dict(kind="verb", verb="gather"),
    "verb-exchange": dict(kind="verb", verb="exchange"),
    "verb-bcast_arrays": dict(kind="verb", verb="bcast_arrays", dtype=F64),
    "verb-bcast_arrays-z-transposed": dict(kind="verb", verb="bcast_arrays", dtype=C128,
                                           transposed=True),
    "from_global-root": dict(kind="from_global_root"),
    "gather_global": dict(kind="gather_global"),
    "transpose-d": dict(kind="transpose", dtype=F64, conj=False),
    "transpose-z-conj": dict(kind="transpose", dtype=C128, conj=True),
    "hermitianize-d-L": dict(kind="hermitianize", dtype=F64, uplo="L"),
    "hermitianize-z-U": dict(kind="hermitianize", dtype=C128, uplo="U"),
    "g2s-blocked-d-L": _g2s(F64, "L", "blocked"),
    "g2s-blocked-d-U": _g2s(F64, "U", "blocked"),
    "g2s-blocked-z-L": _g2s(C128, "L", "blocked"),
    "g2s-blocked-z-U": _g2s(C128, "U", "blocked"),
    "g2s-blocked-s-L-fused": _g2s(F32, "L", "blocked", {"panel_impl": "fused"}),
    "g2s-blocked-la-d-L": _g2s(F64, "L", "blocked", LA),
    "g2s-blocked-la-z-U": _g2s(C128, "U", "blocked", LA),
    "g2s-blocked-mxu-d-L": _g2s(F64, "L", "blocked", OZ7),
    "g2s-twosolve-d-L": _g2s(F64, "L", "twosolve"),
    "g2s-twosolve-d-U": _g2s(F64, "U", "twosolve"),
    "g2s-twosolve-z-L": _g2s(C128, "L", "twosolve"),
    "g2s-twosolve-z-U": _g2s(C128, "U", "twosolve"),
    "g2s-info-d-L": _g2s(F64, "L", "blocked", zero_col=20),
    "g2s-info-ok-z-U": _g2s(C128, "U", "twosolve", zero_col=-1),
    "t_factor-d": dict(kind="t_factor", dtype=F64),
    "t_factor-z": dict(kind="t_factor", dtype=C128),
    "permute-Row": dict(kind="permute", coord="Row"),
    "permute-Col": dict(kind="permute", coord="Col"),
    "general_sub_multiply": dict(kind="gsm", knobs={}),
    "general_sub_multiply-mxu": dict(kind="gsm", knobs=OZ7),
}

BAND = 4

#: The eigensolver pipeline's cases (``tests/test_torch_multiprocess_eigen.py``
#: runs them in worlds of their own): reduction to band, the band's
#: gather, both back-transforms and the two drivers.
EIGEN_CASES = {
    "red2band-d": dict(kind="red2band", dtype=F64, knobs={"dist_step_mode": "unrolled"}),
    "red2band-z": dict(kind="red2band", dtype=C128, knobs={"dist_step_mode": "unrolled"}),
    "red2band-la-d": dict(kind="red2band", dtype=F64,
                          knobs={"dist_step_mode": "unrolled", "comm_lookahead": 1}),
    "red2band-scan-d": dict(kind="red2band", dtype=F64, knobs={"dist_step_mode": "scan"}),
    "red2band-scan-z": dict(kind="red2band", dtype=C128, knobs={"dist_step_mode": "scan"}),
    "red2band-mxu-d": dict(kind="red2band", dtype=F64,
                           knobs={"dist_step_mode": "unrolled", **OZ7}),
    "extract_band-d": dict(kind="extract_band", dtype=F64),
    "bt_r2b-d": dict(kind="bt_r2b", dtype=F64, knobs={"dist_step_mode": "unrolled"}),
    "bt_r2b-scan-z": dict(kind="bt_r2b", dtype=C128, knobs={"dist_step_mode": "scan"}),
    "bt_b2t-d": dict(kind="bt_b2t", dtype=F64),
    "bt_b2t-z": dict(kind="bt_b2t", dtype=C128),
    "evp-d-L": dict(kind="evp", dtype=F64, uplo="L"),
    "evp-z-U": dict(kind="evp", dtype=C128, uplo="U"),
    "evp-scan-d-L": dict(kind="evp", dtype=F64, uplo="L", knobs={"dist_step_mode": "scan"}),
    "gen_evp-d-L": dict(kind="gen_evp", dtype=F64, uplo="L"),
    "gen_evp-z-U": dict(kind="gen_evp", dtype=C128, uplo="U"),
    # the D&C's sharded merges (``shard_min`` lowers the threshold for the
    # call): the solver alone on a seeded tridiagonal of order DC_N, by the
    # host and the device secular routes, and both eigensolvers
    "dc-sharded-host": dict(kind="dc", shard_min=24, knobs={}),
    "dc-sharded-device": dict(kind="dc", shard_min=24, knobs={"secular_device_min_k": 8}),
    "evp-sharded-d-L": dict(kind="evp", dtype=F64, uplo="L", shard_min=16),
    "gen_evp-sharded-z-U": dict(kind="gen_evp", dtype=C128, uplo="U", shard_min=16,
                                knobs={"secular_device_min_k": 8}),
}

#: Order of the "dc" cases' tridiagonal.
DC_N = 100

#: The worlds of the multi-process all-to-all (pairwise, each peer gets its
#: chunk only): 2x2, and three ranks along the row axis, along which the
#: chase back-transform exchanges (a 1x3 row line holds one rank).
A2A_GRIDS = {"2x2": GRIDS["2x2"], "3x1": (3, 1, (2, 0), 40, 8)}

#: The all-to-all's cases: the chase back-transform in float64 and
#: complex128, and the verb itself along the row axis.
A2A_CASES = {
    "a2a-bt_b2t-d": dict(kind="bt_b2t", dtype=F64),
    "a2a-bt_b2t-z": dict(kind="bt_b2t", dtype=C128),
    "verb-all_to_all-row": dict(kind="verb", verb="all_to_all", axis=ROW_AXIS),
    "verb-all_to_all-row-z": dict(kind="verb", verb="all_to_all", axis=ROW_AXIS, dtype=C128),
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
    if spec.get("transposed"):
        # dense values in another layout (a solve's output is often one):
        # every receiver must get the sender's layout, as a copy keeps it
        xs = cc.per_rank(P, Q, lambda r, c: xs[r][c].reshape(3, 2, size).mT)
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


def run_case(name, grid, setenv, delenv) -> dict:
    """Run case ``name`` on ``grid`` (a single-controller or a
    multi-process grid on the CPU); knobs go through ``setenv``/``delenv``
    (the caller restores them). Returns ``{"mat": Matrix}``, ``"info"``,
    ``"value"``, ``"array"`` or ``"ranks"`` (a nested per-rank list)."""
    spec = {**CASES, **EIGEN_CASES, **A2A_CASES}[name]
    P, Q, src, n, nb = {**GRIDS, **A2A_GRIDS}[f"{grid.size.row}x{grid.size.col}"]
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
    if kind == "verb" and spec["verb"] in ("scatter", "gather", "exchange", "bcast_arrays"):
        return _verb_more(spec, P, Q)
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
    return _more(spec, grid, sr, tile, P, Q, n, nb)


def herm(n, dtype, seed=4):
    """A Hermitian matrix (both triangles), seeded."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((n, n))
    return ((x + x.conj().T) / 2).astype(dtype)


def stored(a, uplo):
    """``a`` with junk in the triangle ``uplo`` does not store."""
    keep = np.tril(np.ones(a.shape, bool)) if uplo == "L" else np.triu(np.ones(a.shape, bool))
    return np.where(keep, a, 7.0).astype(a.dtype)


def _root(P, Q):
    """The rank a root-form case scatters from or gathers to: not (0, 0)."""
    return RankIndex2D(P - 1, 0) if P > 1 else RankIndex2D(0, Q - 1)


def _verb_more(spec, P, Q):
    """The scatter from, the ragged gather to one rank (not (0, 0)), a
    pairwise exchange whose every pair moves a value of its own shape, and
    host arrays of one rank's process on every process (its ``-0.0``
    kept, in its layout)."""
    verb = spec["verb"]
    own = _root(P, Q)
    if verb == "bcast_arrays":
        first = _rank_value(own.row, own.col, Q, spec["dtype"], (4, 3)).numpy()
        if spec.get("transposed"):
            first = first.reshape(3, 4).T
        mine = [first, np.arange(-3, 5, dtype=np.int64)]
        got = cc.bcast_arrays(mine if cc.is_local(own.row, own.col) else None, own.row,
                              own.col, [(x.shape, x.dtype) for x in mine])
        return {"ranks": cc.per_rank(P, Q, lambda r, c: torch.from_numpy(got[0])),
                "array": torch.from_numpy(got[1])}
    if verb == "scatter":
        like = cc.per_rank(P, Q, lambda r, c: torch.zeros((3, 2), dtype=torch.float64))
        parts = ([[_rank_value(r, c, Q, F64, (3, 2)) for c in range(Q)] for r in range(P)]
                 if cc.is_local(own.row, own.col) else None)
        return {"ranks": cc.scatter(parts, own.row, own.col, like)}
    if verb == "gather":
        got = cc.gather(cc.per_rank(P, Q, lambda r, c: _rank_value(
            r, c, Q, C128, (1 + (r * Q + c) % 3, 2))), own.row, own.col)
        return {"root_array": None if got is None else torch.cat([v for row in got
                                                                  for v in row])}

    def shape(a, b):
        return (1 + (a[0] + a[1] + 2 * b[0] + b[1]) % 3, 3)

    every = [(r, c) for r in range(P) for c in range(Q)]
    sends = cc.per_rank(P, Q, lambda r, c: {
        d: _rank_value(r, c, Q, F64, shape((r, c), d)) * (1 + d[0] * Q + d[1])
        for d in every if d != (r, c)})
    expect = cc.per_rank(P, Q, lambda r, c: {
        s_: torch.empty(shape(s_, (r, c)), dtype=torch.float64) for s_ in every if s_ != (r, c)})
    got = cc.exchange(sends, expect)
    return {"ranks": cc.per_rank(P, Q, lambda r, c: torch.cat(
        [got[r][c][k] for k in sorted(got[r][c])]))}


def _more(spec, grid, sr, tile, P, Q, n, nb) -> dict:
    """The cases of the matrix ops, HEGST, the QR T factor, permute,
    general_sub_multiply and (:data:`EIGEN_CASES`) the eigensolver
    pipeline."""
    kind = spec["kind"]
    dtype = spec.get("dtype", F64)

    def mat(a):
        return Matrix.from_global(a, tile, grid, source_rank=sr)

    if kind in ("from_global_root", "gather_global"):
        a = np.random.default_rng(9).standard_normal((n, n + 3))
        own = _root(P, Q)
        if kind == "gather_global":
            got = mat(a).gather_global(own)
            return {"root_array": got}
        mine = a if grid.is_local(own.row, own.col) else None
        return {"mat": Matrix.from_global(mine, tile, grid, source_rank=sr, root=own,
                                          size=GlobalElementSize(n, n + 3), dtype=F64)}
    if kind == "transpose":
        return {"mat": mops.transpose(mat(hpd(n, dtype) + np.triu(herm(n, dtype), 1)),
                                      conj=spec["conj"])}
    if kind == "hermitianize":
        return {"mat": mops.hermitianize(mat(herm(n, dtype)), spec["uplo"])}
    if kind == "gen_to_std":
        uplo = spec["uplo"]
        b = hpd(n, dtype, seed=11)
        if spec["zero_col"] is not None and spec["zero_col"] >= 0:
            b[spec["zero_col"], spec["zero_col"]] = -1000.0
        bf = cholesky(uplo, mat(b))
        out = gen_to_std(uplo, mat(stored(herm(n, dtype), uplo)), bf,
                         with_info=spec["zero_col"] is not None)
        if spec["zero_col"] is not None:
            return {"mat": out[0], "info": int(out[1])}
        return {"mat": out}
    if kind == "t_factor":
        rng = np.random.default_rng(12)
        k = nb - 3
        v = rng.standard_normal((n, k))
        taus = 1.0 + rng.random(k)
        if np.dtype(dtype).kind == "c":
            v = v + 1j * rng.standard_normal((n, k))
            taus = taus + 0.5j * rng.random(k)
        vm = Matrix.from_global(v.astype(dtype), tile, grid, source_rank=sr)
        return {"array": qr.t_factor(vm, taus.astype(dtype))}
    if kind == "permute":
        perm = np.random.default_rng(13).permutation(3 * nb)
        a = np.random.default_rng(14).standard_normal((n, n + 3))
        return {"mat": permutations.permute(spec["coord"], perm, mat(a), 1, 4)}
    if kind == "gsm":
        rng = np.random.default_rng(15)
        a, b, c = (rng.standard_normal((n, n)) for _ in range(3))
        return {"mat": general.general_sub_multiply(0.5, mat(a), mat(b), -1.5, mat(c), 1, 4)}
    return _eigen(spec, mat, n, grid, nb)


def _band_input(n, dtype):
    """A seeded ``(BAND + 1, n)`` lower band for the chase."""
    rng = np.random.default_rng(16)
    band = rng.standard_normal((BAND + 1, n))
    if np.dtype(dtype).kind == "c":
        band = band + 1j * rng.standard_normal((BAND + 1, n))
        band[0] = band[0].real
    return band.astype(dtype)


def _eigen(spec, mat, n, grid=None, nb=None) -> dict:
    """The cases of :data:`EIGEN_CASES`; ``mat`` tiles a host array onto
    the grid. ``shard_min`` sets the D&C's sharding threshold for the
    call."""
    saved = tsolv._SHARD_MERGE_MIN_N
    tsolv._SHARD_MERGE_MIN_N = spec.get("shard_min", saved)
    try:
        return _eigen_cases(spec, mat, n, grid, nb)
    finally:
        tsolv._SHARD_MERGE_MIN_N = saved


def dc_tridiag():
    """The "dc" cases' seeded tridiagonal ``(d, e)``: a random part, then
    a Toeplitz (2, 1) part whose merges deflate by rotations."""
    rng = np.random.default_rng(21)
    d, e = rng.standard_normal(DC_N), rng.standard_normal(DC_N - 1)
    d[DC_N // 2:], e[DC_N // 2:] = 2.0, 1.0
    return d, e


def _eigen_cases(spec, mat, n, grid, nb) -> dict:
    kind = spec["kind"]
    if kind == "dc":
        d, e = dc_tridiag()
        lam, q = tsolv.tridiag_solver(d, e, nb, grid=grid)
        return {"array": torch.as_tensor(lam), "ranks": q.blocks}
    dtype = spec["dtype"]
    uplo = spec.get("uplo", "L")
    if kind in ("red2band", "extract_band", "bt_r2b"):
        red = reduction_to_band.reduction_to_band(mat(herm(n, dtype)), band_size=BAND)
        if kind == "red2band":
            return {"mat": red.matrix, "array": red.taus}
        if kind == "extract_band":
            band = reduction_to_band.extract_band(red)
            return {"root_array": None if band is None else torch.as_tensor(band)}
        c = np.random.default_rng(17).standard_normal((n, n - 5)).astype(dtype)
        return {"mat": back_transform.bt_reduction_to_band(red, mat(c))}
    if kind == "bt_b2t":
        tri = band_to_tridiag.band_to_tridiag(_band_input(n, dtype), BAND)
        e = np.random.default_rng(18).standard_normal((n, n - 5))
        return {"mat": back_transform.bt_band_to_tridiag(tri, mat(e))}
    a = mat(stored(herm(n, dtype), uplo))
    if kind == "evp":
        res = eigensolver.eigensolver(uplo, a, band_size=BAND)
    else:
        res = eigensolver.gen_eigensolver(uplo, a, mat(stored(hpd(n, dtype, seed=19), uplo)),
                                          band_size=BAND)
    return {"mat": res.eigenvectors, "array": torch.as_tensor(res.eigenvalues)}


def a2a_traffic_probe(grid, setenv, delenv) -> list:
    """Run the all-to-all verb and the chase back-transform ("a2a-bt_b2t-d")
    with ``cc._transport`` watched. Returns one entry per ``cc.all_to_all``
    call: the axis' rank count, the bytes of this process's value, and the
    ``(kind, bytes received)`` of every transport call made inside it."""
    calls, inside = [], []
    saved_transport, saved_a2a = cc._transport, cc.all_to_all

    def nbytes(out):
        if isinstance(out, torch.Tensor):
            return out.numel() * out.element_size()
        vals = out.values() if isinstance(out, dict) else out or []
        return sum(nbytes(v) for v in vals)

    def transport(kind, x, group, *args, **kwargs):
        out = saved_transport(kind, x, group, *args, **kwargs)
        if inside:
            inside[-1]["moves"].append((kind, nbytes(out)))
        return out

    def all_to_all(xs, axis, **kwargs):
        r, c = cc.local_ranks(*cc.grid_shape(xs))[0]
        P, Q = cc.grid_shape(xs)
        inside.append({"size": P if axis == ROW_AXIS else Q,
                       "value": nbytes(xs[r][c]), "moves": []})
        try:
            return saved_a2a(xs, axis, **kwargs)
        finally:
            calls.append(inside.pop())

    cc._transport, cc.all_to_all = transport, all_to_all
    try:
        for name in ("verb-all_to_all-row", "a2a-bt_b2t-d"):
            run_case(name, grid, setenv, delenv)
    finally:
        cc._transport, cc.all_to_all = saved_transport, saved_a2a
    return calls


def span_probe(grid, setenv, delenv) -> dict:
    """Run case "evp-d-L" with the chase, the D&C and every tensor this
    process creates watched: the calls of ``band_to_tridiag`` and
    ``tridiag_solver``, and the largest floating-point tensor (in
    elements) created from the band's gather to Q's scatter (the call of
    ``extract_band`` to that of ``bt_band_to_tridiag``)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    state = {"on": False, "largest": 0, "chase": 0, "dc": 0}
    mod = eigensolver
    saved = {k: getattr(mod, k) for k in ("extract_band", "bt_band_to_tridiag",
                                          "band_to_tridiag", "tridiag_solver")}

    def watch(name, before):
        def fn(*args, **kwargs):
            before()
            return saved[name](*args, **kwargs)
        return fn

    class Track(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if state["on"]:
                for t in tree_leaves(out):
                    if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()):
                        state["largest"] = max(state["largest"], t.numel())
            return out

    mod.extract_band = watch("extract_band", lambda: state.update(on=True))
    mod.bt_band_to_tridiag = watch("bt_band_to_tridiag", lambda: state.update(on=False))
    mod.band_to_tridiag = watch("band_to_tridiag", lambda: state.update(chase=state["chase"] + 1))
    mod.tridiag_solver = watch("tridiag_solver", lambda: state.update(dc=state["dc"] + 1))
    try:
        with Track():
            res = run_case("evp-d-L", grid, setenv, delenv)
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)
    return {**state, "eigenvalues": res["array"]}


def dc_peak_probe(grid, setenv, delenv) -> dict:
    """Run case "dc-sharded-device" with every tensor this process creates
    watched: the largest floating-point tensor, in elements, against the
    tridiagonal's order."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    state = {"largest": 0}

    class Track(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()):
                    state["largest"] = max(state["largest"], t.numel())
            return out

    with Track():
        run_case("dc-sharded-device", grid, setenv, delenv)
    return {**state, "n": DC_N}


def autotune_probe(grid, out_dir, rank) -> dict:
    """Under ``DLAF_AUTOTUNE=1`` (records to ``at.r<rank>.jsonl``, the table
    to ``table.json``): a Cholesky of a NaN-poisoned copy (a breach), then
    the clean factor under the escalated route. Returns the factor and
    whether this process writes the table."""
    from dlaf_tpu_torch import autotune, obs
    from dlaf_tpu_torch.health import inject

    P, Q, src, n, nb = GRIDS[f"{grid.size.row}x{grid.size.col}"]
    for k, v in (("DLAF_AUTOTUNE", "1"), ("DLAF_LOG", "off"),
                 ("DLAF_METRICS_PATH", os.path.join(out_dir, "at.r%r.jsonl")),
                 ("DLAF_AUTOTUNE_TABLE", os.path.join(out_dir, "table.json"))):
        os.environ[k] = v
    config.initialize()
    mat = Matrix.from_global(hpd(n, F64), TileElementSize(nb, nb), grid,
                             source_rank=RankIndex2D(*src))
    cholesky("L", inject.nan_tile(mat, tile=(1, 0), element=(2, 3)))
    out = cholesky("L", mat)
    obs.flush()
    return {"mat": out, "value": float(autotune.get_table().writer)}


def _local_result(res: dict) -> dict:
    """What this process's rank holds of a case's result."""
    out = {k: v for k, v in res.items() if k in ("info", "value", "array", "root_array")}
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

    if mode == "autotune":
        torch.save(_local_result(autotune_probe(grid, out_dir, rank)),
                   os.path.join(out_dir, f"autotune.r{rank}.pt"))
        multihost.finalize_multihost()
        return 0
    cases = {"eigen": EIGEN_CASES, "a2a": A2A_CASES}.get(mode, CASES)
    if mode == "a2a":
        torch.save(a2a_traffic_probe(grid, setenv, lambda k: os.environ.pop(k, None)),
                   os.path.join(out_dir, f"traffic.r{rank}.pt"))
    if mode == "eigen":
        torch.save(span_probe(grid, setenv, lambda k: os.environ.pop(k, None)),
                   os.path.join(out_dir, f"span.r{rank}.pt"))
        torch.save(dc_peak_probe(grid, setenv, lambda k: os.environ.pop(k, None)),
                   os.path.join(out_dir, f"dcpeak.r{rank}.pt"))
    for name, spec in cases.items():
        try:
            res = {"ok": _local_result(run_case(name, grid, setenv,
                                                lambda k: os.environ.pop(k, None)))}
        except Exception:
            res = {"error": traceback.format_exc()}
        # the verbs this process issues, for graph-conditional-collective,
        # from a second run under an armed tape: the result above comes
        # from the path that runs with no tape
        tape = depgraph.Tape("cpu", ops=False)
        try:
            with tape.armed():
                run_case(name, grid, setenv, lambda k: os.environ.pop(k, None))
        except Exception:
            res.setdefault("error", traceback.format_exc())
        res["schedule"] = tape.schedule
        res["grid_rank"] = tuple(grid.local_ranks[0])
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
