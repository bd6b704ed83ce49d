"""Distributed triangular solve and multiply of the PyTorch port against
the JAX reference, unrolled and scan (``dist_step_mode``).

The reference's test operands (``test_torch_triangular.make_ab``: ragged
sizes, nonzero source ranks) go onto the same grid in both packages: the
reference's ``shard_map`` programs on the virtual CPU mesh, the port's
per-rank loops with every rank on the CPU (the strip-solve wrapper runs
its plain version with ``panel_impl=fused``). Tolerance: the reference's
own test bound, ``rtol = atol = 500 eps`` of the type, against the
reference's result and numpy. Within the port the scan solve's lookahead
is bitwise, as the reference pins it.
"""

import contextlib
import io

import numpy as np
import pytest

from dlaf_tpu import config as jcfg
from dlaf_tpu.algorithms.triangular import triangular_multiply as j_mult
from dlaf_tpu.algorithms.triangular import triangular_solve as j_solve
from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu.common.index2d import RankIndex2D as JRankIndex2D
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu.tile_ops import pallas_panel as jppan
from dlaf_tpu_torch import config
from dlaf_tpu_torch.algorithms.triangular import triangular_multiply, triangular_solve
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.asserts import DlafAssertError
from dlaf_tpu_torch.common.index2d import RankIndex2D, TileElementSize
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.miniapp import miniapp_triangular_solver
from dlaf_tpu_torch.tile_ops import mixed as mx
from dlaf_tpu_torch.tile_ops import ozaki_kernels as ok
from dlaf_tpu_torch.tile_ops import panel_kernels as pk
from test_torch_triangular import SMALL, make_ab, np_op, np_tri, tol

KNOBS = ("DIST_STEP_MODE", "CHOLESKY_LOOKAHEAD", "COMM_LOOKAHEAD", "PANEL_IMPL", "F64_GEMM",
         "F64_TRSM", "F64_GEMM_MIN_DIM", "OZAKI_IMPL")


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    jcfg.initialize()
    yield
    for knob in KNOBS:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    jcfg.initialize()


def set_knobs(monkeypatch, knobs):
    for k, v in knobs.items():
        monkeypatch.setenv("DLAF_" + k.upper(), str(v))
    config.initialize()
    jcfg.initialize()


def counting(monkeypatch, module, name, when=None):
    calls = [0]
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        calls[0] += when is None or bool(when(*args))
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapper)
    return calls


def port_mats(a, b, nb, P, Q, src):
    grid = shared_grid(P, Q, "cpu")
    return (Matrix.from_global(a, TileElementSize(nb, nb), grid, source_rank=RankIndex2D(*src)),
            Matrix.from_global(b, TileElementSize(nb, nb), grid, source_rank=RankIndex2D(*src)))


def jax_mats(a, b, nb, P, Q, src, devices8):
    grid = JGrid(P, Q, devices=devices8[:P * Q])
    return (JMatrix.from_global(a, JTileElementSize(nb, nb), grid=grid,
                                source_rank=JRankIndex2D(*src)),
            JMatrix.from_global(b, JTileElementSize(nb, nb), grid=grid,
                                source_rank=JRankIndex2D(*src)))


def want(kind, a, b, combo, alpha):
    side, uplo, op, diag = combo
    t = np_op(np_tri(a, uplo, diag), op)
    if kind == "solve":
        return np.linalg.solve(t, alpha * b) if side == "L" else (alpha * b) @ np.linalg.inv(t)
    return alpha * (t @ b if side == "L" else b @ t)


def run_both(kind, combo, alpha, a, b, nb, P, Q, src, devices8):
    jfn, pfn = (j_solve, triangular_solve) if kind == "solve" else (j_mult, triangular_multiply)
    ref = np.asarray(jfn(*combo, alpha, *jax_mats(a, b, nb, P, Q, src, devices8)).to_numpy())
    got = pfn(*combo, alpha, *port_mats(a, b, nb, P, Q, src)).to_numpy()
    return ref, got


MULT = [("L", "L", "N", "N"), ("L", "U", "C", "U"), ("R", "U", "N", "N"),
        ("R", "L", "T", "U"), ("L", "U", "N", "N"), ("R", "L", "N", "U")]
# (mode, grid, dtype): the reference's grids, source rank (1 % P, 1 % Q)
SOLVE_CASES = ([("unrolled", (2, 4), np.float64, c) for c in SMALL]
               + [("scan", (4, 2), np.float64, c) for c in SMALL]
               + [("unrolled", (2, 2), np.complex128, c) for c in SMALL[2:5]]
               + [("scan", (2, 4), np.complex128, c) for c in SMALL[5:8]]
               + [("scan", (2, 2), np.float32, c) for c in SMALL[::3]])
MULT_CASES = ([("unrolled", (2, 4), np.float64, c) for c in MULT]
              + [("scan", (4, 2), np.float64, c) for c in MULT]
              + [("scan", (2, 4), np.complex128, c) for c in MULT[::2]]
              + [("unrolled", (2, 2), np.float32, c) for c in MULT[1::2]])


def case_id(c):
    return f"{c[0]}-{c[1][0]}x{c[1][1]}-{np.dtype(c[2]).name}-{''.join(c[3])}"


@pytest.mark.parametrize("mode,grid,dtype,combo", SOLVE_CASES, ids=[case_id(c)
                                                                    for c in SOLVE_CASES])
def test_solve_dist_matches_reference(mode, grid, dtype, combo, monkeypatch, devices8):
    """Ragged in both dimensions (19 x 13, nb=4), forward and backward
    sweeps, the transposed exchanges for op != 'N'."""
    set_knobs(monkeypatch, {"dist_step_mode": mode})
    a, b = make_ab(19, 13, dtype, combo[0], seed=7)
    ref, got = run_both("solve", combo, 2.0, a, b, 4, *grid, (1 % grid[0], 1 % grid[1]),
                        devices8)
    np.testing.assert_allclose(got, ref, **tol(dtype))
    np.testing.assert_allclose(got, want("solve", a, b, combo, 2.0), **tol(dtype))


@pytest.mark.parametrize("mode,grid,dtype,combo", MULT_CASES, ids=[case_id(c)
                                                                   for c in MULT_CASES])
def test_multiply_dist_matches_reference(mode, grid, dtype, combo, monkeypatch, devices8):
    set_knobs(monkeypatch, {"dist_step_mode": mode})
    a, b = make_ab(19, 13, dtype, combo[0], seed=9)
    ref, got = run_both("mult", combo, 0.5, a, b, 4, *grid, (1 % grid[0], 1 % grid[1]),
                        devices8)
    np.testing.assert_allclose(got, ref, **tol(dtype))
    np.testing.assert_allclose(got, want("mult", a, b, combo, 0.5), **tol(dtype))


@pytest.mark.parametrize("mode", ["unrolled", "scan"])
@pytest.mark.parametrize("combo", SMALL, ids=lambda c: "".join(c))
def test_solve_dist_mixed_trsm_knob(combo, mode, monkeypatch):
    """``f64_trsm=mixed`` with ``f64_gemm=mxu``: the panel solves through
    the refined inverse, applications and bulk on the Ozaki route; the
    result stays float64-grade (the reference's test and bound)."""
    set_knobs(monkeypatch, {"f64_trsm": "mixed", "f64_gemm": "mxu", "f64_gemm_min_dim": 4,
                            "dist_step_mode": mode})
    a, b = make_ab(16, 12, np.float64, combo[0], seed=7)
    mixed = counting(monkeypatch, mx, "tri_inv_refined")
    got = triangular_solve(*combo, 1.0, *port_mats(a, b, 4, 2, 4, (1, 1))).to_numpy()
    assert mixed[0] > 0
    np.testing.assert_allclose(got, want("solve", a, b, combo, 1.0), **tol(np.float64))


def test_solve_dist_mixed_matches_reference(monkeypatch, devices8):
    set_knobs(monkeypatch, {"f64_trsm": "mixed", "f64_gemm": "mxu", "f64_gemm_min_dim": 4})
    combo = ("R", "U", "C", "N")
    a, b = make_ab(16, 12, np.float64, "R", seed=7)
    ref, got = run_both("solve", combo, 1.0, a, b, 4, 2, 4, (1, 1), devices8)
    np.testing.assert_allclose(got, ref, **tol(np.float64))


@pytest.mark.parametrize("mode", ["unrolled", "scan"])
def test_solve_dist_edge_tiles(mode, monkeypatch, devices8):
    set_knobs(monkeypatch, {"dist_step_mode": mode})
    a, b = make_ab(13, 9, np.float64, "L", seed=5)
    ref, got = run_both("solve", ("L", "L", "N", "N"), 1.0, a, b, 4, 2, 4, (0, 0), devices8)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **tol(np.float64))
    np.testing.assert_allclose(got, np.linalg.solve(np.tril(a), b), **tol(np.float64))


def test_solve_dist_misaligned_sources_raise():
    """A and B at different source ranks address different global tiles at
    one local slot: the solve and multiply raise instead of giving wrong
    numbers (side 'R' checks the columns only)."""
    n, nb = 16, 4
    rng = np.random.default_rng(0)
    t = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
    b = rng.standard_normal((n, n))
    grid = shared_grid(2, 4, "cpu")
    am = Matrix.from_global(t, TileElementSize(nb, nb), grid, source_rank=RankIndex2D(1, 1))
    bm = Matrix.from_global(b, TileElementSize(nb, nb), grid)
    with pytest.raises(DlafAssertError, match="row slots misaligned"):
        triangular_solve("L", "L", "N", "N", 1.0, am, bm)
    with pytest.raises(DlafAssertError, match="col slots misaligned"):
        triangular_solve("R", "L", "C", "N", 1.0, am, bm)
    with pytest.raises(DlafAssertError, match="misaligned"):
        triangular_multiply("L", "L", "N", "N", 1.0, am, bm)


@pytest.mark.parametrize("combo", [("L", "L", "N", "N"), ("R", "U", "C", "N"),
                                   ("L", "U", "T", "N"), ("R", "L", "N", "N"),
                                   ("L", "U", "N", "N")],
                         ids=lambda c: "".join(c))
def test_solve_scan_lookahead_bitwise(combo, monkeypatch):
    """The pipelined scan solve (deferred bulk, eager next-pivot strip)
    against the serial scan body, bit for bit, at nt = 11 over several
    telescope windows on an offset grid, forward and backward sweeps on
    both sides; comm_lookahead changes nothing."""
    side = combo[0]
    a, b = make_ab(44 if side == "L" else 12, 12 if side == "L" else 44, np.float64, side,
                   seed=13)
    res = {}
    for la, comm in (("0", "0"), ("1", "0"), ("1", "1")):
        set_knobs(monkeypatch, {"dist_step_mode": "scan", "cholesky_lookahead": la,
                                "comm_lookahead": comm})
        res[la, comm] = triangular_solve(*combo, 1.0,
                                         *port_mats(a, b, 4, 2, 4, (1, 2))).to_numpy()
    np.testing.assert_array_equal(res["1", "0"], res["0", "0"])
    np.testing.assert_array_equal(res["1", "1"], res["0", "0"])
    np.testing.assert_allclose(res["1", "0"], want("solve", a, b, combo, 1.0),
                               **tol(np.float64))


@pytest.mark.parametrize("mode", ["unrolled", "scan"])
@pytest.mark.parametrize("combo", [("L", "L", "N", "N"), ("R", "U", "C", "N")],
                         ids=lambda c: "".join(c))
def test_fused_strip_solve_route(combo, mode, monkeypatch, devices8):
    """float32 with ``panel_impl=fused``: every rank's pivot solve goes
    through the strip-solve kernel's plain version (the reference through
    its Pallas kernel in interpret mode), once per rank per step, the
    count ``chip_smoke.py`` asserts (P*Q*nt)."""
    set_knobs(monkeypatch, {"panel_impl": "fused", "dist_step_mode": mode})
    a, b = make_ab(24, 16, np.float32, combo[0], seed=3)
    j_calls = counting(monkeypatch, jppan, "fused_panel_solve")
    # a left-side solve runs as the right-side one transposed: count that
    p_calls = counting(monkeypatch, pk, "panel_solve_plain", when=lambda side, *_: side == "R")
    ref, got = run_both("solve", combo, 1.0, a, b, 4, 2, 2, (1, 0), devices8)
    nt = 24 // 4 if combo[0] == "L" else 16 // 4
    assert j_calls[0] > 0 and p_calls[0] == 2 * 2 * nt
    np.testing.assert_allclose(got, ref, **tol(np.float32))
    np.testing.assert_allclose(got, want("solve", a, b, combo, 1.0), **tol(np.float32))


def test_ozaki_launch_formula_on_cpu(monkeypatch):
    """trsm-d-mxu's count in ``chip_smoke.py``: a slice product for the
    mixed panel solve on every rank at every step, and one for the bulk on
    every rank at every step but the last (forward, uniform slots)."""
    set_knobs(monkeypatch, {"f64_trsm": "mixed", "f64_gemm": "mxu", "f64_gemm_min_dim": 4,
                            "ozaki_impl": "pallas", "dist_step_mode": "unrolled"})
    calls = counting(monkeypatch, ok, "ozaki_product_plain")
    a, b = make_ab(32, 32, np.float64, "L", seed=1)
    triangular_solve("L", "L", "N", "N", 1.0, *port_mats(a, b, 4, 2, 2, (0, 0)))
    nt = 8
    assert calls[0] == 4 * nt + 4 * (nt - 1)


@pytest.mark.parametrize("diag", ["N", "U"])
def test_with_info_on_grid(diag, monkeypatch, devices8):
    """The singular-diagonal info read from A's shards, as the reference's
    from its sharded storage; the solution bitwise the same without it."""
    a, b = make_ab(19, 13, np.float64, "L", seed=2)
    a[9, 9] = 0.0
    combo = ("L", "L", "T", diag)
    jm = jax_mats(a, b, 4, 2, 4, (1, 1), devices8)
    _, jinfo = j_solve(*combo, 1.0, *jm, with_info=True)
    am, bm = port_mats(a, b, 4, 2, 4, (1, 1))
    x, info = triangular_solve(*combo, 1.0, am, bm, with_info=True)
    assert int(info) == int(jinfo) == (10 if diag == "N" else 0)
    plain = triangular_solve(*combo, 1.0, am, bm)
    np.testing.assert_array_equal(x.to_numpy(), plain.to_numpy())


def test_resolve_step_mode(monkeypatch):
    """auto: scan from 128 steps on cpu and, by the cpu rule, on cuda;
    explicit values pass through."""
    assert config.resolve_step_mode(127, "cpu") == "unrolled"
    assert config.resolve_step_mode(128, "cpu") == "scan"
    assert config.resolve_step_mode(127, "cuda") == "unrolled"
    assert config.resolve_step_mode(128, "cuda") == "scan"
    set_knobs(monkeypatch, {"dist_step_mode": "scan"})
    assert config.resolve_step_mode(2, "cuda") == "scan"


@pytest.mark.parametrize("mode", ["unrolled", "scan"])
def test_miniapp_on_cpu_grid(mode):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = miniapp_triangular_solver.run(
            ["-m", "40", "-n", "24", "-b", "8", "--type", "d", "--side", "R", "--uplo", "U",
             "--op", "C", "--backend", "cpu", "--grid-rows", "2", "--grid-cols", "2",
             "--share-device", "--nruns", "1", "--check-result", "last",
             f"--dlaf:dist-step-mode={mode}"])
    lines = buf.getvalue().splitlines()
    assert len(res) == 1
    assert " dRUCN (40, 24) (8, 8) (2, 2) " in lines[0] and lines[0].endswith(" cpu")
    assert lines[-1].startswith("check: PASSED residual=")


def test_miniapp_local_check_fails_on_a_wrong_solve(monkeypatch):
    """The check is exact: a solve that returns B unchanged fails it and
    exits 1."""
    from dlaf_tpu_torch.miniapp import miniapp_triangular_solver as mts

    monkeypatch.setattr(mts, "triangular_solve", lambda *args, **kw: args[6].clone())
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stdout(io.StringIO()):
        mts.run(["-m", "24", "-n", "8", "-b", "8", "--type", "s", "--backend", "cpu",
                 "--nruns", "1", "--nwarmups", "0", "--check-result", "last"])
    assert exc.value.code == 1
