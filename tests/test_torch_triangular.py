"""Local triangular solve and multiply of the PyTorch port against the JAX
reference (``dlaf_tpu/algorithms/triangular.py``, ``tile_ops/blas.py``).

The same seeded numpy operands (well-conditioned triangles, the
reference's ``make_ab``) go through ``dlaf_tpu``'s entry points and the
port's on CPU tensors, for all 24 side x uplo x op x diag combinations in
float64 and a subset in float32 and complex128. Tolerance: the
reference's own test bound, ``rtol = atol = 500 eps`` of the type, against
the reference's result and against numpy. Bitwise where the reference pins
bitwise: ``trsm_rhs_chunk`` against the unchunked solve (native and Ozaki
routes), and the Ozaki-routed ``contract`` against the reference's
(exact group sums on both sides). The recursive solve runs above a
lowered ``TRSM_RECURSE_MIN`` in both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlaf_tpu import config as jcfg
from dlaf_tpu.algorithms.triangular import triangular_multiply as j_mult
from dlaf_tpu.algorithms.triangular import triangular_solve as j_solve
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu.tile_ops import blas as jtb
from dlaf_tpu_torch import config
from dlaf_tpu_torch.algorithms.triangular import triangular_multiply, triangular_solve
from dlaf_tpu_torch.common.index2d import TileElementSize
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.tile_ops import blas as tb

COMBOS = [(s, u, o, d) for s in "LR" for u in "LU" for o in "NTC" for d in "NU"]
SMALL = [("L", "L", "N", "N"), ("L", "U", "T", "N"), ("L", "U", "N", "U"),
         ("L", "L", "C", "N"), ("R", "L", "N", "N"), ("R", "U", "C", "N"),
         ("R", "L", "T", "U"), ("R", "U", "N", "N")]
KNOBS = ("F64_GEMM", "F64_GEMM_MIN_DIM", "TRSM_RHS_CHUNK", "OZAKI_IMPL", "F64_TRSM")


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


def make_ab(n, m, dtype, side, seed=0):
    """The reference test's operands: ``A`` of order n (side L) or m (R)
    with ``2 * order`` added to its diagonal, ``B`` n x m."""
    rng = np.random.default_rng(seed)
    adim = n if side == "L" else m
    a = rng.standard_normal((adim, adim))
    b = rng.standard_normal((n, m))
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal(a.shape)
        b = b + 1j * rng.standard_normal(b.shape)
    a = a + 2 * adim * np.eye(adim)
    return a.astype(dtype), b.astype(dtype)


def np_tri(a, uplo, diag):
    t = np.tril(a) if uplo == "L" else np.triu(a)
    if diag == "U":
        np.fill_diagonal(t, 1.0)
    return t


def np_op(a, op):
    return {"N": a, "T": a.T, "C": a.conj().T}[op]


def tol(dtype):
    eps = np.finfo(np.dtype(dtype).type(0).real.dtype).eps
    return dict(rtol=500 * eps, atol=500 * eps)


def both(fn_j, fn_p, combo, alpha, a, b, nb, **kw):
    """The reference's and the port's result of one local call."""
    ref = fn_j(*combo, alpha, JMatrix.from_global(a, JTileElementSize(nb, nb)),
               JMatrix.from_global(b, JTileElementSize(nb, nb))).to_numpy()
    got = fn_p(*combo, alpha, Matrix.from_global(a, TileElementSize(nb, nb), device="cpu"),
               Matrix.from_global(b, TileElementSize(nb, nb), device="cpu"), **kw)
    return np.asarray(ref), got.to_numpy()


def want_solve(a, b, combo, alpha):
    side, uplo, op, diag = combo
    t = np_op(np_tri(a, uplo, diag), op)
    return np.linalg.solve(t, alpha * b) if side == "L" else (alpha * b) @ np.linalg.inv(t)


def want_mult(a, b, combo, alpha):
    side, uplo, op, diag = combo
    t = np_op(np_tri(a, uplo, diag), op)
    return alpha * (t @ b if side == "L" else b @ t)


@pytest.mark.parametrize("combo", COMBOS, ids=["".join(c) for c in COMBOS])
def test_solve_local_all_combos(combo):
    a, b = make_ab(12, 8, np.float64, combo[0])
    ref, got = both(j_solve, triangular_solve, combo, 1.5, a, b, 4)
    np.testing.assert_allclose(got, ref, **tol(np.float64))
    np.testing.assert_allclose(got, want_solve(a, b, combo, 1.5), **tol(np.float64))


@pytest.mark.parametrize("combo", COMBOS, ids=["".join(c) for c in COMBOS])
def test_multiply_local_all_combos(combo):
    a, b = make_ab(12, 8, np.float64, combo[0], seed=7)
    ref, got = both(j_mult, triangular_multiply, combo, 0.5, a, b, 4)
    np.testing.assert_allclose(got, ref, **tol(np.float64))
    np.testing.assert_allclose(got, want_mult(a, b, combo, 0.5), **tol(np.float64))


@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
@pytest.mark.parametrize("combo", SMALL[:4] + SMALL[5:6], ids=lambda c: "".join(c))
def test_local_dtypes(combo, dtype):
    a, b = make_ab(12, 8, dtype, combo[0], seed=3)
    ref, got = both(j_solve, triangular_solve, combo, 1.0, a, b, 4)
    np.testing.assert_allclose(got, ref, **tol(dtype))
    np.testing.assert_allclose(got, want_solve(a, b, combo, 1.0), **tol(dtype))
    ref, got = both(j_mult, triangular_multiply, combo, 2.0, a, b, 4)
    np.testing.assert_allclose(got, ref, **tol(dtype))


@pytest.mark.parametrize("combo", [("L", "L", "N", "N"), ("R", "U", "C", "N")],
                         ids=lambda c: "".join(c))
@pytest.mark.parametrize("mxu", [False, True])
def test_trsm_rhs_chunk_bitwise_identical(combo, mxu, monkeypatch):
    """Free-axis chunks of the local solve are bitwise the unchunked solve,
    on the native and the Ozaki route, with a ragged last chunk; on the
    Ozaki route the width is raised to ``f64_gemm_min_dim`` in both
    packages (a narrower chunk would move its products off the route)."""
    side = combo[0]
    n, m = (48, 37) if side == "L" else (37, 48)
    a, b = make_ab(n, m, np.float64, side, seed=7)
    # min_dim 32 over the chunk's 16 on the mxu arm: the clamp
    set_knobs(monkeypatch, {"f64_gemm": "mxu", "f64_gemm_min_dim": 32} if mxu else {})
    ref0, kept = both(j_solve, triangular_solve, combo, 1.0, a, b, 8)
    set_knobs(monkeypatch, {"trsm_rhs_chunk": 16})
    from dlaf_tpu.algorithms.triangular import _rhs_chunk_width

    width = tb.resolve_chunk_width("trsm_rhs_chunk", torch.float64, 48, 37, "cpu")
    assert width == _rhs_chunk_width(side, b.shape, np.float64) == (32 if mxu else 16)
    ref1, chunked = both(j_solve, triangular_solve, combo, 1.0, a, b, 8)
    np.testing.assert_array_equal(chunked, kept)
    np.testing.assert_array_equal(ref1, ref0)
    np.testing.assert_allclose(chunked, ref1, **tol(np.float64))


def test_chunk_width_resolution(monkeypatch):
    """-1 (auto) chunks only on the reference's TPU, so never here; 0 is
    off; a width not shorter than the free axis is no chunk."""
    assert tb.resolve_chunk_width("trsm_rhs_chunk", torch.float64, 64, 64, "cpu") == 0
    set_knobs(monkeypatch, {"trsm_rhs_chunk": 64})
    assert tb.resolve_chunk_width("trsm_rhs_chunk", torch.float64, 64, 64, "cpu") == 0
    assert tb.resolve_chunk_width("trsm_rhs_chunk", torch.float64, 64, 65, "cuda") == 64
    set_knobs(monkeypatch, {"trsm_rhs_chunk": 0})
    assert tb.resolve_chunk_width("trsm_rhs_chunk", torch.float64, 64, 65, "cpu") == 0


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("combo", SMALL, ids=lambda c: "".join(c))
def test_recursive_solve_above_lowered_min(combo, mxu, monkeypatch):
    """``TRSM_RECURSE_MIN`` lowered to 16 in both packages: a triangle of
    order 44 (30 for side 'R') splits down to library leaves connected by
    products (on the Ozaki route with ``mxu``), held against the
    reference's recursion and numpy. The off-diagonal entries are scaled
    by 1/44 so
    that the unit-diagonal triangles are as well conditioned as the
    others (a random unit triangle's condition grows exponentially with
    its order)."""
    monkeypatch.setattr(tb, "TRSM_RECURSE_MIN", 16)
    monkeypatch.setattr(jtb, "TRSM_RECURSE_MIN", 16)
    if mxu:
        set_knobs(monkeypatch, {"f64_gemm": "mxu", "f64_gemm_min_dim": 8})
    called = []
    rec = tb._trsm_rec

    def spy(*args):
        called.append(args[4].shape[-1])
        return rec(*args)

    monkeypatch.setattr(tb, "_trsm_rec", spy)
    a, b = make_ab(44, 30, np.float64, combo[0], seed=5)
    a = np.diag(np.diag(a)) + (a - np.diag(np.diag(a))) / 44
    ref, got = both(j_solve, triangular_solve, combo, 1.0, a, b, 4)
    assert called and called[0] == a.shape[0]
    np.testing.assert_allclose(got, ref, **tol(np.float64))
    np.testing.assert_allclose(got, want_solve(a, b, combo, 1.0), **tol(np.float64))


@pytest.mark.parametrize("subscripts,xs,ys", [
    ("rab,cbd->rcad", (3, 8, 8), (2, 8, 5)),
    ("ab,cbd->cad", (8, 8), (3, 8, 5)),
    ("rab,bd->rad", (4, 5, 8), (8, 8)),
])
@pytest.mark.parametrize("mxu", [False, True])
def test_contract_matches_reference(subscripts, xs, ys, mxu, monkeypatch):
    """The einsum the distributed builders use: natively within 500 eps of
    the reference's; on the Ozaki route (exact group sums) bit for bit."""
    set_knobs(monkeypatch, {"f64_gemm": "mxu", "f64_gemm_min_dim": 4,
                            "ozaki_impl": "jnp"} if mxu else {})
    rng = np.random.default_rng(len(subscripts))
    x, y = rng.standard_normal(xs), rng.standard_normal(ys)
    ref = np.asarray(jtb.contract(subscripts, jnp.asarray(x), jnp.asarray(y)))
    got = tb.contract(subscripts, torch.tensor(x), torch.tensor(y)).numpy()
    assert got.shape == ref.shape
    if mxu:
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, np.einsum(subscripts, x, y), **tol(np.float64))


@pytest.mark.parametrize("combo", [("L", "U", "C", "N"), ("R", "L", "T", "U")],
                         ids=lambda c: "".join(c))
def test_trmm_ozaki_route_matches_reference(combo, monkeypatch):
    """``trmm`` on the Ozaki route (exact group sums): bit for bit."""
    set_knobs(monkeypatch, {"f64_gemm": "mxu", "f64_gemm_min_dim": 4, "ozaki_impl": "jnp"})
    a, b = make_ab(24, 16, np.float64, combo[0], seed=9)
    ref = np.asarray(jtb.trmm(*combo, jnp.asarray(a), jnp.asarray(b), alpha=0.5))
    got = tb.trmm(*combo, torch.tensor(a), torch.tensor(b), alpha=0.5).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bad", ["zero", "nan", "none"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_with_info_local(bad, diag):
    """The singular-diagonal info of A: the 1-based first zero or
    non-finite diagonal column, 0 for a clean diagonal and for
    ``diag='U'``, as the reference's; the solution is bitwise the same with
    and without it."""
    a, b = make_ab(20, 6, np.float64, "L", seed=2)
    if bad != "none":
        a[13, 13] = 0.0 if bad == "zero" else np.nan
    combo = ("L", "L", "N", diag)
    jm = JMatrix.from_global(a, JTileElementSize(8, 8))
    jx, jinfo = j_solve(*combo, 1.0, jm, JMatrix.from_global(b, JTileElementSize(8, 8)),
                        with_info=True)
    am = Matrix.from_global(a, TileElementSize(8, 8), device="cpu")
    x, info = triangular_solve(*combo, 1.0, am,
                               Matrix.from_global(b, TileElementSize(8, 8), device="cpu"),
                               with_info=True)
    plain = triangular_solve(*combo, 1.0, am,
                             Matrix.from_global(b, TileElementSize(8, 8), device="cpu"))
    want = 14 if bad != "none" and diag == "N" else 0
    assert info.dtype == torch.int32 and int(info) == int(jinfo) == want
    np.testing.assert_array_equal(x.to_numpy(), plain.to_numpy())
