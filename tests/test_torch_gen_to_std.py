"""HEGST (``gen_to_std``) of the PyTorch port on one rank, against the JAX
reference (``dlaf_tpu/algorithms/gen_to_std.py``).

B is factored once by the reference's ``cholesky``; its tile storage and
A's go into the port through ``matrix/convert.from_jax_storage``, so both
packages transform the same A with the same factor. The reference runs as
its own tests run it on the CPU (Pallas kernels in interpret mode under
``panel_impl=fused``); the port runs on CPU tensors, where each kernel
wrapper takes its plain version. A complex A has a nonzero imaginary
diagonal (the transform reads it as Hermitian, so drops it).

Tolerance: the reference's ``_tol``, ``rtol = atol = 2000 eps`` of the
type, on the whole result (the opposite triangle is A's in both).
``with_info`` is bitwise; ``lookahead`` holds the reference's own bound,
``1e-13`` (see :func:`test_lookahead`).
"""

import numpy as np
import pytest
import torch

from dlaf_tpu import config as jcfg
from dlaf_tpu.algorithms.cholesky import cholesky as j_cholesky
from dlaf_tpu.algorithms.gen_to_std import gen_to_std as j_gen_to_std
from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu.common.index2d import RankIndex2D as JRankIndex2D
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu.tile_ops import ozaki as joz
from dlaf_tpu_torch import config
from dlaf_tpu_torch.algorithms.gen_to_std import gen_to_std
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import (GlobalElementSize, GridSize2D, RankIndex2D,
                                           TileElementSize)
from dlaf_tpu_torch.matrix.convert import from_jax_storage
from dlaf_tpu_torch.matrix.distribution import Distribution
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.miniapp import miniapp_gen_to_std
from dlaf_tpu_torch.tile_ops import ozaki as oz
from dlaf_tpu_torch.tile_ops import panel_kernels as pk

KNOBS = ("HEGST_IMPL", "CHOLESKY_LOOKAHEAD", "COMM_LOOKAHEAD", "PANEL_IMPL", "F64_GEMM",
         "F64_TRSM", "F64_GEMM_MIN_DIM", "OZAKI_IMPL", "DIST_STEP_MODE")


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


def tol(dtype):
    eps = np.finfo(np.dtype(dtype).type(0).real.dtype).eps
    return dict(rtol=2000 * eps, atol=2000 * eps)


def herm(n, dtype, seed, pd=False):
    """The reference test's inputs; a complex A also gets an imaginary
    diagonal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((n, n))
    if pd:
        return (x @ x.conj().T + n * np.eye(n)).astype(dtype)
    a = (x + x.conj().T) / 2
    if np.dtype(dtype).kind == "c":
        a = a + 1j * np.diag(rng.standard_normal(n))
    return a.astype(dtype)


def jax_grid(grid_shape, devices8):
    return (JGrid(*grid_shape, devices=devices8[:grid_shape[0] * grid_shape[1]])
            if grid_shape else None)


def to_port(jm, grid_shape):
    """The reference Matrix's tile storage as a port Matrix (every rank on
    the CPU)."""
    d = jm.dist
    P, Q = grid_shape or (1, 1)
    dist = Distribution(GlobalElementSize(d.size.row, d.size.col),
                        TileElementSize(d.block_size.row, d.block_size.col), GridSize2D(P, Q),
                        source_rank=RankIndex2D(d.source_rank.row, d.source_rank.col))
    return from_jax_storage(np.asarray(jm.storage), dist,
                            grid=shared_grid(P, Q, "cpu") if grid_shape else None, device="cpu")


def inputs(uplo, a, b, nb, grid_shape=None, src=(0, 0), devices8=None):
    """(reference A, reference factor, port A, port factor): B factored by
    the reference, both carried into the port."""
    jgrid = jax_grid(grid_shape, devices8)
    jb = j_cholesky(uplo, JMatrix.from_global(b, JTileElementSize(nb, nb), grid=jgrid,
                                              source_rank=JRankIndex2D(*src)))
    ja = JMatrix.from_global(a, JTileElementSize(nb, nb), grid=jgrid,
                             source_rank=JRankIndex2D(*src))
    return ja, jb, to_port(ja, grid_shape), to_port(jb, grid_shape)


def run_both(uplo, a, b, nb, grid_shape=None, src=(0, 0), devices8=None):
    """(reference result, port result, port factor as numpy)."""
    ja, jb, pa, pb = inputs(uplo, a, b, nb, grid_shape, src, devices8)
    ref = np.asarray(j_gen_to_std(uplo, ja, jb).to_numpy())
    got = gen_to_std(uplo, pa, pb).to_numpy()
    return ref, got, pb.to_numpy()


def expected(uplo, a, f):
    """The transform in numpy from the factor's ``uplo`` triangle."""
    tri = np.tril if uplo == "L" else np.triu
    ah = tri(a, -1 if uplo == "L" else 1)
    ah = ah + ah.conj().T + np.diag(np.diag(a).real)
    t = tri(f)
    if uplo == "L":
        return np.linalg.solve(t, ah) @ np.linalg.inv(t).conj().T
    return np.linalg.solve(t.conj().T, ah) @ np.linalg.inv(t)


def check(uplo, a, ref, got, f, dtype):
    np.testing.assert_allclose(got, ref, **tol(dtype))
    tri, other = (np.tril, np.triu) if uplo == "L" else (np.triu, np.tril)
    k = 1 if uplo == "L" else -1
    np.testing.assert_array_equal(other(got, k), other(a, k))
    np.testing.assert_allclose(tri(got), tri(expected(uplo, a, f)), **tol(dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128, np.float32])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("n,nb", [(12, 4), (13, 4), (8, 8)])
def test_local_matches_reference(uplo, n, nb, dtype):
    a, b = herm(n, dtype, 2), herm(n, dtype, 3, pd=True)
    ref, got, f = run_both(uplo, a, b, nb)
    check(uplo, a, ref, got, f, dtype)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_local_fused_panel_matches_reference(uplo, monkeypatch):
    """float32 with ``panel_impl=fused``: the strip-solve kernel's plain
    version here, the reference's Pallas kernel in interpret mode; 3nt-1
    strip solves (two on each diagonal tile, one per panel)."""
    set_knobs(monkeypatch, {"panel_impl": "fused", "hegst_impl": "blocked"})
    n, nb = 13, 4
    a, b = herm(n, np.float32, 4), herm(n, np.float32, 5, pd=True)
    ja, jb, pa, pb = inputs(uplo, a, b, nb)
    ref = np.asarray(j_gen_to_std(uplo, ja, jb).to_numpy())
    calls = count_right_solves(monkeypatch)
    got = gen_to_std(uplo, pa, pb).to_numpy()
    assert calls[0] == 3 * 4 - 1
    check(uplo, a, ref, got, pb.to_numpy(), np.float32)


def count_right_solves(monkeypatch):
    """Calls of the strip solve's plain version, each side 'L' solve
    counted once (it runs as one side 'R' solve of the transpose, as the
    kernel does)."""
    calls = [0]
    fn = pk.panel_solve_plain

    def wrapper(side, *args, **kw):
        calls[0] += side == "R"
        return fn(side, *args, **kw)

    monkeypatch.setattr(pk, "panel_solve_plain", wrapper)
    return calls


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_twosolve_matches_reference_and_blocked(uplo, monkeypatch):
    dtype, n, nb = np.complex128, 21, 4
    a, b = herm(n, dtype, 11), herm(n, dtype, 12, pd=True)
    out = {}
    for impl in ("blocked", "twosolve"):
        set_knobs(monkeypatch, {"hegst_impl": impl})
        ref, out[impl], f = run_both(uplo, a, b, nb)
        check(uplo, a, ref, out[impl], f, dtype)
    np.testing.assert_allclose(out["blocked"], out["twosolve"], rtol=1e-10, atol=1e-10)


def count_ozaki(monkeypatch, module):
    calls = [0]
    for name in ("matmul_f64", "syrk_f64"):
        fn = getattr(module, name)

        def wrapper(*args, _fn=fn, **kw):
            calls[0] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_mxu_mixed_matches_reference(uplo, monkeypatch):
    """``f64_gemm=mxu`` (``f64_gemm_min_dim=4``, the "jnp" reduction) with
    ``f64_trsm=mixed``: both packages put the blocked form's products on
    the Ozaki route, the same number of times, and agree."""
    set_knobs(monkeypatch, {"hegst_impl": "blocked", "f64_gemm": "mxu", "f64_gemm_min_dim": 4,
                            "f64_trsm": "mixed", "ozaki_impl": "jnp"})
    dtype, n, nb = np.float64, 16, 4
    a, b = herm(n, dtype, 21), herm(n, dtype, 22, pd=True)
    ja, jb, pa, pb = inputs(uplo, a, b, nb)
    jcalls = count_ozaki(monkeypatch, joz)
    ref = np.asarray(j_gen_to_std(uplo, ja, jb).to_numpy())
    pcalls = count_ozaki(monkeypatch, oz)
    got = gen_to_std(uplo, pa, pb).to_numpy()
    assert pcalls[0] == jcalls[0] > 0
    check(uplo, a, ref, got, pb.to_numpy(), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_lookahead(uplo, dtype, monkeypatch):
    """Lookahead on and off on the same factor, against each other and the
    reference, within the reference's own bound for its local lookahead
    (``1e-13``): the row-trimmed rest of the her2k is a smaller product
    than the whole one, which the CPU's BLAS may sum in another order (it
    does at 5 rows), so the local form is not bitwise."""
    n, nb = 21, 4
    a, b = herm(n, dtype, 21), herm(n, dtype, 22, pd=True)
    ja, jb, pa, pb = inputs(uplo, a, b, nb)
    res = {}
    for la in ("0", "1"):
        set_knobs(monkeypatch, {"hegst_impl": "blocked", "cholesky_lookahead": la})
        res[la] = gen_to_std(uplo, pa, pb).to_numpy()
    np.testing.assert_allclose(res["1"], res["0"], rtol=1e-13, atol=1e-13)
    ref = np.asarray(j_gen_to_std(uplo, ja, jb).to_numpy())
    np.testing.assert_allclose(res["1"], ref, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("impl", ["blocked", "twosolve"])
@pytest.mark.parametrize("bad", [None, 6])
def test_with_info(impl, bad, monkeypatch):
    """info 0 for a clean factor, else the 1-based first singular column;
    the result bitwise the same with and without it."""
    set_knobs(monkeypatch, {"hegst_impl": impl})
    n, nb = 13, 4
    a, b = herm(n, np.float64, 6), herm(n, np.float64, 7, pd=True)
    f = np.linalg.cholesky(b)
    if bad is not None:
        f[bad, bad] = 0.0
    res, info = gen_to_std("L", Matrix.from_global(a, TileElementSize(nb, nb), device="cpu"),
                           Matrix.from_global(f, TileElementSize(nb, nb), device="cpu"),
                           with_info=True)
    plain = gen_to_std("L", Matrix.from_global(a, TileElementSize(nb, nb), device="cpu"),
                       Matrix.from_global(f, TileElementSize(nb, nb), device="cpu"))
    assert info.dtype == torch.int32 and int(info) == (0 if bad is None else bad + 1)
    np.testing.assert_array_equal(res.to_numpy(), plain.to_numpy())


@pytest.mark.parametrize("grid", [None, (1, 1)])
@pytest.mark.parametrize("impl", ["blocked", "twosolve"])
@pytest.mark.parametrize("n,nb", [(8, 8), (6, 8), (13, 4), (9, 1)])
def test_donation(n, nb, impl, grid, monkeypatch):
    """``donate=False`` leaves A's and B's storage bitwise unchanged; the
    donated call gives the same result and releases A."""
    set_knobs(monkeypatch, {"hegst_impl": impl})
    a, b = herm(n, np.complex128, 8), herm(n, np.complex128, 9, pd=True)
    g = shared_grid(*grid, "cpu") if grid else None
    am = Matrix.from_global(a, TileElementSize(nb, nb), g, device="cpu")
    bm = Matrix.from_global(np.linalg.cholesky(b), TileElementSize(nb, nb), g, device="cpu")
    keep_a, keep_b = am.storage.clone(), bm.storage.clone()
    out = gen_to_std("L", am, bm)
    assert torch.equal(am.storage, keep_a) and torch.equal(bm.storage, keep_b)
    donated = gen_to_std("L", am, bm, donate=True)
    assert am.storage is None and torch.equal(bm.storage, keep_b)
    np.testing.assert_array_equal(donated.to_numpy(), out.to_numpy())


def test_eigenvalues_match_scipy():
    """eig(A, B) is eig of the transformed standard problem."""
    import scipy.linalg as sla

    n, nb = 12, 4
    a, b = herm(n, np.float64, 6), herm(n, np.float64, 7, pd=True)
    bf = Matrix.from_global(np.linalg.cholesky(b), TileElementSize(nb, nb), device="cpu")
    c = gen_to_std("L", Matrix.from_global(a, TileElementSize(nb, nb), device="cpu"),
                   bf).to_numpy()
    c = np.tril(c) + np.tril(c, -1).T
    np.testing.assert_allclose(np.linalg.eigvalsh(c), sla.eigh(a, b, eigvals_only=True),
                               atol=1e-10)


@pytest.mark.parametrize("args", [
    ["--type", "s"], ["--type", "z", "--uplo", "U"],
    ["--type", "s", "--grid-rows", "2", "--grid-cols", "2", "--share-device"],
    ["--type", "z", "--uplo", "U", "--grid-rows", "2", "--grid-cols", "2", "--share-device"],
])
def test_miniapp_on_cpu(args):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = miniapp_gen_to_std.run(["-m", "48", "-b", "8", "--backend", "cpu", "--nruns", "1",
                                      "--check-result", "last", *args])
    lines = buf.getvalue().splitlines()
    assert len(res) == 1 and " (48, 48) (8, 8) " in lines[0]
    assert lines[-1].startswith("check: PASSED residual=")
