"""``donate=False`` and ``donate_b=False`` leave the caller's storage
bitwise unchanged in the PyTorch port, as the JAX reference's immutable
arrays do.

The port works in place on one tensor per matrix, so every entry copies
its input first; a copy that is in fact a view of the tiles (one tile, or
nb = 1, where the layout transform needs no copy) would let the
factorization or solve write the caller's matrix. Held on every local
Cholesky route at n == nb, n < nb, nb = 1 and several tiles, without a
grid and on a 1x1 grid, and for the triangular solve and multiply, local
and on a 2x2 grid. ``donate=True`` keeps its contract (the storage is
released, ``tests/test_torch_cholesky.py``).
"""

import numpy as np
import pytest
import torch

from dlaf_tpu_torch import config
from dlaf_tpu_torch.algorithms.cholesky import cholesky
from dlaf_tpu_torch.algorithms.triangular import triangular_multiply, triangular_solve
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import TileElementSize
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.matrix.tiling import tiles_to_global

ROUTES = ("loop", "biggemm", "invgemm", "scan", "xla", "ozaki")
SHAPES = [(16, 16), (10, 16), (6, 1), (40, 16)]   # n == nb, n < nb, nb = 1, several tiles


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    for knob in ("CHOLESKY_TRAILING", "DIST_STEP_MODE"):
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    yield
    config.initialize()


def hpd(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    return x @ x.T + n * np.eye(n)


def snapshot(mat):
    return [s.clone() for s in mat.shards()]


def unchanged(mat, before):
    return all(torch.equal(s, b) for s, b in zip(mat.shards(), before))


@pytest.mark.parametrize("n,nb", SHAPES)
def test_tiles_to_global_never_aliases(n, nb):
    mat = Matrix.from_global(hpd(n), TileElementSize(nb, nb), device="cpu")
    g = tiles_to_global(mat.storage, mat.dist)
    assert g.untyped_storage().data_ptr() != mat.storage.untyped_storage().data_ptr()
    g.fill_(7.0)
    assert not (mat.storage == 7.0).any()


@pytest.mark.parametrize("grid", [None, "1x1"])
@pytest.mark.parametrize("n,nb", SHAPES)
@pytest.mark.parametrize("route", ROUTES)
def test_cholesky_donate_false_keeps_storage(route, n, nb, grid, monkeypatch):
    monkeypatch.setenv("DLAF_CHOLESKY_TRAILING", route)
    config.initialize()
    g = shared_grid(1, 1, "cpu") if grid else None
    a = hpd(n)
    mat = Matrix.from_global(a, TileElementSize(nb, nb), g, device="cpu")
    before = snapshot(mat)
    out = cholesky("L", mat, with_info=True)[0]
    assert unchanged(mat, before)
    tol = 60 * n * np.finfo(np.float64).eps * np.abs(a).max()
    assert np.abs(np.tril(out.to_numpy()) - np.linalg.cholesky(a)).max() <= tol


def tri_pair(n, side, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + 2 * n * np.eye(n)
    b = rng.standard_normal((n, n + 3) if side == "L" else (n + 3, n))
    return a, b


@pytest.mark.parametrize("grid", [None, (1, 1), (2, 2)])
@pytest.mark.parametrize("n,nb", SHAPES)
@pytest.mark.parametrize("mode", ["unrolled", "scan"])
def test_triangular_donate_false_keeps_storage(n, nb, grid, mode, monkeypatch):
    monkeypatch.setenv("DLAF_DIST_STEP_MODE", mode)
    config.initialize()
    g = shared_grid(*grid, "cpu") if grid else None
    for side, uplo, op in (("L", "L", "N"), ("R", "U", "C")):
        a, b = tri_pair(n, side, seed=n + nb)
        am = Matrix.from_global(a, TileElementSize(nb, nb), g, device="cpu")
        bm = Matrix.from_global(b, TileElementSize(nb, nb), g, device="cpu")
        ba, bb = snapshot(am), snapshot(bm)
        x = triangular_solve(side, uplo, op, "N", 2.0, am, bm, donate_b=False).to_numpy()
        y = triangular_multiply(side, uplo, op, "N", 0.5, am, bm).to_numpy()
        assert unchanged(am, ba) and unchanged(bm, bb)
        t = np.tril(a) if uplo == "L" else np.triu(a)
        t = t if op == "N" else t.T
        want_x = np.linalg.solve(t, 2 * b) if side == "L" else np.linalg.solve(t.T, 2 * b.T).T
        want_y = 0.5 * (t @ b if side == "L" else b @ t)
        eps = np.finfo(np.float64).eps
        np.testing.assert_allclose(x, want_x, rtol=500 * eps, atol=500 * eps)
        np.testing.assert_allclose(y, want_y, rtol=500 * eps, atol=500 * eps)


@pytest.mark.parametrize("grid", [None, (2, 2)])
def test_triangular_donate_b_releases_storage(grid):
    g = shared_grid(*grid, "cpu") if grid else None
    a, b = tri_pair(40, "L")
    am = Matrix.from_global(a, TileElementSize(16, 16), g, device="cpu")
    keep = triangular_solve("L", "L", "N", "N", 1.0, am,
                            Matrix.from_global(b, TileElementSize(16, 16), g, device="cpu"))
    bm = Matrix.from_global(b, TileElementSize(16, 16), g, device="cpu")
    out = triangular_solve("L", "L", "N", "N", 1.0, am, bm, donate_b=True)
    assert bm.storage is None
    assert all(torch.equal(x, y) for x, y in zip(out.shards(), keep.shards()))
