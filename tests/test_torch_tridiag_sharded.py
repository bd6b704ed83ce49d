"""The D&C's sharded merges of the PyTorch port against the JAX reference.

The reference shards a merge of order ``_SHARD_MERGE_MIN_N`` or more over
its mesh (``dlaf_tpu/eigensolver/tridiag_solver.py``, ``_run_level``);
the port over the ranks of a grid (:func:`tridiag_solver` with ``grid``).
The same numpy-seeded tridiagonal goes through the reference's
``tridiag_solver(..., mesh=grid.mesh)`` on its 8 virtual CPU devices and
the port's on ``shared_grid(P, Q, "cpu")``, on 2x2 and 2x4 grids, float64:
a random tridiagonal, one whose Toeplitz half deflates by rotations, and
one with a zero coupling at the root's split (a decoupled merge). The
threshold is lowered in both packages (``monkeypatch``) so that orders
128-256 shard; one case keeps the real threshold at n >= 512. Bounds (the
reference's): eigenvalues at 1e-11 relative to the reference's, the
eigenpair residual and orthogonality within ``200 n eps``. Against the
port's own unsharded merge: the eigenvalues bitwise, Q within ``200 n
eps``. Then the eigensolver's handoff: the 2-D block-sharded Q re-tiled
into the block-cyclic Matrix equals ``Matrix.from_global`` of the same Q,
and ranks of one grid line on one device share one copy of the rows they
fetch.
"""

import importlib

import numpy as np
import pytest
import torch

from dlaf_tpu import config as jcfg
from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu_torch import config
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import RankIndex2D, TileElementSize
from dlaf_tpu_torch.matrix.matrix import Matrix

jt = importlib.import_module("dlaf_tpu.eigensolver.tridiag_solver")
pt = importlib.import_module("dlaf_tpu_torch.eigensolver.tridiag_solver")

EPS = np.finfo(np.float64).eps


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    for knob in ("SECULAR_DEVICE_MIN_K", "DC_LEVEL_BATCH"):
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    jcfg.initialize()
    yield
    config.initialize()
    jcfg.initialize()


def tridiag(kind: str, n: int):
    rng = np.random.default_rng(7 + n)
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    if kind == "deflating":
        d[n // 2:], e[n // 2:] = 2.0, 1.0
    elif kind == "decoupled":
        # the root's split: a tile boundary near the middle
        e[n // 2 - 1] = 0.0
    return d, e


def budget_checks(d, e, lam, q):
    n = d.shape[0]
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    tol = 200 * n * EPS
    assert np.linalg.norm(t @ q - q * lam[None, :]) / np.linalg.norm(t) < tol
    assert np.linalg.norm(q.T @ q - np.eye(n)) < tol


def run_both(monkeypatch, devices8, kind, n, nb, grid, min_n, secular_k=None):
    P, Q = grid
    if min_n is not None:
        monkeypatch.setattr(pt, "_SHARD_MERGE_MIN_N", min_n)
        monkeypatch.setattr(jt, "_SHARD_MERGE_MIN_N", min_n)
    if secular_k is not None:
        monkeypatch.setenv("DLAF_SECULAR_DEVICE_MIN_K", str(secular_k))
        config.initialize()
        jcfg.initialize()
    d, e = tridiag(kind, n)
    jgrid = JGrid(P, Q, devices=devices8[:P * Q])
    jlam, jq = jt.tridiag_solver(d, e, nb, mesh=jgrid.mesh)
    stats = []
    lam, q = pt.tridiag_solver(d, e, nb, grid=shared_grid(P, Q, "cpu"), stats=stats)
    return d, e, np.asarray(jlam), np.asarray(jq), lam, q, stats


CASES = [("random", 192, 16, (2, 2), 64, None),
         ("deflating", 256, 16, (2, 4), 64, None),
         ("decoupled", 160, 16, (2, 4), 64, None),
         ("random", 192, 16, (2, 4), 64, 32),
         ("deflating", 200, 16, (2, 2), 64, 32),
         ("random", 600, 64, (2, 2), None, None)]


@pytest.mark.parametrize("kind,n,nb,grid,min_n,secular_k", CASES)
def test_sharded_matches_reference_and_unsharded(monkeypatch, devices8, kind, n, nb, grid,
                                                 min_n, secular_k):
    d, e, jlam, jq, lam, q, stats = run_both(monkeypatch, devices8, kind, n, nb, grid, min_n,
                                             secular_k)
    P, Q = grid
    assert isinstance(q, pt.BlockQ)
    assert {s.shards for s in stats if s.n >= pt._SHARD_MERGE_MIN_N} == {P * Q}
    assert {s.shards for s in stats if s.n < pt._SHARD_MERGE_MIN_N} <= {1}
    if kind == "decoupled":
        assert stats[-1].route == "decoupled"
    if secular_k is not None:
        assert any(s.route == "device" and s.shards == P * Q for s in stats)
    qg = q.to_global().numpy()
    # against the reference's sharded merge
    np.testing.assert_allclose(lam, jlam, rtol=1e-11, atol=1e-11 * np.abs(jlam).max())
    budget_checks(d, e, lam, qg)
    budget_checks(d, e, jlam, jq)
    # against the port's own unsharded merge
    lam0, q0 = pt.tridiag_solver(d, e, nb, device="cpu")
    np.testing.assert_array_equal(lam, lam0)
    assert np.abs(qg - q0.numpy()).max() < 200 * n * EPS


@pytest.mark.parametrize("grid,src", [((2, 2), (0, 1)), ((2, 4), (1, 3))])
def test_block_q_retiles_as_from_global(monkeypatch, grid, src):
    """The handoff: the block-sharded Q as the block-cyclic Matrix, by
    rank-to-rank exchanges, bitwise ``Matrix.from_global`` of the whole Q
    (tiles that straddle the blocks' edges, a source rank not (0, 0))."""
    monkeypatch.setattr(pt, "_SHARD_MERGE_MIN_N", 64)
    d, e = tridiag("random", 150)
    g = shared_grid(*grid, "cpu")
    lam, q = pt.tridiag_solver(d, e, 16, grid=g)
    whole = q.to_global()
    tile = TileElementSize(12, 12)
    mat = q.to_matrix(tile, RankIndex2D(*src))
    ref = Matrix.from_global(whole, tile, g, source_rank=RankIndex2D(*src))
    for a, b in zip(mat.shards(), ref.shards()):
        assert torch.equal(a, b)


def test_ranks_on_one_device_share_fetched_rows():
    """The sharded merge's row fetch on a shared device: ranks of one grid
    row (one span) read one copy of their rows, which are the node's Q's
    rows bitwise; :func:`_receivers` names each line's first rank on the
    device as the one that receives."""
    g = shared_grid(2, 3, "cpu")
    assert pt._receivers(g, lambda r, c: c) == {(r, c): (0, c) for r in range(2)
                                                for c in range(3)}
    n = 50
    whole = torch.as_tensor(np.random.default_rng(3).standard_normal((n, n)))
    q = pt.BlockQ(g, n, [[whole[a:b, c0:c1].clone() for c0, c1 in
                          zip(pt._split(n, 3)[:-1], pt._split(n, 3)[1:])]
                         for a, b in zip(pt._split(n, 2)[:-1], pt._split(n, 2)[1:])])
    rows = pt._fetch_rows(g, q, n, lambda r, c: (10 * r, 10 * r + 17))
    for r in range(2):
        assert all(rows[r][c] is rows[r][0] for c in range(3))
        assert torch.equal(rows[r][0], whole[10 * r:10 * r + 17])


def test_small_grid_or_order_does_not_shard(monkeypatch):
    """One rank, or a root below the threshold: Q whole on rank (0, 0)'s
    device, the unsharded result bit for bit."""
    d, e = tridiag("random", 100)
    lam0, q0 = pt.tridiag_solver(d, e, 16, device="cpu")
    lam1, q1 = pt.tridiag_solver(d, e, 16, grid=shared_grid(1, 1, "cpu"))
    lam2, q2 = pt.tridiag_solver(d, e, 16, grid=shared_grid(2, 2, "cpu"))
    for lam, q in ((lam1, q1), (lam2, q2)):
        assert isinstance(q, torch.Tensor)
        np.testing.assert_array_equal(lam, lam0)
        assert torch.equal(q, q0)


@pytest.mark.parametrize("grid", [(2, 2), (2, 4)])
def test_givens_undo_once_per_column_shard(monkeypatch, grid):
    """The Givens undo runs once per column shard of a sharded merge with
    rotations, once per unsharded one: ``chip_smoke.givens_launches`` of
    the merge statistics, the count the script holds the card to."""
    import chip_smoke as cs

    monkeypatch.setattr(pt, "_SHARD_MERGE_MIN_N", 64)
    calls = []
    real = pt.gk.givens_undo
    monkeypatch.setattr(pt.gk, "givens_undo", lambda u, g: calls.append(u.shape) or real(u, g))
    # the Toeplitz T (2, 1): merges of equal halves meet equal poles
    d, e = np.full(256, 2.0), np.full(255, 1.0)
    stats = []
    pt.tridiag_solver(d, e, 16, grid=shared_grid(*grid, "cpu"), stats=stats)
    assert any(s.rotations and s.shards > 1 for s in stats)
    assert len(calls) == cs.givens_launches(stats)
