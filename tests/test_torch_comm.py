"""The grid layer of the PyTorch port against the JAX reference: block-cyclic
index math, the tile storage and its per-rank shards, the grid's device
placement, the collective verbs and the blocking host tier.

Layouts are held bitwise: the same numpy matrix on the same grid shape and
source rank must give the reference's tile storage exactly, shard by
shard. The verbs are held against a numpy model of the reference's
semantics (``dlaf_tpu/comm/collectives.py``) and, for the broadcast,
all-gather and all-reduce, against the reference's own verbs run inside
``shard_map`` on the virtual CPU mesh.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from dlaf_tpu._compat import shard_map
from dlaf_tpu.comm import collectives as jcc
from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu.common.index2d import GlobalElementSize as JGlobalElementSize
from dlaf_tpu.common.index2d import GlobalTileIndex as JGlobalTileIndex
from dlaf_tpu.common.index2d import LocalTileIndex as JLocalTileIndex
from dlaf_tpu.common.index2d import RankIndex2D as JRankIndex2D
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.common.index2d import GridSize2D as JGridSize2D
from dlaf_tpu.matrix import util_distribution as jud
from dlaf_tpu.matrix.distribution import Distribution as JDistribution
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu.miniapp.generators import hpd_element_fn as j_hpd_element_fn
from dlaf_tpu_torch.comm import collectives as cc
from dlaf_tpu_torch.comm import sync
from dlaf_tpu_torch.comm.grid import COL_AXIS, ROW_AXIS, Grid, shared_grid
from dlaf_tpu_torch.common.asserts import DlafAssertError
from dlaf_tpu_torch.common.index2d import (GlobalElementIndex, GlobalElementSize,
                                           GlobalTileIndex, GridSize2D, LocalTileIndex,
                                           RankIndex2D, TileElementSize)
from dlaf_tpu_torch.matrix import tiling
from dlaf_tpu_torch.matrix import util_distribution as ud
from dlaf_tpu_torch.matrix.convert import from_jax_storage, to_jax_storage
from dlaf_tpu_torch.matrix.distribution import Distribution
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.matrix.panel import DistContext, uniform_slot_start
from dlaf_tpu_torch.miniapp.generators import hpd_element_fn

# (P, Q, source rank, ordering): the rotated grids of the reference's tests
GRIDS = [(2, 2, (0, 0), "row-major"), (2, 4, (1, 2), "row-major"),
         (4, 2, (1, 0), "col-major"), (2, 2, (1, 1), "row-major")]
GRID_IDS = [f"{p}x{q}-src{s[0]}{s[1]}-{o[:3]}" for p, q, s, o in GRIDS]


def jax_grid(devices8, P, Q, ordering="row-major"):
    return JGrid(P, Q, devices=devices8[:P * Q], ordering=ordering)


@pytest.mark.parametrize("P,Q,src,ordering", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("m,n,nb", [(29, 29, 8), (37, 22, 8), (16, 16, 8)])
def test_storage_and_shards_match_reference(P, Q, src, ordering, m, n, nb, devices8):
    a = np.random.default_rng(m * n + P).standard_normal((m, n))
    jm = JMatrix.from_global(a, JTileElementSize(nb, nb), jax_grid(devices8, P, Q, ordering),
                             source_rank=JRankIndex2D(*src))
    ref = np.asarray(jm.storage)
    grid = shared_grid(P, Q, "cpu")
    pm = Matrix.from_global(a, TileElementSize(nb, nb), grid, source_rank=RankIndex2D(*src))
    assert pm.distributed and len(pm.shards()) == P * Q
    np.testing.assert_array_equal(to_jax_storage(pm), ref)
    np.testing.assert_array_equal(pm.to_numpy(), a)
    # each rank's shard is the reference's block of that mesh coordinate
    _, _, ltr, ltc = tiling.storage_tile_grid(pm.dist)
    for r in range(P):
        for c in range(Q):
            np.testing.assert_array_equal(
                pm.shards()[r * Q + c].numpy(),
                ref[r * ltr:(r + 1) * ltr, c * ltc:(c + 1) * ltc])
    # the storage transforms alone, and the split/join round trip
    t = tiling.global_to_tiles(torch.tensor(a), pm.dist)
    np.testing.assert_array_equal(t.numpy(), ref)
    np.testing.assert_array_equal(tiling.tiles_to_global(t, pm.dist).numpy(), a)
    joined = tiling.join_shards(tiling.split_shards(t, pm.dist, grid.devices), pm.dist, "cpu")
    assert torch.equal(joined, t)


@pytest.mark.parametrize("P,Q,src,ordering", GRIDS, ids=GRID_IDS)
def test_jax_storage_round_trip_on_grid(P, Q, src, ordering, devices8):
    a = np.random.default_rng(5).standard_normal((29, 29)).astype(np.float32)
    jm = JMatrix.from_global(a, JTileElementSize(8, 8), jax_grid(devices8, P, Q, ordering),
                             source_rank=JRankIndex2D(*src))
    tiles = np.asarray(jm.storage)
    grid = shared_grid(P, Q, "cpu")
    dist = Distribution(GlobalElementSize(29, 29), TileElementSize(8, 8), GridSize2D(P, Q),
                        source_rank=RankIndex2D(*src))
    pm = from_jax_storage(tiles, dist, grid=grid)
    np.testing.assert_array_equal(pm.to_numpy(), np.asarray(jm.to_numpy()))
    back = to_jax_storage(pm)
    assert back.dtype == tiles.dtype
    np.testing.assert_array_equal(back, tiles)


@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
@pytest.mark.parametrize("P,Q,src,ordering", GRIDS[:3], ids=GRID_IDS[:3])
def test_from_element_fn_per_shard_matches_reference(P, Q, src, ordering, dtype, devices8):
    n, nb = 29, 8
    ref = JMatrix.from_element_fn(j_hpd_element_fn(n, dtype), JGlobalElementSize(n, n),
                                  JTileElementSize(nb, nb), jax_grid(devices8, P, Q, ordering),
                                  dtype=dtype, source_rank=JRankIndex2D(*src))
    pm = Matrix.from_element_fn(hpd_element_fn(n, dtype), GlobalElementSize(n, n),
                                TileElementSize(nb, nb), shared_grid(P, Q, "cpu"), dtype=dtype,
                                source_rank=RankIndex2D(*src), device="cpu")
    np.testing.assert_array_equal(to_jax_storage(pm), np.asarray(ref.storage))


def test_util_distribution_matches_reference():
    for size in (0, 1, 29, 64):
        for ts in (1, 8, 16):
            for grid in (1, 2, 3, 4):
                for src in range(grid):
                    nt = -(-size // ts) if size else 0
                    for rank in range(grid):
                        assert ud.local_nr_tiles(nt, grid, rank, src) == \
                            jud.local_nr_tiles(nt, grid, rank, src)
                        assert ud.local_size(size, ts, grid, rank, src) == \
                            jud.local_size(size, ts, grid, rank, src)
                        for t in range(nt + 2):
                            assert ud.rank_global_tile(t, grid, src) == \
                                jud.rank_global_tile(t, grid, src)
                            assert ud.next_local_tile_from_global_tile(t, grid, rank, src) == \
                                jud.next_local_tile_from_global_tile(t, grid, rank, src)
                            assert ud.global_tile_from_local_tile(t, grid, rank, src) == \
                                jud.global_tile_from_local_tile(t, grid, rank, src)
                            assert ud.local_tile_from_global_tile(t, grid) == \
                                jud.local_tile_from_global_tile(t, grid)
    assert ud.tile_from_element(17, 8) == jud.tile_from_element(17, 8) == 2
    assert ud.tile_element_from_element(17, 8) == jud.tile_element_from_element(17, 8) == 1
    assert ud.element_from_tile_and_tile_element(2, 1, 8) == 17


@pytest.mark.parametrize("P,Q,src,ordering", GRIDS, ids=GRID_IDS)
def test_distribution_matches_reference(P, Q, src, ordering):
    for r in range(P):
        for c in range(Q):
            kw = dict(grid_size=GridSize2D(P, Q), rank=RankIndex2D(r, c),
                      source_rank=RankIndex2D(*src))
            d = Distribution(GlobalElementSize(37, 22), TileElementSize(8, 4), **kw)
            jd = JDistribution(JGlobalElementSize(37, 22), JTileElementSize(8, 4),
                               grid_size=JGridSize2D(P, Q), rank=JRankIndex2D(r, c),
                               source_rank=JRankIndex2D(*src))
            assert tuple(d.nr_tiles) == tuple(jd.nr_tiles)
            assert tuple(d.local_nr_tiles) == tuple(jd.local_nr_tiles)
            assert tuple(d.local_size) == tuple(jd.local_size)
            assert d.single_rank() == jd.single_rank() == (P * Q == 1)
            for i in range(d.nr_tiles.row):
                for j in range(d.nr_tiles.col):
                    g = GlobalTileIndex(i, j)
                    owner = d.rank_global_tile(g)
                    assert tuple(owner) == tuple(jd.rank_global_tile(JGlobalTileIndex(i, j)))
                    assert tuple(d.tile_size_of(g)) == tuple(
                        jd.tile_size_of(JGlobalTileIndex(i, j)))
                    if owner == RankIndex2D(r, c):
                        loc = d.local_tile_index(g)
                        assert tuple(loc) == tuple(jd.local_tile_index(JGlobalTileIndex(i, j)))
                        assert d.global_tile_index(loc) == g
                        assert tuple(jd.global_tile_index(JLocalTileIndex(*loc))) == (i, j)
            assert tuple(d.global_tile_index(GlobalElementIndex(17, 9))) == (2, 2)
            lt = d.local_nr_tiles
            if lt.row and lt.col:
                assert d.global_tile_index(LocalTileIndex(0, 0)) == GlobalTileIndex(
                    (r - src[0]) % P, (c - src[1]) % Q)


def test_distribution_asserts():
    with pytest.raises(DlafAssertError):
        Distribution(GlobalElementSize(8, 8), TileElementSize(4, 4), GridSize2D(2, 2),
                     source_rank=RankIndex2D(2, 0))
    d = Distribution(GlobalElementSize(8, 8), TileElementSize(4, 4), GridSize2D(2, 2))
    with pytest.raises(DlafAssertError):
        d.local_tile_index(GlobalTileIndex(1, 0))     # owned by rank (1, 0)
    with pytest.raises(DlafAssertError):
        Matrix(d, [torch.zeros(1, 1, 4, 4)] * 3, shared_grid(2, 2, "cpu"))


@pytest.mark.parametrize("ordering", ["row-major", "col-major"])
@pytest.mark.parametrize("P,Q", [(2, 4), (4, 2), (2, 3)])
def test_grid_placement_matches_reference(P, Q, ordering, devices8):
    """Device i of the list lands where the reference's mesh puts device i."""
    jg = jax_grid(devices8, P, Q, ordering)
    g = Grid(P, Q, devices=[torch.device("cpu", i) for i in range(8)], ordering=ordering)
    assert tuple(g.size) == (P, Q) and g.num_devices == P * Q
    mesh = jg.mesh.devices
    for r in range(P):
        for c in range(Q):
            assert g.device(r, c).index == mesh[r, c].id
    assert [d.index for d in g.devices] == [mesh[r, c].id for r in range(P) for c in range(Q)]
    with pytest.raises(DlafAssertError):
        Grid(P, Q, devices=[torch.device("cpu")] * (P * Q - 1))
    with pytest.raises(ValueError):
        Grid(P, Q, devices=["cpu"] * (P * Q), ordering="diagonal")


def test_shared_grid():
    g = shared_grid(2, 3, "cpu")
    assert g.num_devices == 6 and g.distinct_devices == [torch.device("cpu")]
    assert "shared" in str(g)


def values(P, Q, shape=(3, 4), seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [[torch.tensor(rng.standard_normal(shape).astype(dtype)) for _ in range(Q)]
            for _ in range(P)]


def line(xs, axis, r, c):
    """The numpy model: the values rank (r, c) talks to along ``axis``."""
    return [xs[i][c] for i in range(len(xs))] if axis == ROW_AXIS else list(xs[r])


@pytest.mark.parametrize("axis", [ROW_AXIS, COL_AXIS])
def test_bcast_and_bcast2d(axis):
    P, Q = 2, 3
    xs = values(P, Q)
    src = 1
    out = cc.bcast(xs, axis, src)
    for r in range(P):
        for c in range(Q):
            assert torch.equal(out[r][c], line(xs, axis, r, c)[src])
            assert out[r][c] is not line(xs, axis, r, c)[src]
    out2 = cc.bcast2d(xs, 1, 2)
    for r in range(P):
        for c in range(Q):
            assert torch.equal(out2[r][c], xs[1][2])


def test_bcast_flattens_negative_zero_like_psum():
    """mask-then-psum adds the masked (+0) contributions: -0.0 arrives as
    +0.0, every other value unchanged."""
    xs = cc.per_rank(2, 2, lambda r, c: torch.tensor([-0.0, 1.5, -2.0, 0.0]))
    for out in (cc.bcast(xs, ROW_AXIS, 0), cc.bcast2d(xs, 1, 1)):
        for row in out:
            for v in row:
                assert torch.equal(v, torch.tensor([0.0, 1.5, -2.0, 0.0]))
                assert not torch.signbit(v[0])
    z = cc.per_rank(1, 2, lambda r, c: torch.tensor([complex(-0.0, -0.0)]))
    got = cc.bcast(z, COL_AXIS, 0)[0][1]
    assert not torch.signbit(got.real).any() and not torch.signbit(got.imag).any()


def test_received_values_are_owned_by_the_receiver():
    """All ranks on one device: mutating what one rank received changes
    neither the sender's value nor any other rank's."""
    xs = values(2, 2, seed=3)
    keep = [[x.clone() for x in row] for row in xs]
    for out in (cc.bcast(xs, COL_AXIS, 0), cc.bcast2d(xs, 0, 1), cc.all_gather(xs, ROW_AXIS),
                cc.all_reduce(xs, ROW_AXIS), cc.send_recv(xs, COL_AXIS, 0, 1),
                cc.barrier_value(xs, ROW_AXIS)):
        before = [[v.clone() for v in row] for row in out]
        out[0][0].add_(100.0)
        for r in range(2):
            for c in range(2):
                assert torch.equal(xs[r][c], keep[r][c])
                if (r, c) != (0, 0):
                    assert torch.equal(out[r][c], before[r][c])


@pytest.mark.parametrize("axis", [ROW_AXIS, COL_AXIS])
def test_all_gather_all_reduce_reduce_send_recv(axis):
    P, Q = 3, 2
    xs = values(P, Q, seed=1)
    gathered = cc.all_gather(xs, axis)
    tiled = cc.all_gather(xs, axis, tiled=True, concat_axis=1)
    for op, fold in (("sum", np.sum), ("max", np.max), ("min", np.min)):
        red = cc.all_reduce(xs, axis, op)
        for r in range(P):
            for c in range(Q):
                want = np.stack([v.numpy() for v in line(xs, axis, r, c)])
                np.testing.assert_allclose(red[r][c].numpy(), fold(want, axis=0), rtol=1e-15)
    root = 1
    red = cc.reduce(xs, axis, root, "sum")
    sent = cc.send_recv(xs, axis, 0, 1)
    for r in range(P):
        for c in range(Q):
            vals = [v.numpy() for v in line(xs, axis, r, c)]
            np.testing.assert_array_equal(gathered[r][c].numpy(), np.stack(vals))
            np.testing.assert_array_equal(tiled[r][c].numpy(), np.concatenate(vals, axis=1))
            pos = r if axis == ROW_AXIS else c
            if pos == root:
                np.testing.assert_allclose(red[r][c].numpy(), np.sum(vals, axis=0), rtol=1e-15)
            else:
                assert not red[r][c].any()
            if pos == 1:
                np.testing.assert_array_equal(sent[r][c].numpy(), vals[0])
            else:
                assert not sent[r][c].any()
    with pytest.raises(ValueError):
        cc.all_reduce(xs, axis, "prod")
    bv = cc.barrier_value(xs, axis)
    assert all(torch.equal(bv[r][c], xs[r][c]) for r in range(P) for c in range(Q))


@pytest.mark.parametrize("verb", ["bcast_row", "bcast_col", "bcast2d", "gather_row",
                                  "gather_col", "sum_row", "max_col"])
def test_verbs_match_reference_shard_map(verb, devices8):
    """The reference's own verbs inside shard_map on a 2x3 mesh, on the
    same per-rank values."""
    P, Q = 2, 3
    xs = values(P, Q, shape=(2, 3), seed=11)
    glob = np.concatenate([np.concatenate([x.numpy() for x in row], axis=1) for row in xs])
    jg = JGrid(P, Q, devices=devices8[:P * Q])
    body, port = {
        "bcast_row": (lambda x: jcc.bcast(x, "row", 1), lambda: cc.bcast(xs, ROW_AXIS, 1)),
        "bcast_col": (lambda x: jcc.bcast(x, "col", 2), lambda: cc.bcast(xs, COL_AXIS, 2)),
        "bcast2d": (lambda x: jcc.bcast2d(x, 1, 0), lambda: cc.bcast2d(xs, 1, 0)),
        "gather_row": (lambda x: jcc.all_gather(x, "row", tiled=True),
                       lambda: cc.all_gather(xs, ROW_AXIS, tiled=True)),
        "gather_col": (lambda x: jcc.all_gather(x, "col", tiled=True),
                       lambda: cc.all_gather(xs, COL_AXIS, tiled=True)),
        "sum_row": (lambda x: jcc.all_reduce(x, "row", "sum"),
                    lambda: cc.all_reduce(xs, ROW_AXIS, "sum")),
        "max_col": (lambda x: jcc.all_reduce(x, "col", "max"),
                    lambda: cc.all_reduce(xs, COL_AXIS, "max")),
    }[verb]
    fn = shard_map(body, mesh=jg.mesh, in_specs=JP("row", "col"), out_specs=JP("row", "col"),
                   check_vma=False)
    ref = np.asarray(fn(jnp.asarray(glob)))
    out = port()
    got = np.concatenate([np.concatenate([x.numpy() for x in row], axis=1) for row in out])
    np.testing.assert_array_equal(got, ref)


def test_dist_context_and_slot_start():
    dist = Distribution(GlobalElementSize(75, 75), TileElementSize(8, 8), GridSize2D(2, 3),
                        source_rank=RankIndex2D(1, 2))
    ctx = DistContext(dist)
    assert (ctx.P, ctx.Q, ctx.ltr, ctx.ltc) == (2, 3, 5, 4)
    for k in range(10):
        assert uniform_slot_start(k, 2) == k // 2 == max(0, -(-(k + 1 - 2) // 2))
        assert ctx.owner_r(k) == (1 + k) % 2 and ctx.owner_c(k) == (2 + k) % 3
        assert ctx.kr(k) == k // 2 and ctx.kc(k) == k // 3
    for r in range(2):
        np.testing.assert_array_equal(ctx.g_rows(r, 1, 3), (1 + np.arange(3)) * 2 + (r - 1) % 2)
    for c in range(3):
        np.testing.assert_array_equal(ctx.g_cols(c, 0, 4), np.arange(4) * 3 + (c - 2) % 3)


def test_sync_tier():
    a = np.random.default_rng(2).standard_normal((20, 20))
    m = Matrix.from_global(a, TileElementSize(4, 4), shared_grid(2, 2, "cpu"))
    np.testing.assert_array_equal(sync.gather(m), a)
    shards = sync.gather_shards(m)
    assert len(shards) == 4 and all(s.shape == (3, 3, 4, 4) for s in shards)
    xs = values(2, 2)
    flat = sync.gather_shards(xs)
    np.testing.assert_array_equal(flat[3], xs[1][1].numpy())
    np.testing.assert_allclose(sync.all_reduce(flat, "sum"), sum(flat))
    np.testing.assert_array_equal(sync.reduce(flat, root=3, op="max"), np.max(flat, axis=0))
    with pytest.raises(ValueError):
        sync.all_reduce(flat, "avg")
    sync.barrier(m, xs[0][0])   # CPU tensors: nothing to wait for
    np.testing.assert_array_equal(sync.gather_shards(torch.ones(2))[0], np.ones(2))


def test_port_imports_nothing_of_jax_or_the_reference():
    """The port package and chip_smoke.py import torch and numpy, never
    jax or dlaf_tpu (only the tests import both)."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "dlaf_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    pattern = re.compile(r"^\s*(import jax|from jax|import dlaf_tpu\b(?!_torch)|"
                         r"from dlaf_tpu(\.|\s)(?!_torch))", re.M)
    assert len(files) > 20
    offenders = [str(f.relative_to(root)) for f in files if pattern.search(f.read_text())]
    assert offenders == []
