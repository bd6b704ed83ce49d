"""The two back-transforms of the PyTorch port against the JAX reference
(``dlaf_tpu/eigensolver/back_transform.py``), and ``cc.all_to_all``.

The same numpy-seeded inputs go through both packages: for the chase
back-transform a random band chased once by the port's native chase (the
reference reads the same reflectors), eigenvector matrices of random
entries; for the reflector-block back-transform a random Hermitian A
reduced by each package's own reduction to band (they agree at 1e-12,
``test_torch_reduction_to_band*.py``). The reference runs on XLA:CPU and
its virtual CPU mesh, the port on CPU tensors, every rank of a grid on the
CPU. Tolerance ``1e-11 ||E||`` (float64, complex128: a few hundred
reflector applications of rounding). Within the port: the reflector-block
builders' look-ahead (``la``) on and off bitwise, the groups of the
blocked chase back-transform against each other and against the sweeps
form at tolerance, as in the reference; the in-place blocked form on a
buffer with the fewest zero rows below E bitwise the padded one, those
rows left zero. The public path runs the blocked
form at the automatic group; the other groups and the sweeps form are
called directly, and the reference is set to the same form through its
``bt_b2t_impl``/``bt_b2t_group`` knobs.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from dlaf_tpu import config as jcfg
from dlaf_tpu._compat import shard_map
from dlaf_tpu.comm import collectives as jcc
from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu.common.index2d import RankIndex2D as JRankIndex2D
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu_torch import config
from dlaf_tpu_torch.comm import collectives as cc
from dlaf_tpu_torch.comm.grid import COL_AXIS, ROW_AXIS, shared_grid
from dlaf_tpu_torch.common.index2d import RankIndex2D, TileElementSize
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.matrix.tiling import tiles_to_global
from dlaf_tpu_torch.miniapp.miniapp_band_to_tridiag import make_band

jbt = importlib.import_module("dlaf_tpu.eigensolver.back_transform")
jb2t = importlib.import_module("dlaf_tpu.eigensolver.band_to_tridiag")
jr = importlib.import_module("dlaf_tpu.eigensolver.reduction_to_band")
pbt = importlib.import_module("dlaf_tpu_torch.eigensolver.back_transform")
pb2t = importlib.import_module("dlaf_tpu_torch.eigensolver.band_to_tridiag")
pr = importlib.import_module("dlaf_tpu_torch.eigensolver.reduction_to_band")

KNOBS = ("BT_B2T_IMPL", "BT_B2T_GROUP", "DIST_STEP_MODE")


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


def set_knobs(monkeypatch, **knobs):
    """Both packages read the same DLAF_<KNOB> variables."""
    for k, v in knobs.items():
        monkeypatch.setenv("DLAF_" + k.upper(), str(v))
    config.initialize()
    jcfg.initialize()


def herm(n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((n, n))
    return ((x + x.conj().T) / 2).astype(dtype)


def randm(n, m, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((n, m))
    return x.astype(dtype)


def chased(n, b, dtype, seed=0):
    """The port's chase of a random band, and the reference's
    ``TridiagResult`` of the same arrays."""
    tri = pb2t.band_to_tridiag(make_band(n, b, dtype, seed), b)
    jtri = jb2t.TridiagResult(d=tri.d, e=tri.e, v=tri.v, tau=tri.tau, phase=tri.phase,
                              band=tri.band)
    return tri, jtri


def assert_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-11 * max(np.abs(ref).max(), 1.0))


def q_times(tri, e, impl="blocked", group=0):
    """``Q E`` on one device by one form of the chase back-transform: the
    public path for the blocked form at the automatic group, else the
    phases and then the form called directly."""
    if impl == "blocked" and group == 0:
        return pbt.bt_band_to_tridiag(tri, e)
    v, tau, phase = pbt._reflectors(tri, e.device)
    e = e.to(v.dtype, copy=True)
    if v.is_complex():
        e *= phase[:, None]
    n = tri.d.shape[0]
    if impl == "sweeps":
        return pbt._bt_b2t_scan(v, tau, e, b=tri.band, n=n)
    g = pbt._effective_group(tri.band, v.shape[0], group, e.device.type)
    return pbt._bt_b2t_blocked(v, tau, e, b=tri.band, n=n, group=g)


def port(a, nb, grid, src=(0, 0)):
    return Matrix.from_global(a, TileElementSize(nb, nb), shared_grid(*grid, "cpu") if grid
                              else None, source_rank=RankIndex2D(*src), device="cpu")


def ref(a, nb, grid, devices8, src=(0, 0)):
    jg = JGrid(*grid, devices=devices8[:grid[0] * grid[1]]) if grid else None
    return JMatrix.from_global(a, JTileElementSize(nb, nb), grid=jg,
                               source_rank=JRankIndex2D(*src))


# ---------------------------------------------------------------------------
# bt_band_to_tridiag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("impl,group", [("blocked", 0), ("blocked", 1), ("blocked", 3),
                                        ("blocked", 5), ("blocked", 9), ("sweeps", 0)])
@pytest.mark.parametrize("n,b", [(16, 4), (13, 3), (40, 8)])
def test_bt_b2t_local_matches_reference(n, b, impl, group, dtype, monkeypatch):
    set_knobs(monkeypatch, bt_b2t_impl=impl, bt_b2t_group=group)
    tri, jtri = chased(n, b, dtype, n + b)
    e0 = np.random.default_rng(5).standard_normal((n, n + 3))
    got = q_times(tri, torch.as_tensor(e0), impl, group).numpy()
    assert_close(got, np.asarray(jbt.bt_band_to_tridiag(jtri, jnp.asarray(e0))))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_bt_b2t_groups_and_sweeps_agree(dtype):
    """Every group, auto included, and "sweeps" give the same Q E at
    tolerance (the reference's contract), and Q is unitary."""
    n, b = 45, 6
    tri, _ = chased(n, b, dtype, 3)
    e0 = torch.as_tensor(np.eye(n))
    outs = []
    for impl, group in (("sweeps", 0), ("blocked", 0), ("blocked", 1), ("blocked", 4),
                        ("blocked", 7), ("blocked", 100)):
        outs.append(q_times(tri, e0, impl, group).numpy())
    for q in outs[1:]:
        assert_close(q, outs[0])
    q = outs[0]
    np.testing.assert_allclose(q.conj().T @ q, np.eye(n), atol=1e-13)
    assert pbt._effective_group(6, 43, 0, "cpu") == 6
    assert pbt._effective_group(128, 4094, 0, "cuda") == 128
    assert pbt._effective_group(128, 4094, 0, "cpu") == 64
    assert pbt._effective_group(4, 100, 100, "cpu") == 5
    assert pbt._effective_group(4, 3, 0, "cuda") == 3


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("n,b,group", [(40, 8, 8), (45, 6, 4), (13, 3, 4), (64, 16, 16)])
def test_bt_b2t_in_place_needs_band_plus_group_rows(n, b, group, dtype):
    """The in-place blocked form on a buffer of E and the fewest zero rows
    below it, ``b + G - 2``: bitwise the padded wrapper's Q E, and the
    rows below E still zero (the reflectors are zero there, which is what
    lets the levels that start below row n be skipped)."""
    tri, _ = chased(n, b, dtype, 11)
    v, tau, _ = pbt._reflectors(tri, "cpu")
    e0 = torch.as_tensor(randm(n, n + 2, dtype, 6))
    buf = e0.new_zeros((n + b + group - 2, n + 2))
    buf[:n] = e0
    pbt._bt_b2t_blocked_inplace(v, tau, buf, b=b, n=n, group=group)
    assert torch.equal(buf[:n], pbt._bt_b2t_blocked(v, tau, e0, b=b, n=n, group=group))
    assert not buf[n:].any()


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("grid,src,n,nb,b", [((2, 2), (0, 0), 24, 4, 4),
                                             ((2, 3), (1, 2), 21, 4, 4),
                                             ((2, 3), (0, 1), 29, 8, 3),
                                             ((4, 2), (1, 1), 24, 4, 4)])
@pytest.mark.parametrize("impl", ["blocked", "sweeps"])
def test_bt_b2t_dist_matches_reference(grid, src, n, nb, b, dtype, impl, devices8,
                                       monkeypatch):
    """The distributed (blocked) form against the reference's distributed
    ``impl`` form and against the port's local ``impl`` form."""
    set_knobs(monkeypatch, bt_b2t_impl=impl)
    tri, jtri = chased(n, b, dtype, 7)
    e0 = randm(n, n, np.float64, 8)
    mat = port(e0, nb, grid, src)
    got = pbt.bt_band_to_tridiag(tri, mat)
    want = jbt.bt_band_to_tridiag(jtri, ref(e0, nb, grid, devices8, src))
    assert got.distributed and got.dist == mat.dist
    assert_close(got.to_numpy(), np.asarray(want.to_numpy()))
    local = q_times(tri, torch.as_tensor(e0), impl).numpy()
    assert_close(got.to_numpy(), local)


def test_bt_b2t_leaves_the_input_alone():
    tri, _ = chased(20, 4, np.float64, 2)
    e0 = torch.as_tensor(randm(20, 20, np.float64, 1))
    keep = e0.clone()
    mat = port(e0.numpy(), 4, (2, 2))
    shards = [s.clone() for s in mat.storage]
    pbt.bt_band_to_tridiag(tri, e0)
    pbt.bt_band_to_tridiag(tri, mat)
    assert torch.equal(e0, keep)
    assert all(torch.equal(a, b) for a, b in zip(mat.storage, shards))


# ---------------------------------------------------------------------------
# bt_reduction_to_band
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("n,nb,band", [(16, 4, 4), (21, 8, 4), (33, 8, 8), (24, 8, 2)])
def test_bt_r2b_local_matches_reference(n, nb, band, dtype):
    a = herm(n, dtype, n)
    e0 = randm(n, n - 2, dtype, 4)
    red = pr.reduction_to_band(port(a, nb, None), band_size=band)
    outs = [pbt.bt_reduction_to_band(red, torch.as_tensor(e0)).numpy()]
    # the look-ahead, on no path, reorders the same operations: bitwise
    a_v = tiles_to_global(red.matrix.storage, red.matrix.dist)
    outs.append(pbt._bt_r2b_local(a_v, red.taus, torch.as_tensor(e0).clone(), nb=band,
                                  la=True).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    jred = jr.reduction_to_band(ref(a, nb, None, None), band_size=band)
    assert_close(outs[0], np.asarray(jbt.bt_reduction_to_band(jred, jnp.asarray(e0))))
    # the product with the band's eigenvectors diagonalizes A
    full = red.matrix.to_numpy()
    bandm = np.zeros_like(full)
    for r in range(band + 1):
        d = np.diagonal(full, -r)
        bandm += np.diag(d, -r) + (np.diag(d.conj(), r) if r else 0)
    w, zb = np.linalg.eigh(bandm)
    z = pbt.bt_reduction_to_band(red, torch.as_tensor(zb)).numpy()
    np.testing.assert_allclose(a @ z, z * w[None, :], atol=1e-12 * n * np.abs(a).max())


@pytest.mark.parametrize("mode", ["unrolled", "scan"])
@pytest.mark.parametrize("grid,src,n,nb,band,dtype", [
    ((2, 2), (0, 0), 24, 4, 4, np.float64), ((2, 3), (1, 2), 29, 8, 4, np.complex128),
    ((4, 2), (0, 1), 18, 8, 2, np.float64), ((2, 2), (1, 0), 20, 8, 2, np.complex128)])
def test_bt_r2b_dist_matches_reference(grid, src, n, nb, band, mode, dtype, devices8,
                                       monkeypatch):
    set_knobs(monkeypatch, dist_step_mode=mode)
    a = herm(n, dtype, 40 + n)
    e0 = randm(n, n, dtype, 9)
    red = pr.reduction_to_band(port(a, nb, grid, src), band_size=band)
    got = pbt.bt_reduction_to_band(red, port(e0, nb, grid, src))
    jred = jr.reduction_to_band(ref(a, nb, grid, devices8, src), band_size=band)
    want = jbt.bt_reduction_to_band(jred, ref(e0, nb, grid, devices8, src))
    assert_close(got.to_numpy(), np.asarray(want.to_numpy()))
    local = pbt.bt_reduction_to_band(pr.reduction_to_band(port(a, nb, None), band_size=band),
                                     torch.as_tensor(e0)).numpy()
    assert_close(got.to_numpy(), local)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("grid,n,nb,band", [((2, 2), 24, 4, 4), ((2, 4), 29, 8, 2),
                                            ((4, 4), 40, 4, 4)])
def test_bt_r2b_dist_lookahead_bitwise(grid, n, nb, band, dtype, monkeypatch):
    a = herm(n, dtype, 5)
    e0 = randm(n, n, dtype, 6)
    red = pr.reduction_to_band(port(a, nb, grid, (1, 1)), band_size=band)
    mat = port(e0, nb, grid, (1, 1))
    keep = [s.clone() for s in mat.storage]
    set_knobs(monkeypatch, dist_step_mode="unrolled")
    outs = [pbt.bt_reduction_to_band(red, mat).to_numpy()]
    assert all(torch.equal(s, k) for s, k in zip(mat.storage, keep))
    # the look-ahead, on no path, through the unrolled builder directly
    P, Q = grid
    shards = [s.clone() for s in mat.storage]
    lts_a = cc.per_rank(P, Q, lambda r, c: red.matrix.storage[r * Q + c])
    lts_c = cc.per_rank(P, Q, lambda r, c: shards[r * Q + c])
    pbt._dist_bt_r2b(lts_a, red.taus, lts_c, red.matrix.dist, mat.dist, band, la=True)
    outs.append(Matrix(mat.dist, shards, mat.grid).to_numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# cc.all_to_all
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis,split,concat", [("row", 1, 0), ("row", 0, 1), ("col", 0, 1),
                                               ("col", 1, 0)])
def test_all_to_all_matches_reference_shard_map(axis, split, concat, devices8):
    """The reference's verb inside shard_map on a 2x3 mesh against the
    port's, on the same per-rank values."""
    P, Q = 2, 3
    size = 2 if axis == "row" else 3
    shape = [size * 2, size * 3]
    rng = np.random.default_rng(3)
    vals = [[rng.standard_normal(shape) for _ in range(Q)] for _ in range(P)]
    glob = np.concatenate([np.concatenate(row, axis=1) for row in vals])
    jg = JGrid(P, Q, devices=devices8[:P * Q])
    fn = shard_map(lambda x: jcc.all_to_all(x, axis, split_axis=split, concat_axis=concat),
                   mesh=jg.mesh, in_specs=JP("row", "col"), out_specs=JP("row", "col"),
                   check_vma=False)
    want = np.asarray(fn(jnp.asarray(glob)))
    xs = [[torch.as_tensor(v) for v in row] for row in vals]
    out = cc.all_to_all(xs, ROW_AXIS if axis == "row" else COL_AXIS, split_axis=split,
                        concat_axis=concat)
    got = np.concatenate([np.concatenate([x.numpy() for x in row], axis=1) for row in out])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="divide"):
        cc.all_to_all([[torch.zeros(3, 5)] * Q] * P, COL_AXIS, split_axis=1, concat_axis=0)
