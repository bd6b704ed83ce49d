"""Whole-matrix ops of the PyTorch port (``dlaf_tpu_torch/matrix/ops.py``)
against the JAX reference's (``dlaf_tpu/matrix/ops.py``).

The same seeded complex matrix, with a ragged last tile and an imaginary
diagonal, goes into both packages without a grid and on 2x2, 2x4 and 4x2
grids with nonzero source ranks (the port's ranks all on the CPU). The
ops only move entries and add zeros, so the results are equal, entry for
entry. The inputs the caller keeps stay unchanged, and a donated input's
storage is released.
"""

import numpy as np
import pytest
import torch

from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu.common.index2d import RankIndex2D as JRankIndex2D
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix import ops as jops
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import RankIndex2D, TileElementSize
from dlaf_tpu_torch.matrix import ops
from dlaf_tpu_torch.matrix.matrix import Matrix

# (grid, source rank, n, nb)
LAYOUTS = [(None, (0, 0), 13, 4), ((2, 2), (1, 1), 13, 4), ((2, 4), (1, 2), 21, 4),
           ((4, 2), (3, 0), 18, 4), ((2, 2), (0, 1), 8, 8)]
IDS = ["local", "2x2", "2x4", "4x2", "2x2-one-tile"]


def cmat(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))


def both(a, layout, devices8):
    grid, src, _, nb = layout
    jgrid = JGrid(*grid, devices=devices8[:grid[0] * grid[1]]) if grid else None
    pgrid = shared_grid(*grid, "cpu") if grid else None
    jm = JMatrix.from_global(a, JTileElementSize(nb, nb), grid=jgrid,
                             source_rank=JRankIndex2D(*src))
    pm = Matrix.from_global(a, TileElementSize(nb, nb), pgrid, source_rank=RankIndex2D(*src),
                            device="cpu")
    return jm, pm


def storage_copy(m: Matrix):
    return [s.clone() for s in m.shards()]


def unchanged(m: Matrix, before) -> bool:
    return all(torch.equal(x, y) for x, y in zip(m.shards(), before))


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
@pytest.mark.parametrize("conj", [True, False])
def test_transpose(layout, conj, devices8):
    a = cmat(layout[2], 1)
    jm, pm = both(a, layout, devices8)
    before = storage_copy(pm)
    got = ops.transpose(pm, conj=conj).to_numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.transpose(jm, conj=conj).to_numpy()))
    np.testing.assert_array_equal(got, a.conj().T if conj else a.T)
    assert unchanged(pm, before)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_hermitianize(layout, uplo, devices8):
    a = cmat(layout[2], 2)
    jm, pm = both(a, layout, devices8)
    before = storage_copy(pm)
    got = ops.hermitianize(pm, uplo).to_numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.hermitianize(jm, uplo).to_numpy()))
    assert np.array_equal(got, got.conj().T) and not np.diag(got).imag.any()
    assert unchanged(pm, before)
    donated = ops.hermitianize(pm, uplo, donate=True)
    np.testing.assert_array_equal(donated.to_numpy(), got)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_merge_triangle(layout, uplo, devices8):
    a, b = cmat(layout[2], 3), cmat(layout[2], 4)
    ja, pa = both(a, layout, devices8)
    jb, pb = both(b, layout, devices8)
    want = np.asarray(jops.merge_triangle(ja, jb, uplo).to_numpy())
    keep_a, keep_b = storage_copy(pa), storage_copy(pb)
    got = ops.merge_triangle(pa, pb, uplo)
    np.testing.assert_array_equal(got.to_numpy(), want)
    tri, other = (np.tril, np.triu) if uplo == "L" else (np.triu, np.tril)
    np.testing.assert_array_equal(tri(want), tri(a))
    np.testing.assert_array_equal(other(want, 1 if uplo == "L" else -1),
                                  other(b, 1 if uplo == "L" else -1))
    assert unchanged(pa, keep_a) and unchanged(pb, keep_b)
    # the donating form: the same result, written into new's storage
    _, pa2 = both(a, layout, devices8)
    got2 = ops.merge_triangle(pa2, pb, uplo, donate_new=True, donate_orig=True)
    np.testing.assert_array_equal(got2.to_numpy(), want)
    assert all(x.data_ptr() == y.data_ptr() for x, y in zip(got2.shards(), pa2.shards()))
    assert pb.storage is None


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_copy_and_mirrors(layout, devices8):
    a = cmat(layout[2], 5)
    jm, pm = both(a, layout, devices8)
    c = ops.copy(pm)
    assert all(x.untyped_storage().data_ptr() != y.untyped_storage().data_ptr()
               for x, y in zip(c.shards(), pm.shards()))
    np.testing.assert_array_equal(c.to_numpy(), np.asarray(jops.copy(jm).to_numpy()))
    host = ops.mirror_to_host(pm)
    np.testing.assert_array_equal(host, np.asarray(jops.mirror_to_host(jm)))
    back = ops.mirror_to_device(host * 2, pm)
    assert back.dist == pm.dist and back.device == pm.device
    np.testing.assert_array_equal(back.to_numpy(), 2 * a)
