"""Distributed reduction to band of the PyTorch port against the JAX
reference.

The reference's ``shard_map`` programs run on the virtual CPU mesh
(``devices8``); the port's per-rank loops with every rank on the CPU. The
same numpy-seeded Hermitian A goes through both on 2x2, 2x4 and 4x2 grids
with non-zero source ranks, band = nb and band < nb, ragged n, unrolled
and scan, float64 and complex128: band + V and taus elementwise at
``1e-12 ||A||``, the band's eigenvalues within ``100 n eps`` of A's. Also:
``comm_lookahead`` on and off bitwise, the distributed result against the
port's local one, a 4x4 grid at a tiny size, ``extract_band`` without
joining the shards, and the count of the Ozaki product (#6) that
``chip_smoke.py`` asserts for red2band-mxu, held by the plain version's
calls.
"""

import importlib

import numpy as np
import pytest

from dlaf_tpu import config as jcfg
from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu.common.index2d import RankIndex2D as JRankIndex2D
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu_torch import config
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import RankIndex2D, TileElementSize
from dlaf_tpu_torch.matrix import tiling
from dlaf_tpu_torch.matrix.matrix import Matrix
from test_torch_reduction_to_band import (KNOBS, check_against_reference, check_eigenvalues,
                                          herm, set_knobs)

jr = importlib.import_module("dlaf_tpu.eigensolver.reduction_to_band")
pr = importlib.import_module("dlaf_tpu_torch.eigensolver.reduction_to_band")


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


def port(a, nb, grid, src=(0, 0)):
    return Matrix.from_global(a, TileElementSize(nb, nb), shared_grid(*grid, "cpu") if grid
                              else None, source_rank=RankIndex2D(*src), device="cpu")


# (step mode, grid, source rank, dtype, n, nb, band)
CASES = [("unrolled", (2, 2), (1, 1), np.float64, 16, 4, 4),
         ("unrolled", (2, 4), (1, 2), np.complex128, 29, 8, 4),
         ("unrolled", (2, 2), (0, 1), np.complex128, 24, 8, 8),
         ("unrolled", (4, 2), (1, 0), np.float64, 19, 8, 2),
         ("scan", (2, 4), (1, 2), np.float64, 24, 4, 4),
         ("scan", (2, 2), (1, 1), np.complex128, 21, 4, 4),
         ("scan", (2, 2), (0, 1), np.float64, 24, 8, 4),
         ("scan", (2, 4), (1, 0), np.complex128, 19, 8, 2)]


def case_id(c):
    mode, grid, src, dtype, n, nb, band = c
    return (f"{mode}-{grid[0]}x{grid[1]}-src{src[0]}{src[1]}-{np.dtype(dtype).name}"
            f"-{n}-{nb}-{band}")


@pytest.mark.parametrize("mode,grid,src,dtype,n,nb,band", CASES,
                         ids=[case_id(c) for c in CASES])
def test_dist_matches_reference(mode, grid, src, dtype, n, nb, band, devices8, monkeypatch):
    set_knobs(monkeypatch, dist_step_mode=mode)
    jcfg.initialize()
    a = herm(n, dtype, n + band)
    jgrid = JGrid(*grid, devices=devices8[:grid[0] * grid[1]])
    ref = jr.reduction_to_band(JMatrix.from_global(a, JTileElementSize(nb, nb), grid=jgrid,
                                                   source_rank=JRankIndex2D(*src)),
                               band_size=band)
    got = pr.reduction_to_band(port(a, nb, grid, src), band_size=band)
    assert got.band == band
    full = got.matrix.to_numpy()
    check_against_reference(a, (full, got.taus.numpy()), (ref.matrix.to_numpy(), ref.taus))
    check_eigenvalues(a, full, band)
    np.testing.assert_allclose(pr.extract_band(got), np.asarray(jr.extract_band(ref)), rtol=0,
                               atol=1e-12 * np.abs(a).max())


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("grid,src,n,nb,band", [((2, 2), (0, 0), 24, 8, 4),
                                                ((2, 4), (1, 2), 29, 8, 4),
                                                ((4, 2), (1, 1), 21, 4, 4),
                                                ((2, 4), (1, 0), 19, 8, 2)])
def test_comm_lookahead_bitwise(grid, src, n, nb, band, dtype, monkeypatch):
    """The next panel's chain ahead of the bulk gives bitwise the result
    of the plain order."""
    a = herm(n, dtype, 3)
    out = []
    for la in ("0", "1"):
        set_knobs(monkeypatch, dist_step_mode="unrolled", comm_lookahead=la)
        red = pr.reduction_to_band(port(a, nb, grid, src), band_size=band)
        out.append((red.matrix.to_numpy(), red.taus.numpy()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


@pytest.mark.parametrize("mode", ["unrolled", "scan"])
@pytest.mark.parametrize("grid,n,nb,band", [((2, 4), 24, 4, 4), ((4, 4), 40, 4, 2),
                                            ((4, 4), 37, 8, 4)])
def test_dist_matches_port_local(grid, n, nb, band, mode, monkeypatch):
    """The grid's result against the port's own one-rank result, 4x4
    included (the shape of config #4's grid at a tiny size)."""
    set_knobs(monkeypatch, dist_step_mode=mode)
    a = herm(n, np.float64, 77)
    local = pr.reduction_to_band(port(a, nb, None), band_size=band)
    dist = pr.reduction_to_band(port(a, nb, grid, (1, 3)), band_size=band)
    np.testing.assert_allclose(dist.matrix.to_numpy(), local.matrix.to_numpy(), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(dist.taus.numpy(), local.taus.numpy(), rtol=0, atol=1e-11)
    check_eigenvalues(a, dist.matrix.to_numpy(), band)


def test_extract_band_never_joins_the_matrix(monkeypatch):
    """On a grid the band is gathered from the diagonal and first
    sub-diagonal tiles only: joining the shards or forming the global
    matrix inside ``extract_band`` is a regression."""
    n, nb = 24, 4
    a = herm(n, np.float64, 21)
    local = pr.extract_band(pr.reduction_to_band(port(a, nb, None)))
    dist = pr.reduction_to_band(port(a, nb, (2, 4), (1, 1)))

    def refuse(*args, **kw):
        raise AssertionError("extract_band must not join the full matrix")

    monkeypatch.setattr(tiling, "join_shards", refuse)
    monkeypatch.setattr(Matrix, "to_global", refuse)
    np.testing.assert_allclose(pr.extract_band(dist), local, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(2, 2, 64, 16, 4, 32), (2, 2, 72, 16, 4, 32),
                                   (2, 4, 80, 16, 8, 40), (4, 2, 61, 8, 4, 16)])
@pytest.mark.parametrize("la", ["0", "1"])
@pytest.mark.parametrize("shared", [True, False])
def test_chip_smoke_mxu_launch_formula(shape, la, shared, monkeypatch):
    """``chip_smoke.red2band_mxu_launches`` (red2band-mxu's exact count of
    #6) against the calls of the Ozaki product's plain version under
    ``f64_gemm=mxu``, ``ozaki_impl=pallas``, with ``K_MAX`` lowered so
    that the composed route for deeper contractions is taken too;
    ``shared=False`` with every value formed per rank
    (``cc.per_rank_once`` as ``cc.per_rank``), as one process per rank
    forms them: the multi-process form's summed count."""
    import chip_smoke as cs
    from dlaf_tpu_torch.comm import collectives as cc
    from dlaf_tpu_torch.tile_ops import ozaki_kernels as ok

    if not shared:
        monkeypatch.setattr(cc, "per_rank_once", lambda P, Q, key, make: cc.per_rank(P, Q, make))
    P, Q, n, nb, b, k_max = shape
    calls = []
    real = ok.ozaki_product_plain
    monkeypatch.setattr(ok, "ozaki_product_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(ok, "K_MAX", k_max)
    set_knobs(monkeypatch, f64_gemm="mxu", f64_gemm_min_dim=4, ozaki_impl="pallas",
              comm_lookahead=la, dist_step_mode="unrolled")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, n))
    red = pr.reduction_to_band(port((x + x.T) / 2, nb, (P, Q)), band_size=b)
    assert len(calls) == cs.red2band_mxu_launches(P, Q, n, nb, b, k_max=k_max, min_dim=4,
                                                  shared=shared)
    check_eigenvalues((x + x.T) / 2, red.matrix.to_numpy(), b)


def test_shared_card_forms_replicated_values_once(monkeypatch):
    """Every rank of a 4x4 grid on one device: the gathered panel is
    factored once a panel (not once per rank), and the step's replicated
    values are formed once per device, which bounds the operations the
    host dispatches (1371 a panel at this shape)."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    set_knobs(monkeypatch, dist_step_mode="unrolled", comm_lookahead="1")
    n, nb, b = 256, 32, 8
    npan = -(-n // b) - 1
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, n))
    mat = port((x + x.T) / 2, nb, (4, 4))
    with Count() as count:
        pr.reduction_to_band(mat, band_size=b, donate=True)
    assert count.ops["aten.geqrf"] == npan
    assert sum(count.ops.values()) <= 1400 * npan


@pytest.mark.parametrize("mode", ["unrolled", "scan"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("grid,src,n,nb,band", [((2, 2), (1, 0), 24, 8, 4),
                                                ((2, 4), (0, 3), 29, 8, 8)])
def test_shared_values_bitwise_per_rank(grid, src, n, nb, band, dtype, mode, monkeypatch):
    """The values formed once per line and device (the panel factor and
    V T, the gathered panel, W, M, X and their selections, the index data)
    give bitwise the result of forming each on every rank, as a grid with
    one device per rank does."""
    a = herm(n, dtype, 8)
    set_knobs(monkeypatch, dist_step_mode=mode)
    shared = pr.reduction_to_band(port(a, nb, grid, src), band_size=band)
    monkeypatch.setattr(pr.cc, "per_rank_once",
                        lambda P, Q, key, make: pr.cc.per_rank(P, Q, make))
    own = pr.reduction_to_band(port(a, nb, grid, src), band_size=band)
    np.testing.assert_array_equal(shared.matrix.to_numpy(), own.matrix.to_numpy())
    np.testing.assert_array_equal(shared.taus.numpy(), own.taus.numpy())
