"""Matrix layer, foundations and configuration of the PyTorch port against
the JAX reference.

Layouts are held bitwise: the port keeps the reference's 4-D tile storage,
so the same numpy input must give the same storage in both packages, and
``from_jax_storage``/``to_jax_storage`` must carry it across unchanged.
"""

import numpy as np
import pytest
import torch

from dlaf_tpu import types as jtypes
from dlaf_tpu.common.index2d import GlobalElementSize as JGlobalElementSize
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu.matrix.tiling import storage_tile_grid as j_storage_tile_grid
from dlaf_tpu.miniapp.generators import hpd_element_fn as j_hpd_element_fn
from dlaf_tpu_torch import config, types
from dlaf_tpu_torch.common.asserts import DlafAssertError
from dlaf_tpu_torch.common.index2d import GlobalElementSize, GlobalTileIndex, TileElementSize
from dlaf_tpu_torch.common.sync import hard_fence
from dlaf_tpu_torch.health.info import first_bad_info, local_factor_info
from dlaf_tpu_torch.matrix.convert import from_jax_storage, to_jax_storage
from dlaf_tpu_torch.matrix.distribution import Distribution
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.matrix.tiling import storage_tile_grid
from dlaf_tpu_torch.miniapp.generators import hpd_element_fn
from dlaf_tpu_torch.tile_ops import blas, lapack

SHAPES = [(72, 72, 16), (50, 30, 16), (16, 16, 16), (5, 7, 4)]


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    for knob in ("CHOLESKY_TRAILING", "CHOLESKY_LOOKAHEAD", "PANEL_IMPL", "STEP_IMPL"):
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    yield
    config.initialize()


@pytest.mark.parametrize("m,n,nb", SHAPES)
def test_storage_matches_reference_bitwise(m, n, nb):
    a = np.random.default_rng(m * n).standard_normal((m, n)).astype(np.float32)
    ref = np.asarray(JMatrix.from_global(a, JTileElementSize(nb, nb)).storage)
    mat = Matrix.from_global(a, TileElementSize(nb, nb), device="cpu")
    np.testing.assert_array_equal(to_jax_storage(mat), ref)
    np.testing.assert_array_equal(mat.to_numpy(), a)
    assert storage_tile_grid(mat.dist) == j_storage_tile_grid(
        JMatrix.from_global(a, JTileElementSize(nb, nb)).dist)


@pytest.mark.parametrize("m,n,nb", SHAPES)
def test_jax_storage_round_trip(m, n, nb):
    a = np.random.default_rng(3).standard_normal((m, n))
    jm = JMatrix.from_global(a, JTileElementSize(nb, nb))
    tiles = np.asarray(jm.storage)
    dist = Distribution(GlobalElementSize(m, n), TileElementSize(nb, nb))
    mat = from_jax_storage(tiles, dist, device="cpu")
    np.testing.assert_array_equal(mat.to_numpy(), np.asarray(jm.to_numpy()))
    back = to_jax_storage(mat)
    assert back.dtype == tiles.dtype
    np.testing.assert_array_equal(back, tiles)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_from_element_fn_matches_reference(dtype):
    n, nb = 37, 8
    ref = JMatrix.from_element_fn(j_hpd_element_fn(n, dtype), JGlobalElementSize(n, n),
                                  JTileElementSize(nb, nb), dtype=dtype)
    mat = Matrix.from_element_fn(hpd_element_fn(n, dtype), GlobalElementSize(n, n),
                                 TileElementSize(nb, nb), dtype=dtype, device="cpu")
    np.testing.assert_array_equal(to_jax_storage(mat), np.asarray(ref.storage))


def test_distribution_tiles_and_asserts():
    dist = Distribution(GlobalElementSize(50, 30), TileElementSize(16, 16))
    assert tuple(dist.nr_tiles) == (4, 2)
    assert tuple(dist.tile_size_of(GlobalTileIndex(3, 1))) == (2, 14)
    with pytest.raises(DlafAssertError):
        Matrix(dist, torch.zeros(1, 1, 16, 16))


@pytest.mark.parametrize("letter", ["s", "d", "c", "z"])
def test_types_match_reference(letter):
    dt = types.ELEMENT_TYPES[letter]
    assert dt is jtypes.ELEMENT_TYPES[letter]
    assert types.type_letter(dt) == types.type_letter(types.torch_dtype(dt)) == letter
    assert types.total_ops(dt, 10.0, 20.0) == jtypes.total_ops(dt, 10.0, 20.0)
    assert types.is_complex(dt) == jtypes.is_complex(dt)
    assert types.ceil_div(33, 16) == jtypes.ceil_div(33, 16) == 3


def test_potrf_info_nan_prefix_contract():
    """The composed potrf marks its failure like the reference's kernels:
    NaN from the failing column on; info is its 1-based index."""
    a = torch.tensor([[4.0, 0.0, 0.0], [2.0, 1.0, 0.0], [1.0, 1.0, 5.0]])
    f, info = lapack.potrf_info("L", a)
    assert int(info) == 2
    assert torch.isfinite(f[:, 0]).all() and not torch.isfinite(f[1:, 1:].diagonal()).any()
    assert int(local_factor_info(f)) == 2
    assert int(first_bad_info(torch.zeros(3, dtype=torch.bool))) == 0


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_composed_tile_ops_match_numpy(uplo):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((12, 12))
    a = x @ x.T + 12 * np.eye(12)
    garbage = a + (np.triu if uplo == "L" else np.tril)(np.full((12, 12), 9.0),
                                                       1 if uplo == "L" else -1)
    f = lapack.potrf(uplo, torch.tensor(garbage)).numpy()
    low = np.linalg.cholesky(a)
    tri = low if uplo == "L" else low.T
    np.testing.assert_allclose((np.tril if uplo == "L" else np.triu)(f), tri, rtol=1e-12,
                               atol=1e-12)
    b = rng.standard_normal((5, 12))
    x_ = blas.trsm("R", uplo, "C", "N", torch.tensor(f), torch.tensor(b)).numpy()
    np.testing.assert_allclose(x_ @ tri.T, b, atol=1e-10)
    c = rng.standard_normal((12, 12))
    h = blas.herk(uplo, "N", torch.tensor(b.T), torch.tensor(c), alpha=-1.0).numpy()
    keep = (np.tril if uplo == "L" else np.triu)
    np.testing.assert_allclose(keep(h), keep(c - b.T @ b), atol=1e-12)


def test_config_layering_and_auto(monkeypatch):
    assert config.resolve("step_impl", "cuda") == "fused"
    assert config.resolve("step_impl", "cpu") == "xla"
    # cuda resolves by the card's measurements: native float64 products
    # ("biggemm", f64_gemm "native"); a call that asks for the Ozaki route
    # gets its kernels
    assert config.resolve("cholesky_trailing", "cuda") == "biggemm"
    assert config.resolve("cholesky_trailing", "cpu") == "loop"
    assert config.resolve("cholesky_lookahead", "cuda") == "1"
    assert config.resolve("f64_gemm", "cuda") == "native"
    assert config.resolve("f64_trsm", "cuda") == "native"
    assert config.resolve("f64_trsm", "cpu") == "native"
    assert config.resolve("ozaki_impl", "cuda") == "pallas"
    assert config.resolve("ozaki_impl", "cpu") == "jnp"
    assert config.resolve_slices() == 8
    monkeypatch.setenv("DLAF_F64_GEMM_SLICES", "6")
    monkeypatch.setenv("DLAF_MIXED_COND_LIMIT", "50")
    config.initialize(argv=["--dlaf:ozaki-impl=pallas"])
    assert config.resolve_slices() == 6
    assert config.get_configuration().mixed_cond_limit == 50.0
    assert config.get_configuration().ozaki_impl == "pallas"
    monkeypatch.delenv("DLAF_F64_GEMM_SLICES")
    monkeypatch.delenv("DLAF_MIXED_COND_LIMIT")
    monkeypatch.setenv("DLAF_PANEL_IMPL", "fused")
    config.initialize()
    assert config.resolve("panel_impl", "cpu") == "fused"
    config.initialize(argv=["--dlaf:panel-impl=xla", "--other"])
    assert config.resolve("panel_impl", "cuda") == "xla"
    with pytest.raises(ValueError):
        config.initialize(argv=["--dlaf:step-impl=bogus"])


def test_hard_fence_passes_cpu_tensors_through():
    t = torch.ones(3)
    assert hard_fence(t) is t
    assert hard_fence(t, None) == (t, None)
