"""Reduction to band of the PyTorch port on one rank, against the JAX
reference (``dlaf_tpu/eigensolver/reduction_to_band.py``).

The same numpy-seeded Hermitian A goes through the reference's local
builders (``_red2band_local``, ``_red2band_local_scan``, XLA:CPU) and the
port's (CPU tensors). Both factor panels with LAPACK's geqrf, so the band,
the reflectors below it and the taus agree elementwise: tolerance
``1e-12 ||A||`` (float32: ``1e-4 ||A||``), and the band's eigenvalues
agree with A's within ``100 n eps`` (the miniapp's check). The reference
test's shapes (``tests/test_reduction_to_band.py:61-100, 266-285``),
band < nb included. Also: the asserts, the step-mode routing,
``extract_band``'s layout and edges, and ``donate=False`` leaving the
storage bitwise unchanged on every local route.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlaf_tpu_torch import config
from dlaf_tpu_torch.common.asserts import DlafAssertError
from dlaf_tpu_torch.common.index2d import TileElementSize
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.matrix.matrix import Matrix

jr = importlib.import_module("dlaf_tpu.eigensolver.reduction_to_band")
pr = importlib.import_module("dlaf_tpu_torch.eigensolver.reduction_to_band")

KNOBS = ("DIST_STEP_MODE", "F64_GEMM", "F64_GEMM_MIN_DIM", "COMM_LOOKAHEAD", "OZAKI_IMPL")


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    yield
    for knob in KNOBS:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()


def set_knobs(monkeypatch, **knobs):
    for k, v in knobs.items():
        monkeypatch.setenv("DLAF_" + k.upper(), str(v))
    config.initialize()


def herm(n, dtype, seed):
    """The reference test's input."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((n, n))
    return ((x + x.conj().T) / 2).astype(dtype)


def eps_of(dtype):
    return float(np.finfo(np.dtype(dtype).type(0).real.dtype).eps)


def band_dense(full, band):
    """The Hermitian band matrix held in the lower band of ``full``."""
    out = np.zeros_like(full)
    for r in range(min(band, full.shape[0] - 1) + 1):
        d = np.diagonal(full, -r)
        out += np.diag(d, -r)
        if r:
            out += np.diag(d.conj(), r)
    return out


def check_eigenvalues(a, full, band):
    w = np.linalg.eigvalsh(band_dense(full.astype(np.complex128 if np.iscomplexobj(a)
                                                  else np.float64), band))
    w_ref = np.linalg.eigvalsh(a.astype(np.complex128 if np.iscomplexobj(a) else np.float64))
    n = a.shape[0]
    assert np.abs(w - w_ref).max() / np.abs(w_ref).max() < 100 * n * eps_of(a.dtype)


def check_against_reference(a, got, ref):
    """Band + V and taus elementwise at ``1e-12 ||A||`` (float32 ``1e-4``)."""
    scale = np.abs(a).max() * (1e-4 if a.dtype == np.float32 else 1e-12)
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), rtol=0, atol=scale)
    np.testing.assert_allclose(got[1], np.asarray(ref[1]), rtol=0, atol=scale)


LOCAL = [(16, 4, 4), (24, 8, 8), (13, 4, 4), (8, 8, 8), (24, 8, 4), (24, 8, 2), (32, 16, 4),
         (13, 4, 2)]


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("n,nb,band", LOCAL)
def test_local_matches_reference(n, nb, band, dtype):
    a = herm(n, dtype, n + band)
    ref = jr._red2band_local(jnp.asarray(a), nb=band)
    out, taus = pr._red2band_local(torch.tensor(a), nb=band)
    check_against_reference(a, (out.numpy(), taus.numpy()), ref)
    check_eigenvalues(a, out.numpy(), band)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128, np.float32])
@pytest.mark.parametrize("n,band", [(32, 8), (29, 8), (24, 4), (7, 8)])
def test_local_scan_matches_reference(n, band, dtype):
    a = herm(n, dtype, n + band)
    ref = jr._red2band_local_scan(jnp.asarray(a), nb=band)
    out, taus = pr._red2band_local_scan(torch.tensor(a), nb=band)
    check_against_reference(a, (out.numpy(), taus.numpy()), ref)
    check_eigenvalues(a, out.numpy(), band)


def test_asserts():
    a = herm(16, np.float64, 1)
    with pytest.raises(DlafAssertError, match="not divisible"):
        pr.reduction_to_band(Matrix.from_global(a, TileElementSize(4, 4), device="cpu"),
                             band_size=3)
    with pytest.raises(DlafAssertError, match="band_size must be >= 1"):
        pr.reduction_to_band(Matrix.from_global(a, TileElementSize(4, 4), device="cpu"),
                             band_size=0)
    with pytest.raises(DlafAssertError, match="square only"):
        pr.reduction_to_band(Matrix.from_global(a[:12], TileElementSize(4, 4), device="cpu"))
    with pytest.raises(DlafAssertError, match="square blocks"):
        pr.reduction_to_band(Matrix.from_global(a, TileElementSize(4, 8), device="cpu"))


@pytest.mark.parametrize("mode", ["unrolled", "scan"])
def test_public_api_matches_reference(mode, monkeypatch):
    """The public entry on one rank, both step modes, against the
    reference's public entry under the same ``dist_step_mode``."""
    from dlaf_tpu import config as jcfg
    from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
    from dlaf_tpu.matrix.matrix import Matrix as JMatrix

    n, nb, band = 29, 8, 4
    a = herm(n, np.float64, 5)
    monkeypatch.setenv("DLAF_DIST_STEP_MODE", mode)
    config.initialize()
    jcfg.initialize()
    try:
        ref = jr.reduction_to_band(JMatrix.from_global(a, JTileElementSize(nb, nb)),
                                   band_size=band)
        got = pr.reduction_to_band(Matrix.from_global(a, TileElementSize(nb, nb),
                                                      device="cpu"), band_size=band)
    finally:
        monkeypatch.delenv("DLAF_DIST_STEP_MODE")
        jcfg.initialize()
    assert got.band == band
    assert tuple(got.taus.shape) == tuple(np.asarray(ref.taus).shape) == (-(-n // band) - 1,
                                                                           band)
    check_against_reference(a, (got.matrix.to_numpy(), got.taus.numpy()),
                            (ref.matrix.to_numpy(), ref.taus))
    np.testing.assert_array_equal(pr.extract_band(got).shape, (band + 1, n))


def test_step_mode_routing(monkeypatch):
    """``dist_step_mode=auto`` takes the scan form from
    ``STEP_MODE_AUTO_SCAN_AT`` panels on, the unrolled one below."""
    calls = []
    real = pr._red2band_local_scan
    monkeypatch.setattr(pr, "_red2band_local_scan",
                        lambda *a, **k: calls.append("scan") or real(*a, **k))
    monkeypatch.setitem(config.STEP_MODE_AUTO_SCAN_AT, "cpu", 3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((24, 24))
    pr.reduction_to_band(Matrix.from_global((x + x.T) / 2, TileElementSize(8, 8), device="cpu"),
                         band_size=4)      # 5 panels >= 3: scan
    assert calls == ["scan"]
    calls.clear()
    pr.reduction_to_band(Matrix.from_global((x[:8, :8] + x[:8, :8].T) / 2,
                                            TileElementSize(4, 4), device="cpu"))
    assert calls == []                     # 1 panel < 3: unrolled


def test_extract_band_layout():
    n, nb = 16, 4
    red = pr.reduction_to_band(Matrix.from_global(herm(n, np.float64, 3), TileElementSize(nb, nb),
                                                  device="cpu"))
    band = pr.extract_band(red)
    assert band.shape == (nb + 1, n) and band.dtype == np.float64
    full = red.matrix.to_numpy()
    for r in range(nb + 1):
        np.testing.assert_array_equal(band[r, :n - r], np.diagonal(full, -r))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("n,nb,b", [(16, 4, 2), (13, 4, 4), (13, 4, 1), (3, 4, 2), (0, 4, 2)])
def test_extract_band_sub_blocksize_and_edge(n, nb, b, dtype):
    """Against the reference's ``extract_band`` of the same matrix, and
    against the diagonals of the port's full matrix, zero past its end."""
    from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
    from dlaf_tpu.matrix.matrix import Matrix as JMatrix

    a = herm(n, dtype, 5)
    red = pr.reduction_to_band(Matrix.from_global(a, TileElementSize(nb, nb), device="cpu"),
                               band_size=b)
    band = pr.extract_band(red)
    assert band.shape == (b + 1, n) and band.dtype == np.dtype(dtype)
    ref = jr.BandReduction(JMatrix.from_global(red.matrix.to_numpy(), JTileElementSize(nb, nb)),
                           None, b)
    np.testing.assert_array_equal(band, np.asarray(jr.extract_band(ref)))
    full = red.matrix.to_numpy()
    for r in range(b + 1):
        np.testing.assert_array_equal(band[r, :max(n - r, 0)], np.diagonal(full, -r))
        assert np.all(band[r, max(n - r, 0):] == 0)


def snapshot(mat):
    return [s.clone() for s in mat.shards()]


@pytest.mark.parametrize("mode", ["unrolled", "scan"])
@pytest.mark.parametrize("grid", [None, (1, 1), (2, 2)])
@pytest.mark.parametrize("n,nb,band", [(8, 8, 8), (6, 8, 4), (24, 8, 4)])
def test_donate_false_leaves_storage(n, nb, band, grid, mode, monkeypatch):
    """n == nb, n < nb and several tiles, without a grid, on a 1x1 grid
    and on 2x2, both step modes: ``donate=False`` leaves the storage
    bitwise unchanged; ``donate=True`` releases it, with the same
    result."""
    set_knobs(monkeypatch, dist_step_mode=mode)
    a = herm(n, np.complex128, 9)
    g = shared_grid(*grid, "cpu") if grid else None
    mat = Matrix.from_global(a, TileElementSize(nb, nb), g, device="cpu")
    before = snapshot(mat)
    red = pr.reduction_to_band(mat, band_size=band)
    assert all(torch.equal(s, b) for s, b in zip(mat.shards(), before))
    again = pr.reduction_to_band(mat, band_size=band, donate=True)
    assert mat.storage is None
    np.testing.assert_array_equal(again.matrix.to_numpy(), red.matrix.to_numpy())
    assert torch.equal(again.taus, red.taus)
