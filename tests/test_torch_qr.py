"""The QR pieces of the PyTorch port against the JAX reference:
``tile_ops/lapack.larft``, ``tile_ops/qr_panel`` (``householder_qr``,
``panel_qr``, ``rebuild_q``) and ``algorithms/qr.t_factor`` (local, and on
2x2 and 2x4 grids with the source rank (1, 2) wrapped to the grid, every
rank of the port on the CPU).

Inputs are the reference tests' (``tests/test_qr.py``,
``tests/test_qr_panel.py``): seeded random panels and reflector panels
with unitary factors, some with a zero tau (a null reflector: T's row and
column zero; the distributed Gram keeps its stored column, as the
reference's does, so only there T is held against the reference's
distributed T and not against ``larft``). Tolerances: the panel QR
agrees with the reference's to ``1e-12`` absolute (the same column sweep
and LAPACK's sign convention; on the CPU the port's ``geqrf`` is LAPACK,
as the reference's), its backward error and orthogonality under
``50 k eps``; T agrees with the reference's to ``1e-12`` relative and
satisfies the compact-WY identity to ``1e-12 m`` (``check_t``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlaf_tpu import config as jcfg
from dlaf_tpu.algorithms.qr import t_factor as j_t_factor
from dlaf_tpu.tile_ops import lapack as jlapack
from dlaf_tpu.tile_ops import qr_panel as jqp
from dlaf_tpu_torch import config
from dlaf_tpu_torch.algorithms.qr import t_factor
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.asserts import DlafAssertError
from dlaf_tpu_torch.common.index2d import RankIndex2D, TileElementSize
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.tile_ops import lapack as tl
from dlaf_tpu_torch.tile_ops import qr_panel as qp
from test_qr import check_t, reflector_panel

EPS = float(np.finfo(np.float64).eps)


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    monkeypatch.delenv("DLAF_QR_PANEL", raising=False)
    config.initialize()
    jcfg.initialize()
    yield
    monkeypatch.delenv("DLAF_QR_PANEL", raising=False)
    config.initialize()
    jcfg.initialize()


def panel(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("shape", [(64, 16), (33, 16), (16, 16), (257, 32), (8, 12)])
def test_householder_qr_matches_reference(shape, dtype):
    a = panel(shape, dtype, sum(shape))
    rv, rt = jqp.householder_qr(jnp.asarray(a))
    v, t = qp.householder_qr(torch.tensor(a))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.numpy(), np.asarray(rt), rtol=0, atol=1e-12)
    m, k = shape
    kk = min(m, k)
    q = qp.rebuild_q(v, t)
    r = np.triu(v.numpy()[:kk])
    assert np.linalg.norm(a[:, :kk] - q[:, :kk] @ r[:, :kk]) / np.linalg.norm(a) < 50 * k * EPS
    assert np.linalg.norm(q[:, :kk].conj().T @ q[:, :kk] - np.eye(kk)) < 50 * k * EPS


def test_householder_qr_batched_and_null_reflector():
    """Leading dims batch; a column already reduced (zero tail, real
    diagonal) is a null reflector with tau = 0, as LAPACK."""
    a = panel((3, 20, 6), np.float64, 4)
    a[1, 1:, 0] = 0.0
    v, t = qp.householder_qr(torch.tensor(a))
    for i in range(3):
        vi, ti = qp.householder_qr(torch.tensor(a[i]))
        np.testing.assert_allclose(v[i].numpy(), vi.numpy(), rtol=0, atol=1e-13)
        np.testing.assert_allclose(t[i].numpy(), ti.numpy(), rtol=0, atol=1e-13)
    assert float(t[1, 0]) == 0.0
    rv, rt = jqp.householder_qr(jnp.asarray(a[1]))
    np.testing.assert_allclose(t[1].numpy(), np.asarray(rt), rtol=0, atol=1e-12)


@pytest.mark.parametrize("route", ["geqrf", "householder"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_panel_qr_routes(route, dtype, monkeypatch):
    """The port's ``panel_qr`` (geqrf) against the reference's through
    either of its ``qr_panel`` routes, which share geqrf's convention: to
    roundoff."""
    monkeypatch.setenv("DLAF_QR_PANEL", route)
    jcfg.initialize()
    a = panel((48, 12), dtype, 7)
    rv, rt = jqp.panel_qr(jnp.asarray(a))
    v, t = qp.panel_qr(torch.tensor(a))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.numpy(), np.asarray(rt), rtol=0, atol=1e-12)


def test_panel_qr_is_geqrf():
    a = torch.tensor(panel((30, 10), np.float64, 8))
    v, t = qp.panel_qr(a)
    gv, gt = torch.geqrf(a)
    assert torch.equal(v, gv) and torch.equal(t, gt)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("m,k,zero", [(24, 8, None), (16, 16, 3), (13, 5, 0)])
def test_larft_matches_reference(m, k, zero, dtype):
    v, taus = reflector_panel(m, k, dtype, seed=m)
    if zero is not None:
        taus[zero] = 0   # a null reflector; its stored column is not read
    ref = np.asarray(jlapack.larft(jnp.asarray(v), jnp.asarray(taus)))
    got = tl.larft(torch.tensor(v), torch.tensor(taus)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    if zero is not None:
        assert not got[zero].any() and not got[:, zero].any()
    else:
        check_t(v, taus, got)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_t_factor_local(dtype):
    v, taus = reflector_panel(24, 8, dtype, seed=1)
    ref = np.asarray(j_t_factor(v, taus))
    for arg in (v, torch.tensor(v), Matrix.from_global(v, TileElementSize(8, 8), device="cpu")):
        got = t_factor(arg, taus).numpy()
        check_t(v, taus, got)
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("grid_shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("zero_tau", [False, True])
def test_t_factor_distributed(grid_shape, dtype, zero_tau, devices8):
    from dlaf_tpu.comm.grid import Grid as JGrid
    from dlaf_tpu.common.index2d import RankIndex2D as JRankIndex2D
    from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
    from dlaf_tpu.matrix.matrix import Matrix as JMatrix

    m, k = 40, 8
    v, taus = reflector_panel(m, k, dtype, seed=3)
    if zero_tau:
        taus[5] = 0
    src = (1 % grid_shape[0], 2 % grid_shape[1])
    jm = JMatrix.from_global(v, JTileElementSize(8, 8),
                             grid=JGrid(*grid_shape, devices=devices8[:grid_shape[0] *
                                                                    grid_shape[1]]),
                             source_rank=JRankIndex2D(*src))
    ref = np.asarray(j_t_factor(jm, taus))
    vm = Matrix.from_global(v, TileElementSize(8, 8), shared_grid(*grid_shape, "cpu"),
                            source_rank=RankIndex2D(*src), device="cpu")
    got = t_factor(vm, taus)
    assert tuple(got.shape) == (k, k)
    got = got.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    if not zero_tau:
        # a null reflector's stored column stays in the distributed Gram
        # (as in the reference), where larft drops it: compare only here
        np.testing.assert_allclose(got, t_factor(v, taus).numpy(), rtol=1e-12, atol=1e-13)
        check_t(v, taus, got)
    else:
        assert not got[5].any() and not got[:, 5].any()


def test_t_factor_needs_one_block_column():
    v, taus = reflector_panel(24, 8, np.float64, seed=2)
    with pytest.raises(DlafAssertError):
        t_factor(Matrix.from_global(v, TileElementSize(8, 4), device="cpu"), taus)
