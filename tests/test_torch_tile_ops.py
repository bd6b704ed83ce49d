"""The port's small tile ops and helpers against the JAX reference.

``dlaf_tpu_torch.tile_ops.lapack``'s laset, lacpy, lange, lantr, laed4 and
the tile hegst, ``tile_ops.blas``'s add, scal, axpy, gemv and trmv,
``common.index2d``'s ordering helpers, ``types``' ops_weights, base_float,
complex_of, ``SizeType`` and the ``Device``/``Backend`` maps (the
reference's TPU read as CUDA), ``common.asserts``' three tiers and their
switches (each module reloaded under the environment, as both read it at
import), ``miniapp.generators.random_hermitian`` and
``miniapp.miniapp_kernel``, each on the inputs of the reference's own
cases in ``tests/test_tile_ops.py`` and ``tests/test_index2d.py``, held
to ``dlaf_tpu``'s result (at ``200 eps`` of the type where the two run
different arithmetic, bitwise where they move data).
"""

import contextlib
import importlib
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlaf_tpu import types as jtypes
from dlaf_tpu.common import index2d as jix
from dlaf_tpu.miniapp import generators as jgen
from dlaf_tpu.tile_ops import blas as jtb
from dlaf_tpu.tile_ops import lapack as jtl
from dlaf_tpu_torch import types as ptypes
from dlaf_tpu_torch.common import index2d as pix
from dlaf_tpu_torch.miniapp import generators as pgen
from dlaf_tpu_torch.tile_ops import blas as tb
from dlaf_tpu_torch.tile_ops import lapack as tl

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


def rand(rng, shape, dtype):
    a = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def tol(dtype):
    eps = np.finfo(np.dtype(dtype).type(0).real.dtype).eps
    return dict(rtol=200 * eps, atol=200 * eps)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("uplo", ["L", "U", "G"])
def test_laset_lacpy_match_reference(dtype, uplo):
    got = tl.laset(uplo, 2.0, 5.0, (4, 6), dtype)
    assert got.dtype == ptypes.torch_dtype(dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtl.laset(uplo, 2.0, 5.0, (4, 6),
                                                                     dtype)))
    rng = np.random.default_rng(7)
    src, dst = rand(rng, (5, 5), dtype), rand(rng, (5, 5), dtype)
    out = tl.lacpy(uplo, torch.as_tensor(src), torch.as_tensor(dst))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jtl.lacpy(uplo, jnp.asarray(src),
                                                                     jnp.asarray(dst))))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("norm", ["M", "1", "I", "F"])
def test_lange_lantr_match_reference(norm, dtype):
    rng = np.random.default_rng(8)
    a = rand(rng, (5, 7), dtype)
    np.testing.assert_allclose(float(tl.lange(norm, torch.as_tensor(a))),
                               float(jtl.lange(norm, jnp.asarray(a))), rtol=1e-14)
    sq = rand(rng, (5, 5), dtype)
    for uplo in ("L", "U"):
        for diag in ("N", "U"):
            np.testing.assert_allclose(
                float(tl.lantr(norm, uplo, diag, torch.as_tensor(sq))),
                float(jtl.lantr(norm, uplo, diag, jnp.asarray(sq))), rtol=1e-14)


def test_lange_batched_and_empty():
    a = torch.as_tensor(np.random.default_rng(3).standard_normal((3, 4, 5)))
    np.testing.assert_array_equal(tl.lange("M", a).numpy(), a.abs().amax(dim=(-2, -1)).numpy())
    assert tl.lange("M", torch.zeros((2, 0, 3))).shape == (2,)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_hegst_matches_reference(dtype, uplo):
    rng = np.random.default_rng(11)
    n = 6
    x = rand(rng, (n, n), dtype)
    a = x @ x.conj().T + n * np.eye(n, dtype=dtype)
    y = rand(rng, (n, n), dtype)
    bfull = y @ y.conj().T + n * np.eye(n, dtype=dtype)
    bf = np.linalg.cholesky(bfull) if uplo == "L" else np.linalg.cholesky(bfull).conj().T
    got = tl.hegst(1, uplo, torch.as_tensor(a), torch.as_tensor(bf)).numpy()
    ref = np.asarray(jtl.hegst(1, uplo, jnp.asarray(a), jnp.asarray(bf)))
    np.testing.assert_allclose(got, ref, **tol(dtype))
    keep, other = (np.tril, np.triu) if uplo == "L" else (np.triu, np.tril)
    np.testing.assert_array_equal(other(got, 1 if uplo == "L" else -1),
                                  other(a, 1 if uplo == "L" else -1))
    with pytest.raises(ValueError, match="itype"):
        tl.hegst(2, uplo, torch.as_tensor(a), torch.as_tensor(bf))


def test_hegst_is_the_blocked_hegst_diagonal_step():
    """The blocked HEGST's diagonal transform is the tile hegst (one
    function), Hermitian-expanded."""
    from dlaf_tpu_torch.algorithms.gen_to_std import _hegst_diag

    rng = np.random.default_rng(12)
    a = torch.as_tensor(rand(rng, (8, 8), np.complex128))
    l = torch.as_tensor(np.tril(rand(rng, (8, 8), np.complex128)) + 8 * np.eye(8))
    want = tb.hermitian_from(tl.hegst(1, "L", a, l), "L")
    np.testing.assert_array_equal(_hegst_diag("L", a, l, None, False).numpy(), want.numpy())


def test_laed4_matches_reference():
    rng = np.random.default_rng(17)
    k = 8
    d = np.sort(rng.standard_normal(k))
    z = rng.standard_normal(k)
    z /= np.linalg.norm(z)
    lam = tl.laed4(d, z, 0.7)
    np.testing.assert_allclose(np.sort(lam), np.sort(jtl.laed4(d, z, 0.7)), atol=1e-12)
    np.testing.assert_allclose(np.sort(lam), np.linalg.eigvalsh(np.diag(d) + 0.7 * np.outer(z, z)),
                               atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_axpy_gemv_trmv_scal_match_reference(dtype):
    rng = np.random.default_rng(15)
    a, x, y = rand(rng, (4, 4), dtype), rand(rng, 4, dtype), rand(rng, 4, dtype)
    ta, tx, ty = (torch.as_tensor(v) for v in (a, x, y))
    ja, jx, jy = (jnp.asarray(v) for v in (a, x, y))
    t = tol(dtype)
    np.testing.assert_allclose(tb.axpy(tx, ty, alpha=2.5).numpy(),
                               np.asarray(jtb.axpy(jx, jy, alpha=2.5)), **t)
    np.testing.assert_allclose(tb.scal(ta, alpha=-1.5).numpy(),
                               np.asarray(jtb.scal(ja, alpha=-1.5)), **t)
    for op in ("N", "T", "C"):
        np.testing.assert_allclose(tb.gemv(ta, tx, ty, alpha=2.0, beta=-1.0, op_a=op).numpy(),
                                   np.asarray(jtb.gemv(ja, jx, jy, alpha=2.0, beta=-1.0,
                                                       op_a=op)), **t)
        np.testing.assert_allclose(tb.gemv(ta, tx, op_a=op).numpy(),
                                   np.asarray(jtb.gemv(ja, jx, op_a=op)), **t)
        for uplo in ("L", "U"):
            for diag in ("N", "U"):
                np.testing.assert_allclose(tb.trmv(uplo, op, diag, ta, tx).numpy(),
                                           np.asarray(jtb.trmv(uplo, op, diag, ja, jx)), **t)


@pytest.mark.parametrize("dtype", DTYPES)
def test_add_matches_reference(dtype):
    """``tile::add``: ``b + alpha a``."""
    rng = np.random.default_rng(17)
    a, b = rand(rng, (6, 5), dtype), rand(rng, (6, 5), dtype)
    for kw in ({}, {"alpha": -0.75}):
        np.testing.assert_allclose(tb.add(torch.as_tensor(a), torch.as_tensor(b), **kw).numpy(),
                                   np.asarray(jtb.add(jnp.asarray(a), jnp.asarray(b), **kw)),
                                   **tol(dtype))


def test_device_backend_match_reference():
    """The reference's ``Device``/``Backend`` and their default maps, its
    TPU read as the port's CUDA (``Backend::GPU`` in the reference's C++
    names)."""
    dev = {jtypes.Device.CPU: ptypes.Device.CPU, jtypes.Device.TPU: ptypes.Device.CUDA}
    be = {jtypes.Backend.MC: ptypes.Backend.MC, jtypes.Backend.TPU: ptypes.Backend.GPU}
    assert set(dev.values()) == set(ptypes.Device) and set(be.values()) == set(ptypes.Backend)
    for jb, pb in be.items():
        assert ptypes.default_device(pb) is dev[jtypes.default_device(jb)]
    for jd, pd in dev.items():
        assert ptypes.default_backend(pd) is be[jtypes.default_backend(jd)]
    assert [str(d) for d in ptypes.Device] == ["cpu", "cuda"]
    assert [str(b) for b in ptypes.Backend] == ["mc", "gpu"]
    assert str(ptypes.Device.CPU) == str(jtypes.Device.CPU)
    assert str(ptypes.Backend.MC) == str(jtypes.Backend.MC)
    assert ptypes.SizeType is jtypes.SizeType is int


_ASSERT_ENV = ("DLAF_ASSERT_ENABLE", "DLAF_ASSERT_MODERATE_ENABLE", "DLAF_ASSERT_HEAVY_ENABLE")


@pytest.mark.parametrize("env,fires", [
    ({}, (True, True, False)),
    ({"DLAF_ASSERT_MODERATE_ENABLE": "0"}, (True, False, False)),
    ({"DLAF_ASSERT_HEAVY_ENABLE": "1"}, (True, True, True)),
    ({"DLAF_ASSERT_ENABLE": "off", "DLAF_ASSERT_MODERATE_ENABLE": "no",
      "DLAF_ASSERT_HEAVY_ENABLE": "yes"}, (False, False, True))],
    ids=["defaults", "moderate-off", "heavy-on", "mixed"])
def test_assert_tiers_match_reference(env, fires, monkeypatch):
    """Each tier's default and switch, read at import, and its message:
    both modules reloaded under ``env``, then put back as they were (the
    suite runs with the heavy tier on, and other modules hold the
    original error class)."""
    mods = (importlib.import_module("dlaf_tpu.common.asserts"),
            importlib.import_module("dlaf_tpu_torch.common.asserts"))
    saved = [(m, dict(vars(m))) for m in mods]
    for k in _ASSERT_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        for m in mods:
            importlib.reload(m)
            got = []
            for level, fn in (("DLAF_ASSERT", m.dlaf_assert),
                              ("DLAF_ASSERT_MODERATE", m.dlaf_assert_moderate),
                              ("DLAF_ASSERT_HEAVY", m.dlaf_assert_heavy)):
                fn(True, "never")
                try:
                    fn(False, "boom", 7, "x")
                except m.DlafAssertError as e:
                    msg = str(e)
                    assert msg.startswith(f"[{level}] boom\n  at "), msg
                    assert "test_torch_tile_ops.py" in msg and msg.endswith("\n  7\n  x"), msg
                    got.append(True)
                else:
                    got.append(False)
            assert tuple(got) == fires, m.__name__
    finally:
        for m, d in saved:
            vars(m).update(d)


def test_gemv_batched():
    rng = np.random.default_rng(16)
    a, x = rng.standard_normal((3, 4, 5)), rng.standard_normal((3, 5))
    np.testing.assert_allclose(tb.gemv(torch.as_tensor(a), torch.as_tensor(x)).numpy(),
                               np.einsum("bij,bj->bi", a, x), rtol=1e-14)


def test_index2d_ordering_matches_reference():
    assert [o.value for o in pix.Ordering] == [o.value for o in jix.Ordering]
    for P, Q in ((3, 4), (1, 5), (4, 1)):
        dims, jdims = pix.GlobalTileSize(P, Q), jix.GlobalTileSize(P, Q)
        seen = {o: set() for o in pix.Ordering}
        for r in range(P):
            for c in range(Q):
                for o, jo in zip(pix.Ordering, jix.Ordering):
                    lin = pix.compute_linear_index(o, pix.GlobalTileIndex(r, c), dims)
                    assert lin == jix.compute_linear_index(jo, jix.GlobalTileIndex(r, c), jdims)
                    back = pix.compute_coords(o, lin, dims, pix.GlobalTileIndex)
                    assert back == pix.GlobalTileIndex(r, c)
                    seen[o].add(lin)
        assert all(s == set(range(P * Q)) for s in seen.values())


def test_index2d_bounds_and_range_match_reference():
    from dlaf_tpu_torch.common.asserts import DlafAssertError

    with pytest.raises(DlafAssertError):
        pix.compute_linear_index(pix.Ordering.RowMajor, pix.GlobalTileIndex(3, 0),
                                 pix.GlobalTileSize(3, 4))
    for args in ((pix.LocalTileSize(2, 3),), (pix.LocalTileIndex(1, 1), pix.LocalTileIndex(3, 2)),
                 (pix.LocalTileSize(0, 3),)):
        jargs = [getattr(jix, type(a).__name__)(a.row, a.col) for a in args]
        got = [tuple(i) for i in pix.iterate_range2d(*args)]
        assert got == [tuple(i) for i in jix.iterate_range2d(*jargs)]
    assert list(pix.iterate_range2d((1, 2), cls=pix.GlobalTileIndex)) == [
        pix.GlobalTileIndex(0, 0), pix.GlobalTileIndex(0, 1)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_types_match_reference(dtype):
    assert ptypes.ops_weights(dtype) == jtypes.ops_weights(dtype)
    assert ptypes.base_float(dtype) is jtypes.base_float(dtype)
    assert ptypes.complex_of(dtype) is jtypes.complex_of(dtype)
    td = ptypes.torch_dtype(dtype)
    assert ptypes.base_float(td) == ptypes.torch_dtype(jtypes.base_float(dtype))
    assert ptypes.complex_of(td) == ptypes.torch_dtype(jtypes.complex_of(dtype))
    assert ptypes.total_ops(dtype, 3.0, 5.0) == jtypes.total_ops(dtype, 3.0, 5.0)


@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
@pytest.mark.parametrize("boost", [None, 4.0])
def test_random_hermitian_matches_reference(dtype, boost):
    got = pgen.random_hermitian(9, dtype, seed=3, diag_boost=boost)
    np.testing.assert_array_equal(got, jgen.random_hermitian(9, dtype, seed=3, diag_boost=boost))
    np.testing.assert_array_equal(got, got.conj().T)


@pytest.mark.parametrize("kernel", ["laset", "lacpy", "gemm", "trsm", "potrf"])
def test_miniapp_kernel_cpu(kernel):
    from dlaf_tpu_torch.miniapp import miniapp_kernel

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = miniapp_kernel.run(["--kernel", kernel, "-m", "16", "--batch", "3", "--backend",
                                  "cpu", "--type", "d", "--nruns", "2"])
    assert [r["run"] for r in res] == [0, 1]
    assert buf.getvalue().count(f"{kernel} d (16, 16) x3") == 2
