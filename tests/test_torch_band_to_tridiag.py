"""The band-to-tridiagonal chase of the PyTorch port against the JAX
reference's numpy and native chases (``dlaf_tpu/eigensolver/
band_to_tridiag.py``, ``dlaf_tpu/native/bindings.py``).

The port's chase is the native one, built from its own copy of
``band_to_tridiag.cpp`` with the reference's flags (``-O3 -march=native``,
the same compiler on the same host) into ``dlaf_tpu_torch/_build/``:
bitwise against the reference's library, and across thread counts; against
the reference's numpy chase (d, e, v, tau, phase) at ``1e-12``, the
reference's own tolerance between its two chases
(``tests/test_band_to_tridiag.py:81-91``), since the C++ loops round in
another order than numpy's. It raises when its library cannot be built
instead of falling back. The pipeline A -> band -> T at a tiny size holds
the tridiagonal's eigenvalues against ``eigvalsh(A)`` within ``100 n eps``.
"""

import contextlib
import importlib
import io

import numpy as np
import pytest
import scipy.linalg as sla

from dlaf_tpu.eigensolver.band_to_tridiag import band_to_tridiag_numpy as j_numpy
from dlaf_tpu.native import bindings as jb
from dlaf_tpu_torch import config
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import TileElementSize
from dlaf_tpu_torch.eigensolver.band_to_tridiag import band_to_tridiag
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.miniapp import miniapp_band_to_tridiag, miniapp_reduction_to_band
from dlaf_tpu_torch.native import bindings as pb

pr = importlib.import_module("dlaf_tpu_torch.eigensolver.reduction_to_band")
FIELDS = ("d", "e", "v", "tau", "phase")


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    knobs = ("CHASE_THREADS", "DIST_STEP_MODE")
    for knob in knobs:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    yield
    for knob in knobs:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()


def random_band(n, b, dtype, seed):
    """The reference test's band: a random Hermitian band matrix in lower
    'sb' storage."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((n, n))
    a = (x + x.conj().T) / 2
    a = np.where(np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= b, a, 0).astype(dtype)
    np.fill_diagonal(a, np.real(np.diag(a)))
    band = np.zeros((b + 1, n), dtype=dtype)
    for r in range(b + 1):
        band[r, :n - r] = np.diagonal(a, -r)
    return a, band


def assert_same(got, ref, atol=None):
    """Every field of ``got`` and ``ref`` of one dtype and shape: bitwise,
    or within ``atol``."""
    assert got.band == ref.band
    for f in FIELDS:
        g, r = getattr(got, f), getattr(ref, f)
        assert g.dtype == r.dtype and g.shape == r.shape, f
        if atol is None:
            np.testing.assert_array_equal(g, r, err_msg=f)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=f)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("n,b", [(12, 2), (16, 4), (13, 4), (17, 3), (8, 8), (5, 1), (2, 1),
                                 (1, 1)])
def test_native_matches_reference_numpy(n, b, dtype):
    _, band = random_band(n, b, dtype, n + b)
    assert_same(band_to_tridiag(band, b), j_numpy(band, b), atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("n,b", [(16, 4), (13, 3), (30, 5), (64, 8), (61, 4), (5, 1)])
def test_native_matches_reference_native_bitwise(n, b, dtype):
    """Same source, same flags, same compiler and host: the port's library
    and the reference's give the same bits, sequential and pipelined."""
    _, band = random_band(n, b, dtype, n)
    for nthreads in (1, 4):
        assert_same(pb.band_to_tridiag(band, b, nthreads=nthreads),
                    jb.band_to_tridiag(band, b, nthreads=nthreads))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("n,b", [(64, 8), (61, 4), (96, 16), (40, 8)])
def test_native_thread_counts_bitwise(n, b, dtype):
    _, band = random_band(n, b, dtype, n + 7)
    seq = pb.band_to_tridiag(band, b, nthreads=1)
    for nthreads in (2, 4):
        assert_same(pb.band_to_tridiag(band, b, nthreads=nthreads), seq)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_native_against_numpy_and_eigenvalues(dtype):
    """The native chase agrees with the reference's numpy one to rounding,
    and T's eigenvalues are the band's."""
    n, b = 30, 5
    a, band = random_band(n, b, dtype, 4)
    nat, num = band_to_tridiag(band, b), j_numpy(band, b)
    np.testing.assert_allclose(nat.d, num.d, atol=1e-12)
    np.testing.assert_allclose(nat.e, num.e, atol=1e-12)
    w = sla.eigvalsh_tridiagonal(nat.d, nat.e)
    np.testing.assert_allclose(w, np.linalg.eigvalsh(a), atol=100 * n * np.finfo(float).eps)
    np.testing.assert_allclose(np.abs(nat.phase), 1.0, atol=1e-14)


def test_native_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """A library that cannot be built raises from the native chase, and
    again from the cached error (no compiler respawn), for either type;
    under ``DLAF_STRICT`` the chase raises rather than fall back, and
    otherwise it falls back to the reference's numpy chase, bit for bit
    (the degradation counted: tests/test_torch_health_inject.py)."""
    from dlaf_tpu_torch.health import circuit
    from dlaf_tpu_torch.health.errors import DegradationError

    broken = pb.NativeLibrary(build_dir=str(tmp_path), cxx="false")
    monkeypatch.setattr(pb, "LIBRARY", broken)
    _, band = random_band(12, 3, np.float64, 1)
    with pytest.raises(RuntimeError, match="build or load failed"):
        pb.band_to_tridiag(band, 3)
    monkeypatch.setattr(broken, "build", lambda: pytest.fail("compiler respawned"))
    _, zband = random_band(12, 3, np.complex128, 1)
    for b in (band, zband):
        with pytest.raises(RuntimeError, match="build or load failed"):
            pb.band_to_tridiag(b, 3)
        got, want = band_to_tridiag(b, 3), j_numpy(b, 3)
        for f in ("d", "e", "v", "tau", "phase"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    monkeypatch.setenv("DLAF_STRICT", "1")
    config.initialize()
    try:
        with pytest.raises(DegradationError, match="band_to_tridiag"):
            band_to_tridiag(band, 3)
    finally:
        monkeypatch.delenv("DLAF_STRICT")
        config.initialize()
        # the failures opened the site's breaker: close it for later tests
        circuit.reset("fallback.")


def test_library_builds_into_the_port(tmp_path):
    """The chase's library is built from the port's source into the
    port's build directory, never the reference's."""
    import os

    lib = pb.NativeLibrary(build_dir=str(tmp_path))
    path = lib.build()
    assert os.path.dirname(path) == str(tmp_path) and os.path.exists(path)
    assert lib.src.endswith(os.path.join("dlaf_tpu_torch", "native", "band_to_tridiag.cpp"))
    assert os.path.dirname(pb.LIBRARY.path()).endswith(os.path.join("dlaf_tpu_torch", "_build"))
    _, band = random_band(16, 4, np.float64, 2)
    lib.load()
    assert_same(pb.band_to_tridiag(band, 4, nthreads=1), jb.band_to_tridiag(band, 4, nthreads=1))


def test_config_knobs(monkeypatch):
    monkeypatch.setenv("DLAF_CHASE_THREADS", "3")
    config.initialize()
    assert pb.chase_threads() == 3
    monkeypatch.setenv("DLAF_CHASE_THREADS", "0")
    config.initialize()
    assert pb.chase_threads() >= 1


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("grid,mode", [(None, "unrolled"), ((2, 2), "unrolled"),
                                       ((2, 2), "scan")])
def test_pipeline_eigenvalues(grid, mode, dtype, monkeypatch):
    """A -> band (reduction_to_band, band < nb) -> T (native chase): the
    eigenvalues of (d, e) against A's within 100 n eps."""
    monkeypatch.setenv("DLAF_DIST_STEP_MODE", mode)
    config.initialize()
    n, nb, b = 37, 8, 4
    rng = np.random.default_rng(12)
    x = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((n, n))
    a = ((x + x.conj().T) / 2).astype(dtype)
    mat = Matrix.from_global(a, TileElementSize(nb, nb), shared_grid(*grid, "cpu") if grid
                             else None, device="cpu")
    res = band_to_tridiag(pr.extract_band(pr.reduction_to_band(mat, band_size=b)), b)
    w_ref = np.linalg.eigvalsh(a)
    drift = np.abs(sla.eigvalsh_tridiagonal(res.d, res.e) - w_ref).max() / np.abs(w_ref).max()
    assert drift < 100 * n * np.finfo(np.float64).eps


@pytest.mark.parametrize("app,argv", [
    (miniapp_band_to_tridiag, ["-m", "40", "-b", "6", "--type", "z"]),
    (miniapp_band_to_tridiag, ["-m", "33", "-b", "4", "--dlaf:chase-threads=2"]),
    (miniapp_reduction_to_band, ["-m", "40", "-b", "8", "--band-size", "4", "--type", "d",
                                 "--grid-rows", "2", "--grid-cols", "2", "--share-device"]),
    (miniapp_reduction_to_band, ["-m", "36", "-b", "8", "--type", "z",
                                 "--dlaf:dist-step-mode=scan"]),
    (miniapp_reduction_to_band, ["-m", "36", "-b", "8", "--band-size", "2", "--type", "s",
                                 "--grid-rows", "2", "--grid-cols", "4", "--share-device"])])
def test_miniapps(app, argv):
    """The miniapps on the CPU: per-run lines and ``check: PASSED``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = app.run([*argv, "--backend", "cpu", "--nruns", "2", "--check-result", "all"])
    out = buf.getvalue()
    assert len(res) == 2 and out.count("check: PASSED") == 2, out
    assert out.startswith("[0] ") and "GFlop/s" in out
