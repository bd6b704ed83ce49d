"""Local blocked Cholesky of the PyTorch port against the JAX reference.

One HPD matrix (numpy, seeded, float32) of n=72 with nb=16 — a ragged
last tile — goes through the reference's blocked factorization
``dlaf_tpu.algorithms.cholesky._cholesky_local`` (Pallas kernels in
interpret mode) and through the port's on CPU tensors, on the
three routes: composed ("xla"), ``panel_fused`` and ``step_fused``.

Tolerance: float32, relative to the largest factor entry, ``8 * n * eps``
(the reference's fused-vs-composed parity bound): the two packages sum the
same products in different orders. Within the port the knob contracts the
reference pins are bitwise: lookahead on/off and with_info on/off.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlaf_tpu.algorithms.cholesky import _cholesky_local as jax_cholesky_local
from dlaf_tpu.algorithms.cholesky import cholesky as jax_cholesky
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu_torch import config
from dlaf_tpu_torch.algorithms.cholesky import _cholesky_local, cholesky
from dlaf_tpu_torch.common.index2d import GlobalElementSize, TileElementSize
from dlaf_tpu_torch.matrix.convert import from_jax_storage, to_jax_storage
from dlaf_tpu_torch.matrix.distribution import Distribution
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.miniapp import miniapp_cholesky

N, NB = 72, 16
EPS32 = float(np.finfo(np.float32).eps)
TOL = 8 * N * EPS32
ROUTES = {"xla": (False, False), "panel": (True, False), "step": (False, True)}


def hpd(n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    return (x @ x.T + n * np.eye(n)).astype(np.float32)


def indefinite(col):
    a = hpd(N, seed=4)
    a[col, col] = -1000.0
    return a


@pytest.fixture(autouse=True)
def _fresh_config():
    config.initialize()
    yield
    config.initialize()


@pytest.fixture(scope="module")
def jax_factor():
    """Reference results, cached per (matrix, uplo, route, trailing)."""
    cache = {}

    def get(key, a, uplo, route, trailing="loop"):
        k = (key, uplo, route, trailing)
        if k not in cache:
            pf, sf = ROUTES[route]
            out, info = jax_cholesky_local(
                jnp.asarray(a), uplo=uplo, nb=NB, trailing=trailing, with_info=True,
                panel_fused=pf, step_fused=sf, panel_interpret=True)
            cache[k] = (np.asarray(out), int(info))
        return cache[k]

    return get


def port(a, uplo, route, **kw):
    pf, sf = ROUTES[route]
    return _cholesky_local(torch.tensor(a), uplo=uplo, nb=NB, panel_fused=pf, step_fused=sf,
                           **kw)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_local_slice_matches_reference(uplo, route, jax_factor):
    a = hpd(N)
    ref, ref_info = jax_factor("hpd", a, uplo, route)
    got, info = port(a, uplo, route, with_info=True)
    assert int(info) == ref_info == 0
    got = got.numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() <= TOL
    # the opposite triangle passes through untouched
    other = (np.triu if uplo == "L" else np.tril)(a, 1 if uplo == "L" else -1)
    np.testing.assert_array_equal((np.triu if uplo == "L" else np.tril)(
        got, 1 if uplo == "L" else -1), other)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_biggemm_trailing_matches_reference(uplo, route, jax_factor):
    a = hpd(N)
    ref, _ = jax_factor("hpd", a, uplo, route, trailing="biggemm")
    got = port(a, uplo, route, trailing="biggemm").numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() <= TOL


@pytest.mark.parametrize("route,col", [("xla", 32), ("panel", 37), ("step", 37)])
def test_info_matches_reference(route, col, jax_factor):
    """First failing column. The composed route's potrf fails a whole tile
    on the reference's CPU backend, so there the failing column is a tile's
    first; the fused routes locate it inside the tile."""
    a = indefinite(col)
    _, ref_info = jax_factor(f"indef{col}", a, "L", route)
    _, info = port(a, "L", route, with_info=True)
    assert int(info) == ref_info == col + 1


@pytest.mark.parametrize("trailing", ["loop", "biggemm"])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_lookahead_and_info_bitwise_within_port(uplo, route, trailing):
    a = hpd(N, seed=8)
    r0 = port(a, uplo, route, trailing=trailing, lookahead=False)
    r1, info = port(a, uplo, route, trailing=trailing, lookahead=True, with_info=True)
    assert torch.equal(r0, r1)
    assert int(info) == 0


def test_public_cholesky_matches_reference_storage():
    """Storage to storage: the reference's tile storage goes into the port,
    both factor it (CPU auto routes: loop trailing, composed panel)."""
    a = hpd(N, seed=2)
    jm = JMatrix.from_global(a, JTileElementSize(NB, NB))
    ref = np.asarray(jax_cholesky("L", jm).storage)
    dist = Distribution(GlobalElementSize(N, N), TileElementSize(NB, NB))
    pm = from_jax_storage(np.asarray(jm.storage), dist, device="cpu")
    got = to_jax_storage(cholesky("L", pm))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() / np.abs(ref).max() <= TOL


def test_donate_consumes_storage():
    a = hpd(N, seed=2)
    keep = cholesky("L", Matrix.from_global(a, TileElementSize(NB, NB), device="cpu"))
    mat = Matrix.from_global(a, TileElementSize(NB, NB), device="cpu")
    out = cholesky("L", mat, donate=True)
    assert mat.storage is None
    assert torch.equal(out.storage, keep.storage)


def test_miniapp_lines_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = miniapp_cholesky.run(["-m", "72", "-b", "16", "--type", "s", "--backend", "cpu",
                                    "--nruns", "2", "--check-result", "last",
                                    "--dlaf:step-impl=fused"])
    lines = buf.getvalue().splitlines()
    assert len(res) == 2
    assert lines[0].startswith("[0] ")
    assert lines[0].endswith(f" sL (72, 72) (16, 16) (1, 1) {os.cpu_count()} cpu")
    assert lines[-1].startswith("check: PASSED residual=")

