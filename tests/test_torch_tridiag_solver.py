"""The divide-and-conquer tridiagonal solver of the PyTorch port against the
JAX reference (``dlaf_tpu/eigensolver/tridiag_solver.py``).

The same numpy-seeded (d, e) go through the reference's numpy twin
(``use_device=False``) and the port's device path on CPU tensors, on the
reference tests' cases: random, zero coupling at a split, constant
diagonal (heavy deflation), clustered, Wilkinson; n in {1, 2, 64, 200,
513}, leaves nb in {16, 32}. Eigenvalues within ``5e-13 scale n`` of
scipy's (the reference's ``check``), eigenvectors against the reference's
up to sign at 1e-10, residual and orthogonality. The native secular solver
and deflation scan (the port's own build) against the port's numpy twins
and the reference's bindings: bitwise for the scan, ``1e-11 scale`` for
the roots. The port's Gu-Eisenstat refinement sums its logs paired by
root (the reference's two separate sums cancel at large k): its
coefficients against the reference's, and their orthogonality. The
device secular solve against the reference's (one lane, unpadded). Within
the port: the device secular route against the host route,
``use_device=False`` against ``True``, the Givens kernel's plain version
against the numpy loop.
"""

import importlib

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from dlaf_tpu.native import bindings as jbind
from dlaf_tpu_torch import config
from dlaf_tpu_torch.native import bindings as pbind
from dlaf_tpu_torch.tile_ops import givens_kernels as gk

jt = importlib.import_module("dlaf_tpu.eigensolver.tridiag_solver")
pt = importlib.import_module("dlaf_tpu_torch.eigensolver.tridiag_solver")

KNOBS = ("SECULAR_DEVICE_MIN_K",)


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    yield
    config.initialize()


def knobs(**kw):
    config.initialize(argv=[f"--dlaf:{k.replace('_', '-')}={v}" for k, v in kw.items()])


def case(kind, n, seed=0):
    rng = np.random.default_rng(seed + n)
    if kind == "random":
        return rng.standard_normal(n), rng.standard_normal(max(n - 1, 0))
    if kind == "zero_coupling":
        d, e = rng.standard_normal(n), rng.standard_normal(max(n - 1, 0))
        e[n // 2 - 1::max(n // 4, 1)] = 0.0
        return d, e
    if kind == "constant":
        return np.full(n, 2.0), np.full(max(n - 1, 0), 1.0)
    if kind == "clustered":
        return (np.ones(n) + 1e-14 * rng.standard_normal(n),
                1e-13 * np.abs(rng.standard_normal(max(n - 1, 0))))
    if kind == "wilkinson":
        m = n // 2
        d = np.abs(np.arange(-m, n - m)).astype(np.float64)
        return d, np.ones(max(n - 1, 0))
    raise ValueError(kind)


def check(d, e, lam, q, tol=5e-13):
    """The reference test's check: eigenvalues against scipy, residual and
    orthogonality."""
    n = d.shape[0]
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    scale = max(np.abs(d).max(initial=1.0), np.abs(e).max(initial=1.0), 1.0)
    w = sla.eigvalsh_tridiagonal(d, e) if n > 1 else d
    np.testing.assert_allclose(lam, w, atol=tol * scale * n, rtol=1e-12)
    assert np.linalg.norm(t @ q - q * lam[None, :]) < tol * scale * n * 10
    assert np.linalg.norm(q.T @ q - np.eye(n)) < tol * n * 10


def same_up_to_sign(q, qref, atol=1e-10):
    """Columns equal up to a sign fitted from each column's largest entry
    (eigenvectors of distinct eigenvalues are unique up to sign)."""
    piv = np.abs(qref).argmax(axis=0)
    sign = np.sign(qref[piv, np.arange(q.shape[1])] * q[piv, np.arange(q.shape[1])])
    np.testing.assert_allclose(q * sign[None, :], qref, atol=atol)


KINDS = ["random", "zero_coupling", "constant", "clustered", "wilkinson"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,nb", [(1, 16), (2, 16), (64, 16), (200, 32), (513, 32),
                                  (200, 16)])
def test_matches_reference(kind, n, nb):
    d, e = case(kind, n)
    lam, q = pt.tridiag_solver(d, e, nb, device="cpu")
    assert isinstance(q, torch.Tensor) and q.dtype == torch.float64
    q = q.numpy()
    check(d, e, lam, q)
    jlam, jq = jt.tridiag_solver(d, e, nb, use_device=False)
    np.testing.assert_allclose(lam, jlam, rtol=0, atol=1e-13 * max(np.abs(jlam).max(), 1.0))
    # the numpy twin: the reference's arithmetic but its Gu-Eisenstat sums
    # (a merge's roots read the children's eigenvectors)
    tlam, tq = pt.tridiag_solver(d, e, nb, use_device=False)
    check(d, e, tlam, tq)
    np.testing.assert_allclose(tlam, jlam, rtol=0, atol=1e-13 * max(np.abs(jlam).max(), 1.0))
    np.testing.assert_allclose(np.abs(q), np.abs(tq), atol=1e-10)
    # eigenvectors are compared where the eigenvalues are well apart
    gaps = np.diff(jlam)
    if n < 2 or gaps.min() > 1e-6 * max(np.abs(jlam).max(), 1.0):
        same_up_to_sign(q, jq)
        same_up_to_sign(tq, jq)


@pytest.mark.parametrize("n1", [256, 1024])
def test_gu_eisenstat_sums_paired_by_root(n1):
    """The repair against the reference: one merge of 2 n1 poles, its
    roots bit for bit the reference's, its coefficients orthogonal to
    ``20 k eps`` where the reference's two separate log sums lose
    accuracy as k grows (4.5e-12 at k=512, 7.8e-11 at k=2048)."""
    rng = np.random.default_rng(12)
    lam1, lam2 = np.sort(rng.standard_normal(n1)) * 30, np.sort(rng.standard_normal(n1)) * 30
    z = rng.standard_normal(2 * n1) / np.sqrt(n1)
    port_ctl = pt._merge_ctl_pre(lam1, lam2, z, 0.7, False, 1 << 62)
    ref_ctl = jt._merge_ctl_pre(lam1, lam2, z, 0.7, False, 1 << 62)
    np.testing.assert_array_equal(port_ctl.lam_live, ref_ctl.lam_live)
    k = port_ctl.k
    eps = np.finfo(np.float64).eps

    def orth(v):
        return np.linalg.norm(v @ v.T - np.eye(v.shape[0]))

    assert orth(port_ctl.vcols) < 20 * k * eps
    assert orth(ref_ctl.vcols) > orth(port_ctl.vcols)
    np.testing.assert_allclose(port_ctl.vcols, ref_ctl.vcols, rtol=0, atol=1e-9)


def test_constant_diagonal_known_eigenvalues():
    n = 48
    d, e = np.full(n, 2.0), np.full(n - 1, 1.0)
    stats = []
    lam, q = pt.tridiag_solver(d, e, 8, device="cpu", stats=stats)
    expect = np.sort(2.0 + 2.0 * np.cos(np.pi * np.arange(n, 0, -1) / (n + 1)))
    np.testing.assert_allclose(lam, expect, atol=1e-12)
    check(d, e, lam, q.numpy())
    assert sum(s.rotations for s in stats) > 0, "no Givens rotation on a Toeplitz T"
    assert {s.level for s in stats} == {1, 2, 3} and all(s.route == "host" for s in stats)


@pytest.mark.parametrize("kind", ["random", "constant", "clustered"])
def test_device_secular_route_matches_host(kind):
    """The device secular solve (forced from k = 2) against the host's
    native solver."""
    d, e = case(kind, 200, 4)
    knobs(secular_device_min_k=1 << 40)
    lam_h, q_h = pt.tridiag_solver(d, e, 16, device="cpu")
    stats = []
    knobs(secular_device_min_k=2)
    lam, q = pt.tridiag_solver(d, e, 16, device="cpu", stats=stats)
    assert any(s.route == "device" for s in stats)
    np.testing.assert_allclose(lam, lam_h, rtol=0, atol=5e-13 * 200 * 3)
    check(d, e, lam, q.numpy())
    np.testing.assert_allclose(np.abs(q.numpy()), np.abs(q_h.numpy()), atol=1e-9)


@pytest.mark.parametrize("k", [1, 2, 7, 129, 500])
def test_device_secular_matches_reference(k):
    """The port's device secular solve against the reference's on one
    unpadded lane: roots at the reference's ``1e-11 scale``, coefficients
    at 1e-9 (the port sums its Gu-Eisenstat logs paired by root)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(20 + k)
    ds = np.sort(rng.standard_normal(k)) * 3 + np.arange(k) * 1e-6
    zs = rng.standard_normal(k)
    zs[np.abs(zs) < 0.05] = 0.05
    zs /= np.linalg.norm(zs)
    rho = abs(rng.standard_normal()) + 0.5
    lam, vcols = pt._secular_vcols_device(torch.as_tensor(ds), torch.as_tensor(zs), rho)
    jlam, jvcols = jt._secular_vcols_device(jnp.asarray(ds), jnp.asarray(zs), rho,
                                            jnp.ones(k, dtype=bool))
    scale = np.abs(ds).max() + rho
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=0, atol=1e-11 * scale)
    np.testing.assert_allclose(vcols.numpy(), np.asarray(jvcols), rtol=0, atol=1e-9)
    np.testing.assert_allclose(vcols.numpy() @ vcols.numpy().T, np.eye(k), atol=20 * k * 2e-16)


def test_use_device_false_matches_true_and_empty():
    d, e = case("random", 150, 3)
    lam0, q0 = pt.tridiag_solver(d, e, 32, use_device=False)
    lam1, q1 = pt.tridiag_solver(d, e, 32, device="cpu")
    assert isinstance(q0, np.ndarray)
    np.testing.assert_allclose(lam0, lam1, rtol=0, atol=1e-13 * np.abs(lam0).max())
    np.testing.assert_allclose(np.abs(q0), np.abs(q1.numpy()), atol=1e-10)
    lam, q = pt.tridiag_solver(np.zeros(0), np.zeros(0), 8, device="cpu")
    assert lam.shape == (0,) and tuple(q.shape) == (0, 0)


def test_native_secular_matches_numpy_and_reference():
    """The port's native secular solver against its numpy bisection twin
    (1e-11 scale) and bit for bit against the reference's build of the same
    source; threads give bitwise the same roots."""
    rng = np.random.default_rng(4)
    for k in (1, 2, 7, 129, 500):
        ds = np.sort(rng.standard_normal(k)) * 3 + np.arange(k) * 1e-6
        zs = rng.standard_normal(k)
        zs[np.abs(zs) < 0.05] = 0.05
        zs /= np.linalg.norm(zs)
        rho = abs(rng.standard_normal()) + 0.5
        a_np, mu_np = pt._secular_roots(ds, zs, rho)
        a_nat, mu_nat = pbind.secular_roots(ds, zs, rho)
        scale = np.abs(ds).max() + rho
        np.testing.assert_allclose(ds[a_nat] + mu_nat, ds[a_np] + mu_np, atol=1e-11 * scale)
        a_ref, mu_ref = jbind.secular_roots(ds, zs, rho)
        np.testing.assert_array_equal(a_nat, a_ref)
        np.testing.assert_array_equal(mu_nat, mu_ref)
        a4, mu4 = pbind.secular_roots(ds, zs, rho, nthreads=4)
        assert mu4.tobytes() == mu_nat.tobytes() and np.array_equal(a4, a_nat)


def test_native_deflate_scan_matches_plain_and_reference():
    rng = np.random.default_rng(5)
    for _ in range(6):
        n = 257
        ds = np.sort(np.round(rng.standard_normal(n), 1))
        zs = rng.standard_normal(n) / np.sqrt(n)
        live = np.abs(zs) > rng.uniform(0.01, 0.06)
        tol = 10.0 ** rng.integers(-12, -1)
        runs = []
        for fn in (pbind.deflate_scan, pt._deflation_scan_plain, jbind.deflate_scan):
            z, lv = zs.copy(), live.copy()
            runs.append((fn(ds, z, lv, tol), z, lv))
        for out, z, lv in runs[1:]:
            for x, y in zip(out, runs[0][0]):
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(z, runs[0][1])
            np.testing.assert_array_equal(lv, runs[0][2])
        assert len(runs[0][0][0]) > 0


def test_native_dc_library_builds_into_the_port(tmp_path, monkeypatch):
    """The D&C library is built from the port's sources into the port's
    build directory; a failed build raises (no fallback), once."""
    import os

    lib = pbind.NativeLibrary(pbind.DC_LIBRARY.srcs, build_dir=str(tmp_path), name="dc",
                              bind=pbind._bind_dc)
    assert os.path.dirname(lib.build()) == str(tmp_path)
    assert all(os.path.join("dlaf_tpu_torch", "native") in s for s in lib.srcs)
    broken = pbind.NativeLibrary(pbind.DC_LIBRARY.srcs, build_dir=str(tmp_path / "b"),
                                 cxx="false", name="dc", bind=pbind._bind_dc)
    monkeypatch.setattr(pbind, "DC_LIBRARY", broken)
    d, e = case("random", 40)
    with pytest.raises(RuntimeError, match="build or load failed"):
        pt.tridiag_solver(d, e, 8, device="cpu")
    monkeypatch.setattr(broken, "build", lambda: pytest.fail("compiler respawned"))
    with pytest.raises(RuntimeError, match="build or load failed"):
        pbind.secular_roots(np.arange(3.0), np.ones(3) / 3 ** 0.5, 1.0)


def test_givens_plain_matches_numpy_loop():
    """The Givens kernel's plain version (what a CPU tensor takes) is the
    numpy loop of the reference's host assembly, bit for bit, on chained
    rotations through one anchor row."""
    rng = np.random.default_rng(6)
    u = rng.standard_normal((12, 9))
    giv = np.array([[2, 5, 0.6, 0.8], [2, 7, np.cos(0.3), np.sin(0.3)], [4, 1, 0.0, 1.0],
                    [2, 11, 1.0, 0.0], [9, 4, -0.28, 0.96]])
    want = u.copy()
    for i, j, c, s in giv:
        i, j = int(i), int(j)
        ri, rj = want[i].copy(), want[j].copy()
        want[i] = c * ri - s * rj
        want[j] = s * ri + c * rj
    got = gk.givens_undo(torch.as_tensor(u.copy()), giv)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        gk.givens_undo(torch.zeros(3, 2, device="meta", dtype=torch.float64), giv)


def test_merge_stats_count_deflation():
    d, e = case("random", 256, 7)
    stats = []
    pt.tridiag_solver(d, e, 32, device="cpu", stats=stats)
    assert len(stats) == 7 and [s.level for s in stats].count(1) == 4
    assert all(0 <= s.k <= s.n for s in stats)
    assert max(s.level for s in stats) == 3
