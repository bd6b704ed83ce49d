"""The standard and generalized eigensolvers of the PyTorch port against the
JAX reference (``dlaf_tpu/eigensolver/eigensolver.py``), and the pieces
around them.

A numpy-seeded Hermitian A (and, generalized, an HPD B) goes through the
reference's local driver (XLA:CPU, computed once per type) and the port's
drivers on one rank and on a 2x2 grid, both uplo, float64 and
complex128, n=128, nb=32, band 16: eigenvalues against the reference's at
``1e-12 scale``, the eigenpair residual ``|A Z - [B] Z diag(lambda)|_F /
|A|_F`` and the orthogonality ``|Z^H [B] Z - I|_F`` below ``200 n eps``
(the reference's budgets). Also: ``donate=False`` leaves the inputs'
storage bitwise unchanged, ``resume=True`` without a resume dir raises,
the stage walls and
``keep``, ``permute_array`` against the reference's, the launch formulas
``chip_smoke.py`` asserts (evp-mxu's #6, gen-evp-s's kernels) held by the
calls of the plain versions, and the two miniapps at a tiny size on the
CPU.
"""

import contextlib
import importlib
import io

import numpy as np
import pytest
import torch

from dlaf_tpu import config as jcfg
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu_torch import config
from dlaf_tpu_torch.algorithms.permutations import permute_array
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.asserts import DlafAssertError
from dlaf_tpu_torch.common.index2d import TileElementSize
from dlaf_tpu_torch.common.timer import PhaseTimer, Timer
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.miniapp.miniapp_eigensolver import eigen_residuals

je = importlib.import_module("dlaf_tpu.eigensolver.eigensolver")
jperm = importlib.import_module("dlaf_tpu.algorithms.permutations")
pe = importlib.import_module("dlaf_tpu_torch.eigensolver.eigensolver")

KNOBS = ("F64_GEMM", "F64_GEMM_MIN_DIM", "OZAKI_IMPL", "DIST_STEP_MODE", "BT_LOOKAHEAD",
         "DC_LEVEL_BATCH", "SECULAR_DEVICE_MIN_K", "FORCE_PALLAS_UPDATE")
N, NB, BAND = 128, 32, 16
_REF: dict = {}


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    jcfg.initialize()
    yield
    config.initialize()
    jcfg.initialize()


def herm(n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((n, n))
    return ((x + x.conj().T) / 2).astype(dtype)


def hpd(n, dtype, seed):
    x = herm(n, dtype, seed)
    return (x @ x.conj().T / n + np.eye(n)).astype(dtype)


def port(a, nb, grid):
    return Matrix.from_global(a, TileElementSize(nb, nb), shared_grid(*grid, "cpu") if grid
                              else None, device="cpu")


def reference(dtype, gen):
    """The reference's local eigenvalues of the test's A (and B), once per
    type and problem."""
    key = (np.dtype(dtype).name, gen)
    if key not in _REF:
        a = herm(N, dtype, 1)
        ja = JMatrix.from_global(a, JTileElementSize(NB, NB))
        if gen:
            jb = JMatrix.from_global(hpd(N, dtype, 2), JTileElementSize(NB, NB))
            res = je.gen_eigensolver("L", ja, jb, band_size=BAND)
        else:
            res = je.eigensolver("L", ja, band_size=BAND)
        _REF[key] = np.asarray(res.eigenvalues)
    return _REF[key]


def stored(a, uplo):
    """``a`` with garbage in the triangle ``uplo`` does not store: the
    drivers must read only the stored one."""
    junk = np.full_like(a, 7.0)
    return np.where(np.tril(np.ones(a.shape, bool)) if uplo == "L"
                    else np.triu(np.ones(a.shape, bool)), a, junk)


def check(a, b, lam, z, ref_lam):
    n = a.shape[0]
    eps = np.finfo(np.float64).eps
    scale = np.abs(ref_lam).max()
    np.testing.assert_allclose(lam, ref_lam, rtol=0, atol=1e-12 * scale)
    vals = eigen_residuals(torch.as_tensor(a), None if b is None else torch.as_tensor(b), lam,
                           z.to_global())
    assert vals["eigen_residual"] < 200 * n * eps, vals
    assert vals["orthogonality"] < 200 * n * eps, vals


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("grid", [None, (2, 2)])
def test_eigensolver_matches_reference(grid, uplo, dtype):
    a = herm(N, dtype, 1)
    res = pe.eigensolver(uplo, port(stored(a, uplo), NB, grid), band_size=BAND)
    assert res.eigenvectors.dist.grid_size.row == (grid or (1, 1))[0]
    assert res.eigenvectors.dtype == torch.from_numpy(a).dtype
    check(a, None, res.eigenvalues, res.eigenvectors, reference(dtype, False))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("grid", [None, (2, 2)])
def test_gen_eigensolver_matches_reference(grid, uplo, dtype):
    a, b = herm(N, dtype, 1), hpd(N, dtype, 2)
    res = pe.gen_eigensolver(uplo, port(stored(a, uplo), NB, grid),
                             port(stored(b, uplo), NB, grid), band_size=BAND)
    check(a, b, res.eigenvalues, res.eigenvectors, reference(dtype, True))


@pytest.mark.parametrize("grid", [None, (2, 2)])
def test_float32_and_default_band(grid):
    """float32 with the default band (= nb): eigenvalues against float64's
    at the float32 budget."""
    a = herm(96, np.float64, 3)
    res = pe.eigensolver("L", port(a.astype(np.float32), 16, grid))
    w = np.linalg.eigvalsh(a)
    eps = np.finfo(np.float32).eps
    np.testing.assert_allclose(res.eigenvalues, w, rtol=0, atol=100 * 96 * eps * np.abs(w).max())
    vals = eigen_residuals(torch.as_tensor(a), None, res.eigenvalues,
                           res.eigenvectors.to_global())
    assert max(vals.values()) < 200 * 96 * eps


@pytest.mark.parametrize("grid", [None, (2, 2)])
def test_donate_false_leaves_the_inputs_bitwise(grid):
    a, b = herm(64, np.complex128, 4), hpd(64, np.complex128, 5)
    am, bm = port(a, 16, grid), port(b, 16, grid)
    keep_a, keep_b = [s.clone() for s in am.shards()], [s.clone() for s in bm.shards()]
    pe.eigensolver("L", am, band_size=8)
    pe.gen_eigensolver("U", am, bm, band_size=8)
    assert all(torch.equal(x, y) for x, y in zip(am.shards(), keep_a))
    assert all(torch.equal(x, y) for x, y in zip(bm.shards(), keep_b))
    res = pe.eigensolver("L", am, band_size=8, donate=True)
    assert np.isfinite(res.eigenvalues).all()


def test_resume_raises():
    """``resume=True`` without a resume dir raises rather than recompute
    silently (the stage checkpoints themselves: test_torch_resilience.py)."""
    from dlaf_tpu_torch.health.errors import ResumeError

    with pytest.raises(ResumeError, match="DLAF_RESUME_DIR"):
        pe.eigensolver("L", port(herm(16, np.float64, 1), 4, None), resume=True)


def test_phases_and_keep():
    a = herm(64, np.float64, 6)
    pt, keep = PhaseTimer(), {}
    res = pe.gen_eigensolver("L", port(a, 16, (2, 2)), port(hpd(64, np.float64, 7), 16, (2, 2)),
                             phases=pt, band_size=8, keep=keep)
    assert list(pt.report()) == ["stage.cholesky", "stage.gen_to_std",
                                 "stage.reduction_to_band", "stage.band_to_tridiag",
                                 "stage.tridiag_solver", "stage.bt_band_to_tridiag",
                                 "stage.bt_reduction_to_band", "stage.back_substitution"]
    assert all(v >= 0 for v in pt.report().values())
    assert keep["reduction"].band == 8 and keep["tridiag"].d.shape == (64,)
    assert {s.level for s in keep["dc_stats"]} == {1, 2}
    assert res.eigenvalues.shape == (64,)
    t = Timer()
    assert t.elapsed() >= 0
    with pt.phase("stage.cholesky"):
        pass
    assert pt.report()["stage.cholesky"] >= 0


def test_permute_array_matches_reference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((7, 5))
    for coord, perm in (("Row", rng.permutation(7)), ("Col", rng.permutation(5))):
        got = permute_array(coord, perm, torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jperm.permute_array(coord, perm, x)))
    with pytest.raises(DlafAssertError):
        permute_array("Diag", [0], torch.as_tensor(x))


def set_knobs(monkeypatch, **knobs):
    for k, v in knobs.items():
        monkeypatch.setenv("DLAF_" + k.upper(), str(v))
    config.initialize()


@pytest.mark.parametrize("shape", [(2, 2, 64, 16, 4, 32), (2, 2, 72, 16, 8, 40),
                                   (2, 3, 80, 16, 8, 48), (4, 2, 61, 8, 4, 16)])
def test_chip_smoke_evp_mxu_launch_formula(shape, monkeypatch):
    """``chip_smoke.evp_mxu_launches`` (evp-mxu's exact count of #6, the
    reduction, the D&C merges and both back-transforms) against the calls
    of the Ozaki product's plain version under ``f64_gemm=mxu``,
    ``ozaki_impl=pallas``, with ``K_MAX`` lowered so that the composed
    route of deeper contractions is taken too (bands below 64: the CPU's
    group is the band, as cuda's)."""
    import chip_smoke as cs
    from dlaf_tpu_torch.tile_ops import ozaki_kernels as ok

    P, Q, n, nb, b, k_max = shape
    calls = []
    real = ok.ozaki_product_plain
    monkeypatch.setattr(ok, "ozaki_product_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(ok, "K_MAX", k_max)
    set_knobs(monkeypatch, f64_gemm="mxu", f64_gemm_min_dim=4, ozaki_impl="pallas",
              dist_step_mode="unrolled")
    a = herm(n, np.float64, 9)
    res = pe.eigensolver("L", port(a, nb, (P, Q)), band_size=b)
    assert len(calls) == cs.evp_mxu_launches(P, Q, n, nb, b, k_max=k_max, min_dim=4)
    vals = eigen_residuals(torch.as_tensor(a), None, res.eigenvalues,
                           res.eigenvectors.to_global())
    assert max(vals.values()) < 200 * n * np.finfo(np.float64).eps


def test_chip_smoke_gen_evp_f32_launch_formula(monkeypatch):
    """gen-evp-s's kernel counts (``chip_smoke.GEN_EVP_F32_GRID``: the
    Cholesky of B, twosolve's two solves, the back-substitution) against
    the calls of the kernels' plain versions on the cuda defaults (a
    left-side solve and an upper factor+solve run as their mirror: counted
    once)."""
    import chip_smoke as cs
    from dlaf_tpu_torch.tile_ops import ozaki_kernels as ok
    from dlaf_tpu_torch.tile_ops import panel_kernels as pk
    from dlaf_tpu_torch.tile_ops import update_kernels as uk

    monkeypatch.setenv("DLAF_FORCE_PALLAS_UPDATE", "1")
    calls = {}
    for mod, name, key, skip in (
            (pk, "panel_solve_plain", "solve", "L"), (pk, "potrf_plain", "potrf", None),
            (pk, "factor_solve_plain", "factor_solve", "U"), (pk, "step_plain", "step", None),
            (ok, "ozaki_product_plain", "ozaki_product", None),
            (uk, "masked_trailing_update_plain", "masked_trailing_update", None)):
        def wrapper(*args, _fn=getattr(mod, name), _key=key, _skip=skip, **kw):
            calls[_key] = calls.get(_key, 0) + (args[0] != _skip)
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, wrapper)
    config.initialize(argv=["--dlaf:cholesky-trailing=biggemm", "--dlaf:cholesky-lookahead=1",
                            "--dlaf:comm-lookahead=1", "--dlaf:panel-impl=fused",
                            "--dlaf:step-impl=fused", "--dlaf:hegst-impl=twosolve"])
    n, nb = 48, 8
    a, b = herm(n, np.float64, 10), hpd(n, np.float64, 11)
    res = pe.gen_eigensolver("L", port(a.astype(np.float32), nb, (2, 2)),
                             port(b.astype(np.float32), nb, (2, 2)))
    nt = n // nb
    assert {k: v for k, v in calls.items() if v} == {k: f(2, 2, nt) for k, f in
                                                     cs.GEN_EVP_F32_GRID.items()}
    vals = eigen_residuals(torch.as_tensor(a), torch.as_tensor(b), res.eigenvalues,
                           res.eigenvectors.to_global())
    assert max(vals.values()) < 200 * n * np.finfo(np.float32).eps


@pytest.mark.parametrize("argv", [
    ["-m", "48", "-b", "8", "--band-size", "4", "--type", "d"],
    ["-m", "40", "-b", "8", "--type", "z", "--uplo", "U", "--generalized", "--grid-rows", "2",
     "--grid-cols", "2", "--share-device"],
    ["-m", "40", "-b", "8", "--type", "s", "--generalized"]])
def test_miniapp_eigensolver_cpu(argv):
    from dlaf_tpu_torch.miniapp import miniapp_eigensolver as mes

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = mes.run([*argv, "--backend", "cpu", "--nruns", "2", "--check-result", "last"])
    out = buf.getvalue()
    assert len(res) == 2 and out.count("check: PASSED") == 1, out
    assert ("gen_evp" if "--generalized" in argv else " evp ") in out


@pytest.mark.parametrize("argv", [["-m", "50", "-b", "6", "--type", "d"],
                                  ["-m", "40", "-n", "24", "-b", "4", "--type", "z",
                                   "--grid-rows", "2", "--grid-cols", "2", "--share-device"]])
def test_miniapp_bt_band_to_tridiag_cpu(argv):
    from dlaf_tpu_torch.miniapp import miniapp_bt_band_to_tridiag as mbt

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = mbt.run([*argv, "--backend", "cpu", "--check-result", "last"])
    assert len(res) == 1 and "check: PASSED" in buf.getvalue(), buf.getvalue()
