"""The port's fault injection and degradation registry
(``dlaf_tpu_torch/health/inject.py``, ``registry.py``) and their gated
sites, against the JAX reference's (``dlaf_tpu/health/``).

The same seeds poison the same tile element (``nan_tile``) and the same
payload position (``corrupt_collective``) in both packages; a poisoned
broadcast or all-gather surfaces (a nonzero info, NaNs in the
back-transform) and the next call is clean. Under
``force_native_failure`` the secular solver, the deflation scan and the
chase take their numpy twins, bitwise the reference's under its own drill,
and the eigensolver still meets its budgets. ``disable_pallas`` and
``disable_ozaki`` give bitwise the port's composed routes, within
``c n eps`` of the reference's drilled result, with no kernel (plain
version) called. Under ``DLAF_STRICT`` every gated site raises
``DegradationError`` (one case per site, and an audit that no site is
unlisted); a CUDA kernel whose library fails to build raises, never falls
back. ``hang`` charges a deadline on a fake clock as the reference's does.
"""

import importlib
import os
import re

import numpy as np
import pytest
import torch

from dlaf_tpu import config as jcfg
from dlaf_tpu import obs as jobs
from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu.common.index2d import RankIndex2D as JRankIndex2D
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.health import circuit as jcircuit
from dlaf_tpu.health import inject as jinject
from dlaf_tpu.health import policy as jpolicy
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu_torch import config, health, obs
from dlaf_tpu_torch.comm import collectives as cc
from dlaf_tpu_torch.comm.grid import COL_AXIS, ROW_AXIS, shared_grid
from dlaf_tpu_torch.common.index2d import RankIndex2D, TileElementSize
from dlaf_tpu_torch.health import circuit, inject, policy, registry
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.native import bindings
from dlaf_tpu_torch.tile_ops import blas as tb
from dlaf_tpu_torch.tile_ops import cuda_build as cb
from dlaf_tpu_torch.tile_ops import ozaki_kernels as ok
from dlaf_tpu_torch.tile_ops import panel_kernels as pk
from dlaf_tpu_torch.tile_ops import update_kernels as uk

jchol = importlib.import_module("dlaf_tpu.algorithms.cholesky")
jb2t = importlib.import_module("dlaf_tpu.eigensolver.band_to_tridiag")
jtds = importlib.import_module("dlaf_tpu.eigensolver.tridiag_solver")
pchol = importlib.import_module("dlaf_tpu_torch.algorithms.cholesky")
pb2t = importlib.import_module("dlaf_tpu_torch.eigensolver.band_to_tridiag")
ptds = importlib.import_module("dlaf_tpu_torch.eigensolver.tridiag_solver")
peig = importlib.import_module("dlaf_tpu_torch.eigensolver.eigensolver")
pr2b = importlib.import_module("dlaf_tpu_torch.eigensolver.reduction_to_band")
pbt = importlib.import_module("dlaf_tpu_torch.eigensolver.back_transform")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("CHOLESKY_TRAILING", "CHOLESKY_LOOKAHEAD", "PANEL_IMPL", "STEP_IMPL", "OZAKI_IMPL",
         "F64_GEMM", "F64_TRSM", "F64_GEMM_MIN_DIM", "FORCE_PALLAS_UPDATE", "STRICT",
         "METRICS_PATH", "DIST_STEP_MODE")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize(config.Configuration(log="off"))
    jcfg.initialize(jcfg.Configuration(log="off"))
    yield
    for knob in KNOBS:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    obs._reset_for_tests()
    jobs._reset_for_tests()
    circuit.reset()
    jcircuit.reset()
    config.initialize()
    jcfg.initialize()


def knobs(monkeypatch, **kv):
    """Set knobs in both packages (the environment both read)."""
    for k, v in kv.items():
        monkeypatch.setenv("DLAF_" + k.upper(), str(v))
    config.initialize()
    jcfg.initialize()


def metrics_on(tmp_path, **cfg):
    path = str(tmp_path / "art.jsonl")
    config.initialize(config.Configuration(metrics_path=path, log="off", **cfg))
    return path


def fallbacks(site, reason="native_unavailable"):
    return obs.registry().counter(health.FALLBACK_COUNTER, site=site,
                                  reason=reason).snapshot()["value"]


def hpd(n, dtype=np.float64, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, n))
    return (x @ x.T + n * np.eye(n)).astype(dtype)


def pmat(a, nb, grid=None, src=(0, 0)):
    g = shared_grid(*grid, "cpu") if grid else None
    return Matrix.from_global(a, TileElementSize(nb, nb), grid=g, source_rank=RankIndex2D(*src),
                              device="cpu")


def jmat(a, nb, devices, grid=None, src=(0, 0)):
    g = JGrid(*grid, devices=devices[:grid[0] * grid[1]]) if grid else None
    return JMatrix.from_global(a, JTileElementSize(nb, nb), grid=g,
                               source_rank=JRankIndex2D(*src))


# ---------------------------------------------------------------------------
# Data and payload corruption
# ---------------------------------------------------------------------------

NAN_CASES = [  # (n, nb, grid, source rank, seed, tile, element)
    (16, 4, None, (0, 0), 7, None, None),
    (13, 4, None, (0, 0), 3, None, None),
    (13, 4, None, (0, 0), 11, (3, 1), None),
    (16, 4, None, (0, 0), 0, (1, 0), (2, 3)),
    (22, 4, (2, 2), (1, 0), 5, None, None),
    (22, 4, (2, 3), (0, 2), 9, None, None),
    (22, 4, (2, 2), (0, 1), 2, (5, 4), None),
]


@pytest.mark.parametrize("n,nb,grid,src,seed,tile,element", NAN_CASES)
def test_nan_tile_positions_match_reference(n, nb, grid, src, seed, tile, element, devices8):
    a = hpd(n, seed=seed)
    got = inject.nan_tile(pmat(a, nb, grid, src), tile=tile, element=element, seed=seed)
    want = np.asarray(jinject.nan_tile(jmat(a, nb, devices8, grid, src), tile=tile,
                                       element=element, seed=seed).to_numpy())
    out = got.to_numpy()
    assert np.isnan(out).sum() == 1
    np.testing.assert_array_equal(np.isnan(out), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(out), np.nan_to_num(want))
    # the input is left as it was, and a poison in the stored triangle is
    # detected (the other one is never read)
    assert np.isfinite(pmat(a, nb, grid, src).to_numpy()).all()
    (i, j), = np.argwhere(np.isnan(out))
    _, info = pchol.cholesky("L", got, with_info=True)
    assert (int(info) != 0) == (i >= j)


@pytest.mark.parametrize("shape,dtype", [((5, 7), torch.float64), ((3, 4, 6), torch.float32),
                                         ((9,), torch.complex128), ((4, 4), torch.int32),
                                         ((), torch.float64)])
def test_corrupt_payload_position_matches_reference(shape, dtype):
    x = torch.arange(int(np.prod(shape)) or 1).reshape(shape).to(dtype)
    for seed in (0, 3, 17):
        got = inject._corrupt_payload(x, seed).numpy()
        want = np.asarray(jinject._corrupt_payload(jnp_array(x.numpy()), seed))
        np.testing.assert_array_equal(got, want)
    # a transposed payload keeps its layout; its row-major element is hit
    if len(shape) == 2:
        xt = x.mT
        got = inject._corrupt_payload(xt, 3)
        assert got.stride() == xt.stride()
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jinject._corrupt_payload(jnp_array(xt.numpy()), 3)))
    assert inject._corrupt_payload(torch.empty(0), 1).numel() == 0


def jnp_array(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def _verbs(kind, xs):
    return {"bcast": lambda: cc.bcast(xs, ROW_AXIS, 1),
            "bcast2d": lambda: cc.bcast2d(xs, 1, 0),
            "all_reduce": lambda: cc.all_reduce(xs, COL_AXIS),
            "all_gather": lambda: cc.all_gather(xs, ROW_AXIS),
            "all_to_all": lambda: cc.all_to_all(xs, COL_AXIS, split_axis=0,
                                                concat_axis=1)}[kind]()


@pytest.mark.parametrize("kind", ["bcast", "bcast2d", "all_reduce", "all_gather", "all_to_all"])
def test_corrupt_collective_poisons_the_nth_call_only(kind):
    xs = cc.per_rank(2, 2, lambda r, c: torch.full((4, 6), float(1 + r + 2 * c),
                                                   dtype=torch.float64))
    clean = _verbs(kind, xs)
    with inject.corrupt_collective("bcast" if kind == "bcast2d" else kind, nth=1, seed=4):
        first = _verbs(kind, xs)
        second = _verbs(kind, xs)
        third = _verbs(kind, xs)
    after = _verbs(kind, xs)
    hit = []
    for r in range(2):
        for c in range(2):
            for same in (first, third, after):
                assert torch.equal(same[r][c], clean[r][c])
            hit.append(int(torch.isnan(second[r][c]).sum()) >= 1)
    # an all-to-all delivers the poisoned chunk to one rank of each line
    assert all(hit) if kind != "all_to_all" else hit.count(True) == 2
    assert cc._INJECT_HOOK is None
    with inject.corrupt_collective("bcast"):
        with pytest.raises(RuntimeError, match="not reentrant"):
            with inject.corrupt_collective("bcast"):
                pass


def test_corrupt_collective_detected_and_contained(devices8):
    """Poisoning the first broadcast of a distributed factorization gives
    a nonzero info in both packages, the next call is clean, and the same
    (nth, seed) gives the same info again."""
    a = hpd(16)
    with inject.corrupt_collective("bcast", nth=0, seed=3):
        _, info = pchol.cholesky("L", pmat(a, 4, (2, 2)), with_info=True)
    _, clean = pchol.cholesky("L", pmat(a, 4, (2, 2)), with_info=True)
    with inject.corrupt_collective("bcast", nth=0, seed=3):
        _, info2 = pchol.cholesky("L", pmat(a, 4, (2, 2)), with_info=True)
    with jinject.corrupt_collective("bcast", nth=0, seed=3):
        _, jinfo = jchol.cholesky("L", jmat(a, 4, devices8, (2, 2)), with_info=True)
    assert int(info) != 0 and int(jinfo) != 0
    assert int(clean) == 0 and int(info2) == int(info)


def test_corrupt_all_gather_reaches_bt_chain(monkeypatch):
    """An all-gather on the reflector back-transform's chain carries the
    poison into its result; the next call is bitwise the clean one."""
    monkeypatch.setenv("DLAF_DIST_STEP_MODE", "unrolled")
    config.initialize()
    rng = np.random.default_rng(7)
    n, nb = 24, 4
    x = rng.standard_normal((n, n))
    a = x @ x.T + n * np.eye(n)
    c = rng.standard_normal((n, n))

    def run():
        red = pr2b.reduction_to_band(pmat(a, nb, (2, 2)))
        return pbt.bt_reduction_to_band(red, pmat(c, nb, (2, 2))).to_numpy()

    clean = run()
    assert np.isfinite(clean).all()
    with inject.corrupt_collective("all_gather", nth=0, seed=5):
        poisoned = run()
    assert np.isnan(poisoned).any()
    np.testing.assert_array_equal(run(), clean)


# ---------------------------------------------------------------------------
# Native library failure -> the numpy twins
# ---------------------------------------------------------------------------

def test_bindings_cached_error_reraise_and_once_log(tmp_path, monkeypatch):
    """A failed build is cached (the compiler is not respawned) and logged
    once at error level; the next load after a reset builds again."""
    path = str(tmp_path / "art.jsonl")
    config.initialize(config.Configuration(metrics_path=path, log="error"))
    calls = []

    def failing_build(self):
        calls.append(1)
        raise OSError("synthetic toolchain failure")

    monkeypatch.setattr(bindings.NativeLibrary, "build", failing_build)
    bindings._reset_for_tests()
    try:
        for _ in range(3):
            with pytest.raises(RuntimeError, match="synthetic"):
                bindings.DC_LIBRARY.load()
        assert len(calls) == 1
    finally:
        monkeypatch.undo()
        bindings._reset_for_tests()
    obs.flush()
    errors = [r for r in obs.read_records(path) if r.get("type") == "log"
              and r.get("level") == "error" and r.get("logger") == "native"]
    assert len(errors) == 1
    bindings.DC_LIBRARY.load()


def test_force_native_failure_matches_reference(tmp_path):
    """The chase, the secular solver and the deflation scan under the
    drill: the numpy twins, bitwise the reference's under its own drill,
    each counted once per call."""
    metrics_on(tmp_path)
    jcfg.initialize(jcfg.Configuration(log="off", metrics_path=str(tmp_path / "j.jsonl")))
    rng = np.random.default_rng(4)
    n, b = 40, 3
    band = np.zeros((b + 1, n))
    band[0] = rng.standard_normal(n)
    for r in range(1, b + 1):
        band[r, :-r] = rng.standard_normal(n - r)
    zband = band + 1j * np.vstack([np.zeros((1, n)), rng.standard_normal((b, n))])
    zband[1:] *= np.vstack([np.ones(n)[None] * (np.arange(n)[None] < n - r)
                            for r in range(1, b + 1)])
    d = np.sort(rng.standard_normal(12))
    d[5] = d[4] + 1e-15
    z = rng.standard_normal(12)
    with inject.force_native_failure():
        got = [pb2t.band_to_tridiag(x, b) for x in (band, zband)]
        roots = ptds._secular_roots_host(d, z, 0.7)
        zs, live = z.copy(), np.ones(12, bool)
        rot = ptds._deflation_scan(d, zs, live, 1e-12)
    with jinject.force_native_failure():
        want = [jb2t.band_to_tridiag(x, b) for x in (band, zband)]
        jroots = jtds._secular_roots_host(d, z, 0.7)
        jzs, jlive = z.copy(), np.ones(12, bool)
        jrot = jtds._deflation_scan(d, jzs, jlive, 1e-12)
    for g, w in zip(got, want):
        for f in ("d", "e", "v", "tau", "phase"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    for g, w in zip(roots + rot + (zs, live), jroots + tuple(jrot) + (jzs, jlive)):
        np.testing.assert_array_equal(g, w)
    assert len(rot[0]) == 1
    assert fallbacks("band_to_tridiag") == 2
    assert fallbacks("secular") == 1 and fallbacks("deflate") == 1
    # outside the drill the native library loads again, and agrees with
    # the numpy chase to rounding
    nat = pb2t.band_to_tridiag(band, b)
    np.testing.assert_allclose(nat.d, got[0].d, atol=1e-12)
    assert fallbacks("band_to_tridiag") == 2


def test_force_native_failure_eigensolver_meets_budgets(tmp_path, devices8):
    """The eigensolver with every native site degraded: eigenvalues at the
    reference's (its own drilled run) to 1e-12 scale, eigenpairs within
    200 n eps."""
    from dlaf_tpu_torch.miniapp.miniapp_eigensolver import eigen_residuals

    jeig = importlib.import_module("dlaf_tpu.eigensolver.eigensolver")
    metrics_on(tmp_path)
    n, nb = 48, 8
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, n))
    a = (x + x.T) / 2
    with inject.force_native_failure():
        res = peig.eigensolver("L", pmat(a, nb, (2, 2)), band_size=4)
    with jinject.force_native_failure():
        ref = np.asarray(jeig.eigensolver("L", jmat(a, nb, devices8), band_size=4).eigenvalues)
    np.testing.assert_allclose(res.eigenvalues, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    vals = eigen_residuals(torch.as_tensor(a), None, res.eigenvalues,
                           res.eigenvectors.to_global())
    assert max(vals.values()) < 200 * n * np.finfo(np.float64).eps
    for site in ("band_to_tridiag", "secular", "deflate"):
        assert fallbacks(site) >= 1, site


def test_run_with_fallback_breaker_skips_failing_primary(tmp_path):
    metrics_on(tmp_path, circuit_threshold=2, circuit_cooldown_s=1e9)
    calls = []

    def primary():
        calls.append(1)
        raise RuntimeError("boom")

    for _ in range(4):
        assert registry.run_with_fallback("t_site", primary, lambda: "fb") == "fb"
    assert len(calls) == 2                      # skipped once the breaker opened
    assert fallbacks("t_site") == 2 and fallbacks("t_site", "circuit_open") == 2
    with pytest.raises(ValueError):
        registry.run_with_fallback("t_other", lambda: (_ for _ in ()).throw(ValueError("x")),
                                   lambda: "fb", expected=RuntimeError)
    assert registry.fallback_counts()[("t_site", "native_unavailable")] == 2


# ---------------------------------------------------------------------------
# Route degradations: bitwise the composed routes, no kernel called
# ---------------------------------------------------------------------------

def count_kernels(monkeypatch):
    calls = {}

    def wrap(mod, name):
        fn = getattr(mod, name)

        def counted(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        monkeypatch.setattr(mod, name, counted)

    for name in ("potrf", "panel_solve", "factor_solve", "step"):
        wrap(pk, name)
    wrap(uk, "masked_trailing_update")
    for name in ("ozaki_product", "ozaki_masked_product", "ozaki_syrk"):
        wrap(ok, name)
    return calls


def residual(f, a, uplo="L"):
    f = np.tril(f) if uplo == "L" else np.triu(f)
    g = f @ f.conj().T if uplo == "L" else f.conj().T @ f
    return np.linalg.norm(g - a) / np.linalg.norm(a)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_pallas_off_local_is_the_composed_route(uplo, monkeypatch, tmp_path):
    n, nb = 48, 16
    a = hpd(n, np.float32, 3)
    knobs(monkeypatch, panel_impl="fused", step_impl="fused", cholesky_lookahead=1)
    calls = count_kernels(monkeypatch)
    fused = pchol.cholesky(uplo, pmat(a, nb)).to_numpy()
    assert calls.get("step", 0) + calls.get("potrf", 0) > 0
    calls.clear()
    with inject.disable_pallas():
        degraded = pchol.cholesky(uplo, pmat(a, nb)).to_numpy()
    assert not calls
    with jinject.disable_pallas():
        ref = np.asarray(jchol.cholesky(uplo, JMatrix.from_global(
            a, JTileElementSize(nb, nb))).to_numpy())
    knobs(monkeypatch, panel_impl="xla", step_impl="xla")
    composed = pchol.cholesky(uplo, pmat(a, nb)).to_numpy()
    np.testing.assert_array_equal(degraded, composed)
    eps = np.finfo(np.float32).eps
    tri = np.tril if uplo == "L" else np.triu
    assert np.abs(tri(degraded) - tri(ref)).max() < 60 * n * eps * np.abs(ref).max()
    for f in (fused, degraded):
        assert residual(f.astype(np.float64), a, uplo) < 60 * n * eps
    assert registry.fallback_counts()[("panel", "injected_off")] >= 1
    assert registry.fallback_counts()[("step", "injected_off")] >= 1


def test_pallas_off_distributed_update(monkeypatch, tmp_path, devices8):
    """The update kernel's route closed by the drill on a 2x2 grid: bitwise
    the route off by policy, within 60 n eps of the reference's drilled
    factor."""
    n, nb = 32, 4
    a = hpd(n, np.float32, 5)
    knobs(monkeypatch, force_pallas_update=1)
    path = metrics_on(tmp_path)
    calls = count_kernels(monkeypatch)
    pchol.cholesky("L", pmat(a, nb, (2, 2)))
    assert calls.get("masked_trailing_update", 0) > 0
    calls.clear()
    with inject.disable_pallas():
        degraded = pchol.cholesky("L", pmat(a, nb, (2, 2))).to_numpy()
    assert not calls
    assert fallbacks("pallas_update", "injected_off") >= 1
    with jinject.disable_pallas():
        ref = np.asarray(jchol.cholesky("L", jmat(a, nb, devices8, (2, 2))).to_numpy())
    monkeypatch.delenv("DLAF_FORCE_PALLAS_UPDATE")
    config.initialize(config.Configuration(metrics_path=path, log="off"))
    composed = pchol.cholesky("L", pmat(a, nb, (2, 2))).to_numpy()
    np.testing.assert_array_equal(degraded, composed)
    eps = np.finfo(np.float32).eps
    assert np.abs(np.tril(degraded) - np.tril(ref)).max() < 60 * n * eps * np.abs(ref).max()
    assert residual(degraded.astype(np.float64), a) < 60 * n * eps


def test_ozaki_off_distributed_is_the_native_product(monkeypatch, devices8):
    """``disable_ozaki`` on the distributed f64 Ozaki route (pair kernel
    and slice products): no slice kernel is called, the factor is bitwise
    ``f64_gemm=native``'s, and within c n eps of the reference's drilled
    factor."""
    n, nb = 96, 32
    a = hpd(n)
    knobs(monkeypatch, f64_gemm="mxu", f64_trsm="mixed", ozaki_impl="pallas",
          f64_gemm_min_dim=16)
    calls = count_kernels(monkeypatch)
    pchol.cholesky("L", pmat(a, nb, (2, 2)))
    assert calls.get("ozaki_product", 0) > 0 and calls.get("ozaki_masked_product", 0) > 0
    calls.clear()
    with inject.disable_ozaki():
        assert not tb.f64_gemm_uses_mxu(torch.float64, nb, "cpu")
        degraded = pchol.cholesky("L", pmat(a, nb, (2, 2))).to_numpy()
    assert not calls
    assert tb.f64_gemm_uses_mxu(torch.float64, nb, "cpu")        # restored on exit
    with jinject.disable_ozaki():
        ref = np.asarray(jchol.cholesky("L", jmat(a, nb, devices8, (2, 2))).to_numpy())
    knobs(monkeypatch, f64_gemm="native")
    native = pchol.cholesky("L", pmat(a, nb, (2, 2))).to_numpy()
    np.testing.assert_array_equal(degraded, native)
    eps = np.finfo(np.float64).eps
    assert np.abs(np.tril(degraded) - np.tril(ref)).max() < 60 * n * eps * np.abs(ref).max()
    assert residual(degraded, a) < 1e-12


def test_route_drills_reset_breakers_and_nest_by_name():
    circuit.breaker("fallback.x").record_failure()
    circuit.breaker("serve.y")
    with inject.disable_pallas():
        with inject.disable_ozaki():
            assert inject.route_disabled("pallas") and inject.route_disabled("ozaki")
        assert not inject.route_disabled("ozaki")
    assert not inject.route_disabled("pallas")
    assert circuit.peek("fallback.x") is None and circuit.peek("serve.y") == "closed"


# ---------------------------------------------------------------------------
# DLAF_STRICT: every gated site raises (the coverage audit below)
# ---------------------------------------------------------------------------

def _band():
    band = np.zeros((3, 8))
    band[0] = np.arange(1.0, 9.0)
    return band


def _strict_secular():
    with inject.force_native_failure():
        ptds._secular_roots_host(np.arange(1.0, 7.0), np.full(6, 0.4), 0.5)


def _strict_deflate():
    with inject.force_native_failure():
        ptds._deflation_scan(np.array([1.0, 1.0 + 1e-14, 2.0]), np.full(3, 0.5),
                             np.ones(3, bool), 1e-8)


def _strict_b2t():
    with inject.force_native_failure():
        pb2t.band_to_tridiag(_band(), 2)


def _strict_pallas_update(monkeypatch):
    monkeypatch.setenv("DLAF_FORCE_PALLAS_UPDATE", "1")
    with inject.disable_pallas():
        pchol.cholesky("L", pmat(hpd(8, np.float32), 4, (2, 2)))


def _strict_ozaki_gemm(monkeypatch):
    knobs(monkeypatch, f64_gemm="mxu", f64_gemm_min_dim=4, strict=1)
    with inject.disable_ozaki():
        tb.f64_gemm_uses_mxu(torch.float64, 8, "cpu")


def _strict_ozaki_pallas(monkeypatch):
    knobs(monkeypatch, f64_gemm="mxu", f64_gemm_min_dim=4, ozaki_impl="pallas", strict=1)
    with inject.disable_pallas():
        pchol.cholesky("L", pmat(hpd(16), 4, (2, 2)))


def _strict_panel(monkeypatch):
    knobs(monkeypatch, panel_impl="fused", strict=1)
    with inject.disable_pallas():
        pchol.cholesky("L", pmat(hpd(16, np.float32), 4))


def _strict_step(monkeypatch):
    knobs(monkeypatch, step_impl="fused", strict=1)
    pchol.cholesky("L", pmat(hpd(16), 4))


def _strict_step_drill(monkeypatch):
    knobs(monkeypatch, step_impl="fused", strict=1)
    with inject.disable_pallas():
        pchol.cholesky("U", pmat(hpd(16, np.float32), 4))


STRICT_CASES = {  # name: (run, site, reason)
    "secular": (lambda mp: _strict_secular(), "secular", "native_unavailable"),
    "deflate": (lambda mp: _strict_deflate(), "deflate", "native_unavailable"),
    "band_to_tridiag": (lambda mp: _strict_b2t(), "band_to_tridiag", "native_unavailable"),
    "pallas_update": (_strict_pallas_update, "pallas_update", "injected_off"),
    "ozaki_gemm": (_strict_ozaki_gemm, "ozaki_gemm", "injected_off"),
    "ozaki_pallas": (_strict_ozaki_pallas, "ozaki_pallas", "injected_off"),
    "panel": (_strict_panel, "panel", "injected_off"),
    "step": (_strict_step, "step", "unsupported_dtype"),
    "step-drill": (_strict_step_drill, "step", "injected_off"),
}


@pytest.mark.parametrize("name", sorted(STRICT_CASES))
def test_strict_site_raises(name, monkeypatch):
    run, site, reason = STRICT_CASES[name]
    monkeypatch.setenv("DLAF_STRICT", "1")
    config.initialize()
    with pytest.raises(health.DegradationError) as ei:
        run(monkeypatch)
    assert (ei.value.site, ei.value.reason) == (site, reason)
    # counted before the raise
    assert registry.fallback_counts()[(site, reason)] >= 1


def test_strict_coverage_audit_no_unlisted_site():
    """Every degradation-site literal in the port is a site of the
    reference's and has a strict case above; every site of the reference
    is gated in the port (the reference's audit, run over both)."""
    pat = re.compile(r"report_fallback\(\s*['\"]([a-z0-9_]+)['\"]"
                     r"|route_available\(\s*['\"][a-z0-9_]+['\"]\s*,\s*['\"]([a-z0-9_]+)['\"]"
                     r"|run_with_fallback\(\s*['\"]([a-z0-9_]+)['\"]"
                     r"|_route\(\s*['\"][a-z0-9_]+['\"]\s*,\s*['\"]([a-z0-9_]+)['\"]")

    def sites(pkg):
        found = set()
        for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, pkg)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in filenames:
                if fn.endswith(".py"):
                    for m in pat.finditer(open(os.path.join(dirpath, fn)).read()):
                        found.add(next(g for g in m.groups() if g))
        return found

    covered = {site for _, site, _ in STRICT_CASES.values()}
    port, ref = sites("dlaf_tpu_torch"), sites("dlaf_tpu")
    assert port, "the audit found no site: the pattern rotted"
    assert port <= covered, f"sites {sorted(port - covered)} have no strict case"
    assert ref <= port, f"reference sites {sorted(ref - port)} are not gated in the port"


def test_cuda_kernel_build_failure_raises_without_fallback(monkeypatch):
    """A failed kernel build raises from the library's load, and never
    closes a route gate: the gates read the configuration and the drills
    only, and no kernel module catches or reports a failure."""
    def failing_build(self):
        raise RuntimeError("nvcc failed (1): synthetic")

    monkeypatch.setattr(cb.CudaLibrary, "build", failing_build)
    for lib in (pk.LIBRARY, uk.LIBRARY, ok.LIBRARY):
        monkeypatch.setattr(lib, "_lib", None)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            lib.load()
    monkeypatch.setenv("DLAF_STRICT", "1")
    config.initialize()
    before = registry.fallback_counts()
    assert pk.panel_uses_fused(torch.float32, 256, "cuda")
    assert pk.step_uses_fused(torch.float32, 256, "cuda")
    assert uk.supports_update(torch.float32, "cuda")
    assert registry.fallback_counts() == before
    for mod in ("cuda_build", "panel_kernels", "update_kernels", "ozaki_kernels",
                "givens_kernels"):
        src = open(os.path.join(ROOT, "dlaf_tpu_torch", "tile_ops", f"{mod}.py")).read()
        assert "run_with_fallback" not in src, mod
        # the build's one handler collects the nvcc errors and raises them
        assert re.findall(r"except\b.*", src) == (
            ["except RuntimeError as e:"] if mod == "cuda_build" else []), mod


# ---------------------------------------------------------------------------
# hang: a deadline on a fake clock
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_hang_charges_the_deadline_as_the_reference(tmp_path):
    path = metrics_on(tmp_path)
    results = []
    for hmod, pmod in ((inject, policy), (jinject, jpolicy)):
        pol = pmod.RetryPolicy(max_attempts=3, attempt_deadline_s=1.0)
        with hmod.hang("t.site", 2.5):
            with pytest.raises(Exception) as ei:
                pmod.with_policy("t.site", lambda: 7, policy=pol, clock=FakeClock())
        results.append((type(ei.value).__name__, ei.value.site, ei.value.elapsed_s,
                        ei.value.deadline_s, ei.value.attempt))
        assert pmod.with_policy("t.site", lambda: 7, policy=pol, clock=FakeClock()) == 7
        with hmod.hang("t.other", 5.0):
            assert pmod.with_policy("t.site", lambda: 8, policy=pol, clock=FakeClock()) == 8
    assert results[0] == results[1] == ("DeadlineExceededError", "t.site", 2.5, 1.0, 0)
    assert inject.hang_seconds("t.site") == 0.0
    with pytest.raises(ValueError):
        with inject.hang("t.site", -1.0):
            pass
    obs.flush()
    assert [r["event"] for r in obs.read_records(path) if r.get("type") == "resilience"] \
        == ["deadline"]
