"""Panel kernels of the PyTorch port against the JAX reference's Pallas
kernels.

The same inputs, made with numpy from a seed, go through
``dlaf_tpu.tile_ops.pallas_panel`` (Pallas kernels in interpret mode) and
through the port's ``dlaf_tpu_torch.tile_ops.panel_kernels`` on CPU
tensors, where each wrapper runs its plain PyTorch version. The CUDA
kernels themselves run only on the card, where ``chip_smoke.py`` holds
each against its plain version.

Tolerance: both sides compute in float32 with the same math (micro-block
ladder, blocked triangular inverse, masked slab) but sum in different
orders, so results agree to ``8 * d * eps_f32`` relative to the largest
entry — the reference's own fused-vs-composed parity bound
(tests/test_pallas_panel.py ULP_C). bfloat16 outputs agree to two bf16
ulps of the largest entry.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlaf_tpu.tile_ops import pallas_panel as ppan
from dlaf_tpu_torch import config
from dlaf_tpu_torch.health.info import local_factor_info
from dlaf_tpu_torch.tile_ops import panel_kernels as pk

EPS32 = float(np.finfo(np.float32).eps)
BF16_TOL = 2 * 2.0 ** -8


def bound(d):
    return 8 * d * EPS32


def hpd(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    return (x @ x.T + n * np.eye(n)).astype(np.float32)


def rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(autouse=True)
def _fresh_config():
    config.initialize()
    yield
    config.initialize()


@pytest.mark.parametrize("d", [16, 40])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_potrf_plain_matches_fused_potrf(uplo, d):
    a = hpd(d, seed=d)
    ref = np.asarray(ppan.fused_potrf(uplo, jnp.asarray(a), interpret=True))
    got = pk.potrf(uplo, torch.tensor(a)).numpy()
    assert rel(got, ref) <= bound(d)
    # the opposite triangle passes through exactly
    other = np.triu(a, 1) if uplo == "L" else np.tril(a, -1)
    np.testing.assert_array_equal(np.triu(got, 1) if uplo == "L" else np.tril(got, -1), other)


def test_potrf_plain_bf16_matches_fused_potrf():
    a = jnp.asarray(hpd(16, seed=3), dtype=jnp.bfloat16)
    ref = np.asarray(ppan.fused_potrf("L", a, interpret=True).astype(jnp.float32))
    got = pk.potrf("L", torch.tensor(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert rel(got.float().numpy(), ref) <= BF16_TOL


@pytest.mark.parametrize("combo,alpha,batched", [
    (("R", "L", "C", "N"), 1.0, False),
    (("R", "U", "C", "N"), 1.0, False),
    (("L", "L", "C", "N"), 1.0, False),
    (("L", "U", "C", "N"), 1.0, False),
    (("R", "L", "N", "U"), 1.0, False),
    (("L", "L", "T", "N"), 2.5, False),
    (("R", "U", "C", "N"), 1.0, True),
])
def test_panel_solve_plain_matches_fused_panel_solve(combo, alpha, batched):
    side, uplo, op, diag = combo
    na = 16
    rng = np.random.default_rng(11)
    t = np.tril(rng.standard_normal((na, na))).astype(np.float32) + na * np.eye(na, dtype=np.float32)
    if uplo == "U":
        t = t.T.copy()
    shape = (3, na, na) if batched else ((40, na) if side == "R" else (na, 40))
    b = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(ppan.fused_panel_solve(side, uplo, op, diag, jnp.asarray(t), jnp.asarray(b),
                                            alpha=alpha, interpret=True))
    got = pk.panel_solve(side, uplo, op, diag, torch.tensor(t), torch.tensor(b), alpha=alpha)
    assert tuple(got.shape) == shape
    assert rel(got.numpy(), ref) <= bound(na)


@pytest.mark.parametrize("m", [40, 10])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_step_plain_matches_fused_step(uplo, m):
    d = 16
    w = min(d, m)
    rng = np.random.default_rng(5)
    diag = hpd(d, seed=7)
    strip = rng.standard_normal((m, d)).astype(np.float32)
    slab = rng.standard_normal((m, w)).astype(np.float32)
    if uplo == "U":
        diag, strip, slab = diag.T.copy(), strip.T.copy(), slab.T.copy()
    ref = ppan.fused_step(uplo, jnp.asarray(diag), jnp.asarray(strip), jnp.asarray(slab),
                          interpret=True)
    got = pk.step(uplo, torch.tensor(diag), torch.tensor(strip), torch.tensor(slab))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        assert rel(g.numpy(), r) <= bound(d)


def test_indefinite_tile_nan_prefix_matches_reference():
    """potrf_info contract: the factor's diagonal is non-finite from the
    first failing column on, and the solved strip's columns from there on;
    the port's plain versions fail at the same column as the Pallas
    kernels. Off the diagonal, the reference's micro-panel update spreads
    NaN into the failing rows' earlier columns (NaN * 0); the port does
    the same, so the WHOLE NaN mask of the factor and the step are held
    (at d=256 and d=200 in ``test_indefinite_tile_nan_mask_and_info``)."""
    d, m = 16, 24
    a = hpd(d, seed=2)
    a[5, 5] = -100.0
    rng = np.random.default_rng(9)
    strip = rng.standard_normal((m, d)).astype(np.float32)
    slab = rng.standard_normal((m, d)).astype(np.float32)
    ref_f = np.asarray(ppan.fused_potrf("L", jnp.asarray(a), interpret=True))
    got_f = pk.potrf("L", torch.tensor(a))
    ref_s = ppan.fused_step("L", jnp.asarray(a), jnp.asarray(strip), jnp.asarray(slab),
                            interpret=True)
    got_s = pk.step("L", torch.tensor(a), torch.tensor(strip), torch.tensor(slab))
    assert int(local_factor_info(got_f)) == int(local_factor_info(got_s[0])) == 6
    for g, r in ((got_f, ref_f), (got_s[0], ref_s[0])):
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(np.asarray(r)))
    # solved strip: finite columns before the failing one, none from it on
    for p in (got_s[1].numpy(), np.asarray(ref_s[1])):
        np.testing.assert_array_equal(np.isfinite(p).all(axis=0), np.arange(d) < 5)
    np.testing.assert_array_equal(np.isfinite(got_s[2].numpy()), np.isfinite(np.asarray(ref_s[2])))


@pytest.mark.parametrize("pivot", [1, 8, 9, 38, "last", "zero"])
@pytest.mark.parametrize("d", [256, 200])
def test_indefinite_tile_nan_mask_and_info(d, pivot):
    """The whole potrf_info failure contract at the main path's tile and a
    ragged one, the contract the CUDA factor is held to on the card: the
    first failing column (info) and the WHOLE NaN mask of the factor equal
    the Pallas ladder's, for a pivot at the edges of a micro-panel (1, 8,
    9), inside one (38), in the last column, and an exactly zero pivot (a
    zero row and column, so no rounding decides it)."""
    a = hpd(d, seed=3)
    if pivot == "zero":
        a[37, :] = 0.0
        a[:, 37] = 0.0
        want = 38
    else:
        want = d if pivot == "last" else pivot
        a[want - 1, want - 1] = -1000.0
    ref = np.asarray(ppan.fused_potrf("L", jnp.asarray(a), interpret=True))
    got = pk.potrf("L", torch.tensor(a)).numpy()
    assert int(local_factor_info(torch.tensor(got))) == int(local_factor_info(torch.tensor(ref))) \
        == want
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))


@pytest.mark.parametrize("entry", ["factor_solve", "panel_solve", "panel_solve U"])
@pytest.mark.parametrize("pivot", [1, 8, 9, 38, "last", "zero"])
@pytest.mark.parametrize("d", [256, 200])
def test_solved_strip_nan_columns_match_reference(d, pivot, entry):
    """The contract the CUDA inverse is held to on the card, through the
    strip product: column c of a solved strip is NaN exactly when row c of
    the triangle's inverse holds a NaN, so the inverse must put NaN in the
    rows where the reference's blocked ``_tri_inv_lower`` does (the failing
    row and every later one) and in no row before. ``factor_solve`` factors
    the indefinite tile first; ``panel_solve`` solves against the failed
    factor of the same tile, stored lower or (``U``) upper: the upper
    triangle's strip takes the inverse's columns instead. The port's plain
    versions against the Pallas kernels, pivots as in
    ``test_indefinite_tile_nan_mask_and_info``."""
    a = hpd(d, seed=3)
    if pivot == "zero":
        a[37, :] = 0.0
        a[:, 37] = 0.0
        first = 37
    else:
        first = (d if pivot == "last" else pivot) - 1
        a[first, first] = -1000.0
    strip = np.random.default_rng(d).standard_normal((24, d)).astype(np.float32)
    if entry == "factor_solve":
        ref = np.asarray(ppan.fused_factor_solve("L", jnp.asarray(a), jnp.asarray(strip),
                                                 interpret=True)[1])
        got = pk.factor_solve("L", torch.tensor(a), torch.tensor(strip))[1].numpy()
    else:
        uplo = entry[-1] if entry.endswith("U") else "L"
        fac = pk.potrf_plain("L", torch.tensor(a)).numpy()
        fac = fac if uplo == "L" else fac.T.copy()
        ref = np.asarray(ppan.fused_panel_solve("R", uplo, "C", "N", jnp.asarray(fac),
                                                jnp.asarray(strip), interpret=True))
        got = pk.panel_solve("R", uplo, "C", "N", torch.tensor(fac), torch.tensor(strip)).numpy()
    nan_cols = np.isnan(got).any(axis=0)
    np.testing.assert_array_equal(nan_cols, np.isnan(ref).any(axis=0))
    if entry != "panel_solve U":
        np.testing.assert_array_equal(nan_cols, np.arange(d) >= first)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))


def test_cpu_wrappers_run_plain_versions_without_launching():
    pk.reset_launches()
    a = torch.tensor(hpd(16))
    b = torch.tensor(np.random.default_rng(0).standard_normal((20, 16)).astype(np.float32))
    assert torch.equal(pk.potrf("L", a), pk.potrf_plain("L", a))
    assert torch.equal(pk.panel_solve("R", "L", "C", "N", a, b),
                       pk.panel_solve_plain("R", "L", "C", "N", a, b))
    for g, r in zip(pk.step("L", a, b, b), pk.step_plain("L", a, b, b)):
        assert torch.equal(g, r)
    for g, r in zip(pk.factor_solve("U", a, b.mT), pk.factor_solve_plain("U", a, b.mT)):
        assert torch.equal(g, r)
    assert pk.LAUNCHES == {"potrf": 0, "solve": 0, "factor_solve": 0, "step": 0}


@pytest.mark.parametrize("dtype,nb,fused", [
    (torch.float32, 256, True),
    (torch.bfloat16, 64, True),
    (torch.float64, 64, False),
    (torch.complex64, 64, False),
    (torch.float32, 512, False),
])
def test_route_policy_explicit_fused(dtype, nb, fused):
    """An explicit ``fused`` binds on both devices for f32/bf16 tiles up to
    256; other dtypes and larger tiles take the composed route."""
    config.initialize(argv=["--dlaf:panel-impl=fused", "--dlaf:step-impl=fused"])
    for dev in ("cpu", "cuda"):
        assert pk.panel_uses_fused(dtype, nb, dev) is fused
        assert pk.step_uses_fused(dtype, nb, dev) is fused


def test_library_path_is_keyed_by_source():
    path = pk.library_path()
    assert path.startswith(pk._BUILD) and path.endswith(".so")
    assert path == pk.library_path()
