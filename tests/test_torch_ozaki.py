"""Ozaki slice products and mixed-precision panels of the PyTorch port
against the JAX reference.

The same inputs, made with numpy from a seed, go through
``dlaf_tpu.tile_ops.ozaki`` / ``pallas_ozaki`` (Pallas kernels in
interpret mode) / ``mixed`` and through the port's ``dlaf_tpu_torch``
counterparts on CPU tensors, where each kernel wrapper runs its plain
PyTorch version. The CUDA kernel itself runs only on the card, where
``chip_smoke.py`` holds it against its plain version bit for bit.

Tolerances: the peel, the integer group sums and both folds are
deterministic IEEE sequences, so slices, ``(hi, lo)`` planes and the
``matmul_f64``/``syrk_f64``/``matmul_c128``/``herk_c128`` results are held
BIT FOR BIT on both ``ozaki_impl`` routes. The mixed panels run their seed
through two different libraries (XLA's and LAPACK's f32 cholesky), so they
are held at ``c * n * eps`` with the reference's Cholesky budget c = 60.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlaf_tpu import config as jcfg
from dlaf_tpu.tile_ops import mixed as jmx
from dlaf_tpu.tile_ops import ozaki as joz
from dlaf_tpu.tile_ops.pallas_ozaki import fused_slice_product, fused_slice_syrk
from dlaf_tpu_torch import config
from dlaf_tpu_torch.tile_ops import mixed as mx
from dlaf_tpu_torch.tile_ops import ozaki as oz
from dlaf_tpu_torch.tile_ops import ozaki_kernels as ok

KNOBS = ("OZAKI_IMPL", "F64_GEMM_SLICES", "MIXED_COND_LIMIT", "MIXED_SEED",
         "MIXED_SEED_BASE")


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    jcfg.initialize()
    yield
    for knob in KNOBS:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    jcfg.initialize()


def set_knobs(monkeypatch, **knobs):
    """The same knobs, through the environment, for both packages."""
    for k, v in knobs.items():
        monkeypatch.setenv("DLAF_" + k.upper(), str(v))
    config.initialize()
    jcfg.initialize()


def operands(m, k, n, seed=41, complex_=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k))
    b = rng.standard_normal((k, n))
    if complex_:
        a = a + 1j * rng.standard_normal((m, k))
        b = b + 1j * rng.standard_normal((k, n))
    return a, b


def jax_slices(x, s, axis):
    sc = joz._scale(jnp.asarray(x), axis=axis)
    return jnp.stack(joz._peel_slices(joz._normalize(jnp.asarray(x), sc), s))


def fold_replay(ia, ib):
    """Numpy replay of ``pallas_ozaki._fold_body`` (the reference's own
    exactness pin, tests/test_ozaki.py): exact int64 group sums, the
    int -> double-f32 split and the two-sum fold."""
    s = ia.shape[0]
    ia64, ib64 = np.asarray(ia, np.int64), np.asarray(ib, np.int64)
    hi = np.zeros((ia.shape[1], ib.shape[2]), np.float32)
    lo = np.zeros_like(hi)
    for d in range(s):
        p = np.zeros(hi.shape, np.int64)
        for t in range(d + 1):
            p = p + ia64[t] @ ib64[d - t]
        phi = p.astype(np.float32)
        plo = (p - phi.astype(np.int64)).astype(np.float32)
        scale = np.float32(2.0 ** (-7 * (d + 2)))
        b32 = phi * scale
        ssum = hi + b32
        bb = ssum - hi
        err = (hi - (ssum - bb)) + (b32 - bb)
        hi = ssum
        lo = lo + (err + plo * scale)
    return hi, lo


@pytest.mark.parametrize("s", [6, 8])
@pytest.mark.parametrize("shape,axis", [((40, 64), -1), ((33, 17), -2), ((5, 200), -1)])
def test_scale_and_peel_bitwise(shape, axis, s):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape) * np.exp(rng.uniform(-20, 20, shape))
    x[1] = 0.0   # a zero row maps to scale 1
    ref_sc = joz._scale(jnp.asarray(x), axis=axis)
    got_sc = oz._scale(torch.tensor(x), axis)
    np.testing.assert_array_equal(got_sc.numpy(), np.asarray(ref_sc))
    ref = joz._peel_slices(joz._normalize(jnp.asarray(x), ref_sc), s)
    got = oz._peel_slices(oz._normalize(torch.tensor(x), got_sc), s)
    assert len(got) == s
    for g, r in zip(got, ref):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("m,k,n,s", [(40, 64, 24, 6), (33, 50, 17, 8), (16, 96, 40, 3),
                                     (40, 32, 24, 1), (33, 200, 17, 9)])
def test_product_plain_matches_fused_slice_product(m, k, n, s):
    a, b = operands(m, k, n)
    ia, ib = jax_slices(a, s, -1), jax_slices(b, s, -2)
    ref = fused_slice_product(ia, ib, block_m=16, block_n=16, interpret=True)
    got = ok.ozaki_product(torch.tensor(np.asarray(ia)), torch.tensor(np.asarray(ib)))
    replay = fold_replay(ia, ib)
    for g, r, p in zip(got, ref, replay):
        assert g.dtype == torch.float32 and tuple(g.shape) == (m, n)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), p)


@pytest.mark.parametrize("m,k,s", [(40, 64, 8), (300, 16, 3), (40, 32, 1), (300, 200, 9)])
def test_syrk_plain_matches_fused_slice_syrk(m, k, s):
    """Whole (hi, lo) planes: the 256-row blocks on and below the block
    diagonal, and the zero blocks above it (m=300 has one)."""
    a, _ = operands(m, k, 1, seed=5)
    ia = jax_slices(a, s, -1)
    ref = fused_slice_syrk(ia, interpret=True)
    got = ok.ozaki_syrk(torch.tensor(np.asarray(ia)))
    replay = fold_replay(ia, np.swapaxes(np.asarray(ia), 1, 2))
    blk = np.arange(m) // ok.SYRK_BLOCK
    upper = blk[None, :] > blk[:, None]
    for g, r, p in zip(got, ref, replay):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy()[~upper], p[~upper])
        assert not g.numpy()[upper].any()


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("fn", ["matmul_f64", "syrk_f64", "matmul_c128", "herk_c128"])
def test_products_match_reference_bitwise(fn, impl, monkeypatch):
    """Both routes replay the reference's order exactly: bit for bit."""
    set_knobs(monkeypatch, ozaki_impl=impl)
    a, b = operands(37, 45, 21, seed=11, complex_=fn.endswith("c128"))
    if fn.startswith("matmul"):
        ref = getattr(joz, fn)(jnp.asarray(a), jnp.asarray(b))
        got = getattr(oz, fn)(torch.tensor(a), torch.tensor(b))
        exact = a @ b
    else:
        ref = getattr(joz, fn)(jnp.asarray(a))
        got = getattr(oz, fn)(torch.tensor(a))
        exact = a @ a.conj().T
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # and it is an f64-grade product (the pallas fold keeps ~48 bits)
    tol = 1e-13 if impl == "jnp" else 1e-12
    assert np.abs(got.numpy() - exact).max() <= tol * np.abs(a).max() ** 2 * a.shape[1]


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("fn", ["syrk_f64", "herk_c128"])
@pytest.mark.parametrize("tri", ["L", "U"])
def test_gram_without_mirror_keeps_reference_triangle(tri, fn, impl, monkeypatch):
    """``tri`` forms no mirror; the triangle it names is the reference's
    mirrored gram's, bit for bit."""
    set_knobs(monkeypatch, ozaki_impl=impl)
    a, _ = operands(40, 45, 1, seed=13, complex_=fn == "herk_c128")
    ref = np.asarray(getattr(joz, fn)(jnp.asarray(a)))
    got = getattr(oz, fn)(torch.tensor(a), tri=tri).numpy()
    keep = np.tril if tri == "L" else np.triu
    np.testing.assert_array_equal(keep(got), keep(ref))


def test_slices_knob_and_mm_mxu(monkeypatch):
    """``f64_gemm_slices`` reaches the product; ``mm_mxu`` promotes a
    mixed real/complex pair to complex128 as the reference does."""
    from dlaf_tpu.tile_ops import blas as jtb
    from dlaf_tpu_torch.tile_ops import blas as tb

    set_knobs(monkeypatch, f64_gemm_slices=5)
    a, b = operands(12, 20, 9, seed=2)
    bc = b + 0.5j * b
    ref = jtb.mm_mxu(jnp.asarray(a), jnp.asarray(bc))
    got = tb.mm_mxu(torch.tensor(a), torch.tensor(bc))
    assert got.dtype == torch.complex128
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    err5 = np.abs(got.numpy() - a @ bc).max()
    assert 1e-14 < err5 < 1e-8   # 35 bits: coarser than f64, far finer than f32


def hpd(n, dtype, seed=0, cond=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((n, n))
    a = x @ x.conj().T + n * np.eye(n)
    if cond is not None:   # graded diagonal: condition ~cond
        d = np.logspace(0, np.log10(cond) / 2, n)
        a = a * d[:, None] * d[None, :]
    return a.astype(dtype)


def budget(n, dtype):
    return 60 * n * np.finfo(dtype).eps


def rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("seed_kind", ["xla", "recursive"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_mixed_entry_points_match_reference(uplo, dtype, seed_kind, monkeypatch):
    set_knobs(monkeypatch, mixed_seed=seed_kind, mixed_seed_base=8)
    n = 24
    a = hpd(n, dtype, seed=4)
    if uplo == "U":
        a = a.conj().T.copy()
    ja, ta = jnp.asarray(a), torch.tensor(a)
    rf, ri = jmx.potrf_inv_refined(uplo, ja)
    gf, gi = mx.potrf_inv_refined(uplo, ta)
    assert rel(gf.numpy(), np.asarray(rf)) <= budget(n, dtype)
    assert rel(gi.numpy(), np.asarray(ri)) <= budget(n, dtype)
    assert rel(mx.potrf_refined(uplo, ta).numpy(), np.asarray(jmx.potrf_refined(uplo, ja))) \
        <= budget(n, dtype)
    lower = uplo == "L"
    tri = np.asarray(rf)
    assert rel(mx.tri_inv_refined(torch.tensor(tri), lower=lower).numpy(),
               np.asarray(jmx.tri_inv_refined(jnp.asarray(tri), lower=lower))) \
        <= budget(n, dtype)
    # the factor and its inverse are what they claim
    f = gf.numpy()
    herm = np.tril(a) + np.tril(a, -1).conj().T if lower else np.triu(a) + np.triu(a, 1).conj().T
    rec = f @ f.conj().T if lower else f.conj().T @ f
    assert rel(rec, herm) <= budget(n, dtype)
    assert np.abs(gi.numpy() @ f - np.eye(n)).max() <= budget(n, dtype)


@pytest.mark.parametrize("case", ["cond_guard", "nonfinite_seed"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_mixed_fallback_to_native(dtype, case, monkeypatch):
    """The guard's two triggers take the native f64 factor, bit for bit:
    a block whose seed conditioning estimate exceeds ``mixed_cond_limit``,
    and one the f32 seed cannot factor at all (a 2x2 block that is
    positive definite in f64 but singular once rounded to f32). The
    reference's factor of the same block reconstructs it to its budget."""
    n = 16
    if case == "cond_guard":
        a = hpd(n, dtype, seed=6, cond=1e6)
    else:
        a = (n * np.eye(n)).astype(dtype)
        a[-2:, -2:] = [[1.0, 1.0 - 1e-9], [1.0 - 1e-9, 1.0]]
    ta = torch.tensor(a)
    native = torch.tril(torch.linalg.cholesky(ta))
    seed_l, _, l32 = mx._refined_seed(ta)
    if case == "cond_guard":
        assert torch.isfinite(seed_l).all() and mx._diag_ratio_sq(l32) > mx.cond_limit()
    else:
        assert not torch.isfinite(seed_l).all()
    l, linv = mx.potrf_inv_refined("L", ta)
    assert torch.equal(l, native)
    assert torch.equal(linv, torch.linalg.solve_triangular(native, torch.eye(n, dtype=ta.dtype),
                                                           upper=False))
    assert torch.equal(mx.potrf_refined("L", ta), native)
    rf = np.asarray(jmx.potrf_inv_refined("L", jnp.asarray(a))[0])
    assert rel(rf @ rf.conj().T, a) <= budget(n, dtype)
    if case == "cond_guard":
        # the same block under a looser limit stays on the fast path
        set_knobs(monkeypatch, mixed_cond_limit=1e12)
        fast, _ = mx.potrf_inv_refined("L", ta)
        assert not torch.equal(fast, native)
        assert rel(fast.numpy(), native.numpy()) <= 1e-6


@pytest.mark.parametrize("offset,k", [(0, 64), (1, 64), (3, 200), (5, 32)])
def test_k_rows_pads_k_and_aligns_for_tma(offset, k):
    """What the slice kernel's TMA maps are built on: contiguous slices, K
    zero-padded to a multiple of 32 (the padding adds nothing), and a base
    address on a 16-byte boundary, also for a view that starts off one."""
    rng = np.random.default_rng(offset)
    buf = torch.tensor(rng.integers(-64, 65, 3 * 7 * k + offset), dtype=torch.int8)
    x = buf[offset:].reshape(3, 7, k)
    got = ok._k_rows(x)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert got.shape == (3, 7, k + (-k) % 32)
    assert torch.equal(got[..., :k], x) and not got[..., k:].any()


def test_cpu_wrappers_run_plain_versions_without_launching():
    ok.reset_launches()
    rng = np.random.default_rng(0)
    ia = torch.tensor(rng.integers(-64, 65, (4, 20, 33)), dtype=torch.int8)
    ib = torch.tensor(rng.integers(-64, 65, (4, 33, 7)), dtype=torch.int8)
    for g, r in zip(ok.ozaki_product(ia, ib), ok.ozaki_product_plain(ia, ib)):
        assert torch.equal(g, r)
    for g, r in zip(ok.ozaki_syrk(ia), ok.ozaki_syrk_plain(ia)):
        assert torch.equal(g, r)
    pairs = ia.reshape(4, 4, 5, 33)
    mode = torch.tensor([[0, 1, 2, 1]] * 4, dtype=torch.int32)
    for g, r in zip(ok.ozaki_masked_product(pairs, pairs, mode),
                    ok.ozaki_masked_product_plain(pairs, pairs, mode)):
        assert torch.equal(g, r)
    assert ok.LAUNCHES == {"ozaki_product": 0, "ozaki_syrk": 0, "ozaki_masked_product": 0}
    assert ok.LIBRARY.path().endswith(".so") and ok.LIBRARY.path() == ok.LIBRARY.path()
