"""The distributed Cholesky of the PyTorch port, and its two kernels'
plain versions, against the JAX reference.

Kernels: ``masked_trailing_update_plain`` against the Pallas
``masked_trailing_update(interpret=True)`` (float32: the same products
summed in another order, rtol 1e-6 of the largest entry; bfloat16: within
one bf16 ulp of the reference's float32 result rounded down), and
``ozaki_masked_product_plain`` against ``masked_slice_product(interpret=
True)`` bit for bit.

Builder: one seeded numpy HPD matrix with a ragged last tile goes onto the
same grid shape with the same source rank in both packages: the
reference's ``shard_map`` program on the virtual CPU mesh, the port's
per-rank loop with every rank on the CPU (kernel wrappers run their plain
versions). Both read the same ``DLAF_<KNOB>`` variables, and the route each
case names is asserted taken on both sides. Tolerance: the reference's
factor budget, ``60 n eps`` of the type on the largest difference of the
factors relative to the largest entry of ``A``. Further grid, source-rank
and size combinations are held against the port's local builder and
numpy. Within the port, the reference's knob contracts are bitwise:
lookahead, comm_lookahead and with_info on or off.
"""

import contextlib
import importlib
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlaf_tpu import config as jcfg
from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu.common.index2d import RankIndex2D as JRankIndex2D
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu.tile_ops import pallas_kernels as jpk
from dlaf_tpu.tile_ops import pallas_ozaki as jpo
from dlaf_tpu_torch import config
from dlaf_tpu_torch.algorithms.cholesky import cholesky
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import RankIndex2D, TileElementSize
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.miniapp import miniapp_cholesky
from dlaf_tpu_torch.tile_ops import ozaki as oz
from dlaf_tpu_torch.tile_ops import ozaki_kernels as ok
from dlaf_tpu_torch.tile_ops import panel_kernels as pk
from dlaf_tpu_torch.tile_ops import update_kernels as uk

# the module (``dlaf_tpu.algorithms`` re-exports the function under its name)
jchol = importlib.import_module("dlaf_tpu.algorithms.cholesky")

KNOBS = ("CHOLESKY_TRAILING", "CHOLESKY_LOOKAHEAD", "COMM_LOOKAHEAD", "PANEL_IMPL",
         "STEP_IMPL", "OZAKI_IMPL", "F64_GEMM", "F64_TRSM", "F64_GEMM_SLICES",
         "F64_GEMM_MIN_DIM", "FORCE_PALLAS_UPDATE")


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


def set_knobs(monkeypatch, knobs):
    for k, v in knobs.items():
        monkeypatch.setenv("DLAF_" + k.upper(), str(v))
    config.initialize()
    jcfg.initialize()


def hpd(n, dtype, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((n, n))
    return (x @ x.conj().T + n * np.eye(n)).astype(dtype)


def port_factor(a, uplo, nb, P, Q, src=(0, 0), **kw):
    mat = Matrix.from_global(a, TileElementSize(nb, nb), shared_grid(P, Q, "cpu"),
                             source_rank=RankIndex2D(*src))
    out = cholesky(uplo, mat, **kw)
    if kw.get("with_info"):
        return out[0].to_numpy(), int(out[1])
    return out.to_numpy()


def jax_factor(a, uplo, nb, P, Q, src, devices8, with_info=False):
    jchol._dist_cholesky_cached.cache_clear()
    mat = JMatrix.from_global(a, JTileElementSize(nb, nb), JGrid(P, Q, devices=devices8[:P * Q]),
                              source_rank=JRankIndex2D(*src))
    out = jchol.cholesky(uplo, mat, with_info=with_info)
    if with_info:
        return np.asarray(out[0].to_numpy()), int(out[1])
    return np.asarray(out.to_numpy())


def counting(monkeypatch, module, name, when=None):
    """Count the calls of ``module.name`` (trace-time calls on the JAX side)
    for which ``when(*args)`` holds (default: all)."""
    calls = [0]
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        calls[0] += when is None or bool(when(*args))
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapper)
    return calls


# ---------------------------------------------------------------------------
# Kernel #5: the predicated trailing update
# ---------------------------------------------------------------------------

def update_inputs(R, C, nb, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((R, C, nb, nb)).astype(np.float32)
    vr = rng.standard_normal((R, nb, nb)).astype(np.float32)
    vc = rng.standard_normal((C, nb, nb)).astype(np.float32)
    mode = rng.integers(0, 4, size=(R, C)).astype(np.int32)
    mode[0, 0], mode[-1, -1], mode[0, -1], mode[-1, 0] = 0, 1, 2, 3
    return a, vr, vc, mode


@pytest.mark.parametrize("R,C,nb", [(3, 4, 16), (2, 2, 24), (1, 3, 8)])
def test_masked_update_plain_matches_pallas_f32(R, C, nb):
    a, vr, vc, mode = update_inputs(R, C, nb, seed=R * C + nb)
    ref = np.asarray(jpk.masked_trailing_update(jnp.asarray(a), jnp.asarray(vr),
                                                jnp.asarray(vc), jnp.asarray(mode),
                                                interpret=True))
    got = uk.masked_trailing_update_plain(torch.tensor(a), torch.tensor(vr), torch.tensor(vc),
                                          torch.tensor(mode)).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    # mode 0 pairs and the masked-off triangles pass through bitwise
    i = np.arange(nb)
    for r in range(R):
        for c in range(C):
            keep = {0: np.zeros((nb, nb), bool), 1: np.ones((nb, nb), bool),
                    2: i[:, None] >= i[None, :], 3: i[:, None] <= i[None, :]}[mode[r, c]]
            np.testing.assert_array_equal(got[r, c][~keep], a[r, c][~keep])


def test_masked_update_plain_matches_pallas_bf16():
    R, C, nb = 3, 2, 16
    a, vr, vc, mode = update_inputs(R, C, nb, seed=9)
    to = lambda x: torch.tensor(x).to(torch.bfloat16)  # noqa: E731
    ta, tr, tc = to(a), to(vr), to(vc)
    ref = jpk.masked_trailing_update(jnp.asarray(ta.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(tr.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(tc.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(mode), interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    got = uk.masked_trailing_update_plain(ta, tr, tc, torch.tensor(mode))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # within one bf16 ulp of the reference's f32 result rounded down
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(got - ref) <= ulp).all()


def test_masked_update_in_place_on_a_strided_block():
    """The wrapper writes the rank's trailing block in place through a
    strided view of its shard; tiles outside the view are untouched."""
    ltr, ltc, nb = 5, 4, 8
    rng = np.random.default_rng(4)
    shard = torch.tensor(rng.standard_normal((ltr, ltc, nb, nb)).astype(np.float32))
    before = shard.clone()
    block = shard[2:, 1:]
    vr = torch.tensor(rng.standard_normal((3, nb, nb)).astype(np.float32))
    vc = torch.tensor(rng.standard_normal((3, nb, nb)).astype(np.float32))
    mode = torch.tensor([[1, 0, 2], [3, 1, 0], [0, 2, 1]], dtype=torch.int32)
    want = uk.masked_trailing_update_plain(before[2:, 1:], vr, vc, mode)
    uk.reset_launches()
    out = uk.masked_trailing_update(block, vr, vc, mode)
    assert out is block and uk.LAUNCHES["masked_trailing_update"] == 0
    assert torch.equal(shard[2:, 1:], want)
    assert torch.equal(shard[:2], before[:2]) and torch.equal(shard[:, :1], before[:, :1])


@pytest.mark.parametrize("diag_mode", [2, 3])
@pytest.mark.parametrize("nb", [136, 200])
def test_masked_update_plain_matches_pallas_ragged_diagonal(nb, diag_mode):
    """At tile sizes off the kernel's 128-wide sub-tile (the diagonal of a
    mode 2 or 3 pair runs through a sub-tile's interior, and the second
    sub-tile is ragged), with that mode on every diagonal pair: the plain
    version against the Pallas kernel, as in the f32 test above."""
    R = C = 3
    a, vr, vc, mode = update_inputs(R, C, nb, seed=nb + diag_mode)
    np.fill_diagonal(mode, diag_mode)
    ref = np.asarray(jpk.masked_trailing_update(jnp.asarray(a), jnp.asarray(vr),
                                                jnp.asarray(vc), jnp.asarray(mode),
                                                interpret=True))
    got = uk.masked_trailing_update_plain(torch.tensor(a), torch.tensor(vr), torch.tensor(vc),
                                          torch.tensor(mode)).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    i = np.arange(nb)
    tri = i[:, None] >= i[None, :] if diag_mode == 2 else i[:, None] <= i[None, :]
    for r in range(R):
        np.testing.assert_array_equal(got[r, r][~tri], a[r, r][~tri])


def test_masked_update_transposed_operands():
    """uplo 'U' passes transposed views of contiguous panel stacks: the
    wrapper takes them as they are (layout 1, no copy on the card), alone
    or beside a contiguous one, and gives what the same operands made
    contiguous give; strided layouts are copied."""
    R, C, nb = 3, 2, 16
    a, xr, xc, mode = update_inputs(R, C, nb, seed=21)
    xr, xc = torch.tensor(xr), torch.tensor(xc)
    vr, vc = xr.mT, xc.mT
    assert uk.panel_layout(vr) == uk.panel_layout(vc) == 1
    assert uk.panel_layout(xr) == 0 and uk.panel_layout(xr[:, :8, :8]) is None
    want = torch.tensor(a)
    uk.masked_trailing_update(want, vr.contiguous(), vc.contiguous(), torch.tensor(mode))
    for ops in ((vr, vc), (vr, vc.contiguous()), (vr.contiguous(), vc)):
        got = torch.tensor(a)
        uk.masked_trailing_update(got, *ops, torch.tensor(mode))
        assert torch.equal(got, want)
    ref = np.asarray(jpk.masked_trailing_update(jnp.asarray(a), jnp.asarray(vr.numpy()),
                                                jnp.asarray(vc.numpy()), jnp.asarray(mode),
                                                interpret=True))
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_sweeps_pass_panels_the_kernel_reads_in_place(uplo, monkeypatch):
    """Both distributed sweeps hand the update kernel panel stacks it reads
    as they are: uplo 'L' contiguous ones, uplo 'U' its row panel as a
    transposed view (read through the kernel's transpose flag) beside a
    contiguous column panel. Nothing is copied per launch."""
    set_knobs(monkeypatch, {**FORCE, "panel_impl": "fused", "step_impl": "xla"})
    layouts = []
    fn = uk.masked_trailing_update

    def spy(a, vr, vc, mode):
        layouts.append((uk.panel_layout(vr), uk.panel_layout(vc)))
        return fn(a, vr, vc, mode)

    monkeypatch.setattr(uk, "masked_trailing_update", spy)
    port_factor(hpd(64, np.float32, seed=3), uplo, 8, 2, 2)
    assert layouts and set(layouts) == {(0, 0) if uplo == "L" else (1, 0)}


def test_update_route_gate(monkeypatch):
    assert uk.supports_update(torch.float32, "cuda")
    assert uk.supports_update(torch.bfloat16, "cuda")
    assert not uk.supports_update(torch.float64, "cuda")
    assert not uk.supports_update(torch.float32, "cpu")
    monkeypatch.setenv("DLAF_FORCE_PALLAS_UPDATE", "1")
    assert uk.supports_update(torch.float32, "cpu")
    assert not uk.supports_update(torch.complex64, "cpu")


# ---------------------------------------------------------------------------
# Kernel #7: the predicated Ozaki pair product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,C,mb,k", [(3, 2, 16, 16), (2, 3, 32, 32), (4, 1, 16, 32)])
def test_ozaki_masked_plain_matches_pallas_bitwise(R, C, mb, k):
    s = 8
    rng = np.random.default_rng(R * 10 + C + mb)
    afl = torch.tensor(rng.standard_normal((R * mb, k)))
    bfl = torch.tensor(rng.standard_normal((C * mb, k)))
    ia = torch.stack(oz._peel_slices(oz._normalize(afl, oz._scale(afl, -1)), s))
    ib = torch.stack(oz._peel_slices(oz._normalize(bfl, oz._scale(bfl, -1)), s))
    ia, ib = ia.reshape(s, R, mb, k), ib.reshape(s, C, mb, k)
    mode = rng.integers(0, 3, size=(R, C)).astype(np.int32)
    mode[0, 0] = 0
    mode[-1, -1] = 1
    rhi, rlo = jpo.masked_slice_product(jnp.asarray(ia.numpy()), jnp.asarray(ib.numpy()),
                                        jnp.asarray(mode), interpret=True)
    ok.reset_launches()
    hi, lo = ok.ozaki_masked_product(ia, ib, torch.tensor(mode))
    assert ok.LAUNCHES["ozaki_masked_product"] == 0
    np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
    dead = mode == 0
    assert not hi.numpy()[dead].any() and not lo.numpy()[dead].any()


# ---------------------------------------------------------------------------
# The builder against the JAX builder
# ---------------------------------------------------------------------------

FORCE = {"force_pallas_update": 1}
OZ7 = {"f64_gemm": "mxu", "f64_trsm": "mixed", "ozaki_impl": "pallas", "f64_gemm_min_dim": 16}
LA = {"cholesky_lookahead": 1, "comm_lookahead": 1}

# (name, dtype, n, nb, P, Q, src, knobs, uplo)
CASES = [
    ("einsum", np.float32, 72, 16, 2, 2, (0, 0), {}, "L"),
    ("einsum", np.float32, 72, 16, 2, 4, (1, 2), LA, "U"),
    ("update-kernel", np.float32, 72, 16, 2, 2, (0, 0), {**FORCE, **LA}, "L"),
    ("update-kernel", np.float32, 72, 16, 4, 2, (1, 0), FORCE, "U"),
    ("step-fused", np.float32, 72, 16, 2, 2, (1, 1), {**FORCE, **LA, "step_impl": "fused"}, "L"),
    ("panel-fused", np.float32, 72, 16, 2, 3, (0, 1), {**FORCE, "panel_impl": "fused"}, "U"),
    ("native", np.float64, 72, 16, 2, 4, (0, 3), LA, "L"),
    ("native", np.complex128, 56, 16, 2, 2, (1, 0), {}, "U"),
    ("oz-masked", np.float64, 72, 16, 2, 2, (0, 0), {**OZ7, **LA}, "L"),
    ("oz-masked", np.float64, 72, 16, 4, 2, (1, 1), OZ7, "U"),
    ("oz-rect", np.complex128, 56, 16, 2, 2, (0, 1), {**OZ7, **LA}, "L"),
]


@pytest.mark.parametrize("name,dtype,n,nb,P,Q,src,knobs,uplo", CASES,
                         ids=[f"{c[0]}-{np.dtype(c[1]).name}-{c[4]}x{c[5]}-{c[8]}"
                              for c in CASES])
def test_dist_matches_reference(name, dtype, n, nb, P, Q, src, knobs, uplo, monkeypatch,
                                devices8):
    set_knobs(monkeypatch, knobs)
    a = hpd(n, dtype, seed=n + P)
    j_upd = counting(monkeypatch, jchol, "masked_trailing_update")
    j_oz = counting(monkeypatch, jpo, "masked_slice_product")
    ref = jax_factor(a, uplo, nb, P, Q, src, devices8)
    p_upd = counting(monkeypatch, uk, "masked_trailing_update_plain")
    p_oz = counting(monkeypatch, ok, "ozaki_masked_product_plain")
    p_fs = counting(monkeypatch, pk, "factor_solve_plain")
    p_solve = counting(monkeypatch, pk, "panel_solve_plain")
    got, info = port_factor(a, uplo, nb, P, Q, src, with_info=True)
    assert info == 0
    # the route the case names, taken on both sides
    want_upd = name in ("update-kernel", "step-fused", "panel-fused")
    assert (j_upd[0] > 0) == (p_upd[0] > 0) == want_upd
    assert (j_oz[0] > 0) == (p_oz[0] > 0) == (name == "oz-masked")
    assert (p_fs[0] > 0) == (name == "step-fused")
    assert (p_solve[0] > 0) == (name == "panel-fused")
    eps = np.finfo(dtype).eps
    assert np.abs(got - ref).max() / np.abs(a).max() <= 60 * n * eps
    other = np.triu if uplo == "L" else np.tril
    kk = 1 if uplo == "L" else -1
    np.testing.assert_array_equal(other(got, kk), other(a, kk))


# ---------------------------------------------------------------------------
# More grids and sizes, against the port's local builder and numpy
# ---------------------------------------------------------------------------

GRID_CASES = [(1, 3, (0, 1)), (3, 1, (2, 0)), (3, 2, (1, 1)), (2, 3, (0, 2)), (1, 1, (0, 0))]
SIZES = [(16, 16), (17, 16), (50, 8)]


@pytest.mark.parametrize("n,nb", SIZES)
@pytest.mark.parametrize("P,Q,src", GRID_CASES, ids=[f"{p}x{q}" for p, q, _ in GRID_CASES])
@pytest.mark.parametrize("route", ["einsum", "update-kernel", "oz-masked"])
def test_dist_matches_local_and_numpy(route, P, Q, src, n, nb, monkeypatch):
    knobs, dtype = {"einsum": ({}, np.float64), "update-kernel": ({**FORCE, **LA}, np.float32),
                    "oz-masked": ({**OZ7, "f64_gemm_min_dim": 8}, np.float64)}[route]
    set_knobs(monkeypatch, knobs)
    a = hpd(n, dtype, seed=n + P * Q)
    for uplo in ("L", "U"):
        got = port_factor(a, uplo, nb, P, Q, src)
        local = cholesky(uplo, Matrix.from_global(a, TileElementSize(nb, nb),
                                                  device="cpu")).to_numpy()
        keep = np.tril if uplo == "L" else np.triu
        tol = 60 * n * np.finfo(dtype).eps * np.abs(a).max()
        assert np.abs(got - local).max() <= tol
        f = np.linalg.cholesky(a.astype(np.float64))
        assert np.abs(keep(got) - (f if uplo == "L" else f.T)).max() <= tol


# ---------------------------------------------------------------------------
# Knob contracts within the port, bit for bit
# ---------------------------------------------------------------------------

BITWISE = [
    ("einsum", np.float32, {}),
    ("update-kernel", np.float32, FORCE),
    ("step-fused", np.float32, {**FORCE, "step_impl": "fused"}),
    ("oz-masked", np.float64, OZ7),
    ("native", np.complex128, {}),
]


@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("name,dtype,knobs", BITWISE, ids=[c[0] for c in BITWISE])
def test_lookahead_comm_lookahead_and_info_bitwise(name, dtype, knobs, uplo, monkeypatch):
    a = hpd(72, dtype, seed=8)
    results = []
    for la, cla in ((0, 0), (1, 0), (1, 1)):
        set_knobs(monkeypatch, {**knobs, "cholesky_lookahead": la, "comm_lookahead": cla})
        results.append(port_factor(a, uplo, 16, 2, 3, (1, 0)))
    got, info = port_factor(a, uplo, 16, 2, 3, (1, 0), with_info=True)
    assert info == 0
    for r in results[1:] + [got]:
        np.testing.assert_array_equal(r, results[0])


@pytest.mark.parametrize("knobs,col", [({}, 32), ({**FORCE, "step_impl": "fused"}, 37)])
def test_info_matches_reference(knobs, col, monkeypatch, devices8):
    """A failing pivot: the reference's XLA:CPU factor fails a whole tile,
    so the composed route is compared on a tile boundary; the fused factor
    locates the column inside its tile in both packages."""
    set_knobs(monkeypatch, {**knobs, "cholesky_lookahead": 1})
    a = hpd(72, np.float32, seed=4)
    a[col, col] = -1000.0
    _, ref = jax_factor(a, "L", 16, 2, 2, (0, 1), devices8, with_info=True)
    _, info = port_factor(a, "L", 16, 2, 2, (0, 1), with_info=True)
    assert info == ref == col + 1


def test_launch_formulas_on_cpu(monkeypatch):
    """The counts ``chip_smoke.py`` asserts on the card, held here by the
    plain versions' calls: one update per rank per step k < nt-1, one
    factor+solve per rank per such step with step_impl=fused and a potrf
    per rank on the last; panel_impl=fused: a potrf per rank per step, a
    solve per rank per step k < nt-1. (Uniform slots: on these grids every
    rank keeps a trailing slot until the last step.)"""
    n, nb, P, Q = 64, 8, 2, 2
    nt = n // nb
    a = hpd(n, np.float32, seed=3)
    # the cuda defaults: fused step and panel kernels, both look-aheads
    set_knobs(monkeypatch, {**FORCE, **LA, "step_impl": "fused", "panel_impl": "fused"})
    calls = {name: counting(monkeypatch, mod, name) for mod, name in (
        (uk, "masked_trailing_update_plain"), (pk, "factor_solve_plain"), (pk, "potrf_plain"))}
    # a left-side solve runs as the right-side one transposed: count that
    calls["panel_solve_plain"] = counting(monkeypatch, pk, "panel_solve_plain",
                                          when=lambda side, *_: side == "R")
    port_factor(a, "L", nb, P, Q)
    assert calls["masked_trailing_update_plain"][0] == P * Q * (nt - 1)
    assert calls["factor_solve_plain"][0] == P * Q * (nt - 1)
    assert calls["potrf_plain"][0] == P * Q
    for c in calls.values():
        c[0] = 0
    set_knobs(monkeypatch, {**FORCE, "panel_impl": "fused", "step_impl": "xla"})
    port_factor(a, "U", nb, 2, 4)
    assert calls["masked_trailing_update_plain"][0] == 8 * (nt - 1)
    assert calls["potrf_plain"][0] == 8 * nt
    assert calls["panel_solve_plain"][0] == 8 * (nt - 1)


def test_oz_route_counts_on_cpu(monkeypatch):
    """f64 with f64_gemm=mxu, f64_trsm=mixed, the Ozaki kernels and
    lookahead: the pair product once per rank per step k < nt-1; the slice
    product for the panel on every rank and for the look-ahead column on
    the ranks that own it."""
    n, nb, P, Q = 64, 16, 2, 2
    nt = n // nb
    set_knobs(monkeypatch, {**OZ7, **LA})
    masked = counting(monkeypatch, ok, "ozaki_masked_product_plain")
    prod = counting(monkeypatch, ok, "ozaki_product_plain")
    port_factor(hpd(n, np.float64, seed=6), "L", nb, P, Q)
    assert masked[0] == P * Q * (nt - 1)
    assert prod[0] == P * Q * (nt - 1) + P * (nt - 1)


def test_wrappers_launch_nothing_on_cpu(monkeypatch):
    uk.reset_launches()
    ok.reset_launches()
    set_knobs(monkeypatch, {**FORCE, **OZ7})
    port_factor(hpd(40, np.float32), "L", 8, 2, 2)
    port_factor(hpd(40, np.float64), "U", 16, 2, 2)
    assert set(uk.LAUNCHES.values()) == {0} and set(ok.LAUNCHES.values()) == {0}


def test_donate_and_scan_on_grid(monkeypatch, devices8):
    """donate=True releases the shards (same factor); trailing "scan" on a
    grid runs the distributed scan builder, held against the reference's
    ``_build_dist_cholesky_scan`` at 60 n eps, and leaves the input
    unchanged without donate."""
    a = hpd(40, np.float64)
    grid = shared_grid(2, 2, "cpu")
    keep = cholesky("L", Matrix.from_global(a, TileElementSize(8, 8), grid))
    mat = Matrix.from_global(a, TileElementSize(8, 8), grid)
    out = cholesky("L", mat, donate=True)
    assert mat.storage is None
    assert all(torch.equal(x, y) for x, y in zip(out.shards(), keep.shards()))
    set_knobs(monkeypatch, {"cholesky_trailing": "scan"})
    j_scan = counting(monkeypatch, jchol, "_build_dist_cholesky_scan")
    ref = jax_factor(a, "L", 8, 2, 2, (0, 0), devices8)
    mat = Matrix.from_global(a, TileElementSize(8, 8), grid)
    before = [s.clone() for s in mat.shards()]
    got = cholesky("L", mat).to_numpy()
    assert j_scan[0] == 1
    assert all(torch.equal(x, y) for x, y in zip(mat.shards(), before))
    assert np.abs(got - ref).max() / np.abs(a).max() <= 60 * 40 * np.finfo(np.float64).eps


# ---------------------------------------------------------------------------
# The miniapp on a CPU grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("letter,uplo,extra", [
    ("s", "L", ["--dlaf:step-impl=fused", "--dlaf:cholesky-lookahead=1"]),
    ("d", "U", ["--dlaf:f64-gemm=mxu", "--dlaf:f64-trsm=mixed", "--dlaf:ozaki-impl=pallas",
                "--dlaf:f64-gemm-min-dim=16"]),
])
def test_miniapp_on_cpu_grid(letter, uplo, extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = miniapp_cholesky.run(["-m", "72", "-b", "16", "--type", letter, "--uplo", uplo,
                                    "--backend", "cpu", "--grid-rows", "2", "--grid-cols", "2",
                                    "--share-device", "--nruns", "1", "--check-result", "last",
                                    *extra])
    lines = buf.getvalue().splitlines()
    assert len(res) == 1
    assert f" {letter}{uplo} (72, 72) (16, 16) (2, 2) " in lines[0]
    assert lines[-1].startswith("check: PASSED residual=")


def test_miniapp_grid_needs_share_device():
    with pytest.raises(SystemExit, match="--share-device"):
        miniapp_cholesky.run(["-m", "32", "-b", "8", "--type", "s", "--backend", "cpu",
                              "--grid-rows", "2", "--grid-cols", "2"])
