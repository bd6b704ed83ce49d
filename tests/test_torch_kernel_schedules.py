"""The schedules of two hand-written kernels of the PyTorch port, held on the
CPU where the kernels themselves cannot run.

The Givens undo (``csrc/givens.cu``) loads the rows of the rotations ahead
of the one it applies, following a schedule the host computes
(``givens_kernels.dependencies`` and ``schedule``). Here: the dependency
array against an O(g^2) brute force on seeded lists with anchor chains,
returning rows and repeated pairs; the schedule's flags against their
definition; and a numpy model of the kernel's loop (loads ahead into a
ring of ``DEPTH`` slots, registers for the previous rotation's rows,
deferred stores), which must give bitwise the sequential loop
(``givens_undo_plain``) on every list, and through the port's D&C
(``tridiag_solver`` with the model in place of the plain loop) the same
eigenpairs as the reference (``dlaf_tpu/eigensolver/tridiag_solver.py``).
A schedule made for another depth must not pass.

The strip product (``csrc/panel.cu`` ``strip_kernel``) runs, for each
32-column group, only the 32-wide K chunks that the triangular inverse
reaches, and adds ``sum_k b(r, k) * 0`` over the skipped ones. A numpy
model of that rule against the dense product the plain version computes,
with inf and NaN planted in ``b`` at skipped and at computed k and NaN
pivots in the triangle, on the cases of
``test_solved_strip_nan_columns_match_reference``: equal NaN and inf
masks, and values within the f32 rounding of a different order.
"""

import importlib

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from dlaf_tpu_torch.tile_ops import givens_kernels as gk
from dlaf_tpu_torch.tile_ops import panel_kernels as pk

jt = importlib.import_module("dlaf_tpu.eigensolver.tridiag_solver")
pt = importlib.import_module("dlaf_tpu_torch.eigensolver.tridiag_solver")

# ---------------------------------------------------------------------------
# The Givens undo
# ---------------------------------------------------------------------------


def rotation_list(kind: str, g: int, n: int, seed: int) -> np.ndarray:
    """A seeded ``(g, 4)`` list ``(i, j, c, s)`` on ``n`` rows."""
    rng = np.random.default_rng(seed)
    if kind == "fresh":          # disjoint pairs, the Toeplitz merge's structure
        perm = rng.permutation(n)  # (each pair comes back after n / 2 rotations)
        rows = perm[np.arange(2 * g) % n].reshape(g, 2)
    elif kind == "anchor":       # chains of rotations through one anchor row
        rows = np.empty((g, 2), dtype=np.int64)
        perm = rng.permutation(n)
        anchor, nxt = perm[0], 1
        for t in range(g):
            if rng.random() < 0.1:
                anchor = perm[nxt % n]
                nxt += 1
            j = perm[nxt % n]
            nxt += 1
            if j == anchor:
                j = perm[nxt % n]
                nxt += 1
            rows[t] = anchor, j
    elif kind == "moving":       # the anchor moves to the row just written
        rows = np.empty((g, 2), dtype=np.int64)
        perm = rng.permutation(n)
        for t in range(g):
            rows[t] = perm[t % n], perm[(t + 1) % n]
    elif kind == "repeat":       # the same pairs again and again
        pairs = rng.permutation(n)[:6].reshape(3, 2)
        rows = pairs[rng.integers(0, 3, g)]
    elif kind == "mixed":        # few rows: dependencies at every distance
        rows = np.stack([rng.choice(min(n, 24), 2, replace=False) for _ in range(g)])
    else:
        raise ValueError(kind)
    th = rng.uniform(0, 2 * np.pi, g)
    return np.column_stack([rows[:, 0], rows[:, 1], np.cos(th), np.sin(th)])


KINDS = ["fresh", "anchor", "moving", "repeat", "mixed"]


def brute_dependencies(ij) -> np.ndarray:
    ij = np.asarray(ij, dtype=np.int64)
    dep = np.full(ij.shape, -1)
    for t in range(ij.shape[0]):
        for r in range(2):
            for p in range(t):
                if ij[t, r] in ij[p]:
                    dep[t, r] = p
    return dep


def kernel_model(u: np.ndarray, giv, depth: int = gk.DEPTH, sched_depth=None) -> np.ndarray:
    """The loop of ``givens_undo_kernel`` in numpy on all columns at once:
    rotation t's ``PREFETCH`` rows are loaded into slot ``t % depth``
    before rotation 0 (t < depth) or right after rotation t - depth is
    stored; ``FROM_I``/``FROM_J`` take the previous rotation's new rows;
    ``RELOAD`` reads memory when the rotation is applied; a new row is
    stored only with its flag."""
    rec = gk.schedule(giv, depth if sched_depth is None else sched_depth)
    rot, cs = rec[:, :4], rec.view(np.float64)[:, 2:]
    mem = u.copy()
    g = rot.shape[0]
    ahead_i, ahead_j = [None] * depth, [None] * depth
    a = b = None

    def load_ahead(t):
        i, j, f = rot[t, :3]
        if f & 3 == gk.PREFETCH:
            ahead_i[t % depth] = mem[i].copy()
        if f >> 2 & 3 == gk.PREFETCH:
            ahead_j[t % depth] = mem[j].copy()

    def source(f, ahead, row):
        return {gk.PREFETCH: ahead, gk.FROM_I: a, gk.FROM_J: b}.get(f, row)

    for t in range(min(depth, g)):
        load_ahead(t)
    for t in range(g):
        i, j, f = rot[t, :3]
        c, s = cs[t]
        ri = source(f & 3, ahead_i[t % depth], mem[i].copy())
        rj = source(f >> 2 & 3, ahead_j[t % depth], mem[j].copy())
        a, b = c * ri - s * rj, s * ri + c * rj
        if f & gk.STORE_I:
            mem[i] = a
        if f & gk.STORE_J:
            mem[j] = b
        if t + depth < g:
            load_ahead(t + depth)
    return mem


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_dependencies_match_brute_force(kind, seed):
    giv = rotation_list(kind, 150, 64, seed)
    np.testing.assert_array_equal(gk.dependencies(giv[:, :2]), brute_dependencies(giv[:, :2]))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("depth", [1, 4, gk.DEPTH])
def test_schedule_flags_follow_their_definition(kind, depth):
    giv = rotation_list(kind, 120, 48, 3)
    rec = gk.schedule(giv, depth)
    rot, cs = rec[:, :4], rec.view(np.float64)[:, 2:]
    ij = giv[:, :2].astype(np.int64)
    dep = brute_dependencies(ij)
    np.testing.assert_array_equal(rot[:, :2], ij)
    np.testing.assert_array_equal(cs, giv[:, 2:])
    for t in range(len(ij)):
        f = rot[t, 2]
        for r, (shift, store) in enumerate(((0, gk.STORE_I), (2, gk.STORE_J))):
            p = dep[t, r]
            if p >= 0 and p == t - 1:
                want = gk.FROM_I if ij[t, r] == ij[t - 1, 0] else gk.FROM_J
            elif p < 0 or p <= t - depth:
                want = gk.PREFETCH
            else:
                want = gk.RELOAD
            assert f >> shift & 3 == want, (t, r)
            kept = t + 1 < len(ij) and ij[t, r] in ij[t + 1]
            assert bool(f & store) == (not kept), (t, r)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("g", [1, 15, 16, 17, 255, 300])
def test_kernel_model_bitwise_plain_loop(kind, g):
    """The kernel's schedule applied in the kernel's order is bitwise the
    sequential loop, at g below, at and past the depth and the staging
    chunk (256), and on w = 13 columns (not a multiple of a block)."""
    n = 64
    giv = rotation_list(kind, g, n, g)
    u = np.random.default_rng(g).standard_normal((n, 13))
    want = gk.givens_undo_plain(torch.as_tensor(u.copy()), giv).numpy()
    np.testing.assert_array_equal(kernel_model(u, giv), want)
    np.testing.assert_array_equal(kernel_model(u, giv, depth=3), want)


def test_wrong_depth_schedule_is_caught():
    """A schedule made for a shallower ring than the one that runs it
    reads rows before their writers stored them: the model must then
    differ from the loop, so the bitwise tests above can fail."""
    giv = rotation_list("mixed", 200, 64, 5)
    u = np.random.default_rng(5).standard_normal((64, 7))
    want = gk.givens_undo_plain(torch.as_tensor(u.copy()), giv).numpy()
    assert not np.array_equal(kernel_model(u, giv, depth=8, sched_depth=2), want)


def test_schedule_refuses_a_row_with_itself():
    with pytest.raises(ValueError, match="itself"):
        gk.schedule(np.array([[3, 3, 1.0, 0.0]]))


def tridiagonal(kind: str, n: int):
    """Cases of ``test_torch_tridiag_solver`` that deflate by rotations: a
    constant diagonal (a Toeplitz T), clustered."""
    rng = np.random.default_rng(n)
    if kind == "constant":
        return np.full(n, 2.0), np.full(n - 1, 1.0)
    return np.ones(n) + 1e-14 * rng.standard_normal(n), 1e-13 * np.abs(rng.standard_normal(n - 1))


@pytest.mark.parametrize("kind,n,nb", [("constant", 200, 16), ("constant", 513, 32),
                                       ("constant", 96, 8), ("clustered", 64, 16)])
def test_tridiag_solver_through_the_kernel_schedule(kind, n, nb, monkeypatch):
    """The port's D&C on the CPU with every merge's Givens undo applied by
    the kernel's schedule (the model) instead of the plain loop: bitwise
    the plain run, and against the reference as
    ``test_torch_tridiag_solver.test_matches_reference`` holds it. The
    constant diagonal (a Toeplitz T) deflates disjoint pairs by
    rotations at every merge."""
    d, e = tridiagonal(kind, n)
    lam0, q0 = pt.tridiag_solver(d, e, nb, device="cpu")
    used = []

    def by_schedule(u, giv):
        used.append(len(giv))
        u.copy_(torch.as_tensor(kernel_model(u.numpy(), np.asarray(giv))))
        return u

    monkeypatch.setattr(gk, "givens_undo", by_schedule)
    lam, q = pt.tridiag_solver(d, e, nb, device="cpu")
    assert used and sum(used) > 0
    np.testing.assert_array_equal(lam, lam0)
    np.testing.assert_array_equal(q.numpy(), q0.numpy())
    q = q.numpy()
    scale = max(np.abs(d).max(), np.abs(e).max(), 1.0)
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    np.testing.assert_allclose(lam, sla.eigvalsh_tridiagonal(d, e), atol=5e-13 * scale * n,
                               rtol=1e-12)
    assert np.linalg.norm(t @ q - q * lam[None, :]) < 5e-12 * scale * n
    assert np.linalg.norm(q.T @ q - np.eye(n)) < 5e-12 * n
    jlam, _ = jt.tridiag_solver(d, e, nb, use_device=False)
    np.testing.assert_allclose(lam, jlam, rtol=0, atol=1e-13 * max(np.abs(jlam).max(), 1.0))


# ---------------------------------------------------------------------------
# The strip product's skip rule
# ---------------------------------------------------------------------------

#: ``PW`` in ``csrc/panel.cu``: the strip product's column group and K chunk.
GROUP = 32


def strip_model(b: np.ndarray, inv: np.ndarray, trans: int) -> np.ndarray:
    """``b @ op(inv)`` as ``strip_kernel`` computes it: for each column
    group g, the K chunks [0, g] (trans, ``op = inv^T``) or [g, end)
    (``op = inv``) only, plus ``sum_k b(r, k) * 0`` over the others."""
    m, k = b.shape
    bop = inv.T if trans else inv          # bop[k, c]
    nk = -(-k // GROUP)
    out = np.empty((m, bop.shape[1]), dtype=np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for g in range(-(-bop.shape[1] // GROUP)):
            cols = slice(GROUP * g, GROUP * (g + 1))
            lo, hi = (0, min(g + 1, nk)) if trans else (min(g, nk), nk)
            run = slice(GROUP * lo, GROUP * hi)
            skipped = b[:, GROUP * hi:] if trans else b[:, :GROUP * lo]
            z = (skipped * np.float32(0)).sum(axis=1, dtype=np.float32)
            out[:, cols] = b[:, run] @ bop[run, cols] + z[:, None]
    return out


def factor_and_inverse(d: int, pivot):
    """An HPD tile's f32 factor, with a NaN pivot at ``pivot`` (1-based)
    unless None, and the inverse the strip multiplies by (the plain
    version's ``_tri_inv_lower``, zero above its 8 x 8 diagonal blocks)."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((d, d))
    fac = np.linalg.cholesky(x @ x.T + d * np.eye(d)).astype(np.float32)
    if pivot is not None:
        fac[pivot - 1, pivot - 1] = np.nan
    return fac, pk._tri_inv_lower(torch.tensor(fac)).numpy()


@pytest.mark.parametrize("trans", [1, 0])
@pytest.mark.parametrize("d,pivot", [(d, p) for d in (256, 200, 129, 9)
                                     for p in (None, 1, 9, 38, "last") if p != 38 or d > 38])
def test_strip_skip_rule_matches_dense_product(d, pivot, trans):
    fac, inv = factor_and_inverse(d, d if pivot == "last" else pivot)
    # structure the skip relies on: zero above the 8 x 8 diagonal blocks
    r, c = np.indices((d, d))
    assert not inv[c > (r | 7)].any()
    rng = np.random.default_rng(d + 1)
    b = rng.standard_normal((40, d)).astype(np.float32)
    # non-finite entries at skipped and computed k of both orientations
    for row, k, v in ((0, d - 1, np.inf), (1, 0, np.nan), (2, d // 2, -np.inf),
                      (3, min(33, d - 1), np.nan), (4, 7, np.inf), (4, d - 2, np.nan)):
        b[row, k] = v
    with np.errstate(invalid="ignore", over="ignore"):
        dense = b @ (inv.T if trans else inv)
    got = strip_model(b, inv, trans)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(dense))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(dense))
    fin = np.isfinite(dense)
    if fin.any():
        scale = np.abs(dense[fin]).max()
        assert np.abs(got[fin] - dense[fin]).max() <= 8 * d * 2.0 ** -23 * scale
    # the plain version (what a CPU tensor takes, and what the kernel is
    # held to on the card) is this dense product
    plain = pk.panel_solve_plain("R", "L", "C" if trans else "N", "N", torch.tensor(fac),
                                 torch.tensor(b)).numpy()
    np.testing.assert_array_equal(np.isnan(plain), np.isnan(dense))
    np.testing.assert_array_equal(np.isinf(plain), np.isinf(dense))
