"""The port's batched entry points and program service
(``dlaf_tpu_torch/algorithms/batched.py``, ``serve/programs.py``) against
the JAX reference's (``dlaf_tpu/algorithms/batched.py``,
``serve/programs.py``).

The same numpy-seeded batches go through both packages (the port on CPU
tensors): Cholesky factors and triangular solves agree at ``60 n eps``
relative, eigenvalues at ``100 n eps`` and each package's eigenpair
residual and orthogonality stay below ``200 n eps`` (eigenvector signs
are free). Within the port, the lane-parity contract holds bitwise: lane
i of a B-lane dispatch equals the B=1 dispatch and the unbatched lane
program, pad lanes are inert, and the call form the card uses (at least
16 lanes per library call, the solve in calls of exactly 16) gives the
same lanes at every B (exercised here with 4 lanes on the CPU). Shape padding stays within ``64 eps`` of the exact-size program
(the reference's ``test_serve.py`` budget). The program service's
hit/miss/warmup/eviction counts follow the reference's for the same
call sequence.
"""

import numpy as np
import pytest
import torch

from dlaf_tpu import config as jcfg
from dlaf_tpu.serve import ProgramService as JProgramService
from dlaf_tpu.serve import cholesky_batched as j_cholesky_batched
from dlaf_tpu.serve import cholesky_spec as j_cholesky_spec
from dlaf_tpu.serve import eigh_batched as j_eigh_batched
from dlaf_tpu.serve import eigh_spec as j_eigh_spec
from dlaf_tpu.serve import solve_batched as j_solve_batched
from dlaf_tpu.serve import solve_spec as j_solve_spec
from dlaf_tpu_torch import config
from dlaf_tpu_torch.algorithms import batched as bt
from dlaf_tpu_torch.serve import (ProgramService, cholesky_batched, cholesky_spec, eigh_batched,
                                  eigh_spec, program_builder, solve_batched, solve_spec)

DTYPES = {"s": np.float32, "d": np.float64, "z": np.complex128}


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    for knob in ("SERVE_CACHE_BYTES", "SERVE_BATCH", "SERVE_BUCKETS"):
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    jcfg.initialize()


def svc(**kw):
    return ProgramService(device="cpu", **kw)


def eps(dtype):
    return np.finfo(np.dtype(dtype).type(0).real.dtype).eps


def rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def hpd(n, seed=0, dtype=np.float64, shift=None):
    x = rand((n, n), dtype, seed)
    return (x @ x.conj().T + (n if shift is None else shift) * np.eye(n)).astype(dtype)


def hpd_batch(b, n, dtype=np.float64, seed=0):
    return np.stack([hpd(n, seed=seed + i, dtype=dtype) for i in range(b)])


def tri_batch(b, n, uplo, dtype=np.float64, seed=0):
    x = rand((b, n, n), dtype, seed)
    t = np.tril(x) if uplo == "L" else np.triu(x)
    return (t + 3 * np.eye(n)).astype(dtype)


def herm_batch(b, n, dtype, seed):
    x = rand((b, n, n), dtype, seed)
    return ((x + np.conj(np.swapaxes(x, -1, -2))) / 2).astype(dtype)


def rel(x, y):
    return np.linalg.norm(np.asarray(x) - np.asarray(y)) / np.linalg.norm(np.asarray(y))


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_cholesky_batched_vs_reference(dt, uplo):
    n, b = 24, 4
    a = hpd_batch(b, n, DTYPES[dt])
    out, info = cholesky_batched(uplo, a, with_info=True, service=svc())
    jout, jinfo = j_cholesky_batched(uplo, a, with_info=True, service=JProgramService())
    assert info.tolist() == np.asarray(jinfo).tolist() == [0] * b
    for i in range(b):
        assert rel(out[i].numpy(), jout[i]) <= 60 * n * eps(a.dtype)
        # the other triangle passes through exactly
        other = np.triu if uplo == "L" else np.tril
        k = 1 if uplo == "L" else -1
        np.testing.assert_array_equal(other(out[i].numpy(), k), other(a[i], k))


@pytest.mark.parametrize("side,uplo,op,diag", [("L", "L", "N", "N"), ("L", "U", "T", "N"),
                                               ("R", "U", "N", "U"), ("R", "L", "C", "N")])
@pytest.mark.parametrize("dt", ["d", "z"])
def test_solve_batched_vs_reference(side, uplo, op, diag, dt):
    n, nrhs, b = 20, 5, 3
    a = tri_batch(b, n, uplo, DTYPES[dt])
    rhs = rand((b, n, nrhs) if side == "L" else (b, nrhs, n), DTYPES[dt], 7)
    alpha = np.array([1.0, -2.0, 0.5])
    x, info = solve_batched(side, uplo, op, diag, alpha, a, rhs, with_info=True, service=svc())
    jx, jinfo = j_solve_batched(side, uplo, op, diag, alpha, a, rhs, with_info=True,
                                service=JProgramService())
    assert info.tolist() == np.asarray(jinfo).tolist() == [0] * b
    for i in range(b):
        assert rel(x[i].numpy(), jx[i]) <= 60 * n * eps(a.dtype)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_eigh_batched_vs_reference(dt, uplo):
    n, b = 16, 3
    h = herm_batch(b, n, DTYPES[dt], 3)
    # poison the triangle the op must not read
    keep = np.tril(np.ones((n, n), bool)) if uplo == "L" else np.triu(np.ones((n, n), bool))
    stored = np.where(keep, h, 1e30).astype(h.dtype)
    w, v, info = eigh_batched(uplo, stored, with_info=True, service=svc())
    jw, _, jinfo = j_eigh_batched(uplo, stored, with_info=True, service=JProgramService())
    assert info.tolist() == np.asarray(jinfo).tolist() == [0] * b
    e = eps(h.dtype)
    for i in range(b):
        norm = np.linalg.norm(h[i])
        assert np.abs(w[i].numpy() - np.asarray(jw[i])).max() <= 100 * n * e * norm
        vi = v[i].numpy()
        assert np.linalg.norm(h[i] @ vi - vi * w[i].numpy()[None, :]) <= 200 * n * e * norm
        assert np.linalg.norm(vi.conj().T @ vi - np.eye(n)) <= 200 * n * e


def test_info_flags_failing_lanes_like_reference():
    """A failing lane is flagged by both packages (the port reports the
    exact failing column, the reference's XLA:CPU NaNs the whole lane);
    clean lanes report 0 and keep their bits."""
    n = 12
    good = hpd_batch(3, n)
    mixed = good.copy()
    mixed[1] = hpd(n, seed=9, shift=-100.0)
    s = svc()
    out_good, _ = cholesky_batched("L", good, with_info=True, service=s)
    out, info = cholesky_batched("L", mixed, with_info=True, service=s)
    _, jinfo = j_cholesky_batched("L", mixed, with_info=True, service=JProgramService())
    info, jinfo = info.numpy(), np.asarray(jinfo)
    assert info[0] == info[2] == jinfo[0] == jinfo[2] == 0
    assert info[1] >= 1 and jinfo[1] >= 1
    col = info[1] - 1
    d = np.diagonal(out[1].numpy())
    assert np.isfinite(d[:col]).all() and np.isnan(d[col:]).all()
    for i in (0, 2):
        assert torch.equal(out[i], out_good[i])


def test_solve_info_flags_singular_diagonal():
    a = tri_batch(3, 10, "L")
    a[2, 4, 4] = 0.0
    rhs = rand((3, 10, 2), np.float64, 1)
    _, info = solve_batched("L", "L", "N", "N", 1.0, a, rhs, with_info=True, service=svc())
    _, jinfo = j_solve_batched("L", "L", "N", "N", 1.0, a, rhs, with_info=True,
                               service=JProgramService())
    assert info.tolist() == np.asarray(jinfo).tolist() == [0, 0, 5]
    _, info_u = solve_batched("L", "L", "N", "U", 1.0, a, rhs, with_info=True, service=svc())
    assert info_u.tolist() == [0, 0, 0]


# ---------------------------------------------------------------------------
# The lane-parity contract within the port
# ---------------------------------------------------------------------------

def _run(op, x, s, *, uplo="L", rhs=None):
    if op == "cholesky":
        return cholesky_batched(uplo, x, with_info=True, service=s)
    if op == "solve":
        return solve_batched("L", uplo, "N", "N", 1.0, x, rhs, with_info=True, service=s)
    return eigh_batched(uplo, x, with_info=True, service=s)


def _inputs(op, b, n, dtype):
    if op == "cholesky":
        return hpd_batch(b, n, dtype), None
    if op == "solve":
        return tri_batch(b, n, "L", dtype), rand((b, n, 3), dtype, 5)
    return herm_batch(b, n, dtype, 4), None


def _lane(out, i):
    return tuple(o[i] for o in out)


@pytest.mark.parametrize("op", ["cholesky", "solve", "eigh"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("chunk", [None, 4], ids=["lanes", "chunk4"])
def test_lane_parity_bitwise(op, dt, chunk, monkeypatch):
    """Lane i of a B-lane dispatch == the B=1 dispatch == the lane
    program on the unbatched lane, bitwise, at B = 1, 3, 4 and 9; with at
    least 4 lanes per library call (the card's call form at a CPU size:
    B < 4 padded, the solve cut into 4-lane calls) too."""
    monkeypatch.setitem(bt.MIN_LANES, "cpu", chunk)
    n = 12
    a, rhs = _inputs(op, 9, n, DTYPES[dt])
    s = svc()
    ones = [_run(op, a[i:i + 1], s, rhs=None if rhs is None else rhs[i:i + 1])
            for i in range(9)]
    for b in (3, 4, 9):
        out = _run(op, a[:b], s, rhs=None if rhs is None else rhs[:b])
        for i in range(b):
            for x, y in zip(_lane(out, i), _lane(ones[i], 0)):
                assert torch.equal(x, y), (op, b, i)
    monkeypatch.setitem(bt.MIN_LANES, "cpu", None)
    plain = _run(op, a, svc(), rhs=rhs)
    for i in range(9):
        for x, y in zip(_lane(plain, i), _lane(ones[i], 0)):
            assert torch.equal(x, y)


def test_pad_lanes_inert_and_identity():
    n, b = 16, 4
    full = hpd_batch(b, n)
    padded = full.copy()
    padded[2:] = np.eye(n)
    s = svc()
    out_full, _ = cholesky_batched("L", full, with_info=True, service=s)
    out_pad, info_pad = cholesky_batched("L", padded, with_info=True, service=s)
    assert torch.equal(out_full[:2], out_pad[:2]) and info_pad.tolist() == [0] * b
    eye1, _ = cholesky_batched("L", np.eye(n)[None], with_info=True, service=s)
    for i in (2, 3):
        assert torch.equal(out_pad[i], eye1[0])
        assert torch.equal(out_pad[i], torch.eye(n, dtype=torch.float64))


def test_shape_padding_budgeted():
    """The queue's identity-border shape padding: the pad region is
    exactly inert, the real block within 64 eps of the exact-size
    program (the reference's budget)."""
    s = svc()
    n_req, bn = 13, 16
    a = hpd(n_req, seed=3)
    ap = np.eye(bn)
    ap[:n_req, :n_req] = a
    out_p, info_p = cholesky_batched("L", ap[None], with_info=True, service=s)
    out_s, _ = cholesky_batched("L", a[None], with_info=True, service=s)
    out_p, out_s = out_p[0].numpy(), out_s[0].numpy()
    assert int(info_p[0]) == 0
    np.testing.assert_array_equal(np.tril(out_p)[n_req:, n_req:], np.eye(bn - n_req))
    assert np.abs(np.tril(out_p)[n_req:, :n_req]).max() == 0.0
    np.testing.assert_allclose(out_p[:n_req, :n_req], out_s, rtol=0,
                               atol=64 * np.finfo(np.float64).eps * np.abs(out_s).max())


@pytest.mark.parametrize("op", ["cholesky", "solve", "eigh"])
def test_donation(op):
    """donate=False leaves the caller's tensor bitwise unchanged;
    donate=True writes the result into the donated storage, bitwise the
    undonated result."""
    a, rhs = _inputs(op, 3, 10, np.float64)
    a_t, rhs_t = torch.from_numpy(a.copy()), None if rhs is None else torch.from_numpy(rhs.copy())
    s = svc()
    if op == "cholesky":
        keep = cholesky_batched("L", a_t, service=s)
        assert torch.equal(a_t, torch.from_numpy(a))
        got = cholesky_batched("L", a_t, donate=True, service=s)
        assert got.data_ptr() == a_t.data_ptr() and torch.equal(got, keep)
    elif op == "solve":
        keep = solve_batched("L", "L", "N", "N", 2.0, a_t, rhs_t, service=s)
        assert torch.equal(rhs_t, torch.from_numpy(rhs)) and torch.equal(a_t, torch.from_numpy(a))
        got = solve_batched("L", "L", "N", "N", 2.0, a_t, rhs_t, donate_b=True, service=s)
        assert got.data_ptr() == rhs_t.data_ptr() and torch.equal(got, keep)
    else:
        kw, kv = eigh_batched("L", a_t, service=s)
        assert torch.equal(a_t, torch.from_numpy(a))
        w, v = eigh_batched("L", a_t, donate=True, service=s)
        assert v.data_ptr() == a_t.data_ptr() and torch.equal(v, kv) and torch.equal(w, kw)


def test_check_batch_rejects():
    with pytest.raises(AssertionError):
        cholesky_batched("L", hpd(8), service=svc(), device="cpu")
    with pytest.raises(AssertionError):
        cholesky_batched("L", np.ones((2, 3, 4)), service=svc(), device="cpu")
    with pytest.raises(AssertionError):
        solve_batched("L", "L", "N", "N", 1.0, tri_batch(2, 8, "L"), np.ones((2, 7, 1)),
                      service=svc())
    with pytest.raises(AssertionError):
        cholesky_batched("X", hpd_batch(2, 8), service=svc())
    assert bt.default_nb(5) == 5 and bt.default_nb(1000) == 256


# ---------------------------------------------------------------------------
# Program service: the reference's counts for the same call sequence
# ---------------------------------------------------------------------------

def _specs(mod):
    chol, solve, eigh = ((cholesky_spec, solve_spec, eigh_spec) if mod == "port"
                         else (j_cholesky_spec, j_solve_spec, j_eigh_spec))
    return [chol(batch=2, n=8, nb=8, dtype="float64"),
            chol(batch=2, n=8, nb=8, dtype="float64", uplo="U"),
            chol(batch=2, n=8, nb=8, dtype="float64", with_info=False),
            solve(batch=2, n=8, nrhs=3, nb=8, dtype="float64"),
            eigh(batch=2, n=8, nb=8, dtype="float64")]


COUNTS = ("hits", "misses", "warmups", "evictions", "compiles", "entries")


def _drive(s, specs, args):
    """One scripted sequence of service calls; the stats after each."""
    seen = []
    s.run(specs[0], *args[0])
    s.run(specs[0], *args[0])
    seen.append(s.stats())
    s.warmup(specs[1], specs[3])
    s.warmup(specs[1])
    s.run(specs[3], *args[3])
    seen.append(s.stats())
    assert s.evict(specs[1]) and not s.evict(specs[1])
    seen.append(s.stats())
    s.warmup(specs[2], specs[4])
    seen.append(s.stats())
    assert s.evict(specs[0])
    s.run(specs[0], *args[0])
    seen.append(s.stats())
    return seen, set(sp.site for sp in s.specs())


def test_service_counts_follow_reference():
    a = hpd_batch(2, 8)
    rhs = rand((2, 8, 3), np.float64, 1)
    p_args = {0: (torch.from_numpy(a),), 3: (torch.from_numpy(a), torch.from_numpy(rhs),
                                             torch.ones(2, dtype=torch.float64))}
    j_args = {0: (a,), 3: (a, rhs, np.ones(2))}
    p_seen, p_sites = _drive(svc(), _specs("port"), p_args)
    j_seen, j_sites = _drive(JProgramService(), _specs("ref"), j_args)
    for p, j in zip(p_seen, j_seen):
        assert {k: p[k] for k in COUNTS} == {k: j[k] for k in COUNTS}
        assert p["hit_rate"] == j["hit_rate"]
    assert p_sites == j_sites


def test_service_evicted_bucket_recompiles_and_still_answers():
    """An evicted bucket program is compiled again on its next request
    (a miss, one more compile) and answers bitwise as before; warmup of a
    warm spec costs nothing."""
    s = svc()
    s1 = _specs("port")[0]
    walls = s.warmup(s1)
    assert walls[s1] > 0 and s.warmup(s1)[s1] == 0.0
    a = torch.from_numpy(hpd_batch(2, 8))
    first = s.run(s1, a.clone())
    assert s.evict(s1) and s1 not in s.specs()
    again = s.run(s1, a.clone())
    st = s.stats()
    assert (st["hits"], st["misses"], st["warmups"], st["evictions"], st["compiles"]) == (1, 1, 1, 1, 2)
    for x, y in zip(first, again):
        assert torch.equal(x, y)


def test_spec_sites_match_reference():
    for p, j in zip(_specs("port"), _specs("ref")):
        assert p.site == j.site


def test_program_builder_shapes():
    for spec in _specs("port"):
        fn, args, donate = program_builder(spec)
        assert args[0][0] == (spec.batch, spec.n, spec.n)
        assert args[0][1] == torch.float64 and donate == ()
        if spec.op == "solve":
            assert args[1][0] == (2, 8, 3) and args[2][0] == (2,)


@pytest.mark.parametrize("op", ["cholesky", "solve", "eigh"])
def test_lane_probe_call_forms_agree_on_cpu(op, monkeypatch, tmp_path):
    """The lane probe's two call forms (16-lane chunks, one padded call;
    16 lanes on the CPU here) give the same lanes on the CPU, where LAPACK
    factors lane by lane, at B below, at and above 16; without a card the
    probe exits 1."""
    from dlaf_tpu_torch.serve import lane_probe

    monkeypatch.setitem(bt.MIN_LANES, "cpu", 16)
    gen = torch.Generator().manual_seed(5)
    for b in (3, 16, 21):
        fn, xs, pads = lane_probe._case(op, torch.float64, b, 8, gen, torch.device("cpu"))
        whole, chunked = lane_probe._whole(fn, xs, pads), lane_probe._chunked(fn, xs, pads)
        for w in (whole if isinstance(whole, tuple) else (whole,)):
            assert w.shape[0] == b
        assert lane_probe._same(whole, chunked)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert lane_probe.main(["--out", str(tmp_path / "p.json")]) == 1


@pytest.mark.parametrize("split", [False, True], ids=["pad", "split"])
def test_fixed_lanes_call_counts(split, monkeypatch):
    """The card's call form at a CPU size (4 lanes): a batch below 4 lanes
    is padded to one 4-lane call; a longer one is one call, or with
    ``split`` calls of exactly 4 lanes, the last padded; the lanes come
    back in order and cut to B."""
    monkeypatch.setitem(bt.MIN_LANES, "cpu", 4)
    seen = []

    def fn(x):
        seen.append(x.shape[0])
        return x * 2

    pad = torch.full((2,), -1.0)
    for b, calls in ((1, [4]), (4, [4]), (9, [4, 4, 4] if split else [9])):
        seen.clear()
        x = torch.arange(2.0 * b).reshape(b, 2)
        assert torch.equal(bt._fixed_lanes(fn, x, pads=(pad,), split=split), x * 2)
        assert seen == calls
