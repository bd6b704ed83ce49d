"""The port's health layer (``dlaf_tpu_torch/health/``: errors, policy,
circuit, recovery) against the JAX reference's (``dlaf_tpu/health/``).

The same scripted calls, under one fake clock and one recording sleep,
go through both packages: the retry policy's backoff sequence, the
attempts and outcomes of ``with_policy`` (retryable, non-retryable,
exhausted, late), and the circuit breaker's state after every step
(closed -> open -> half-open -> closed or open again). The recovery
drivers on the same seeded matrices make the same number of attempts with
the same shifts: ``robust_cholesky`` locally and on a 2x2 grid,
``robust_cholesky_batched`` on a batch with two indefinite lanes (the
clean lanes bitwise the plain dispatch's, one bucket program for every
attempt). The error types carry the reference's fields and messages.
"""

import numpy as np
import pytest
import torch

from dlaf_tpu import config as jcfg
from dlaf_tpu import health as jhealth
from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu.common.index2d import RankIndex2D as JRankIndex2D
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.health import circuit as jcircuit
from dlaf_tpu.health import errors as jerrors
from dlaf_tpu.health import policy as jpolicy
from dlaf_tpu.health import recovery as jrecovery
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu.serve import ProgramService as JProgramService
from dlaf_tpu_torch import config, health
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import RankIndex2D, TileElementSize
from dlaf_tpu_torch.health import circuit, errors, policy, recovery
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.serve import ProgramService, cholesky_batched


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for knob in ("CHECK", "CIRCUIT_THRESHOLD", "CIRCUIT_COOLDOWN_S"):
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    jcfg.initialize()
    yield
    circuit.reset()
    jcircuit.reset()
    config.initialize()
    jcfg.initialize()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def hpd(n, seed=0, shift=None):
    x = np.random.default_rng(seed).standard_normal((n, n))
    return x @ x.T + (n if shift is None else shift) * np.eye(n)


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------

ERROR_ARGS = [
    ("FactorizationError", (5, 3, (0.0, 1e-6, 1e-2), (5, 5, 4)), {}),
    ("DegradationError", ("secular", "build failed", "no compiler"), {}),
    ("DeadlineExceededError", ("serve.queue", 0.25, 0.1), {"attempt": 2}),
    ("CircuitOpenError", ("serve.cholesky", 12.5), {}),
    ("OverloadError", (16, 16), {"op": "eigh", "bucket_n": 64}),
    ("PreemptionError", ("tridiag",), {}),
    ("ResumeError", ("bt_b2t", "fingerprint mismatch"), {}),
    ("AutotuneExhaustedError", ("cholesky.n64",), {"rung": 3, "ladder": "f64",
                                                   "bound_ratio": 2.5}),
    ("DrainedError", ("serve.queue", 7), {"op": "solve", "bucket_n": 32}),
    ("WorkerLostError", (1, 42, "eof"), {}),
    ("FleetUnavailableError", (3, {0: "dead", 1: "draining"}), {}),
    ("CheckError", ("cholesky input", 4), {}),
]


@pytest.mark.parametrize("name,args,kw", ERROR_ARGS, ids=[e[0] for e in ERROR_ARGS])
def test_errors_match_reference(name, args, kw):
    p, j = getattr(errors, name)(*args, **kw), getattr(jerrors, name)(*args, **kw)
    assert str(p) == str(j)
    assert {k: v for k, v in vars(p).items()} == {k: v for k, v in vars(j).items()}
    assert isinstance(p, errors.HealthError) and isinstance(p, RuntimeError)


# ---------------------------------------------------------------------------
# RetryPolicy and with_policy
# ---------------------------------------------------------------------------

POLICIES = [dict(), dict(max_attempts=5, backoff_base_s=0.1),
            dict(max_attempts=6, backoff_base_s=0.05, backoff_growth=3.0, backoff_max_s=1.0,
                 jitter=0.3, seed=7),
            dict(max_attempts=2, backoff_base_s=0.2, jitter=0.0)]


@pytest.mark.parametrize("kw", POLICIES)
def test_policy_delays_match_reference(kw):
    p, j = policy.RetryPolicy(**kw), jpolicy.RetryPolicy(**kw)
    assert [p.delay_s(r) for r in range(8)] == [j.delay_s(r) for r in range(8)]


@pytest.mark.parametrize("bad", [dict(max_attempts=0), dict(backoff_base_s=-1.0),
                                 dict(backoff_growth=0.5), dict(jitter=1.0),
                                 dict(attempt_deadline_s=0.0)])
def test_policy_validation(bad):
    with pytest.raises(ValueError):
        policy.RetryPolicy(**bad)
    with pytest.raises(ValueError):
        jpolicy.RetryPolicy(**bad)


def test_classification_matches_reference():
    for exc in (ValueError(), TypeError(), KeyError(), RuntimeError(), OSError(),
                TimeoutError(), ConnectionError(), NotImplementedError(), KeyboardInterrupt()):
        assert policy.default_retryable(exc) == jpolicy.default_retryable(exc)
    assert not policy.default_retryable(errors.OverloadError(1, 1))
    assert not jpolicy.default_retryable(jerrors.OverloadError(1, 1))


def _scenario(mod, fails, exc, *, late=False, **kw):
    """``with_policy`` over a callable that raises ``exc`` on its first
    ``fails`` calls (and, with ``late``, advances the clock past the
    deadline on success); returns the outcome, calls, sleeps and clock."""
    clock, sleeps, calls = FakeClock(), [], []

    def fn(x):
        calls.append(clock.t)
        clock.t += 0.01
        if len(calls) <= fails:
            raise exc
        if late:
            clock.t += 5.0
        return x * 2

    def sleep(d):
        sleeps.append(d)
        clock.t += d

    try:
        out = mod.with_policy("site", fn, 21, policy=mod.RetryPolicy(**kw), clock=clock,
                              sleep=sleep)
    except Exception as e:                    # noqa: BLE001 - the outcome compared
        out = (type(e).__name__, str(e))
    return out, calls, sleeps, clock.t


@pytest.mark.parametrize("fails,exc,late,kw", [
    (0, RuntimeError("x"), False, {}),
    (2, RuntimeError("flaky"), False, dict(max_attempts=3, backoff_base_s=0.1)),
    (5, OSError("down"), False, dict(max_attempts=3, backoff_base_s=0.05, seed=3)),
    (1, ValueError("bug"), False, dict(max_attempts=4)),
    (0, RuntimeError("x"), True, dict(attempt_deadline_s=1.0)),
    (1, TimeoutError("t"), False, dict(max_attempts=2, retryable=lambda e: False)),
], ids=["ok", "retried", "exhausted", "non-retryable", "late", "narrowed"])
def test_with_policy_matches_reference(fails, exc, late, kw):
    assert _scenario(policy, fails, exc, late=late, **kw) == \
        _scenario(jpolicy, fails, exc, late=late, **kw)


def test_attempts_driver_matches_reference():
    def run(mod):
        seen = []
        for a in mod.attempts("s", mod.RetryPolicy(max_attempts=4), sleep=seen.append):
            seen.append(a.index)
            if a.index < 2:
                a.fail(reason="info=3")
        return seen

    assert run(policy) == run(jpolicy) == [0, 1, 2]


# ---------------------------------------------------------------------------
# CircuitBreaker
# ---------------------------------------------------------------------------

def _breaker_script(mod, errmod):
    clock = FakeClock()
    br = mod.CircuitBreaker("s", threshold=2, cooldown_s=10.0, clock=clock)
    seen = []
    script = ["allow", "fail", "allow", "fail", "allow", "tick5", "allow", "tick6", "allow",
              "allow", "fail", "allow", "tick11", "allow", "ok", "allow", "fail", "ok", "fail",
              "fail", "reset", "allow"]
    for step in script:
        try:
            if step == "allow":
                br.allow()
            elif step == "fail":
                br.record_failure()
            elif step == "ok":
                br.record_success()
            elif step == "reset":
                br.reset()
            else:
                clock.t += float(step[4:])
            seen.append((step, br.state(), None))
        except errmod.CircuitOpenError as e:
            seen.append((step, br.state(), round(e.retry_in_s, 9)))
    return seen


def test_breaker_states_match_reference():
    p, j = _breaker_script(circuit, errors), _breaker_script(jcircuit, jerrors)
    assert p == j
    assert {s for _, s, _ in p} == {"closed", "open", "half_open"}


def test_breaker_registry():
    clock = FakeClock()
    assert circuit.peek("a") is None
    br = circuit.breaker("a", threshold=1, clock=clock)
    assert circuit.breaker("a", threshold=9) is br and br.threshold == 1
    other = FakeClock()
    assert circuit.breaker("a", clock=other).clock is other
    br.record_failure()
    circuit.breaker("b")
    assert circuit.states() == {"a": "open", "b": "closed"} and circuit.peek("a") == "open"
    assert circuit.reset("a") == 1 and circuit.peek("a") is None and br.state() == "closed"
    assert circuit.reset() == 1 and circuit.states() == {}


def test_breaker_defaults_from_config(monkeypatch):
    monkeypatch.setenv("DLAF_CIRCUIT_THRESHOLD", "5")
    monkeypatch.setenv("DLAF_CIRCUIT_COOLDOWN_S", "2.5")
    config.initialize()
    br = circuit.CircuitBreaker("c")
    assert br.threshold == 5 and br.cooldown_s == 2.5


# ---------------------------------------------------------------------------
# Recovery
# ---------------------------------------------------------------------------

def _both(a, grid, src, nb, devices8):
    jgrid = JGrid(*grid, devices=devices8[:grid[0] * grid[1]]) if grid else None
    pgrid = shared_grid(*grid, "cpu") if grid else None
    jm = JMatrix.from_global(a, JTileElementSize(nb, nb), grid=jgrid,
                             source_rank=JRankIndex2D(*src))
    pm = Matrix.from_global(a, TileElementSize(nb, nb), pgrid, source_rank=RankIndex2D(*src),
                            device="cpu")
    return jm, pm


@pytest.mark.parametrize("grid,src", [(None, (0, 0)), ((2, 2), (1, 0))], ids=["local", "2x2"])
def test_shift_diagonal_and_check_finite(grid, src, devices8):
    a = np.random.default_rng(0).standard_normal((13, 13))
    jm, pm = _both(a, grid, src, 4, devices8)
    before = [s.clone() for s in pm.shards()]
    got = recovery.shift_diagonal(pm, 0.5).to_numpy()
    np.testing.assert_array_equal(got, np.asarray(jrecovery.shift_diagonal(jm, 0.5).to_numpy()))
    np.testing.assert_array_equal(got, a + 0.5 * np.eye(13))
    assert all(torch.equal(x, y) for x, y in zip(pm.shards(), before))
    recovery.check_finite("m", pm)
    a[3, 5] = a[7, 7] = np.nan
    _, pm = _both(a, grid, src, 4, devices8)
    with pytest.raises(errors.CheckError) as e:
        recovery.check_finite("m", pm)
    assert e.value.count == 2


@pytest.mark.parametrize("grid,src", [(None, (0, 0)), ((2, 2), (1, 1))], ids=["local", "2x2"])
def test_robust_cholesky_matches_reference(grid, src, devices8):
    a = hpd(16, seed=3, shift=-6.0)
    jm, pm = _both(a, grid, src, 4, devices8)
    res = health.robust_cholesky("L", pm)
    jres = jhealth.robust_cholesky("L", jm)
    assert res.attempts == jres.attempts >= 2
    assert res.shifts == jres.shifts
    assert all(i > 0 for i in res.infos[:-1]) and res.infos[-1] == 0
    assert len(res.infos) == len(jres.infos)
    fac = np.tril(res.matrix.to_numpy())
    np.testing.assert_allclose(fac @ fac.T, a + res.shifts[-1] * np.eye(16), atol=1e-9)
    with pytest.raises(errors.FactorizationError) as e:
        health.robust_cholesky("L", pm, max_attempts=1)
    assert e.value.attempts == 1 and e.value.shifts == (0.0,)


def test_robust_cholesky_check_guard(monkeypatch):
    a = hpd(8)
    a[2, 1] = np.inf
    pm = Matrix.from_global(a, TileElementSize(4, 4), device="cpu")
    health.robust_cholesky("L", Matrix.from_global(hpd(8), TileElementSize(4, 4), device="cpu"))
    monkeypatch.setenv("DLAF_CHECK", "1")
    config.initialize()
    with pytest.raises(errors.CheckError, match="cholesky input"):
        health.robust_cholesky("L", pm)


def test_robust_batched_matches_reference():
    n = 12
    a = np.stack([hpd(n, seed=i) for i in range(4)])
    a[1] = hpd(n, seed=20, shift=-80.0)
    a[3] = hpd(n, seed=21, shift=-80.0)
    plain, _ = cholesky_batched("L", a.copy(), with_info=True,
                                service=ProgramService(device="cpu"))
    s = ProgramService(device="cpu")
    res = health.robust_cholesky_batched("L", a, service=s)
    jres = jhealth.robust_cholesky_batched("L", a, service=JProgramService())
    assert res.attempts == jres.attempts >= 2
    assert res.lane_attempts == jres.lane_attempts
    assert res.lane_attempts[0] == res.lane_attempts[2] == 1
    assert res.shifts == jres.shifts
    assert [[i != 0 for i in v] for v in res.infos] == [[i != 0 for i in v] for v in jres.infos]
    for i in (0, 2):
        assert torch.equal(res.out[i], plain[i])
    for i in (1, 3):
        fac = np.tril(res.out[i].numpy())
        shift = res.shifts[res.lane_attempts[i] - 1]
        np.testing.assert_allclose(fac @ fac.T, a[i] + shift * np.eye(n), atol=1e-8)
    st = s.stats()
    # every attempt through the one bucket program: one compile, then hits
    assert st["compiles"] == 1 and st["misses"] == 1 and st["hits"] == res.attempts - 1


def test_robust_batched_exhaustion_and_validation():
    a = np.stack([hpd(8), hpd(8, seed=40, shift=-30.0)])
    s = ProgramService(device="cpu")
    with pytest.raises(errors.FactorizationError) as exc:
        health.robust_cholesky_batched("L", a, max_attempts=1, service=s)
    with pytest.raises(jerrors.FactorizationError) as jexc:
        jhealth.robust_cholesky_batched("L", a, max_attempts=1, service=JProgramService())
    assert exc.value.attempts == jexc.value.attempts == 1
    assert len(exc.value.infos) == len(jexc.value.infos) == 1 and exc.value.infos[0] >= 1
    for bad in (dict(max_attempts=0), dict(shift=0.0), dict(shift_growth=1.0)):
        with pytest.raises(ValueError):
            health.robust_cholesky_batched("L", a, service=s, **bad)
    with pytest.raises(ValueError):
        health.robust_cholesky_batched("L", hpd(8), service=s)
