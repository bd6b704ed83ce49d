"""The port's request queue (``dlaf_tpu_torch/serve/queue.py``) against the
JAX reference's (``dlaf_tpu/serve/queue.py``), and its own contracts.

Both queues are driven by the same seeded sequence of submits, polls and
flushes under the same fake clock values (two clock schedules, shed on
and off at an admission bound): every dispatch holds the same request ids
in the same order, the same submits are shed, the same tickets expire,
``stats()`` agrees on depth, shed and expired counts, and each served
request's answer agrees with the reference's (factor and solve at ``60 n
eps``, eigenvalues at ``100 n eps``). The reference's own queue tests
(deadline determinism, bucket keys, rhs ceilings, eigh shape padding,
malformed requests, dispatch-failure poisoning, threaded submits, drain)
are ported, with the overload bound, the retry and the breaker.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from dlaf_tpu import config as jcfg
from dlaf_tpu.health import circuit as jcircuit
from dlaf_tpu.serve import ProgramService as JProgramService
from dlaf_tpu.serve import Queue as JQueue
from dlaf_tpu.serve import Request as JRequest
from dlaf_tpu.serve import bucket_ceiling as j_bucket_ceiling
from dlaf_tpu.serve import queue as jqueue
from dlaf_tpu.serve import rhs_ceiling as j_rhs_ceiling
from dlaf_tpu_torch import config
from dlaf_tpu_torch.health import circuit
from dlaf_tpu_torch.health.errors import (CircuitOpenError, DeadlineExceededError, DrainedError,
                                          OverloadError)
from dlaf_tpu_torch.serve import ProgramService, Queue, Request, bucket_ceiling, rhs_ceiling
from dlaf_tpu_torch.serve import queue as pqueue


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for knob in ("SERVE_BUCKETS", "SERVE_BATCH", "SERVE_DEADLINE_MS", "SERVE_MAX_DEPTH",
                 "SERVE_SHED"):
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    jcfg.initialize()
    yield
    circuit.reset()
    jcircuit.reset()


@pytest.fixture(scope="module")
def jsvc():
    """One reference service for the module: its compiled bucket programs
    are reused across the scenarios."""
    return JProgramService()


def svc():
    return ProgramService(device="cpu")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def hpd(n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n)).astype(dtype)
    return (x @ x.T + n * np.eye(n)).astype(dtype)


def tri(n, seed=0, uplo="L"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    return (np.tril(x) if uplo == "L" else np.triu(x)) + 3 * np.eye(n)


def sym(n, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, n))
    return (x + x.T) / 2


# ---------------------------------------------------------------------------
# The same drive through both queues
# ---------------------------------------------------------------------------

def _recording(base):
    class Rec(base):
        def _dispatch_lanes(self, key, lanes):
            out = super()._dispatch_lanes(key, lanes)
            self.log.append((key.op, key.n, key.nrhs,
                             [r.rid for r, t in lanes if t.done]))
            return out

    return Rec


def _drive(QueueCls, RequestCls, service, seed, shed):
    """A seeded sequence of submits, polls and flushes; returns the
    dispatch log, per-submit outcomes, the tickets and the final stats."""
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    q = _recording(QueueCls)(service, batch=3, deadline_s=0.05, buckets=(8, 16), clock=clock,
                             max_depth=5, shed=shed)
    q.log = []
    steps = (0.0, 0.005, 0.01, 0.03) if seed % 2 else (0.0, 0.0, 0.0, 0.02, 0.2)
    outcomes, tickets = [], []
    for i in range(36):
        clock.t += float(rng.choice(steps))
        act = rng.random()
        if act < 0.75:
            op = ("cholesky", "solve", "eigh")[int(rng.integers(3))]
            n = int(rng.integers(5, 9) if rng.random() < 0.6 else rng.integers(9, 17))
            deadline = None if rng.random() < 0.6 else float(rng.choice([0.02, 0.1]))
            if op == "cholesky":
                req = RequestCls(op=op, a=hpd(n, seed=i), deadline_s=deadline)
            elif op == "solve":
                b = np.random.default_rng(i).standard_normal((n, int(rng.integers(1, 3))))
                req = RequestCls(op=op, a=tri(n, seed=i), b=b, alpha=float(rng.choice([1, -2])),
                                 deadline_s=deadline)
            else:
                req = RequestCls(op=op, a=sym(n, seed=i), deadline_s=deadline)
            try:
                tickets.append(q.submit(req))
                outcomes.append(("ok", tickets[-1].request.rid))
            except Exception as e:          # noqa: BLE001 - the shed is the outcome
                outcomes.append((type(e).__name__, None))
        elif act < 0.92:
            outcomes.append(("poll", q.poll()))
        else:
            outcomes.append(("flush", q.flush()))
    outcomes.append(("flush", q.flush()))
    return q.log, outcomes, tickets, q.stats()


def _agree(p, j, op, n):
    eps = np.finfo(np.float64).eps
    if op == "eigh":
        pw, pv = p
        jw, _ = j
        assert np.abs(pw - np.asarray(jw)).max() <= 100 * n * eps * max(np.abs(jw).max(), 1)
        return
    p, j = np.asarray(p), np.asarray(j)
    if op == "cholesky":
        p, j = np.tril(p), np.tril(j)
    assert np.linalg.norm(p - j) <= 60 * n * eps * np.linalg.norm(j)


@pytest.mark.parametrize("seed", [0, 1], ids=["clock-coarse", "clock-fine"])
@pytest.mark.parametrize("shed", [True, False], ids=["shed", "backpressure"])
def test_dispatch_membership_matches_reference(seed, shed, jsvc):
    p_log, p_out, p_tix, p_stats = _drive(Queue, Request, svc(), seed, shed)
    j_log, j_out, j_tix, j_stats = _drive(JQueue, JRequest, jsvc, seed, shed)
    assert p_log == j_log and len(p_log) > 5
    assert p_out == j_out
    for key in ("pending", "requests", "dispatches", "shed", "expired", "drained"):
        assert p_stats[key] == j_stats[key], key
    assert ({s: (b["depth"], b["shed"], b["expired"], b["dispatches"])
             for s, b in p_stats["buckets"].items()}
            == {s: (b["depth"], b["shed"], b["expired"], b["dispatches"])
                for s, b in j_stats["buckets"].items()})
    if shed:
        assert p_stats["shed"] > 0
    assert len(p_tix) == len(j_tix)
    for pt, jt in zip(p_tix, j_tix):
        assert pt.done == jt.done and type(pt.error).__name__ == type(jt.error).__name__
        if pt.done:
            assert pt.info == jt.info == 0
            _agree(pt.result(), jt.result(), pt.request.op, np.asarray(pt.request.a).shape[0])


def test_ceilings_and_wire_match_reference():
    for buckets in ((), (32, 64), (5, 12, 100)):
        for n in range(1, 140):
            assert bucket_ceiling(n, buckets) == j_bucket_ceiling(n, buckets)
    for free in range(1, 70):
        assert rhs_ceiling(free) == j_rhs_ceiling(free)
    a = np.arange(12, dtype=np.complex128).reshape(3, 4) * (1 + 2j)
    assert pqueue.array_to_wire(a) == jqueue.array_to_wire(a)
    np.testing.assert_array_equal(pqueue.array_from_wire(pqueue.array_to_wire(a)), a)
    req = Request(op="solve", a=tri(4), b=np.ones((4, 2)), alpha=-2.0, rid=7, deadline_s=0.5)
    doc = req.to_wire()
    assert doc == JRequest(op="solve", a=tri(4), b=np.ones((4, 2)), alpha=-2.0, rid=7,
                           deadline_s=0.5).to_wire()
    back = Request.from_wire(doc)
    np.testing.assert_array_equal(back.a, req.a)
    assert (back.op, back.alpha, back.rid, back.deadline_s) == ("solve", -2.0, 7, 0.5)


def test_serve_knobs_and_validation(monkeypatch):
    monkeypatch.setenv("DLAF_SERVE_BUCKETS", "32,64")
    monkeypatch.setenv("DLAF_SERVE_SHED", "0")
    cfg = config.initialize()
    assert config.parse_serve_buckets(cfg.serve_buckets) == (32, 64) and cfg.serve_shed is False
    monkeypatch.delenv("DLAF_SERVE_BUCKETS")
    monkeypatch.delenv("DLAF_SERVE_SHED")
    for bad in (dict(serve_batch=0), dict(serve_deadline_ms=-1.0),
                dict(serve_max_depth=-1), dict(serve_retry_attempts=0),
                dict(serve_retry_backoff_ms=-1.0), dict(circuit_threshold=0),
                dict(circuit_cooldown_s=-1.0), dict(serve_buckets="64,32"),
                dict(serve_buckets="a,b")):
        with pytest.raises(ValueError):
            config.initialize(config.Configuration(**bad))
    for value in ("", "8", "8,16,32", " 4 "):
        assert config.parse_serve_buckets(value) == jcfg.parse_serve_buckets(value)
    d, j = config.Configuration(), jcfg.Configuration()
    for knob in ("serve_buckets", "serve_batch", "serve_deadline_ms", "serve_max_depth",
                 "serve_shed", "serve_retry_attempts", "serve_retry_backoff_ms",
                 "circuit_threshold", "circuit_cooldown_s", "check"):
        assert getattr(d, knob) == getattr(j, knob), knob


# ---------------------------------------------------------------------------
# The reference's queue tests, ported
# ---------------------------------------------------------------------------

def test_full_batch_dispatches_immediately():
    clock = FakeClock()
    q = Queue(svc(), batch=3, deadline_s=1e9, buckets=(16,), clock=clock)
    t1 = q.submit(Request(op="cholesky", a=hpd(12, seed=1)))
    t2 = q.submit(Request(op="cholesky", a=hpd(14, seed=2)))
    assert not t1.done and q.pending() == 2
    t3 = q.submit(Request(op="cholesky", a=hpd(16, seed=3)))
    assert t1.done and t2.done and t3.done and q.pending() == 0 and q.dispatches == 1
    for t in (t1, t2, t3):
        a = np.asarray(t.request.a)
        fac = np.tril(t.result())
        assert fac.shape == a.shape
        np.testing.assert_allclose(fac @ fac.T, a, atol=1e-10 * len(a))
        assert t.info == 0 and t.total_s >= 0.0


def test_deadline_determinism_with_fake_clock():
    clock = FakeClock()
    q = Queue(svc(), batch=4, deadline_s=0.05, buckets=(16,), clock=clock)
    t1 = q.submit(Request(op="cholesky", a=hpd(10)))
    clock.t = 0.049
    assert q.poll() == 0 and not t1.done
    clock.t = 0.051
    assert q.poll() == 1 and t1.done and q.dispatches == 1
    t2 = q.submit(Request(op="cholesky", a=hpd(10, seed=4)))
    clock.t = 0.2
    t3 = q.submit(Request(op="eigh", a=sym(12)))
    assert t2.done and not t3.done
    q.flush()
    assert t3.done


def test_request_deadline_expires_before_dispatch():
    clock = FakeClock()
    q = Queue(svc(), batch=4, deadline_s=1e9, buckets=(16,), clock=clock)
    late = q.submit(Request(op="cholesky", a=hpd(8), deadline_s=0.01))
    clock.t = 0.5
    ok = q.submit(Request(op="cholesky", a=hpd(8, seed=1)))
    q.flush()
    assert ok.done and not late.done and isinstance(late.error, DeadlineExceededError)
    with pytest.raises(RuntimeError, match="expired before dispatch"):
        late.result()
    st = q.stats()
    assert st["expired"] == 1 and st["dispatches"] == 1


def test_bucket_keys_separate_ops_dtypes_and_flags():
    q = Queue(svc(), batch=8, deadline_s=1e9, buckets=(16,), clock=FakeClock())
    q.submit(Request(op="cholesky", a=hpd(12)))
    q.submit(Request(op="cholesky", a=hpd(12).astype(np.float32)))
    q.submit(Request(op="cholesky", a=hpd(12), uplo="U"))
    q.submit(Request(op="eigh", a=sym(12)))
    q.submit(Request(op="solve", a=tri(12), b=np.ones((12, 3))))
    assert len(q._pending) == 5 and q.flush() == 5


def test_solve_roundtrip_with_rhs_bucketing():
    s = svc()
    q = Queue(s, batch=2, deadline_s=1e9, buckets=(16,), clock=FakeClock())
    a1, b1 = tri(12, seed=1), np.random.default_rng(0).standard_normal((12, 5))
    a2, b2 = tri(10, seed=2), np.random.default_rng(1).standard_normal((10, 7))
    t1 = q.submit(Request(op="solve", a=a1, b=b1, alpha=2.0))
    t2 = q.submit(Request(op="solve", a=a2, b=b2))
    assert t1.done and t2.done
    x1, x2 = t1.result(), t2.result()
    assert x1.shape == b1.shape and x2.shape == b2.shape
    np.testing.assert_allclose(np.tril(a1) @ x1, 2.0 * b1, atol=1e-10)
    np.testing.assert_allclose(np.tril(a2) @ x2, b2, atol=1e-10)
    (spec,) = s.specs()
    assert spec.n == 16 and spec.nrhs == 8


def test_rhs_ceiling_is_pow2_not_matrix_bucket():
    s = svc()
    q = Queue(s, batch=1, deadline_s=1e9, buckets=(512,), clock=FakeClock())
    t = q.submit(Request(op="solve", a=tri(12), b=np.ones((12, 1))))
    (spec,) = s.specs()
    assert spec.n == 512 and spec.nrhs == 1
    np.testing.assert_allclose(np.tril(tri(12)) @ t.result(), np.ones((12, 1)), atol=1e-10)


def test_eigh_shape_pad_recovers_leading_pairs():
    q = Queue(svc(), batch=1, deadline_s=1e9, buckets=(16,), clock=FakeClock())
    a = sym(11, seed=5)
    w, v = q.submit(Request(op="eigh", a=a)).result()
    assert w.shape == (11,) and v.shape == (11, 11)
    ws, vs = np.linalg.eigh(a)
    np.testing.assert_allclose(w, ws, atol=1e-12)
    np.testing.assert_allclose(np.abs(v), np.abs(vs), atol=1e-10)
    np.testing.assert_allclose(a @ v, v * w[None, :], atol=1e-11)


def test_eigh_shape_pad_dominant_eigenvalue():
    q = Queue(svc(), batch=1, deadline_s=1e9, buckets=(16,), clock=FakeClock())
    a = np.ones((8, 8))
    w, v = q.submit(Request(op="eigh", a=a)).result()
    np.testing.assert_allclose(w, np.linalg.eigh(a)[0], atol=1e-12)
    assert abs(w[-1] - 8) < 1e-12
    np.testing.assert_allclose(a @ v, v * w[None, :], atol=1e-11)


def test_ticket_result_before_dispatch_raises():
    q = Queue(svc(), batch=4, deadline_s=1e9, buckets=(16,), clock=FakeClock())
    t = q.submit(Request(op="cholesky", a=hpd(8)))
    with pytest.raises(RuntimeError, match="still queued"):
        t.result()


def test_rejects_malformed_requests():
    q = Queue(svc(), batch=2, clock=FakeClock())
    with pytest.raises(AssertionError):
        q.submit(Request(op="lu", a=hpd(8)))
    with pytest.raises(AssertionError):
        q.submit(Request(op="cholesky", a=np.ones((3, 4))))
    with pytest.raises(AssertionError):
        q.submit(Request(op="solve", a=tri(8), b=np.ones((5, 2))))
    with pytest.raises(AssertionError, match="dtype"):
        q.submit(Request(op="solve", a=tri(8).astype(np.float32), b=np.ones((8, 2))))
    assert q.pending() == 0 and q.requests == 0


class _Boom(ProgramService):
    """A service whose first ``fails`` runs raise."""

    def __init__(self, fails):
        super().__init__(device="cpu")
        self.fails = fails
        self.calls = 0

    def run(self, spec, *args):
        self.calls += 1
        if self.calls <= self.fails:
            raise RuntimeError("kernel exploded")
        return super().run(spec, *args)


def test_dispatch_failure_poisons_tickets_with_cause():
    q = Queue(_Boom(10 ** 6), batch=2, deadline_s=1e9, buckets=(16,), clock=FakeClock(),
              retry_attempts=1)
    t1 = q.submit(Request(op="cholesky", a=hpd(8, seed=0)))
    with pytest.raises(RuntimeError, match="kernel exploded"):
        q.submit(Request(op="cholesky", a=hpd(8, seed=1)))
    assert t1.error is not None and not t1.done
    with pytest.raises(RuntimeError, match="dispatch failed") as exc:
        t1.result()
    assert "kernel exploded" in str(exc.value.__cause__)
    assert q.pending() == 0 and q.stats()["buckets"]
    assert next(iter(q.stats()["buckets"].values()))["failures"] == 1


def test_transient_failure_retries_and_breaker_opens():
    clock = FakeClock()
    boom = _Boom(2)
    q = Queue(boom, batch=1, deadline_s=1e9, buckets=(16,), clock=clock, retry_attempts=3)
    t = q.submit(Request(op="cholesky", a=hpd(8)))
    assert t.done and t.info == 0 and boom.calls == 3      # two retries, then served
    site = q._spec(q._key(t.request)).site
    assert circuit.peek(site) == "closed"
    dead = _Boom(10 ** 6)
    q2 = Queue(dead, batch=1, deadline_s=1e9, buckets=(16,), clock=clock, retry_attempts=3)
    with pytest.raises(RuntimeError):
        q2.submit(Request(op="cholesky", a=hpd(8)))
    assert circuit.peek(site) == "open" and dead.calls == 3
    with pytest.raises(CircuitOpenError):
        q2.submit(Request(op="cholesky", a=hpd(8)))
    assert dead.calls == 3                                   # failed fast
    assert q2.stats()["buckets"][site]["breaker"] == "open"
    clock.t += config.get_configuration().circuit_cooldown_s
    t = Queue(svc(), batch=1, deadline_s=1e9, buckets=(16,), clock=clock).submit(
        Request(op="cholesky", a=hpd(8)))
    assert t.done and circuit.peek(site) == "closed"         # the probe closed it


@pytest.mark.parametrize("shed", [True, False], ids=["shed", "backpressure"])
def test_overload_bound_holds_and_strands_nothing(shed):
    q = Queue(svc(), batch=4, deadline_s=1e9, buckets=(8, 16), clock=FakeClock(),
              max_depth=6, shed=shed)
    tickets, shed_n, depth = [], 0, []
    for i in range(24):          # a 2x burst of 4 buckets
        op, n = (("cholesky", 6), ("cholesky", 12), ("eigh", 6), ("eigh", 12))[i % 4]
        a = hpd(n, seed=i) if op == "cholesky" else sym(n, seed=i)
        try:
            tickets.append(q.submit(Request(op=op, a=a)))
        except OverloadError as e:
            shed_n += 1
            assert e.max_depth == 6 and e.depth >= 6
        depth.append(q.pending())
    assert max(depth) <= 6
    assert (shed_n > 0) == shed and q.stats()["shed"] == shed_n
    q.flush()
    assert all(t.done and t.error is None for t in tickets)
    assert len(tickets) + shed_n == 24


def test_threaded_submits_race_free():
    s = svc()
    q = Queue(s, batch=4, deadline_s=1e9, buckets=(16,))
    s.warmup(*q.warmup_specs([Request(op="cholesky", a=hpd(12))]))
    tickets, errors = [], []

    def worker(seed):
        try:
            tickets.append(q.submit(Request(op="cholesky", a=hpd(12, seed=seed))))
        except Exception as e:               # noqa: BLE001 - recorded
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    q.flush()
    assert errors == []
    assert len(tickets) == 32 and all(t.done for t in tickets)
    assert q.dispatches == 8 and q.pending() == 0
    assert sorted(t.request.rid for t in tickets) == list(range(32))


def test_drain_returns_undispatched_and_poisons_tickets():
    q = Queue(svc(), batch=4, deadline_s=1e9, buckets=(16,), clock=FakeClock())
    done = q.submit(Request(op="cholesky", a=hpd(12, seed=9)))
    q.flush()
    assert done.done
    reqs = [Request(op="cholesky", a=hpd(12, seed=i)) for i in range(3)]
    reqs.append(Request(op="eigh", a=sym(12)))
    tickets = [q.submit(r) for r in reqs]
    assert q.pending() == 4
    drained = q.drain()
    assert q.pending() == 0
    assert [r.rid for r, _ in drained] == [r.rid for r in reqs]
    assert [t for _, t in drained] == tickets
    for req, t in drained:
        assert not t.done and isinstance(t.error, DrainedError)
        assert t.error.rid == req.rid and t.error.site == "serve.queue" and t.error.bucket_n == 16
        with pytest.raises(RuntimeError, match="drained undispatched") as ei:
            t.result()
        assert ei.value.__cause__ is t.error
    assert {t.error.op for _, t in drained} == {"cholesky", "eigh"}
    assert q.poll(now=1e12) == 0 and q.flush() == 0 and q.drain() == []
    assert q.stats()["drained"] == 4
    t2 = q.submit(Request(op="cholesky", a=hpd(12, seed=77)))
    q.flush()
    assert t2.done and np.tril(t2.result()).shape == (12, 12)


def test_warmup_makes_the_stream_all_hits():
    s = svc()
    q = Queue(s, batch=2, deadline_s=1e9, buckets=(8, 16), clock=FakeClock())
    sample = [Request(op="cholesky", a=hpd(6)), Request(op="eigh", a=sym(12)),
              Request(op="solve", a=tri(7), b=np.ones((7, 3)))]
    walls = q.warmup(sample)
    assert len(walls) == 3 and s.stats()["warmups"] == 3
    for i in range(6):
        q.submit(Request(op="cholesky", a=hpd(5 + i % 3, seed=i)))
        q.submit(Request(op="eigh", a=sym(9 + i % 4, seed=i)))
        q.submit(Request(op="solve", a=tri(8, seed=i), b=np.ones((8, 4))))
    q.flush()
    st = s.stats()
    assert st["misses"] == 0 and st["hit_rate"] == 1.0 and st["hits"] == q.dispatches == 9
    assert torch.get_default_device().type == "cpu"
