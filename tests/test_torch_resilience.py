"""The port's stage checkpoints and resume (``dlaf_tpu_torch/health/
resume.py``, ``eigensolver(..., resume=True)``), its serve dispatch drills
and its resilience artifacts, against the JAX reference.

A preempt at each of the five stage boundaries (red2band, b2t, tridiag,
bt_b2t, bt_r2b), on one rank and on a 2x2 grid, then ``resume=True``,
gives the uninterrupted run's eigenpairs bit for bit, and the eigenvalues
are the reference's to ``1e-12`` of their scale; the killed and the
resuming run are also two separate processes. The resume guards raise
``ResumeError`` naming the keys; a multi-process world ignores the
directory and refuses ``resume=True``, and a poisoned broadcast there is
detected and contained. The queue's ``fail_dispatch`` retry, its breaker
and a threaded flapping soak follow the reference's drills. The port's
artifacts pass the reference's ``validate_records`` with
``require_resilience`` and ``require_fallbacks``.
"""

import importlib
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from dlaf_tpu import config as jcfg
from dlaf_tpu import obs as jobs
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu_torch import config, obs
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import TileElementSize
from dlaf_tpu_torch.health import circuit, inject
from dlaf_tpu_torch.health.errors import (CircuitOpenError, OverloadError, PreemptionError,
                                          ResumeError)
from dlaf_tpu_torch.matrix import checkpoint as ckpt
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.miniapp.miniapp_eigensolver import eigen_residuals
from dlaf_tpu_torch.obs import validate as vcli
from dlaf_tpu_torch.serve import ProgramService, Queue, Request

jeig = importlib.import_module("dlaf_tpu.eigensolver.eigensolver")
peig = importlib.import_module("dlaf_tpu_torch.eigensolver.eigensolver")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_resilience_worker.py")
STAGES = ("red2band", "b2t", "tridiag", "bt_b2t", "bt_r2b")
N, NB, BAND = 32, 8, 4
_REF = {}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for key in ("METRICS_PATH", "RESUME_DIR", "STRICT", "CIRCUIT_THRESHOLD",
                "CIRCUIT_COOLDOWN_S"):
        monkeypatch.delenv("DLAF_" + key, raising=False)
    config.initialize(config.Configuration(log="off"))
    yield
    obs._reset_for_tests()
    jobs._reset_for_tests()
    circuit.reset()
    config.initialize()
    jcfg.initialize()


def herm(n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((n, n))
    return ((x + x.conj().T) / 2).astype(dtype)


def pmat(a, grid=None):
    return Matrix.from_global(a, TileElementSize(NB, NB),
                              shared_grid(*grid, "cpu") if grid else None, device="cpu")


def reference_eigenvalues(dtype):
    key = np.dtype(dtype).name
    if key not in _REF:
        _REF[key] = np.asarray(jeig.eigensolver(
            "L", JMatrix.from_global(herm(N, 0, dtype), JTileElementSize(NB, NB)),
            band_size=BAND).eigenvalues)
    return _REF[key]


def run(a, grid, **kw):
    res = peig.eigensolver("L", pmat(a, grid), band_size=BAND, **kw)
    return np.asarray(res.eigenvalues), res.eigenvectors.to_numpy()


# ---------------------------------------------------------------------------
# Kill at every stage boundary, resume bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("grid", [None, (2, 2)])
def test_eigensolver_preempt_resume_bitwise(grid, dtype, tmp_path):
    a = herm(N, 0, dtype)
    lam, vecs = run(a, grid)
    ref = reference_eigenvalues(dtype)
    np.testing.assert_allclose(lam, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    for stage in STAGES:
        rd = str(tmp_path / stage)
        config.initialize(config.Configuration(log="off", resume_dir=rd))
        with pytest.raises(PreemptionError) as ei:
            with inject.preempt(stage):
                run(a, grid)
        assert ei.value.stage == stage
        # the killed stage's checkpoint is on disk, the next one's is not
        assert ckpt.stage_manifest(os.path.join(rd, "eigensolver"), stage) is not None
        later = STAGES[STAGES.index(stage) + 1:]
        assert not later or ckpt.stage_manifest(os.path.join(rd, "eigensolver"),
                                                later[0]) is None
        got_lam, got_vecs = run(a, grid, resume=True)
        np.testing.assert_array_equal(got_lam, lam)
        np.testing.assert_array_equal(got_vecs, vecs)
    vals = eigen_residuals(torch.as_tensor(a), None, lam, torch.as_tensor(vecs))
    assert max(vals.values()) < 200 * N * np.finfo(np.float64).eps


def test_eigensolver_resume_guards(tmp_path):
    a = herm(24, 1)
    mat = lambda: Matrix.from_global(a, TileElementSize(8, 8), device="cpu")  # noqa: E731
    with pytest.raises(ResumeError, match="DLAF_RESUME_DIR"):
        peig.eigensolver("L", mat(), resume=True)
    config.initialize(config.Configuration(log="off", resume_dir=str(tmp_path / "rd")))
    peig.eigensolver("L", mat())
    with pytest.raises(ResumeError, match="fingerprint mismatch on .*uplo"):
        peig.eigensolver("U", mat(), resume=True)
    with pytest.raises(ResumeError, match="band_size"):
        peig.eigensolver("L", mat(), band_size=4, resume=True)
    # other data at the same shape and configuration
    a2 = herm(24, 2)
    with pytest.raises(ResumeError, match="input_sha"):
        peig.eigensolver("L", Matrix.from_global(a2, TileElementSize(8, 8), device="cpu"),
                         resume=True)
    # the other triangle is not part of the run's identity
    junk = np.where(np.tril(np.ones_like(a, bool)), a, 7.0)
    res = peig.eigensolver("L", Matrix.from_global(junk, TileElementSize(8, 8), device="cpu"),
                           resume=True)
    assert np.isfinite(res.eigenvalues).all()
    # a manifest of another version is refused
    man = os.path.join(str(tmp_path / "rd"), "eigensolver", "red2band.json")
    with open(man) as f:
        m = json.load(f)
    m["version"] = 99
    with open(man, "w") as f:
        json.dump(m, f)
    with pytest.raises(ResumeError, match="manifest version"):
        peig.eigensolver("L", mat(), resume=True)
    # a fresh run never skips, whatever is on disk, and rewrites the stage
    peig.eigensolver("L", mat())
    assert ckpt.stage_manifest(os.path.dirname(man), "red2band")["version"] == 1


@pytest.mark.parametrize("dtype,uplo,grid", [(np.float64, "L", None),
                                             (np.complex128, "U", (2, 2))])
def test_stage_fingerprint_is_the_reference_s(dtype, uplo, grid, tmp_path, devices8):
    """On the CPU the run identity is the reference's, key for key: the
    device type stands where the reference has its backend, and the input
    hash covers the stored triangle only."""
    from dlaf_tpu.comm.grid import Grid as JGrid

    rd = str(tmp_path / "rd")
    config.initialize(config.Configuration(log="off", resume_dir=rd))
    jcfg.initialize(jcfg.Configuration(log="off", resume_dir=rd))
    a = herm(N, 3, dtype)
    got = peig._stage_fingerprint(uplo, pmat(a, grid), BAND)
    jg = JGrid(*grid, devices=devices8[:4]) if grid else None
    want = jeig._stage_fingerprint(uplo, JMatrix.from_global(a, JTileElementSize(NB, NB),
                                                             grid=jg), BAND, N, NB)
    assert got == want


def test_resume_records_pass_both_validators(tmp_path):
    path = str(tmp_path / "art.jsonl")
    a = herm(24, 2)
    config.initialize(config.Configuration(log="off", metrics_path=path,
                                           resume_dir=str(tmp_path / "rd")))
    mat = lambda: Matrix.from_global(a, TileElementSize(8, 8), device="cpu")  # noqa: E731
    peig.eigensolver("L", mat())
    with pytest.raises(PreemptionError):
        with inject.preempt("tridiag"):
            peig.eigensolver("L", mat())
    peig.eigensolver("L", mat(), resume=True)
    with inject.force_native_failure():
        peig.eigensolver("L", mat())
    obs.flush()
    recs = obs.read_records(path)
    res = [r for r in recs if r.get("type") == "resilience"]
    assert [r["event"] for r in res if r["event"] != "checkpoint"] == \
        ["preempt"] + ["resume"] * 5
    assert sum(r["event"] == "checkpoint" for r in res) == 5 + 3 + 5
    assert not obs.validate_records(recs, require_resilience=True, require_fallbacks=True)
    assert not jobs.validate_records(recs, require_resilience=True, require_fallbacks=True)
    assert vcli.main([path, "--require-resilience", "--require-fallbacks"]) == 0
    clean = str(tmp_path / "clean.jsonl")
    obs._reset_for_tests()          # counters live as long as the process
    config.initialize(config.Configuration(log="off", metrics_path=clean))
    peig.eigensolver("L", mat())
    obs.flush()
    assert vcli.main([clean, "--require-fallbacks"]) == 1
    assert jobs.validate_records(obs.read_records(clean), require_fallbacks=True)


def _spawn(*args, timeout=120):
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, WORKER, *args], env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("stage", ["b2t", "bt_b2t"])
def test_kill_and_resume_in_two_processes(stage, tmp_path):
    """One process is killed at the boundary, another resumes from the
    directory it left: the eigenpairs are this process's uninterrupted
    run's, bit for bit."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        import torch_resilience_worker as w
    finally:
        sys.path.pop(0)
    killed = _spawn("kill", str(tmp_path), stage)
    assert killed.returncode == 3, killed.stdout + killed.stderr
    assert ckpt.stage_manifest(str(tmp_path / "rd" / "eigensolver"), stage) is not None
    resumed = _spawn("resume", str(tmp_path))
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    got = np.load(tmp_path / "resumed.npz")
    res = peig.eigensolver("L", Matrix.from_global(w.problem(), TileElementSize(w.NB, w.NB),
                                                   device="cpu"), band_size=w.BAND)
    np.testing.assert_array_equal(got["lam"], res.eigenvalues)
    np.testing.assert_array_equal(got["vecs"], res.eigenvectors.to_numpy())


def test_multi_process_world_ignores_the_directory_and_contains_a_poisoned_bcast(tmp_path):
    url = f"file://{tmp_path}/rdv"
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, WORKER, "world", url, str(r), "4", str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(4)]
    try:
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    got = [json.load(open(tmp_path / f"world.r{r}.json")) for r in range(4)]
    assert all(g["poisoned"] != 0 and g["clean"] == 0 for g in got)
    assert len({g["poisoned"] for g in got}) == 1
    assert all("single-controller only" in g["resume"] for g in got)
    assert not os.path.exists(tmp_path / "rd")
    assert sum("ignored in a multi-process world" in o for o in outs) == 4
    # the eigenvalues of the single controller's 2x2 grid, bit for bit
    lam, _ = run(herm(N, 0), (2, 2))
    np.testing.assert_array_equal(np.asarray(got[0]["lam"]), lam)


# ---------------------------------------------------------------------------
# Serve dispatch drills (the reference's tests/test_resilience.py)
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def hpd(n, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, n))
    return x @ x.T + n * np.eye(n)


def test_queue_dispatch_retries_transient_fault(tmp_path):
    path = str(tmp_path / "q.jsonl")
    config.initialize(config.Configuration(log="off", metrics_path=path))
    clean = Queue(ProgramService(device="cpu"), batch=2, deadline_s=1e9, buckets=(16,),
                  clock=FakeClock(), retry_attempts=3)
    c1 = clean.submit(Request(op="cholesky", a=hpd(8, 1)))
    clean.submit(Request(op="cholesky", a=hpd(8, 2)))
    q = Queue(ProgramService(device="cpu"), batch=2, deadline_s=1e9, buckets=(16,),
              clock=FakeClock(), retry_attempts=3)
    with inject.fail_dispatch(nth=0, count=2):
        t1 = q.submit(Request(op="cholesky", a=hpd(8, 1)))
        t2 = q.submit(Request(op="cholesky", a=hpd(8, 2)))
    assert t1.done and t2.done
    np.testing.assert_array_equal(t1.result(), c1.result())
    obs.flush()
    recs = obs.read_records(path)
    assert len([r for r in recs if r.get("type") == "resilience"
                and r.get("event") == "retry"]) == 2
    assert not obs.validate_records(recs, require_resilience=True)
    assert not jobs.validate_records(recs, require_resilience=True)


def test_queue_sustained_fault_opens_breaker_and_fails_fast(tmp_path):
    path = str(tmp_path / "q.jsonl")
    config.initialize(config.Configuration(log="off", metrics_path=path))
    q = Queue(ProgramService(device="cpu"), batch=1, deadline_s=1e9, buckets=(16,),
              clock=FakeClock(), retry_attempts=3)
    with inject.fail_dispatch(nth=0, count=100):
        with pytest.raises(RuntimeError, match="injected dispatch fault"):
            q.submit(Request(op="cholesky", a=hpd(8, 1)))
        (bucket,) = q.stats()["buckets"].values()
        assert bucket["breaker"] == "open" and bucket["failures"] == 1
        with pytest.raises(CircuitOpenError):
            q.submit(Request(op="cholesky", a=hpd(8, 2)))
        obs.flush()
        errors = obs.validate_records(obs.read_records(path), require_resilience=True)
        assert any("left open" in e for e in errors)
    t = q.submit(Request(op="cholesky", a=hpd(8, 3)))
    assert t.done
    with pytest.raises(ValueError):
        with inject.fail_dispatch(count=0):
            pass
    with inject.fail_dispatch():
        with pytest.raises(RuntimeError, match="not reentrant"):
            with inject.fail_dispatch():
                pass


def test_queue_soak_threaded_flapping_fault_no_deadlock_no_double():
    """16 threads against a flapping fault behind one attempt: the breaker
    opens, the half-open probe closes it, no submit deadlocks, no request
    dispatches twice and no ticket is stranded."""
    config.initialize(config.Configuration(log="off", circuit_threshold=3,
                                           circuit_cooldown_s=0.05))
    served, errors = [], []
    lock = threading.Lock()

    class Tracking(ProgramService):
        def run(self, spec, *args):
            out = super().run(spec, *args)
            with lock:
                served.append(args[0].shape[0])
            return out

    q = Queue(Tracking(device="cpu"), batch=4, deadline_s=1e9, buckets=(8,), max_depth=64,
              shed=True, retry_attempts=1)
    q.warmup([Request(op="cholesky", a=hpd(8))])
    served.clear()
    tickets = []

    def worker(seed):
        try:
            t = q.submit(Request(op="cholesky", a=hpd(8, seed)))
            with lock:
                tickets.append(t)
        except (OverloadError, CircuitOpenError, RuntimeError) as e:
            with lock:
                errors.append(e)

    def storm(phase):
        threads = [threading.Thread(target=worker, args=(phase * 100 + i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "soak deadlocked"
        try:
            q.flush()
        except (CircuitOpenError, RuntimeError):
            pass

    with inject.fail_dispatch(nth=0, count=10_000):
        storm(1)
        (bucket,) = q.stats()["buckets"].values()
        assert bucket["breaker"] == "open"
        assert not served
    circuit.reset("serve.")
    with inject.fail_dispatch(nth=0, count=1, every=5):
        storm(2)
    q.flush()
    assert all(t.done or t.error is not None for t in tickets), "stranded tickets"
    assert all(not (t.done and t.error is not None) for t in tickets)
    assert sum(t.done for t in tickets) >= 10
    assert q.dispatches == len(served)
