"""The port's multi-process bring-up (``dlaf_tpu_torch/comm/multihost.py``)
against the reference's multihost unit tests (``tests/test_comm.py``:
the single-process no-op and the slice-aware layout; ``tests/test_health.py``:
the actionable bring-up error and the retried connect), with
``torch.distributed.init_process_group`` monkeypatched; the refusal of an
NCCL world with two ranks on one device; and ``torchrun`` launches on
the CPU (2x2, one process per rank, gloo) of ``miniapp_cholesky`` and of
the eigensolver pipeline's miniapps (HEGST, reduction to band, the
generalized eigensolver, the chase back-transform).

The retry test also holds the reference's ``dlaf_retry_total`` counter
of the observability layer, and that a ``%r`` metrics path resolves to
the process rank once the world is up.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from dlaf_tpu_torch import config, obs
from dlaf_tpu_torch.comm import collectives as cc
from dlaf_tpu_torch.comm import multihost
from dlaf_tpu_torch.health import policy as hpolicy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass(frozen=True)
class FakeEntry:
    rank: int
    node: str


def test_layout_slice_aware():
    """The column axis stays inside one node where the node's process count
    factors over it; node-major ordering otherwise (reference
    ``test_multihost_layout_slice_aware``)."""
    # 2 nodes x 4 processes, grid 4x2: each row's 2 columns inside one node
    ents = [FakeEntry(i, f"n{i // 4}") for i in range(8)]
    assert set(map(len, multihost.slice_groups(ents).values())) == {4}
    out = multihost.layout_2d(ents, 4, 2)
    assert out.shape == (4, 2)
    for r in range(4):
        assert len({e.node for e in out[r]}) == 1, [e.node for e in out[r]]
    # grid 2x4: cols == per-node -> each row IS one node
    out2 = multihost.layout_2d(ents, 2, 4)
    for r in range(2):
        assert len({e.node for e in out2[r]}) == 1
    # one node: a plain reshape keeps the process order
    flat = [FakeEntry(i, "n0") for i in range(8)]
    assert [e.rank for e in multihost.layout_2d(flat, 2, 4).ravel()] == list(range(8))
    # 3 nodes of 4, grid 4x3: neither count divides the other -> entry
    # order, still every process once
    ents12 = [FakeEntry(i, f"n{i // 4}") for i in range(12)]
    out4 = multihost.layout_2d(ents12, 4, 3)
    assert sorted(e.rank for e in out4.ravel()) == list(range(12))
    # interleaved nodes are made node-major
    mixed = [FakeEntry(i, f"n{i % 2}") for i in range(8)]
    out5 = multihost.layout_2d(mixed, 4, 2)
    for r in range(4):
        assert len({e.node for e in out5[r]}) == 1
    with pytest.raises(Exception, match="must use all 8"):
        multihost.layout_2d(ents, 3, 2)


def test_squarest_grid():
    assert [multihost._squarest(n) for n in (1, 4, 6, 8, 12, 7)] == [
        (1, 1), (2, 2), (2, 3), (2, 4), (3, 4), (1, 7)]


def test_initialize_multihost_single_process_noop(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)

    def boom(**kw):
        raise AssertionError("a single-process world must not connect")

    monkeypatch.setattr(dist, "init_process_group", boom)
    multihost.initialize_multihost()
    multihost.initialize_multihost(None, num_processes=1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    multihost.initialize_multihost()
    assert multihost.process_info() == (0, 1)
    assert cc.world() is None


def test_multihost_timeout_actionable_error(monkeypatch):
    seen = {}

    def fake_init(backend=None, init_method=None, world_size=None, rank=None, timeout=None):
        seen.update(backend=backend, init_method=init_method, timeout=timeout)
        raise TimeoutError("deadline exceeded waiting for coordinator")

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    with pytest.raises(RuntimeError) as ei:
        multihost.initialize_multihost("10.0.0.1:8476", num_processes=4, process_id=1,
                                       backend="gloo", timeout=5, connect_attempts=1)
    msg = str(ei.value)
    assert "10.0.0.1:8476" in msg and "timeout=5s" in msg
    assert "firewall" in msg and "SAME" in msg and "4 process(es)" in msg
    assert seen["timeout"].total_seconds() == 5
    assert seen["init_method"] == "tcp://10.0.0.1:8476" and seen["backend"] == "gloo"


@pytest.fixture
def metrics_on(tmp_path, monkeypatch):
    """The obs layer recording into a ``%r`` path; reset afterwards (the
    pinned rank must not leak into later tests)."""
    monkeypatch.setenv("DLAF_METRICS_PATH", str(tmp_path / "run.%r.jsonl"))
    config.initialize()
    yield tmp_path
    monkeypatch.delenv("DLAF_METRICS_PATH")
    obs._reset_for_tests()
    config.initialize()


def test_multihost_connect_retries_transient_failures(monkeypatch, metrics_on):
    """A transient bring-up failure retries with backoff and the world
    comes up on a later attempt, each retry counted once
    (``dlaf_retry_total{site="multihost.connect"}``, the reference's
    assertion), and the ``%r`` metrics path then names the process rank; a
    caller bug raises at once with its own message (never retried)."""
    calls = []

    def flaky_init(**kw):
        calls.append(kw)
        if len(calls) < 3:
            raise ConnectionError("connection refused")

    slept = []
    monkeypatch.setattr(dist, "init_process_group", flaky_init)
    monkeypatch.setattr(hpolicy.time, "sleep", slept.append)
    multihost.initialize_multihost("file:///tmp/x", num_processes=4, process_id=1,
                                   backend="gloo", connect_attempts=3, connect_backoff_s=0.25)
    assert len(calls) == 3 and len(slept) == 2
    assert slept[0] < slept[1]           # exponential backoff
    assert calls[0]["init_method"] == "file:///tmp/x" and calls[0]["rank"] == 1
    assert obs.registry().counter("dlaf_retry_total",
                                  site="multihost.connect").snapshot()["value"] == 2
    assert obs.current_rank() == 1
    assert obs.STATE.sink.path == str(metrics_on / "run.1.jsonl")
    obs.flush()
    assert obs.validate_file(str(metrics_on / "run.1.jsonl")) == []
    assert {r.get("rank") for r in obs.read_records(str(metrics_on / "run.1.jsonl"))} == {1}

    calls.clear()

    def buggy_init(**kw):
        calls.append(1)
        raise ValueError("trying to initialize the default process group twice!")

    monkeypatch.setattr(dist, "init_process_group", buggy_init)
    with pytest.raises(ValueError, match="twice"):
        multihost.initialize_multihost("10.0.0.1:8476", num_processes=4, process_id=1,
                                       backend="gloo")
    assert len(calls) == 1               # caller bugs are never retried


def test_torchrun_env_world(monkeypatch):
    """With no arguments and ``WORLD_SIZE > 1`` the world is read from the
    environment (``env://``)."""
    seen = {}
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: seen.update(kw))
    multihost.initialize_multihost(backend="gloo")
    assert seen["init_method"] == "env://" and seen["world_size"] == 4
    assert "rank" not in seen


def test_nccl_refuses_two_ranks_on_one_device():
    with pytest.raises(ValueError, match='backend="gloo"'):
        multihost.refuse_shared_nccl([("h", "cuda:0"), ("h", "cuda:0")])
    with pytest.raises(ValueError, match='backend="gloo"'):
        multihost.refuse_shared_nccl([("h", "cpu"), ("h", "cpu")])
    multihost.refuse_shared_nccl([("h", "cuda:0"), ("h", "cuda:1"), ("g", "cuda:0")])


def test_grid_of_the_multi_process_form_is_not_a_single_controller():
    """Without a world the grid constructor builds the single controller,
    whose every rank is local."""
    from dlaf_tpu_torch.comm.grid import shared_grid

    g = shared_grid(2, 3, "cpu")
    assert not g.multi_process and len(g.local_ranks) == 6 and g.is_local(1, 2)


def test_torchrun_miniapp_cholesky_on_cpu(tmp_path):
    """``torchrun`` launches 4 processes of ``miniapp_cholesky`` on a 2x2
    grid on the CPU (gloo): ``check: PASSED`` once (process 0 prints), and
    every process exits 0. With ``DLAF_METRICS_PATH=run.%r.jsonl`` each
    process writes its own artifact, valid, stamped with its rank and
    carrying its collectives' byte counters."""
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           "GLOO_SOCKET_IFNAME": "lo", "TMPDIR": str(tmp_path),
           "DLAF_METRICS_PATH": str(tmp_path / "run.%r.jsonl")}
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "dlaf_tpu_torch.miniapp.miniapp_cholesky", "--backend", "cpu",
         "--grid-rows", "2", "--grid-cols", "2", "--share-device", "-m", "72", "-b", "16",
         "--type", "s", "--check-result", "last"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("check: PASSED") == 1, out.stdout
    assert out.stdout.count("GFlop/s sL (72, 72) (16, 16) (2, 2)") == 1, out.stdout
    assert sorted(p.name for p in tmp_path.glob("run.*.jsonl")) == \
        [f"run.{r}.jsonl" for r in range(4)]
    for r in range(4):
        path = str(tmp_path / f"run.{r}.jsonl")
        assert obs.validate_file(path, require_spans=True, require_gflops=True,
                                 require_collectives=True) == [], r
        assert {rec.get("rank") for rec in obs.read_records(path)} == {r}


@pytest.mark.parametrize("app,args,line", [
    ("miniapp_gen_to_std", ("-m", "48", "-b", "8", "--type", "z"), "zL (48, 48) (8, 8) (2, 2)"),
    ("miniapp_reduction_to_band", ("-m", "72", "-b", "16", "--band-size", "4", "--type", "d"),
     "dL (72, 72) (16, 16) (2, 2)"),
    ("miniapp_gen_eigensolver", ("-m", "72", "-b", "16", "--type", "z", "--uplo", "U"),
     "zU gen_evp (72, 72) (16, 16) (2, 2)"),
    ("miniapp_bt_band_to_tridiag", ("-m", "80", "-b", "8", "--type", "d"),
     "d (80, 80) band=8 (2, 2)"),
])
def test_torchrun_eigensolver_miniapps_on_cpu(tmp_path, app, args, line):
    """``torchrun`` runs the eigensolver pipeline's miniapps with one
    process per rank of a 2x2 grid on the CPU (gloo): one run line (process
    0), one ``check: PASSED`` (rank (0, 0)'s process), every process exits
    0."""
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           "GLOO_SOCKET_IFNAME": "lo", "TMPDIR": str(tmp_path)}
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", f"dlaf_tpu_torch.miniapp.{app}", "--backend", "cpu", "--grid-rows", "2",
         "--grid-cols", "2", "--share-device", *args, "--check-result", "last"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("check: PASSED") == 1, out.stdout
    assert out.stdout.count(line) == 1, out.stdout
