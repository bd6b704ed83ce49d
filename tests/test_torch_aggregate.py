"""The port's artifact merger (``dlaf_tpu_torch/obs/aggregate.py``) against
the JAX reference's (``dlaf_tpu/obs/aggregate.py``), on the port's own
artifacts.

The artifacts, written once for the module: a ``torchrun`` 2x2
``--share-device`` Cholesky on the CPU with ``%r`` shards (one per process,
with accuracy and autotune records); a serve stream through ``serve.Queue``
with program telemetry and the per-request accuracy records; and a fleet
drill (a router and two in-process workers, one killed, its tickets
redispatched). Each set goes through both packages' ``main``: the printed
tables, the ``-o`` merged JSONL, ``--chrome``, ``--align``, ``--trace``
and ``--top-slow`` are equal, byte for byte. So are ``infer_rank`` and
``UNRESOLVED_RANK_BASE``, and the exit codes of the usage errors.

No field differs on purpose between the two merges: both read the same
records, and a record's own fields (its ``platform``, ``cuda`` or ``cpu``
in the port) pass through both unchanged.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from dlaf_tpu.obs import aggregate as jagg
from dlaf_tpu_torch import config, health, obs
from dlaf_tpu_torch.fleet import Router, connect_worker
from dlaf_tpu_torch.obs import aggregate as pagg
from dlaf_tpu_torch.serve import ProgramService, Queue, Request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _in_process_artifact(path, body, **cfg):
    """Run ``body()`` with the port's records going to ``path``."""
    config.initialize(config.Configuration(metrics_path=path, log="off", **cfg))
    try:
        body()
        obs.flush()
    finally:
        obs._reset_for_tests()
        health.circuit.reset()
        config.initialize()


def _hpd(n, seed):
    x = np.random.default_rng(seed).standard_normal((n, n))
    return x @ x.T + n * np.eye(n)


def _serve_stream():
    q = Queue(ProgramService(device="cpu"), batch=4, deadline_s=1e9, buckets=(16, 32))
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(14):
        n = int(rng.integers(5, 33))
        if i % 3 == 2:
            reqs.append(Request(op="solve", a=np.eye(n) + np.tril(rng.standard_normal((n, n)), -1)
                                / n, b=rng.standard_normal((n, 2))))
        else:
            reqs.append(Request(op="cholesky", a=_hpd(n, i)))
    q.warmup(reqs)
    tickets = [q.submit(r) for r in reqs]
    q.flush()
    assert all(t.done for t in tickets)


class _Clock:
    t = 0.0

    def __call__(self):
        return self.t


def _fleet_drill():
    router = Router(clock=_Clock(), port=0)
    svc = ProgramService(device="cpu")
    workers = []
    for k in range(2):
        w = connect_worker(router.port, k, idle_tick_s=0.01,
                           queue=Queue(svc, batch=8, deadline_s=1e9, buckets=(16,)))
        threading.Thread(target=w.serve, daemon=True).start()
        workers.append(w)
    try:
        deadline = time.monotonic() + 10
        while len(router.stats()["workers"]) < 2:
            assert time.monotonic() < deadline
            router.poll()
            time.sleep(0.005)
        tickets = [router.submit(Request(op="cholesky", a=_hpd(12, i))) for i in range(3)]
        victim = tickets[0].worker
        workers[victim].kill()
        while router.stats()["workers"][victim]["state"] != "dead":
            assert time.monotonic() < deadline + 10
            router.poll()
            time.sleep(0.005)
        router.flush()
        assert router.join(tickets, timeout_s=60)
        assert router.stats()["redispatches"] == 3
    finally:
        router.close()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("agg")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo",
           "TMPDIR": str(d), "DLAF_LOG": "off", "DLAF_METRICS_PATH": str(d / "chol.r%r.jsonl"),
           "DLAF_ACCURACY": "1", "DLAF_AUTOTUNE": "1"}
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "dlaf_tpu_torch.miniapp.miniapp_cholesky", "--backend", "cpu", "--grid-rows", "2",
         "--grid-cols", "2", "--share-device", "-m", "72", "-b", "16", "--type", "d",
         "--nruns", "4", "--check-result", "last"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    shards = [str(d / f"chol.r{r}.jsonl") for r in range(4)]
    serve = str(d / "serve.jsonl")
    _in_process_artifact(serve, _serve_stream, accuracy="1", program_telemetry=True)
    fleet = str(d / "fleet.jsonl")
    _in_process_artifact(fleet, _fleet_drill)
    return {"dir": d, "shards": shards, "serve": serve, "fleet": fleet}


def _run(main, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(args))
    return rc, buf.getvalue()


def _both(args, outputs=()):
    """(rc, stdout, {output: bytes}) of each package's main on ``args``."""
    got = []
    for main in (pagg.main, jagg.main):
        for path in outputs:
            if os.path.exists(path):
                os.remove(path)
        rc, text = _run(main, args)
        files = {}
        for path in outputs:
            with open(path, "rb") as f:
                files[path] = f.read()
        got.append((rc, text, files))
    return got


SETS = {
    "shards": lambda a: a["shards"],
    "serve": lambda a: [a["serve"]],
    "fleet": lambda a: [a["fleet"]],
    "all": lambda a: a["shards"] + [a["serve"], a["fleet"]],
}


@pytest.mark.parametrize("flags", [(), ("--align",), ("--top", "3")],
                         ids=["plain", "align", "top3"])
@pytest.mark.parametrize("which", list(SETS))
def test_merge_tables_and_outputs_are_the_references(artifacts, which, flags):
    paths = SETS[which](artifacts)
    merged = str(artifacts["dir"] / "merged.jsonl")
    chrome = str(artifacts["dir"] / "chrome.json")
    port, ref = _both([*paths, "-o", merged, "--chrome", chrome, *flags], (merged, chrome))
    assert port[0] == ref[0] == 0
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    text = port[1]
    assert "== merged " in text
    records = [json.loads(line) for line in port[2][merged].splitlines()]
    assert records == sorted(records, key=lambda r: r.get("ts") or 0.0)
    assert len(json.loads(port[2][chrome])["traceEvents"]) > 0
    if which in ("shards", "all"):
        assert "== per-rank span skew ==" in text and "== collective imbalance" in text
        assert "== accuracy" in text and "== autotune decision trail" in text
        assert {r["rank"] for r in records} >= {0, 1, 2, 3}


def test_shard_ranks_and_positions(artifacts):
    records = pagg.merge_artifacts(artifacts["shards"] + [artifacts["serve"]])
    ranks = {r["rank"] for r in records}
    # the shards carry their ranks; the serve artifact (no rank field, no
    # r<N> in its name) takes its argument position
    assert ranks == {0, 1, 2, 3, 4}
    assert records == jagg.merge_artifacts(artifacts["shards"] + [artifacts["serve"]])


def _trace_ids(path, event):
    return [r["trace_id"] for r in obs.read_records(path)
            if r.get("type") == "fleet" and r.get("event") == event]


def test_trace_join_is_the_references(artifacts):
    fleet = artifacts["fleet"]
    tid = _trace_ids(fleet, "redispatch")[0]
    port, ref = _both([fleet, artifacts["serve"], "--trace", tid])
    assert port == ref and port[0] == 0
    text = port[1]
    assert f"== trace {tid}:" in text
    for kind in ("route", "redispatch", "request"):
        assert kind in text, (kind, text)
    assert "  queue wait" in text         # the request's waterfall


def test_trace_of_a_serve_request_is_the_references(artifacts):
    serve = artifacts["serve"]
    tid = next(r["trace_id"] for r in obs.read_records(serve)
               if r.get("type") == "serve" and r.get("event") == "request")
    port, ref = _both([serve, "--trace", tid])
    assert port == ref and port[0] == 0 and "program" in port[1]


def test_top_slow_is_the_references(artifacts):
    port, ref = _both([artifacts["serve"], artifacts["fleet"], "--top-slow", "5"])
    assert port == ref and port[0] == 0
    assert "== top 5 slowest requests" in port[1] and "trace " in port[1]


@pytest.mark.parametrize("args", [
    ("--trace",), ("--top-slow", "0"), ("--top-slow", "x"), ("--bogus",), ("-o",), (),
], ids=["trace-no-id", "top-slow-0", "top-slow-nan", "unknown-flag", "o-no-path", "no-paths"])
def test_usage_errors_are_the_references(artifacts, args, capsys):
    paths = () if args == () else (artifacts["serve"],)
    assert pagg.main([*paths, *args]) == jagg.main([*paths, *args]) == 2


def test_failures_are_the_references(artifacts, tmp_path, capsys):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    bad = tmp_path / "bad.jsonl"
    bad.write_text("{not json\n")
    for args in ([str(empty)], [str(bad)], [str(tmp_path / "missing.jsonl")],
                 [artifacts["serve"], "--trace", "0123456789abcdef"],
                 [artifacts["shards"][0], "--top-slow", "3"]):
        assert pagg.main(args) == jagg.main(args) == 1, args


@pytest.mark.parametrize("name", [
    "run.r3.jsonl", "art.r12.jsonl", "x-r0-y.jsonl", "run.u4242.jsonl", "run.ru77.jsonl",
    "router.jsonl", "rank.jsonl", "r7", "ur5.jsonl",
])
def test_infer_rank_is_the_references(name):
    for pos in (0, 5):
        assert pagg.infer_rank(f"/tmp/{name}", pos) == jagg.infer_rank(f"/tmp/{name}", pos)
    assert pagg.UNRESOLVED_RANK_BASE == jagg.UNRESOLVED_RANK_BASE == 1_000_000


def test_unresolved_placeholder_stays_a_separate_row(artifacts, tmp_path):
    odd = tmp_path / "chol.u999.jsonl"
    lines = [{k: v for k, v in r.items() if k != "rank"}
             for r in obs.read_records(artifacts["shards"][1])]
    odd.write_text("".join(json.dumps(r) + "\n" for r in lines))
    records = pagg.merge_artifacts([str(odd)])
    assert {r["rank"] for r in records} == {pagg.UNRESOLVED_RANK_BASE + 999}
    assert records == jagg.merge_artifacts([str(odd)])


def test_rebase_and_overlap_are_the_references(artifacts):
    records = pagg.merge_artifacts(artifacts["shards"])
    rebased = pagg.rebase_per_rank(records)
    assert rebased == jagg.rebase_per_rank(records)
    assert pagg.overlap_report(rebased) == jagg.overlap_report(rebased)
    assert pagg.chrome_trace(rebased) == jagg.chrome_trace(rebased)
    assert pagg.collective_imbalance(records) == jagg.collective_imbalance(records)
    assert pagg.devtrace_rows(records) == jagg.devtrace_rows(records) == []
