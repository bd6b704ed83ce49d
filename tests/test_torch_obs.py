"""The port's telemetry core (``dlaf_tpu_torch/obs``) against the
reference's (``dlaf_tpu/obs``), on the CPU.

* The same operations fed to both registries give byte-identical
  Prometheus exposition; ``quantile``/``quantiles`` equal the reference's
  and numpy's.
* With every knob off each instrumented site is the no-op singleton, and
  an algorithm run records nothing; with metrics on and no trace
  directory the per-step phases still enter nothing.
* Spans (nesting, GFlop/s only when fenced, lazy entry attrs), the log
  levels and ``warning_once``, the validator and its CLI's exit codes,
  ``PhaseTimer``'s spans and its profiler ownership: the reference's
  semantic cases (``tests/test_obs.py``) re-run against the port.
* The miniapp's artifacts (one rank, and a 2x2 grid with the comm
  look-ahead) pass the port's and the reference's validators.
* After ONE fresh call, the collective, step and tile-op counters and the
  entry spans (names, attr keys, flops) equal the reference's after one
  fresh trace of the same builder. The port counts per call, the
  reference per traced program, so they agree on a first call only.
* With a trace directory the distributed Cholesky's step phases name the
  ``torch.profiler`` timeline.
"""

import functools
import gc
import importlib
import json
import math
import os

import numpy as np
import pytest

import jax
from dlaf_tpu import config as jcfg
from dlaf_tpu import obs as jobs
from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu.common.index2d import RankIndex2D as JRankIndex2D
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu.obs import sinks as jsinks
from dlaf_tpu_torch import config, obs
from dlaf_tpu_torch.algorithms.cholesky import cholesky
from dlaf_tpu_torch.algorithms.triangular import triangular_solve
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import RankIndex2D, TileElementSize
from dlaf_tpu_torch.common.timer import PhaseTimer
from dlaf_tpu_torch.eigensolver.eigensolver import eigensolver
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.obs import metrics as pmetrics
from dlaf_tpu_torch.obs._state import STATE

jchol = importlib.import_module("dlaf_tpu.algorithms.cholesky")
jtri = importlib.import_module("dlaf_tpu.algorithms.triangular")
jev = importlib.import_module("dlaf_tpu.eigensolver.eigensolver")
jmetrics = importlib.import_module("dlaf_tpu.obs.metrics")

KNOBS = ("METRICS_PATH", "TRACE_DIR", "LOG", "CHOLESKY_TRAILING", "CHOLESKY_LOOKAHEAD",
         "COMM_LOOKAHEAD", "DIST_STEP_MODE", "PANEL_IMPL", "STEP_IMPL")


@pytest.fixture(autouse=True)
def reset(monkeypatch):
    """Every test starts and ends with both layers unconfigured."""
    for k in KNOBS:
        monkeypatch.delenv("DLAF_" + k, raising=False)
    obs._reset_for_tests()
    config.initialize()
    yield
    for k in KNOBS:
        monkeypatch.delenv("DLAF_" + k, raising=False)
    obs._reset_for_tests()
    config.initialize()
    jobs._reset_for_tests()
    jcfg.finalize()
    jcfg.initialize()


def metrics_on(tmp_path, name="obs.jsonl", **cfg):
    path = str(tmp_path / name)
    config.initialize(config.Configuration(metrics_path=path, **cfg))
    return path


# ---------------------------------------------------------------------------
# the registry and its exposition, byte for byte
# ---------------------------------------------------------------------------

def _feed(mod, reg, ops):
    """Apply the op list to ``reg`` (a registry of ``mod``'s package)."""
    ctx = importlib.import_module(mod.__name__.rsplit(".", 1)[0] + ".context")
    for kind, name, labels, value, tid in ops:
        if kind == "counter":
            reg.counter(name, **labels).inc(value)
        elif kind == "gauge":
            reg.gauge(name, **labels).set(value)
        else:
            bounds = (0.001, 0.1, 1.0) if name.endswith("custom") else None
            h = reg.histogram(name, bounds=bounds, **labels)
            with ctx.trace_context(trace_id=tid):
                h.observe(value)


def _ops(seed):
    rng = np.random.default_rng(seed)
    names = {"counter": ["dlaf_comm_collective_bytes_total", "dlaf_retry_total"],
             "gauge": ["dlaf_serve_depth", "dlaf_circuit_state"],
             "histogram": ["dlaf_span_seconds", "lat_custom"]}
    label_vals = ["row", "col", 'a\\b"c', "two\nlines", "0.5"]
    ops = []
    for _ in range(60):
        kind = ["counter", "gauge", "histogram"][rng.integers(3)]
        labels = {k: label_vals[rng.integers(len(label_vals))]
                  for k in ("axis", "kind")[:rng.integers(3)]}
        value = (int(rng.integers(1, 5000)) if rng.random() < 0.5
                 else float(rng.exponential() * 10.0 ** rng.integers(-7, 4)))
        tid = ["aabbccdd00112233", ["t1", "t2"], None][rng.integers(3)]
        ops.append((kind, names[kind][rng.integers(2)], labels, value, tid))
    return ops


@pytest.mark.parametrize("exemplars", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_byte_identical_to_reference(seed, exemplars):
    ops = _ops(seed)
    preg, jreg = pmetrics.Registry(), jmetrics.Registry()
    _feed(pmetrics, preg, ops)
    _feed(jmetrics, jreg, ops)
    ptext = pmetrics.prometheus_text(preg.snapshot(), exemplars=exemplars)
    assert ptext == jmetrics.prometheus_text(jreg.snapshot(), exemplars=exemplars)
    assert ptext.count("# TYPE") >= 3
    assert (" # {trace_id=" in ptext) == exemplars


@pytest.mark.parametrize("size", [1, 2, 3, 7, 64, 100])
def test_quantiles_match_reference_and_numpy(size):
    vals = np.random.default_rng(size).exponential(size=size).tolist()
    qs = [0.0, 0.123, 0.5, 0.95, 0.99, 1.0]
    for q in qs:
        got = pmetrics.quantile(vals, q)
        assert got == jmetrics.quantile(vals, q) == float(np.quantile(vals, q))
    assert pmetrics.quantiles(vals, qs) == jmetrics.quantiles(vals, qs)
    assert math.isnan(pmetrics.quantile([], 0.5))
    with pytest.raises(ValueError):
        pmetrics.quantile([1.0], 1.5)


def test_registry_semantics():
    reg = obs.Registry()
    c = reg.counter("hits", kind="bcast", axis="row")
    c.inc()
    c.inc(41)
    assert reg.counter("hits", kind="bcast", axis="row") is c
    assert reg.counter("hits", kind="bcast", axis="col") is not c
    reg.gauge("depth").set(3)
    reg.gauge("depth").set(7.5)
    h = reg.histogram("lat", bounds=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    snap = {m["name"]: m for m in reg.snapshot() if not m["labels"]}
    assert snap["depth"]["value"] == 7.5
    assert snap["lat"]["buckets"] == [[0.1, 1], [1.0, 3], [10.0, 4], ["+Inf", 5]]
    assert snap["lat"]["count"] == 5 and snap["lat"]["min"] == 0.05
    assert c.value == 42.0


# ---------------------------------------------------------------------------
# the no-op fast path
# ---------------------------------------------------------------------------

class _Unformattable:
    """A step index that fails when a name is formatted from it."""

    def __index__(self):
        raise AssertionError("a step name was formatted with no profiler armed")

    __int__ = __index__


def test_noop_fast_path_when_disabled(tmp_path):
    """With every knob off each site is the module-level singleton, the
    lazy attrs are never built, and a distributed Cholesky and a solve
    record nothing."""
    assert not obs.enabled() and not obs.metrics_active()
    calls = []
    assert obs.span("a", flops=1.0, n=5) is obs.NOOP_SPAN
    assert obs.entry_span("algo", lambda: calls.append(1)) is obs.NOOP_SPAN
    assert obs.named_span("c") is obs.NOOP_CTX
    assert obs.named_span("c.step%03d.panel", _Unformattable()) is obs.NOOP_CTX
    assert obs.counter("x", k="v") is obs.NOOP_COUNTER
    assert obs.gauge("y") is obs.NOOP_GAUGE
    assert obs.histogram("z") is obs.NOOP_HISTOGRAM
    assert obs.histogram("z").windowed() is obs.NOOP_WINDOW

    def fn():
        return 1

    assert obs.scoped_step("s", fn) is fn
    assert calls == []
    with obs.span("a") as sp:
        sp.set_attr("k", 1)
    obs.counter("x").inc(3)
    obs.observe_latency("op", 0.5)
    assert obs.prometheus_snapshot_text() == ""
    a = _hpd(40, np.float64)
    cholesky("L", _pmat(a, 2, 2, 8))
    triangular_solve("L", "L", "N", "N", 1.0, _pmat(a, 2, 2, 8), _pmat(a[:, :9], 2, 2, 8))
    assert STATE.registry is None and STATE.sink is None and not STATE.profiler_started
    assert list(tmp_path.iterdir()) == []
    # metrics on, no trace directory: the step phases still enter nothing
    metrics_on(tmp_path)
    assert obs.named_span("cholesky.step000.panel") is obs.NOOP_CTX
    assert obs.named_span("cholesky.step%03d.panel", _Unformattable()) is obs.NOOP_CTX
    assert obs.scoped_step("s", fn) is fn


# ---------------------------------------------------------------------------
# spans, logs
# ---------------------------------------------------------------------------

def test_span_nesting_and_reentrancy(tmp_path):
    path = metrics_on(tmp_path)
    with obs.span("outer", n=1):
        with obs.span("inner"):
            with obs.span("inner"):
                obs.current_span().set_attr("route", "mxu")
    with obs.span("outer"):
        pass
    recs = [r for r in obs.read_records(path) if r["type"] == "span"]
    assert [(r["name"], r["depth"], r["parent"]) for r in recs] == [
        ("inner", 2, "inner"), ("inner", 1, "outer"), ("outer", 0, None), ("outer", 0, None)]
    assert recs[0]["attrs"] == {"route": "mxu"} and recs[2]["attrs"] == {"n": 1}
    assert all(r["dur_s"] >= 0 and math.isfinite(r["dur_s"]) for r in recs)


@pytest.mark.parametrize("entry", [False, True])
def test_span_gflops_only_when_fenced(tmp_path, entry):
    """A fenced span derives GFlop/s from its flops; an entry span is
    unfenced, builds its attrs lazily, keeps the flops and derives none."""
    path = metrics_on(tmp_path)
    if entry:
        sp = obs.entry_span("algo", lambda: dict(flops=3e9, n=64))
    else:
        sp = obs.span("work", flops=3e9, n=64)
    with sp:
        pass
    rec = [r for r in obs.read_records(path) if r["type"] == "span"][0]
    assert rec["flops"] == 3e9 and rec["attrs"] == {"n": 64}
    if entry:
        assert rec["fenced"] is False and "gflops" not in rec
        assert obs.validate_file(path, require_gflops=True) != []
    else:
        assert rec["gflops"] == pytest.approx(3e9 / rec["dur_s"] / 1e9)
        assert obs.validate_file(path, require_spans=True, require_gflops=True) == []


def test_log_levels_warning_once_and_notices(capsys):
    config.initialize(config.Configuration(log="warning"))
    lg = obs.get_logger("lvl")
    lg.info("hidden")
    lg.warning("shown", a=1)
    err = capsys.readouterr().err
    assert "hidden" not in err and "dlaf_tpu_torch[warning] lvl: shown [a=1]" in err
    # suppressed one-shot keys stay unconsumed
    config.initialize(config.Configuration(log="error"))
    lg.warning_once("k", "notice")
    assert capsys.readouterr().err == ""
    config.initialize(config.Configuration(log="info"))
    for _ in range(3):
        lg.warning_once("k", "notice")
    lg.warning_once("k2", "second")
    err = capsys.readouterr().err
    assert err.count("notice") == 1 and err.count("second") == 1
    # the auto-knob notices go through the same logger: DLAF_LOG=off
    # silences them
    config.initialize(config.Configuration(log="off"))
    config.announce_once(("t_obs_knob", "cpu"), "t_obs_knob resolved")
    config.initialize(config.Configuration(log="info"))
    assert capsys.readouterr().err == ""
    with pytest.raises(ValueError):
        config.initialize(config.Configuration(log="loud"))


def test_bad_dlaf_log_env_is_lenient_on_lazy_path(monkeypatch, capsys):
    obs._reset_for_tests()
    monkeypatch.setenv("DLAF_LOG", "warn")
    obs.get_logger("lenient").info("still works")
    err = capsys.readouterr().err
    assert "DLAF_LOG='warn'" in err and "still works" in err
    with pytest.raises(ValueError):
        config.initialize()


# ---------------------------------------------------------------------------
# the validator and its CLI
# ---------------------------------------------------------------------------

def _span(**kw):
    return {"type": "span", "name": "x", "dur_s": 0.1, "depth": 0, "parent": None,
            "attrs": {}, **kw}


def test_validator_rejects_what_the_reference_rejects(tmp_path):
    path = str(tmp_path / "bad.jsonl")
    sink = obs.JsonlSink(path)
    for rec in (_span(dur_s=float("nan")), {k: v for k, v in _span().items() if k != "name"},
                _span(gflops=float("inf")), {"type": "mystery"},
                _span(fenced=False, gflops=99999.0), _span(rank=-1), _span(rank="r0"),
                _span(name="robust_cholesky.attempt", attrs={"attempt": 1}),
                {"type": "resilience", "site": "s", "event": "retry", "attrs": {}},
                {"type": "serve", "event": "request", "op": "cholesky", "dtype": "float64",
                 "bucket_n": 8, "n": 16, "queue_s": 0.0, "total_s": 0.0},
                {"type": "log", "level": "info", "logger": "x", "msg": "m", "trace_id": ""}):
        sink.write(rec)
    sink.close()
    errs = obs.validate_file(path)
    assert len(errs) == 12, errs
    assert errs == jsinks.validate_file(path)


@pytest.mark.parametrize("flag", ["spans", "gflops", "collectives", "retries",
                                  "comm-overlap", "serve", "resilience", "flight"])
def test_validate_cli_exit_codes(tmp_path, capsys, flag):
    from dlaf_tpu_torch.obs.validate import main

    empty = str(tmp_path / "empty.jsonl")
    open(empty, "w").close()
    assert main([empty]) == 0
    assert main([empty, f"--require-{flag}"]) == 1
    assert main([]) == 2 and main([empty, empty]) == 2
    assert main([empty, "--require-thing"]) == 2
    assert main([str(tmp_path / "missing.jsonl")]) == 1
    capsys.readouterr()


# ---------------------------------------------------------------------------
# PhaseTimer and the profiler's single owner
# ---------------------------------------------------------------------------

class FakeProfile:
    """Stands in for ``torch.profiler.profile``: counts starts, stops and
    exports."""
    calls = {"start": 0, "stop": 0, "export": 0}

    def __init__(self, **kw):
        self.kw = kw

    def start(self):
        FakeProfile.calls["start"] += 1

    def stop(self):
        FakeProfile.calls["stop"] += 1

    def export_chrome_trace(self, path):
        FakeProfile.calls["export"] += 1
        with open(path, "w") as f:
            f.write("{}")


@pytest.fixture
def fake_profiler(monkeypatch):
    import torch

    FakeProfile.calls = {"start": 0, "stop": 0, "export": 0}
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    return FakeProfile.calls


def test_phase_timer_emits_spans(tmp_path):
    path = metrics_on(tmp_path)
    pt = PhaseTimer()
    for _ in range(2):
        with pt.phase("stage_a", run=1):
            pass
    assert set(pt.report()) == {"stage_a"}
    names = [r["name"] for r in obs.read_records(path) if r["type"] == "span"]
    assert names == ["stage_a", "stage_a"]


def test_phase_timer_profiler_single_owner(tmp_path, fake_profiler, capsys):
    """A timer's profile_dir trace claims the one process-wide profiler:
    a trace_dir configured mid-phase starts no second one (and the
    timer warns that it is superseded); stop() ends it and writes the
    trace into the timer's directory."""
    pt = PhaseTimer(profile_dir=str(tmp_path / "timer_trace"))
    with pt.phase("stage_a"):
        config.initialize(config.Configuration(trace_dir=str(tmp_path / "obs_trace")))
        with obs.span("inner"):
            pass
    with pt.phase("stage_b"):
        pass
    assert fake_profiler["start"] == 1 and STATE.profiler_started
    assert "superseded by DLAF_TRACE_DIR" in capsys.readouterr().err
    out = pt.stop()
    assert fake_profiler == {"start": 1, "stop": 1, "export": 1}
    assert not STATE.profiler_started and os.path.dirname(out) == str(tmp_path / "timer_trace")


def test_stopped_profiler_does_not_restart(tmp_path, fake_profiler):
    config.initialize(config.Configuration(trace_dir=str(tmp_path / "t")))
    with obs.span("a"):
        with obs.named_span("a.step"):
            pass
    assert fake_profiler["start"] == 1
    out = obs.stop_profiler()
    assert fake_profiler["stop"] == 1 and os.path.exists(out)
    with obs.span("b"):
        pass
    assert fake_profiler["start"] == 1 and obs.named_span("c") is obs.NOOP_CTX


def test_step_phases_name_the_profiler_timeline(tmp_path):
    """With a trace directory the distributed Cholesky's per-step phases
    are ``record_function`` ranges: the Chrome trace holds
    ``cholesky.step<k>.panel|strip|bulk`` once per step."""
    config.initialize(config.Configuration(trace_dir=str(tmp_path / "trace")))
    nt = 5
    cholesky("L", _pmat(_hpd(40, np.float32), 2, 2, 8))
    out = obs.stop_profiler()
    names = [e.get("name") for e in json.load(open(out))["traceEvents"]]
    for k in range(nt):
        for phase in ("panel", "strip", "bulk"):
            assert names.count(f"cholesky.step{k:03d}.{phase}") == 1, (k, phase)
    assert names.count("cholesky") == 1


# ---------------------------------------------------------------------------
# the miniapp's artifact under both validators
# ---------------------------------------------------------------------------

def _both_valid(path, **require):
    records = obs.read_records(path)
    assert obs.validate_records(records, **require) == []
    assert jsinks.validate_records(records, **require) == []
    return records


@pytest.mark.parametrize("grid", ["1x1", "2x2"])
def test_miniapp_cholesky_artifact_passes_both_validators(tmp_path, monkeypatch, grid):
    from dlaf_tpu_torch.miniapp.miniapp_cholesky import run

    path = str(tmp_path / "mc.jsonl")
    monkeypatch.setenv("DLAF_METRICS_PATH", path)
    args = ["-m", "64", "-b", "16", "--type", "d", "--backend", "cpu", "--nruns", "2"]
    if grid == "2x2":
        args += ["--grid-rows", "2", "--grid-cols", "2", "--share-device",
                 "--dlaf:cholesky-lookahead=1", "--dlaf:comm-lookahead=1"]
    results = run(args)
    require = dict(require_spans=True, require_gflops=True)
    if grid == "2x2":
        require.update(require_collectives=True, require_comm_overlap=True)
    records = _both_valid(path, **require)
    runs = [r for r in records if r["type"] == "span" and r["name"] == "miniapp_cholesky.run"]
    timed = [r for r in runs if not r["attrs"]["warmup"]]
    assert len(timed) == 2 and all(r["attrs"]["grid"] == grid for r in runs)
    for r, res in zip(timed, results):
        # the span's rate and the printed one time the same fenced region
        assert r["gflops"] == pytest.approx(res["gflops"], rel=0.5)
    entry = [r for r in records if r["type"] == "span" and r["name"] == "cholesky"]
    assert len(entry) == len(runs) and all(r["fenced"] is False for r in entry)


# ---------------------------------------------------------------------------
# counters and entry spans after one fresh call, against one fresh trace
# ---------------------------------------------------------------------------

COUNTED = ("dlaf_comm_collective_count_total", "dlaf_comm_collective_bytes_total",
           "dlaf_cholesky_steps_total", "dlaf_algo_tile_ops_total",
           "dlaf_comm_overlapped_total", "dlaf_dc_merges_total")

#: The port's own verbs (the reference has no counterpart kinds): the
#: band's gather to rank (0, 0) and the mirror tiles' exchange.
PORT_KINDS = ("scatter", "gather", "exchange", "bcast_arrays")


def _hpd(n, dtype, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    return (x @ x.T + n * np.eye(n)).astype(dtype)


def _pmat(a, P, Q, nb):
    if P * Q == 1:
        return Matrix.from_global(a, TileElementSize(nb, nb), device="cpu")
    return Matrix.from_global(a, TileElementSize(nb, nb), shared_grid(P, Q, "cpu"),
                              source_rank=RankIndex2D(0, 0))


def _jmat(a, P, Q, nb, devices8):
    if P * Q == 1:
        return JMatrix.from_global(a, JTileElementSize(nb, nb))
    return JMatrix.from_global(a, JTileElementSize(nb, nb),
                               JGrid(P, Q, devices=devices8[:P * Q]),
                               source_rank=JRankIndex2D(0, 0))


def _fresh_reference():
    """Drop every compiled program of the reference, so its next call
    traces (and counts) afresh."""
    jcfg._clear_program_caches()
    jax.clear_caches()
    for o in gc.get_objects():
        if type(o) is functools._lru_cache_wrapper and \
                str(getattr(o, "__module__", "")).startswith("dlaf_tpu."):
            o.cache_clear()


def _counters(snapshot):
    return {(m["name"], tuple(sorted(m["labels"].items()))): m["value"]
            for m in snapshot if m["name"] in COUNTED
            and m["labels"].get("kind") not in PORT_KINDS}


def _entries(path):
    return sorted((r["name"], tuple(sorted(r["attrs"])), r.get("flops"))
                  for r in obs.read_records(path)
                  if r["type"] == "span" and r.get("fenced") is False)


def _solve(side_uplo_op, a, b):
    side, uplo, op = side_uplo_op
    return lambda m: (side, uplo, op, "N", 0.5, m(a), m(b if side == "L" else b.T.copy()))


CASES = {
    "chol-local-la": dict(knobs={"cholesky_lookahead": 1}, dtype=np.float64, run="chol",
                          grid=(1, 1)),
    "chol-local-scan": dict(knobs={"cholesky_trailing": "scan"}, dtype=np.float64, run="chol",
                            grid=(1, 1)),
    "chol-s": dict(knobs={}, dtype=np.float32, run="chol"),
    "chol-d-la": dict(knobs={"cholesky_lookahead": 1, "comm_lookahead": 1},
                      dtype=np.float64, run="chol"),
    "trsm-LLN": dict(knobs={"dist_step_mode": "unrolled"}, dtype=np.float64, run="LLN"),
    "trsm-RUC": dict(knobs={"dist_step_mode": "unrolled"}, dtype=np.float64, run="RUC"),
    "evp": dict(knobs={}, dtype=np.float64, run="evp"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_counters_and_entry_spans_match_reference_after_one_fresh_call(
        name, tmp_path, monkeypatch, devices8):
    case = CASES[name]
    for k, v in case["knobs"].items():
        monkeypatch.setenv("DLAF_" + k.upper(), str(v))
    (P, Q), n, nb = case.get("grid", (2, 2)), 40, 8
    rng = np.random.default_rng(5)
    if case["run"] == "chol":
        a = _hpd(n, case["dtype"])
        args = lambda m: ("L", m(a))                       # noqa: E731
        pfn, jfn = cholesky, jchol.cholesky
    elif case["run"] == "evp":
        h = rng.standard_normal((n, n))
        args = lambda m: ("L", m(h + h.T))                 # noqa: E731
        pfn = functools.partial(eigensolver, band_size=4)
        jfn = functools.partial(jev.eigensolver, band_size=4)
    else:
        a = rng.standard_normal((n, n)) + 2 * n * np.eye(n)
        args = _solve(case["run"], a, rng.standard_normal((n, 19)))
        pfn, jfn = triangular_solve, jtri.triangular_solve
    ppath, jpath = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    monkeypatch.setenv("DLAF_LOG", "off")
    config.initialize(config.Configuration(metrics_path=ppath))
    jcfg.initialize(jcfg.Configuration(metrics_path=jpath))
    _fresh_reference()
    jargs = args(lambda x: _jmat(x, P, Q, nb, devices8))
    jobs.registry().clear()
    jfn(*jargs)
    pargs = args(lambda x: _pmat(x, P, Q, nb))
    obs.registry().clear()
    pfn(*pargs)
    got, want = _counters(obs.registry().snapshot()), _counters(jobs.registry().snapshot())
    assert got == want
    assert any(k[0] == ("dlaf_comm_collective_bytes_total" if P * Q > 1
                        else "dlaf_cholesky_steps_total") for k in got)
    if name == "chol-d-la":
        assert any(k[0] == "dlaf_comm_overlapped_total" for k in got)
    if name == "evp":
        assert got[("dlaf_dc_merges_total", (("mode", "serialized"),))] > 0
    obs.flush()
    jobs.flush()
    assert _entries(ppath) == _entries(jpath)
