"""Program telemetry of the PyTorch port (``dlaf_tpu_torch/obs/telemetry.py``)
against the JAX reference's (``dlaf_tpu/obs/telemetry.py``), on the CPU.

* Off, ``telemetry.call`` is a passthrough: the callable's own result
  object, no key, no record.
* On, one ``compile`` record (after one ``retrace`` record) per distinct
  program key and none on a repeated call; another shape or dtype is a new
  key in both packages alike, another autotune route a new key in the
  port; ``dlaf_retrace_total{site}`` counts the keys. The memory gauges
  are finite.
* The port's artifacts pass ``--require-telemetry`` in both validators,
  and both reject the same three broken artifacts (no compile, no HBM,
  no retrace evidence).
* Every instrumented site of the port records under its reference label,
  and a factor with the knob on is bitwise the factor with it off.
* A warmed serve stream keeps ``dlaf_retrace_total{site=serve.*}`` at 1,
  so both validators' ``--require-serve`` pass on the port's artifact; an
  evicted bucket compiled again trips the serve retrace leg.
* The device peak counter's outer view stays whole across telemetry's
  resets (a fake allocator stands in for the card).
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlaf_tpu import config as jcfg
from dlaf_tpu import obs as jobs
from dlaf_tpu.obs import sinks as jsinks
from dlaf_tpu_torch import config, obs
from dlaf_tpu_torch.autotune import routes
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import TileElementSize
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.obs import telemetry
from dlaf_tpu_torch.serve import ProgramService, Queue, Request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("DLAF_PROGRAM_TELEMETRY", "DLAF_METRICS_PATH", "DLAF_ACCURACY",
              "DLAF_AUTOTUNE"):
        monkeypatch.delenv(k, raising=False)
    obs._reset_for_tests()
    config.initialize()
    yield
    obs._reset_for_tests()
    jobs._reset_for_tests()
    config.initialize()
    jcfg.initialize()


def telemetry_on(tmp_path, name="tele.jsonl", **cfg):
    path = str(tmp_path / name)
    config.initialize(config.Configuration(metrics_path=path, program_telemetry=True,
                                           log="off", **cfg))
    return path


def hpd(n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    return (x @ x.T + n * np.eye(n)).astype(dtype)


def records(path, rtype=None):
    obs.flush()
    recs = obs.read_records(path) if os.path.exists(path) else []
    return [r for r in recs if rtype is None or r.get("type") == rtype]


def last_metrics(recs) -> list:
    snaps = [r for r in recs if r.get("type") == "metrics"]
    return snaps[-1]["metrics"] if snaps else []


def counter(recs, name, **labels):
    return [m["value"] for m in last_metrics(recs)
            if m["name"] == name and all(m["labels"].get(k) == v for k, v in labels.items())]


# ---------------------------------------------------------------------------
# call(): off, on, keys
# ---------------------------------------------------------------------------

def test_off_is_a_passthrough(tmp_path):
    path = str(tmp_path / "off.jsonl")
    config.initialize(config.Configuration(metrics_path=path, log="off"))
    assert not telemetry.active()
    sentinel = object()
    got = telemetry.call("toy", lambda x: sentinel, torch.zeros(4))
    assert got is sentinel
    assert telemetry._SEEN == {}
    assert records(path, "program") == []
    assert not counter(records(path), "dlaf_retrace_total")


#: (shape, dtype) call sequences and the compile records and retrace count
#: they must give in both packages.
SEQUENCES = {
    "repeat": ([((8, 8), np.float64)] * 3, 1),
    "shapes": ([((8, 8), np.float64), ((8, 8), np.float64), ((4, 4), np.float64)], 2),
    "dtypes": ([((8, 8), np.float64), ((8, 8), np.float32), ((8, 8), np.float64)], 2),
    "mixed": ([((8, 8), np.float64), ((4, 4), np.float32), ((4, 4), np.float64),
               ((8, 8), np.float32), ((4, 4), np.float32)], 4),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_compile_per_key_against_the_reference(tmp_path, name):
    seq, keys = SEQUENCES[name]
    path = telemetry_on(tmp_path, "port.jsonl")
    for shape, dt in seq:
        out = telemetry.call("toy", torch.mul, torch.ones(shape, dtype=torch.from_numpy(
            np.zeros(1, dt)).dtype), 2.0)
        assert float(out[0, 0]) == 2.0
    port = records(path)
    jpath = str(tmp_path / "ref.jsonl")
    jcfg.initialize(jcfg.Configuration(metrics_path=jpath, program_telemetry=True))
    f = jax.jit(lambda x: x * 2.0)
    for shape, dt in seq:
        jobs.telemetry.call("toy", f, jnp.ones(shape, dtype=dt))
    jobs.flush()
    ref = jobs.read_records(jpath)
    for recs in (port, ref):
        compiles = [r for r in recs if r.get("type") == "program" and r["event"] == "compile"]
        assert len(compiles) == keys
        assert all(r["site"] == "toy" and math.isfinite(r["compile_s"]) for r in compiles)
    assert counter(port, "dlaf_retrace_total", site="toy") == [float(keys)]
    assert len([r for r in port if r.get("type") == "program"
                and r["event"] == "retrace"]) == keys


def test_route_is_a_new_key(tmp_path):
    path = telemetry_on(tmp_path)
    x = torch.ones(4, 4)
    for route in (None, routes.Route(f64_gemm_slices=5), None, routes.Route(step_impl="xla"),
                  routes.Route(f64_gemm_slices=5)):
        with routes.applied(route):
            telemetry.call("routed", torch.neg, x)
    recs = records(path)
    compiles = [r for r in recs if r.get("type") == "program" and r["event"] == "compile"]
    assert [r["attrs"].get("route") for r in compiles] == [
        None, {"f64_gemm_slices": 5}, {"step_impl": "xla"}]
    assert counter(recs, "dlaf_retrace_total", site="routed") == [3.0]


def test_memory_gauges_are_finite(tmp_path):
    path = telemetry_on(tmp_path)
    a, b = torch.ones(16, 8, dtype=torch.float64), torch.ones(8, 4, dtype=torch.float64)
    telemetry.call("gauges", torch.matmul, a, b)
    recs = records(path)
    (rec,) = [r for r in recs if r.get("type") == "program" and r["event"] == "compile"]
    assert rec["hbm"] == {"args": float(a.nbytes + b.nbytes), "output": 16.0 * 4 * 8}
    gauges = {m["labels"]["what"]: m["value"] for m in last_metrics(recs)
              if m["name"] == "dlaf_hbm_bytes"}
    assert gauges == rec["hbm"] and all(math.isfinite(v) for v in gauges.values())
    hist = [m for m in last_metrics(recs) if m["name"] == "dlaf_compile_seconds"]
    assert hist[0]["count"] == 1 and math.isfinite(hist[0]["sum"])


def test_seen_keys_are_bounded(tmp_path, monkeypatch):
    telemetry_on(tmp_path)
    monkeypatch.setattr(telemetry, "MAX_PROGRAMS", 3)
    for n in range(1, 6):
        telemetry.call("bounded", torch.neg, torch.zeros(n))
    assert len(telemetry._SEEN) == 3
    telemetry.call("bounded", torch.neg, torch.zeros(5))    # still seen: no new key
    assert len(telemetry._SEEN) == 3


def test_aot_compile_measures_always_records_when_on(tmp_path):
    prog = telemetry.aot_compile("probe", torch.matmul, torch.eye(4), torch.eye(4))
    assert math.isfinite(prog.compile_s) and prog.compiled is torch.matmul
    assert torch.equal(prog.output, torch.eye(4))
    assert obs.registry().snapshot() == []
    path = telemetry_on(tmp_path)
    telemetry.aot_compile("probe", torch.matmul, torch.eye(4), torch.eye(4))
    assert [r["event"] for r in records(path, "program")] == ["retrace", "compile"]


# ---------------------------------------------------------------------------
# The validators
# ---------------------------------------------------------------------------

def _cholesky_artifact(tmp_path):
    from dlaf_tpu_torch.algorithms.cholesky import cholesky

    path = telemetry_on(tmp_path)
    cholesky("L", Matrix.from_global(hpd(48), TileElementSize(16, 16), device=CPU))
    return records(path)


def test_artifact_passes_both_validators(tmp_path):
    recs = _cholesky_artifact(tmp_path)
    assert obs.validate_records(recs, require_telemetry=True) == []
    assert jsinks.validate_records(recs, require_telemetry=True) == []


def _strip(recs, what):
    """The artifact without one leg of telemetry evidence."""
    out = []
    for r in recs:
        r = json.loads(json.dumps(r))
        if r.get("type") == "program":
            if what == "compile" and r["event"] == "compile":
                continue
            if what == "retrace" and r["event"] == "retrace":
                continue
            if what == "hbm":
                r.pop("hbm", None)
        if r.get("type") == "metrics":
            drop = {"compile": "dlaf_compile_seconds", "hbm": "dlaf_hbm_bytes",
                    "retrace": "dlaf_retrace_total"}[what]
            r["metrics"] = [m for m in r["metrics"] if m["name"] != drop]
        out.append(r)
    return out


@pytest.mark.parametrize("what,msg", [("compile", "compile-seconds"),
                                      ("hbm", "HBM accounting"),
                                      ("retrace", "retrace evidence")])
def test_both_validators_reject_the_same_broken_artifacts(tmp_path, what, msg):
    broken = _strip(_cholesky_artifact(tmp_path), what)
    for validate in (obs.validate_records, jsinks.validate_records):
        assert validate(broken) == []
        errs = validate(broken, require_telemetry=True)
        assert len(errs) == 1 and msg in errs[0], errs


def test_validate_cli_flag(tmp_path):
    recs = _cholesky_artifact(tmp_path)
    good, bad = tmp_path / "good.jsonl", tmp_path / "bad.jsonl"
    good.write_text("".join(json.dumps(r) + "\n" for r in recs))
    bad.write_text("".join(json.dumps(r) + "\n" for r in _strip(recs, "retrace")))
    for path, rc in ((good, 0), (bad, 1)):
        for mod in ("dlaf_tpu_torch.obs.validate", "dlaf_tpu.obs.validate"):
            proc = subprocess.run([sys.executable, "-m", mod, str(path), "--require-telemetry"],
                                  capture_output=True, text=True, cwd=REPO,
                                  env={**os.environ, "JAX_PLATFORMS": "cpu"})
            assert proc.returncode == rc, (mod, proc.stdout, proc.stderr)


# ---------------------------------------------------------------------------
# The instrumented sites
# ---------------------------------------------------------------------------

def _local(n=48, nb=16, dtype=np.float64, seed=0):
    return Matrix.from_global(hpd(n, seed, dtype), TileElementSize(nb, nb), device=CPU)


def _grid(n=48, nb=8, dtype=np.float64, seed=0):
    return Matrix.from_global(hpd(n, seed, dtype), TileElementSize(nb, nb),
                              grid=shared_grid(2, 2, CPU), device=CPU)


def _run_cholesky_local():
    from dlaf_tpu_torch.algorithms.cholesky import cholesky

    cholesky("L", _local())


def _run_cholesky_scan():
    from dlaf_tpu_torch.algorithms.cholesky import cholesky

    config.initialize(config.Configuration(
        metrics_path=obs._state.STATE.sink.path, program_telemetry=True, log="off",
        cholesky_trailing="scan"))
    cholesky("L", _local())


def _run_cholesky_dist():
    from dlaf_tpu_torch.algorithms.cholesky import cholesky

    cholesky("L", _grid())


def _run_panel_kernels():
    from dlaf_tpu_torch.algorithms.cholesky import cholesky

    config.initialize(config.Configuration(
        metrics_path=obs._state.STATE.sink.path, program_telemetry=True, log="off",
        panel_impl="fused", step_impl="fused"))
    cholesky("L", _local(dtype=np.float32))
    cholesky("L", _grid(dtype=np.float32))
    config.initialize(config.Configuration(
        metrics_path=obs._state.STATE.sink.path, program_telemetry=True, log="off",
        panel_impl="fused", step_impl="xla"))
    cholesky("U", _local(dtype=np.float32))


def _run_trsm_trmm():
    from dlaf_tpu_torch.algorithms.triangular import triangular_multiply, triangular_solve

    a, b = _grid(), _grid(seed=1)
    triangular_solve("L", "L", "N", "N", 1.0, a, b, with_info=True)
    triangular_multiply("L", "L", "N", "N", 1.0, a, b)


def _run_hegst():
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.algorithms.gen_to_std import gen_to_std

    for make in (_local, _grid):
        gen_to_std("L", make(seed=2), cholesky("L", make()))


def _run_red2band_bt():
    from dlaf_tpu_torch.eigensolver.eigensolver import eigensolver

    eigensolver("L", _local(32, 8), band_size=4)
    eigensolver("L", _grid(32, 8), band_size=4)


def _run_kernel_miniapp():
    from dlaf_tpu_torch.miniapp import miniapp_kernel

    miniapp_kernel.run(["--kernel", "gemm", "-m", "8", "--batch", "2", "--backend", "cpu",
                        "--nruns", "2", f"--dlaf:metrics-path={obs._state.STATE.sink.path}",
                        "--dlaf:program-telemetry=1", "--dlaf:log=off"])


SITES = {
    "cholesky.local": _run_cholesky_local,
    "cholesky.local_scan": _run_cholesky_scan,
    "cholesky.dist": _run_cholesky_dist,
    "pallas_panel": _run_panel_kernels,
    "triangular": _run_trsm_trmm,
    "gen_to_std": _run_hegst,
    "red2band+bt_r2b": _run_red2band_bt,
    "miniapp_kernel": _run_kernel_miniapp,
}

EXPECT = {
    "cholesky.local": {"cholesky.local"},
    "cholesky.local_scan": {"cholesky.local_scan"},
    "cholesky.dist": {"cholesky.dist"},
    "pallas_panel": {"pallas_panel.potrf", "pallas_panel.solve", "pallas_panel.factor_solve",
                     "pallas_panel.step"},
    "triangular": {"triangular_solve.dist", "triangular_multiply.dist", "diag_info"},
    "gen_to_std": {"gen_to_std.local", "gen_to_std.dist"},
    "red2band+bt_r2b": {"reduction_to_band.local", "reduction_to_band.dist",
                        "bt_reduction_to_band.local", "bt_reduction_to_band.dist"},
    "miniapp_kernel": {"miniapp_kernel.gemm"},
}


@pytest.mark.parametrize("name", sorted(SITES))
def test_sites_record_under_the_reference_labels(tmp_path, name):
    path = telemetry_on(tmp_path)
    SITES[name]()
    recs = records(path)
    sites = {r["site"] for r in recs if r.get("type") == "program"}
    assert EXPECT[name] <= sites, sites
    assert obs.validate_records(recs, require_telemetry=True) == []
    assert jsinks.validate_records(recs, require_telemetry=True) == []


@pytest.mark.parametrize("grid", [False, True])
def test_factor_bitwise_knob_on_off(tmp_path, grid):
    from dlaf_tpu_torch.algorithms.cholesky import cholesky

    make = _grid if grid else _local
    ref = cholesky("L", make()).to_numpy()
    path = telemetry_on(tmp_path)
    got = cholesky("L", make()).to_numpy()
    again = cholesky("L", make()).to_numpy()
    assert ref.tobytes() == got.tobytes() == again.tobytes()
    site = "cholesky.dist" if grid else "cholesky.local"
    assert counter(records(path), "dlaf_retrace_total", site=site) == [1.0]


# ---------------------------------------------------------------------------
# Serve buckets
# ---------------------------------------------------------------------------

def _stream(q, n_reqs, seed=0):
    tickets = [q.submit(Request(op="cholesky", a=hpd(12, seed + i))) for i in range(n_reqs)]
    q.flush()
    for t in tickets:
        t.result()


def test_warm_serve_stream_keeps_one_program_per_bucket(tmp_path):
    path = telemetry_on(tmp_path, accuracy="1")
    q = Queue(ProgramService(device="cpu"), buckets=(16,), batch=2, deadline_s=1e9)
    q.warmup([Request(op="cholesky", a=hpd(12))])
    _stream(q, 6)
    recs = records(path)
    site = q._spec(q._key(Request(op="cholesky", a=hpd(12)))).site
    assert counter(recs, "dlaf_retrace_total", site=site) == [1.0]
    serve = [m["value"] for m in last_metrics(recs) if m["name"] == "dlaf_retrace_total"
             and m["labels"]["site"].startswith("serve.")]
    assert serve == [1.0]
    assert obs.validate_records(recs, require_serve=True, require_telemetry=True) == []
    assert jsinks.validate_records(recs, require_serve=True, require_telemetry=True) == []


def test_serve_bucket_compiled_again_trips_the_retrace_leg(tmp_path):
    path = telemetry_on(tmp_path, accuracy="1")
    q = Queue(ProgramService(device="cpu"), buckets=(16,), batch=2, deadline_s=1e9)
    req = Request(op="cholesky", a=hpd(12))
    q.warmup([req])
    q.service.evict(q._spec(q._key(req)))
    q.warmup([req])
    _stream(q, 2)
    recs = records(path)
    for validate in (obs.validate_records, jsinks.validate_records):
        errs = validate(recs, require_serve=True)
        assert len(errs) == 1 and "retraced mid-stream" in errs[0], errs


# ---------------------------------------------------------------------------
# The device peak counter's outer view
# ---------------------------------------------------------------------------

class FakeAllocator:
    """The caching allocator's counters as torch.cuda exposes them."""

    def __init__(self):
        self.live = 0
        self.peak = 0

    def alloc(self, n):
        self.live += n
        self.peak = max(self.peak, self.live)

    def free(self, n):
        self.live -= n


class FakeCudaTensor:
    is_cuda = True
    device = torch.device("cuda", 0)


@pytest.fixture
def fake_card(monkeypatch):
    fa = FakeAllocator()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: fa.live)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: fa.peak)

    def reset(*a):
        fa.peak = fa.live

    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
    monkeypatch.setattr(telemetry, "_tensors",
                        lambda x, out: out + [FakeCudaTensor()] if x is not None else out)
    monkeypatch.setattr(telemetry, "_nbytes", lambda x: 0.0)
    return fa


def test_peak_outer_view_stays_whole(tmp_path, fake_card):
    fa = fake_card
    telemetry_on(tmp_path)
    telemetry.reset_peak_memory_stats(0)
    fa.alloc(1000)
    fa.free(1000)                        # an outer run's peak: 1000

    def inner(_):
        fa.alloc(300)
        fa.free(300)

    def outer(_):
        fa.alloc(200)
        telemetry.call("inner", inner, 1)
        fa.free(200)

    telemetry.call("outer", outer, 1)
    # torch's own counter was reset under the outer reader ...
    assert torch.cuda.max_memory_allocated(0) < 1000
    # ... the telemetry view keeps the outer peak, and each site got its own
    assert telemetry.max_memory_allocated(0) == 1000
    gauges = {m["labels"]["site"]: m["value"] for m in obs.registry().snapshot()
              if m["name"] == "dlaf_hbm_bytes" and m["labels"]["what"] == "peak"}
    assert gauges == {"inner": 300.0, "outer": 500.0}
    fa.alloc(5000)
    fa.free(5000)
    assert telemetry.max_memory_allocated(0) == 5000
    telemetry.reset_peak_memory_stats(0)
    assert telemetry.max_memory_allocated(0) == 0
