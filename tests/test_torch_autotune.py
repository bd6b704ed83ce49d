"""The route autotuner of the PyTorch port (``dlaf_tpu_torch/autotune/``)
against the JAX reference's (``dlaf_tpu/autotune/``), on the CPU.

Mirrors ``tests/test_autotune.py``:

* the pure ``decide`` gives the reference's ``(reason, rung)`` trail on the
  same probe sequences (a Hypothesis property over random ratios with NaN
  and inf, margins, budgets, relax counts and start rungs, and the
  reference's named sequences), and the ladders' idents, tags and start
  rungs are equal;
* a table saved by one package loads in the other with an equal
  ``to_json`` after the same observations; the port loads the committed
  ``.autotune_table.json``; both refuse the same malformed or stale
  tables, naming the field; saves are atomic;
* the entries steer: a ``nan_tile`` breach escalates and the next call
  runs under the new route; the ``autotune`` records pass both
  validators' ``--require-autotune`` and both reject the exhausted state;
  under ``DLAF_STRICT`` exhaustion raises and the flight dump passes
  ``--require-flight``; donated inputs skip the probe and the cadence knob
  thins it;
* on the CPU both ladders are inert: at every rung the factor is bitwise
  the ``DLAF_AUTOTUNE=0`` factor; a route override never counts a fallback
  and never raises, and on ``cuda`` the f32 rungs open and close the
  kernels they name; under ``f64_gemm=mxu`` the port at slice rung r
  (s = 5..8) agrees with the reference at rung r;
* ``miniapp_cholesky``'s checks steer a donated run; the serve buckets
  carry their route, a route change is a new program, the dispatch
  residuals feed the bucket and a strict exhaustion is no dispatch
  failure;
* a gloo 2x2 world of four processes takes the same decisions on every
  process, writes the table from process 0 only, and its next factor is
  bitwise the single controller's under the same route.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import dlaf_tpu.autotune as jat
from dlaf_tpu import config as jcfg
from dlaf_tpu import obs as jobs
from dlaf_tpu.algorithms.cholesky import cholesky as jax_cholesky
from dlaf_tpu.common.index2d import TileElementSize as JTile
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu.obs import sinks as jsinks
from dlaf_tpu_torch import autotune as at
from dlaf_tpu_torch import config, obs
from dlaf_tpu_torch.algorithms.cholesky import cholesky
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import RankIndex2D, TileElementSize
from dlaf_tpu_torch.health import inject
from dlaf_tpu_torch.health import registry as hreg
from dlaf_tpu_torch.health.errors import AutotuneExhaustedError
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.tile_ops import panel_kernels as pk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
F64, F32 = at.LADDER_F64, at.LADDER_F32
KEY = at.site_key("cholesky", n=48, nb=16, dtype=np.float64, platform="cpu")
JKEY = jat.site_key("cholesky", n=48, nb=16, dtype=np.float64, platform="cpu")
ENV = ("DLAF_AUTOTUNE", "DLAF_AUTOTUNE_TABLE", "DLAF_AUTOTUNE_MARGIN",
       "DLAF_AUTOTUNE_RELAX_AFTER", "DLAF_AUTOTUNE_BUDGET", "DLAF_AUTOTUNE_PROBE_EVERY",
       "DLAF_METRICS_PATH", "DLAF_LOG", "DLAF_STRICT", "DLAF_ACCURACY",
       "DLAF_PROGRAM_TELEMETRY", "DLAF_FLIGHT_RECORDER", "DLAF_F64_GEMM",
       "DLAF_F64_GEMM_MIN_DIM", "DLAF_OZAKI_IMPL")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    at._reset_for_tests()
    obs._reset_for_tests()
    config.initialize()
    yield
    for k in ENV:
        os.environ.pop(k, None)
    at._reset_for_tests()
    jat._reset_for_tests()
    obs._reset_for_tests()
    jobs._reset_for_tests()
    config.initialize()
    jcfg.initialize()


def arm(tmp_path=None, **env):
    """Set ``env`` (and an artifact under ``tmp_path``) for the port, with
    a fresh table; returns the artifact path."""
    for k, v in env.items():
        os.environ[k] = str(v)
    path = None
    if tmp_path is not None:
        path = str(tmp_path / "art.jsonl")
        os.environ["DLAF_METRICS_PATH"] = path
    os.environ.setdefault("DLAF_LOG", "off")
    config.initialize()
    at._reset_for_tests()
    return path


def records(path, rtype=None):
    obs.flush()
    recs = obs.read_records(path) if os.path.exists(path) else []
    return [r for r in recs if rtype is None or r.get("type") == rtype]


def hpd(n, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((n, n))
    return (x @ x.conj().T + n * np.eye(n)).astype(dtype)


def local(n=48, nb=16, dtype=np.float64, seed=0):
    return Matrix.from_global(hpd(n, dtype, seed), TileElementSize(nb, nb), device=CPU)


def trail(decide, ratios, *, ladder_len, start, margin=0.25, relax_after=3, budget=0):
    rung, holds, changes, out = start, 0, 0, []
    for ratio in ratios:
        reason, rung, holds, changes = decide(rung, holds, changes, ratio,
                                              ladder_len=ladder_len, margin=margin,
                                              relax_after=relax_after, budget=budget)
        out.append((reason, rung))
    return out


# ---------------------------------------------------------------------------
# The decision core and the ladders
# ---------------------------------------------------------------------------

RATIO = st.one_of(st.floats(0.0, 3.0), st.just(float("nan")), st.just(float("inf")),
                  st.sampled_from([0.25, 1.0]))


@settings(max_examples=300, deadline=None)
@given(ratios=st.lists(RATIO, max_size=40), ladder=st.sampled_from(["f64", "f32"]),
       start=st.integers(0, 5), margin=st.floats(0.01, 1.0),
       relax_after=st.integers(1, 5), budget=st.integers(0, 4))
def test_decide_trail_is_the_reference_trail(ratios, ladder, start, margin, relax_after,
                                             budget):
    lad = F64 if ladder == "f64" else F32
    kw = dict(ladder_len=len(lad.rungs), start=min(start, len(lad.rungs) - 1), margin=margin,
              relax_after=relax_after, budget=budget)
    assert trail(at.decide, ratios, **kw) == trail(jat.decide, ratios, **kw)


#: The reference's named sequences (tests/test_autotune.py) with the trail
#: each must give from the f64 ladder's start: (ratios, kwargs, expected).
NAMED = {
    "escalate": ([3.0], {}, [("escalate", 4)]),
    "nan": ([float("nan")], {}, [("escalate", 4)]),
    "inf": ([float("inf")], {}, [("escalate", 4)]),
    "relax-after-k": ([0.01] * 3, {}, [("hold", 3), ("hold", 3), ("relax", 2)]),
    "hysteresis": ([0.01, 0.01, 0.5, 0.01, 0.01, 0.01], {},
                   [("hold", 3)] * 5 + [("relax", 2)]),
    "floor": ([0.01] * 40, {}, None),
    "budget": ([0.01] * 12 + [3.0], {"budget": 1}, None),
    "exhausted": ([5.0], {"start": 5}, [("exhausted", 5)]),
    "breach-resets": ([0.01, 0.01, 3.0, 0.01, 0.01], {},
                      [("hold", 3), ("hold", 3), ("escalate", 4), ("hold", 4), ("hold", 4)]),
}


@pytest.mark.parametrize("name", sorted(NAMED))
def test_named_sequences(name):
    ratios, kw, want = NAMED[name]
    kw = {"ladder_len": 6, "start": 3, **kw}
    got = trail(at.decide, ratios, **kw)
    assert got == trail(jat.decide, ratios, **kw)
    if want is not None:
        assert got == want
    if name == "floor":
        assert got[-1] == ("hold", 0)
    if name == "budget":
        assert sum(r == "relax" for r, _ in got) == 1 and got[-1][0] == "escalate"


def test_ladders_are_the_reference_ladders():
    for mine, ref in ((F64, jat.LADDER_F64), (F32, jat.LADDER_F32)):
        assert mine.ident == ref.ident and mine.start == ref.start
        assert [(r.tag(), r.as_dict(), r.key()) for r in mine.rungs] == \
            [(r.tag(), r.as_dict(), r.key()) for r in ref.rungs]
    assert F64.rungs[F64.start].as_dict() == {"f64_gemm_slices": 7}
    assert F32.rungs[F32.start].as_dict() == {}
    for dt, want in ((torch.float64, F64), (np.complex128, F64), (torch.float32, F32),
                     ("bfloat16", F32), (torch.bfloat16, F32), (torch.int32, None)):
        assert at.ladder_for(dt) is want
    assert at.site_key("trsm", n=100, nb=16, dtype=torch.complex128, platform="cuda").label \
        == jat.site_key("trsm", n=100, nb=16, dtype=np.complex128, platform="cuda").label


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

SEQ = [3.0, float("nan"), 0.01, 0.01, 0.01, 0.6, 0.01]


def learned(mod, key):
    table = mod.RouteTable()
    for ratio in SEQ:
        table.observe(key, mod.LADDER_F64, ratio, margin=0.25, relax_after=3, budget=0)
    return table


def test_tables_equal_after_the_same_observations():
    assert learned(at, KEY).to_json() == learned(jat, JKEY).to_json()


@pytest.mark.parametrize("direction", ["port-to-reference", "reference-to-port"])
def test_a_saved_table_loads_in_the_other_package(tmp_path, direction):
    path = str(tmp_path / "t.json")
    src, dst = (at, jat) if direction == "port-to-reference" else (jat, at)
    learned(src, KEY if src is at else JKEY).save(path)
    loaded = dst.RouteTable()
    loaded.load(path)
    assert loaded.to_json() == learned(src, KEY if src is at else JKEY).to_json()
    raw = open(path).read()
    assert "NaN" not in raw and "null" in raw
    assert [p for p in os.listdir(tmp_path) if ".tmp." in p] == []


def test_the_committed_table_loads():
    table = at.RouteTable()
    table.load(os.path.join(REPO, ".autotune_table.json"))
    snap = table.snapshot()
    assert snap and all(e["rung"] == 0 for e in snap.values())
    ref = jat.RouteTable()
    ref.load(os.path.join(REPO, ".autotune_table.json"))
    assert table.to_json() == ref.to_json()


@pytest.mark.parametrize("mutate,field", [
    (lambda d: d.pop("version"), "version"),
    (lambda d: d.update(version=99), "version"),
    (lambda d: d.update(entries={}), "entries"),
    (lambda d: d["entries"][0].pop("rung"), "rung"),
    (lambda d: d["entries"][0].update(rung=-1), "rung"),
    (lambda d: d["entries"][0].update(rung=999), "rung"),
    (lambda d: d["entries"][0].pop("op"), "op"),
    (lambda d: d["entries"][0].update(ladder="f64:2:bogus"), "ladder"),
    (lambda d: d["entries"][0].update(dtype="int16"), "dtype"),
    (lambda d: d["entries"][0].update(history="x"), "history"),
], ids=["no-version", "version", "entries", "no-rung", "rung-neg", "rung-big", "no-op",
        "stale-ladder", "dtype", "history"])
def test_both_refuse_the_same_tables(mutate, field):
    doc = learned(at, KEY).to_json()
    mutate(doc)
    for mod in (at, jat):
        with pytest.raises(ValueError, match=field) as err:
            mod.RouteTable().load_dict(json.loads(json.dumps(doc)))
        if mod is at:
            mine = str(err.value)
        else:
            assert str(err.value) == mine


def test_load_refuses_unparsable_and_retries_a_short_read(tmp_path, monkeypatch):
    from dlaf_tpu_torch.autotune import table as tmod

    bad = tmp_path / "bad.json"
    bad.write_text('{"version": 1, "entr')
    with pytest.raises(ValueError, match="unparsable autotune table"):
        at.RouteTable().load(str(bad))
    path = str(tmp_path / "t.json")
    learned(at, KEY).save(path)
    calls = {"n": 0}
    real = tmod.json.load

    def flaky(f, *a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("Expecting value: line 1 column 1")
        return real(f, *a, **k)

    monkeypatch.setattr(tmod.json, "load", flaky)
    loaded = at.RouteTable()
    loaded.load(path)
    assert calls["n"] == 2 and loaded.rung_of(KEY) is not None


def test_table_knob_warm_starts_persists_and_refuses(tmp_path):
    path = str(tmp_path / "t.json")
    learned(at, KEY).save(path)
    arm(tmp_path, DLAF_AUTOTUNE="1", DLAF_AUTOTUNE_TABLE=path)
    table = at.get_table()
    assert table.writer and table.rung_of(KEY) == learned(at, KEY).rung_of(KEY)
    at.observe_ratio(KEY, F64, 5.0)
    on_disk = at.RouteTable()
    on_disk.load(path)
    assert on_disk.to_json() == table.to_json()
    silent = at.RouteTable(path, writer=False)
    silent.observe(KEY, F64, 5.0, margin=0.25, relax_after=3, budget=0)
    on_disk.load(path)
    assert on_disk.to_json() == table.to_json()
    (tmp_path / "v.json").write_text(json.dumps({"version": 42, "entries": []}))
    arm(tmp_path, DLAF_AUTOTUNE="1", DLAF_AUTOTUNE_TABLE=str(tmp_path / "v.json"))
    with pytest.raises(ValueError, match="version"):
        at.get_table()


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------

def force_rung(key, ladder, rung):
    at.get_table().entry(key, ladder).rung = rung


@pytest.mark.parametrize("ladder,rung", [("f64", r) for r in range(6)]
                         + [("f32", r) for r in range(4)])
def test_cpu_ladders_are_inert(tmp_path, ladder, rung):
    """At every rung the factor is bitwise the DLAF_AUTOTUNE=0 factor."""
    dt = np.float64 if ladder == "f64" else np.float32
    arm(DLAF_AUTOTUNE="0")
    ref = cholesky("L", local(dtype=dt)).to_numpy()
    arm(tmp_path, DLAF_AUTOTUNE="1")
    lad = F64 if ladder == "f64" else F32
    force_rung(at.site_key("cholesky", n=48, nb=16, dtype=dt, platform="cpu"), lad, rung)
    got = cholesky("L", local(dtype=dt)).to_numpy()
    assert ref.tobytes() == got.tobytes()
    (rec,) = records(str(tmp_path / "art.jsonl"), "autotune")
    assert rec["route_old"] == lad.rungs[rung].as_dict()


def test_knob_off_and_auto_emit_nothing(tmp_path):
    for value in ("0", "auto"):
        path = arm(tmp_path, DLAF_AUTOTUNE=value)
        cholesky("L", local())
        assert records(path, "autotune") == []
        assert not at.enabled("cuda") and not at.enabled("cpu")


def test_probes_feed_the_table_per_op(tmp_path):
    from dlaf_tpu_torch.algorithms.gen_to_std import gen_to_std
    from dlaf_tpu_torch.algorithms.triangular import triangular_solve
    from dlaf_tpu_torch.eigensolver.eigensolver import eigensolver

    path = arm(tmp_path, DLAF_AUTOTUNE="1")
    mat = local()
    fac = cholesky("L", mat)
    gen_to_std("L", local(seed=1), fac)
    triangular_solve("L", "L", "N", "N", 1.0, fac, local(seed=2))
    res = eigensolver("L", local(32, 8), band_size=4)
    assert np.isfinite(res.eigenvalues).all()
    sites = set(at.get_table().snapshot())
    assert {"cholesky.n64.nb16.float64.cpu", "hegst.n64.nb16.float64.cpu",
            "trsm.n64.nb16.float64.cpu", "eigensolver.n32.nb8.float64.cpu"} <= sites
    recs = records(path)
    auto = [r for r in recs if r["type"] == "autotune"]
    assert {r["op"] for r in auto} == {"cholesky", "hegst", "trsm", "eigensolver"}
    assert all(r["reason"] == "hold" for r in auto)
    assert obs.validate_records(recs) == [] and jsinks.validate_records(recs) == []


def test_donated_skips_and_cadence_thins_the_probe(tmp_path):
    path = arm(tmp_path, DLAF_AUTOTUNE="1")
    cholesky("L", local(), donate=True)
    assert records(path, "autotune") == []
    path = arm(tmp_path, DLAF_AUTOTUNE="1", DLAF_AUTOTUNE_PROBE_EVERY="3")
    mat = local()
    for _ in range(6):
        cholesky("L", mat)
    assert len(records(path, "autotune")) == 2      # calls 1 and 4 probe


def test_breach_escalates_and_the_next_call_takes_the_route(tmp_path):
    path = arm(tmp_path, DLAF_AUTOTUNE="1")
    mat = local()
    cholesky("L", inject.nan_tile(mat, tile=(1, 0), element=(2, 3)))
    rec = records(path, "autotune")[-1]
    assert (rec["reason"], rec["rung_new"], rec["nonfinite"], rec["probe"]) == \
        ("escalate", F64.start + 1, True, None)
    assert at.get_table().route_for(KEY, F64) == F64.rungs[F64.start + 1]
    assert obs.registry().gauge("dlaf_autotune_route", op="cholesky",
                                knob="rung").snapshot()["value"] == F64.start + 1
    seen = []
    real = at.Steering.applied

    def spy(self):
        seen.append(self.route)
        return real(self)

    at.Steering.applied = spy
    try:
        cholesky("L", mat)
    finally:
        at.Steering.applied = real
    assert seen == [F64.rungs[F64.start + 1]]
    for _ in range(2):
        cholesky("L", mat)
    recs = records(path)
    assert [r["reason"] for r in recs if r["type"] == "autotune"] == \
        ["escalate", "hold", "hold", "relax"]
    for validate in (obs.validate_records, jsinks.validate_records):
        assert validate(recs, require_autotune=True) == []


def test_strict_exhaustion_raises_and_dumps(tmp_path):
    path = arm(tmp_path, DLAF_AUTOTUNE="1", DLAF_STRICT="1", DLAF_FLIGHT_RECORDER="32")
    for _ in range(len(F64.rungs) - 1 - F64.start):
        at.observe_ratio(KEY, F64, 5.0)
    with pytest.raises(AutotuneExhaustedError) as err:
        at.observe_ratio(KEY, F64, 5.0)
    assert err.value.site == KEY.label and err.value.rung == len(F64.rungs) - 1
    flight = path + ".flight.jsonl"
    assert json.loads(open(flight).readline())["reason"] == "autotune_exhausted"
    assert obs.validate_file(flight, require_flight=True) == []
    assert jsinks.validate_records(jobs.read_records(flight), require_flight=True) == []
    recs = records(path)
    for validate in (obs.validate_records, jsinks.validate_records):
        errs = validate(recs, require_autotune=True)
        assert len(errs) == 1 and "exhausted" in errs[0], errs
    # an exhaustion recovered by a later relax is no open state
    os.environ["DLAF_STRICT"] = "0"
    config.initialize()
    for _ in range(3):
        at.observe_ratio(KEY, F64, 0.0)
    recs = records(path)
    for validate in (obs.validate_records, jsinks.validate_records):
        assert validate(recs, require_autotune=True) == []


def test_validate_cli_flags(tmp_path):
    path = arm(tmp_path, DLAF_AUTOTUNE="1")
    at.observe_ratio(KEY, F64, 0.5)
    held = tmp_path / "held.jsonl"
    held.write_text("".join(json.dumps(r) + "\n" for r in records(path)))
    at.observe_ratio(KEY, F64, 5.0)
    moved = tmp_path / "moved.jsonl"
    moved.write_text("".join(json.dumps(r) + "\n" for r in records(path)))
    for file, rc in ((moved, 0), (held, 1)):
        for mod in ("dlaf_tpu_torch.obs.validate", "dlaf_tpu.obs.validate"):
            proc = subprocess.run([sys.executable, "-m", mod, str(file), "--require-autotune"],
                                  capture_output=True, text=True, cwd=REPO,
                                  env={**os.environ, "JAX_PLATFORMS": "cpu"})
            assert proc.returncode == rc, (mod, proc.stdout, proc.stderr)


@pytest.mark.parametrize("rung", range(len(F64.rungs)))
def test_route_override_is_policy_never_a_degradation(rung):
    """A route's overrides count no fallback and never raise under
    DLAF_STRICT, on either device type, for a dtype the kernels do not
    take; an explicit configured "fused" still does."""
    arm(DLAF_STRICT="1")
    before = hreg.fallback_counts()
    with at.applied(F64.rungs[rung]):
        for dev in ("cuda", "cpu"):
            assert not pk.step_uses_fused(torch.float64, 16, dev)
            assert not pk.panel_uses_fused(torch.float64, 16, dev)
    assert hreg.fallback_counts() == before
    if rung == 0:
        arm(DLAF_STRICT="1")
        os.environ["DLAF_STEP_IMPL"] = "fused"
        config.initialize()
        try:
            with pytest.raises(Exception, match="step"):
                pk.step_uses_fused(torch.float64, 16, "cuda")
        finally:
            os.environ.pop("DLAF_STEP_IMPL")
            config.initialize()


def test_f32_rungs_bind_on_cuda_only():
    """On ``cuda`` rung 0/1 fuse the step, rung 2 closes the step kernel,
    rung 3 the panel kernels too; on ``cpu`` every rung is the default."""
    want = {0: (True, True), 1: (True, True), 2: (False, True), 3: (False, False)}
    for rung, (step, panel) in want.items():
        with at.applied(F32.rungs[rung]):
            assert pk.step_uses_fused(torch.float32, 16, "cuda") is step
            assert pk.panel_uses_fused(torch.float32, 16, "cuda") is panel
            assert not pk.step_uses_fused(torch.float32, 16, "cpu")
            assert not pk.panel_uses_fused(torch.float32, 16, "cpu")


@pytest.mark.parametrize("rung", [1, 2, 3, 4], ids=["s5", "s6", "s7", "s8"])
def test_mxu_slice_rungs_match_the_reference(tmp_path, rung):
    """Under f64_gemm=mxu the port at slice rung r against the reference
    at rung r (the route tests' 60 n eps)."""
    n, nb = 64, 16
    env = dict(DLAF_AUTOTUNE="1", DLAF_F64_GEMM="mxu", DLAF_F64_GEMM_MIN_DIM="16")
    arm(tmp_path, **env)
    jcfg.initialize()
    jat._reset_for_tests()
    a = hpd(n, seed=3)
    key = at.site_key("cholesky", n=n, nb=nb, dtype=np.float64, platform="cpu")
    force_rung(key, F64, rung)
    jat.get_table().entry(jat.site_key("cholesky", n=n, nb=nb, dtype=np.float64,
                                       platform="cpu"), jat.LADDER_F64).rung = rung
    ref = np.asarray(jax_cholesky("L", JMatrix.from_global(a, JTile(nb, nb))).to_numpy())
    got = cholesky("L", Matrix.from_global(a, TileElementSize(nb, nb), device=CPU)).to_numpy()
    assert np.abs(np.tril(got) - np.tril(ref)).max() / np.abs(ref).max() \
        <= 60 * n * np.finfo(np.float64).eps
    # the slice count binds: rung r's factor is not the native one
    os.environ["DLAF_F64_GEMM"] = "native"
    arm(tmp_path, DLAF_AUTOTUNE="0")
    native = cholesky("L", Matrix.from_global(a, TileElementSize(nb, nb),
                                              device=CPU)).to_numpy()
    assert native.tobytes() != got.tobytes()


def test_miniapp_ingest_steers_a_donated_run(tmp_path):
    from dlaf_tpu_torch.miniapp import miniapp_cholesky

    path = str(tmp_path / "app.jsonl")
    miniapp_cholesky.run(["-m", "48", "-b", "16", "--type", "d", "--backend", "cpu",
                          "--nruns", "2", "--check-result", "last", "--dlaf:autotune=1",
                          "--dlaf:accuracy=1", f"--dlaf:metrics-path={path}",
                          "--dlaf:log=off"])
    recs = records(path, "autotune")
    assert [r["attrs"]["source"] for r in recs] == ["ingest", "ingest"]
    assert [r["attrs"].get("run", "check") for r in recs] == [0, "check"]
    assert at.get_table().rung_of(KEY) == F64.start


# ---------------------------------------------------------------------------
# Serve buckets
# ---------------------------------------------------------------------------

def _queue():
    from dlaf_tpu_torch.serve import ProgramService, Queue

    return Queue(ProgramService(device="cpu"), buckets=(32,), batch=4, deadline_s=1e9)


def _reqs(k, n=20, seed=0):
    from dlaf_tpu_torch.serve import Request

    return [Request(op="cholesky", a=hpd(n, seed=seed + i)) for i in range(k)]


SERVE_KEY = at.site_key("cholesky", n=32, nb=32, dtype="float64", platform="cpu")


def test_bucket_spec_carries_the_route(tmp_path):
    arm(tmp_path, DLAF_AUTOTUNE="1")
    q = _queue()
    spec = q._spec(q._key(_reqs(1)[0]))
    assert dict(spec.route) == F64.rungs[F64.start].as_dict() and ".rt_s7" in spec.site
    # the bound program applies the route around every call
    prog = q.service.get(spec)
    seen = []
    real = prog.fn
    prog.fn = lambda *a: seen.append(at.active()) or real(*a)
    prog(*[torch.eye(32, dtype=torch.float64).expand(4, 32, 32).clone()])
    assert seen == [F64.rungs[F64.start]] and at.active() is None
    arm(tmp_path, DLAF_AUTOTUNE="0")
    spec0 = q._spec(q._key(_reqs(1)[0]))
    assert spec0.route == () and ".rt_" not in spec0.site


def test_route_change_is_a_new_bucket_program(tmp_path):
    path = arm(tmp_path, DLAF_AUTOTUNE="1", DLAF_PROGRAM_TELEMETRY="1")
    q = _queue()
    reqs = _reqs(8)
    q.warmup(reqs)
    for r in _reqs(8):
        q.submit(r)
    q.flush()
    assert q.service.stats()["misses"] == 0
    held = q._spec(q._key(reqs[0])).site
    at.observe_ratio(SERVE_KEY, F64, 5.0)
    moved = q._spec(q._key(reqs[0])).site
    assert moved != held and ".rt_s8" in moved
    q.submit(_reqs(1)[0])
    q.flush()
    assert q.service.stats()["misses"] == 1
    for site in (held, moved):
        assert obs.registry().counter("dlaf_retrace_total",
                                      site=site).snapshot()["value"] == 1
    assert jsinks.validate_records(records(path), require_telemetry=True) == []


def test_serve_residuals_feed_the_bucket(tmp_path):
    path = arm(tmp_path, DLAF_AUTOTUNE="1", DLAF_ACCURACY="1")
    q = _queue()
    q.warmup(_reqs(1))
    for r in _reqs(4):
        q.submit(r)
    q.flush()
    recs = records(path, "autotune")
    assert len(recs) == 1 and recs[0]["attrs"]["source"] == "serve"
    assert recs[0]["attrs"]["lanes"] == 4 and recs[0]["reason"] == "hold"
    assert at.get_table().rung_of(SERVE_KEY) == F64.start


def test_strict_exhaustion_is_no_dispatch_failure(tmp_path):
    from dlaf_tpu_torch.serve import Request

    path = arm(tmp_path, DLAF_AUTOTUNE="1", DLAF_ACCURACY="1", DLAF_STRICT="1")
    q = _queue()
    for _ in range(len(F64.rungs) - 1 - F64.start):
        at.observe_ratio(SERVE_KEY, F64, 5.0)
    ticket = q.submit(Request(op="cholesky", a=np.full((20, 20), np.nan)))
    with pytest.raises(AutotuneExhaustedError):
        q.flush()
    assert ticket.done and ticket.error is None
    st_ = q.stats()
    assert st_["dispatches"] == 1
    bucket = next(iter(st_["buckets"].values()))
    assert bucket["dispatches"] == 1 and bucket["failures"] == 0
    disp = [r for r in records(path, "serve") if r["event"] == "dispatch"]
    assert len(disp) == 1


# ---------------------------------------------------------------------------
# The multi-process form
# ---------------------------------------------------------------------------

def _strip(r):
    return {k: v for k, v in r.items() if k not in ("ts", "rank", "trace_id", "span_id")}


def test_multiprocess_decisions_agree_and_match_the_single_controller(tmp_path):
    import torch_mp_worker as w
    from test_torch_multiprocess import join, spawn

    out = str(tmp_path / "world")
    join(spawn(2, 2, out, mode="autotune"), 150.0)
    got = [torch.load(os.path.join(out, f"autotune.r{i}.pt")) for i in range(4)]
    decisions = [[_strip(r) for r in obs.read_records(os.path.join(out, f"at.r{i}.jsonl"))
                  if r["type"] == "autotune"] for i in range(4)]
    assert all(d == decisions[0] for d in decisions)
    assert [r["reason"] for r in decisions[0]] == ["escalate", "hold"]
    assert [g["value"] for g in got] == [1.0, 0.0, 0.0, 0.0]     # process 0 writes
    saved = at.RouteTable()
    saved.load(os.path.join(out, "table.json"))
    assert saved.snapshot()[decisions[0][0]["site"]]["rung"] == F64.start + 1
    # the single controller under the same route
    P, Q, src, n, nb = w.GRIDS["2x2"]
    mat = Matrix.from_global(w.hpd(n, np.float64), TileElementSize(nb, nb),
                             shared_grid(2, 2, CPU), source_rank=RankIndex2D(*src))
    with at.applied(F64.rungs[F64.start + 1]):
        want = cholesky("L", mat)
    for g in got:
        for i, shard in g["shards"].items():
            assert shard.numpy().tobytes() == want.storage[int(i)].numpy().tobytes()
