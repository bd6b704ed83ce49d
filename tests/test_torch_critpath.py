"""Critical-path attribution of the port (``dlaf_tpu_torch/obs/critpath.py``)
against the JAX reference's (``dlaf_tpu/obs/critpath.py``).

* The accounting the two share (``_trimmed_window``, ``_step_table``,
  ``_bound_of``, ``_critical_path`` with lookahead on and off,
  ``_mean_steps``) on seeded numpy-made event lists: equal results.
* The port's step structure on synthetic Kineto traces
  (``tests/torch_kineto_synth.py``): known per-step walls and gaps to
  1 us with the host running ahead of the device, ``scanstep``
  occurrences numbering the steps (``--steps`` checks their count), the
  injected gap recovered exactly on a serial timeline, and the lookahead
  knob read off the artifact, where the reference's ``bool(... or True)``
  always gives the lookahead critical path.
* The records under both validators with ``--require-critpath``, and the
  reject cases in both.
* The card's fixture (``tests/fixtures/torch_devtrace/``, dist-L N=2048,
  nb=256 on the H100): eight steps, the CLI, the injected gap.

The reference's step-structure tests (``tests/test_critpath.py``) import
``dlaf_tpu.analysis``, which jax 0.9.0 breaks; nothing here imports it.
"""

import contextlib
import copy
import io
import json
import os

import numpy as np
import pytest

from dlaf_tpu.obs import critpath as jcp
from dlaf_tpu.obs.sinks import validate_records as jvalidate
from dlaf_tpu_torch.obs import critpath as pcp
from dlaf_tpu_torch.obs import devtrace as pdev
from dlaf_tpu_torch.obs.aggregate import merge_artifacts
from dlaf_tpu_torch.obs.sinks import (CRITPATH_BOUNDS, CRITPATH_COVERAGE_FLOOR,
                                      WHATIF_SCENARIOS)
from dlaf_tpu_torch.obs.sinks import validate_records as pvalidate
from torch_kineto_synth import Trace, serial_steps, span

HERE = os.path.dirname(os.path.abspath(__file__))
CARD_FIXTURE = os.path.join(HERE, "fixtures", "torch_devtrace")
CARD_TRACE = os.path.join(CARD_FIXTURE, "trace.json.gz")
CARD_JSONL = os.path.join(CARD_FIXTURE, "merged.jsonl")

CATS = ("mxu", "collective", "copy", "host_callback", "compute")


def _seeded_events(seed: int, n_steps: int = 7, per_step: int = 6) -> list:
    """Overlapping per-step event lists as the joiners build them (seconds)."""
    rng = np.random.default_rng(seed)
    evs, t = [], 0.0
    for k in range(n_steps):
        if k == 3 and seed % 2:
            t += 1e-3          # an empty step for odd seeds
            continue
        for _ in range(per_step):
            lo = t + float(rng.uniform(0.0, 80e-6))
            hi = lo + float(rng.choice([0.0, rng.uniform(1e-6, 120e-6)], p=[0.1, 0.9]))
            evs.append({"lo": lo, "hi": hi, "step": k,
                        "phase": str(rng.choice(pcp.PHASES)), "cat": str(rng.choice(CATS))})
        t += float(rng.uniform(60e-6, 260e-6))
    return evs


@pytest.mark.parametrize("seed", range(4))
def test_accounting_equals_the_references(seed):
    evs = _seeded_events(seed)
    n = max(e["step"] for e in evs) + 1
    for k in range(n):
        sevs = [e for e in evs if e["step"] == k]
        if sevs:
            assert pcp._trimmed_window(sevs) == jcp._trimmed_window(sevs)
            assert pcp._trimmed_window(sevs, 0.2) == jcp._trimmed_window(sevs, 0.2)
    table = pcp._step_table(evs, n)
    assert table == jcp._step_table(evs, n)
    for s in table:
        if not s.get("empty"):
            assert pcp._bound_of(s) == jcp._bound_of(s)
    for lookahead in (True, False):
        assert pcp._critical_path(table, lookahead) == jcp._critical_path(table, lookahead)
    other = pcp._step_table(_seeded_events(seed + 10), n)
    mean = pcp._mean_steps([table, other])
    assert mean == jcp._mean_steps([table, other])
    for lookahead in (True, False):
        assert pcp._critical_path(mean, lookahead) == jcp._critical_path(mean, lookahead)


# ---------------------------------------------------------------------------
# the step structure on synthetic Kineto traces
# ---------------------------------------------------------------------------

def test_serial_timeline_walls_and_gaps():
    """The host runs 5 ms ahead of the device; every step's ops join by
    launch: walls, phases and zero gaps to 1 us, then one 30 us gap."""
    t, records = serial_steps(n_steps=4)
    # open a 30 us hole before step 3 on the device
    for e in t.events:
        if e.get("cat") == "kernel" and e["ts"] >= 5000.0 + 600.0:
            e["ts"] += 30.0
    rep = pcp.attribute(t.shuffled(), records)
    assert rep["join"] == "annotation" and rep["coverage"] == pytest.approx(1.0)
    prog = rep["programs"]["chol"]
    assert (prog["n_steps"], prog["n_runs"], prog["scan"]) == (4, 1, False)
    assert prog["wall_s"] == pytest.approx(830e-6, abs=1e-6)
    for s in prog["steps"]:
        assert s["wall_s"] == pytest.approx(200e-6, abs=1e-6)
        assert s["phases"] == {"panel": pytest.approx(100e-6, abs=1e-6),
                               "bulk": pytest.approx(100e-6, abs=1e-6)}
        assert s["bound"] in CRITPATH_BOUNDS
    gaps = [s.get("gap_after_s") for s in prog["steps"]]
    assert gaps[:2] == [pytest.approx(0.0, abs=1e-6)] * 2
    assert gaps[2] == pytest.approx(30e-6, abs=1e-6) and gaps[3] is None
    assert prog["gap_total_s"] == pytest.approx(30e-6, abs=1e-6)
    assert prog["gflops"] == pytest.approx(1e6 / 830e-6 / 1e9)
    wi = {w["scenario"]: w for w in prog["whatif"]}
    assert set(wi) == set(WHATIF_SCENARIOS)
    assert wi["gaps_closed"]["saved_s"] == pytest.approx(30e-6, abs=1e-6)


def test_scanstep_occurrences_number_the_steps():
    t = Trace(21)
    t.range("trsm_entry", 0.0, 1000.0)
    for k in range(3):
        t.range("trsm.scanstep", 300.0 * k, 200.0)
        t.launch(300.0 * k + 10.0, "void strip_kernel<float, 8>(Params)", 5000.0 + 300.0 * k,
                 80.0)
        t.launch(300.0 * k + 20.0, "nvjet_tst_128x64_64x8_1x2_h_bz_TNT",
                 5080.0 + 300.0 * k, 100.0)
    records = [span("trsm_entry")]
    prog = pcp.attribute(t.shuffled(), records)["programs"]["trsm"]
    assert prog["scan"] and prog["n_steps"] == 3
    for s in prog["steps"]:
        assert s["phases"]["other"] == pytest.approx(180e-6)
    assert prog["steps"][0]["gap_after_s"] == pytest.approx(120e-6)
    assert pcp.attribute(t.events, records, steps_hint=3)["programs"]["trsm"]["n_steps"] == 3
    with pytest.raises(ValueError, match="--steps says 4"):
        pcp.attribute(t.events, records, steps_hint=4)


def test_runs_are_entry_ranges():
    t, records = serial_steps(n_steps=2)
    t2, _ = serial_steps(n_steps=2, host_lead=9000.0)
    shift = 1000.0
    for e in t2.events:
        if e.get("ph") in ("X", "s", "f") and e.get("cat") != "kernel" and "ts" in e:
            e["ts"] += shift
        if e.get("cat") == "cuda_runtime":
            e["args"]["correlation"] += 100
        elif e.get("cat") == "kernel":
            e["args"]["correlation"] += 100
        elif e.get("cat") == "ac2g":
            e["id"] += 100
    events = t.events + [e for e in t2.events if e.get("ph") != "M"]
    prog = pcp.attribute(events, records)["programs"]["chol"]
    assert (prog["n_runs"], prog["n_steps"]) == (2, 2)


def test_runs_without_entry_ranges_split_where_the_step_drops():
    """No entry span in the artifact: a run ends where the step index
    drops (the reference's rule without windows)."""
    t, _ = serial_steps(n_steps=2)
    t2, _ = serial_steps(n_steps=2, host_lead=9000.0)
    for e in t2.events:
        if e.get("cat") in ("user_annotation", "cpu_op", "cuda_runtime") or e.get("ph") == "s":
            e["ts"] += 1000.0
        if e.get("cat") in ("cuda_runtime", "kernel"):
            e["args"]["correlation"] += 100
        elif e.get("cat") == "ac2g":
            e["id"] += 100
    events = t.events + [e for e in t2.events if e.get("ph") != "M"]
    prog = pcp.attribute(events, [])["programs"]["chol"]
    assert (prog["n_runs"], prog["n_steps"]) == (2, 2)


def test_inject_gap_recovers_exactly_on_serial_timeline():
    t, records = serial_steps(n_steps=3)
    events = t.events
    assert pcp.inject_gap(events, records, "chol", 1, 5e-3) == 1
    prog = pcp.attribute(events, records)["programs"]["chol"]
    steps = prog["steps"]
    assert steps[0]["gap_after_s"] == pytest.approx(5e-3, rel=1e-9)
    assert steps[1]["gap_after_s"] == pytest.approx(0.0, abs=1e-12)
    assert prog["gap_total_s"] == pytest.approx(5e-3, rel=1e-9)
    assert steps[0]["bound"] == "gap"
    assert steps[1]["wall_s"] == pytest.approx(200e-6)
    assert pcp.parse_inject("cholesky.step002=2.0") == ("cholesky", 2, pytest.approx(2e-3))
    with pytest.raises(ValueError, match="inject-gap"):
        pcp.parse_inject("cholesky.panel=2.0")


def _lookahead_trace():
    """Two steps whose panel chain is long: the lookahead path (panel_1
    off strip_0) and the serial one (off bulk_0) differ."""
    t, _ = serial_steps(n_steps=3, phases=("panel", "strip", "bulk"))
    return t


@pytest.mark.parametrize("source", ["span", "metrics"])
def test_lookahead_knob_is_read_not_forced(source):
    """A lookahead-off artifact: the port takes the serial critical path;
    the reference's ``bool(... or True)`` would take the lookahead one."""
    t = _lookahead_trace()
    if source == "span":
        records = [span("chol_entry", lookahead=0)]
    else:
        records = [span("chol_entry"),
                   {"v": 1, "type": "metrics", "ts": 1.0, "metrics": [],
                    "knobs": {"cholesky_lookahead": "0"}}]
    rep = pcp.attribute(t.events, records)
    prog = rep["programs"]["chol"]
    assert rep["lookahead"] is False and prog["lookahead"] is False
    serial = jcp._critical_path(prog["steps"], False)
    forced = jcp._critical_path(prog["steps"], True)
    assert prog["critical_path"] == serial["nodes"]
    assert serial["nodes"] != forced["nodes"]
    # with the knob on both agree
    on = pcp.attribute(t.events, [span("chol_entry", lookahead=1)])["programs"]["chol"]
    assert on["critical_path"] == forced["nodes"]


def test_trace_without_steps_or_device_ops_fails():
    t = Trace(22)
    t.range("cholesky", 0.0, 100.0)
    t.launch(10.0, "void potrf_kernel<float>(float const*)", 500.0, 50.0)
    with pytest.raises(ValueError, match="step<k>"):
        pcp.attribute(t.events, [span("cholesky")])
    with pytest.raises(ValueError, match="no device events"):
        pcp.attribute(Trace(23).events, [span("cholesky")])


# ---------------------------------------------------------------------------
# records under both validators
# ---------------------------------------------------------------------------

def _records():
    t, records = serial_steps(n_steps=3)
    return pcp.records_from_report(pcp.attribute(t.events, records), "t.json.gz")


def test_records_pass_both_validators():
    recs = _records()
    for validate in (jvalidate, pvalidate):
        assert not validate(recs)
        assert not validate(recs, require_critpath=True)
    types = [r["type"] for r in recs]
    assert types.count("critpath") == 1 and types.count("whatif") == len(WHATIF_SCENARIOS)


def _mutate(case, recs):
    cp = [r for r in recs if r["type"] == "critpath"][0]
    if case == "low_coverage":
        cp["coverage"] = CRITPATH_COVERAGE_FLOOR - 0.01
        return recs, True, "coverage"
    if case == "no_whatif":
        return [r for r in recs if r["type"] != "whatif"], True, "whatif"
    if case == "bad_bound":
        cp["steps"][0]["bound"] = "mystery"
        return recs, False, "bound"
    if case == "nan_wall":
        cp["steps"][1]["wall_s"] = float("nan")
        return recs, False, "wall_s"
    if case == "bad_scenario":
        [r for r in recs if r["type"] == "whatif"][0]["scenario"] = "magic"
        return recs, False, "scenario"
    wi = [r for r in recs if r["type"] == "whatif"][0]
    wi["projected_wall_s"] = wi["wall_s"] * 2
    return recs, False, "projected_wall_s"


@pytest.mark.parametrize("case", ["low_coverage", "no_whatif", "bad_bound", "nan_wall",
                                  "bad_scenario", "slower_projection"])
def test_reject_cases_in_both_packages(case):
    recs, require, want = _mutate(case, _records())
    for validate in (jvalidate, pvalidate):
        errors = validate(copy.deepcopy(recs), require_critpath=require)
        assert any(want in e for e in errors), (validate, errors)


# ---------------------------------------------------------------------------
# the card's fixture and the CLI
# ---------------------------------------------------------------------------

def test_card_fixture_steps_and_drill(tmp_path):
    records = merge_artifacts([CARD_JSONL])
    events = pdev.load_trace(CARD_TRACE)
    rep = pcp.attribute(events, records)
    assert rep["join"] == "annotation" and rep["coverage"] >= CRITPATH_COVERAGE_FLOOR
    prog = rep["programs"]["cholesky"]
    assert (prog["n_steps"], prog["n_runs"], prog["scan"]) == (8, 1, False)
    assert prog["lookahead"] is True
    assert not pvalidate(pcp.records_from_report(rep, CARD_TRACE), require_critpath=True)
    joined = pcp._joined_events(events, records)[0]
    table = pcp._step_table([e for e in joined if e["algo"] == "cholesky"], 8)
    lead = table[4]["start_s"] - table[3]["end_s"]
    assert pcp.inject_gap(events, records, "cholesky", 4, 20e-3) == 1
    gap = pcp.attribute(events, records)["programs"]["cholesky"]["steps"][3]["gap_after_s"]
    # 20 ms less the boundary's lookahead overlap (lead < 0), or plus its gap
    assert gap == pytest.approx(lead + 20e-3, abs=1e-9) and gap > 10e-3


def test_cli_exit_codes(tmp_path):
    out = str(tmp_path / "cp.jsonl")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        assert pcp.main([CARD_TRACE, CARD_JSONL, "-o", out, "--json",
                         str(tmp_path / "r.json")]) == 0
        assert pcp.main([CARD_TRACE]) == 2
        assert pcp.main([CARD_TRACE, CARD_JSONL, "--bogus"]) == 2
        assert pcp.main([CARD_TRACE, CARD_JSONL, "--steps"]) == 2
        assert pcp.main([CARD_TRACE, CARD_JSONL, "--inject-gap", "cholesky.step004=5",
                         "--top", "0"]) == 0
        bare = tmp_path / "bare.jsonl"
        bare.write_text(json.dumps(span("other")) + "\n")
        t = Trace(24)
        t.range("cholesky", 0.0, 100.0)
        t.launch(10.0, "void potrf_kernel<float>(float const*)", 500.0, 50.0)
        pdev.write_trace(str(tmp_path / "local.json"), t.events)
        assert pcp.main([str(tmp_path / "local.json"), str(bare)]) == 1
    assert "critical path:" in buf.getvalue() and "what-if:" in buf.getvalue()
    assert not pvalidate([json.loads(line) for line in open(out)], require_critpath=True)
