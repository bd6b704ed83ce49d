"""Critical-path and stall attribution from device traces.

Port of ``dlaf_tpu/obs/critpath.py``. It rebuilds the executed per-step
timeline of the pipelined builders (cholesky, trsm, trmm, hegst,
red2band, bt_r2b) from a ``torch.profiler`` trace and the merged
artifact. Per step k it reports the measured panel / strip / bulk /
collective / copy walls, the idle *gap* between step k's last op and
step k+1's first op, the critical path through the step DAG, a bound
class, and Amdahl-style what-if projections ("collectives free -> wall
-X%", "gaps closed -> +Y GF/s").

**The step structure.** The reference reads it from HLO ``schedule``
records (``schedule_from_hlo``, ``schedule_record``, ``_op_maps``,
``_scheduled_events``), emitted when a program compiles. Eager PyTorch
compiles no program, so none of these is ported and the port writes no
``schedule`` record. Instead a device op's ``(algo, step, phase)`` is
read off the innermost ``<algo>.step<k>[.<phase>]`` range around its
launch, through the launch join of :mod:`.devtrace`. Innermost wins, so a
lookahead panel ``cholesky.step<k+1>.panel`` nested in step k's outer
range counts for step k+1, as the reference's op_name rule does.

**Scan builders.** Each eager iteration enters ``<algo>.scanstep`` once,
so a scan program's step is the occurrence number of that range within
its run: the reference's anchor inference (``_scan_steps``) is not
needed. ``--steps N`` states how many iterations a scan program runs:
a scan program with another count makes :func:`attribute` raise (the
CLI exits 1). It binds no unrolled program.

**CSE.** The reference's ``_detangle_shared`` undoes XLA's sharing of
one instruction between steps; eager code shares nothing, so it is
dropped.

**Runs.** A run is the innermost entry-span range (an artifact span
name that is no step or ``comm`` name: ``cholesky``,
``triangular_solve``, ...) around the launch. Without one, a run ends
where the step index drops, as in the reference.

**Coverage** is the busy time of the ops joined to a step over the busy
time of all ops launched in the runs that hold them (the whole trace
without runs).

**Lookahead.** The reference computes ``lookahead = bool(... or True)``,
always true, so a lookahead-off run gets the lookahead critical path.
The port reads the knob: the ``lookahead`` attr of the run's entry span
(what the call ran), else the ``cholesky_lookahead``/``lookahead`` knob
of the artifact's last ``metrics`` record that carries ``knobs``, else
true.

Usage:
    python -m dlaf_tpu_torch.obs.critpath TRACE MERGED.jsonl [options]

    TRACE           profiler trace file (*.json[.gz]) or a directory to
                    search for the newest one
    MERGED.jsonl    merged observability artifact (the span vocabulary,
                    the entry spans' flop models and knobs)

Options:
    -o PATH             append critpath/whatif JSONL records to PATH
    --json PATH         write the full report as JSON to PATH
    --top N             show at most N steps per program (default 32)
    --steps N           scan-built programs: the iteration count they
                        must have (another count exits 1)
    --inject-gap SPEC   testing: shift the device timeline to open an
                        artificial gap, SPEC = <algo>.step<k>=<ms>
                        (e.g. cholesky.step002=5 shifts every device op
                        launched in step 2 or later of each run by 5 ms)
    --distill PATH      write a minimal replayable trace JSON to PATH

Exit codes: 0 ok, 1 no per-step attribution possible, 2 bad arguments.
"""

from __future__ import annotations

import functools
import json
import os
import re
import sys
import time
from typing import Any

from .devtrace import (
    COMM_RE,
    SCAN_RE,
    STEP_RE,
    _intersect_len,
    _union,
    distill as _devtrace_distill,
    innermost,
    join_ops,
    join_points,
    load_trace,
    span_vocabulary,
    write_trace,
)
from .sinks import SCHEMA_VERSION

PHASES = ("panel", "strip", "bulk", "other")

# Bound classes, in reporting order.  "panel" folds in the strip phase
# (both sit on the panel-chain critical path), "comm"/"copy" are the
# collective/copy categories regardless of phase, "gap" is measured idle.
BOUNDS = ("panel", "bulk", "comm", "copy", "gap")


# ---------------------------------------------------------------------------
# device-event join


@functools.lru_cache(maxsize=8192)
def _step_name(name: str):
    """``(algo, step, phase)`` of a step range name (step -1 for a scan
    body), or None."""
    m = STEP_RE.fullmatch(name)
    if m:
        return m.group(1), int(m.group(2)), m.group(3) or "other"
    m = SCAN_RE.fullmatch(name)
    if m:
        return m.group(1), -1, m.group(2) or "other"
    return None


def _joined_events(events: list[dict], records: list[dict]):
    """Join the trace's device ops to their step ranges.

    Returns ``(joined, busy_total_s, busy_denom_s, join, run_names)``:
    ``joined`` is a list of dicts with keys lo/hi (seconds), algo, step,
    phase, cat, name, domain, run and event (the trace event); the
    coverage denominator counts device busy of the runs that hold a
    joined op (unrelated work in the trace must not dilute coverage);
    ``run_names`` maps a run id to its entry span's name.
    """
    ops, windows, join = join_ops(events, records)
    busy_total = sum(o["hi"] - o["lo"] for o in ops if o["hi"] > o["lo"])
    spans = span_vocabulary(records)
    step_ws, run_ws = [], []
    for w in windows:
        if _step_name(w[2]) is not None:
            step_ws.append(w)
        elif w[2] in spans and not COMM_RE.fullmatch(w[2]):
            run_ws.append(w)
    points = join_points(ops, join)
    step_idx = innermost(points, step_ws)
    run_idx = innermost(points, run_ws)
    # a scan body's step: the occurrence of its outermost same-algo range
    # within the run, in start order
    roots: dict = {}
    occurrence: dict = {}
    scan_ws = [i for i, w in enumerate(step_ws) if _step_name(w[2])[1] < 0]
    if scan_ws:
        for i in scan_ws:
            lo, hi, name, key = step_ws[i]
            algo = _step_name(name)[0]
            outer = [j for j in scan_ws if _step_name(step_ws[j][2])[0] == algo
                     and step_ws[j][3] == key and step_ws[j][0] <= lo and hi <= step_ws[j][1]]
            roots[i] = min(outer, key=lambda j: (step_ws[j][0], -step_ws[j][1]))
        root_ids = sorted(set(roots.values()), key=lambda j: step_ws[j][0])
        root_run = innermost([(step_ws[j][0], step_ws[j][3]) for j in root_ids], run_ws)
        count: dict = {}
        for j, r in zip(root_ids, root_run):
            k = (r, _step_name(step_ws[j][2])[0])
            occurrence[j] = count.get(k, 0)
            count[k] = occurrence[j] + 1
    joined: list[dict] = []
    held = set()
    for o, si, ri in zip(ops, step_idx, run_idx):
        if si is None or o["hi"] <= o["lo"]:
            continue
        algo, step, phase = _step_name(step_ws[si][2])
        if step < 0:
            step = occurrence[roots[si]]
        joined.append({"lo": o["lo"] * 1e-6, "hi": o["hi"] * 1e-6, "algo": algo,
                       "step": step, "phase": phase, "cat": o["cat"], "name": o["name"],
                       "domain": o["domain"], "run": ri, "scan": _step_name(
                           step_ws[si][2])[1] < 0, "event": o["event"]})
        held.add(ri)
    if held - {None}:
        denom = sum(o["hi"] - o["lo"] for o, ri in zip(ops, run_idx)
                    if ri in held and o["hi"] > o["lo"])
    else:
        denom = busy_total
    if not any(e["run"] is not None for e in joined):
        _segment_runs(joined)
    run_names = {i: w[2] for i, w in enumerate(run_ws)}
    return joined, busy_total * 1e-6, denom * 1e-6, join, run_names


def _segment_runs(joined: list[dict]) -> None:
    """Run ids where no entry-span range holds the ops (a trace of steps
    alone): per algo in start order, a new run where the step index
    drops (the reference's rule without windows)."""
    by_algo: dict[str, list[dict]] = {}
    for ev in joined:
        by_algo.setdefault(ev["algo"], []).append(ev)
    for evs in by_algo.values():
        evs.sort(key=lambda e: e["lo"])
        run = 0
        prev_step = -1
        for ev in evs:
            if 0 <= ev["step"] < prev_step:
                run += 1
            prev_step = ev["step"]
            ev["run"] = ("seg", run)


# ---------------------------------------------------------------------------
# per-step accounting


def _flops_for(algo: str, records: list[dict]) -> float | None:
    """Per-run flop count from the entry span records, if recorded."""
    best = None
    for r in records:
        if r.get("type") != "span":
            continue
        name = r.get("name", "")
        fl = (r.get("attrs") or {}).get("flops") or r.get("flops")
        if fl and (name == algo or algo in name):
            best = float(fl)
    return best


def _on(value) -> bool:
    """A knob's value as a switch: 0, "0", false, "false", "off", "no"
    are off."""
    return str(value).strip().lower() not in ("0", "false", "off", "no", "none", "")


def _lookahead(records: list[dict], entry_names=()) -> bool:
    """The lookahead a run ran with (the module docstring's order)."""
    seen = None
    for r in records:
        if r.get("type") == "span" and r.get("name") in entry_names \
                and "lookahead" in (r.get("attrs") or {}):
            seen = r["attrs"]["lookahead"]
    if seen is not None:
        return _on(seen)
    knobs = {}
    for rec in records:
        if rec.get("type") == "metrics" and rec.get("knobs"):
            knobs = rec["knobs"]
    for key in ("cholesky_lookahead", "lookahead"):
        if key in knobs:
            return _on(knobs[key])
    return True


def _trimmed_window(sevs: list[dict], tail: float = 0.005) -> tuple[float, float]:
    """Duration-weighted robust window of one step's events.

    Near-zero-duration stragglers must not stretch the step across the
    run, so the window keeps the span holding all but a ``tail`` fraction
    of the step's busy time at each end.  Steps whose events are all
    zero-length fall back to the plain min/max.
    """
    total = sum(e["hi"] - e["lo"] for e in sevs)
    if total <= 0.0:
        return (min(e["lo"] for e in sevs), max(e["hi"] for e in sevs))
    cut = tail * total
    acc = 0.0
    lo = sevs[0]["lo"]
    for e in sorted(sevs, key=lambda e: e["lo"]):
        lo = e["lo"]
        acc += e["hi"] - e["lo"]
        if acc > cut:
            break
    acc = 0.0
    hi = sevs[-1]["hi"]
    for e in sorted(sevs, key=lambda e: e["hi"], reverse=True):
        hi = e["hi"]
        acc += e["hi"] - e["lo"]
        if acc > cut:
            break
    return (lo, hi) if lo < hi else (min(e["lo"] for e in sevs),
                                     max(e["hi"] for e in sevs))


def _step_table(evs: list[dict], n_steps: int) -> list[dict]:
    """Per-step walls, category exposure and boundary gaps for one run."""
    steps: list[dict] = []
    by_step: dict[int, list[dict]] = {}
    for ev in evs:
        by_step.setdefault(ev["step"], []).append(ev)
    for k in range(n_steps):
        sevs = by_step.get(k, [])
        if not sevs:
            steps.append({"step": k, "empty": True})
            continue
        lo, hi = _trimmed_window(sevs)
        phase_w = {}
        for ph in PHASES:
            u = _union([(e["lo"], e["hi"]) for e in sevs if e["phase"] == ph])
            if u:
                phase_w[ph] = sum(b - a for a, b in u)
        comm_u = _union([(e["lo"], e["hi"]) for e in sevs if e["cat"] == "collective"])
        copy_u = _union([(e["lo"], e["hi"]) for e in sevs if e["cat"] == "copy"])
        comp_u = _union(
            [(e["lo"], e["hi"]) for e in sevs if e["cat"] not in ("collective", "copy")]
        )
        busy_u = _union([(e["lo"], e["hi"]) for e in sevs])
        busy = sum(b - a for a, b in busy_u)
        comm = sum(b - a for a, b in comm_u)
        copy = sum(b - a for a, b in copy_u)
        comm_exposed = comm - _intersect_len(comm_u, comp_u)
        steps.append(
            {
                "step": k,
                "start_s": lo,
                "wall_s": hi - lo,
                "busy_s": busy,
                "idle_s": max(0.0, (hi - lo) - busy),
                "phases": phase_w,
                "comm_s": comm,
                "comm_exposed_s": max(0.0, comm_exposed),
                "copy_s": copy,
                "end_s": hi,
            }
        )
    # boundary gaps: idle between step k's last op and step k+1's first op,
    # clamped at zero when steps overlap (lookahead pipelining)
    for k in range(len(steps) - 1):
        a, b = steps[k], steps[k + 1]
        if a.get("empty") or b.get("empty"):
            continue
        a["gap_after_s"] = max(0.0, b["start_s"] - a["end_s"])
    return steps


def _bound_of(step: dict) -> str:
    """Classify what bounds a step: argmax over exposure per category."""
    ph = step.get("phases", {})
    panel = ph.get("panel", 0.0) + ph.get("strip", 0.0)
    bulk = ph.get("bulk", 0.0) + ph.get("other", 0.0)
    comm = step.get("comm_exposed_s", 0.0)
    copy = step.get("copy_s", 0.0)
    gap = step.get("gap_after_s", 0.0) + step.get("idle_s", 0.0)
    scores = {"panel": panel - comm - copy, "bulk": bulk, "comm": comm, "copy": copy, "gap": gap}
    scores["panel"] = max(0.0, scores["panel"])
    return max(BOUNDS, key=lambda b: scores[b])


def _critical_path(steps: list[dict], lookahead: bool) -> dict:
    """Longest path through the step DAG.

    Nodes are (step, phase) with measured walls; edges are
    panel_k -> strip_k -> bulk_k within a step, bulk_k -> bulk_{k+1}
    (trailing updates serialize on the matrix), and the next panel hangs
    off strip_k when lookahead overlaps it with bulk_k, else off bulk_k.
    Boundary gaps ride the cross-step edges.
    """
    dist: dict[tuple[int, str], float] = {}
    prev: dict[tuple[int, str], tuple[int, str] | None] = {}

    def relax(node, base, src, w):
        if base + w > dist.get(node, -1.0):
            dist[node] = base + w
            prev[node] = src

    for st in steps:
        if st.get("empty"):
            continue
        k = st["step"]
        ph = st.get("phases", {})
        gap = steps[k - 1].get("gap_after_s", 0.0) if 0 < k <= len(steps) else 0.0
        chain = [p for p in ("panel", "strip", "bulk", "other") if p in ph]
        for i, p in enumerate(chain):
            w = ph[p]
            node = (k, p)
            relax(node, gap, None, w)
            if i > 0:
                relax(node, dist[(k, chain[i - 1])], (k, chain[i - 1]), w)
            # cross-step dependencies from step k-1
            if i == 0:
                # the panel hangs off strip_{k-1} (lookahead overlap) or the
                # end of step k-1 entirely (serial)
                srcs = ("strip", "panel") if lookahead else ("bulk", "other", "strip", "panel")
            elif p in ("bulk", "other"):
                srcs = ("bulk", "other")  # trailing updates serialize
            else:
                srcs = ()
            for pp in srcs:
                src = (k - 1, pp)
                if src in dist:
                    relax(node, dist[src] + gap, src, w)
    if not dist:
        return {"length_s": 0.0, "nodes": []}
    last = max(dist, key=lambda n: dist[n])
    path = []
    node: tuple[int, str] | None = last
    while node is not None:
        path.append(f"step{node[0]:03d}.{node[1]}")
        node = prev.get(node)
    return {"length_s": dist[last], "nodes": list(reversed(path))}


def _mean_steps(per_run: list[list[dict]]) -> list[dict]:
    """Average per-step numbers across runs (element-wise over steps)."""
    if not per_run:
        return []
    n_steps = max(len(r) for r in per_run)
    out = []
    for k in range(n_steps):
        rows = [r[k] for r in per_run if k < len(r) and not r[k].get("empty")]
        if not rows:
            out.append({"step": k, "empty": True})
            continue
        agg: dict[str, Any] = {"step": k}
        for key in ("wall_s", "busy_s", "idle_s", "comm_s", "comm_exposed_s", "copy_s",
                    "gap_after_s"):
            vals = [r.get(key) for r in rows if r.get(key) is not None]
            if vals:
                agg[key] = sum(vals) / len(vals)
        phases: dict[str, float] = {}
        for ph in PHASES:
            vals = [r["phases"].get(ph) for r in rows if r["phases"].get(ph) is not None]
            if vals:
                phases[ph] = sum(vals) / len(vals)
        agg["phases"] = phases
        agg["bound"] = _bound_of(agg)
        out.append(agg)
    return out


def _runs_of(joined: list[dict], algo: str) -> dict:
    runs: dict = {}
    for ev in joined:
        if ev["algo"] == algo:
            runs.setdefault(ev["run"], []).append(ev)
    return runs


def attribute(
    events: list[dict],
    records: list[dict],
    *,
    steps_hint: int | None = None,
) -> dict[str, Any]:
    """Join device events to their step ranges and build the full report.

    Raises ``ValueError`` when the trace has no device events, when no
    device op was launched inside a step range, or when a scan program's
    step count is not ``steps_hint``.
    """
    joined, busy_total, busy_denom, join, run_names = _joined_events(events, records)
    if busy_total <= 0.0:
        raise ValueError("trace contains no device events (a CPU-only trace?)")
    if not joined:
        raise ValueError("no device op was launched inside a <algo>.step<k> or "
                         "<algo>.scanstep range (a builder that names no step, or a "
                         "trace without its ranges)")
    attributed = sum(e["hi"] - e["lo"] for e in joined)
    coverage = attributed / busy_denom if busy_denom > 0 else 0.0
    lookahead = _lookahead(records, set(run_names.values()))

    programs: dict[str, Any] = {}
    for algo in sorted({ev["algo"] for ev in joined}):
        runs = _runs_of(joined, algo)
        scan = all(e["scan"] for evs in runs.values() for e in evs)
        entry = {run_names[r] for r in runs if r in run_names}
        la = _lookahead(records, entry) if entry else lookahead
        per_run_steps: list[list[dict]] = []
        run_walls: list[float] = []
        gaps_per_run: list[float] = []
        comm_exposed_run: list[float] = []
        panel_exposed_run: list[float] = []
        copy_run: list[float] = []
        for revs in sorted(runs.values(), key=lambda evs: min(e["lo"] for e in evs)):
            n_steps = max(e["step"] for e in revs) + 1
            if scan and steps_hint is not None and n_steps != steps_hint:
                raise ValueError(f"{algo}: a run of the scan program has {n_steps} "
                                 f"steps, --steps says {steps_hint}")
            table = _step_table(revs, n_steps)
            per_run_steps.append(table)
            run_walls.append(max(e["hi"] for e in revs) - min(e["lo"] for e in revs))
            gaps_per_run.append(sum(s.get("gap_after_s", 0.0) for s in table))
            comm_u = _union([(e["lo"], e["hi"]) for e in revs if e["cat"] == "collective"])
            comp_u = _union(
                [(e["lo"], e["hi"]) for e in revs if e["cat"] not in ("collective", "copy")]
            )
            comm_exposed_run.append(
                max(0.0, sum(b - a for a, b in comm_u) - _intersect_len(comm_u, comp_u))
            )
            pan_u = _union(
                [(e["lo"], e["hi"]) for e in revs if e["phase"] in ("panel", "strip")]
            )
            blk_u = _union([(e["lo"], e["hi"]) for e in revs if e["phase"] in ("bulk", "other")])
            panel_exposed_run.append(
                max(0.0, sum(b - a for a, b in pan_u) - _intersect_len(pan_u, blk_u))
            )
            copy_run.append(
                sum(b - a for a, b in _union(
                    [(e["lo"], e["hi"]) for e in revs if e["cat"] == "copy"]))
            )
        mean = _mean_steps(per_run_steps)
        n_runs = len(per_run_steps)
        wall = sum(run_walls) / n_runs
        gaps = sum(gaps_per_run) / n_runs
        cp = _critical_path(mean, la)
        flops = _flops_for(algo, records)

        def project(saved_s: float, label: str) -> dict:
            new_wall = max(1e-12, wall - min(saved_s, wall))
            w: dict[str, Any] = {
                "scenario": label,
                "saved_s": saved_s,
                "wall_s": wall,
                "projected_wall_s": new_wall,
                "wall_pct": 100.0 * (wall - new_wall) / wall if wall > 0 else 0.0,
            }
            if flops:
                w["gflops"] = flops / wall / 1e9
                w["projected_gflops"] = flops / new_wall / 1e9
            return w

        whatifs = [
            project(sum(comm_exposed_run) / n_runs, "collectives_free"),
            project(gaps, "gaps_closed"),
            project(sum(panel_exposed_run) / n_runs, "panel_free"),
            project(sum(copy_run) / n_runs, "copies_free"),
        ]
        whatifs.sort(key=lambda w: -w["saved_s"])
        bounds = [s.get("bound") for s in mean if not s.get("empty")]
        overall = max(BOUNDS, key=lambda b: bounds.count(b)) if bounds else "gap"
        programs[algo] = {
            "scan": scan,
            "n_runs": n_runs,
            "n_steps": len(mean),
            "wall_s": wall,
            "gap_total_s": gaps,
            "critical_path_s": cp["length_s"],
            "critical_path": cp["nodes"],
            "bound": overall,
            "lookahead": la,
            "steps": mean,
            "whatif": whatifs,
        }
        if flops:
            programs[algo]["gflops"] = flops / wall / 1e9

    return {
        "device_busy_s": busy_total,
        "attributed_s": attributed,
        "coverage": coverage,
        "join": join,
        "events": len(joined),
        "lookahead": lookahead,
        "programs": programs,
    }


# ---------------------------------------------------------------------------
# gap injection (testing / chip drill)


def parse_inject(spec: str) -> tuple[str, int, float]:
    """Parse ``<algo>.step<k>=<ms>`` into (algo, step, seconds)."""
    m = re.fullmatch(r"([A-Za-z0-9_]+)\.step(\d+)=([0-9.]+)", spec.strip())
    if not m:
        raise ValueError(f"bad --inject-gap spec {spec!r}; want <algo>.step<k>=<ms>")
    return m.group(1), int(m.group(2)), float(m.group(3)) * 1e-3


def inject_gap(events: list[dict], records: list[dict], algo: str, step: int,
               seconds: float) -> int:
    """Shift the timeline so an idle gap of ``seconds`` opens immediately
    before ``step`` of ``algo`` in every run.

    Every device op launched in step >= ``step`` of a run that has that
    step shifts by the delta. The join goes by launch, so no host range
    has to stretch. On a serial (non-overlapping) timeline the measured
    boundary gap grows by *exactly* the delta; with lookahead overlap the
    earlier step's tail eats into it, so the recovered gap is ``delta -
    overlap``. Mutates ``events`` in place; returns the number of runs
    injected into.
    """
    joined, _bt, _bd, _join, _names = _joined_events(events, records)
    delta_us = seconds * 1e6
    n = 0
    for revs in _runs_of(joined, algo).values():
        if not any(e["step"] == step for e in revs):
            continue
        n += 1
        for e in revs:
            if e["step"] >= step:
                e["event"]["ts"] = float(e["event"].get("ts", 0.0)) + delta_us
    return n


# ---------------------------------------------------------------------------
# records + rendering


def records_from_report(report: dict, trace: str) -> list[dict]:
    ts = time.time()
    base = os.path.basename(trace)
    out = []
    for algo, prog in report.get("programs", {}).items():
        steps = []
        for s in prog["steps"]:
            if s.get("empty"):
                steps.append({"step": s["step"], "empty": True})
                continue
            steps.append(
                {
                    "step": s["step"],
                    "wall_s": round(s.get("wall_s", 0.0), 9),
                    "panel_s": round(
                        s["phases"].get("panel", 0.0) + s["phases"].get("strip", 0.0), 9),
                    "bulk_s": round(
                        s["phases"].get("bulk", 0.0) + s["phases"].get("other", 0.0), 9),
                    "comm_s": round(s.get("comm_s", 0.0), 9),
                    "comm_exposed_s": round(s.get("comm_exposed_s", 0.0), 9),
                    "copy_s": round(s.get("copy_s", 0.0), 9),
                    "idle_s": round(s.get("idle_s", 0.0), 9),
                    "gap_after_s": round(s.get("gap_after_s", 0.0), 9),
                    "bound": s.get("bound", "gap"),
                }
            )
        rec = {
            "type": "critpath",
            "v": SCHEMA_VERSION,
            "ts": ts,
            "trace": base,
            "algo": algo,
            "scan": prog["scan"],
            "join": report.get("join"),
            "coverage": round(report.get("coverage", 0.0), 6),
            "n_runs": prog["n_runs"],
            "n_steps": prog["n_steps"],
            "wall_s": round(prog["wall_s"], 9),
            "gap_total_s": round(prog["gap_total_s"], 9),
            "critical_path_s": round(prog["critical_path_s"], 9),
            "critical_path": prog["critical_path"],
            "bound": prog["bound"],
            "steps": steps,
        }
        if "gflops" in prog:
            rec["gflops"] = round(prog["gflops"], 3)
        out.append(rec)
        for w in prog["whatif"]:
            wrec = {
                "type": "whatif",
                "v": SCHEMA_VERSION,
                "ts": ts,
                "trace": base,
                "algo": algo,
                "scenario": w["scenario"],
                "saved_s": round(w["saved_s"], 9),
                "wall_s": round(w["wall_s"], 9),
                "projected_wall_s": round(w["projected_wall_s"], 9),
                "wall_pct": round(w["wall_pct"], 3),
            }
            if "projected_gflops" in w:
                wrec["gflops"] = round(w["gflops"], 3)
                wrec["projected_gflops"] = round(w["projected_gflops"], 3)
            out.append(wrec)
    return out


def _fmt_ms(s: float) -> str:
    return f"{s * 1e3:8.3f}"


def format_report(report: dict, top_n: int = 32) -> str:
    lines = []
    lines.append(
        f"critpath: {report['events']} step-joined device events, "
        f"coverage {report['coverage']:.1%} (join={report['join']}, "
        f"device busy {report['device_busy_s'] * 1e3:.3f} ms)"
    )
    for algo, prog in report.get("programs", {}).items():
        hdr = (
            f"\n{algo}: {prog['n_steps']} steps x {prog['n_runs']} runs"
            f"{' (scan)' if prog['scan'] else ''}, wall {_fmt_ms(prog['wall_s']).strip()} ms, "
            f"gaps {_fmt_ms(prog['gap_total_s']).strip()} ms, "
            f"critical path {_fmt_ms(prog['critical_path_s']).strip()} ms, "
            f"bound: {prog['bound']}, lookahead {int(prog['lookahead'])}"
        )
        if "gflops" in prog:
            hdr += f", {prog['gflops']:.1f} GF/s"
        lines.append(hdr)
        lines.append(
            "  step     wall ms  panel ms   bulk ms   comm ms  exp.comm   copy ms"
            "   idle ms    gap ms  bound"
        )
        for s in prog["steps"][:top_n]:
            if s.get("empty"):
                lines.append(f"  {s['step']:4d}  (no device events)")
                continue
            ph = s.get("phases", {})
            panel = ph.get("panel", 0.0) + ph.get("strip", 0.0)
            bulk = ph.get("bulk", 0.0) + ph.get("other", 0.0)
            lines.append(
                f"  {s['step']:4d}  {_fmt_ms(s.get('wall_s', 0.0))}  {_fmt_ms(panel)}"
                f"  {_fmt_ms(bulk)}  {_fmt_ms(s.get('comm_s', 0.0))}"
                f"  {_fmt_ms(s.get('comm_exposed_s', 0.0))}  {_fmt_ms(s.get('copy_s', 0.0))}"
                f"  {_fmt_ms(s.get('idle_s', 0.0))}  {_fmt_ms(s.get('gap_after_s', 0.0))}"
                f"  {s.get('bound', '')}"
            )
        if len(prog["steps"]) > top_n:
            lines.append(f"  ... {len(prog['steps']) - top_n} more steps")
        lines.append(f"  critical path: {' -> '.join(prog['critical_path'])}")
        lines.append("  what-if:")
        for w in prog["whatif"]:
            line = (
                f"    {w['scenario']:<17} saves {_fmt_ms(w['saved_s']).strip()} ms "
                f"-> wall -{w['wall_pct']:.1f}%"
            )
            if "projected_gflops" in w:
                line += f", {w['gflops']:.1f} -> {w['projected_gflops']:.1f} GF/s"
            lines.append(line)
    if not report.get("programs"):
        lines.append("(no per-step programs attributed)")
    return "\n".join(lines)


def load_records(path: str) -> list[dict]:
    records = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


# ---------------------------------------------------------------------------
# CLI


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out_path = json_path = distill_path = inject = None
    top_n = 32
    steps_hint = None
    positional = []
    i = 0
    try:
        while i < len(argv):
            a = argv[i]
            if a in ("-h", "--help"):
                print(__doc__)
                return 0
            if a == "-o":
                i += 1
                out_path = argv[i]
            elif a == "--json":
                i += 1
                json_path = argv[i]
            elif a == "--distill":
                i += 1
                distill_path = argv[i]
            elif a == "--top":
                i += 1
                top_n = int(argv[i])
            elif a == "--steps":
                i += 1
                steps_hint = int(argv[i])
            elif a == "--inject-gap":
                i += 1
                inject = argv[i]
            elif a.startswith("-"):
                print(f"critpath: unknown option {a}", file=sys.stderr)
                return 2
            else:
                positional.append(a)
            i += 1
    except (IndexError, ValueError):
        print(__doc__, file=sys.stderr)
        return 2
    if len(positional) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trace_path, jsonl_path = positional
    try:
        events = load_trace(trace_path)
        records = load_records(jsonl_path)
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(f"critpath: {exc}", file=sys.stderr)
        return 2
    try:
        if inject is not None:
            algo, step, seconds = parse_inject(inject)
            n = inject_gap(events, records, algo, step, seconds)
            print(
                f"critpath: injected {seconds * 1e3:.1f} ms before "
                f"{algo}.step{step:03d} in {n} runs",
                file=sys.stderr,
            )
        report = attribute(events, records, steps_hint=steps_hint)
    except ValueError as exc:
        print(f"critpath: {exc}", file=sys.stderr)
        return 1
    # artifacts before stdout: a SIGPIPE from a closed pager must not lose them
    if out_path:
        recs = records_from_report(report, trace_path)
        with open(out_path, "a", encoding="utf-8") as fh:
            for rec in recs:
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
    if json_path:
        with open(json_path, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")
    if distill_path:
        kept = _devtrace_distill(events, records)
        write_trace(distill_path, kept)
        print(f"critpath: distilled {len(kept)} events -> {distill_path}", file=sys.stderr)
    print(format_report(report, top_n))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
