"""Device-timeline attribution from profiler traces.

Port of ``dlaf_tpu/obs/devtrace.py``. It reads the Chrome trace a
``DLAF_TRACE_DIR`` run writes (``obs.trace.stop_profiler``: one
``dlaf_trace.r<rank>.p<pid>.json`` per process, a ``torch.profiler``
(Kineto) trace) and turns it into measured per-phase device facts: op
classification, the phase join, measured overlap and measured GFlop/s.
The reference's XLA rules stay (``hlo_op``/``hlo_module`` args,
``/device:`` process tracks, the midpoint join), so a jax.profiler trace
such as the reference's ``tests/fixtures/devtrace/`` replays through
this module to the same report. A Kineto trace takes the rules below.

**Device ops.** A Kineto device op is a complete event (``ph == "X"``)
of category ``kernel``, ``gpu_memcpy`` or ``gpu_memset``.
``gpu_user_annotation`` (the device-side mirror of a ``record_function``
range: counting it would count every phase twice), ``cuda_runtime``,
``cuda_driver``, ``cpu_op`` and ``user_annotation`` are never ops.

**Phase join by launch.** On a TPU the host annotations and the device
ops share one program, and the reference gives a device interval to the
innermost span window containing its midpoint. On a CUDA card the host
runs ahead: a kernel often executes after the range that launched it has
closed. Here a device op's phase is the innermost vocabulary
``user_annotation`` on its launching thread that contains its launching
runtime call: the ``cuda_runtime``/``cuda_driver`` event with the same
``args.correlation``, or the host end of its ``ac2g`` flow. A device op
whose launch the trace does not carry falls back to the midpoint join.
A trace with no vocabulary annotation at all takes the reference's
rebase join (:func:`_fallback_windows`, through
:func:`.aggregate.rebase_per_rank`); ``join`` reports which.

**Span vocabulary.** The reference takes it from the artifact's ``span``
records. The port's per-step ``named_span`` writes no record, so the
vocabulary is the artifact's span names, plus every name of the step
patterns (``<algo>.step<k>[.<phase>]``, ``<algo>.scanstep[.<phase>]``),
plus the ``comm.<verb>`` names. A ``comm.<verb>`` range is not a phase:
it classifies what it launches (below), and the phase of such an op is
the innermost other vocabulary range around its launch.

**Collectives.** On the TPU a collective is an XLA op, classified by
name. In the port each verb of :mod:`..comm.collectives` runs inside
``obs.named_span("comm.<verb>")`` while a profiler is armed. Under the
single controller a verb is device-local copies; across processes it is
NCCL kernels or gloo's staging copies. Every device op launched inside
such a range is ``collective``, of the verb's kind in the reference's
spelling (:data:`VERB_KINDS`):

    ==============================  ========================
    verb                            kind
    ==============================  ========================
    bcast, bcast2d, bcast_arrays    collective-broadcast
    all_reduce, reduce, barrier     all-reduce
    all_gather                      all-gather
    all_to_all                      all-to-all
    send_recv, exchange             collective-permute
    scatter                         send
    gather                          recv
    ==============================  ========================

An NCCL kernel launched outside such a range is classified by its name.

**The other categories on the card** (:func:`classify_op` with a Kineto
category): ``mxu`` is product work, the name kept so that the records
and validators stay the reference's: cuBLAS/CUTLASS GEMM, TRSM and SYRK
kernels, ``potrf``/``cholesky``, and the port's hand kernels
(``potrf_kernel``, ``trinv_kernel``, ``strip_kernel``, ``slab_kernel``,
``masked_update_kernel``, ``slice_fold_kernel``, ``givens_undo_kernel``);
``copy`` is ``Memcpy DtoD``/``PtoP``, ``Memset`` and the gather, scatter,
cat, transpose, index and copy kernels; ``host_callback`` is ``Memcpy
HtoD``/``DtoH``; ``compute`` the rest.

**Overlap domain.** One CUDA device (``args.device``, all its streams),
as one TPU device is one in the reference.

Two JSONL record types land in the schema (:mod:`.sinks`): one
``devtrace`` summary (per-phase busy walls, attribution coverage; on a
Kineto trace its ``attrs.kernels`` holds each device op's launches and
busy seconds by short name, and ``attrs.lost_launches`` the launches the
trace holds no device op of) and one ``measured_overlap`` record per phase
with positive attributed collective time. ``python -m
dlaf_tpu_torch.obs.validate --require-devtrace`` gates on them.

CLI::

    python -m dlaf_tpu_torch.obs.devtrace <trace.json[.gz] | trace_dir> \\
        merged.jsonl [more.jsonl ...] [-o enriched.jsonl] \\
        [--json report.json] [--distill small.trace.json.gz] [--top N]

Prints the attribution report; ``-o`` writes the input records plus the
new ``devtrace``/``measured_overlap`` records; ``--distill`` writes a
reduced trace (metadata, device ops, their runtime launches and flows,
and the vocabulary's host ranges), which replays to the same report.

Exit status: 0 = report produced; 1 = unreadable trace/artifact or a
trace with no device op events (a CPU-only trace has none: an empty
attribution must fail loudly); 2 = usage.
"""

from __future__ import annotations

import collections
import functools
import glob
import gzip
import json
import os
import re
import sys
import time

#: Collective op-name prefixes -> kind label (XLA HLO spelling; checked
#: before every other category so ``all-gather`` never classifies as a
#: data-movement ``gather``).
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "all-to-all",
                    "reduce-scatter", "collective-permute",
                    "collective-broadcast", "send", "recv")

#: Name tokens that mark MXU work in an XLA op name.
MXU_TOKENS = ("dot", "conv", "cholesky", "triangular-solve", "einsum")

#: Name tokens for data movement in an XLA op name.
COPY_TOKENS = ("copy", "transpose", "bitcast", "slice", "concatenate",
               "gather", "scatter", "broadcast", "reshape", "pad")

#: Name tokens for host round trips in an XLA op name.
HOST_TOKENS = ("custom-call", "infeed", "outfeed", "host-")

#: Classification categories, display order.
CATEGORIES = ("mxu", "collective", "copy", "host_callback", "compute")

#: Kineto categories of device ops.
KINETO_OP_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: Kineto categories of host calls that launch device work.
KINETO_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

#: Each verb of ``comm/collectives.py`` -> its kind (the module docstring's
#: table).
VERB_KINDS = {"bcast": "collective-broadcast", "bcast2d": "collective-broadcast",
              "bcast_arrays": "collective-broadcast", "all_reduce": "all-reduce",
              "reduce": "all-reduce", "barrier": "all-reduce",
              "all_gather": "all-gather", "all_to_all": "all-to-all",
              "send_recv": "collective-permute", "exchange": "collective-permute",
              "scatter": "send", "gather": "recv"}

#: Lower-case name tokens of product kernels on the card: the port's hand
#: kernels, cuBLAS/cuBLASLt (``gemm``, ``nvjet``, ``xmma``, split-K's
#: reduction), CUTLASS, and the solver kernels.
KINETO_MXU_TOKENS = ("potrf_kernel", "trinv_kernel", "strip_kernel", "slab_kernel",
                     "masked_update_kernel", "slice_fold_kernel", "givens_undo_kernel",
                     "gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas", "splitkreduce",
                     "trsm", "trsv", "syrk", "herk", "potrf", "cholesky")

#: Lower-case name tokens of data-movement kernels.
KINETO_COPY_TOKENS = ("copy", "gather", "scatter", "catarray", "transpose", "index",
                      "memcpy", "memset")

#: NCCL kernel name tokens (lower case) -> kind.
NCCL_KINDS = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
              ("reducescatter", "reduce-scatter"), ("alltoall", "all-to-all"),
              ("broadcast", "collective-broadcast"), ("sendrecv", "collective-permute"),
              ("send", "send"), ("recv", "recv"), ("reduce", "all-reduce"))

#: The step patterns of the per-step names (the reference critpath's
#: ``_STEP_RE``/``_SCAN_RE``), anchored to a whole range name.
STEP_RE = re.compile(r"([A-Za-z0-9_]+)\.step(\d+)(?:\.(panel|strip|bulk))?")
SCAN_RE = re.compile(r"([A-Za-z0-9_]+)\.scanstep(?:\.(panel|strip|bulk))?")
COMM_RE = re.compile(r"comm\.([a-z_0-9]+)")


def classify_op(name: str, cat=None):
    """``(category, kind)`` for one device op — ``kind`` is the collective
    kind for collectives, None otherwise. Without ``cat`` (or with an XLA
    event's), ``name`` is an XLA op name and the reference's rules apply;
    they return ``(None, None)`` for profiler-infrastructure events
    (``::``-qualified C++ names, spaced descriptions). With a Kineto
    device category (``kernel``, ``gpu_memcpy``, ``gpu_memset``) the
    card's rules apply: NCCL kernels by name, then host copies, product
    kernels, data movement, and the rest as ``compute``."""
    if cat in KINETO_OP_CATS:
        return _classify_kineto(name or "", cat)
    if not name or "::" in name or " " in name:
        return None, None
    base = name.split(".")[0]
    for kind in COLLECTIVE_KINDS:
        if base.startswith(kind) or f"_{kind}" in base:
            return "collective", kind
    for tok in HOST_TOKENS:
        if tok in base:
            return "host_callback", None
    for tok in MXU_TOKENS:
        if tok in base:
            return "mxu", None
    for tok in COPY_TOKENS:
        if tok in base:
            return "copy", None
    return "compute", None


def _classify_kineto(name: str, cat: str):
    low = name.lower()
    if cat == "gpu_memset":
        return "copy", None
    if cat == "gpu_memcpy":
        return ("host_callback", None) if ("htod" in low or "dtoh" in low) else ("copy", None)
    if "nccl" in low:
        for tok, kind in NCCL_KINDS:
            if tok in low:
                return "collective", kind
        return "collective", "collective-permute"
    for tok in KINETO_MXU_TOKENS:
        if tok in low:
            return "mxu", None
    for tok in KINETO_COPY_TOKENS:
        if tok in low:
            return "copy", None
    return "compute", None


@functools.lru_cache(maxsize=4096)
def short_name(name: str) -> str:
    """A device op's name without ``void``, template arguments and
    parameters: ``potrf_kernel`` for ``void potrf_kernel<float>(...)``,
    ``Memcpy DtoD`` for ``Memcpy DtoD (Device -> Device)``."""
    s = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    out, depth = [], 0
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


def newest_trace(root: str) -> str:
    """Newest trace under ``root``: the port's own files
    (``dlaf_trace.*.json[.gz]``), ``torch.profiler``'s
    (``*.pt.trace.json[.gz]``) and the reference's ``*.trace.json.gz``;
    the Chrome trace is preferred over a perfetto one at equal recency."""
    pats = ("dlaf_trace.*.json", "dlaf_trace.*.json.gz", "*.pt.trace.json",
            "*.trace.json.gz", "perfetto_trace.json.gz")
    cands = sorted({p for pat in pats
                    for p in glob.glob(os.path.join(root, "**", pat), recursive=True)},
                   key=os.path.getmtime)
    if not cands:
        raise SystemExit(f"no trace (dlaf_trace.*.json, *.pt.trace.json, *.trace.json.gz) "
                         f"under {root}")
    chrome = [c for c in cands if not c.endswith("perfetto_trace.json.gz")]
    return (chrome or cands)[-1]


def load_trace(path: str) -> list:
    """Trace events from a Chrome trace file (gzipped or plain JSON; a
    directory is resolved through :func:`newest_trace`)."""
    if os.path.isdir(path):
        path = newest_trace(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _meta_maps(events):
    """(process names by pid, thread names by (pid, tid))."""
    procs, threads = {}, {}
    for e in events:
        if e.get("ph") != "M":
            continue
        if e.get("name") == "process_name":
            procs[e.get("pid")] = (e.get("args") or {}).get("name", "")
        elif e.get("name") == "thread_name":
            threads[(e.get("pid"), e.get("tid"))] = \
                (e.get("args") or {}).get("name", "")
    return procs, threads


#: Kineto categories that are host work, never a device op or a window
#: of the midpoint join's XLA rules (a fast path: most events are these).
_KINETO_HOST_CATS = frozenset(("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
                               "gpu_user_annotation", "python_function", "cpu_instant_event",
                               "overhead", "ac2g", "Trace"))


#: Kineto categories whose events are never a window: the ranges are
#: ``user_annotation`` events (XLA's carry no category).
_NEVER_WINDOWS = (_KINETO_HOST_CATS - {"user_annotation"}) | frozenset(KINETO_OP_CATS)


def _is_kineto_op(e) -> bool:
    return e.get("cat") in KINETO_OP_CATS


def _is_device_event(e, procs) -> bool:
    """A device-op interval: a Kineto ``kernel``/``gpu_memcpy``/
    ``gpu_memset`` event, or (the reference's rules) one carrying the XLA
    ``hlo_op``/``hlo_module`` args or living on a ``/device:`` process.
    Kineto's host events and its ``gpu_user_annotation`` mirrors on the
    device tracks are never one."""
    cat = e.get("cat")
    if cat in KINETO_OP_CATS:
        return True
    if cat in _KINETO_HOST_CATS:
        return False
    args = e.get("args") or {}
    if "hlo_op" in args or "hlo_module" in args:
        return True
    return str(procs.get(e.get("pid"), "")).startswith("/device:")


def _domain(e, procs):
    """The overlap domain of one device op (see :func:`device_events`)."""
    if _is_kineto_op(e):
        return ("device", (e.get("args") or {}).get("device", e.get("pid")))
    pid = e.get("pid")
    return pid if str(procs.get(pid, "")).startswith("/device:") else (pid, e.get("tid"))


def device_events(events) -> list:
    """Classified device intervals: ``(start_us, end_us, category, kind,
    name, domain)`` for every complete (``ph == "X"``) device-op event.
    ``domain`` is the overlap domain: one CUDA device (``args.device``)
    on a Kineto trace, the process for ``/device:`` tracks, the single
    executor thread on an XLA:CPU host-process trace. The category here
    is the op's own (:func:`classify_op`); :func:`attribute` also makes
    every op launched inside a ``comm.<verb>`` range a collective."""
    return [(o["lo"], o["hi"], o["cat"], o["kind"], o["name"], o["domain"])
            for o in device_ops(events)]


#: Host calls that put an op on the device (the names ``lost_launches``
#: counts).
LAUNCH_CALL_TOKENS = ("LaunchKernel", "Memcpy", "Memset")


def lost_launches(events, windows) -> int:
    """Launching runtime calls (:data:`LAUNCH_CALL_TOKENS`) inside one of
    ``windows`` (``(lo, hi, name, (pid, tid))``, on the calling thread)
    whose correlation no device op of the trace carries: attributed work
    the profiler did not record. 0 on a complete trace."""
    ops = {(e.get("args") or {}).get("correlation") for e in events
           if e.get("ph") == "X" and e.get("cat") in KINETO_OP_CATS}
    points = [(float(e.get("ts", 0.0)), (e.get("pid"), e.get("tid"))) for e in events
              if e.get("ph") == "X" and e.get("cat") in KINETO_LAUNCH_CATS
              and any(tok in e.get("name", "") for tok in LAUNCH_CALL_TOKENS)
              and (e.get("args") or {}).get("correlation") not in ops]
    return sum(w is not None for w in innermost(points, windows))


def device_ops(events) -> list:
    """Every device op with its launch: dicts ``lo``/``hi`` (us),
    ``cat``/``kind`` (:func:`classify_op`), ``name``, ``domain`` and
    ``launch``, the ``(pid, tid, ts)`` of its launching host call: the
    ``cuda_runtime``/``cuda_driver`` event of the same
    ``args.correlation``, else the host end (``ph == "s"``) of its
    ``ac2g`` flow; None where the trace carries neither (XLA traces).
    ``event`` is the trace event itself."""
    procs, _ = _meta_maps(events)
    launch, flow_src, flow_dst, found = {}, {}, {}, []
    for e in events:
        ph = e.get("ph")
        cat = e.get("cat")
        if ph != "X":
            if cat == "ac2g" and ph in ("s", "f"):
                key = (e.get("pid"), e.get("tid"), float(e.get("ts", 0.0)))
                if ph == "s":
                    flow_src.setdefault(e.get("id"), key)
                else:
                    flow_dst[key] = e.get("id")
            continue
        if cat in KINETO_LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = (e.get("pid"), e.get("tid"), float(e.get("ts", 0.0)))
        elif _is_device_event(e, procs):
            found.append(e)
    classes: dict = {}
    out = []
    for e in found:
        kineto = e.get("cat") in KINETO_OP_CATS
        name = e.get("name", "?")
        key = (name, kineto and e.get("cat"))
        if key not in classes:
            classes[key] = classify_op(e.get("name", ""), e.get("cat") if kineto else None)
        cat, kind = classes[key]
        if cat is None:
            continue
        start = float(e.get("ts", 0.0))
        ln = None
        if kineto:
            ln = launch.get((e.get("args") or {}).get("correlation"))
            if ln is None:
                ln = flow_src.get(flow_dst.get((e.get("pid"), e.get("tid"), start)))
        out.append({"lo": start, "hi": start + float(e.get("dur", 0.0) or 0.0),
                    "cat": cat, "kind": kind, "name": name,
                    "domain": _domain(e, procs), "launch": ln, "event": e})
    return out


def span_vocabulary(records) -> set:
    """The artifact's span names (the reference's whole vocabulary)."""
    return {r.get("name", "?") for r in records
            if isinstance(r, dict) and r.get("type") == "span"}


def in_vocabulary(name, span_names) -> bool:
    """A range name the join uses: an artifact span name, a step name
    (:data:`STEP_RE`, :data:`SCAN_RE`) or a ``comm.<verb>`` name."""
    return isinstance(name, str) and (
        name in span_names or STEP_RE.fullmatch(name) is not None
        or SCAN_RE.fullmatch(name) is not None or COMM_RE.fullmatch(name) is not None)


def host_span_events(events, span_names) -> list:
    """``(start_us, end_us, name)`` for host-thread events whose names
    are in the JSONL span vocabulary — the TraceAnnotation mirrors that
    become phase windows. Host threads carry thousands of jax-internal
    events (``dce``, ``cholesky_expander``); only the vocabulary match
    keeps them out of the phase set."""
    return [(lo, hi, name) for lo, hi, name, _ in _host_windows(events, span_names, False)]


def _host_windows(events, span_names, patterns: bool = True) -> list:
    """``(start_us, end_us, name, (pid, tid))`` of the vocabulary's host
    ranges (with ``patterns``, :func:`in_vocabulary`'s; else the span
    names only). Device events and device-side annotation mirrors are
    never windows."""
    procs, _ = _meta_maps(events)
    names = set(span_names)
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") in _NEVER_WINDOWS:
            continue
        name = e.get("name")
        if not (name in names or (patterns and in_vocabulary(name, ()))) \
                or _is_device_event(e, procs):
            continue
        start = float(e.get("ts", 0.0))
        out.append((start, start + float(e.get("dur", 0.0) or 0.0), name,
                    (e.get("pid"), e.get("tid"))))
    return out


def _union(intervals):
    """Union length-preserving merge of ``[(lo, hi)]`` (sorted input not
    required)."""
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def _intersect_len(a_sorted_union, b_sorted_union) -> float:
    out, i, j = 0.0, 0, 0
    a, b = a_sorted_union, b_sorted_union
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _fallback_windows(records, devs) -> list:
    """Phase windows when the trace carries no annotation mirrors:
    JSONL spans rebased per rank (the ``--align`` machinery of
    :mod:`.aggregate`) onto the device-event origin — inter-clock offset
    drops out, honest to within dispatch skew."""
    from .aggregate import rebase_per_rank

    if not devs:
        return []
    t0 = min(lo for lo, *_ in devs)
    out = []
    for r in rebase_per_rank(records):
        if r.get("type") != "span":
            continue
        end = (r.get("ts") or 0.0) * 1e6 + t0
        dur = (r.get("dur_s") or 0.0) * 1e6
        out.append((end - dur, end, r.get("name", "?")))
    return out


def innermost(points, windows) -> list:
    """For each point ``(t, key)`` the index into ``windows`` (``(lo, hi,
    name, key)``) of the innermost (shortest) window with the same key
    containing ``t``, or None. A point of key None matches windows of
    every key (the midpoint join). A sweep: points in time order, windows
    activated by start and expired lazily, so the join costs
    O((P + W) log P + P * nesting depth), not O(P x W)."""
    groups: dict = {None: list(range(len(windows)))}
    for wi, w in enumerate(windows):
        if w[3] is not None:
            groups.setdefault(w[3], []).append(wi)
    out = [None] * len(points)
    by_key: dict = {}
    for pi, (_, key) in enumerate(points):
        by_key.setdefault(key, []).append(pi)
    for key, pis in by_key.items():
        # (lo, hi, name) order, as the reference's sorted windows: the
        # first of two equal windows wins
        wins = sorted(groups.get(key, ()), key=lambda wi: windows[wi][:3])
        pis.sort(key=lambda pi: points[pi][0])
        active: list = []
        k = 0
        for pi in pis:
            t = points[pi][0]
            while k < len(wins) and windows[wins[k]][0] <= t:
                active.append(wins[k])
                k += 1
            if any(windows[wi][1] < t for wi in active):
                active = [wi for wi in active if windows[wi][1] >= t]
            best = None
            for wi in active:
                lo, hi = windows[wi][0], windows[wi][1]
                if lo <= t <= hi and (best is None
                                      or hi - lo < windows[best][1] - windows[best][0]):
                    best = wi
            out[pi] = best
    return out


def join_points(ops, join: str) -> list:
    """The point of each op :func:`innermost` places: its launch ``(ts,
    (pid, tid))``, else (no launch, or the rebase join, whose windows lie
    on the device clock) its midpoint with key None."""
    return [(o["launch"][2], o["launch"][:2]) if o["launch"] is not None and join != "rebase"
            else ((o["lo"] + o["hi"]) / 2.0, None) for o in ops]


def join_ops(events, records) -> tuple:
    """The port's join of one trace to one merged artifact: ``(ops,
    windows, join)``. ``ops`` are :func:`device_ops`' dicts, each also
    with ``phase_w`` (index into ``windows`` of its phase: the innermost
    non-``comm`` vocabulary range around its launch, else around its
    midpoint; None outside every one) and ``op_cat``, its own category;
    an op launched inside a ``comm.<verb>`` range is a collective of the
    verb's kind.
    ``windows`` are ``(lo_us, hi_us, name, key)``. ``join`` is
    ``"annotation"``, or ``"rebase"`` when the trace has no vocabulary
    range (the JSONL spans rebased onto the device origin)."""
    ops = device_ops(events)
    span_names = span_vocabulary(records)
    windows = _host_windows(events, span_names)
    join = "annotation"
    if not windows:
        devs = [(o["lo"], o["hi"]) for o in ops]
        windows = [(lo, hi, name, None) for lo, hi, name in _fallback_windows(records, devs)]
        join = "rebase"
    phase_ws = [w for w in windows if not COMM_RE.fullmatch(w[2])]
    comm_ws = [w for w in windows if COMM_RE.fullmatch(w[2])]
    points = join_points(ops, join)
    phase_idx = innermost(points, phase_ws)
    # a comm range classifies only what it launched
    launched = [i for i, p in enumerate(points) if p[1] is not None]
    comm_idx = [None] * len(ops)
    for i, cw in zip(launched, innermost([points[i] for i in launched], comm_ws)):
        comm_idx[i] = cw
    index = {id(w): i for i, w in enumerate(windows)}
    for o, pw, cw in zip(ops, phase_idx, comm_idx):
        o["phase_w"] = index[id(phase_ws[pw])] if pw is not None else None
        o["op_cat"] = o["cat"]
        if cw is not None:
            o["cat"] = "collective"
            o["kind"] = VERB_KINDS.get(COMM_RE.fullmatch(comm_ws[cw][2]).group(1),
                                       "collective-permute")
    return ops, windows, join


def attribute(events, records) -> dict:
    """The attribution report joining one trace to one merged artifact.

    Returns::

        {"device_busy_s", "attributed_s", "coverage", "events",
         "domains", "join",                       # "annotation"|"rebase"
         "categories": {cat: seconds},            # whole-trace totals
         "phases": {name: {"busy_s",              # sum over tracks
                           "wall_s",              # union across tracks
                           "categories": {cat: s},
                           "flops", "measured_gflops"}},  # when modeled
         "overlap": [{"algo", "axis", "collective_s", "overlapped_s",
                      "overlap_frac", "mxu_busy_s",
                      "kinds": {kind: s}}, ...],
         "knobs": {attr: [values]},
         "kernels": {short name: {"launches", "busy_s", "category"}},
         "lost_launches": n}

    (the category of a kernel is its own, :func:`classify_op`'s, of most
    of its busy time: a ``comm`` range does not change it)

    ``kernels`` and ``lost_launches`` (:func:`lost_launches`, in the
    vocabulary's ranges) only where device ops carry their launches (a
    Kineto trace). ``coverage`` = attributed device busy / total device busy —
    the floor ``--require-devtrace`` enforces. Raises ValueError when the
    trace carries no device op events (an empty attribution must fail
    loudly, not report 100 % of nothing)."""
    ops, windows, join = join_ops(events, records)
    if not ops or not any(o["hi"] > o["lo"] for o in ops):
        # zero-duration-only traces would divide coverage by zero below;
        # both shapes mean the same thing — nothing to attribute
        raise ValueError("trace contains no device op events with "
                         "duration (kernel/gpu_memcpy/gpu_memset, hlo_op-tagged "
                         "or /device:-track intervals)")
    spans = [r for r in records if isinstance(r, dict)
             and r.get("type") == "span"]
    total_busy = 0.0
    attributed = 0.0
    cat_totals = collections.Counter()
    phases: dict = {}
    mxu_by_domain: dict = {}
    coll_by_phase: dict = {}
    kernels: dict = {}
    for o in ops:
        lo, hi, cat, kind, domain = o["lo"], o["hi"], o["cat"], o["kind"], o["domain"]
        dur = (hi - lo) / 1e6
        total_busy += dur
        cat_totals[cat] += dur
        if o["launch"] is not None:
            cell = kernels.setdefault(short_name(o["name"]), {"launches": 0, "busy_s": 0.0,
                                                              "category": {}})
            cell["launches"] += 1
            cell["busy_s"] += dur
            cell["category"][o["op_cat"]] = cell["category"].get(o["op_cat"], 0.0) + dur
        if cat == "mxu":
            mxu_by_domain.setdefault(domain, []).append((lo, hi))
        if o["phase_w"] is None:
            continue
        phase = windows[o["phase_w"]][2]
        attributed += dur
        cell = phases.setdefault(phase, {"busy_s": 0.0, "_ivs": [],
                                         "categories":
                                             collections.Counter()})
        cell["busy_s"] += dur
        cell["_ivs"].append((lo, hi))
        cell["categories"][cat] += dur
        if cat == "collective":
            coll_by_phase.setdefault(phase, []).append(
                (lo, hi, kind, domain))
    for cell in phases.values():
        cell["wall_s"] = sum(hi - lo for lo, hi in
                             _union(cell.pop("_ivs"))) / 1e6
        cell["categories"] = dict(cell["categories"])
    for cell in kernels.values():
        # a short name may stand for several instantiations: the category
        # of most of its busy time
        cell["category"] = max(cell["category"], key=cell["category"].get)
    # measured MFU: flop-modeled span names -> device busy wall
    flops_by_name = collections.Counter()
    for s in spans:
        f = s.get("flops")
        if isinstance(f, (int, float)) and not isinstance(f, bool) \
                and s.get("name") in phases:
            flops_by_name[s["name"]] += float(f)
    for name, f in flops_by_name.items():
        cell = phases[name]
        cell["flops"] = f
        if cell["wall_s"] > 0:
            cell["measured_gflops"] = f / cell["wall_s"] / 1e9
    # measured overlap per attributed phase: collective time coinciding
    # with MXU-busy time in the same overlap domain
    mxu_union = {d: _union(iv) for d, iv in mxu_by_domain.items()}
    overlap = []
    for phase, colls in sorted(coll_by_phase.items()):
        coll_s = sum(hi - lo for lo, hi, _, _ in colls) / 1e6
        if coll_s <= 0:
            continue
        overlapped = 0.0
        kinds = collections.Counter()
        for lo, hi, kind, domain in colls:
            kinds[kind] += (hi - lo) / 1e6
            overlapped += _intersect_len([(lo, hi)],
                                         mxu_union.get(domain, []))
        overlapped_s = min(overlapped / 1e6, coll_s)
        overlap.append({
            "algo": phase, "axis": "all",
            "collective_s": coll_s, "overlapped_s": overlapped_s,
            "overlap_frac": overlapped_s / coll_s,
            # phase-scoped like every sibling field: overlapped_s /
            # mxu_busy_s is a meaningful ratio
            "mxu_busy_s": phases[phase]["categories"].get("mxu", 0.0),
            "kinds": dict(kinds)})
    from .aggregate import KNOB_ATTRS

    knobs: dict = {}
    for s in spans:
        for k in KNOB_ATTRS:
            if k in (s.get("attrs") or {}):
                knobs.setdefault(k, set()).add(s["attrs"][k])
    report = {
        "device_busy_s": total_busy,
        "attributed_s": attributed,
        "coverage": attributed / total_busy,
        "events": len(ops),
        "domains": len({o["domain"] for o in ops}),
        "join": join,
        "categories": dict(cat_totals),
        "phases": phases,
        "overlap": overlap,
        "knobs": {k: sorted(v) for k, v in knobs.items()},
    }
    if kernels:
        report["kernels"] = kernels
        report["lost_launches"] = lost_launches(events, windows)
    return report


def records_from_report(report: dict, trace: str) -> list:
    """The JSONL records the report lands as (schema: :mod:`.sinks`):
    one ``devtrace`` summary plus one ``measured_overlap`` record per
    (algo, axis) with positive attributed collective time — a
    zero-collective attribution emits NO overlap record, which is exactly
    what ``--require-devtrace`` rejects."""
    from .sinks import SCHEMA_VERSION

    ts = time.time()
    phases = {}
    for name, cell in report["phases"].items():
        out = {"busy_s": cell["busy_s"], "wall_s": cell["wall_s"],
               "categories": cell["categories"]}
        for key in ("flops", "measured_gflops"):
            if key in cell:
                out[key] = cell[key]
        phases[name] = out
    attrs = {"events": report["events"], "domains": report["domains"],
             "knobs": report["knobs"]}
    if "kernels" in report:
        attrs["kernels"] = report["kernels"]
        attrs["lost_launches"] = report["lost_launches"]
    recs = [{
        "v": SCHEMA_VERSION, "type": "devtrace", "ts": ts,
        "trace": os.path.basename(trace),
        "device_busy_s": report["device_busy_s"],
        "attributed_s": report["attributed_s"],
        "coverage": report["coverage"],
        "join": report["join"],
        "phases": phases,
        "attrs": attrs,
    }]
    for row in report["overlap"]:
        recs.append({
            "v": SCHEMA_VERSION, "type": "measured_overlap", "ts": ts,
            "algo": row["algo"], "axis": row["axis"],
            "collective_s": row["collective_s"],
            "overlapped_s": row["overlapped_s"],
            "overlap_frac": row["overlap_frac"],
            "mxu_busy_s": row["mxu_busy_s"],
            "kinds": row["kinds"],
            "attrs": {"trace": os.path.basename(trace)},
        })
    return recs


def format_report(report: dict, top_n: int = 25) -> list:
    """Printable lines for one attribution report."""
    lines = [
        f"device busy {report['device_busy_s'] * 1e3:.2f} ms over "
        f"{report['events']} op events, {report['domains']} domain(s); "
        f"attributed {report['attributed_s'] * 1e3:.2f} ms "
        f"(coverage {report['coverage'] * 100:.1f}%, "
        f"join={report['join']})"]
    cats = " ".join(f"{c}={report['categories'].get(c, 0.0) * 1e3:.2f}ms"
                    for c in CATEGORIES if c in report["categories"])
    lines.append(f"by category: {cats}")
    ranked = sorted(report["phases"].items(),
                    key=lambda kv: -kv[1]["busy_s"])[:top_n]
    for name, cell in ranked:
        cats = " ".join(f"{c}={cell['categories'].get(c, 0.0) * 1e3:.2f}"
                        for c in CATEGORIES if c in cell["categories"])
        mfu = (f"  measured {cell['measured_gflops']:.2f} GF/s (device)"
               if "measured_gflops" in cell else "")
        lines.append(f"  {cell['busy_s'] * 1e3:10.2f} ms busy  "
                     f"wall {cell['wall_s'] * 1e3:10.2f} ms  "
                     f"{name}  [{cats}]{mfu}")
    for row in report["overlap"][:top_n]:
        kinds = " ".join(f"{k}={v * 1e3:.2f}ms"
                         for k, v in sorted(row["kinds"].items()))
        lines.append(
            f"  overlap {row['algo']}/{row['axis']}: "
            f"{row['overlap_frac'] * 100:.1f}% of "
            f"{row['collective_s'] * 1e3:.2f} ms collective time "
            f"MXU-overlapped ({kinds})")
    if len(report["overlap"]) > top_n:
        lines.append(f"  ... {len(report['overlap']) - top_n} more overlap rows")
    if report["knobs"]:
        lines.append("  knob attrs seen: "
                     + " ".join(f"{k}={v}" for k, v in
                                sorted(report["knobs"].items())))
    if "lost_launches" in report:
        lines.append("  launches in the ranges without a device op in the trace: "
                     f"{report['lost_launches']}")
    for name, cell in sorted(report.get("kernels", {}).items(),
                             key=lambda kv: -kv[1]["busy_s"])[:top_n]:
        lines.append(f"  kernel {cell['busy_s'] * 1e3:10.3f} ms {cell['launches']:7d} "
                     f"launches  {cell['category']:<13s} {name[:90]}")
    return lines


def track_tables(events) -> list:
    """Per-track totals: ``[(track, total_ms, [(name, ms), ...])]`` sorted
    by total, complete events only."""
    procs, _ = _meta_maps(events)
    by_track = collections.defaultdict(collections.Counter)
    track_total = collections.Counter()
    for e in events:
        if e.get("ph") != "X":
            continue
        pid = e.get("pid")
        track = procs.get(pid, f"pid{pid}")
        dur = float(e.get("dur", 0) or 0) / 1e3    # us -> ms
        by_track[track][e.get("name", "?")] += dur
        track_total[track] += dur
    return [(track, total, by_track[track].most_common())
            for track, total in track_total.most_common()]


def distill(events, records) -> list:
    """The reduced trace for a committed fixture: metadata events, device
    op events, the runtime calls and ``ac2g`` flows that launched them
    (and every launching call, so that :func:`lost_launches` replays),
    and the vocabulary's host ranges — everything :func:`attribute` and
    the critical path consume, nothing else (a raw trace carries tens of
    thousands of host operator events). The distilled file replays to
    the same report."""
    procs, _ = _meta_maps(events)
    span_names = span_vocabulary(records)
    # the launches of the device ops: by correlation, or by flow id
    corrs = {(e.get("args") or {}).get("correlation") if e.get("ph") == "X" else e.get("id")
             for e in events if (e.get("ph") == "X" and _is_kineto_op(e))
             or (e.get("ph") == "f" and e.get("cat") == "ac2g")}
    corrs.discard(None)
    keep = []
    for e in events:
        ph = e.get("ph")
        cat = e.get("cat")
        if ph == "M":
            keep.append(e)
        elif ph in ("s", "f"):
            if cat == "ac2g" and e.get("id") in corrs:
                keep.append(e)
        elif ph != "X":
            continue
        elif cat in KINETO_LAUNCH_CATS:
            if (e.get("args") or {}).get("correlation") in corrs \
                    or any(tok in e.get("name", "") for tok in LAUNCH_CALL_TOKENS):
                keep.append(e)
        elif _is_device_event(e, procs) or (
                cat not in _NEVER_WINDOWS and in_vocabulary(e.get("name"), span_names)):
            keep.append(e)
    return keep


def write_trace(path: str, events) -> None:
    """A Chrome trace file of ``events`` (gzipped when ``path`` ends in
    ``.gz``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out_path = json_path = distill_path = None
    top_n = 25
    paths = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-o":
            i += 1
            out_path = argv[i] if i < len(argv) else None
        elif a == "--json":
            i += 1
            json_path = argv[i] if i < len(argv) else None
        elif a == "--distill":
            i += 1
            distill_path = argv[i] if i < len(argv) else None
        elif a == "--top":
            i += 1
            try:
                top_n = int(argv[i]) if i < len(argv) else top_n
            except ValueError:
                print(__doc__, file=sys.stderr)
                return 2
        elif a.startswith("-"):
            print(__doc__, file=sys.stderr)
            return 2
        else:
            paths.append(a)
        i += 1
    if len(paths) < 2 \
            or (out_path is None and "-o" in argv) \
            or (json_path is None and "--json" in argv) \
            or (distill_path is None and "--distill" in argv):
        print(__doc__, file=sys.stderr)
        return 2
    trace_path, jsonl_paths = paths[0], paths[1:]
    from .aggregate import merge_artifacts

    try:
        if os.path.isdir(trace_path):
            trace_path = newest_trace(trace_path)
        t0 = time.perf_counter()
        events = load_trace(trace_path)
        parse_s = time.perf_counter() - t0
        records = merge_artifacts(jsonl_paths)
        report = attribute(events, records)
    except (OSError, ValueError) as e:
        print(f"devtrace: {e}", file=sys.stderr)
        return 1
    # artifacts land BEFORE the human-facing report: a downstream
    # consumer piping the report through `head` closes stdout early
    # (SIGPIPE), and that must never cost the enriched artifact
    recs = records_from_report(report, trace_path)
    if out_path:
        with open(out_path, "w") as f:
            for r in records + recs:
                f.write(json.dumps(r, default=str) + "\n")
    if json_path:
        with open(json_path, "w") as f:
            json.dump(report, f, indent=1, default=str)
    if distill_path:
        kept = distill(events, records)
        write_trace(distill_path, kept)
    print(f"trace: {trace_path} ({os.path.getsize(trace_path)} bytes, {len(events)} events, "
          f"parsed in {parse_s:.3f} s)")
    for line in format_report(report, top_n):
        print(line)
    if not report["overlap"]:
        print("devtrace: WARNING — zero attributed collective device "
              "time; no measured_overlap record emitted "
              "(--require-devtrace will reject this artifact)",
              file=sys.stderr)
    if out_path:
        print(f"enriched artifact: {out_path} (+{len(recs)} devtrace "
              "records)")
    if json_path:
        print(f"report json: {json_path}")
    if distill_path:
        print(f"distilled trace: {distill_path} ({len(kept)} of "
              f"{len(events)} events kept)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
