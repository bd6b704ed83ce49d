"""Request-scoped trace correlation.

Port of ``dlaf_tpu/obs/context.py`` (pure Python, copied). One
context-local slot holding ``(trace_id, span_id)``; the JSONL sink
(:mod:`.sinks`) stamps both onto EVERY record written while
the context is active — ``request``, ``dispatch``, span, ``accuracy``,
and ``resilience`` — so a single ID joins a request's whole
causal chain from ``Queue.submit`` through retry/breaker decisions to
its serve records, with zero per-record plumbing at the emit
sites.

Conventions (the serving layer is the reference user, serve/queue.py):

* ``trace_id`` — one 16-hex-char ID per REQUEST, generated at
  ``Queue.submit``. Records scoped to one request carry it as a string;
  records scoped to a whole batch (a dispatch record, the retry records
  of a batched dispatch, a program compile triggered by the batch) carry
  the LIST of member trace IDs — ``obs.aggregate --trace <id>`` matches
  both.
* ``span_id`` — one 16-hex-char ID per batch DISPATCH, shared by the
  dispatch record and every member request's records; it is the join key
  between a request and the stage timings of the dispatch that served it.

Cost contract: with no context entered, the stamp check in the sink is
one ``ContextVar.get`` returning the ``None`` default — no allocation.
``contextvars`` (not a bare thread-local) so the IDs survive executor
hops the way the rest of the tracing machinery expects.
"""

from __future__ import annotations

import contextlib
import contextvars
import uuid

#: (trace, span_id) of the active context, or None. ``trace`` is a str,
#: a tuple of strs (batch scope), or None (span_id-only contexts).
_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "dlaf_trace_ctx", default=None)


def new_trace_id() -> str:
    """A fresh 16-hex-char request trace ID."""
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    """A fresh 16-hex-char dispatch span ID."""
    return uuid.uuid4().hex[:16]


@contextlib.contextmanager
def trace_context(trace_id=None, span_id=None):
    """Stamp ``trace_id``/``span_id`` onto every record emitted inside.

    ``trace_id`` may be a single ID (request scope), a list/tuple of IDs
    (batch scope — e.g. every member of a dispatch), or None to keep the
    enclosing context's trace while overriding only ``span_id``.
    Entering with both None is a no-op passthrough. Contexts nest; the
    innermost non-None value of each slot wins."""
    outer = _CTX.get()
    if trace_id is None and span_id is None:
        yield
        return
    if isinstance(trace_id, (list, tuple, set)):
        trace = tuple(str(t) for t in trace_id) or None
    elif trace_id is not None:
        trace = str(trace_id)
    else:
        trace = outer[0] if outer else None
    if span_id is None and outer:
        span_id = outer[1]
    token = _CTX.set((trace, str(span_id) if span_id is not None else None))
    try:
        yield
    finally:
        _CTX.reset(token)


def current_trace():
    """``(trace, span_id)`` of the active context — ``trace`` a str or
    tuple of strs — or ``(None, None)``."""
    ctx = _CTX.get()
    return ctx if ctx is not None else (None, None)


def single_trace_id():
    """The active trace ID when the context is request-scoped (a single
    string), else None — exemplar capture only attributes a latency
    observation to ONE request, never to a whole batch."""
    ctx = _CTX.get()
    return ctx[0] if ctx is not None and isinstance(ctx[0], str) else None


def record_stamp(record: dict) -> None:
    """Stamp the active context onto ``record`` (sink write path): sets
    ``trace_id`` (str, or list for batch scope) and ``span_id`` unless
    the emitter already provided them."""
    ctx = _CTX.get()
    if ctx is None:
        return
    trace, span_id = ctx
    if trace is not None and "trace_id" not in record:
        record["trace_id"] = list(trace) if isinstance(trace, tuple) \
            else trace
    if span_id is not None and "span_id" not in record:
        record["span_id"] = span_id


def trace_matches(record: dict, trace_id: str) -> bool:
    """Whether ``record`` belongs to ``trace_id`` — equal to its string
    ``trace_id``, or a member of its batch-scope list (the join predicate
    of ``obs.aggregate --trace``)."""
    tid = record.get("trace_id")
    if isinstance(tid, str):
        return tid == trace_id
    if isinstance(tid, (list, tuple)):
        return trace_id in tid
    return False
