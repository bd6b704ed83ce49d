"""The route table: per-site route state and the pure decision core.

Port of ``dlaf_tpu/autotune/table.py``. One :class:`Entry` per site key
``(op, n_bucket, nb, dtype, platform)`` holds the current ladder rung, the
consecutive comfortable probes (the relax hysteresis), the relax budget
spent and a short probe history (observability only). Decisions are made
by :func:`decide`, a PURE function of ``(entry state, probe, policy)``:
an injected probe sequence replays the same decision trail every time,
and, in the multi-process form, every process fed the same (all-reduced)
probe takes the same decision.

Decision semantics (the reference's):

* ``bound_ratio > 1`` or a non-finite probe: **escalate** one rung at
  once (never throttled by the budget). At the top rung the decision is
  **exhausted** (the controller raises under ``DLAF_STRICT`` and trips
  the flight recorder).
* ``bound_ratio <= margin``: one comfortable probe; after
  ``relax_after`` CONSECUTIVE ones, **relax** one rung (floor: rung 0),
  spending one unit of the per-site ``budget`` (an exhausted budget
  holds).
* between: **hold**, and the comfortable streak restarts.

Persistence: a schema-versioned JSON document (the reference's, so a
table written by either package loads in the other), written atomically
(temp file, ``fsync``, ``os.replace``); ``load`` refuses loudly, naming
the field, on a malformed entry, another version or an entry stale
against the current ladders. A table built with ``writer=False`` (every
process but process 0 of a multi-process world) never writes its path.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
from typing import Dict, Optional

from .routes import Ladder, Route, dtype_name, ladder_for

#: Persisted-table schema version; bumped on any incompatible change.
TABLE_VERSION = 1

#: Probe history kept per entry (observability/debugging only — never
#: decision state, which is exactly (rung, holds, changes)).
HISTORY_CAP = 8

#: Decision vocabulary (mirrored by the ``autotune`` record schema in
#: obs/sinks.py, the single schema owner).
REASONS = ("escalate", "relax", "hold", "exhausted")


def bucket_n(n: int) -> int:
    """The table's n-bucket: next power of two >= max(n, 8) — the serve
    layer's auto bucket policy, so offline-learned routes and serving
    buckets share entries."""
    return 1 << max(int(n) - 1, 7).bit_length()


@dataclasses.dataclass(frozen=True)
class SiteKey:
    """One tuned site: the route-table key."""

    op: str
    n_bucket: int
    nb: int
    dtype: str
    platform: str

    @property
    def label(self) -> str:
        return (f"{self.op}.n{self.n_bucket}.nb{self.nb}."
                f"{self.dtype}.{self.platform}")


def site_key(op: str, *, n: int, nb: int, dtype, platform: str) -> SiteKey:
    """The table key of one call; ``dtype`` a torch or numpy dtype or a
    name, ``platform`` the device type (``cuda``, ``cpu``)."""
    return SiteKey(op=str(op), n_bucket=bucket_n(n), nb=int(nb),
                   dtype=dtype_name(dtype), platform=str(platform))


@dataclasses.dataclass
class Entry:
    """Mutable per-site state (decision state + audit history)."""

    rung: int
    holds: int = 0
    changes: int = 0            # relaxes consumed against the budget
    escalations: int = 0
    history: list = dataclasses.field(default_factory=list)
    calls: int = 0              # probe-cadence counter (never persisted)


@dataclasses.dataclass(frozen=True)
class Decision:
    """One decision: the reason, the rung transition, and the probe that
    drove it (``probe`` is +inf for a non-finite estimate)."""

    reason: str
    rung_old: int
    rung_new: int
    probe: float
    nonfinite: bool = False


def decide(rung: int, holds: int, changes: int, ratio: float, *,
           ladder_len: int, margin: float, relax_after: int,
           budget: int):
    """THE decision core — a pure function of (state, probe, policy);
    returns ``(reason, rung_new, holds_new, changes_new)``. See the
    module docstring for the semantics; every branch is pinned by
    tests/test_torch_autotune.py against the reference's."""
    nonfinite = not math.isfinite(ratio)
    if nonfinite or ratio > 1.0:
        # breach: escalate immediately (budget never throttles safety)
        if rung + 1 < ladder_len:
            return "escalate", rung + 1, 0, changes
        return "exhausted", rung, 0, changes
    if ratio <= margin:
        holds += 1
        if holds >= relax_after and rung > 0 \
                and (budget == 0 or changes < budget):
            return "relax", rung - 1, 0, changes + 1
        return "hold", rung, holds, changes
    # inside the budget but not comfortable: hold, streak resets
    return "hold", rung, 0, changes


class RouteTable:
    """Thread-safe site -> :class:`Entry` map over the ladder catalog
    (module docstring). ``path`` (optional) arms persistence: every
    applied decision re-serializes the table atomically, unless
    ``writer`` is False."""

    def __init__(self, path: str = "", *, writer: bool = True):
        self.path = str(path or "")
        self.writer = bool(writer)
        self._entries: Dict[SiteKey, Entry] = {}
        self._lock = threading.RLock()

    # -- route lookup ----------------------------------------------------

    def entry(self, key: SiteKey, ladder: Ladder) -> Entry:
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                ent = Entry(rung=ladder.start)
                self._entries[key] = ent
            return ent

    def route_for(self, key: SiteKey, ladder: Ladder) -> Route:
        with self._lock:
            return ladder.rungs[self.entry(key, ladder).rung]

    def rung_of(self, key: SiteKey) -> Optional[int]:
        with self._lock:
            ent = self._entries.get(key)
            return None if ent is None else ent.rung

    def tick(self, key: SiteKey, ladder: Ladder, every: int) -> bool:
        """Count one entry call against the site; True when the probe
        cadence (``DLAF_AUTOTUNE_PROBE_EVERY``) says this call should
        probe — the FIRST call always does. Call counts are in-memory
        only (persisting per call would turn every entry into a table
        write; decisions persist, ticks do not)."""
        with self._lock:
            ent = self.entry(key, ladder)
            due = ent.calls % max(int(every), 1) == 0
            ent.calls += 1
            return due

    # -- decisions -------------------------------------------------------

    def observe(self, key: SiteKey, ladder: Ladder, ratio: float, *,
                margin: float, relax_after: int, budget: int) -> Decision:
        """Feed one probe ``bound_ratio``; applies :func:`decide` to the
        site's entry and persists (when armed). Returns the decision."""
        nonfinite = not math.isfinite(float(ratio))
        with self._lock:
            ent = self.entry(key, ladder)
            reason, rung_new, holds_new, changes_new = decide(
                ent.rung, ent.holds, ent.changes, float(ratio),
                ladder_len=len(ladder.rungs), margin=margin,
                relax_after=relax_after, budget=budget)
            decision = Decision(reason=reason, rung_old=ent.rung,
                                rung_new=rung_new,
                                probe=(float("inf") if nonfinite
                                       else float(ratio)),
                                nonfinite=nonfinite)
            ent.rung = rung_new
            ent.holds = holds_new
            ent.changes = changes_new
            if reason == "escalate":
                ent.escalations += 1
            ent.history.append(None if nonfinite else float(ratio))
            del ent.history[:-HISTORY_CAP]
            if self.path and self.writer:
                self._save_locked(self.path)
        return decision

    # -- persistence -----------------------------------------------------

    def to_json(self) -> dict:
        with self._lock:
            entries = []
            for key in sorted(self._entries, key=lambda k: k.label):
                ent = self._entries[key]
                ladder = ladder_for(key.dtype)
                entries.append({
                    "op": key.op, "n_bucket": key.n_bucket, "nb": key.nb,
                    "dtype": key.dtype, "platform": key.platform,
                    "ladder": ladder.ident if ladder is not None else "",
                    "rung": ent.rung, "holds": ent.holds,
                    "changes": ent.changes,
                    "escalations": ent.escalations,
                    "history": list(ent.history),
                })
            return {"version": TABLE_VERSION, "entries": entries}

    def save(self, path: Optional[str] = None) -> str:
        with self._lock:
            return self._save_locked(path or self.path)

    def _save_locked(self, path: str) -> str:
        if not path:
            raise ValueError("RouteTable.save: no path configured "
                             "(DLAF_AUTOTUNE_TABLE)")
        doc = self.to_json()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        # atomic-replace discipline (matrix/checkpoint.py, obs/flight.py):
        # the table either exists complete or keeps its previous content
        os.replace(tmp, path)
        return path

    def load_dict(self, doc: dict, *, where: str = "<table>") -> None:
        """Warm-start from a parsed table document; refuses LOUDLY —
        naming the failing field — on malformed/stale/version-mismatched
        content (module docstring)."""
        if not isinstance(doc, dict):
            raise ValueError(f"{where}: autotune table must be a JSON "
                             "object")
        version = doc.get("version")
        if version != TABLE_VERSION:
            raise ValueError(
                f"{where}: field 'version' is {version!r}, this build "
                f"reads version {TABLE_VERSION} — refusing a cross-"
                "version warm start (re-learn or migrate the table)")
        entries = doc.get("entries")
        if not isinstance(entries, list):
            raise ValueError(f"{where}: field 'entries' must be a list, "
                             f"got {type(entries).__name__}")
        parsed: Dict[SiteKey, Entry] = {}
        for i, ent in enumerate(entries):
            w = f"{where}: entries[{i}]"
            if not isinstance(ent, dict):
                raise ValueError(f"{w}: must be an object")
            for field in ("op", "dtype", "platform", "ladder"):
                if not isinstance(ent.get(field), str) or not ent.get(field):
                    raise ValueError(f"{w}: field {field!r} missing or "
                                     "not a non-empty string")
            for field in ("n_bucket", "nb", "rung", "holds", "changes",
                          "escalations"):
                v = ent.get(field)
                if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                    raise ValueError(f"{w}: field {field!r} must be a "
                                     f"non-negative int, got {v!r}")
            hist = ent.get("history", [])
            if not isinstance(hist, list) or any(
                    h is not None and not isinstance(h, (int, float))
                    for h in hist):
                raise ValueError(f"{w}: field 'history' must be a list "
                                 "of numbers/nulls")
            ladder = ladder_for(ent["dtype"])
            if ladder is None:
                raise ValueError(f"{w}: field 'dtype' ({ent['dtype']!r}) "
                                 "has no ladder in this build — stale "
                                 "entry, refusing the warm start")
            if ent["ladder"] != ladder.ident:
                raise ValueError(
                    f"{w}: field 'ladder' ({ent['ladder']!r}) does not "
                    f"match this build's {ladder.ident!r} — the rung "
                    "indexes a different ladder; refusing the stale "
                    "warm start")
            if ent["rung"] >= len(ladder.rungs):
                raise ValueError(
                    f"{w}: field 'rung' ({ent['rung']}) outside the "
                    f"{len(ladder.rungs)}-rung {ladder.name} ladder")
            key = SiteKey(op=ent["op"], n_bucket=ent["n_bucket"],
                          nb=ent["nb"], dtype=ent["dtype"],
                          platform=ent["platform"])
            parsed[key] = Entry(
                rung=ent["rung"], holds=ent["holds"],
                changes=ent["changes"], escalations=ent["escalations"],
                history=[None if h is None else float(h) for h in hist])
        with self._lock:
            self._entries = parsed

    def load(self, path: Optional[str] = None) -> None:
        path = path or self.path
        doc = None
        for attempt in range(2):
            try:
                with open(path) as f:
                    doc = json.load(f)
                break
            except ValueError as e:
                # writers replace the table atomically (tmp + fsync +
                # os.replace), but a reader that opened the OLD inode
                # right as it was unlinked can still see a short read on
                # some filesystems. One immediate re-open lands on the
                # NEW complete inode; only a second failure means the
                # file is genuinely corrupt — refuse the warm start then.
                if attempt:
                    raise ValueError(f"{path}: unparsable autotune "
                                     f"table ({e})")
        self.load_dict(doc, where=path)

    # -- introspection ---------------------------------------------------

    def snapshot(self) -> dict:
        """Label -> entry summary."""
        with self._lock:
            return {k.label: dataclasses.asdict(e)
                    for k, e in self._entries.items()}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
