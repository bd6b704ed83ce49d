"""Findings + committed-baseline workflow for the static-analysis layer.

Port of ``dlaf_tpu/analysis/findings.py``, unchanged in behaviour. A
:class:`Finding` is one rule violation at one site. A committed baseline
file (``dlaf_tpu_torch/analysis/baseline.json``) grandfathers the
findings that predate a rule, and the gate fails on any finding NOT in
the baseline — so the codebase can only get cleaner. The baseline is keyed
on ``rule|site|detail`` (not line numbers), so unrelated edits that move
code around do not churn it; ``site`` carries the line only for the
human report.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``rule``   — stable rule id (``graph-*`` from the tape auditor,
                 ``lint-*`` from the AST linter).
    ``site``   — where: ``path:line`` for lint, the program spec name
                 (e.g. ``cholesky.dist.L.la1.comm1``) for graph checks.
    ``message``— human-readable description, printed in reports.
    ``key_detail`` — the stable identity tail; defaults to the message.
                 Lint findings override it with a line-number-free form
                 so editing an unrelated part of a file cannot churn
                 the baseline.
    """

    rule: str
    site: str
    message: str
    key_detail: Optional[str] = None

    @property
    def key(self) -> str:
        return f"{self.rule}|{self.key_detail if self.key_detail is not None else self.site}"

    def __str__(self) -> str:
        return f"{self.site}: [{self.rule}] {self.message}"


def load_baseline(path: str) -> List[str]:
    """Read the committed baseline: a JSON document
    ``{"findings": [key, ...]}``. A missing file is an empty baseline."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return []
    if not isinstance(doc, dict) or not isinstance(doc.get("findings"), list):
        raise ValueError(f"{path}: baseline must be {{'findings': [...]}}")
    keys = doc["findings"]
    if not all(isinstance(k, str) for k in keys):
        raise ValueError(f"{path}: baseline keys must be strings")
    return keys


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    doc = {
        "comment": "Grandfathered dlaf_tpu_torch.analysis findings. The "
                   "gate fails on any finding not listed here; remove "
                   "entries as the underlying issue is fixed (ROADMAP.md "
                   "section 3 gives each its reason).",
        "findings": sorted({f.key for f in findings}),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def diff_baseline(findings: Sequence[Finding], baseline: Sequence[str],
                  ) -> Tuple[List[Finding], List[str]]:
    """(new findings not grandfathered, stale baseline keys no longer
    observed). New findings fail the gate; stale keys are reported so
    the baseline shrinks as code is fixed."""
    base = set(baseline)
    new = [f for f in findings if f.key not in base]
    seen = {f.key for f in findings}
    stale = sorted(base - seen)
    return new, stale
