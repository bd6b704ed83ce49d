"""CLI validator for DLAF_METRICS_PATH artifacts.

    python -m dlaf_tpu_torch.obs.validate <artifact.jsonl> [flags]

Flags:
    --require-spans         fail unless >= 1 span record
    --require-gflops        fail unless >= 1 span has finite derived gflops
    --require-collectives   fail unless a metrics snapshot carries a
                            positive dlaf_comm_collective_bytes_total
    --require-retries       fail unless >= 1 robust_cholesky.attempt span
                            with attempt >= 1 (an actual shifted retry)
    --require-fallbacks     fail unless a metrics snapshot carries a
                            positive dlaf_fallback_total
    --require-comm-overlap  fail unless a metrics snapshot carries positive
                            finite dlaf_comm_overlapped_total{algo,axis}
                            counters AND finite per-axis
                            dlaf_comm_collective_bytes_total for BOTH grid
                            axes (the comm look-ahead audit trail)
    --require-serve         fail unless the artifact carries a warmed
                            steady-state serving trail: >= 1 batched serve
                            dispatch (lanes >= 2, cache hit), ZERO
                            cache-miss dispatches and >= 1 request record
                            with finite latency
    --require-resilience    fail unless the artifact carries >= 1
                            resilience record with event retry or resume,
                            and NO dlaf_circuit_state gauge left at the
                            open value (2) in the last metrics snapshot
    --require-flight        validate the file as a flight-recorder
                            incident dump: >= 1 flight_trigger record with
                            a known reason AND >= 1 ordinary pre-trigger
                            record captured by the ring
    --prom                  print the last metrics snapshot as Prometheus
                            text exposition after validating

Exit status 0 = schema-valid (and all required content present); 1 =
errors (printed one per line); 2 = usage error (unknown flag, or not
exactly one path). Port of ``dlaf_tpu/obs/validate.py`` for the record
types the port writes (:mod:`.sinks`).
"""

from __future__ import annotations

import sys

from .metrics import prometheus_text
from .sinks import read_records, validate_records

_REQUIRES = ("spans", "gflops", "collectives", "retries", "fallbacks",
             "comm-overlap", "serve", "resilience", "flight")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {a for a in argv if a.startswith("--")}
    paths = [a for a in argv if not a.startswith("--")]
    known = {f"--require-{r}" for r in _REQUIRES} | {"--prom"}
    if len(paths) != 1 or flags - known:
        print(__doc__, file=sys.stderr)
        return 2
    path = paths[0]
    try:
        records = read_records(path)
    except (OSError, ValueError) as e:
        print(f"INVALID {path}: {e}", file=sys.stderr)
        return 1
    errors = validate_records(
        records, **{"require_" + r.replace("-", "_"): f"--require-{r}" in flags
                    for r in _REQUIRES})
    if errors:
        for e in errors:
            print(f"INVALID {path}: {e}", file=sys.stderr)
        return 1
    counts = {t: sum(r.get("type") == t for r in records)
              for t in ("span", "log", "serve", "resilience", "flight_trigger")}
    snaps = [r for r in records if r.get("type") == "metrics"]
    ranks = sorted({r["rank"] for r in records if "rank" in r})
    extra = f", {counts['serve']} serve records" if counts["serve"] else ""
    extra += f", {counts['resilience']} resilience records" if counts["resilience"] else ""
    extra += f", {counts['flight_trigger']} flight triggers" if counts["flight_trigger"] else ""
    extra += f", ranks {ranks}" if ranks else ""
    print(f"VALID {path}: {len(records)} records ({counts['span']} spans, "
          f"{len(snaps)} metrics snapshots, {counts['log']} logs{extra})")
    if "--prom" in flags and snaps:
        sys.stdout.write(prometheus_text(snaps[-1]["metrics"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
