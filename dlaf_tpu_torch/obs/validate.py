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
    --require-accuracy      fail unless >= 1 accuracy record carries a
                            finite value and bound_ratio (the
                            DLAF_ACCURACY audit trail)
    --require-serve         fail unless the artifact carries a warmed
                            steady-state serving trail: >= 1 batched serve
                            dispatch (lanes >= 2, cache hit), ZERO
                            cache-miss dispatches, >= 1 request record
                            with finite latency and >= 1 per-request
                            accuracy record (site serve, finite value and
                            bound_ratio), and no serve site retraced
                            (dlaf_retrace_total{site=serve.*} >= 2)
    --require-resilience    fail unless the artifact carries >= 1
                            resilience record with event retry or resume,
                            and NO dlaf_circuit_state gauge left at the
                            open value (2) in the last metrics snapshot
    --require-telemetry     fail unless the artifact carries the program
                            telemetry trail: >= 1 finite compile-seconds
                            observation, finite memory accounting and
                            retrace evidence (program records or the
                            dlaf_compile_seconds / dlaf_hbm_bytes /
                            dlaf_retrace_total metrics)
    --require-autotune      fail unless >= 1 autotune record escalated or
                            relaxed a route, and no site's LAST decision
                            is 'exhausted' (an open incident)
    --require-fleet         fail unless the artifact carries the fleet
                            tier's zero-loss trail: >= 1 fleet record with
                            event route, ZERO ticket_lost records, and a
                            redispatch record wherever a worker died
                            ungracefully (worker_dead not 'drained')
    --require-devtrace      fail unless the artifact carries the
                            device-timeline attribution: >= 1
                            measured_overlap record with positive
                            attributed collective time AND >= 1 devtrace
                            record with attribution coverage >=
                            DEVTRACE_COVERAGE_FLOOR (0.5)
    --require-critpath      fail unless the artifact carries >= 1
                            critpath record with >= 1 step and join
                            coverage >= CRITPATH_COVERAGE_FLOOR (0.5) AND
                            >= 1 whatif projection record
    --require-flight        validate the file as a flight-recorder
                            incident dump: >= 1 flight_trigger record with
                            a known reason AND >= 1 ordinary pre-trigger
                            record captured by the ring
    --accuracy-history      validate the file as an append-only accuracy
                            history log (finite value/bound_ratio/n/nb,
                            non-empty site/metric/platform/dtype/ts/
                            source) instead of an artifact; incompatible
                            with the --require-* flags
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
from .sinks import read_records, validate_history_records, validate_records

_REQUIRES = ("spans", "gflops", "collectives", "retries", "fallbacks",
             "comm-overlap", "accuracy", "serve", "resilience", "flight",
             "telemetry", "autotune", "fleet", "devtrace", "critpath")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {a for a in argv if a.startswith("--")}
    paths = [a for a in argv if not a.startswith("--")]
    known = {f"--require-{r}" for r in _REQUIRES} | {"--prom", "--accuracy-history"}
    history = "--accuracy-history" in flags
    if len(paths) != 1 or flags - known or (history and len(flags) > 1):
        print(__doc__, file=sys.stderr)
        return 2
    path = paths[0]
    try:
        records = read_records(path)
    except (OSError, ValueError) as e:
        print(f"INVALID {path}: {e}", file=sys.stderr)
        return 1
    if history:
        errors = validate_history_records(records)
        for e in errors:
            print(f"INVALID {path}: {e}", file=sys.stderr)
        if errors:
            return 1
        print(f"VALID {path}: {len(records)} accuracy history entries")
        return 0
    errors = validate_records(
        records, **{"require_" + r.replace("-", "_"): f"--require-{r}" in flags
                    for r in _REQUIRES})
    if errors:
        for e in errors:
            print(f"INVALID {path}: {e}", file=sys.stderr)
        return 1
    counts = {t: sum(r.get("type") == t for r in records)
              for t in ("span", "log", "accuracy", "serve", "resilience",
                        "flight_trigger", "program", "autotune", "fleet")}
    snaps = [r for r in records if r.get("type") == "metrics"]
    ranks = sorted({r["rank"] for r in records if "rank" in r})
    extra = f", {counts['accuracy']} accuracy records" if counts["accuracy"] else ""
    extra += f", {counts['serve']} serve records" if counts["serve"] else ""
    extra += f", {counts['resilience']} resilience records" if counts["resilience"] else ""
    extra += f", {counts['flight_trigger']} flight triggers" if counts["flight_trigger"] else ""
    extra += f", {counts['program']} program records" if counts["program"] else ""
    extra += f", {counts['autotune']} autotune decisions" if counts["autotune"] else ""
    extra += f", {counts['fleet']} fleet records" if counts["fleet"] else ""
    n_dev = sum(r.get("type") in ("devtrace", "measured_overlap") for r in records)
    n_crit = sum(r.get("type") in ("critpath", "whatif") for r in records)
    extra += f", {n_dev} devtrace records" if n_dev else ""
    extra += f", {n_crit} critpath records" if n_crit else ""
    extra += f", ranks {ranks}" if ranks else ""
    print(f"VALID {path}: {len(records)} records ({counts['span']} spans, "
          f"{len(snaps)} metrics snapshots, {counts['log']} logs{extra})")
    if "--prom" in flags and snaps:
        sys.stdout.write(prometheus_text(snaps[-1]["metrics"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
