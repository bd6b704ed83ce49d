"""``python -m dlaf_tpu_torch.analysis`` — the static-analysis gate.

Port of ``dlaf_tpu/analysis/__main__.py``. Runs the tape auditor
(:mod:`.graphcheck`: every builder recorded once on ``--device``, a 2x2
grid of that one device) and the convention linter (:mod:`.lint`), diffs
the findings against the committed baseline
(``dlaf_tpu_torch/analysis/baseline.json``), and exits 1 on any finding
not in it.

``--drill NAME`` runs one seeded-bad must-trip program (:mod:`.drills`)
instead: exit 1 with the expected rule named in the output proves the
gate can fail; exit 3 means the CHECK is broken (it no longer flags its
own drill). A usage error (an unknown drill, ``--device cuda`` with no
card, a walk that finds no file) exits 2.

``--device`` is ``cuda`` by default, as every entry point of the port:
the hand kernels then launch inside the recorded calls. ``--device cpu``
records the plain versions; the finding keys are the same on both.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dlaf_tpu_torch.analysis",
        description="op-tape graph auditor + repo-convention linter of the port")
    parser.add_argument("--root", default=".",
                        help="repo root to lint / find the baseline in")
    # mutually exclusive: both at once would skip every checker and
    # report a vacuously clean gate
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--lint-only", action="store_true", help="skip the graph auditor")
    only.add_argument("--graph-only", action="store_true", help="skip the linter")
    parser.add_argument("--baseline", default=None,
                        help="baseline path (default <root>/dlaf_tpu_torch/analysis/"
                             "baseline.json)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="grandfather ALL current findings and exit 0")
    parser.add_argument("--hbm-factor", type=float, default=None,
                        help="materialized-intermediate budget as a multiple of one "
                             "rank's input bytes")
    parser.add_argument("--drill", default=None, help="run one seeded-bad must-trip drill")
    parser.add_argument("--list-drills", action="store_true")
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                        help="where the recorded calls and the graph drills run")
    args = parser.parse_args(argv)

    from . import BASELINE_PATH, diff_baseline, load_baseline, write_baseline
    from . import lint as lint_mod

    if args.list_drills:
        from . import drills as drills_mod

        print("\n".join(sorted(drills_mod.DRILLS)))
        return 0

    needs_device = not args.lint_only and not (args.drill == "lint_violation")
    if needs_device and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            parser.error("--device cuda: no CUDA device here (pass --device cpu)")

    if args.drill:
        from . import drills as drills_mod

        try:
            findings, expected = drills_mod.run(args.drill, device=args.device)
        except KeyError as e:
            # a typo'd drill name must exit 2 (usage error), never 1 —
            # rc=1 is the "drill tripped" success contract
            parser.error(str(e))
        for f in findings:
            print(f)
        missing = set(expected) - {f.rule for f in findings}
        if missing:
            print(f"DRILL BROKEN: {args.drill} did not trip {sorted(missing)} — the "
                  f"checker lost its teeth", file=sys.stderr)
            return 3
        print(f"drill {args.drill}: tripped {sorted(set(expected))} as required")
        return 1

    findings = []
    if not args.lint_only:
        from . import graphcheck as graphcheck_mod

        kw = {}
        if args.hbm_factor is not None:
            kw["hbm_factor"] = args.hbm_factor
        stats: dict = {}
        t0 = time.perf_counter()
        findings.extend(graphcheck_mod.run(device=args.device, stats=stats, **kw))
        kernels: dict = {}
        for s in stats.values():
            for k, v in s["kernels"].items():
                kernels[k] = kernels.get(k, 0) + v
        print(f"graph: {len(stats)} programs recorded on {args.device}, "
              f"{sum(s['ops'] for s in stats.values())} ops, "
              f"{sum(kernels.values())} kernel nodes {dict(sorted(kernels.items()))}, "
              f"{sum(s['collectives'] for s in stats.values())} collectives, "
              f"{time.perf_counter() - t0:.2f} s")
    if not args.graph_only:
        try:
            findings.extend(lint_mod.run(args.root))
        except FileNotFoundError as e:
            # zero files scanned = misconfiguration, not a clean tree
            parser.error(str(e))

    baseline_path = args.baseline or os.path.join(args.root, BASELINE_PATH)
    if args.write_baseline:
        if args.lint_only or args.graph_only:
            # a partial run would overwrite the shared baseline with only
            # the selected checker's findings, silently erasing the other
            # checker's grandfathered keys
            parser.error("--write-baseline requires a full run (drop "
                         "--lint-only/--graph-only)")
        write_baseline(baseline_path, findings)
        print(f"wrote {len(findings)} finding key(s) to {baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    if args.lint_only or args.graph_only:
        # the other checker's grandfathered keys are not stale here
        prefix = "graph-" if args.graph_only else "lint-"
        baseline = [k for k in baseline if k.startswith(prefix)]
    new, stale = diff_baseline(findings, baseline)
    old = len(findings) - len(new)
    print(f"dlaf_tpu_torch.analysis: {len(findings)} finding(s) "
          f"({len(new)} new, {old} baselined), {len(stale)} stale baseline key(s)")
    for key in stale:
        print(f"  stale baseline entry (fixed? remove it): {key}")
    for f in new:
        print(f"  NEW {f}")
    if new:
        print(f"FAILED: {len(new)} new finding(s) — fix them or, for a deliberate "
              f"grandfather, rerun with --write-baseline and give the reason in "
              f"ROADMAP.md section 3", file=sys.stderr)
        return 1
    print("analysis gate: PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
