"""Run a miniapp on the card with its kernels built first, and report its
stages, peaks and kernel launches.

    python dlaf_tpu_torch/miniapp/stage_report.py --out DIR [--timeout S] \\
        MODULE [ARGS...]

e.g. BASELINE config #5 (the generalized eigensolver, float64, N=32768,
nb=512 on an 8x8 grid, every rank on the one card; give the call at least
1800 s):

    python dlaf_tpu_torch/miniapp/stage_report.py --out smoke_artifacts/config5 \\
        miniapp_gen_eigensolver -m 32768 -b 512 --grid-rows 8 --grid-cols 8 \\
        --share-device --type d --nwarmups 0 --nruns 1 --check-result last

It prints the card's name and power limit (``nvidia-smi``), builds the
hand kernels (one nvcc a source, all at once, as ``chip_smoke.py`` does;
skipped without a card), so that no build falls inside the timed run, then
runs ``peak_memory.py MODULE ARGS`` in a child process with
``DLAF_METRICS_PATH=DIR/run.jsonl``. The child prints the miniapp's lines,
its peak device memory, its peak resident set and the hand kernels'
launches. From the artifact this prints, for each timed run, its wall and
GFlop/s (the run span's flop model) and every ``stage.*`` span under it
with its share of the run's wall. The miniapps pass no PhaseTimer of
their own, so these stage spans are unfenced: a stage's queued device work
may finish inside the next one. Exits with the child's code.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card_line() -> str:
    """``name, power limit`` of the first card, or why there is none."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed ({e})"
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi failed"


def build_kernels() -> None:
    """Build and load the four kernel libraries (no-op without a card)."""
    import torch

    if not torch.cuda.is_available():
        print("[build] no card: the plain versions run", flush=True)
        return
    from dlaf_tpu_torch.tile_ops import cuda_build, givens_kernels, ozaki_kernels
    from dlaf_tpu_torch.tile_ops import panel_kernels, update_kernels

    t0 = time.perf_counter()
    libs = tuple(m.LIBRARY for m in (panel_kernels, ozaki_kernels, update_kernels,
                                     givens_kernels))
    cuda_build.build_all(libs)
    for lib in libs:
        lib.load()
    print(f"[build] {len(libs)} kernel libraries built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def stage_table(path: str) -> list[dict]:
    """One dict per timed run span of the artifact at ``path``: ``run``,
    ``wall`` (s), ``gflops`` and ``stages`` (name -> seconds summed, in
    first-seen order), the stage spans recorded since the previous run
    span. Warm-up runs are left out."""
    runs, stages = [], {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("type") != "span":
                continue
            name = rec.get("name", "")
            if name.startswith("stage."):
                stages[name] = stages.get(name, 0.0) + rec["dur_s"]
            elif name.startswith("miniapp_") and name.endswith(".run"):
                attrs = rec.get("attrs", {})
                if not attrs.get("warmup"):
                    runs.append({"run": attrs.get("run"), "wall": rec["dur_s"],
                                 "gflops": rec.get("gflops"), "stages": stages})
                stages = {}
    return runs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True, help="directory for the artifact")
    p.add_argument("--timeout", type=float, default=3300.0, help="the child's limit (s)")
    p.add_argument("module", help="a miniapp of dlaf_tpu_torch.miniapp")
    p.add_argument("args", nargs=argparse.REMAINDER)
    opts = p.parse_args(argv)
    if ROOT not in sys.path:
        # run as a script: the package lies beside this file's parent
        sys.path.insert(0, ROOT)
    os.makedirs(opts.out, exist_ok=True)
    artifact = os.path.join(opts.out, "run.jsonl")
    if os.path.exists(artifact):
        os.remove(artifact)
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[host] {os.cpu_count()} cores", flush=True)
    build_kernels()
    env = {**os.environ, "DLAF_METRICS_PATH": artifact,
           "PYTHONPATH": os.pathsep.join(filter(None, (ROOT, os.environ.get("PYTHONPATH"))))}
    cmd = [sys.executable, os.path.join(ROOT, "dlaf_tpu_torch", "miniapp", "peak_memory.py"),
           opts.module, *opts.args]
    print(f"[run] {' '.join(cmd[2:])}", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, start_new_session=True)
    try:
        rc = proc.wait(timeout=opts.timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        print(f"[run] killed at its {opts.timeout:.0f} s limit", flush=True)
        return 124
    print(f"[run] exit {rc} after {time.perf_counter() - t0:.1f} s (process start, set-up "
          "and check included)", flush=True)
    if not os.path.exists(artifact):
        print("[stages] no artifact", flush=True)
        return rc or 1
    for r in stage_table(artifact):
        gf = "not recorded" if r["gflops"] is None else f"{r['gflops']:.2f}"
        print(f"[stages] run {r['run']}: wall {r['wall']:.6f} s, {gf} GFlop/s [{card}]",
              flush=True)
        for name, s in r["stages"].items():
            print(f"[stages]   {name.removeprefix('stage.'):24s} {s:12.6f} s "
                  f"{100 * s / r['wall']:6.2f}% (unfenced)", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
