#!/usr/bin/env python3
"""Smoke test of the dlaf_tpu_torch port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written kernels (``dlaf_tpu_torch/csrc/panel.cu``,
``csrc/ozaki.cu``, ``csrc/update.cu`` and ``csrc/givens.cu``, one nvcc
each, started together) from the checkout, prints ptxas's registers,
shared memory and spills of the potrf, inverse, strip and slab product,
slice, update and Givens kernels (and fails on a spill), and
holds each kernel against its plain PyTorch version on the card: the panel
kernels (potrf, strip solve, factor+solve, fused step) in float32 and
bfloat16, potrf alone and the triangular inverse (through the strip solve,
unit and non-unit diagonal, both triangles) at d = 256, 200, 129, 64, 9, 8
and 1, indefinite tiles with the failing pivot at columns 1, 8, 9, 38 and
d or exactly zero (equal info and NaN masks through potrf, factor+solve
and step), and triangles with a NaN pivot at those columns (equal NaN
columns of the solved strip); the strip and slab products alone through
their C entries (transB 1 and 0, float32 and bfloat16 with the f32 copy,
d = 256, 200, 129, 9, 8, 1, m = 16128, 16127, 4099, 1000; inf and NaN in
``b`` at k the triangle's skip leaves out, with NaN masks equal to the
dense product's; the slab at w = d and w < d with a NaN above the mask);
the Givens undo bit for bit on rotation lists that stress its schedule
(disjoint pairs, anchor chains, a moving anchor, repeated pairs, 24-row
mixes; g = 3001, 2048, 17; w = 1000, 333, 129); the Ozaki slice kernels
(product, syrk) bit for bit at the main path's shapes, ragged shapes,
K = 32, 224, 256 and 1024 and 1, 2, 8 and 9 slices; the distributed
Cholesky's two kernels at
the shapes of its first step on one rank of a 2x2 grid (N=16384, nb=256:
32 x 32 tile pairs) and on ragged tiles: the predicated trailing update in
float32 and bfloat16, modes 0-3, in place on a strided view of a shard, at
nb = 256, 200, 136 and 130, with every pair dead, every pair live, a 1 x 1
table and transposed panels (as uplo 'U' passes them), and the predicated
Ozaki pair product bit for bit (also with every pair dead and every pair
live). It times each kernel, its plain version and a
PyTorch library yardstick with CUDA events (the kernel also over 50
back-to-back calls, without the host's work per call), then
drives the port's main paths through ``miniapp_cholesky.run``, each with
its launch counts:

1. N=16384, nb=256, float32, uplo L, fused step route, lookahead 1;
2. N=8192, nb=256, float32, uplo U, fused panel route (potrf + strip solve);
3. N=16384, nb=256, float64, uplo L, trailing "ozaki" with the Ozaki
   kernels (``ozaki_impl=pallas``), lookahead 1;
4. N=4096, nb=256, complex128, uplo U, the same route (``ozaki_impl``
   auto), lookahead 0;
5. N=8192, nb=256, float32, uplo L, trailing "scan" with the fused
   factor+solve kernel, lookahead 1;

and the distributed Cholesky with every rank of the grid on the one card
(``--share-device``), lookahead and comm_lookahead at their cuda defaults:

6. dist-L: N=16384, nb=256, float32, uplo L, 2x2, fused factor+solve and
   the predicated update kernel;
7. dist-U: N=8192, nb=256, float32, uplo U, 2x4, potrf and strip solve
   kernels and the update kernel;
8. dist-f64: N=16384, nb=256, float64, uplo L, 2x2, ``f64_gemm=mxu``,
   ``f64_trsm=mixed``: the Ozaki pair kernel for the bulk, the slice
   product for the panels and the look-ahead column;
9. dist-z: N=4096, nb=256, complex128, uplo U, 2x2, native (no kernel);

the multi-process form (``comm/multihost.py``: one process per rank):

9b. mp: 4 processes spawned on this card (2x2, ``cuda:0`` each, gloo, a
    ``file://`` rendezvous) factor dist-L (float32, defaults) and
    dist-f64 (``f64_gemm=mxu``, ``f64_trsm=mixed``, ``ozaki_impl=
    pallas``), solve config #2's LLNN at N=4096, nb=256, and run the
    eigensolver pipeline at N=4096: HEGST in complex128 (config #3's
    type) by twosolve and blocked, reduction to band (float64, nb=512,
    band 128; by default and under ``f64_gemm=mxu``), ``eigensolver``
    (nb=512, band 128, of the Toeplitz tridiagonal (2, 1), whose D&C,
    its merges of 512 and more sharded over the processes, must launch
    the Givens undo) and ``gen_eigensolver`` (nb=256, band 128); each
    process's shard (and
    taus, eigenvalues) must be bitwise the single controller's on the
    same card (the eigenvectors too, though the single controller applies
    the chase's reflectors once to its four ranks' columns side by side
    and a process to its own), and the launches summed over the processes
    its counts, or, where a value a grid line holds alike is formed once
    per device there (``cc.per_rank_once``), its counts with that sharing
    off (red2band-d-mxu's #6 also against ``red2band_mxu_launches``); then ``torchrun --standalone
    --nproc-per-node 4 -m dlaf_tpu_torch.miniapp.miniapp_cholesky -m 4096
    -b 256 --grid-rows 2 --grid-cols 2 --share-device`` in float32 (the
    float64 launch went to make room for the autotune phase), and one
    ``torchrun`` launch of miniapp_gen_to_std (complex128, N=4096),
    miniapp_reduction_to_band (config #4's widths at N=8192 on 2x2) and
    miniapp_gen_eigensolver (float64, N=2048, nb=256, 2x2) in turn in one
    world, its start-up and shutdown paid once (the room that buys goes to
    gen-evp-d-c5), each with one
    ``check: PASSED`` and its wall beside the single controller's run of
    the same arguments in this process (one card's processes meet over
    host-staged gloo, so these walls show the transport; a ``[wall]`` line
    for every case of the phase); with 4 or more visible cards the
    NCCL form (one card per process) of the float32 Cholesky, else one
    line saying it was not run;

the distributed scan Cholesky (``cholesky_trailing=scan``, 2x2):

10. dist-scan-L: N=16384, float32, uplo L, the fused factor+solve at the
    panel site of every rank every step (4 nt launches), lookahead 1;
    dist-scan-U: N=8192, float32, uplo U, the potrf and strip-solve
    kernels there instead (4 nt each);
11. dist-scan-f64: N=8192, float64, uplo U, ``f64_gemm=mxu``,
    ``ozaki_impl=pallas``, ``f64_trsm=mixed``: the Ozaki pair kernel for
    every step's bulk on every rank, slice products for the mixed panels
    and the eager next row;

and the triangular solver (``miniapp_triangular_solver.run``, m = n =
8192, nb=256, 2x2 unless named local):

12. trsm-d (BASELINE config #2, double, LLNN, default routes) under
    ``dist_step_mode=unrolled`` and ``scan``;
13. trsm-s: float32 LLN and RUC through the strip-solve kernel on every
    rank every step (4 nt launches a solve);
14. trsm-d-mxu: config #2 with ``f64_gemm=mxu``, ``f64_trsm=mixed``: slice
    products for the mixed panels and the bulk, one of its products held
    bit for bit against the plain version;
15. trsm-local: one rank, float64 and float32 (the recursive solve above
    order 2048);
16. trmm-d: ``triangular_multiply`` in double on 2x2, unrolled, checked
    against ``blas.trmm`` of the gathered matrices on the card;

HEGST (``miniapp_gen_to_std.run``: B factored once by ``cholesky``, then
warm-up and timed transforms of A, each with its check line and launch
counts, the Cholesky of B's included):

17. hegst-z-blocked, hegst-z-twosolve and hegst-z: BASELINE config #3
    (complex128, N=8192, nb=256, 2x2) by each formulation and on the
    default routes (no kernel);
18. hegst-z-mxu: config #3 blocked under ``f64_gemm=mxu``,
    ``f64_trsm=mixed``: the slice product (#6) for every pair, strip and
    panel product (four per complex product), counted exactly; one pair
    product at step 0's shape held bit for bit against the plain version;
19. hegst-s: float32, N=16384, 2x2, blocked, ``panel_impl=fused``: the
    strip solve (#2) 4(3nt-1) times a call; hegst-s-twosolve (#2 8nt a
    call, in its two solves) and hegst-s-default; hegst-s-U: uplo U on
    2x4 at N=8192, blocked; hegst-local-z and hegst-local-s: one rank,
    N=8192, each by both formulations and the default (local twosolve
    runs no kernel). The HEGST route phase fails when, in any of the four
    cells (z and s, 2x2 and one rank), the default is more than a quarter
    slower than the faster formulation;
20. qr: ``panel_qr`` of a random float64 (16384, 128) panel and the T
    factor from its reflectors, local and on 2x2 (blocks 512 x 128),
    checked as a compact-WY factorization and against each other;

reduction to band (``miniapp_reduction_to_band.run``: warm-up and timed
reductions, each with its eigenvalue check on the card, wall, GFlop/s,
peak device memory and launch counts) and the chase:

21. red2band-d and red2band-d-scan: BASELINE config #4 (float64,
    N=16384, nb=512, band 128, 4x4) by the default step mode (unrolled at
    127 panels) and by scan; red2band-local-d and red2band-local-d-scan:
    the same matrix on one rank; red2band-z: complex128, N=8192, nb=256,
    band 256, 2x2 (no kernel on any of them);
22. red2band-mxu: float64, N=4096, nb=512, band 128, 2x2 under
    ``f64_gemm=mxu``: #6 exactly ``red2band_mxu_launches`` a call; one
    bulk product at panel 0 (2048 x 2048, K = 128) and one W product
    (K = 1024) through #6 bit for bit against its plain version;
23. b2t-z: a seeded random Hermitian A reduced on the card (complex128
    N=4096, nb=256, band 128 on one rank), its band extracted and chased
    by the native chase on the host, the eigenvalues of (d, e) (scipy)
    against ``torch.linalg.eigvalsh(A)`` below 100 n eps; then a random A
    through each other builder the red2band cells drive (config #4 scan
    on 4x4 and on one rank, complex128 N=8192 on 2x2, red2band-mxu's cell
    with its exact #6 count), the band's eigenvalues against A's below
    100 n eps: the analytic setter of those cells has rank at most 4, so
    only a full spectrum checks their later panels (config #4's unrolled
    reduction and chase on a random A run in evp-d below);

the eigensolver (``eigensolver`` / ``gen_eigensolver`` with a PhaseTimer:
each stage's wall and share, GFlop/s by ``total_ops(5n^3/3, 5n^3/3)``,
peak device and host memory, the D&C's deflation fraction, Givens
rotations and secular route per level, launch counts; checked: the
eigenvalues against ``torch.linalg.eigvalsh`` below 100 n eps where A is
random, the eigenpair residual and the orthogonality below 200 n eps):

24. evp-d: a seeded random Hermitian A at BASELINE config #4's shape
    (float64, N=16384, nb=512, band 128, 4x4) by the default routes, the
    D&C's merges of 512 and more sharded over the 16 ranks; and
    evp-d-analytic, the analytic setter on that grid at N=8192 (its
    deflation and rotations); in every cell the Givens undo's launches exactly
    ``givens_launches`` of the call's merge statistics (one a column
    shard of each merge with rotations) and the peak device memory;
25. evp-local-d (float64, N=8192, nb=512, band 128, one rank: the local
    back-transforms), evp-z (complex128, N=4096, nb=256, band 128, 2x2),
    evp-scan (evp-z's shape in float64, ``dist_step_mode=scan``: both scan
    builders), evp-mxu (float64, N=4096, nb=512, band 128, 2x2,
    ``f64_gemm=mxu``: #6 exactly ``evp_mxu_launches`` a call, and bit for
    bit at a D&C merge product's and a chase back-transform's shape);
26. gen-evp-d and gen-evp-s: ``gen_eigensolver`` in float64 and float32
    (N=8192, nb=256, 2x2, uplo L, B the HPD generator's), the float32
    one with #1, #2, #3 and #5 exactly ``GEN_EVP_F32_GRID``; and
    gen-evp-d-c5, BASELINE config #5's shape (float64, nb = band = 512,
    8x8, the D&C's merges sharded over the 64 ranks) cut to N=4096 for
    room, its eigenvalues against ``_gen_reference``;
27. dc-route: the D&C of evp-d's tridiagonal by ``secular_device_min_k``
    2048, 4096, 8192 and host-only, with walls and peak memory, the
    host-only result checked, cuda's default (2048) on one device
    bitwise evp-d's sharded eigenvalues, its wall beside evp-d's sharded
    D&C stage; the defaults on an iid normal (d, e) and on a Toeplitz T, whose
    largest Givens undo (the hand-written kernel beside the eight) is
    held bit for bit against its plain loop and timed;
28. ``miniapp_eigensolver`` at N=4096, nb=256, 2x2, standard and
    ``--generalized``, with its check lines; the chase back-transform's
    blocked form (the path's) and the reference's sweeps form on evp-d's
    reflectors (512 columns);

the rest of the algorithms layer and the serving entry point, each path
with its launch counts (none, but the one #6 product under ``mxu``):

29. algos: ``max_norm`` ('G' and 'L') and the grid ``permute`` (a row and
    a column range of 4 tiles) at BASELINE config #4's shape (float64,
    N=16384, nb=512, 4x4, source rank (1, 2)), bitwise against
    ``abs().max()`` and ``index_select`` on the gathered matrix;
    ``general_sub_multiply`` (float64, N=8192, nb=256, 2x2) against
    ``torch.matmul`` at ``60 k eps``, natively over 16 tiles and under
    ``f64_gemm=mxu`` over 4 (one #6 launch); ``miniapp_gen_eigensolver``
    at N=4096, nb=256 with its check line;
30. serve: the batched entry points' lane parity (lane i of B = 4 and 16
    against B = 1, bitwise, in float32, float64 and complex128 at n = 20,
    48 and 200; the bare library call's parity printed beside it), pad
    lanes, info vector and donation; a warm stream of 2048 float64
    requests through ``serve.Queue`` (buckets 32/64/128/256, 16 lanes; n
    uniform over 17-256: 50% cholesky, 30% solve with 1-16 right-hand
    sides, 20% eigh) with every residual checked and its requests/s,
    p50/p99 latency, dispatches and lane fill; its Cholesky problems
    through the queue, ``cholesky_batched`` and a loop of singleton
    ``cholesky()`` calls; an overload pass (max_depth 16, shed, a 2x
    burst) that fails if depth passes the bound or a ticket is stranded;
    ``robust_cholesky_batched`` with two indefinite lanes;
31. fleet (``fleet/`` and ``obs/aggregate.py``; artifacts under
    ``smoke_artifacts/fleet``, :func:`fleet_phase`): real worker processes
    (``python -m dlaf_tpu_torch.fleet.worker``, each with its own CUDA
    context on the one card) behind in-process routers, serve's buckets,
    16 lanes, float64: (a) a warmed seeded 512-request stream of the serve
    mix through ``fleet_workers`` (3) workers and through one, every
    residual checked,
    requests/s, p50/p99 at the router, tickets per worker, start-up and
    warm-up seconds, no ``heartbeat_timeout``/``redispatch``/
    ``ticket_lost`` record; (b) 128 requests under a long deadline, the
    worker holding the most unacknowledged tickets SIGKILLed, every ticket
    correct, >= 1 redispatch, 0 lost, the recovery seconds, the merged
    artifact through ``--require-fleet``; (c) its SIGTERM twin (handbacks,
    no redispatch, exit 0, ``--require-fleet``); (d) failover off: the
    stranded tickets raise ``WorkerLostError`` and ``--require-fleet``
    rejects the artifact; (e) ``aggregate --trace`` of one redispatched
    ticket joins the router's route and redispatch records and the
    surviving worker's serve record; at shutdown every worker drains and
    exits 0, the SIGKILLed ones -9;
32. obs (the telemetry core; artifacts under the git-ignored
    ``smoke_artifacts/obs``): main-L (``miniapp_cholesky`` N=16384,
    nb=256, f32, fused step) with the knobs off and with
    ``DLAF_METRICS_PATH`` on, three timed calls each in-process: equal
    launch counts of #1/#4, the factor bitwise the same, the fenced
    ``miniapp_cholesky.run`` spans' GFlop/s within 2% of the printed ones,
    and through the CLI an artifact that ``python -m
    dlaf_tpu_torch.obs.validate --require-spans --require-gflops``
    accepts; one dist-L call (N=2048, 2x2) with ``trace_dir`` set, whose
    Chrome trace holds ``cholesky.step<k>.panel|strip|bulk`` once per step
    and every #5 launch inside a ``.bulk`` range; evp-d N=4096 2x2 on the
    Toeplitz tridiagonal (2, 1), whose artifact holds the pipeline's entry
    spans and ``dlaf_dc_merges_total`` and whose Givens undo launches; a
    warm 256-request stream of the serve mix with the records off, then
    with the records and ``/metrics`` on (one injected transient dispatch
    failure retried in each), two scrapes whose counters do not decrease,
    ``/healthz`` carrying the queue's stats, an artifact passing
    ``--require-serve --require-resilience``; ``torchrun``
    ``miniapp_cholesky`` N=4096 2x2 with ``run.%r.jsonl``: four valid
    artifacts, each of its own rank, with collective counters;

33. accuracy (``obs/accuracy.py``; artifacts under
    ``smoke_artifacts/accuracy``): main-L (float32, N=16384) and dist-L
    (2x2) factored once, the Hutchinson probe's and the exact residual's
    times and values (within ``60 n eps``); ``miniapp_cholesky`` under ``DLAF_ACCURACY=1`` and ``full``,
    one record a timed run, its artifacts through ``--require-accuracy``;
    a 256-request serve stream with ``DLAF_ACCURACY=1``, one record a
    request, through ``--require-serve``.

34. autotune (``autotune/`` and ``obs/telemetry.py``; artifacts under
    ``smoke_artifacts/autotune``), strict, ``DLAF_AUTOTUNE=1`` and
    ``DLAF_PROGRAM_TELEMETRY=1`` into one artifact (:func:`autotune_phase`):
    main-L's shape through the f32 ladder (two ``nan_tile`` breaches
    escalate to rungs 2 and 3, six clean calls relax back to the start
    rung, each call's launches the rung's, the start rung's factor bitwise
    the ``DLAF_AUTOTUNE=0`` one), the f64 ladder's slice rungs s = 5..8
    under ``f64_gemm=mxu`` (walls and residuals; #6 and #8 at every rung),
    dist-L 2x2 (a breach escalates, the next call runs the new route), the
    strict exhaustion drill (``--require-flight`` on its dump, its open
    artifact rejected by ``--require-autotune``), one line per telemetry
    site and main-L walls with the program records off and on; the
    artifact through ``--require-telemetry --require-autotune``.

35. devtrace (``obs/devtrace.py``, ``obs/critpath.py``; artifacts under
    ``smoke_artifacts/devtrace``), strict, within 60 s
    (:func:`devtrace_phase`): dist-L (N=16384, nb=256, f32, 2x2, fused
    step, lookahead on) and config #2's solve (trsm-d, N=8192, f64, LLNN,
    2x2, unrolled), each one warm call and one under ``DLAF_METRICS_PATH``
    and ``DLAF_TRACE_DIR``, merged by ``obs.aggregate``, through the
    devtrace and critpath CLIs (coverage, join, busy by category, the top
    phases, the ``measured_overlap`` row, critpath's step table, program
    line and what-ifs, the largest gaps; 64 and 32 steps); dist-L's
    enriched artifact through ``--require-devtrace --require-critpath``,
    each of its hand kernels named in the report at its wrappers' launch
    count and no launch in its ranges without a device op; the drills: ``--inject-gap cholesky.step032=5`` recovered
    within [5 ms - the boundary's lookahead overlap, 5 ms + 1 us],
    critpath on a main-L trace and devtrace on a CPU-activity trace exit 1.

36. analysis (``dlaf_tpu_torch/analysis``; artifacts under
    ``smoke_artifacts/analysis``), strict, within 60 s
    (:func:`analysis_phase`): ``python -m dlaf_tpu_torch.analysis``
    with ``--device cuda`` and ``--device cpu`` in the background, both
    exit 0 with no new and no stale baseline key (equal keys); main-L and
    dist-L (N=16384, nb=256, f32) recorded by ``analysis.depgraph.trace``
    after a warm call, before the gates start, under
    ``torch.cuda.set_sync_debug_mode("warn")``:
    kernel nodes equal to the launches, the runtime's sync warnings equal
    to the tape's host syncs, no finding outside the baseline, and dist-L's
    next panel collectives ahead of and independent of each step's bulk;
    the ``host_callback`` drill on the card (exit 1, one warning per
    finding). In the multi-process phase each process runs each case
    again, at N=2048 under an armed tape (the bitwise result and the
    wall come from its run with no tape), saves its verb schedule, and
    ``graphcheck.schedule_findings`` finds nothing for any case.

The script sets ``DLAF_ACCURACY=full``, so every miniapp's check (here
and in the processes it starts) computes the exact residual. On one card
the collectives are device-local copies and every rank repeats the
diagonal tile's factor, so these walls do not measure communication.
Each phase prints ``[phase] <name> <s>`` and its slow cases ``[wall]``
lines; a ``[wall]`` line before the kernels' JSON line gives the script's
wall from its start.

Then the route phase times the float64 (N=16384) and complex128 (N=8192)
defaults, with no knob set, beside every route "auto" could pick for them
(biggemm, loop, ozaki on either reduction, scan with native or mixed
panels and native or Ozaki products): one timed factorization each, with
its residual line and launch counts, and fails when the default is more
than a quarter slower than the fastest of them. It factors a small ragged
matrix against a float64 reference, profiles one float32 and one float64
(Ozaki) factorization, one dist-L, dist-U and dist-f64 factorization, one
config #2 solve unrolled and scan, one config #4 reduction to band and evp-d's
device stages (the D&C and both back-transforms), and prints a JSON line
of per-kernel numbers,
the card's name and power limit, and as its last line ``{"ok": true,
"device": {...}}``. Any failure
exits non-zero. It needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

#: Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s
#: and operations/s by input type (float32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12,
            # float64 outside the tensor cores (NVIDIA's data sheet): the
            # Givens undo's arithmetic
            "float64": 34e12}

EPS = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -8}


def smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi failed"


def time_ms(torch, fn, reps: int = 25, warm: int = 3) -> float:
    """Median over ``reps`` single calls, each timed with CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def batch_ms(torch, fn, calls: int = 50, warm: int = 3) -> float:
    """CUDA-event time per call over ``calls`` back-to-back calls: the
    card's time for the work while the host keeps ahead of it (a single
    call's event time also holds that call's host work)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def ptxas_report(libs, kernels) -> None:
    """Print ``-Xptxas -v``'s registers, shared memory and spills of each
    named kernel from this run's build; raise if one of them spills or is
    missing from the report."""
    seen = set()
    for lib in libs:
        lines = lib.log.splitlines()
        for i, line in enumerate(lines):
            name = next((k for k in kernels if k in line), None)
            if name is None or "Function properties" not in line:
                continue
            seen.add(name)
            spills, regs = lines[i + 1].strip(), lines[i + 2].split(":", 1)[-1].strip()
            print(f"[ptxas] {name}: {regs}; {spills}", flush=True)
            if "0 bytes spill stores, 0 bytes spill loads" not in spills:
                raise AssertionError(f"{name} spills registers: {spills}")
    if set(kernels) - seen:
        raise AssertionError(f"ptxas reported nothing for {sorted(set(kernels) - seen)}")


def rel_err(torch, got, ref) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|) over entries finite in
    both; raises if the NaN/inf patterns differ."""
    g, r = got.float(), ref.float()
    if not torch.equal(torch.isfinite(g), torch.isfinite(r)):
        raise AssertionError("non-finite patterns differ between kernel and plain version")
    fin = torch.isfinite(r)
    if not fin.any():
        return 0.0, 0.0
    err = float((g[fin] - r[fin]).abs().max())
    scale = float(r[fin].abs().max()) or 1.0
    return err, err / scale


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """Least time (ms) for the work, and what bounds it."""
    bt, ot = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[kind] * 1e3
    return max(bt, ot), "bytes" if bt >= ot else "operations"


def profile_run(torch, label: str, fn, host_ops: bool = False, warm: bool = True) -> None:
    """Where the time of one call of ``fn`` goes (after one warm-up call,
    unless ``warm`` is False: the caller ran the same shapes already):
    device time by kernel from ``torch.profiler``, and the device's busy
    share of the host wall (informational; prints what the profiler
    saw). By default the device activity alone is recorded (the printed
    sums are the device's): a call of tens of thousands of host operations
    is then parsed in seconds, not a minute; ``host_ops=True`` records the
    host's operations too."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
        name = name.split("(")[0][:70]
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    if not spans:
        print("[profile] the profiler recorded no device time", flush=True)
        return
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    print(f"[profile] {label}: host wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of wall)", flush=True)
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        print(f"[profile] {tot / 1e3:9.3f} ms {cnt:6d} launches  {name}", flush=True)


def profile_factorization(torch, dev, argv, letter: str, dtype, n: int = 16384,
                          nb: int = 256, grid_shape=None, uplo: str = "L") -> None:
    """:func:`profile_run` of one main-path factorization; with
    ``grid_shape`` every rank of that grid is on ``dev``."""
    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import GlobalElementSize, TileElementSize
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp.generators import hpd_element_fn

    config.initialize(argv=argv)
    grid = shared_grid(*grid_shape, dev) if grid_shape else None
    ref = Matrix.from_element_fn(hpd_element_fn(n, dtype), GlobalElementSize(n, n),
                                 TileElementSize(nb, nb), grid, dtype=dtype, device=dev)
    where = f" grid {grid_shape[0]}x{grid_shape[1]} on one card" if grid_shape else ""
    mats = [ref.clone(), ref.clone()]
    del ref
    profile_run(torch, f"n={n} nb={nb} {letter} uplo {uplo}{where} {' '.join(argv)}",
                lambda: cholesky(uplo, mats.pop(), donate=True))


def profile_trsm(torch, dev, mode: str, n: int = 8192, nb: int = 256) -> None:
    """:func:`profile_run` of one config #2 solve (double, m = n, LLNN, 2x2
    on ``dev``) in ``dist_step_mode`` ``mode``."""
    import numpy as np

    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.algorithms.triangular import triangular_solve
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import GlobalElementSize, TileElementSize
    from dlaf_tpu_torch.matrix.matrix import Matrix

    config.initialize(argv=[f"--dlaf:dist-step-mode={mode}"])
    grid = shared_grid(2, 2, dev)
    size, block = GlobalElementSize(n, n), TileElementSize(nb, nb)
    am = Matrix.from_element_fn(lambda i, j: 1.0 / (1.0 + (i - j).abs()) + 2.0 * n * (i == j),
                                size, block, grid, dtype=np.float64, device=dev)
    bm = Matrix.from_element_fn(lambda i, j: torch.cos(0.001 * (i + 1))
                                + torch.sin(0.002 * (j + 1)), size, block, grid,
                                dtype=np.float64, device=dev)
    mats = [bm.clone(), bm.clone()]
    profile_run(torch, f"trsm-d n={n} nb={nb} LLNN grid 2x2 on one card {mode}",
                lambda: triangular_solve("L", "L", "N", "N", 1.0, am, mats.pop(), donate_b=True))


def dist_kernels(torch, dev, randn, rows, check, time_ms, bound, card, uk, ok, oz) -> None:
    """The distributed Cholesky's two kernels against their plain versions
    and timed, at the shapes of its first step on rank (0, 0) of a 2x2 grid
    (N=16384, nb=256: the rank's 32 x 32 trailing tile pairs, lookahead
    on) and on ragged tiles; fills ``rows``."""
    import numpy as np

    from dlaf_tpu_torch.algorithms.dist_step import pair_modes

    R = C = 32
    nb = 256
    g = np.arange(R) * 2                                   # rank (0, 0)'s tiles
    step0 = {"L": pair_modes(g, g, 0, 64, "L", True), "U": pair_modes(g, g, 0, 64, "U", True)}
    rng = np.random.default_rng(3)

    def modes_tensor(m):
        return torch.tensor(m, dtype=torch.int32, device=dev)

    # ---- kernel #5: the predicated trailing update, in place ----
    for dt in (torch.float32, torch.bfloat16):
        tname = str(dt).split(".")[1]
        for case, (r_, c_, b_, mode), layout in (
                ("step-0 uplo L", (R, C, nb, step0["L"]), "rows"),
                # as the uplo 'U' sweep passes them: vr a transposed view
                ("step-0 uplo U", (R, C, nb, step0["U"]), "vr.mT"),
                ("step-0 uplo U both .mT", (R, C, nb, step0["U"]), "both.mT"),
                ("ragged nb=200 modes 0-3", (5, 7, 200, rng.integers(0, 4, (5, 7))), "rows"),
                ("nb=136 modes 0-3 vr.mT", (6, 4, 136, rng.integers(0, 4, (6, 4))), "vr.mT"),
                ("nb=136 every pair 2", (3, 3, 136, np.full((3, 3), 2)), "rows"),
                ("nb=200 every pair 3 .mT", (3, 2, 200, np.full((3, 2), 3)), "both.mT"),
                ("every pair dead", (4, 3, nb, np.zeros((4, 3), np.int64)), "rows"),
                ("every pair live nb=200", (3, 4, 200, np.ones((3, 4), np.int64)), "rows"),
                ("1x1 mode 1", (1, 1, nb, np.ones((1, 1), np.int64)), "rows"),
                ("1x1 mode 3 nb=136 .mT", (1, 1, 136, np.full((1, 1), 3)), "both.mT"),
                # nb off a multiple of 4: panels staged element by element
                ("nb=130 modes 0-3", (3, 4, 130, rng.integers(0, 4, (3, 4))), "rows"),
                ("nb=130 modes 0-3 .mT", (3, 4, 130, rng.integers(0, 4, (3, 4))), "both.mT")):
            # the block is a strided view of a shard one tile wider each way
            shard = randn(r_ + 1, c_ + 1, b_, b_).to(dt)
            before = shard.clone()
            vr, vc = randn(r_, b_, b_).to(dt), randn(c_, b_, b_).to(dt)
            mt = modes_tensor(mode)
            want = uk.masked_trailing_update_plain(before[1:, 1:], vr, vc, mt)
            # the same operands as transposed views of contiguous stacks
            if layout != "rows":
                vr = vr.mT.contiguous().mT
                if layout == "both.mT":
                    vc = vc.mT.contiguous().mT
                assert uk.panel_layout(vr) == 1
            uk.masked_trailing_update(shard[1:, 1:], vr, vc, mt)
            torch.cuda.synchronize()
            outside = torch.equal(shard[0], before[0]) and torch.equal(shard[:, 0], before[:, 0])
            if not outside:
                raise AssertionError(f"masked_trailing_update {case}: wrote outside its view")
            err = check("update", f"{tname} {case} {r_}x{c_} in place",
                        [(shard[1:, 1:], want)], dt, b_)
            if (dt, case) == (torch.float32, "step-0 uplo L"):
                rows["masked_trailing_update"] = {"max_abs_err": err}
            del shard, before, want

    # ---- kernel #7: the predicated Ozaki pair product, bit for bit ----
    s = 8

    def pair_slices(x, count, b):
        sc = oz._scale(x, -1)
        return torch.stack(oz._peel_slices(oz._normalize(x, sc), s)).reshape(s, count, b, -1)

    for case, (r_, c_, b_, mode) in (("step-0", (R, C, nb, step0["L"])),
                                     ("ragged mb=200", (5, 3, 200, rng.integers(0, 3, (5, 3)))),
                                     ("all modes 0", (4, 3, nb, np.zeros((4, 3), np.int64))),
                                     ("all live mb=136", (3, 4, 136, np.ones((3, 4), np.int64)))):
        ia = pair_slices(randn(r_ * b_, b_, dtype=torch.float64), r_, b_)
        ib = pair_slices(randn(c_ * b_, b_, dtype=torch.float64), c_, b_)
        mt = modes_tensor(mode)
        got = ok.ozaki_masked_product(ia, ib, mt)
        ref = ok.ozaki_masked_product_plain(ia, ib, mt)
        same = all(torch.equal(x, y) for x, y in zip(got, ref))
        err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
        print(f"[kernel] ozaki_masked {case} s={s} {r_}x{c_} pairs of {b_}x{b_}, "
              f"{int((mode != 0).sum())} live: hi and lo "
              f"{'bitwise equal' if same else 'DIFFER'} (max_abs_err={err:.3e})", flush=True)
        if not same:
            raise AssertionError(f"ozaki_masked_product {case}: not bitwise equal")
        if case == "step-0":
            rows["ozaki_masked_product"] = {"max_abs_err": err}
            ia0, ib0, mt0 = ia, ib, mt
        del got, ref
    torch.cuda.synchronize()

    # ---- times at the step-0 shape ----
    live = int((step0["L"] != 0).sum())
    # the operations the data needs: a diagonal pair (mode 2 or 3) only its
    # triangle, nb (nb + 1) / 2 entries of 2 nb each (not the whole pair)
    full = int((step0["L"] == 1).sum())
    upd_ops = full * 2 * nb ** 3 + (live - full) * nb * nb * (nb + 1)
    mt = modes_tensor(step0["L"])
    shard = randn(R + 1, C + 1, nb, nb)
    block = shard[1:, 1:]
    vr, vc = randn(R, nb, nb), randn(C, nb, nb)
    a64, b64 = randn(R * nb, nb, dtype=torch.float64), randn(nb, C * nb, dtype=torch.float64)
    timings = {
        # the einsum route's full rectangle: twice the kernel's work
        "masked_trailing_update": (
            lambda: uk.masked_trailing_update(block, vr, vc, mt),
            lambda: uk.masked_trailing_update_plain(block, vr, vc, mt),
            lambda: torch.matmul(vr.reshape(R * nb, nb), vc.reshape(C * nb, nb).mT),
            "float32 torch.matmul of the full 8192x256 @ 256x8192 rectangle",
            (2 * live + R + C) * nb * nb * 4, upd_ops, "float32"),
        "ozaki_masked_product": (
            lambda: ok.ozaki_masked_product(ia0, ib0, mt0),
            lambda: ok.ozaki_masked_product_plain(ia0, ib0, mt0),
            lambda: a64 @ b64, "float64 torch.matmul 8192x256 @ 256x8192",
            s * (R + C) * nb * nb + 8 * R * C * nb * nb,
            live * s * (s + 1) / 2 * 2 * nb ** 3, "int8"),
    }
    for name, (kern, plain, lib, label, nbytes, ops, kind) in timings.items():
        lib_ms = time_ms(torch, lib)
        bms, by = bound(nbytes, ops, kind)
        rows[name].update(ms=time_ms(torch, kern), batch_ms=batch_ms(torch, kern),
                          plain_ms=time_ms(torch, plain, reps=3), library_ms=lib_ms, bound_ms=bms,
                          bound_by=by)
        r = rows[name]
        print(f"[time] {name:22s} kernel={r['ms']:.4f} ms (batched {r['batch_ms']:.4f} ms) "
              f"plain={r['plain_ms']:.4f} ms "
              f"{label}={lib_ms:.4f} ms bound={bms:.5f} ms ({by}; {live} live pairs of "
              f"{R}x{C}) [{card}]", flush=True)
    whole = bound((2 * live + R + C) * nb * nb * 4, live * 2 * nb ** 3, "float32")[0]
    print(f"[time] masked_trailing_update bound with the diagonal pairs counted whole: "
          f"{whole:.5f} ms", flush=True)
    # the uplo 'U' sweep's operands: the row panel a transposed view, read
    # through the kernel's transpose flag (no copy)
    vr_t, mt_u = vr.mT.contiguous().mT, modes_tensor(step0["U"])
    kern = lambda: uk.masked_trailing_update(block, vr_t, vc, mt_u)  # noqa: E731
    print(f"[time] masked_trailing_update uplo U (vr a transposed view) kernel="
          f"{time_ms(torch, kern):.4f} ms (batched {batch_ms(torch, kern):.4f} ms) [{card}]",
          flush=True)


def scan_paths(torch, dev, card, drive, pk, ok, oz) -> None:
    """The distributed scan Cholesky, the distributed and local triangular
    solve and the distributed triangular multiply, every rank of a grid on
    this card, each with its check line, wall, GFlop/s and launch counts.
    Per step of the scan Cholesky every rank runs the panel site and the
    bulk, the last step included; per step of the unrolled solve every rank
    solves the pivot panel, and ranks with remaining slots (every rank
    before the last step) run the bulk product."""
    import numpy as np

    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.algorithms.triangular import triangular_multiply
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import GlobalElementSize, TileElementSize
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp import miniapp_triangular_solver as mts
    from dlaf_tpu_torch.tile_ops import blas as tb

    share = ["--share-device", "--nruns", "2", "--nwarmups", "1", "--check-result", "last"]
    grid2 = ["--grid-rows", "2", "--grid-cols", "2"]
    scan = "--dlaf:cholesky-trailing=scan"
    for name, argv, n, letter, expect in (
            # the fused factor+solve at the panel site of every rank, every step
            ("dist-scan-L", ["--type", "s", "--uplo", "L", scan, "--dlaf:step-impl=fused",
                             "--dlaf:cholesky-lookahead=1"], 16384, "s",
             {"factor_solve": lambda nt: 4 * nt}),
            # the potrf and strip-solve kernels at the panel site instead
            ("dist-scan-U", ["--type", "s", "--uplo", "U", scan, "--dlaf:panel-impl=fused",
                             "--dlaf:step-impl=xla"], 8192, "s",
             {"potrf": lambda nt: 4 * nt, "solve": lambda nt: 4 * nt}),
            # the pair kernel for the bulk of every step on every rank; slice
            # products for the mixed panel on every rank and the eager next
            # row on the two ranks that own it
            ("dist-scan-f64", ["--type", "d", "--uplo", "U", scan, "--dlaf:f64-gemm=mxu",
                               "--dlaf:ozaki-impl=pallas", "--dlaf:f64-trsm=mixed",
                               "--dlaf:cholesky-lookahead=1"], 8192, "d",
             {"ozaki_masked_product": lambda nt: 4 * nt,
              "ozaki_product": lambda nt: 4 * nt + 2 * (nt - 1)})):
        t = drive(["-m", str(n), "-b", "256", *grid2, *argv, *share], n, 256, 3, expect)
        print(f"[scan] {name:13s} N={n} nb=256 2x2 on one card: {t:.6f} s "
              f"{n ** 3 / 3 / t / 1e9:.2f} GFlop/s [{card}]", flush=True)

    def trsm(name, argv, n, expect, nfact=3):
        t = drive(["-m", str(n), "-n", str(n), "-b", "256", *argv], n, 256, nfact, expect,
                  app=mts)
        print(f"[trsm] {name:22s} m=n={n} nb=256: {t:.6f} s {n ** 3 / t / 1e9:.2f} GFlop/s "
              f"[{card}]", flush=True)
        return t

    d2 = ["--type", "d", *grid2, *share]
    # the two step forms in turns (the host's noise moves between runs)
    walls = {"unrolled": [], "scan": []}
    for _ in range(2):
        for mode in walls:
            walls[mode].append(trsm(f"trsm-d {mode}", [*d2, f"--dlaf:dist-step-mode={mode}"],
                                    8192, {}))
    print(f"[trsm] config #2 (d, 8192, nb=256, 2x2 on one card), best of 2 runs in each of 2 "
          f"turns: unrolled {walls['unrolled']} s, scan {walls['scan']} s [{card}]", flush=True)
    # the strip-solve kernel on every rank at every step
    for combo in (["--side", "L", "--uplo", "L", "--op", "N"],
                  ["--side", "R", "--uplo", "U", "--op", "C"]):
        trsm("trsm-s " + "".join(combo[1::2]), ["--type", "s", *grid2, *share, *combo,
                                                "--dlaf:panel-impl=fused"], 8192,
             {"solve": lambda nt: 4 * nt})
    # slice products: the mixed panel on every rank at every step, the bulk
    # on every rank at every step but the last
    trsm("trsm-d-mxu", [*d2, "--dlaf:f64-gemm=mxu", "--dlaf:f64-trsm=mixed"], 8192,
         {"ozaki_product": lambda nt: 4 * nt + 4 * (nt - 1)})
    for letter in ("d", "s"):
        trsm(f"trsm-local {letter}", ["--type", letter, "--nruns", "2", "--nwarmups", "1",
                                      "--check-result", "last"], 8192, {})

    # a float64 product of trsm-d-mxu's bulk (step 0, one rank: 16 slots
    # of 256 against 16 columns of 256) against its plain version
    s = 8
    gen = torch.Generator(device=dev).manual_seed(11)
    a = torch.randn(4096, 256, generator=gen, device=dev, dtype=torch.float64)
    b = torch.randn(256, 4096, generator=gen, device=dev, dtype=torch.float64)
    ia = torch.stack(oz._peel_slices(oz._normalize(a, oz._scale(a, -1)), s))
    ib = torch.stack(oz._peel_slices(oz._normalize(b, oz._scale(b, -2)), s))
    got, ref = ok.ozaki_product(ia, ib), ok.ozaki_product_plain(ia, ib)
    same = all(torch.equal(x, y) for x, y in zip(got, ref))
    print(f"[kernel] ozaki_product trsm-d-mxu bulk 4096x4096 K=256 s={s}: hi and lo "
          f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
    if not same:
        raise AssertionError("ozaki_product at the trsm-d-mxu shape: not bitwise equal")
    del a, b, ia, ib, got, ref

    # trmm-d: the distributed multiply against blas.trmm of the gathered
    # matrices, on the card
    n, nb = 8192, 256
    config.initialize(argv=["--dlaf:dist-step-mode=unrolled"])
    grid = shared_grid(2, 2, dev)
    am = Matrix.from_element_fn(lambda i, j: 1.0 / (1.0 + (i - j).abs()) + 2.0 * n * (i == j),
                                GlobalElementSize(n, n), TileElementSize(nb, nb), grid,
                                device=dev)
    bm = Matrix.from_element_fn(lambda i, j: torch.cos(0.001 * (i + 1))
                                + torch.sin(0.002 * (j + 1)), GlobalElementSize(n, n),
                                TileElementSize(nb, nb), grid, device=dev)
    counts0 = {**pk.LAUNCHES, **ok.LAUNCHES}
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = triangular_multiply("L", "L", "N", "N", 1.0, am, bm)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    want = tb.trmm("L", "L", "N", "N", am.to_global(), bm.to_global())
    got = out.to_global()
    err = float((got - want).abs().max() / want.abs().max())
    tol = 60 * n * float(np.finfo(np.float64).eps)
    t = min(times[1:])
    print(f"[trmm] trmm-d LLNN d n={n} nb={nb} 2x2 on one card, unrolled: {t:.6f} s "
          f"{n ** 3 / t / 1e9:.2f} GFlop/s rel_err={err:.3e} tol={tol:.3e} launches "
          f"{ {k: v - counts0[k] for k, v in {**pk.LAUNCHES, **ok.LAUNCHES}.items()} } "
          f"[{card}]", flush=True)
    if not err <= tol:
        raise AssertionError(f"trmm-d: rel_err {err} > {tol}")
    print(f"check: PASSED trmm-d rel_err={err:.3e} tol={tol:.3e}", flush=True)


#: Launches of the HEGST paths per call (grid P x Q, nt tiles a side,
#: uplo L unless named), by the code's structure: every rank transforms the
#: diagonal tile (two solves) every step and solves its slot of the panel
#: on every step but the last; under ``f64_gemm=mxu`` and ``f64_trsm=mixed``
#: each complex product is four slice products, each solve against the
#: refined inverse one product: the two diagonal solves and the panel on
#: every rank, the deferred row solve on the Q ranks of row k (k >= 1), its
#: pair product on every rank while a rank keeps slots of rows below k
#: (:func:`_rows_left`), the look-ahead column's two strips on the P ranks
#: that own it and the bulk's two pair products on every rank (k <= nt-2).
HEGST_LAUNCHES = {
    "solve": lambda P, Q, nt: P * Q * (3 * nt - 1),
    "ozaki_product": lambda P, Q, nt: 4 * (2 * P * Q * nt + P * Q * (nt - 1) + Q * (nt - 1)
                                           + P * Q * _rows_left(P, nt) + 2 * P * (nt - 1)
                                           + 2 * P * Q * (nt - 1)),
}


def _rows_left(P: int, nt: int) -> int:
    """Steps 1 <= k < nt at which the uniform trailing slots (from
    ``uniform_slot_start(k + 1, P)``) leave a rank any row slot."""
    return sum(1 for k in range(1, nt) if -(-nt // P) > max(0, -(-(k + 2 - P) // P)))
#: Launches of the Cholesky of B that each HEGST run factors once, on the
#: cuda defaults (fused factor+solve, potrf at the last step, the update
#: kernel for float32 grids) or, complex128 under mxu + mixed, four slice
#: products for each rank's panel and bulk and each look-ahead strip.
CHOL_F32_GRID = {"factor_solve": lambda P, Q, nt: P * Q * (nt - 1),
                 "potrf": lambda P, Q, nt: P * Q,
                 "masked_trailing_update": lambda P, Q, nt: P * Q * (nt - 1)}
CHOL_F32_LOCAL = {"step": lambda P, Q, nt: nt - 1, "potrf": lambda P, Q, nt: 1}
CHOL_Z_MXU_GRID = {"ozaki_product": lambda P, Q, nt: 4 * (2 * P * Q + P) * (nt - 1)}


#: Launches of twosolve on a grid per call: each of its two distributed
#: solves runs the strip-solve kernel on every rank at every step. The
#: local solve runs no kernel.
TWOSOLVE_LAUNCHES = {"solve": lambda P, Q, nt: 2 * P * Q * nt}


def hegst_expect(P, Q, calls, hegst=(), chol=None, table=HEGST_LAUNCHES):
    """Expected launches of one miniapp_gen_to_std run: ``calls`` HEGST
    calls (warm-ups included) of the named ``hegst`` kernels (counts from
    ``table``) and one Cholesky of B (``chol``), as functions of nt for
    ``drive``."""
    out = {}
    for name in hegst:
        out[name] = (lambda f: lambda nt: calls * f(P, Q, nt))(table[name])
    for name, f in (chol or {}).items():
        prev = out.get(name, lambda nt: 0)
        out[name] = (lambda f, prev: lambda nt: prev(nt) + f(P, Q, nt))(f, prev)
    return out


def hegst_paths(torch, dev, card, drive, ok) -> None:
    """HEGST through ``miniapp_gen_to_std.run`` (every rank of a grid on
    this card), each with its check line, wall, GFlop/s (the reference's
    model, n^3/2 multiplications and as many additions) and exact launch
    counts; the route phase in four cells; one pair product of the Ozaki
    route bit for bit against its plain version; one blocked call under the
    profiler."""
    import importlib

    import numpy as np

    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.miniapp import miniapp_gen_to_std as mgs
    from dlaf_tpu_torch.types import total_ops

    # the module (the package exports the function of the same name)
    gs = importlib.import_module("dlaf_tpu_torch.algorithms.gen_to_std")

    runs = ["--nruns", "2", "--nwarmups", "1", "--check-result", "last"]
    share = ["--share-device", *runs]
    walls = {}

    def hegst(name, argv, n, letter, expect, grid=(2, 2), nb=256):
        t = drive(["-m", str(n), "-b", str(nb), "--type", letter, *argv], n, nb, 1, expect,
                  app=mgs)
        dt = {"s": np.float32, "d": np.float64, "z": np.complex128}[letter]
        print(f"[hegst] {name:18s} N={n} nb={nb} {grid[0]}x{grid[1]}: {t:.6f} s "
              f"{total_ops(dt, n ** 3 / 2, n ** 3 / 2) / t / 1e9:.2f} GFlop/s [{card}]",
              flush=True)
        walls[name] = t
        return t

    g22 = ["--grid-rows", "2", "--grid-cols", "2", *share]
    blocked, twosolve = "--dlaf:hegst-impl=blocked", "--dlaf:hegst-impl=twosolve"
    fused = "--dlaf:panel-impl=fused"
    config.initialize()
    default = config.resolve("hegst_impl", "cuda")
    # BASELINE config #3: the two formulations by name, then the default
    # routes; no kernel on the complex path
    hegst("hegst-z-blocked", [*g22, blocked], 8192, "z", {})
    hegst("hegst-z-twosolve", [*g22, twosolve], 8192, "z", {})
    hegst("hegst-z", g22, 8192, "z", {})
    # one call, no warm-up: the Ozaki route's count and check, not its wall
    hegst("hegst-z-mxu", ["--grid-rows", "2", "--grid-cols", "2", "--share-device",
                          "--nruns", "1", "--nwarmups", "0", "--check-result", "last",
                          blocked, "--dlaf:f64-gemm=mxu", "--dlaf:f64-trsm=mixed"], 8192, "z",
          hegst_expect(2, 2, 1, ("ozaki_product",), CHOL_Z_MXU_GRID))
    # float32: the strip-solve kernel on every rank, by both formulations
    # and the default (panel_impl=fused is cuda's default too)
    s22 = {"blocked": hegst_expect(2, 2, 3, ("solve",), CHOL_F32_GRID),
           "twosolve": hegst_expect(2, 2, 3, ("solve",), CHOL_F32_GRID, TWOSOLVE_LAUNCHES)}
    hegst("hegst-s", [*g22, blocked, fused], 16384, "s", s22["blocked"])
    hegst("hegst-s-twosolve", [*g22, twosolve, fused], 16384, "s", s22["twosolve"])
    hegst("hegst-s-default", g22, 16384, "s", s22[default])
    hegst("hegst-s-U", ["--uplo", "U", "--grid-rows", "2", "--grid-cols", "4", *share,
                        blocked, fused], 8192, "s",
          hegst_expect(2, 4, 3, ("solve",), CHOL_F32_GRID), grid=(2, 4))
    hegst("hegst-local-z", runs, 8192, "z", {}, grid=(1, 1))
    hegst("hegst-local-z-blocked", [*runs, blocked], 8192, "z", {}, grid=(1, 1))
    hegst("hegst-local-z-twosolve", [*runs, twosolve], 8192, "z", {}, grid=(1, 1))
    s11 = {"blocked": hegst_expect(1, 1, 3, ("solve",), CHOL_F32_LOCAL),
           "twosolve": hegst_expect(1, 1, 3, (), CHOL_F32_LOCAL)}
    hegst("hegst-local-s", [*runs, blocked, fused], 8192, "s", s11["blocked"], grid=(1, 1))
    hegst("hegst-local-s-twosolve", [*runs, twosolve, fused], 8192, "s", s11["twosolve"],
          grid=(1, 1))
    hegst("hegst-local-s-default", runs, 8192, "s", s11[default], grid=(1, 1))

    # the route phase: in each cell, the default beside the two
    # formulations it picks from
    for cell, dflt, blk, two in (
            ("z N=8192 2x2 (config #3)", "hegst-z", "hegst-z-blocked", "hegst-z-twosolve"),
            ("s N=16384 2x2", "hegst-s-default", "hegst-s", "hegst-s-twosolve"),
            ("z N=8192 local", "hegst-local-z", "hegst-local-z-blocked",
             "hegst-local-z-twosolve"),
            ("s N=8192 local", "hegst-local-s-default", "hegst-local-s",
             "hegst-local-s-twosolve")):
        best = min((walls[blk], "blocked"), (walls[two], "twosolve"))
        print(f"[route] hegst {cell} nb=256: default ({default}) {walls[dflt]:.6f} s, blocked "
              f"{walls[blk]:.6f} s, twosolve {walls[two]:.6f} s [{card}]", flush=True)
        if walls[dflt] > 1.25 * best[0]:
            raise AssertionError(f"hegst {cell}: the default route is slower than {best[1]}")

    # one pair product of hegst-z-mxu's bulk at step 0 (a rank's 16 row
    # tiles against its 16 column tiles, complex128: four slice products)
    # through the kernel and through its plain version
    config.initialize(argv=["--dlaf:ozaki-impl=pallas"])
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(16, 256, 256, generator=gen, device=dev, dtype=torch.complex128)
    y = torch.randn(16, 256, 256, generator=gen, device=dev, dtype=torch.complex128)
    got = gs._pair_product(x, y, True)
    kernel = ok.ozaki_product
    ok.ozaki_product = ok.ozaki_product_plain
    try:
        ref = gs._pair_product(x, y, True)
    finally:
        ok.ozaki_product = kernel
    same = torch.equal(got, ref)
    print(f"[kernel] ozaki_product hegst-z-mxu pair product 16x16 tiles of 256 complex128: "
          f"{'bitwise equal' if same else 'DIFFER'} to the plain version", flush=True)
    if not same:
        raise AssertionError("hegst pair product: not bitwise equal to the plain version")
    del x, y, got, ref

    for impl in ("blocked", "twosolve"):
        profile_hegst(torch, dev, impl)


def profile_hegst(torch, dev, impl: str, n: int = 8192, nb: int = 256) -> None:
    """:func:`profile_run` of one config #3 HEGST (complex128, uplo L, 2x2
    on ``dev``) by the formulation ``impl``."""
    import numpy as np

    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.algorithms.gen_to_std import gen_to_std
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import GlobalElementSize, TileElementSize
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp.generators import herm_element_fn, hpd_element_fn

    config.initialize(argv=[f"--dlaf:hegst-impl={impl}"])
    grid = shared_grid(2, 2, dev)
    size, block = GlobalElementSize(n, n), TileElementSize(nb, nb)
    am = Matrix.from_element_fn(herm_element_fn(n, np.complex128), size, block, grid,
                                dtype=np.complex128, device=dev)
    bf = cholesky("L", Matrix.from_element_fn(hpd_element_fn(n, np.complex128), size, block,
                                              grid, dtype=np.complex128, device=dev),
                  donate=True)
    mats = [am.clone(), am.clone()]
    profile_run(torch, f"hegst-z n={n} nb={nb} uplo L grid 2x2 on one card {impl}",
                lambda: gen_to_std("L", mats.pop(), bf, donate=True))


def qr_phase(torch, dev, card) -> None:
    """The QR T factor at reduction to band's panel width at config #4:
    reflectors from ``panel_qr`` of a random float64 (16384, 128) panel,
    then ``t_factor`` locally (``larft``) and on a 2x2 grid on this card
    (blocks 512 x 128, one block column). Checks the compact-WY
    factorization ``|(I - V T V^H) R - A| / |A|`` and the orthogonality of
    its first 128 columns against ``100 m eps``, and the grid's T against
    the local one to 1e-12 relative."""
    import numpy as np

    from dlaf_tpu_torch.algorithms.qr import t_factor
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import TileElementSize
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.tile_ops.qr_panel import householder_qr, panel_qr

    m, k = 16384, 128
    gen = torch.Generator(device=dev).manual_seed(13)
    a = torch.randn(m, k, generator=gen, device=dev, dtype=torch.float64)
    walls = {}
    for name, fn in (("panel_qr (geqrf)", lambda: panel_qr(a)),
                     ("householder_qr", lambda: householder_qr(a))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vfull, taus = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    vfull, taus = panel_qr(a)
    t_loc = t_factor(vfull, taus)
    vm = Matrix.from_global(vfull, TileElementSize(512, k), shared_grid(2, 2, dev), device=dev)
    t0 = time.perf_counter()
    t_grid = t_factor(vm, taus)
    torch.cuda.synchronize()
    t_grid_s = time.perf_counter() - t0
    v = torch.tril(vfull, -1) + torch.eye(m, k, dtype=vfull.dtype, device=dev)
    qk = torch.eye(m, k, dtype=v.dtype, device=dev) - v @ (t_loc @ v[:k].mH)
    r = torch.triu(vfull[:k])
    fact = float(torch.linalg.norm(qk @ r - a) / torch.linalg.norm(a))
    orth = float(torch.linalg.norm(qk.mH @ qk - torch.eye(k, dtype=v.dtype, device=dev)))
    same = float(torch.linalg.norm(t_grid - t_loc) / torch.linalg.norm(t_loc))
    tol = 100 * m * float(np.finfo(np.float64).eps)
    print(f"[qr] m={m} k={k} f64: panel_qr {walls['panel_qr (geqrf)']:.6f} s, householder_qr "
          f"{walls['householder_qr']:.6f} s, t_factor 2x2 {t_grid_s:.6f} s; factorization "
          f"{fact:.3e} orthogonality {orth:.3e} tol {tol:.3e}; T grid vs local {same:.3e} "
          f"[{card}]", flush=True)
    if not (fact < tol and orth < tol and same <= 1e-12 and tuple(t_grid.shape) == (k, k)):
        raise AssertionError("qr: the T factor fails its checks")
    print(f"check: PASSED qr factorization={fact:.3e} orthogonality={orth:.3e} "
          f"grid_vs_local={same:.3e}", flush=True)


def _slot(k: int, p: int) -> int:
    """Uniform local slot covering every rank's tiles from global tile
    ``k`` on a ``p``-rank axis (``matrix.panel.uniform_slot_start``)."""
    return max(0, -(-(k + 1 - p) // p))


def red2band_mxu_launches(P: int, Q: int, n: int, nb: int, b: int, k_max: int = 1024,
                          min_dim: int = 128, shared: bool = True) -> int:
    """Launches of #6 in one distributed unrolled reduction to band under
    ``f64_gemm=mxu`` (float64, ``ozaki_impl=pallas``), every rank of the
    P x Q grid on one card: per panel with a trailing block, W's partial
    product on every rank when its contraction (the rank's trailing
    columns) is at most ``k_max`` deep (deeper ones take the composed
    route, no kernel), M's once per grid row (its partial product is the
    same on every rank of a row, formed once per device) when the row's
    trailing rows are, and the bulk's two products on every rank
    (contraction ``b``); each only where every dimension is at least
    ``min_dim``. The eager strip under ``comm_lookahead`` reuses the
    bulk's products. ``shared=False``: M's on every rank, as one process
    per rank forms it (the multi-process form)."""
    nt = -(-n // nb)
    ltr, ltc = -(-nt // P), -(-nt // Q)
    total = 0
    for p in range(-(-n // b) - 1):
        tr0 = ((p + 1) * b) // nb
        rows, cols = (ltr - _slot(tr0, P)) * nb, (ltc - _slot(tr0, Q)) * nb
        if rows <= 0 or cols <= 0:
            continue
        w = cols <= k_max and min(rows, cols, b) >= min_dim
        m = rows <= k_max and min(rows, b) >= min_dim
        bulk = 2 * (min(rows, b, cols) >= min_dim)
        total += P * Q * (w + bulk) + (P if shared else P * Q) * m
    return total


def red2band_paths(torch, dev, card, drive, ok) -> None:
    """Reduction to band through ``miniapp_reduction_to_band.run`` (every
    rank of a grid on this card), each with its check line (the band's
    eigenvalues against A's on the card, below 100 n eps), wall, GFlop/s
    (the reference's model, 2n^3/3 multiplications and as many additions),
    peak device memory and exact launch counts: BASELINE config #4 by the
    default step mode and by scan, the same matrix on one rank both ways,
    complex128 with band = nb, and float64 under ``f64_gemm=mxu`` with
    #6 counted exactly; then two of red2band-mxu's products through #6
    bit for bit against its plain version (:func:`red2band_mxu_products`)."""
    import numpy as np

    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.miniapp import miniapp_reduction_to_band as mrb
    from dlaf_tpu_torch.types import total_ops

    one = ["--nruns", "1", "--nwarmups", "1", "--check-result", "last"]
    c4 = ["-m", "16384", "-b", "512", "--band-size", "128", "--type", "d"]
    g44 = ["--grid-rows", "4", "--grid-cols", "4", "--share-device"]
    g22 = ["--grid-rows", "2", "--grid-cols", "2", "--share-device"]
    config.initialize()
    print(f"[red2band] dist_step_mode auto at 127 panels on cuda: "
          f"{config.resolve_step_mode(127, 'cuda')}", flush=True)

    def r2b(name, argv, n, nb, letter, grid, expect=None):
        torch.cuda.synchronize()
        _reset_peak()
        t = drive([*argv, *one], n, nb, 2, expect or {}, app=mrb)
        peak = _peak_gib()
        dt = {"d": np.float64, "z": np.complex128}[letter]
        print(f"[red2band] {name:22s} N={n} nb={nb} {grid}: {t:.6f} s "
              f"{total_ops(dt, 2 * n ** 3 / 3, 2 * n ** 3 / 3) / t / 1e9:.2f} GFlop/s, peak "
              f"{peak:.2f} GiB [{card}]", flush=True)

    r2b("red2band-d", [*c4, *g44], 16384, 512, "d", "4x4 band 128")
    r2b("red2band-d-scan", [*c4, *g44, "--dlaf:dist-step-mode=scan"], 16384, 512, "d",
        "4x4 band 128")
    r2b("red2band-local-d", c4, 16384, 512, "d", "1x1 band 128")
    r2b("red2band-local-d-scan", [*c4, "--dlaf:dist-step-mode=scan"], 16384, 512, "d",
        "1x1 band 128")
    r2b("red2band-z", ["-m", "8192", "-b", "256", "--type", "z", *g22], 8192, 256, "z",
        "2x2 band 256")
    count = red2band_mxu_launches(2, 2, 4096, 512, 128)
    r2b("red2band-mxu", ["-m", "4096", "-b", "512", "--band-size", "128", "--type", "d", *g22,
                         "--dlaf:f64-gemm=mxu", "--dlaf:ozaki-impl=pallas"], 4096, 512, "d",
        "2x2 band 128", {"ozaki_product": lambda nt: count})
    red2band_mxu_products(torch, dev, ok)


def red2band_mxu_products(torch, dev, ok) -> None:
    """Two of red2band-mxu's products under ``f64_gemm=mxu``,
    ``ozaki_impl=pallas``, at that path's shapes, through #6 and then with
    it swapped for its plain version, bit for bit: the bulk's ``X V^H`` of
    one rank at panel 0 (2048 x 2048 tiles' rows and columns, contraction
    b = 128) and W's partial product of one rank where its contraction is
    1024 deep (1024 trailing rows and columns). Each must launch #6."""
    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.tile_ops import blas as tb

    config.initialize(argv=["--dlaf:f64-gemm=mxu", "--dlaf:ozaki-impl=pallas"])
    gen = torch.Generator(device=dev).manual_seed(15)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float64)

    xr, vc = randn(4, 512, 128), randn(4, 512, 128)
    atr, vtl = randn(2, 2, 512, 512), randn(2, 512, 128)
    for name, fn in (("bulk X V^H 2048x2048, K=128",
                      lambda: tb.contract("rad,cbd->rcab", xr, vc.conj())),
                     ("W partial 1024x128, K=1024",
                      lambda: tb.contract("rcab,cbd->rad", atr, vtl))):
        before = ok.LAUNCHES["ozaki_product"]
        got = fn()
        torch.cuda.synchronize()
        launched = ok.LAUNCHES["ozaki_product"] - before
        kernel = ok.ozaki_product
        ok.ozaki_product = ok.ozaki_product_plain
        try:
            ref = fn()
        finally:
            ok.ozaki_product = kernel
        same = torch.equal(got, ref)
        print(f"[kernel] ozaki_product red2band-mxu {name}: {launched} launch(es), "
              f"{'bitwise equal' if same else 'DIFFER'} to the plain version", flush=True)
        if launched < 1 or not same:
            raise AssertionError(f"red2band-mxu {name}: #6 not launched or not bitwise equal")
    config.initialize()


_SCAN, _MXU = "--dlaf:dist-step-mode=scan", "--dlaf:f64-gemm=mxu"
#: :func:`b2t_paths`' cases: name, n, nb, band, type, grid (None: one
#: rank), knobs, chased (else the band's eigenvalues are checked)
B2T_CASES = (("rand-d-scan", 16384, 512, 128, "d", (4, 4), [_SCAN], False),
             ("rand-local-d-scan", 16384, 512, 128, "d", None, [_SCAN], False),
             ("rand-z", 8192, 256, 256, "z", (2, 2), [], False),
             ("b2t-z", 4096, 256, 128, "z", None, [], True),
             ("rand-mxu", 4096, 512, 128, "d", (2, 2), [_MXU, "--dlaf:ozaki-impl=pallas"], False))


def b2t_paths(torch, dev, card, ok) -> None:
    """The pipeline end to end, and every builder of the red2band cells on
    a full spectrum. A seeded random Hermitian A (its eigenvalues by
    ``torch.linalg.eigvalsh`` on the card, once per size and type) is
    reduced to band on the card and its band extracted (only the band's
    diagonals cross to the host). b2t-z (complex128, N=4096, nb=256, band
    128, one rank) chases it to a real tridiagonal by the native chase and
    holds the eigenvalues of (d, e) (scipy) against A's, the phases of
    unit modulus (config #4's unrolled reduction and chase of a random A
    run in the eigensolver's evp-d); rand-d-scan and rand-local-d-scan (config #4 on 4x4 and
    on one rank, scan), rand-z (red2band-z's shape: complex128, N=8192,
    nb=256, band 256, 2x2) and rand-mxu (red2band-mxu's, with #6 exactly
    ``red2band_mxu_launches``) hold the band's eigenvalues (``eigvalsh`` on
    the card) against A's. Each below 100 n eps. The red2band cells' own
    check reads the reference's analytic setter, of rank at most 4: after
    its first panel the trailing matrix is at roundoff, so these are the
    checks of the later panels."""
    import numpy as np

    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import TileElementSize
    from dlaf_tpu_torch.eigensolver.band_to_tridiag import band_to_tridiag
    from dlaf_tpu_torch.eigensolver.reduction_to_band import extract_band, reduction_to_band
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp import miniapp_reduction_to_band as mrb
    from dlaf_tpu_torch.miniapp.miniapp_band_to_tridiag import tridiag_drift
    from dlaf_tpu_torch.native import bindings

    held = None
    for name, n, nb, b, letter, grid, knobs, chase in B2T_CASES:
        dtype = {"d": torch.float64, "z": torch.complex128}[letter]
        want6 = (red2band_mxu_launches(*grid, n, nb, b) if "--dlaf:f64-gemm=mxu" in knobs
                 else 0)
        if held is None or held[0] != (n, dtype):
            held = None
            gen = torch.Generator(device=dev).manual_seed(14)
            x = torch.randn(n, n, generator=gen, device=dev, dtype=dtype)
            a = (x + x.mH) / 2
            del x
            held = ((n, dtype), a, torch.linalg.eigvalsh(a))
        _, a, w_ref = held
        config.initialize(argv=knobs)
        mat = Matrix.from_global(a, TileElementSize(nb, nb),
                                 shared_grid(*grid, dev) if grid else None, device=dev)
        before6 = ok.LAUNCHES["ozaki_product"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        red = reduction_to_band(mat, band_size=b, donate=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launched6 = ok.LAUNCHES["ozaki_product"] - before6
        band = extract_band(red)
        t2 = time.perf_counter()
        del mat, red
        tol = 100 * n * float(np.finfo(np.float64).eps)
        shape = f"{grid[0]}x{grid[1]}" if grid else "1x1"
        if chase:
            res = band_to_tridiag(band, b)
            t3 = time.perf_counter()
            resid = tridiag_drift(w_ref, res)
            unit = float(np.abs(np.abs(res.phase) - 1).max())
            print(f"[b2t] {name} N={n} nb={nb} band={b} {shape}: reduction {t1 - t0:.6f} s, "
                  f"extract_band {t2 - t1:.6f} s, native chase {t3 - t2:.6f} s "
                  f"({bindings.chase_threads()} threads, "
                  f"{6 * n * n * b * (4 if dtype.is_complex else 1) / (t3 - t2) / 1e9:.2f} "
                  f"GFlop/s); eigenvalue drift {resid:.3e} tol {tol:.3e}, phases off unit "
                  f"{unit:.1e} [{card}]", flush=True)
            good = (unit < 1e-12 and res.d.shape == (n,) and res.e.shape == (n - 1,)
                    and np.isfinite(res.d).all() and np.isfinite(res.e).all())
        else:
            w = torch.linalg.eigvalsh(mrb.wide(mrb.band_matrix(band, dev)))
            resid = mrb.eigenvalue_drift(w_ref, w)
            print(f"[b2t] {name} N={n} nb={nb} band={b} {shape} {' '.join(knobs) or 'default'}: "
                  f"reduction {t1 - t0:.6f} s, #6 launches {launched6}; band eigenvalue drift "
                  f"{resid:.3e} tol {tol:.3e} [{card}]", flush=True)
            good = bool(torch.isfinite(w).all())
        if not (good and resid < tol):
            raise AssertionError(f"{name}: the eigenvalues disagree with A's")
        if launched6 != want6:
            raise AssertionError(f"{name}: #6 launched {launched6} times, expected {want6}")
        print(f"check: PASSED {name} residual={resid:.3e} tol={tol:.3e}", flush=True)
    del held, a, w_ref
    config.initialize()


# ---------------------------------------------------------------------------
# The eigensolver: the D&C, both back-transforms and the drivers
# ---------------------------------------------------------------------------

def _mxu_product(m: int, k: int, n: int, k_max: int, min_dim: int) -> int:
    """1 when an (m x k) @ (k x n) float64 product under ``f64_gemm=mxu``
    (``ozaki_impl=pallas``) launches #6: every dimension at least
    ``min_dim`` and the contraction at most ``k_max`` deep."""
    return int(min(m, k, n) >= min_dim and k <= k_max)


def dc_mxu_launches(n: int, nb: int, k_max: int = 1024, min_dim: int = 128, P: int = 1,
                    Q: int = 1, shard_min: int = 512) -> int:
    """#6 launches of one D&C of order ``n`` (leaves of at most ``nb``)
    under ``f64_gemm=mxu``, over the solver's split tree: an unsharded
    merge's two products ``Q1 @ qc[:n1]`` (n1 x n1 by n1 x n) and ``Q2 @
    qc[n1:]``; a merge sharded over a P x Q grid (P Q > 1, order at least
    ``shard_min``) the products of each rank (r, c), the rows of its grid
    row's block that fall in Q1 (Q2) by Q1's (Q2's) order, times its grid
    column's block of columns."""
    from dlaf_tpu_torch.eigensolver.tridiag_solver import _split

    def products(size, m):
        if P * Q == 1 or size < shard_min:
            return (_mxu_product(m, m, size, k_max, min_dim)
                    + _mxu_product(size - m, size - m, size, k_max, min_dim))
        rb, cb = _split(size, P), _split(size, Q)
        total = 0
        for r in range(P):
            top = max(0, min(rb[r + 1], m) - rb[r])
            bot = max(0, rb[r + 1] - max(rb[r], m))
            for c in range(Q):
                w = cb[c + 1] - cb[c]
                total += (_mxu_product(top, m, w, k_max, min_dim) if top else 0)
                total += (_mxu_product(bot, size - m, w, k_max, min_dim) if bot else 0)
        return total

    def walk(size):
        if size <= max(nb, 2):
            return 0
        m = (size // 2 // nb) * nb
        if m == 0 or m == size:
            m = size // 2
        return walk(m) + walk(size - m) + products(size, m)
    return walk(n)


def givens_launches(stats) -> int:
    """The Givens undo's launches of one D&C from its merge statistics:
    one per column shard (one a merge unsharded) of each merge that
    deflated by rotations."""
    return sum(s.shards for s in stats if s.rotations)


def bt_b2t_mxu_launches(n: int, b: int, m: int, k_max: int = 1024, min_dim: int = 128) -> int:
    """#6 launches of the blocked chase back-transform (cuda's group: the
    band) of an ``(n, m)`` E on one card: per step level that starts above
    row n (block ``k``, step ``t``: row ``k G + 1 + t b``) the products
    ``V^H E`` (G x L by L x m) and ``V W`` (L x G by G x m)."""
    n_sweeps = max(n - 2, 0)
    if n_sweeps == 0:
        return 0
    g = max(1, min(b, b + 1, n_sweeps))
    L = b + g - 1
    n_steps = -(-(n - 1) // b)
    levels = sum(min(n_steps, -(-(n - 1 - k * g) // b)) for k in range(-(-n_sweeps // g)))
    return levels * (_mxu_product(g, L, m, k_max, min_dim) + _mxu_product(L, g, m, k_max, min_dim))


def bt_r2b_mxu_launches(P: int, Q: int, n: int, nb: int, b: int, k_max: int = 1024,
                        min_dim: int = 128) -> int:
    """#6 launches of the distributed unrolled reflector-block
    back-transform, every rank on one card: per panel with trailing rows,
    ``V^H C`` on every rank (contraction: the rank's trailing rows), ``T
    W2`` once per grid column (the same on the column's ranks) and ``V
    W2`` on every rank (contraction b)."""
    nt = -(-n // nb)
    ltr, ltc = -(-nt // P), -(-nt // Q)
    total = 0
    for p in range(-(-n // b) - 1):
        rows = (ltr - _slot(((p + 1) * b) // nb, P)) * nb
        if rows <= 0:
            continue
        cols = ltc * nb
        total += (P * Q * _mxu_product(b, rows, cols, k_max, min_dim)
                  + Q * _mxu_product(b, b, cols, k_max, min_dim)
                  + P * Q * _mxu_product(rows, b, cols, k_max, min_dim))
    return total


def evp_mxu_launches(P: int, Q: int, n: int, nb: int, b: int, k_max: int = 1024,
                     min_dim: int = 128, shard_min: int = 512) -> int:
    """#6 launches of one distributed ``eigensolver`` call under
    ``f64_gemm=mxu``, every rank of the P x Q grid on one card (unrolled
    steps): the reduction to band, the D&C's merge products (sharded from
    order ``shard_min``), the blocked chase back-transform of the columns
    the ranks received side by side, and the reflector-block
    back-transform."""
    nt = -(-n // nb)
    ltc = -(-nt // Q)
    m = P * Q * -(-ltc // P) * nb
    return (red2band_mxu_launches(P, Q, n, nb, b, k_max, min_dim)
            + dc_mxu_launches(n, nb, k_max, min_dim, P, Q, shard_min)
            + bt_b2t_mxu_launches(n, b, m, k_max, min_dim)
            + bt_r2b_mxu_launches(P, Q, n, nb, b, k_max, min_dim))


#: Launches of one float32 ``gen_eigensolver`` call on a P x Q grid on the
#: cuda defaults: the Cholesky of B (fused factor+solve, potrf at the last
#: step, the update kernel), HEGST by twosolve (two solves, the strip solve
#: on every rank every step) and the back-substitution (one more such
#: solve); the eigensolver's float32 stages run no kernel.
GEN_EVP_F32_GRID = {**CHOL_F32_GRID, "solve": lambda P, Q, nt: 3 * P * Q * nt}


class HostPeak:
    """Peak resident set of this process over a ``with`` block, GiB:
    ``/proc/self/statm`` sampled every 10 ms by a thread (the kernel's own
    high-water mark, ``VmHWM``, spans the process's life), beside the
    resident set on entry, so that the block's own growth shows. None where
    there is no ``/proc``."""

    def __init__(self):
        import threading

        self.peak = None
        self.entry = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def _rss():
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError):
            return None

    def _run(self):
        while True:
            rss = self._rss()
            if rss is not None:
                self.peak = max(self.peak or 0, rss / 2 ** 30)
            if self._stop.wait(0.01):
                return

    def __enter__(self):
        rss = self._rss()
        self.entry = None if rss is None else rss / 2 ** 30
        self._thread.start()
        return self

    def text(self) -> str:
        """``peak (growth above entry)``, or "not measured"."""
        if self.peak is None or self.entry is None:
            return "not measured"
        return f"{self.peak:.2f} GiB ({self.peak - self.entry:.2f} GiB above entry)"

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        return False


def _dc_levels(stats) -> str:
    """Deflation fraction, merges, rotations (total, largest a merge) and
    secular routes per level of a D&C walk."""
    out = []
    for lvl in sorted({s.level for s in stats}):
        ss = [s for s in stats if s.level == lvl]
        merged = sum(s.n for s in ss)
        defl = sum(s.n - s.k for s in ss)
        routes = ",".join(f"{r}:{sum(s.route == r for s in ss)}"
                          for r in ("host", "device", "decoupled") if any(s.route == r for s in ss))
        out.append(f"L{lvl} n={ss[0].n}x{len(ss)} deflated {defl / merged:.4f} rotations "
                   f"{sum(s.rotations for s in ss)} (max {max(s.rotations for s in ss)}) {routes}")
    return "; ".join(out)


def evp_cell(torch, dev, card, kmods, name, a, nb, band, grid, knobs=(), b=None, w_ref=None,
             expect=None, keep=None):
    """One ``eigensolver`` (``gen_eigensolver`` with ``b``) call on the
    global ``a`` (every rank of ``grid`` on ``dev``), with a PhaseTimer:
    prints the stage walls, GFlop/s (``total_ops(5n^3/3, 5n^3/3)``), peak
    device and host memory, the D&C's deflation per level and the
    launches; checks the eigenvalues against ``w_ref`` (100 n eps), the
    eigenpair residual and the orthogonality (200 n eps, with B), the
    launch counts against ``expect`` (name -> count; every other kernel 0)
    and the Givens undo's against :func:`givens_launches` of the call's
    merge statistics. Returns the launches."""
    import numpy as np

    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import TileElementSize
    from dlaf_tpu_torch.common.timer import PhaseTimer
    from dlaf_tpu_torch.eigensolver.eigensolver import eigensolver, gen_eigensolver
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp import miniapp_reduction_to_band as mrb
    from dlaf_tpu_torch.miniapp.checks import effective_eps
    from dlaf_tpu_torch.miniapp.miniapp_eigensolver import eigen_residuals
    from dlaf_tpu_torch.types import total_ops

    config.initialize(argv=list(knobs))
    n = a.shape[0]
    g = shared_grid(*grid, dev) if grid else None
    mat = Matrix.from_global(a, TileElementSize(nb, nb), g, device=dev)
    bm = Matrix.from_global(b, TileElementSize(nb, nb), g, device=dev) if b is not None else None
    keep = {} if keep is None else keep
    pt = PhaseTimer()
    for m in kmods:
        m.reset_launches()
    torch.cuda.synchronize()
    _reset_peak()
    with HostPeak() as host:
        t0 = time.perf_counter()
        if bm is None:
            res = eigensolver("L", mat, phases=pt, band_size=band, donate=True, keep=keep)
        else:
            res = gen_eigensolver("L", mat, bm, phases=pt, band_size=band, donate=True,
                                  keep=keep)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
    peak_dev = _peak_gib()
    counts = {k: v for m in kmods for k, v in m.LAUNCHES.items()}
    del mat
    z = res.eigenvectors.to_global()
    vals = eigen_residuals(a, b, res.eigenvalues, z)
    del z
    eps, _ = effective_eps(a.dtype)
    tol = 200 * n * eps
    drift = (mrb.eigenvalue_drift(w_ref.cpu(), torch.as_tensor(res.eigenvalues))
             if w_ref is not None else None)
    shape = f"{grid[0]}x{grid[1]}" if grid else "1x1"
    dt = str(a.dtype).removeprefix("torch.")
    flops = total_ops(dt, 5 * n ** 3 / 3, 5 * n ** 3 / 3)
    print(f"[evp] {name} N={n} nb={nb} band={band or nb} {shape} {dt} "
          f"{' '.join(knobs) or 'default'}: {t:.6f} s {flops / t / 1e9:.2f} GFlop/s, peak device "
          f"{peak_dev:.2f} GiB, peak host {host.text()} [{card}]", flush=True)
    stages = pt.report()
    print(f"[evp] {name} stages: " + ", ".join(
        f"{k.removeprefix('stage.')} {v:.6f} s ({100 * v / t:.1f}%)" for k, v in stages.items()),
        flush=True)
    if keep.get("dc_stats"):
        print(f"[evp] {name} D&C: {_dc_levels(keep['dc_stats'])}", flush=True)
    print(f"[evp] {name} launches {counts}", flush=True)
    ok_ = (vals["eigen_residual"] < tol and vals["orthogonality"] < tol
           and (drift is None or drift < 100 * n * eps)
           and bool(np.isfinite(res.eigenvalues).all()) and res.eigenvalues.shape == (n,))
    print(f"check: {'PASSED' if ok_ else 'FAILED'} {name} residual={vals['eigen_residual']:.3e} "
          f"orthogonality={vals['orthogonality']:.3e} eigenvalue_drift="
          f"{'not checked' if drift is None else f'{drift:.3e}'} tol={tol:.3e} "
          f"(drift tol {100 * n * eps:.3e})", flush=True)
    if not ok_:
        raise AssertionError(f"{name}: eigenpairs fail their check")
    want = {k: (expect or {}).get(k, 0) for k in counts}
    want["givens_undo"] = givens_launches(keep.get("dc_stats") or [])
    stats = keep.get("dc_stats") or []
    print(f"[evp] {name} D&C: {sum(s.shards > 1 for s in stats)} of {len(stats)} merges "
          f"sharded over {max((s.shards for s in stats), default=1)} ranks; Givens undo "
          f"launches {counts.get('givens_undo', 0)}, by the merges' statistics "
          f"{want['givens_undo']}", flush=True)
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")
    return counts, res, stages, t


def _random_herm(torch, dev, n, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, n, generator=gen, device=dev, dtype=dtype)
    return (x + x.mH) / 2


def _gen_reference(torch, a, b):
    """The generalized eigenvalues of (A, B) in float64 on the card."""
    from dlaf_tpu_torch.miniapp.miniapp_reduction_to_band import wide

    lf = torch.linalg.cholesky(wide(b))
    c = torch.linalg.solve_triangular(lf, wide(a), upper=False)
    c = torch.linalg.solve_triangular(lf, c.mH, upper=False)
    return torch.linalg.eigvalsh((c + c.mH) / 2)


#: :func:`evp_paths`' cells: name, n, nb, band (None: nb), type, grid (None:
#: one rank), knobs, generalized, A (a seeded random Hermitian A with a
#: full spectrum, or the miniapps' analytic setter, of rank at most 4).
#: Cells of one (n, type, problem) share their A; the float32 generalized
#: cell takes the float64 one's A and B.
EVP_CASES = (("evp-d", 16384, 512, 128, "d", (4, 4), [], False, "random"),
             ("evp-d-analytic", 8192, 512, 128, "d", (4, 4), [], False, "analytic"),
             ("evp-local-d", 8192, 512, 128, "d", None, [], False, "random"),
             ("evp-z", 4096, 256, 128, "z", (2, 2), [], False, "random"),
             ("evp-scan", 4096, 256, 128, "d", (2, 2), [_SCAN], False, "random"),
             ("evp-mxu", 4096, 512, 128, "d", (2, 2), [_MXU], False, "random"),
             ("gen-evp-d", 8192, 256, None, "d", (2, 2), [], True, "random"),
             ("gen-evp-s", 8192, 256, None, "s", (2, 2), [], True, "random"),
             ("gen-evp-d-c5", 4096, 512, 512, "d", (8, 8), [], True, "random"))

#: Cells of :data:`EVP_CASES` cut in order from a BASELINE config, and why.
EVP_CUTS = {"gen-evp-d-c5": "BASELINE config #5's shape (float64, nb=band=512, 8x8) with "
                            "N=4096 cut from its 32768 for room: each rank owns one tile"}


def evp_paths(torch, dev, card, kmods, ok, launches) -> dict:
    """The eigensolver cells of :data:`EVP_CASES`, every rank of a grid on
    this card, each checked (:func:`evp_cell`; the eigenvalues where A is
    random): evp-d (config #4's shape by the default routes), the
    analytic setter on the same grid at half the order (its deflation and
    rotations), evp-local-d,
    evp-z, evp-scan (both scan builders), evp-mxu (#6 exactly
    :func:`evp_mxu_launches`, and bit for bit at a merge product's and a
    chase back-transform's shape), gen-evp-d and gen-evp-s (B the HPD
    generator's; float32 with exact kernel launches), gen-evp-d-c5
    (config #5's shape, N cut to 4096: :data:`EVP_CUTS`). Returns the first
    cell's intermediate results for the D&C route sweep and the profile
    phase, with its eigenvalues (``"eigenvalues"``) and stage walls
    (``"stages"``)."""
    import numpy as np

    from dlaf_tpu_torch.miniapp.generators import hpd_element_fn
    from dlaf_tpu_torch.miniapp.miniapp_reduction_to_band import herm_setter

    dtypes = {"s": torch.float32, "d": torch.float64, "z": torch.complex128}
    held, first = {}, None
    for name, n, nb, band, letter, grid, knobs, gen, kind in EVP_CASES:
        key = (n, torch.complex128 if letter == "z" else torch.float64, gen, kind)
        if key not in held:
            held.clear()
            i = torch.arange(n, device=dev, dtype=torch.float64)
            a = (_random_herm(torch, dev, n, key[1], 20 + len(name) + n % 97)
                 if kind == "random" else herm_setter(i[:, None], i[None, :]).to(key[1]))
            b = hpd_element_fn(n, np.float64)(i[:, None], i[None, :]) if gen else None
            w = None
            if kind == "random":
                w = torch.linalg.eigvalsh(a) if b is None else _gen_reference(torch, a, b)
            held[key] = (a, b, w)
        a, b, w = held[key]
        if letter == "s":
            a, b = a.float(), b.float() if b is not None else None
            w = torch.linalg.eigvalsh(a.double()) if b is None else _gen_reference(torch, a, b)
        expect = None
        if _MXU in knobs:
            expect = {"ozaki_product": evp_mxu_launches(*grid, n, nb, band)}
        elif letter == "s" and gen:
            expect = {k: f(*grid, -(-n // nb)) for k, f in GEN_EVP_F32_GRID.items()}
        keep = {} if first is None else None
        if name in EVP_CUTS:
            print(f"[evp] {name}: {EVP_CUTS[name]}", flush=True)
        counts, res, stages, t = evp_cell(torch, dev, card, kmods, name, a.to(dtypes[letter]),
                                          nb, band, grid, knobs, b=b, w_ref=w, expect=expect,
                                          keep=keep)
        if name in EVP_CUTS:
            room = "; ".join(f"{k} {v:.1f} s" for k, v in ROOM.items()) or "none measured"
            print(f"[wall] evp {name} {t:.1f} s beside the room bought for it: {room}",
                  flush=True)
        if first is None:
            # evp-d's eigenvalues and stage walls: the D&C route sweep's
            # comparison
            keep["eigenvalues"] = res.eigenvalues.copy()
            keep["stages"] = stages
            first = keep
        del res
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if _MXU in knobs:
            evp_mxu_products(torch, dev, ok)
    held.clear()
    return first


def evp_mxu_products(torch, dev, ok) -> None:
    """Two of evp-mxu's products under ``f64_gemm=mxu``, through #6 and
    then with it swapped for its plain version, bit for bit: the D&C's
    merge product at n = 2048 (Q1 1024 x 1024 by qc 1024 x 2048) and a
    step level of the chase back-transform (V^H 128 x 255 by E 255 x
    4096). Each must launch #6."""
    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.tile_ops import blas as tb

    config.initialize(argv=["--dlaf:f64-gemm=mxu"])
    gen = torch.Generator(device=dev).manual_seed(16)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float64)

    q1, qc, vh, seg = randn(1024, 1024), randn(1024, 2048), randn(128, 255), randn(255, 4096)
    for name, fn in (("D&C merge Q1 @ qc, 1024 x 2048, K=1024", lambda: tb.mm(q1, qc)),
                     ("chase back-transform V^H E, 128 x 4096, K=255", lambda: tb.mm(vh, seg))):
        before = ok.LAUNCHES["ozaki_product"]
        got = fn()
        torch.cuda.synchronize()
        launched = ok.LAUNCHES["ozaki_product"] - before
        kernel = ok.ozaki_product
        ok.ozaki_product = ok.ozaki_product_plain
        try:
            ref = fn()
        finally:
            ok.ozaki_product = kernel
        same = torch.equal(got, ref)
        print(f"[kernel] ozaki_product evp-mxu {name}: {launched} launch(es), "
              f"{'bitwise equal' if same else 'DIFFER'} to the plain version", flush=True)
        if launched < 1 or not same:
            raise AssertionError(f"evp-mxu {name}: #6 not launched or not bitwise equal")
    config.initialize()


#: evp-d's D&C stage on one card before its merges were sharded: the
#: ``tridiag_solver`` stage this script printed for evp-d when the D&C ran
#: on rank (0, 0)'s device alone (NVIDIA H100 80GB HBM3, 700.00 W).
EVP_D_DC_UNSHARDED_S = 3.156282


def dc_route(torch, dev, card, gk, rows, launches, tri, nb: int = 512, sharded=None) -> None:
    """The D&C's route sweep on evp-d's tridiagonal ``tri`` (a seeded random
    Hermitian A of config #4's shape, chased; leaves ``nb``):
    ``secular_device_min_k`` at 2048, 4096, 8192 and host-only, with walls,
    peak device and host memory; the host-only result checked (eigenvalues
    against scipy's, residual and orthogonality on the card).
    Then the defaults on a (d, e) of independent normal entries (its
    eigenvectors are localized: nearly every pole deflates) and on a
    constant-diagonal Toeplitz T (near-equal poles at every merge,
    deflated by rotations), whose largest Givens undo is held bit for bit
    against the plain loop and timed. ``sharded``: evp-d's eigenvalues
    and D&C stage seconds, its merges sharded over its 4x4 grid; the
    default cell's eigenvalues (one device, cuda's auto 2048) must equal
    them bit for bit."""
    import numpy as np
    import scipy.linalg as sla

    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.eigensolver import tridiag_solver as ts

    d, e = tri.d, tri.e
    n = d.shape[0]
    eps = float(np.finfo(np.float64).eps)

    def solve(dd, ee, knobs):
        config.initialize(argv=knobs)
        stats = []
        gk.reset_launches()
        torch.cuda.synchronize()
        _reset_peak()
        with HostPeak() as host:
            t0 = time.perf_counter()
            lam, q = ts.tridiag_solver(dd, ee, nb, device=dev, stats=stats)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
        launches["givens_undo"] = launches.get("givens_undo", 0) + gk.LAUNCHES["givens_undo"]
        return lam, q, stats, t, _peak_gib(), host.text()

    def check(name, dd, ee, lam, q):
        t_ = torch.as_tensor
        dq = t_(dd, device=dev)[:, None] * q
        dq[:-1] += t_(ee, device=dev)[:, None] * q[1:]
        dq[1:] += t_(ee, device=dev)[:, None] * q[:-1]
        scale = max(np.abs(dd).max(), np.abs(ee).max(), 1.0)
        resid = float(torch.linalg.matrix_norm(dq - q * t_(lam, device=dev)[None, :])) / scale
        gram = q.T @ q
        gram.diagonal().sub_(1.0)
        orth = float(torch.linalg.matrix_norm(gram))
        w = sla.eigvalsh_tridiagonal(dd, ee)
        drift = float(np.abs(lam - w).max()) / scale
        tol = 200 * n * eps
        good = resid < tol and orth < tol and drift < 100 * n * eps
        print(f"check: {'PASSED' if good else 'FAILED'} {name} residual={resid:.3e} "
              f"orthogonality={orth:.3e} eigenvalue_drift={drift:.3e} tol={tol:.3e}", flush=True)
        if not good:
            raise AssertionError(f"{name}: the D&C's eigenpairs fail their check")

    host = 1 << 62
    for mk in (2048, 4096, 8192, host):
        lam, q, stats, t, pdev, phost = solve(d, e, [f"--dlaf:secular-device-min-k={mk}"])
        label = "host-only" if mk == host else str(mk)
        print(f"[dc-route] N={n} nb={nb} secular_device_min_k={label:9s}: {t:.6f} s, peak device "
              f"{pdev:.2f} GiB, peak host {phost}, device secular merges "
              f"{sum(s.route == 'device' for s in stats)} [{card}]", flush=True)
        if mk == config.SECULAR_DEVICE_MIN_K_AUTO["cuda"] and sharded is not None:
            lam_s, t_s = sharded
            same = bool(np.array_equal(lam, lam_s))
            print(f"[dc] evp-d's D&C sharded over its 4x4 grid (one card): stage {t_s:.6f} s; "
                  f"unsharded on the same T in this call {t:.6f} s; unsharded evp-d stage before "
                  f"the sharding {EVP_D_DC_UNSHARDED_S} s (an earlier run); eigenvalues "
                  f"bitwise the unsharded solve's: {same} [{card}]", flush=True)
            if not same:
                raise AssertionError("evp-d: the sharded D&C's eigenvalues differ from the "
                                     "unsharded solve's")
        if mk != host:
            del q
    print(f"[dc-route] D&C: {_dc_levels(stats)}", flush=True)
    check("dc-route evp-d T host-only", d, e, lam, q)
    del q
    rng = np.random.default_rng(9)
    di, ei = rng.standard_normal(n), rng.standard_normal(n - 1)
    lam, q, stats, t, pdev, phost = solve(di, ei, [])
    print(f"[dc-route] iid normal (d, e) N={n} nb={nb} default: {t:.6f} s, peak device "
          f"{pdev:.2f} GiB, peak host {phost} [{card}]; D&C: {_dc_levels(stats)}",
          flush=True)
    check("dc-route iid", di, ei, lam, q)
    del q
    config.initialize()
    print(f"[dc-route] cuda auto: secular_device_min_k={config.resolve_secular_device_min_k('cuda')}"
          f" ({config.DC_AUTO_NOTE})", flush=True)

    # a Toeplitz T: near-equal poles at every merge, deflated by rotations
    dt_, et_ = np.full(n, 2.0), np.full(n - 1, 1.0)
    biggest = {}
    kernel = gk.givens_undo

    def record(u, giv):
        if len(giv) > len(biggest.get("giv", ())):
            biggest.update(u=u.clone(), giv=np.asarray(giv).copy())
        return kernel(u, giv)

    gk.givens_undo = record
    try:
        lam, q, stats, t, pdev, phost = solve(dt_, et_, [])
    finally:
        gk.givens_undo = kernel
    used = gk.LAUNCHES["givens_undo"]
    print(f"[dc-route] toeplitz N={n} nb={nb} default: {t:.6f} s, peak device {pdev:.2f} GiB, "
          f"Givens undo launches {used} [{card}]; D&C: {_dc_levels(stats)}", flush=True)
    check("dc-route toeplitz", dt_, et_, lam, q)
    del q
    if used < 1 or not biggest:
        raise AssertionError("dc-route toeplitz: the Givens undo kernel was not launched")
    u0, giv = biggest["u"], biggest["giv"]
    got = gk.givens_undo(u0.clone(), giv)
    ref = gk.givens_undo_plain(u0.clone(), giv)
    torch.cuda.synchronize()
    same = torch.equal(got, ref)
    err = float((got - ref).abs().max())
    print(f"[kernel] givens_undo u {tuple(u0.shape)}, {len(giv)} rotations: "
          f"{'bitwise equal' if same else 'DIFFERS'} to the plain loop", flush=True)
    if not same:
        raise AssertionError("givens_undo differs from its plain version")
    w = u0.shape[1]
    touched = len(np.unique(giv[:, :2]))
    nbytes = 2 * touched * w * 8 + giv.nbytes
    bms, by = bound(nbytes, 6.0 * len(giv) * w, "float64")
    rows["givens_undo"] = dict(max_abs_err=err, ms=time_ms(torch, lambda: gk.givens_undo(
        u0.clone(), giv)), batch_ms=batch_ms(torch, lambda: gk.givens_undo(u0.clone(), giv),
                                              calls=10),
        plain_ms=time_ms(torch, lambda: gk.givens_undo_plain(u0.clone(), giv), reps=1, warm=0),
        library_ms=None, bound_ms=bms, bound_by=by)
    clone_ms = time_ms(torch, lambda: u0.clone())
    r = rows["givens_undo"]
    print(f"[time] givens_undo   kernel={r['ms']:.4f} ms (batched {r['batch_ms']:.4f} ms) "
          f"plain={r['plain_ms']:.4f} ms (each with a {clone_ms:.4f} ms copy of u) "
          f"bound={bms:.5f} ms ({by}) [{card}]", flush=True)


def evp_miniapp(torch, drive, card) -> None:
    """``miniapp_eigensolver`` at N=4096, nb=256, 2x2 on this card, standard
    and ``--generalized`` (the analytic setter, B the HPD generator's), one
    warm-up and one timed run each with its check line: the CLI end to
    end."""
    from dlaf_tpu_torch.miniapp import miniapp_eigensolver as mes

    base = ["-m", "4096", "-b", "256", "--grid-rows", "2", "--grid-cols", "2", "--share-device",
            "--nruns", "1", "--nwarmups", "1", "--check-result", "last"]
    for name, extra in (("evp", []), ("gen_evp", ["--generalized"])):
        t = drive([*base, *extra], 4096, 256, 1, {}, app=mes)
        print(f"[miniapp] miniapp_eigensolver {name} N=4096 nb=256 2x2 d: {t:.6f} s "
              f"{10 * 4096 ** 3 / 3 / t / 1e9:.2f} GFlop/s [{card}]", flush=True)


def profile_evp(torch, dev, keep) -> None:
    """:func:`profile_run` of evp-d's device stages on its chase output:
    the D&C, the chase back-transform onto the 4x4 grid and the
    reflector-block back-transform (no warm-up: evp-d ran these shapes)."""
    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.eigensolver.back_transform import bt_band_to_tridiag, bt_reduction_to_band
    from dlaf_tpu_torch.eigensolver.tridiag_solver import tridiag_solver
    from dlaf_tpu_torch.matrix.matrix import Matrix

    config.initialize()
    red, tri = keep["reduction"], keep["tridiag"]
    mat = red.matrix

    def stages():
        _, z = tridiag_solver(tri.d, tri.e, mat.block_size.row, device=dev)
        zb = bt_band_to_tridiag(tri, Matrix.from_global(z, mat.block_size, grid=mat.grid,
                                                        source_rank=mat.dist.source_rank))
        del z
        return bt_reduction_to_band(red, zb)

    profile_run(torch, "evp-d device stages (D&C, bt_b2t, bt_r2b) n=16384 nb=512 band=128 "
                "grid 4x4 on one card default", stages, warm=False)


def b2t_forms(torch, dev, card, keep, cols: int = 512) -> None:
    """The chase back-transform on evp-d's reflectors by the path's blocked
    form (``bt_band_to_tridiag``) against the reference's sweeps form
    (``_bt_b2t_scan``, on no path), one call each on a ``cols``-column
    random E on one device: sweeps at evp-d's full width would take about
    a minute (16k rank-1 segment updates of 2 GB each)."""
    from dlaf_tpu_torch.eigensolver import back_transform as bt

    tri = keep["tridiag"]
    n = tri.d.shape[0]
    e = torch.randn(n, cols, generator=torch.Generator(device=dev).manual_seed(17), device=dev,
                    dtype=torch.float64)
    v, tau, _ = bt._reflectors(tri, e.device)
    forms = (("blocked", lambda: bt.bt_band_to_tridiag(tri, e)),
             ("sweeps", lambda: bt._bt_b2t_scan(v, tau, e, b=tri.band, n=n)))
    walls, outs = {}, {}
    for name, fn in forms:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    diff = float((outs["blocked"] - outs["sweeps"]).abs().max())
    for name, wall in walls.items():
        print(f"[bt_b2t] evp-d reflectors N={n} band={tri.band} on {cols} columns, {name}: "
              f"{wall:.6f} s [{card}]", flush=True)
    print(f"[bt_b2t] blocked against sweeps: max abs difference {diff:.3e}", flush=True)
    if not diff < 1e-10:
        raise AssertionError("bt_b2t: blocked and sweeps disagree")


def profile_red2band(torch, dev, n: int = 16384, nb: int = 512, band: int = 128) -> None:
    """:func:`profile_run` of one config #4 reduction to band (float64, the
    analytic setter, 4x4 on ``dev``) by the default step mode."""
    import numpy as np

    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import GlobalElementSize, TileElementSize
    from dlaf_tpu_torch.eigensolver.reduction_to_band import reduction_to_band
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp.miniapp_reduction_to_band import herm_setter

    config.initialize()
    ref = Matrix.from_element_fn(herm_setter, GlobalElementSize(n, n), TileElementSize(nb, nb),
                                 shared_grid(4, 4, dev), dtype=np.float64, device=dev)
    mats = [ref.clone(), ref.clone()]
    del ref
    profile_run(torch, f"red2band-d n={n} nb={nb} band={band} grid 4x4 on one card default",
                lambda: reduction_to_band(mats.pop(), band_size=band, donate=True),
                host_ops=False)


# ---------------------------------------------------------------------------
# The rest of the algorithms layer and the serving entry point
# ---------------------------------------------------------------------------

#: Seed of the serve phase's request stream and the algos phase's matrices.
SERVE_SEED = 20261017


def _reset_peak() -> None:
    """Reset the card's peak-memory counter and program telemetry's floor
    of it (:func:`dlaf_tpu_torch.obs.telemetry.reset_peak_memory_stats`)."""
    from dlaf_tpu_torch.obs import telemetry

    telemetry.reset_peak_memory_stats()


def _peak_gib() -> float:
    """The card's peak allocation since :func:`_reset_peak`, in GiB,
    whole across program telemetry's own resets."""
    from dlaf_tpu_torch.obs import telemetry

    return telemetry.max_memory_allocated() / 2 ** 30


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def counted(kmods, launches, expect, fn, what: str):
    """``fn()`` with every kernel's count set to 0 just before it and read
    just after: fails unless the counts equal ``expect`` (a name missing
    from it: 0), adds them to ``launches`` and returns ``fn``'s result."""
    for m in kmods:
        m.reset_launches()
    out = fn()
    counts = {k: v for m in kmods for k, v in m.LAUNCHES.items()}
    want = {k: expect.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    for k, v in counts.items():
        launches[k] += v
    return out


def algos_phase(torch, dev, card, kmods, launches, drive, n: int = 16384, nb: int = 512,
                grid=(4, 4), gn: int = 8192, gnb: int = 256, gen_n: int = 4096,
                gen_nb: int = 256) -> None:
    """``max_norm`` and the grid ``permute`` at BASELINE config #4's shape
    (float64, N=16384, nb=512, 4x4 on this card, source rank (1, 2); a row
    range and a column range of 4 tiles), bitwise against ``abs().max()``
    and ``index_select`` on the gathered matrix; ``max_norm`` of a
    unit-modulus complex128 matrix of that shape bitwise against numpy's
    absolute value; ``general_sub_multiply``
    (float64, N=8192, nb=256, 2x2) against ``torch.matmul`` at ``60 k
    eps``, natively over 16 tiles and under ``f64_gemm=mxu`` over 4 (one
    #6 launch); ``miniapp_gen_eigensolver`` with its check line."""
    import numpy as np

    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.algorithms import general_sub_multiply, max_norm, permute
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import RankIndex2D, TileElementSize
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp import miniapp_gen_eigensolver as mge

    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    f64 = torch.float64
    a = torch.randn(n, n, generator=gen, device=dev, dtype=f64)
    mat = Matrix.from_global(a, TileElementSize(nb, nb), shared_grid(*grid, dev),
                             source_rank=RankIndex2D(1, 2))
    for uplo in ("G", "L"):
        _sync(torch, dev)
        t0 = time.perf_counter()
        got = counted(kmods, launches, {}, lambda: max_norm(mat, uplo), f"max_norm {uplo}")
        t = time.perf_counter() - t0
        want = float((a.tril() if uplo == "L" else a).abs().max())
        print(f"[algos] max_norm {uplo} d N={n} nb={nb} {grid[0]}x{grid[1]}: {got!r} against "
              f"abs().max() {want!r} ({'bitwise' if got == want else 'DIFFER'}) {t:.6f} s "
              f"[{card}]", flush=True)
        if got != want:
            raise AssertionError(f"max_norm {uplo}: {got!r} != {want!r}")
    prng = np.random.default_rng(SERVE_SEED)
    for coord, t_begin in (("Row", 3), ("Col", min(9, n // nb - 4))):
        a0, a1 = t_begin * nb, (t_begin + 4) * nb
        perm = prng.permutation(a1 - a0)
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = counted(kmods, launches, {}, lambda: permute(coord, perm, mat, t_begin,
                                                           t_begin + 4), f"permute {coord}")
        _sync(torch, dev)
        t = time.perf_counter() - t0
        idx = torch.as_tensor(perm, device=dev) + a0
        want = a.clone()
        if coord == "Row":
            want[a0:a1] = a.index_select(0, idx)
        else:
            want[:, a0:a1] = a.index_select(1, idx)
        same = torch.equal(out.to_global(), want)
        print(f"[algos] permute {coord} tiles [{t_begin}, {t_begin + 4}) d N={n} nb={nb} "
              f"{grid[0]}x{grid[1]}: {'bitwise' if same else 'DIFFER'} against index_select, "
              f"{t:.6f} s [{card}]", flush=True)
        if not same:
            raise AssertionError(f"permute {coord} disagrees with index_select")
        del out, want
    del mat, a
    # complex128: unit-modulus entries, every one a candidate for the
    # maximum to its last bit, held bitwise against numpy's absolute value
    # of the host copy (the reference's); and the device's elementwise
    # complex absolute value against numpy's on a million entries
    from dlaf_tpu_torch.algorithms.norm import _cabs

    theta = torch.rand(n, n, generator=gen, device=dev, dtype=f64) * (2 * np.pi)
    z = torch.polar(torch.ones_like(theta), theta)
    del theta
    zmat = Matrix.from_global(z, TileElementSize(nb, nb), shared_grid(*grid, dev),
                              source_rank=RankIndex2D(1, 2))
    zabs = np.abs(z.cpu().numpy())
    del z
    for uplo in ("G", "L"):
        _sync(torch, dev)
        t0 = time.perf_counter()
        got = counted(kmods, launches, {}, lambda: max_norm(zmat, uplo), f"max_norm z {uplo}")
        t = time.perf_counter() - t0
        want = float((np.tril(zabs) if uplo == "L" else zabs).max())
        print(f"[algos] max_norm {uplo} z (unit modulus) N={n} nb={nb} {grid[0]}x{grid[1]}: "
              f"{got!r} against numpy {want!r} ({'bitwise' if got == want else 'DIFFER'}) "
              f"{t:.6f} s [{card}]", flush=True)
        if got != want:
            raise AssertionError(f"max_norm z {uplo}: {got!r} != {want!r}")
    del zmat, zabs
    for cdt in (torch.complex128, torch.complex64):
        g = torch.randn(1 << 20, generator=gen, device=dev, dtype=cdt)
        for label, zz in (("gaussian", g), ("unit", g / g.abs())):
            same = np.array_equal(_cabs(zz).cpu().numpy(), np.abs(zz.cpu().numpy()))
            print(f"[algos] complex abs {str(cdt)[6:]} {label} (2^20 entries) on {dev.type}: "
                  f"{'bitwise' if same else 'DIFFERS from'} numpy's", flush=True)
            if not same:
                raise AssertionError(f"complex abs {cdt} {label} differs from numpy's")
    mats = [torch.randn(gn, gn, generator=gen, device=dev, dtype=f64) for _ in range(3)]
    pm = [Matrix.from_global(x, TileElementSize(gnb, gnb), shared_grid(2, 2, dev)) for x in mats]
    alpha, beta = 0.75, -1.5
    eps = float(torch.finfo(f64).eps)
    for label, argv, t_rng, expect in (
            ("native", [], (4, 20), {}),
            # one #6 launch on the card (a CPU rehearsal runs its plain version)
            ("mxu", ["--dlaf:f64-gemm=mxu"], (4, 8), {"ozaki_product": int(dev.type == "cuda")})):
        config.initialize(argv=argv)
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = counted(kmods, launches, expect, lambda: general_sub_multiply(
            alpha, pm[0], pm[1], beta, pm[2], *t_rng), f"general_sub_multiply {label}")
        _sync(torch, dev)
        t = time.perf_counter() - t0
        config.initialize()
        r = slice(t_rng[0] * gnb, min(t_rng[1] * gnb, gn))
        k = r.stop - r.start
        got = out.to_global()
        ref = alpha * (mats[0][r, r] @ mats[1][r, r]) + beta * mats[2][r, r]
        err = float((got[r, r] - ref).abs().max())
        scale = (abs(alpha) * float(mats[0][r, r].abs().max() * mats[1][r, r].abs().max()) * k
                 + abs(beta) * float(mats[2][r, r].abs().max()))
        tol = 60 * k * eps * scale
        outside = got.clone()
        outside[r, r] = mats[2][r, r]
        print(f"[algos] general_sub_multiply {label} d N={gn} nb={gnb} 2x2 tiles "
              f"[{t_rng[0]}, {t_rng[1]}) k={k}: max_abs_err={err:.3e} tol={tol:.3e} "
              f"{t:.6f} s [{card}]", flush=True)
        if not (err <= tol and torch.equal(outside, mats[2])):
            raise AssertionError(f"general_sub_multiply {label} disagrees with torch.matmul")
        del out, got, outside
    del pm, mats
    t = drive(["-m", str(gen_n), "-b", str(gen_nb), "--nruns", "1", "--nwarmups", "0",
               "--check-result", "last"], gen_n, gen_nb, 1, {}, app=mge)
    print(f"[algos] miniapp_gen_eigensolver N={gen_n} nb={gen_nb} d local: {t:.6f} s "
          f"{10 * gen_n ** 3 / 3 / t / 1e9:.2f} GFlop/s [{card}]", flush=True)


def _serve_inputs(torch, dev, op, dt, b, n, gen):
    """A (b, n, n) batch of well-conditioned problems of ``op`` (and the
    solve's (b, n, 4) right-hand sides)."""
    x = torch.randn(b, n, n, generator=gen, device=dev, dtype=dt)
    eye = torch.eye(n, device=dev, dtype=dt)
    if op == "cholesky":
        return x @ x.mH / n + eye, None
    if op == "solve":
        return eye + torch.tril(x, -1) / n, torch.randn(b, n, 4, generator=gen, device=dev,
                                                          dtype=dt)
    return (x + x.mH) / 2, None


def serve_contracts(torch, dev, card, kmods, launches, svc) -> None:
    """The serving contracts on the card for float32, float64 and
    complex128: lane i of a B-lane dispatch equals the B=1 dispatch,
    bitwise, at B = 4, 16 and 64 and n = 20, 48 and 200 (lanes 16-63 of
    B=64 against B=16 dispatches of the same lanes; and whether the bare
    library call would have: informational); pad lanes inert; one
    indefinite lane flagged, the clean lanes 0 and bitwise unchanged;
    ``donate=False`` leaves the input bitwise as it was, ``donate=True``
    factors in place."""
    from dlaf_tpu_torch.algorithms import batched as bt
    from dlaf_tpu_torch.serve import cholesky_batched, eigh_batched, solve_batched

    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)

    def run(op, x, rhs):
        if op == "cholesky":
            return cholesky_batched("L", x, with_info=True, service=svc)
        if op == "solve":
            return solve_batched("L", "L", "N", "N", 1.0, x, rhs, with_info=True, service=svc)
        return eigh_batched("L", x, with_info=True, service=svc)

    def bare(op, x, rhs):
        if op == "cholesky":
            return (torch.linalg.cholesky_ex(x)[0],)
        if op == "solve":
            return (torch.linalg.solve_triangular(torch.tril(x), rhs, upper=False),)
        return torch.linalg.eigh(x)

    def same(u, v, i, j):
        return all(torch.equal(torch.nan_to_num(p[i]), torch.nan_to_num(q[j]))
                   for p, q in zip(u, v))

    for dt in (torch.float32, torch.float64, torch.complex128):
        for n in (20, 48, 200):
            for op in ("cholesky", "solve", "eigh"):
                x, rhs = _serve_inputs(torch, dev, op, dt, 64, n, gen)

                def sub(i, j):
                    return x[i:j], None if rhs is None else rhs[i:j]

                def lanes():
                    ones = [run(op, *sub(i, i + 1)) for i in range(16)]
                    sixteens = [run(op, *sub(i, i + 16)) for i in (16, 32, 48)]
                    return ones, sixteens, {b: run(op, *sub(0, b)) for b in (4, 16, 64)}

                ones, sixteens, outs = counted(kmods, launches, {}, lanes,
                                               f"serve lanes {op}")
                # lanes below 16 against B=1; lanes 16-63 of B=64 against
                # the B=16 dispatches of the same lanes
                ok_ = (all(same(outs[b], ones[i], i, 0) for b in (4, 16, 64) for i in range(16)
                           if i < b)
                       and all(same(outs[64], sixteens[i // 16 - 1], i, i % 16)
                               for i in range(16, 64)))
                lib = bare(op, *sub(0, 16))
                lib1 = [bare(op, *sub(i, i + 1)) for i in range(16)]
                lib_ok = all(same(lib, lib1[i], i, 0) for i in range(16))
                form = (f"calls of exactly {bt.MIN_LANES['cuda']} lanes" if op == "solve"
                        else f"one call of at least {bt.MIN_LANES['cuda']} lanes")
                print(f"[serve] lane-parity {op:8s} {str(dt)[6:]:10s} n={n:3d}: lane i of B=4, "
                      f"16 and 64 vs B=1 (and B=16) {'bitwise' if ok_ else 'DIFFER'} (call form: "
                      f"{form}); bare library B=16 vs B=1 "
                      f"{'bitwise' if lib_ok else 'differs'}", flush=True)
                if not ok_:
                    raise AssertionError(f"lane parity fails: {op} {dt} n={n}")
        n = 48
        full, _ = _serve_inputs(torch, dev, "cholesky", dt, 16, n, gen)
        padded = full.clone()
        padded[4:] = torch.eye(n, device=dev, dtype=dt)
        mixed = full.clone()
        mixed[5] -= 3 * torch.eye(n, device=dev, dtype=dt)
        keep = mixed.clone()

        def contracts():
            return (cholesky_batched("L", full, with_info=True, service=svc),
                    cholesky_batched("L", padded, with_info=True, service=svc),
                    cholesky_batched("L", mixed, with_info=True, service=svc))

        (of, inf_f), (op_, inf_p), (om, inf_m) = counted(kmods, launches, {}, contracts,
                                                         "serve contracts")
        eye = torch.eye(n, device=dev, dtype=dt)
        pad_ok = (torch.equal(of[:4], op_[:4]) and all(torch.equal(op_[i], eye)
                                                       for i in range(4, 16))
                  and not inf_p.any() and not inf_f.any())
        clean = [i for i in range(16) if i != 5]
        info_ok = (int(inf_m[5]) >= 1 and not inf_m[clean].any()
                   and torch.equal(om[clean], of[clean]))
        donate_ok = torch.equal(mixed, keep)
        own = full.clone()
        fac = cholesky_batched("L", own, donate=True, service=svc)
        donate_ok = donate_ok and fac.data_ptr() == own.data_ptr() and torch.equal(fac, of)
        print(f"[serve] contracts {str(dt)[6:]:10s} n={n}: pad lanes "
              f"{'inert' if pad_ok else 'NOT INERT'}; info {inf_m.tolist()} "
              f"({'failing lane flagged, clean lanes 0 and bitwise' if info_ok else 'WRONG'}); "
              f"donate=False input {'unchanged' if torch.equal(mixed, keep) else 'CHANGED'}, "
              f"donate=True {'in place' if donate_ok else 'NOT IN PLACE'}", flush=True)
        if not (pad_ok and info_ok and donate_ok):
            raise AssertionError(f"serve contracts fail for {dt}")


def _stream_requests(np, Request, count, seed, lo=17, hi=256):
    """``count`` float64 requests, n uniform over [lo, hi]: 50% cholesky,
    30% solve (nrhs uniform over 1..16), 20% eigh, from ``seed``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(count):
        u, n = rng.random(), int(rng.integers(lo, hi + 1))
        x = rng.standard_normal((n, n))
        if u < 0.5:
            reqs.append(Request(op="cholesky", a=x @ x.T / n + np.eye(n)))
        elif u < 0.8:
            b = rng.standard_normal((n, int(rng.integers(1, 17))))
            reqs.append(Request(op="solve", a=np.eye(n) + np.tril(x, -1) / n, b=b,
                                alpha=float(rng.choice([1.0, -0.5]))))
        else:
            reqs.append(Request(op="eigh", a=(x + x.T) / 2))
    return reqs


def _residual_ok(np, t) -> tuple[bool, float, float]:
    """(within budget, residual, budget) of one served request: the
    factor's ``|L L^T - A| / |A|`` and the solve's ``|T X - alpha B| /
    (|T| |X|)`` below ``60 n eps``, the eigenpairs' ``|A V - V W| / |A|``
    and ``|V^T V - I|`` below ``200 n eps`` (Frobenius norms)."""
    req, eps = t.request, np.finfo(np.float64).eps
    a = np.asarray(req.a)
    n = a.shape[0]
    if req.op == "cholesky":
        l = np.tril(t.result())
        r, c = np.linalg.norm(l @ l.T - a) / np.linalg.norm(a), 60
    elif req.op == "solve":
        x, tri = t.result(), np.tril(a)
        r = np.linalg.norm(tri @ x - req.alpha * req.b) / (np.linalg.norm(tri)
                                                           * np.linalg.norm(x))
        c = 60
    else:
        w, v = t.result()
        r = max(np.linalg.norm(a @ v - v * w[None, :]) / np.linalg.norm(a),
                np.linalg.norm(v.T @ v - np.eye(n)))
        c = 200
    return bool(r <= c * n * eps and t.info == 0), float(r), c * n * eps


def serve_phase(torch, dev, card, kmods, launches, count: int = 2048,
                buckets=(32, 64, 128, 256), batch: int = 16, rounds: int = 12) -> None:
    """The serving entry point on the card: the contracts
    (:func:`serve_contracts`); a warm stream of ``count`` float64 requests
    through ``Queue`` (buckets 32/64/128/256, 16 lanes, the default 50 ms
    deadline on the host clock), every answer checked by its residual,
    with requests/s, p50/p99 latency, dispatches and mean lane fill; the
    stream's Cholesky problems through the queue alone, through
    ``cholesky_batched`` over padded batches and through a loop of
    singleton ``cholesky()`` calls (the reference's serve arm), the three
    alternating over ``rounds`` rounds, each round's ratio per form; an
    overload pass (max_depth 16, shed, a 2x burst into one bucket) that
    fails if depth passes the bound or an accepted ticket is stranded; and
    ``robust_cholesky_batched`` with two indefinite lanes."""
    import numpy as np

    from dlaf_tpu_torch import config, health
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.common.index2d import TileElementSize
    from dlaf_tpu_torch.health.errors import OverloadError
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.serve import (ProgramService, Queue, Request, bucket_ceiling,
                                      cholesky_batched)

    svc = ProgramService(device=dev)
    t_phase = time.perf_counter()
    serve_contracts(torch, dev, card, kmods, launches, svc)
    print(f"[serve] contracts {time.perf_counter() - t_phase:.1f} s", flush=True)

    reqs = _stream_requests(np, Request, count, SERVE_SEED)
    q = Queue(ProgramService(device=dev), batch=batch, buckets=buckets)
    t0 = time.perf_counter()
    walls = q.warmup(reqs)
    print(f"[serve] warmup: {len(walls)} bucket programs in {time.perf_counter() - t0:.2f} s "
          f"(first warm calls {sum(walls.values()):.2f} s)", flush=True)

    def stream():
        t0 = time.perf_counter()
        tickets = [q.submit(r) for r in reqs]
        q.flush()
        return tickets, time.perf_counter() - t0

    tickets, wall = counted(kmods, launches, {}, stream, "serve stream")
    checks = [_residual_ok(np, t) for t in tickets]
    worst = {op: max((r / tol for (ok_, r, tol), t in zip(checks, tickets)
                      if t.request.op == op), default=0.0) for op in ("cholesky", "solve", "eigh")}
    lat = np.array([t.total_s for t in tickets])
    st, sst = q.stats(), q.service.stats()
    fill = count / (st["dispatches"] * batch)
    print(f"[serve] stream: {count} f64 requests (n 17-256: "
          f"{sum(t.request.op == 'cholesky' for t in tickets)} cholesky, "
          f"{sum(t.request.op == 'solve' for t in tickets)} solve, "
          f"{sum(t.request.op == 'eigh' for t in tickets)} eigh) in {wall:.4f} s: "
          f"{count / wall:.1f} requests/s, latency p50 {np.percentile(lat, 50) * 1e3:.3f} ms "
          f"p99 {np.percentile(lat, 99) * 1e3:.3f} ms, {st['dispatches']} dispatches, mean "
          f"lane fill {fill:.3f}, cache hit rate {sst['hit_rate']:.3f} [{card}]", flush=True)
    print(f"[serve] stream residuals: worst residual/budget cholesky {worst['cholesky']:.3e} "
          f"solve {worst['solve']:.3e} eigh {worst['eigh']:.3e}; "
          f"{sum(c[0] for c in checks)} of {count} within budget", flush=True)
    if not (all(c[0] for c in checks) and all(t.done for t in tickets)):
        raise AssertionError("serve stream: a request missed its residual budget")
    if sst["misses"]:
        raise AssertionError(f"serve stream after warmup missed the cache: {sst}")

    # the Cholesky problems alone: the queue, the batched entry over
    # padded batches and a loop of singleton cholesky() calls
    chol = [r.a for r in reqs if r.op == "cholesky"]
    qc = Queue(ProgramService(device=dev), batch=batch, buckets=buckets)
    qc.warmup([Request(op="cholesky", a=a) for a in chol])
    by_bucket = {}
    for a in chol:
        by_bucket.setdefault(bucket_ceiling(len(a), buckets), []).append(a)
    padded = []
    for bn, group in by_bucket.items():
        for i in range(0, len(group), batch):
            pb = np.broadcast_to(np.eye(bn), (batch, bn, bn)).copy()
            for j, a in enumerate(group[i:i + batch]):
                pb[j, :len(a), :len(a)] = a
            padded.append(pb)
    csvc = ProgramService(device=dev)
    mats = [Matrix.from_global(a, TileElementSize(len(a), len(a)), device=dev) for a in chol]

    def queue_pass():
        ts = [qc.submit(Request(op="cholesky", a=a)) for a in chol]
        qc.flush()
        return ts

    def batched_pass():
        for pb in padded:
            out, info = cholesky_batched("L", pb, with_info=True, service=csvc)
        _sync(torch, dev)

    def singles_pass():
        outs = [cholesky("L", m.clone(), donate=True) for m in mats]
        _sync(torch, dev)
        return outs

    # float64 takes the composed panel route at any block size; naming it
    # spares one announcement per distinct order
    config.initialize(argv=["--dlaf:panel-impl=xla", "--dlaf:step-impl=xla"])

    # the three forms alternate, round after round, so a slow stretch of
    # the shared host falls on all of them: medians and spreads of the
    # rounds
    forms = (("queue", queue_pass), ("batched entry", batched_pass), ("singles", singles_pass))
    for _, fn in forms:
        fn()                                  # warm
    times = {name: [] for name, _ in forms}
    for _ in range(rounds):
        for name, fn in forms:
            t0 = time.perf_counter()
            counted(kmods, launches, {}, fn, f"serve cholesky {name}")
            times[name].append(time.perf_counter() - t0)
    config.initialize()
    med = {k: float(np.median(v)) for k, v in times.items()}
    rps = {k: len(chol) / v for k, v in med.items()}
    spread = {k: f"{len(chol) / max(v):.1f}-{len(chol) / min(v):.1f}" for k, v in times.items()}
    ratio = {k: sorted(a / b for a, b in zip(times["singles"], times[k]))
             for k in ("batched entry", "queue")}
    print(f"[serve] cholesky only ({len(chol)} problems, n 17-256, f64; medians of {rounds} "
          f"alternating rounds, range in brackets): queue {rps['queue']:.1f} "
          f"[{spread['queue']}] req/s, batched entry {rps['batched entry']:.1f} "
          f"[{spread['batched entry']}] req/s, singleton cholesky() loop {rps['singles']:.1f} "
          f"[{spread['singles']}] req/s; batched/singles {med['singles'] / med['batched entry']:.2f}x "
          f"[{ratio['batched entry'][0]:.2f}-{ratio['batched entry'][-1]:.2f}], queue/singles "
          f"{med['singles'] / med['queue']:.2f}x [{ratio['queue'][0]:.2f}-{ratio['queue'][-1]:.2f}]"
          f" [{card}]", flush=True)
    print("[serve] cholesky rounds (s): " + "; ".join(
        f"{k} {[round(t, 4) for t in v]}" for k, v in times.items()), flush=True)

    # overload: a 2x burst into one bucket whose batch cannot fill first
    rng = np.random.default_rng(SERVE_SEED + 1)
    burst = []
    for _ in range(32):
        n = int(rng.integers(17, 33))
        x = rng.standard_normal((n, n))
        burst.append(x @ x.T / n + np.eye(n))
    qo = Queue(ProgramService(device=dev), batch=32, deadline_s=1e9, buckets=(32,), max_depth=16,
               shed=True)
    qo.warmup([Request(op="cholesky", a=burst[0])])
    for i in range(2):
        tickets, shed, depth = [], 0, 0
        t0 = time.perf_counter()
        for a in burst:
            try:
                tickets.append(qo.submit(Request(op="cholesky", a=a)))
            except OverloadError:
                shed += 1
            depth = max(depth, qo.pending())
        qo.flush()
        t = time.perf_counter() - t0
        stranded = [tk for tk in tickets if not tk.done]
        lat = [tk.total_s for tk in tickets]
        print(f"[serve] overload pass {i}: 32-request burst, max_depth 16: accepted "
              f"{len(tickets)}, shed {shed}, max depth {depth}, stranded {len(stranded)}, "
              f"accepted {len(tickets) / t:.1f} req/s p99 {np.percentile(lat, 99) * 1e3:.3f} ms "
              f"[{card}]", flush=True)
        if depth > 16 or stranded or shed != 16:
            raise AssertionError("overload: the depth bound or the accepted tickets failed")

    # recovery: two indefinite lanes re-shifted through the one program
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 2)
    x = torch.randn(16, 64, 64, generator=gen, device=dev, dtype=torch.float64)
    eye = torch.eye(64, device=dev, dtype=torch.float64)
    a = x @ x.mT / 64 + eye
    for i in (3, 9):
        # barely indefinite: the third shift (about 4e-4) recovers the lane
        a[i] -= (float(torch.linalg.eigvalsh(a[i])[0]) + 1e-4) * eye
    rsvc = ProgramService(device=dev)
    plain, _ = cholesky_batched("L", a.clone(), with_info=True, service=ProgramService(device=dev))
    res = counted(kmods, launches, {}, lambda: health.robust_cholesky_batched("L", a,
                                                                              service=rsvc),
                  "robust_cholesky_batched")
    clean = [i for i in range(16) if i not in (3, 9)]
    fixed = []
    for i in (3, 9):
        l = res.out[i].tril()
        shift = res.shifts[res.lane_attempts[i] - 1]
        fixed.append(float(torch.linalg.matrix_norm(l @ l.mT - a[i] - shift * eye)
                           / torch.linalg.matrix_norm(a[i] + shift * eye)))
    ok_ = (res.lane_attempts[3] >= 2 and res.lane_attempts[9] >= 2
           and all(res.lane_attempts[i] == 1 for i in clean)
           and torch.equal(res.out[clean], plain[clean])
           and max(fixed) <= 60 * 64 * float(torch.finfo(torch.float64).eps)
           and rsvc.stats()["compiles"] == 1)
    print(f"[serve] robust_cholesky_batched: attempts {res.attempts}, lane attempts "
          f"{res.lane_attempts}, shifts {res.shifts}, recovered lanes' residual "
          f"{max(fixed):.3e}, clean lanes bitwise the plain dispatch, one bucket program: "
          f"{'ok' if ok_ else 'FAIL'}", flush=True)
    if not ok_:
        raise AssertionError("robust_cholesky_batched on the card")


# ---------------------------------------------------------------------------
# The fleet phase: router and worker processes on the card
# ---------------------------------------------------------------------------

#: Bucket ceilings of the fleet phase (the serve phase's), for the router's
#: bucket strings and the workers' queues alike.
FLEET_BUCKETS = "32,64,128,256"


def _fleet_layout() -> tuple:
    """``(tag, worker indices)`` of the fleet phase's three fleets: as many
    as the ``fleet_workers`` knob says (``DLAF_FLEET_WORKERS``, 3) behind
    R1, one behind R2, two behind R3. The indices differ between the
    fleets, so each router's workers have breakers (``fleet.worker{k}``,
    one per process) and ``%r`` shards of their own. Legs b and c each
    stop one of R1's workers and leave it one to take their tickets: R1
    needs three."""
    from dlaf_tpu_torch import config

    workers = config.get_configuration().fleet_workers
    if workers < 3:
        raise ValueError(f"fleet phase: fleet_workers={workers}; legs b and c need 3 or more")
    return (("w", tuple(range(workers))), ("one", (workers,)),
            ("off", (workers + 1, workers + 2)))


def _fleet_wait(router, cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"fleet: {what} (router {router.stats()})")
        router.poll()
        time.sleep(0.002)


def _fleet_resolve(router, tickets, timeout: float = 120.0) -> dict:
    """Poll ``router`` until every ticket resolves; ``{seq: perf_counter
    at which its resolution was seen}`` and the seconds spent inside
    ``poll`` (the router thread's own work)."""
    seen, busy = {}, 0.0
    deadline = time.monotonic() + timeout
    while len(seen) < len(tickets):
        if time.monotonic() > deadline:
            raise AssertionError(f"fleet: {len(tickets) - len(seen)} tickets unresolved after "
                                 f"{timeout} s ({router.stats()})")
        t0 = time.perf_counter()
        router.poll()
        now = time.perf_counter()
        busy += now - t0
        for t in tickets:
            if t.seq not in seen and t.resolved():
                seen[t.seq] = now
        time.sleep(0.001)
    return seen, busy


def _fleet_stream(np, router, reqs):
    """Submit ``reqs``, flush, wait: (tickets, wall, end-to-end latencies at
    the router, the router thread's busy seconds)."""
    t0 = time.perf_counter()
    tickets, sent = [], {}
    for r in reqs:
        t = router.submit(r)
        sent[t.seq] = time.perf_counter()
        tickets.append(t)
    router.flush()
    busy = time.perf_counter() - t0
    seen, polled = _fleet_resolve(router, tickets)
    wall = time.perf_counter() - t0
    return tickets, wall, np.array([seen[t.seq] - sent[t.seq] for t in tickets]), busy + polled


def _fleet_check(np, tickets, what: str) -> str:
    """Every resolved ticket's residual within its budget (the serve
    phase's check); the worst residual/budget per op."""
    checks = [(t, _residual_ok(np, t)) for t in tickets]
    bad = [t.seq for t, c in checks if not c[0]]
    if bad:
        raise AssertionError(f"fleet {what}: tickets {bad[:8]} missed their residual budget")
    worst = {op: max((c[1] / c[2] for t, c in checks if t.request.op == op), default=0.0)
             for op in ("cholesky", "solve", "eigh")}
    return " ".join(f"{op} {v:.3e}" for op, v in worst.items())


def _fleet_victim(router, tickets, live, settle: float = 0.3) -> tuple:
    """After ``settle`` seconds of polling (full batches come back), the
    worker of ``live`` holding the most unacknowledged tickets and that
    count."""
    end = time.monotonic() + settle
    while time.monotonic() < end:
        router.poll()
        time.sleep(0.002)
    held = {w: sum(1 for t in tickets if not t.resolved() and t.worker == w) for w in live}
    victim = max(held, key=held.get)
    if not held[victim]:
        raise AssertionError(f"fleet: no worker holds an unacknowledged ticket {held}")
    return victim, held


def _fleet_merge(out_dir: str, tag: str, shards, router_art: str, *flags) -> tuple:
    """``python -m dlaf_tpu_torch.obs.aggregate`` of the worker shards and
    the router's artifact (last: its argument position is its rank), then
    ``python -m dlaf_tpu_torch.obs.validate --require-fleet``, both in this
    process (their ``main``); (merged path, validate's exit code, its
    output)."""
    from dlaf_tpu_torch.obs import aggregate, validate

    merged = os.path.join(out_dir, f"{tag}_merged.jsonl")
    with open(os.path.join(out_dir, f"{tag}_aggregate.txt"), "w") as f, \
            contextlib.redirect_stdout(f):
        rc = aggregate.main([*shards, router_art, "-o", merged, *flags])
    if rc:
        raise AssertionError(f"fleet {tag}: aggregate exit {rc}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        vrc = validate.main([merged, "--require-fleet"])
    return merged, vrc, buf.getvalue().strip()


def fleet_phase(torch, dev, card, out_dir, stream: int = 512, drill: int = 128,
                buckets: str = FLEET_BUCKETS, batch: int = 16, device: str = "cuda",
                root: str = None) -> None:
    """The fleet serve tier on the card (item 31 of the module docstring).

    The worker processes start together (``subprocess.Popen`` of a fresh
    interpreter each, never a fork of this CUDA process):
    ``fleet_workers`` (3) behind router R1 (legs a, b, c), one behind R2
    (the one-worker stream of leg a), two behind R3, built with
    ``DLAF_FLEET_FAILOVER=0`` (leg d), each fleet with worker indices of
    its own (:func:`_fleet_layout`). The
    workers run with a 60 s queue deadline, so partial batches wait for a
    fill or a flush (the legs' unacknowledged tickets), and write their
    records to ``%r`` shards; the routers' records go to one artifact per
    leg. A thread polls the routers no leg is driving, so their heartbeats
    stay live. Warm-up sends the stream's bucket specs by (op, bucket) so
    that no worker is silent for one whole warm-up. At shutdown the routers
    drain their fleets: a drain that raises or leaves a worker routable, a
    worker that must be killed, or an exit code other than 0 (-9 for the
    two SIGKILLed workers) fails the phase."""
    import signal
    import threading

    import numpy as np

    from dlaf_tpu_torch import config, obs
    from dlaf_tpu_torch.fleet import Router
    from dlaf_tpu_torch.health.errors import WorkerLostError
    from dlaf_tpu_torch.obs import aggregate, trace_matches
    from dlaf_tpu_torch.serve import ProgramService, Queue, Request

    root = root or os.path.dirname(os.path.abspath(__file__))
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, name))
    t_phase = t_case = time.perf_counter()
    saved = {k: os.environ.get(k) for k in ("DLAF_SERVE_BUCKETS", "DLAF_FLEET_FAILOVER")}
    os.environ["DLAF_SERVE_BUCKETS"] = buckets
    _obs_env(os.path.join(out_dir, "a_router.jsonl"))
    config.initialize()
    r1, r2 = Router(port=0), Router(port=0)
    os.environ["DLAF_FLEET_FAILOVER"] = "0"
    config.initialize()
    r3 = Router(port=0)
    os.environ.pop("DLAF_FLEET_FAILOVER")
    config.initialize()
    if r3.failover or not r1.failover:
        raise AssertionError("fleet: DLAF_FLEET_FAILOVER did not reach the routers")
    ids = dict(_fleet_layout())
    wide = f"{len(ids['w'])} workers"
    layout = (("w", r1, ids["w"]), ("one", r2, ids["one"]), ("off", r3, ids["off"]))
    env = {**os.environ, "PYTHONPATH": root, "DLAF_SERVE_DEADLINE_MS": "60000",
           "DLAF_SERVE_BATCH": str(batch), "DLAF_SERVE_BUCKETS": buckets, "DLAF_ACCURACY": "0",
           "DLAF_LOG": "warning"}
    procs, started = {}, time.perf_counter()
    for tag, router, ks in layout:
        for k in ks:
            log = open(os.path.join(out_dir, f"{tag}.{k}.log"), "w")
            procs[(tag, k)] = subprocess.Popen(
                [sys.executable, "-m", "dlaf_tpu_torch.fleet.worker", "--connect",
                 f"127.0.0.1:{router.port}", "--worker", str(k), "--backend", device],
                env={**env, "DLAF_METRICS_PATH": os.path.join(out_dir, f"{tag}.r%r.jsonl")},
                stdout=log, stderr=subprocess.STDOUT, cwd=root)
            log.close()
    idle = {r1, r2, r3}
    stop = []
    expect = {key: 0 for key in procs}  # exit codes at shutdown

    def keep_alive():
        while not stop:
            for r in list(idle):
                r.poll()
            time.sleep(0.05)

    pump = threading.Thread(target=keep_alive, daemon=True)
    up_at = {}
    try:
        deadline = time.monotonic() + 180
        while len(up_at) < len(procs):
            for tag, router, _ in layout:
                router.poll()
                for k, m in router.stats()["workers"].items():
                    if m["state"] == "up" and (tag, k) not in up_at:
                        up_at[(tag, k)] = time.perf_counter() - started
            for key, p in procs.items():
                if p.poll() is not None:
                    raise AssertionError(f"fleet worker {key} exited {p.returncode} before its "
                                         f"hello (log {out_dir}/{key[0]}.{key[1]}.log)")
            if time.monotonic() > deadline:
                raise AssertionError(f"fleet: workers never said hello: {sorted(up_at)}")
            time.sleep(0.01)
        pump.start()
        print(f"[fleet] start-up: {len(procs)} worker processes ({device}, each its own "
              f"context) up in {max(up_at.values()):.2f} s; per worker "
              + ", ".join(f"{t}{k} {s:.2f} s" for (t, k), s in sorted(up_at.items()))
              + f" [{card}]", flush=True)
        t_case = _wall("fleet start-up", t_case)

        # -- warm-up: the stream's bucket programs in every worker ---------
        reqs = _stream_requests(np, Request, stream, SERVE_SEED + 20)
        specs = Queue(ProgramService(device=dev), batch=batch).warmup_specs(reqs)
        groups = {}
        for spec in specs:
            groups.setdefault((spec.op, spec.n), []).append(spec)
        warm = {}

        def warm_all(tag, router):
            for group in groups.values():
                got = router.warmup(group, timeout_s=120.0)
                for k, sec in got.items():
                    warm.setdefault((tag, k), []).append(sec)

        idle.clear()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=warm_all, args=(tag, router))
                   for tag, router, _ in layout]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        warm_wall = time.perf_counter() - t0
        idle.update({r2, r3})
        short = [key for key in procs if len(warm.get(key, [])) != len(groups)]
        if short:
            raise AssertionError(f"fleet: warm-up unacknowledged by {short}")
        print(f"[fleet] warm-up: {len(specs)} bucket programs in {len(groups)} messages to each "
              f"worker, {warm_wall:.2f} s for all; first warm calls per worker "
              + ", ".join(f"{t}{k} {sum(v):.2f} s (longest message {max(v):.2f} s)"
                          for (t, k), v in sorted(warm.items())) + f" [{card}]", flush=True)
        t_case = _wall("fleet warm-up", t_case)

        # -- (a) the clean stream: R1's workers, then one ------------------
        idle.discard(r1)
        res = {}
        for label, router in ((wide, r1), ("1 worker", r2)):
            idle.discard(router)
            tickets, wall, lat, busy = _fleet_stream(np, router, reqs)
            idle.add(router)
            worst = _fleet_check(np, tickets, f"clean stream {label}")
            per = {}
            for t in tickets:
                per[t.worker] = per.get(t.worker, 0) + 1
            st = router.stats()
            res[label] = stream / wall
            print(f"[fleet] (a) clean stream, {label}: {stream} f64 requests (n 17-256: "
                  f"{sum(r.op == 'cholesky' for r in reqs)} cholesky, "
                  f"{sum(r.op == 'solve' for r in reqs)} solve, "
                  f"{sum(r.op == 'eigh' for r in reqs)} eigh) in {wall:.4f} s: "
                  f"{stream / wall:.1f} requests/s, latency at the router p50 "
                  f"{np.percentile(lat, 50) * 1e3:.3f} ms p99 {np.percentile(lat, 99) * 1e3:.3f} "
                  f"ms; tickets per worker {dict(sorted(per.items()))}; router thread busy "
                  f"{busy:.3f} s ({100 * busy / wall:.1f}% of the wall); worst residual/budget "
                  f"{worst} [{card}]", flush=True)
            if st["redispatches"] or st["lost"]:
                raise AssertionError(f"fleet clean stream {label}: {st}")
        print(f"[fleet] (a) 1 worker against {wide}: {res['1 worker']:.1f} against "
              f"{res[wide]:.1f} requests/s, {wide}/1 worker "
              f"{res[wide] / res['1 worker']:.2f}x (a finding, not a gate) [{card}]",
              flush=True)
        obs.flush()
        clean = [r for r in obs.read_records(os.path.join(out_dir, "a_router.jsonl"))
                 if r.get("type") == "fleet"]
        bad = [r["event"] for r in clean
               if r["event"] in ("heartbeat_timeout", "redispatch", "ticket_lost")]
        if bad:
            raise AssertionError(f"fleet clean leg: {bad}")
        t_case = _wall("fleet (a) clean streams", t_case)

        shards = [os.path.join(out_dir, f"w.r{k}.jsonl") for k in ids["w"]]
        live = list(ids["w"])

        def leg(tag, router, sig, seed, count, live):
            """Submit ``count`` requests, stop the worker of ``live`` with
            the most unacknowledged tickets by ``sig``, flush, resolve."""
            _obs_env(os.path.join(out_dir, f"{tag}_router.jsonl"))
            config.initialize()
            idle.discard(router)
            before = router.stats()
            tickets = [router.submit(r) for r in
                       _stream_requests(np, Request, count, SERVE_SEED + seed)]
            victim, held = _fleet_victim(router, tickets, live)
            key = ("off" if router is r3 else "w", victim)
            proc = procs[key]
            expect[key] = -signal.SIGKILL if sig == signal.SIGKILL else 0
            t_stop = time.perf_counter()
            proc.send_signal(sig)
            _fleet_wait(router, lambda: router.stats()["workers"][victim]["state"] == "dead",
                        f"worker {victim} never read dead")
            router.flush()
            seen, _ = _fleet_resolve(router, tickets)
            idle.add(router)
            rc = proc.wait(timeout=60)
            after = router.stats()
            delta = {k: after[k] - before[k] for k in ("redispatches", "handbacks", "lost")}
            return tickets, victim, held, t_stop, seen, rc, delta

        # -- (b) SIGKILL: failover ----------------------------------------
        tickets, victim, held, t_kill, seen, rc, delta = leg("b", r1, signal.SIGKILL, 21, drill, live)
        worst = _fleet_check(np, tickets, "SIGKILL leg")
        moved = [t for t in tickets if t.redispatched]
        recovery = max(seen[t.seq] for t in moved) - t_kill if moved else float("nan")
        if not (delta["redispatches"] >= 1 and delta["lost"] == 0 and rc == -signal.SIGKILL):
            raise AssertionError(f"fleet SIGKILL leg: {delta}, worker exit {rc}")
        live.remove(victim)
        merged, vrc, vout = _fleet_merge(out_dir, "b", shards, os.path.join(out_dir,
                                                                            "b_router.jsonl"))
        print(f"[fleet] (b) SIGKILL: {drill} requests, unacknowledged per worker {held}, "
              f"worker {victim} killed (exit {rc}): {delta['redispatches']} redispatched, "
              f"{delta['lost']} lost, all {len(tickets)} correct (worst residual/budget "
              f"{worst}); recovery {recovery:.4f} s from the kill to the last redispatched "
              f"answer; merged artifact --require-fleet: exit {vrc} ({vout}) [{card}]",
              flush=True)
        if vrc:
            raise AssertionError(f"fleet SIGKILL leg: --require-fleet rejected {merged}")

        # -- (e) one trace across the processes ---------------------------
        pick = moved[0]
        recs = [r for r in aggregate.merge_artifacts([*shards, os.path.join(
            out_dir, "b_router.jsonl")]) if trace_matches(r, pick.trace_id)]
        kinds = {(r.get("type"), r.get("event"), r.get("rank")) for r in recs}
        router_rank = len(shards)
        want = {("fleet", "route", router_rank), ("fleet", "redispatch", router_rank),
                ("serve", "request", pick.worker)}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            trc = aggregate.main([merged, "--trace", pick.trace_id])
        for line in buf.getvalue().splitlines():
            print(f"[fleet] (e) {line}", flush=True)
        print(f"[fleet] (e) trace {pick.trace_id} (ticket {pick.seq}, worker {victim} -> "
              f"{pick.worker}): {len(recs)} records across the router and the workers, "
              f"aggregate --trace exit {trc}; route, redispatch and the survivor's serve "
              f"request {'joined' if want <= kinds else 'MISSING'}", flush=True)
        if trc or not want <= kinds:
            raise AssertionError(f"fleet trace join: {sorted(map(str, kinds))}")
        t_case = _wall("fleet (b) SIGKILL and (e) trace", t_case)

        # -- (c) SIGTERM: the graceful twin --------------------------------
        tickets, victim, held, t_term, seen, rc, delta = leg("c", r1, signal.SIGTERM, 22, drill, live)
        worst = _fleet_check(np, tickets, "SIGTERM leg")
        live.remove(victim)
        merged, vrc, vout = _fleet_merge(out_dir, "c", shards, os.path.join(out_dir,
                                                                            "c_router.jsonl"))
        print(f"[fleet] (c) SIGTERM: {drill} requests, unacknowledged per worker {held}, "
              f"worker {victim} drained (exit {rc}): {delta['handbacks']} handed back, "
              f"{delta['redispatches']} redispatched, {delta['lost']} lost, all "
              f"{len(tickets)} correct (worst residual/budget {worst}) in "
              f"{max(seen.values()) - t_term:.4f} s from the signal; merged artifact "
              f"--require-fleet: exit {vrc} ({vout}) [{card}]", flush=True)
        if not (delta["handbacks"] >= 1 and delta["redispatches"] == 0 and delta["lost"] == 0
                and rc == 0 and vrc == 0):
            raise AssertionError(f"fleet SIGTERM leg: {delta}, exit {rc}, validate {vrc}")
        t_case = _wall("fleet (c) SIGTERM", t_case)

        # -- (d) failover off: the must-trip leg ---------------------------
        tickets, victim, held, _, seen, rc, delta = leg("d", r3, signal.SIGKILL, 23, drill // 2,
                                                       list(ids["off"]))
        lost = [t for t in tickets if t.error is not None]
        raised = 0
        for t in lost:
            try:
                t.result()
            except RuntimeError as e:
                raised += isinstance(e.__cause__, WorkerLostError)
        _fleet_check(np, [t for t in tickets if t.error is None], "failover-off leg")
        merged, vrc, vout = _fleet_merge(
            out_dir, "d", [os.path.join(out_dir, f"off.r{k}.jsonl") for k in ids["off"]],
            os.path.join(out_dir, "d_router.jsonl"))
        print(f"[fleet] (d) failover off: {drill // 2} requests, worker {victim} killed holding "
              f"{held[victim]}: {delta['lost']} lost, {raised} raise WorkerLostError, "
              f"{delta['redispatches']} redispatched; --require-fleet on the merged artifact: "
              f"exit {vrc} (must reject): {vout.splitlines()[0] if vout else ''}", flush=True)
        if not (delta["lost"] >= 1 and raised == len(lost) == delta["lost"]
                and delta["redispatches"] == 0 and vrc == 1 and "ticket_lost" in vout):
            raise AssertionError(f"fleet failover-off leg: {delta}, raised {raised}, "
                                 f"validate {vrc}")
        t_case = _wall("fleet (d) failover off", t_case)
    finally:
        stop.append(True)
        if pump.is_alive():
            pump.join(timeout=5)
        # the shutdown's faults fail the phase below, once the legs passed
        # (a leg's own exception is the one to see otherwise)
        faults = []
        for router in (r1, r2, r3):
            try:
                router.drain_fleet(timeout_s=20)
            except Exception as e:
                faults.append(f"drain_fleet raised {e!r}")
            if router.membership.routable():
                faults.append(f"workers {router.membership.routable()} routable after the drain")
        exits = {}
        for key, p in procs.items():
            try:
                exits[key] = p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                exits[key] = p.wait()
                faults.append(f"worker {key} killed 30 s after the drain")
        for router in (r1, r2, r3):
            router.close()
        _obs_env(None)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        config.initialize()
    print(f"[fleet] shutdown: worker exits {dict(sorted(exits.items()))}", flush=True)
    faults += [f"worker {key} exited {rc}, not {expect[key]}"
               for key, rc in sorted(exits.items()) if rc != expect[key]]
    if faults:
        raise AssertionError(f"fleet shutdown: {faults}")
    _wall("fleet shutdown", t_case)
    print(f"[fleet] phase {time.perf_counter() - t_phase:.1f} s (budget 60 s)", flush=True)


# ---------------------------------------------------------------------------
# The obs phase: the telemetry core on the card
# ---------------------------------------------------------------------------

#: main-L: the f32 local Cholesky through the fused step kernels.
OBS_MAIN_L = ("--type", "s", "--uplo", "L", "--dlaf:step-impl=fused",
              "--dlaf:cholesky-lookahead=1")

#: The entry spans the eigensolver's artifact must hold.
OBS_EVP_SPANS = ("eigensolver", "reduction_to_band", "tridiag_solver", "bt_band_to_tridiag",
                 "bt_reduction_to_band")


def _obs_env(path=None, **extra):
    """``os.environ`` with ``DLAF_METRICS_PATH`` set to ``path`` (or
    removed), for the next ``config.initialize()``."""
    os.environ.pop("DLAF_METRICS_PATH", None)
    if path is not None:
        os.environ["DLAF_METRICS_PATH"] = path
    for k, v in extra.items():
        os.environ[k] = v


def _obs_validate(root: str, path: str, *flags) -> str:
    """``python -m dlaf_tpu_torch.obs.validate path flags``: fails unless
    it exits 0; returns its VALID line."""
    out = subprocess.run([sys.executable, "-m", "dlaf_tpu_torch.obs.validate", path, *flags],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": root})
    if out.returncode:
        raise AssertionError(f"obs.validate {path} {flags}: exit {out.returncode}\n"
                             f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
    return out.stdout.strip()


def _run_spans(records, name: str) -> list:
    return [r for r in records if r.get("type") == "span" and r.get("name") == name
            and not r["attrs"].get("warmup")]


def _last_metrics(records) -> dict:
    snaps = [r for r in records if r.get("type") == "metrics"]
    return {(m["name"], tuple(sorted(m["labels"].items()))): m.get("value")
            for m in (snaps[-1]["metrics"] if snaps else [])}


def _scrape(port: int, route: str) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=30) as resp:
        return resp.read().decode()


def _scraped_counters(text: str) -> dict:
    out = {}
    for ln in text.splitlines():
        if ln.startswith("#") or " " not in ln:
            continue
        name, val = ln.rsplit(" ", 1)
        if "_total" in name or "_count" in name:
            out[name] = float(val)
    return out


def obs_phase(torch, card, kmods, launches, out_dir, n: int = 16384, nb: int = 256,
              dist_n: int = 2048, evp_n: int = 4096, stream: int = 256,
              device: str = "cuda", mp_args=("-m", "4096", "-b", "256"), app_args=()) -> None:
    """The telemetry core on the card (module docstring, the obs phase);
    fails on any disagreement. Artifacts go under ``out_dir``. The sizes,
    ``device`` and ``app_args`` let a CPU rehearsal run it small."""
    import re
    import socket

    import numpy as np

    from dlaf_tpu_torch import config, obs
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import GlobalElementSize, TileElementSize
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp import miniapp_cholesky
    from dlaf_tpu_torch.miniapp.generators import hpd_element_fn
    from dlaf_tpu_torch.obs import devtrace
    from dlaf_tpu_torch.serve import ProgramService, Queue, Request

    root = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    dev = torch.device(device)
    main_args = ["-m", str(n), "-b", str(nb), *OBS_MAIN_L, *app_args]
    nt = -(-n // nb)

    # -- main-L with the knobs off and with metrics_path on, in-process ----
    def main_l(path):
        _obs_env(path)
        for m in kmods:
            m.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = miniapp_cholesky.run([*main_args, "--nruns", "3", "--nwarmups", "1",
                                        "--check-result", "last"])
        counts = {k: v for m in kmods for k, v in m.LAUNCHES.items()}
        _obs_env(None)
        config.initialize()
        if "check: PASSED" not in buf.getvalue():
            raise AssertionError(f"obs main-L: no 'check: PASSED' line\n{buf.getvalue()}")
        for k, v in counts.items():
            launches[k] += v
        return res, counts

    off, c_off = main_l(None)
    art = os.path.join(out_dir, "mainL.jsonl")
    on, c_on = main_l(art)
    want = {k: 0 for k in c_off}
    if dev.type == "cuda":      # one warm-up and three timed factorizations
        want.update(step=4 * (nt - 1), potrf=4)
    if not (c_off == c_on == want):
        raise AssertionError(f"obs main-L: launches off {c_off}, on {c_on}, expected {want}")
    records = obs.read_records(art)
    errs = obs.validate_records(records, require_spans=True, require_gflops=True)
    spans = _run_spans(records, "miniapp_cholesky.run")
    if errs or len(spans) != 3:
        raise AssertionError(f"obs main-L artifact: {errs}, {len(spans)} timed run spans")
    worst = max(abs(sp["gflops"] / r["gflops"] - 1.0) for sp, r in zip(spans, on))
    print(f"[obs] main-L N={n} nb={nb} f32 walls over 3 calls: records off "
          f"{[round(r['time_s'], 6) for r in off]} s, metrics_path on "
          f"{[round(r['time_s'], 6) for r in on]} s; launches {c_on} equal in both states; "
          f"span GFlop/s within {worst * 100:.3f}% of the printed ones; artifact "
          f"{os.path.getsize(art)} bytes, {len(records)} records [{card}]", flush=True)
    if worst > 0.02:
        raise AssertionError(f"obs main-L: span GFlop/s {worst * 100:.2f}% off the printed")

    # the factor bitwise with the records off and on
    def factor(path):
        _obs_env(path)
        config.initialize(argv=list(OBS_MAIN_L[4:]))
        ref = Matrix.from_element_fn(hpd_element_fn(n, np.float32), GlobalElementSize(n, n),
                                     TileElementSize(nb, nb), None, dtype=np.float32,
                                     device=dev)
        out = cholesky("L", ref, donate=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        _obs_env(None)
        config.initialize()
        return [s for s in out.storage if s is not None]

    f_off, f_on = factor(None), factor(os.path.join(out_dir, "factor.jsonl"))
    same = all(torch.equal(x, y) for x, y in zip(f_off, f_on))
    print(f"[obs] main-L factor with records off and on: {'bitwise equal' if same else 'DIFFER'}",
          flush=True)
    if not same:
        raise AssertionError("obs main-L: the factor differs with the records on")
    del f_off, f_on

    # through the CLI: its artifact passes the validator's CLI, and each
    # span's GFlop/s is the printed one's
    cli = os.path.join(out_dir, "mainL_cli.jsonl")
    out = _run_group([sys.executable, "-m", "dlaf_tpu_torch.miniapp.miniapp_cholesky",
                      *main_args, "--nruns", "3", "--nwarmups", "1", "--check-result", "last"],
                     600, {**os.environ, "PYTHONPATH": root, "DLAF_METRICS_PATH": cli})
    printed = [float(g) for g in re.findall(r"^\[\d+\] [0-9.]+s ([0-9.]+)GFlop/s", out, re.M)]
    line = _obs_validate(root, cli, "--require-spans", "--require-gflops")
    spans = _run_spans(obs.read_records(cli), "miniapp_cholesky.run")
    # 2% of the printed value, or half a unit of its last printed digit
    off = [abs(sp["gflops"] - g) - max(0.02 * g, 0.005) for sp, g in zip(spans, printed)]
    print(f"[obs] main-L CLI: {line}; GFlop/s printed {printed}, spans "
          f"{[round(sp['gflops'], 2) for sp in spans]}", flush=True)
    if "check: PASSED" not in out or len(spans) != len(printed) or max(off) > 0:
        raise AssertionError("obs main-L CLI: the spans' GFlop/s disagree with the printed")

    # -- the profiler's names: one dist-L call on 2x2 -----------------------
    tdir = os.path.join(out_dir, "trace")
    config.initialize(argv=["--dlaf:step-impl=fused", f"--dlaf:trace-dir={tdir}"])
    grid = shared_grid(2, 2, dev)
    a = Matrix.from_element_fn(hpd_element_fn(dist_n, np.float32),
                               GlobalElementSize(dist_n, dist_n), TileElementSize(nb, nb),
                               grid, dtype=np.float32)
    kmods[2].reset_launches()
    cholesky("L", a, donate=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    n_update = kmods[2].LAUNCHES["masked_trailing_update"]
    path = obs.stop_profiler()
    config.initialize()
    del a
    events = json.load(open(path))["traceEvents"]
    cpu = [e for e in events if e.get("cat") == "user_annotation"]
    names = {}
    for e in cpu:
        names[e["name"]] = names.get(e["name"], 0) + 1
    dnt = -(-dist_n // nb)
    missing = [f"cholesky.step{k:03d}.{ph}" for k in range(dnt) for ph in ("panel", "strip", "bulk")
               if names.get(f"cholesky.step{k:03d}.{ph}") != 1]
    # the device timeline's mirrors, and the launch join of obs.devtrace
    ops, windows, _ = devtrace.join_ops(events, [])
    kern = [o for o in ops if "masked_update" in o["name"]]
    gpu_bulk = [e for e in events if e.get("cat") == "gpu_user_annotation"
                and e.get("name", "").endswith(".bulk")]
    by_ann = sum(any(s["ts"] <= o["lo"] and o["hi"] <= s["ts"] + s["dur"] for s in gpu_bulk)
                 for o in kern)
    by_corr = sum(o["phase_w"] is not None and windows[o["phase_w"]][2].endswith(".bulk")
                  for o in kern)
    print(f"[obs] dist-L N={dist_n} nb={nb} 2x2 profiler trace {os.path.basename(path)} "
          f"({os.path.getsize(path)} bytes): {len(cpu)} named ranges, "
          f"cholesky.stepNNN.panel|strip|bulk once per step for {dnt} steps"
          f"{' (missing ' + str(missing[:6]) + ')' if missing else ''}; #5 kernel: "
          f"{n_update} wrapper launches, {len(kern)} kernel events, {by_ann} inside a "
          f".bulk range on the device timeline, {by_corr} launched inside a .bulk range "
          f"[{card}]", flush=True)
    if missing or names.get("cholesky") != 1:
        raise AssertionError(f"obs profiler: step names missing {missing[:6]}")
    if dev.type == "cuda" and (not kern or len(kern) != n_update
                               or max(by_ann, by_corr) != len(kern)):
        raise AssertionError("obs profiler: the #5 kernel events do not match the wrapper's "
                             "launches, or are not inside the .bulk ranges")

    # -- the eigensolver: a case that deflates ------------------------------
    evp = os.path.join(out_dir, "evp.jsonl")
    _obs_env(evp)
    _, counts, _ = _mp_case("eigensolver", "d", (), shared_grid(2, 2, dev), n=evp_n, nb=nb)
    obs.flush()
    _obs_env(None)
    config.initialize()
    for k, v in counts.items():
        launches[k] += v
    records = obs.read_records(evp)
    entry = {r["name"] for r in records if r.get("type") == "span" and r.get("fenced") is False}
    merges = _last_metrics(records).get(("dlaf_dc_merges_total", (("mode", "serialized"),)), 0)
    print(f"[obs] evp-d N={evp_n} 2x2 Toeplitz (2, 1): entry spans {sorted(entry)}, "
          f"dlaf_dc_merges_total {merges}, Givens undo launches {counts.get('givens_undo')}; "
          f"{_obs_validate(root, evp, '--require-spans', '--require-collectives')}; artifact "
          f"{os.path.getsize(evp)} bytes", flush=True)
    if not (set(OBS_EVP_SPANS) <= entry and merges > 0
            and (counts.get("givens_undo", 0) > 0 or dev.type != "cuda")):
        raise AssertionError("obs evp: entry spans, merge counter or Givens undo missing")

    # -- serving: the stream with the records off, on, on, off ------------
    reqs = _stream_requests(np, Request, stream, SERVE_SEED)
    half = stream // 2

    def serve_pass(port=None):
        """One warmed stream in two halves, the exporter (if on) scraped
        between and after them outside the timed window; returns (wall,
        tickets, queue, scrapes, seconds of the mid-stream scrape)."""
        q = Queue(ProgramService(device=dev), batch=16, buckets=(32, 64, 128, 256))
        q.warmup(reqs)
        run = q.service.run
        failed = []

        def flaky(spec, *args):
            # one injected transient failure: the dispatch policy retries it
            if not failed:
                failed.append(spec.site)
                raise RuntimeError("injected transient dispatch failure")
            return run(spec, *args)

        q.service.run = flaky
        scrapes, scrape_s = [], 0.0
        t0 = time.perf_counter()
        tickets = [q.submit(r) for r in reqs[:half]]
        q.flush()
        wall = time.perf_counter() - t0
        if port:
            t0 = time.perf_counter()
            scrapes.append(_scrape(port, "/metrics"))
            scrape_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tickets += [q.submit(r) for r in reqs[half:]]
        q.flush()
        wall += time.perf_counter() - t0
        if port:
            scrapes += [_scrape(port, "/metrics"), _scrape(port, "/healthz")]
        if len(failed) != 1 or not all(_residual_ok(np, t)[0] for t in tickets):
            raise AssertionError("obs serve: a residual missed its budget, or no retry")
        return wall, tickets, q, scrapes, scrape_s

    walls = {"off1": serve_pass()[0]}
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    serve_art = os.path.join(out_dir, "serve.jsonl")
    # the per-request accuracy records that --require-serve asks for
    acc = os.environ.get("DLAF_ACCURACY", "0")
    _obs_env(serve_art, DLAF_METRICS_PORT=str(port),
             DLAF_ACCURACY="1" if acc == "0" else acc)
    config.initialize()
    metrics_scrapes, stats_ok, scrape_walls = [], True, []
    for tag in ("on1", "on2"):
        walls[tag], tickets, q, (scrape1, scrape2, healthz), scrape_s = serve_pass(port)
        metrics_scrapes += [scrape1, scrape2]
        scrape_walls.append(scrape_s)
        stats_ok = stats_ok and json.loads(json.dumps(q.stats())) in json.loads(healthz)["queues"]
    obs.flush()
    _obs_env(None, DLAF_ACCURACY=acc)
    os.environ.pop("DLAF_METRICS_PORT", None)
    config.initialize()
    walls["off2"] = serve_pass()[0]
    counters = [_scraped_counters(t) for t in metrics_scrapes]
    shrank = [k for c1, c2 in zip(counters, counters[1:]) for k, v in c1.items()
              if c2.get(k, -1.0) < v]
    line = _obs_validate(root, serve_art, "--require-serve", "--require-resilience")
    lat = np.array([t.total_s for t in tickets])
    print(f"[obs] serve: {stream} f64 requests a pass, one injected dispatch failure retried "
          f"each pass, walls without the scrapes (records off, on with /metrics on 127.0.0.1, "
          f"on, off): " + ", ".join(f"{k} {v:.4f} s ({stream / v:.1f} requests/s)"
                                     for k, v in walls.items())
          + f"; last on pass p50 {np.percentile(lat, 50) * 1e3:.3f} ms p99 "
          f"{np.percentile(lat, 99) * 1e3:.3f} ms; mid-stream /metrics scrapes "
          f"{', '.join(f'{t * 1e3:.3f}' for t in scrape_walls)} ms, "
          f"{', '.join(str(len(t)) for t in metrics_scrapes)} bytes, {len(counters[-1])} "
          f"counter series, none decreased: {not shrank}; /healthz queue stats match: "
          f"{stats_ok}; {line}; artifact {os.path.getsize(serve_art)} bytes [{card}]",
          flush=True)
    if shrank or not stats_ok:
        raise AssertionError(f"obs serve: counters shrank {shrank[:4]}, stats match {stats_ok}")

    # -- four processes: one artifact per rank -------------------------------
    tmpl = os.path.join(out_dir, "run.%r.jsonl")
    env = {**os.environ, "PYTHONPATH": root, "GLOO_SOCKET_IFNAME": "lo",
           "DLAF_METRICS_PATH": tmpl}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", "-m", "dlaf_tpu_torch.miniapp.miniapp_cholesky", *mp_args, "--type", "s",
           "--grid-rows", "2", "--grid-cols", "2", "--share-device", "--nruns", "1",
           "--check-result", "last", *app_args]
    out = _run_group(cmd, 600, env)
    if out.count("check: PASSED") != 1:
        raise AssertionError("obs torchrun: no 'check: PASSED' line")
    sizes = []
    for r in range(4):
        path = tmpl.replace("%r", str(r))
        line = _obs_validate(root, path, "--require-spans", "--require-collectives")
        ranks = {rec.get("rank") for rec in obs.read_records(path)}
        if ranks != {r}:
            raise AssertionError(f"obs torchrun: {path} carries ranks {ranks}")
        sizes.append(os.path.getsize(path))
    extra = sorted(f for f in os.listdir(out_dir) if f.startswith("run.")
                   and f not in {f"run.{r}.jsonl" for r in range(4)})
    print(f"[obs] torchrun 4 processes dist-L {' '.join(mp_args)} 2x2: run.%r.jsonl gave one "
          f"valid artifact per rank with its own rank and collective counters, {sizes} bytes"
          f"{'; other files ' + str(extra) if extra else ''} [{card}]", flush=True)
    if extra:
        raise AssertionError(f"obs torchrun: files other than one per rank: {extra}")


#: The eigensolver's five stage boundaries, in pipeline order.
RESUME_STAGES = ("red2band", "b2t", "tridiag", "bt_b2t", "bt_r2b")


def _wall(label: str, t0: float) -> float:
    """Print ``[wall] label <s>`` since ``t0``; returns the time now."""
    now = time.perf_counter()
    print(f"[wall] {label} {now - t0:.1f} s", flush=True)
    return now


def accuracy_phase(torch, card, kmods, launches, out_dir, n: int = 16384, nb: int = 256,
                   stream: int = 256, device: str = "cuda", app_args=()) -> None:
    """The accuracy probes (``obs/accuracy.py``) on the card: main-L
    (float32, one rank) and dist-L (2x2 on the card) factored once, each
    probe's time (CUDA events around the call: the ``"1"`` Hutchinson
    estimate and the exact ``"full"`` residual) and the estimate beside the
    exact value, both within ``60 n eps`` (at float32's rounding level the
    probe's own rounding is of the residual's size, so their ratio is
    printed, not bounded); then the Cholesky miniapp under
    ``DLAF_ACCURACY=1`` and ``full``, its artifacts through ``python -m
    dlaf_tpu_torch.obs.validate --require-accuracy``; a ``stream``-request
    serve stream with ``DLAF_ACCURACY=1`` through ``--require-serve``.
    Artifacts go under ``out_dir``; ``device`` and ``app_args`` let a CPU
    rehearsal run it small."""
    import numpy as np

    from dlaf_tpu_torch import config, obs
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import GlobalElementSize, TileElementSize
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp import miniapp_cholesky
    from dlaf_tpu_torch.miniapp.generators import hpd_element_fn
    from dlaf_tpu_torch.obs import accuracy
    from dlaf_tpu_torch.serve import ProgramService, Queue, Request

    root = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    dev = torch.device(device)
    saved = os.environ.get("DLAF_ACCURACY")
    tol = 60 * n * float(np.finfo(np.float32).eps)
    cuda = dev.type == "cuda"

    def timed(fn, reps):
        if not cuda:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        return time_ms(torch, fn, reps=reps, warm=1)

    # -- the probes on main-L's and dist-L's factors -------------------------
    config.initialize(argv=["--dlaf:step-impl=fused", "--dlaf:cholesky-lookahead=1"])
    for label, grid in (("main-L", None), ("dist-L 2x2", shared_grid(2, 2, dev))):
        t_case = time.perf_counter()
        ref = Matrix.from_element_fn(hpd_element_fn(n, np.float32), GlobalElementSize(n, n),
                                     TileElementSize(nb, nb), grid, dtype=np.float32,
                                     device=dev)
        for m in kmods:
            m.reset_launches()
        out = cholesky("L", ref.clone(), donate=True)
        for m in kmods:
            for k, v in m.LAUNCHES.items():
                launches[k] += v
        exact = accuracy.cholesky_residual("L", ref, out, "full")
        est = accuracy.cholesky_residual("L", ref, out, "1")
        ms1 = timed(lambda: accuracy.cholesky_residual("L", ref, out, "1"), 10)
        msf = timed(lambda: accuracy.cholesky_residual("L", ref, out, "full"), 3)
        good = exact < tol and est < tol
        print(f"[accuracy] {label} N={n} nb={nb} f32: probe '1' {est:.3e} in {ms1:.3f} ms, "
              f"exact 'full' {exact:.3e} in {msf:.3f} ms (CUDA events around the call), "
              f"estimate/exact {est / exact:.3f}, tol {tol:.3e} [{card}]", flush=True)
        del ref, out
        _wall(f"accuracy probes {label}", t_case)
        if not good:
            raise AssertionError(f"accuracy {label}: the estimates miss their bounds")

    # -- the miniapp's records under DLAF_ACCURACY=1 and full ----------------
    lines = []
    for label, grid_args in (("main-L", []),
                             ("dist-L", ["--grid-rows", "2", "--grid-cols", "2",
                                         "--share-device"])):
        for mode in ("1", "full"):
            t_case = time.perf_counter()
            path = os.path.join(out_dir, f"{label}.{mode}.jsonl")
            _obs_env(path, DLAF_ACCURACY=mode)
            buf = io.StringIO()
            for m in kmods:
                m.reset_launches()
            with contextlib.redirect_stdout(buf):
                miniapp_cholesky.run(["-m", str(n), "-b", str(nb), *OBS_MAIN_L, *grid_args,
                                      "--nruns", "2", "--nwarmups", "1", "--check-result",
                                      "last", *app_args])
            obs.flush()
            for m in kmods:
                for k, v in m.LAUNCHES.items():
                    launches[k] += v
            got = [r for r in obs.read_records(path) if r.get("type") == "accuracy"]
            line = _obs_validate(root, path, "--require-accuracy")
            check = [ln for ln in buf.getvalue().splitlines() if ln.startswith("check:")]
            values = ", ".join(f"{r['value']:.3e}" for r in got)
            lines.append(f"{label} DLAF_ACCURACY={mode}: {len(got)} records ({values}), "
                         f"{check[0] if check else 'no check line'}; {line}")
            _wall(f"accuracy miniapp {label} DLAF_ACCURACY={mode}", t_case)
            if len(got) != 2 or not check or "PASSED" not in check[0]:
                raise AssertionError(f"accuracy miniapp {label} {mode}: {len(got)} records, "
                                     f"{check}")
    for ln in lines:
        print(f"[accuracy] {ln} [{card}]", flush=True)

    # -- the serve stream's per-request records ------------------------------
    t_case = time.perf_counter()
    path = os.path.join(out_dir, "serve.jsonl")
    _obs_env(None)
    config.initialize()
    reqs = _stream_requests(np, Request, stream, SERVE_SEED + 5)
    q = Queue(ProgramService(device=dev), batch=16, buckets=(32, 64, 128, 256))
    q.warmup(reqs)
    _obs_env(path, DLAF_ACCURACY="1")
    config.initialize()
    tickets = [q.submit(r) for r in reqs]
    q.flush()
    obs.flush()
    recs = [r for r in obs.read_records(path) if r.get("type") == "accuracy"]
    line = _obs_validate(root, path, "--require-serve")
    worst = max(r["bound_ratio"] for r in recs)
    print(f"[accuracy] serve {stream} f64 requests with DLAF_ACCURACY=1: {len(recs)} per-request "
          f"accuracy records, worst bound_ratio {worst:.3e}, every ticket within its budget: "
          f"{all(_residual_ok(np, t)[0] for t in tickets)}; {line} [{card}]", flush=True)
    _obs_env(None)
    if saved is None:
        os.environ.pop("DLAF_ACCURACY", None)
    else:
        os.environ["DLAF_ACCURACY"] = saved
    config.initialize()
    _wall("accuracy serve stream", t_case)
    if len(recs) != stream or worst >= 1.0:
        raise AssertionError(f"accuracy serve: {len(recs)} records, worst ratio {worst}")


def rung_launches(rung: int, nt: int, ranks: int = 0) -> dict:
    """Kernel launches of one float32 Cholesky (default knobs on cuda:
    biggemm, lookahead 1) at a rung of the f32 ladder: rungs 0 and 1 fuse
    the step (one rank: #4 each strip-bearing step, #1 for the last
    tile; ``ranks`` on a grid: #3 per rank per step with a trailing
    update, #1 on every rank), rung 2 the panel kernels alone (#1 per
    step, #2 per strip-bearing step, on every rank), rung 3 none of them;
    on a grid the update kernel (#5) at every rung."""
    if not ranks:
        return ({"step": nt - 1, "potrf": 1}, {"step": nt - 1, "potrf": 1},
                {"potrf": nt, "solve": nt - 1}, {})[rung]
    upd = {"masked_trailing_update": ranks * (nt - 1)}
    fused = {"factor_solve": ranks * (nt - 1), "potrf": ranks, **upd}
    return (fused, fused, {"potrf": ranks * nt, "solve": ranks * (nt - 1), **upd}, upd)[rung]


def autotune_phase(torch, card, kmods, launches, out_dir, n: int = 16384, nb: int = 256,
                   f64_n: int = 16384, dist_n: int = 8192, small_n: int = 4096,
                   device: str = "cuda") -> None:
    """The route autotuner (``autotune/``) and the program telemetry
    (``obs/telemetry.py``) on the card, strict, with ``DLAF_AUTOTUNE=1``
    and ``DLAF_PROGRAM_TELEMETRY=1`` into one artifact under ``out_dir``:

    1. main-L's shape (float32, N=``n``, one rank, ``donate=False``): the
       ``DLAF_AUTOTUNE=0`` factor, then a clean call at the start rung
       (bitwise that factor), two ``inject.nan_tile`` breaches (escalate
       to rungs 2 and 3), six clean calls (relax to 2, then to 1); every
       call's launches are the rung's (:func:`rung_launches`) and every
       clean call's probe within ``60 n eps``;
    2. the f64 ladder under ``f64_gemm=mxu`` (trailing "ozaki", one rank,
       N=``f64_n``): one call per slice rung s = 5..8, its wall (the call,
       its probe included), the probe and the exact residual; #6 and #8 at
       every rung, in equal counts;
    3. dist-L (float32, N=``dist_n``, 2x2 on the card): a clean call, a
       breach (escalate) and the next call under the escalated route (#3
       and #5 at the start rung, #1/#2/#5 after);
    4. exhaustion under strict (N=``small_n``, its own artifact): a breach
       at rung 2, then one at the top raises ``AutotuneExhaustedError``;
       the flight dump passes ``--require-flight`` and the artifact is
       rejected by ``--require-autotune``;
    5. telemetry: one line per kernel site (the first call's wall and
       bytes, the site's program count), main-L walls over five calls with
       the program records off and five on (donated: no probe), the
       counts unchanged by the five; the artifact passes
       ``--require-telemetry --require-autotune``.

    ``device`` and the sizes let a CPU rehearsal run it small (where the
    kernels' launches stay 0: the rung formulas then do not apply)."""
    import numpy as np

    from dlaf_tpu_torch import autotune, config, obs
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import GlobalElementSize, TileElementSize
    from dlaf_tpu_torch.health import inject
    from dlaf_tpu_torch.health.errors import AutotuneExhaustedError
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp.generators import hpd_element_fn
    from dlaf_tpu_torch.obs import accuracy

    root = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    knobs = ("DLAF_AUTOTUNE", "DLAF_PROGRAM_TELEMETRY", "DLAF_AUTOTUNE_TABLE",
             "DLAF_FLIGHT_RECORDER", "DLAF_ACCURACY")
    saved = {k: os.environ.get(k) for k in knobs}
    path = os.path.join(out_dir, "autotune.jsonl")
    f32, f64l = autotune.LADDER_F32, autotune.LADDER_F64

    def arm(metrics, argv=(), **env):
        # the entries' probe is the Hutchinson "1" estimate (the script
        # sets DLAF_ACCURACY=full for the miniapps' checks)
        _obs_env(metrics, **{"DLAF_AUTOTUNE_TABLE": os.path.join(out_dir, "table.json"),
                             "DLAF_ACCURACY": "1", "DLAF_FLIGHT_RECORDER": "0", **env})
        config.initialize(argv=list(argv))

    def make(n_, dtype, grid=None):
        return Matrix.from_element_fn(hpd_element_fn(n_, dtype), GlobalElementSize(n_, n_),
                                      TileElementSize(nb, nb), grid, dtype=dtype, device=dev)

    def expect(want):
        return want if cuda else {}

    def steered(label, mat, want, *, poisoned=False):
        """One steered call: launches asserted; returns (factor, its
        decision records, wall s)."""
        before = len(written())
        x = inject.nan_tile(mat, tile=(1, 0), element=(2, 3)) if poisoned else mat
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = counted(kmods, launches, expect(want), lambda: cholesky("L", x), label)
        _sync(torch, dev)
        wall = time.perf_counter() - t0
        new = [r for r in written()[before:] if r.get("type") == "autotune"]
        return out, new, wall

    def written():
        return obs.read_records(path) if os.path.exists(path) else []

    def trail(recs):
        return " ".join(f"{r['reason']}:{r['rung_old']}->{r['rung_new']}" for r in recs)

    # -- 1. main-L's shape, the f32 ladder ------------------------------------
    t_case = time.perf_counter()
    arm(None, DLAF_AUTOTUNE="0", DLAF_PROGRAM_TELEMETRY="0")
    ref = make(n, np.float32)
    nt = -(-n // nb)
    plain = counted(kmods, launches, expect(rung_launches(1, nt)),
                    lambda: cholesky("L", ref), "autotune main-L DLAF_AUTOTUNE=0")
    arm(path, DLAF_AUTOTUNE="1", DLAF_PROGRAM_TELEMETRY="1")
    key = autotune.site_key("cholesky", n=n, nb=nb, dtype=torch.float32, platform=dev.type)
    steps = [("start", False, 1, "hold", 1), ("breach", True, 1, "escalate", 2),
             ("breach", True, 2, "escalate", 3)]
    steps += [("clean", False, 3, "hold", 3)] * 2 + [("clean", False, 3, "relax", 2)]
    steps += [("clean", False, 2, "hold", 2)] * 2 + [("clean", False, 2, "relax", 1)]
    lines = []
    for i, (what, poisoned, rung, reason, after) in enumerate(steps):
        out, recs, wall = steered(f"autotune main-L call {i} ({what}, rung {rung})", ref,
                                  rung_launches(rung, nt), poisoned=poisoned)
        got = (len(recs), recs[0]["reason"] if recs else None, recs[0]["rung_old"] if recs
               else None, autotune.get_table().rung_of(key))
        if got != (1, reason, rung, after):
            raise AssertionError(f"autotune main-L call {i}: decision {got}, expected "
                                 f"(1, {reason!r}, {rung}, {after})")
        probe = recs[0]["probe"]    # the bound_ratio: the residual over 60 n eps
        if not poisoned and not (probe is not None and probe < 1.0):
            raise AssertionError(f"autotune main-L call {i}: probe ratio {probe} not within "
                                 "60 n eps")
        if i == 0 and out.to_numpy().tobytes() != plain.to_numpy().tobytes():
            raise AssertionError("autotune main-L: the start rung's factor is not bitwise "
                                 "the DLAF_AUTOTUNE=0 factor")
        lines.append(f"call {i} {what:6s} rung {rung} ({f32.rungs[rung].tag()}): "
                     f"{recs[0]['reason']} -> rung {after}, probe "
                     f"{'nonfinite' if probe is None else f'{probe:.3e} of 60 n eps'}, "
                     f"{wall:.3f} s")
        del out
    for ln in lines:
        print(f"[autotune] main-L N={n} nb={nb} f32 {ln} [{card}]", flush=True)
    print(f"[autotune] main-L: start-rung factor bitwise the DLAF_AUTOTUNE=0 factor; launches "
          f"per rung {[rung_launches(r, nt) for r in range(4)] if cuda else 'not counted'} "
          f"[{card}]", flush=True)
    del plain, ref
    _wall("autotune main-L f32 ladder", t_case)

    # -- 2. the f64 ladder under f64_gemm=mxu ----------------------------------
    t_case = time.perf_counter()
    arm(path, ["--dlaf:f64-gemm=mxu", "--dlaf:cholesky-trailing=ozaki"], DLAF_AUTOTUNE="1",
        DLAF_PROGRAM_TELEMETRY="1")
    ref = make(f64_n, np.float64)
    key64 = autotune.site_key("cholesky", n=f64_n, nb=nb, dtype=torch.float64,
                              platform=dev.type)
    tol64 = 60 * f64_n * float(np.finfo(np.float64).eps)
    # one donated call (no probe) first, so the first rung's wall is not the
    # process's first mxu call
    autotune.get_table().entry(key64, f64l).rung = 4
    for m in kmods:
        m.reset_launches()
    cholesky("L", ref.clone(), donate=True)
    for k, v in ((k, v) for m in kmods for k, v in m.LAUNCHES.items()):
        launches[k] += v
    oz_counts = []
    for rung in (1, 2, 3, 4):
        autotune.get_table().entry(key64, f64l).rung = rung
        for m in kmods:
            m.reset_launches()
        before = len(written())
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = cholesky("L", ref)
        _sync(torch, dev)
        wall = time.perf_counter() - t0
        counts = {k: v for m in kmods for k, v in m.LAUNCHES.items()}
        for k, v in counts.items():
            launches[k] += v
        recs = [r for r in written()[before:] if r.get("type") == "autotune"]
        exact = accuracy.cholesky_residual("L", ref, out, "full")
        oz = (counts["ozaki_product"], counts["ozaki_syrk"])
        oz_counts.append(oz)
        print(f"[autotune] f64 mxu ladder N={f64_n} nb={nb} rung {rung} "
              f"({f64l.rungs[rung].tag()}): wall {wall:.6f} s (the call, its probe included), "
              f"probe {recs[0]['attrs'].get('value', float('nan')):.3e}, exact residual "
              f"{exact:.3e} ({exact / tol64:.3e} of 60 n eps), decision {trail(recs)}, #6 "
              f"{oz[0]} #8 {oz[1]} [{card}]", flush=True)
        if cuda and (min(oz) == 0 or oz != oz_counts[0]):
            raise AssertionError(f"autotune f64 rung {rung}: #6/#8 launches {oz}, first rung "
                                 f"{oz_counts[0]}")
        if not math.isfinite(exact):
            raise AssertionError(f"autotune f64 rung {rung}: residual {exact}")
        del out
    del ref
    _wall("autotune f64 mxu slice rungs", t_case)

    # -- 3. dist-L 2x2 on the card -----------------------------------------------
    t_case = time.perf_counter()
    arm(path, DLAF_AUTOTUNE="1", DLAF_PROGRAM_TELEMETRY="1")
    ref = make(dist_n, np.float32, shared_grid(2, 2, dev))
    dnt = -(-dist_n // nb)
    for i, (what, poisoned, rung, reason) in enumerate(
            (("start", False, 1, "hold"), ("breach", True, 1, "escalate"),
             ("escalated", False, 2, "hold"))):
        _, recs, wall = steered(f"autotune dist-L call {i} ({what})", ref,
                                rung_launches(rung, dnt, 4), poisoned=poisoned)
        if [(r["reason"], r["rung_old"]) for r in recs] != [(reason, rung)]:
            raise AssertionError(f"autotune dist-L call {i}: {trail(recs)}, expected "
                                 f"{reason} at rung {rung}")
        print(f"[autotune] dist-L N={dist_n} nb={nb} 2x2 on one card call {i} {what}: rung "
              f"{rung} ({f32.rungs[rung].tag()}) {trail(recs)}, launches "
              f"{rung_launches(rung, dnt, 4) if cuda else 'not counted'}, {wall:.3f} s "
              f"[{card}]", flush=True)
    del ref
    _wall("autotune dist-L 2x2", t_case)

    # -- 4. exhaustion under strict --------------------------------------------
    t_case = time.perf_counter()
    bad = os.path.join(out_dir, "exhausted.jsonl")
    arm(bad, DLAF_AUTOTUNE="1", DLAF_PROGRAM_TELEMETRY="0", DLAF_FLIGHT_RECORDER="64",
        DLAF_AUTOTUNE_TABLE=os.path.join(out_dir, "exhausted.table.json"))
    small = make(small_n, np.float32)
    skey = autotune.site_key("cholesky", n=small_n, nb=nb, dtype=torch.float32,
                             platform=dev.type)
    autotune.get_table().entry(skey, f32).rung = 2
    cholesky("L", inject.nan_tile(small, tile=(1, 0), element=(2, 3)))
    try:
        cholesky("L", inject.nan_tile(small, tile=(1, 0), element=(2, 3)))
    except AutotuneExhaustedError as e:
        raised = e
    else:
        raise AssertionError("autotune: a breach at the top rung did not raise under strict")
    flight = _obs_validate(root, bad + ".flight.jsonl", "--require-flight")
    gate = subprocess.run([sys.executable, "-m", "dlaf_tpu_torch.obs.validate", bad,
                           "--require-autotune"], capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": root})
    if gate.returncode != 1 or "exhausted" not in gate.stderr:
        raise AssertionError(f"autotune: the exhausted artifact was not rejected by "
                             f"--require-autotune (exit {gate.returncode}): {gate.stderr}")
    print(f"[autotune] exhaustion N={small_n} f32 strict: {type(raised).__name__} at "
          f"{raised.site} rung {raised.rung} ({raised.ladder} ladder); {flight}; the open "
          f"artifact rejected by --require-autotune: {gate.stderr.strip().splitlines()[-1]} "
          f"[{card}]", flush=True)
    del small
    _wall("autotune exhaustion", t_case)

    # -- 5. telemetry ------------------------------------------------------------
    t_case = time.perf_counter()
    arm(path, DLAF_AUTOTUNE="1", DLAF_PROGRAM_TELEMETRY="1")
    records = written()
    first = {}
    for r in records:
        if r.get("type") == "program" and r.get("event") == "compile":
            first.setdefault(r["site"], r)
    reg = obs.registry()

    def keys(site):
        return int(reg.counter("dlaf_retrace_total", site=site).snapshot()["value"])

    for site in sorted(first):
        hbm = first[site].get("hbm", {})
        print(f"[autotune] program {site}: compile_s {first[site]['compile_s']:.6f} (the first "
              f"call of its first key, fenced), args {hbm.get('args', 0):.0f} B, output "
              f"{hbm.get('output', 0):.0f} B, peak {hbm.get('peak', float('nan')):.0f} B, "
              f"programs (dlaf_retrace_total) {keys(site)} [{card}]", flush=True)
    ref = make(n, np.float32)
    walls = {}
    for mode in ("0", "1", "0", "1"):
        arm(path, DLAF_AUTOTUNE="1", DLAF_PROGRAM_TELEMETRY=mode)
        before = {s: keys(s) for s in first}
        ts = []
        for _ in range(5):
            x = ref.clone()
            _sync(torch, dev)
            t0 = time.perf_counter()
            counted(kmods, launches, expect(rung_launches(1, nt)),
                    lambda: cholesky("L", x, donate=True), f"autotune records {mode}")
            _sync(torch, dev)
            ts.append(time.perf_counter() - t0)
        if {s: keys(s) for s in first} != before:
            raise AssertionError(f"autotune telemetry: program counts moved over five "
                                 f"repeated main-L calls: {before}")
        walls.setdefault(mode, []).extend(ts)
    print(f"[autotune] main-L N={n} nb={nb} f32 walls over 10 calls each (two rounds of five, "
          f"donated, no probe), program records off: median "
          f"{statistics.median(walls['0']):.6f} s [{min(walls['0']):.6f}, "
          f"{max(walls['0']):.6f}], on: median {statistics.median(walls['1']):.6f} s "
          f"[{min(walls['1']):.6f}, {max(walls['1']):.6f}]; program counts unchanged by "
          f"repeated calls [{card}]", flush=True)
    del ref
    obs.flush()
    line = _obs_validate(root, path, "--require-telemetry", "--require-autotune")
    print(f"[autotune] {line} [{card}]", flush=True)
    for k, v in saved.items():
        os.environ.pop(k, None)
        if v is not None:
            os.environ[k] = v
    _obs_env(None)
    config.initialize()
    _wall("autotune telemetry", t_case)


#: The hand kernels a dist-L call launches, by the name its trace gives
#: them, each with the wrappers whose launches it must equal in sum.
DIST_L_TRACE_KERNELS = (("potrf_kernel", ("potrf", "factor_solve")),
                        ("trinv_kernel", ("factor_solve",)),
                        ("strip_kernel", ("factor_solve",)),
                        ("plan_kernel", ("masked_trailing_update",)),
                        ("masked_update_kernel", ("masked_trailing_update",)))

#: The devtrace phase's budget (s): it fails above it.
DEVTRACE_BUDGET_S = 60.0


def _obs_cli(root: str, module: str, *args, timeout: float = 300) -> tuple:
    """``python -m dlaf_tpu_torch.obs.<module> args``: (exit code, stdout,
    stderr, seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", f"dlaf_tpu_torch.obs.{module}", *args],
                         capture_output=True, text=True, timeout=timeout,
                         env={**os.environ, "PYTHONPATH": root})
    return out.returncode, out.stdout, out.stderr, time.perf_counter() - t0


def _obs_cli_ok(root: str, module: str, *args) -> tuple:
    """:func:`_obs_cli` that fails unless the command exits 0."""
    rc, out, err, secs = _obs_cli(root, module, *args)
    if rc:
        raise AssertionError(f"obs.{module} {args}: exit {rc}\n{out[-2000:]}{err[-2000:]}")
    return out, secs


def devtrace_phase(torch, card, kmods, launches, out_dir, n: int = 16384, nb: int = 256,
                   trsm_n: int = 8192, main_n: int = 4096, small_n: int = 1024,
                   device: str = "cuda", budget: float = DEVTRACE_BUDGET_S) -> None:
    """Device-timeline attribution on the card (``obs/devtrace.py``,
    ``obs/critpath.py``); artifacts under ``out_dir``. dist-L (float32,
    N=``n``, 2x2 on the card, fused step, lookahead on) and config #2's
    solve (trsm-d, float64, N=``trsm_n``, LLNN, 2x2, unrolled): one warm
    call, then one under ``DLAF_METRICS_PATH`` and ``DLAF_TRACE_DIR``;
    the artifact merged by ``obs.aggregate``, the trace through the
    devtrace and critpath CLIs (critpath on dist-L: nt steps; on trsm-d:
    ``trsm_n / nb``), the enriched dist-L artifact through ``validate
    --require-devtrace --require-critpath``; each hand kernel of dist-L
    named in the report at the launches its wrappers counted, and no
    launch in its ranges lost by the trace. Drills: a
    5 ms gap injected before step nt/2 of the distilled dist-L trace comes
    back within [5 ms - the measured lookahead overlap of that boundary,
    5 ms + 1 us]; critpath on a main-L trace (the local builder names no
    step) exits 1; devtrace on a trace of CPU activity alone exits 1.
    Fails above ``budget`` seconds."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from dlaf_tpu_torch import config, obs
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.algorithms.triangular import triangular_solve
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import GlobalElementSize, TileElementSize
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp.generators import hpd_element_fn
    from dlaf_tpu_torch.obs import critpath, devtrace

    t_all = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    dev = torch.device(device)
    grid = shared_grid(2, 2, dev)
    block = TileElementSize(nb, nb)

    def at(name):
        return os.path.join(out_dir, name)

    def traced(tag, argv, make, call, expect):
        """One warm call, then one traced call with its launches counted;
        returns (trace, merged artifact, export s)."""
        config.initialize(argv=argv)
        call(make())
        _sync(torch, dev)
        _obs_env(at(f"{tag}.jsonl"), DLAF_TRACE_DIR=at(f"{tag}_trace"))
        config.initialize(argv=argv)
        mat = make()
        counted(kmods, launches, expect if dev.type == "cuda" else {},
                lambda: (call(mat), _sync(torch, dev)), f"devtrace {tag}")
        del mat
        obs.flush()
        t0 = time.perf_counter()
        path = obs.stop_profiler()
        export_s = time.perf_counter() - t0
        os.environ.pop("DLAF_TRACE_DIR")
        _obs_env(None)
        config.initialize()
        _obs_cli_ok(root, "aggregate", at(f"{tag}.jsonl"), "-o", at(f"{tag}.merged.jsonl"))
        return path, at(f"{tag}.merged.jsonl"), export_s

    def attribution(tag, trace, merged, *flags, top=0):
        """The devtrace and critpath CLIs on one trace (the latter's step
        table printed, ``top`` steps), the enriched artifact through the
        validator; returns (devtrace report, critpath report, devtrace
        stdout, seconds of the three)."""
        enriched = at(f"{tag}.enriched.jsonl")
        out, s1 = _obs_cli_ok(root, "devtrace", trace, merged, "-o", enriched, "--json",
                              at(f"{tag}.devtrace.json"), "--distill",
                              at(f"{tag}.distilled.json.gz"), "--top", "6")
        table, s2 = _obs_cli_ok(root, "critpath", trace, enriched, "-o", enriched, "--json",
                                at(f"{tag}.critpath.json"), "--top", str(top))
        for line in table.splitlines():
            if line.strip() and not line.startswith("  critical path:"):
                print(f"[devtrace] {tag} | {line}", flush=True)
        t0 = time.perf_counter()
        line = _obs_validate(root, enriched, *flags)
        s3 = time.perf_counter() - t0
        print(f"[devtrace] {tag}: {line}", flush=True)
        return (json.load(open(at(f"{tag}.devtrace.json"))),
                json.load(open(at(f"{tag}.critpath.json"))), out, s1 + s2 + s3)

    def show(tag, what, dt, cp, algo, out, export_s, clis):
        prog = cp["programs"][algo]
        head = out.splitlines()[0]
        cats = {c: round(v * 1e3, 3) for c, v in dt["categories"].items()}
        print(f"[devtrace] {what}: {head.split('(', 1)[1].rstrip(')')}, export "
              f"{export_s:.2f} s, CLIs {clis:.2f} s; device busy "
              f"{dt['device_busy_s'] * 1e3:.3f} ms over {dt['events']} ops, coverage "
              f"{dt['coverage']:.4f} (join {dt['join']}), busy ms by category {cats} "
              f"[{card}]", flush=True)
        for name, cell in sorted(dt["phases"].items(), key=lambda kv: -kv[1]["busy_s"])[:5]:
            print(f"[devtrace] {tag} phase {name}: busy {cell['busy_s'] * 1e3:.3f} ms, wall "
                  f"{cell['wall_s'] * 1e3:.3f} ms", flush=True)
        rows = sorted(dt["overlap"], key=lambda r: -r["collective_s"])
        if rows:
            r = rows[0]
            print(f"[devtrace] {tag} measured_overlap: {len(rows)} phases with collective "
                  f"time, {sum(x['collective_s'] for x in rows) * 1e3:.3f} ms in all; the "
                  f"largest {r['algo']}: {r['collective_s'] * 1e3:.3f} ms, overlap_frac "
                  f"{r['overlap_frac']:.4f}, kinds "
                  f"{ {k: round(v * 1e3, 3) for k, v in r['kinds'].items()} }", flush=True)
        wi = ", ".join(f"{w['scenario']} -{w['wall_pct']:.1f}% ({w['saved_s'] * 1e3:.3f} ms)"
                       for w in prog["whatif"])
        print(f"[devtrace] {tag} critpath {algo}: {prog['n_steps']} steps x {prog['n_runs']} "
              f"run, coverage {cp['coverage']:.4f}, wall {prog['wall_s'] * 1e3:.3f} ms, gaps "
              f"{prog['gap_total_s'] * 1e3:.3f} ms, critical path "
              f"{prog['critical_path_s'] * 1e3:.3f} ms, bound {prog['bound']}, lookahead "
              f"{int(prog['lookahead'])}; what-ifs {wi}", flush=True)
        bounds = {}
        for s in prog["steps"]:
            bounds[s.get("bound")] = bounds.get(s.get("bound"), 0) + 1
        gaps = sorted((s for s in prog["steps"] if "gap_after_s" in s),
                      key=lambda s: -s["gap_after_s"])[:5]
        print(f"[devtrace] {tag} step bounds {bounds}; largest gaps: " + "; ".join(
            f"after step {s['step']} {s['gap_after_s'] * 1e3:.3f} ms (wall "
            f"{s['wall_s'] * 1e3:.3f}, busy {s['busy_s'] * 1e3:.3f}, bound {s['bound']})"
            for s in gaps), flush=True)
        return prog

    # -- dist-L: the fused factor+solve and the predicated update ----------
    nt = -(-n // nb)
    expect = {"factor_solve": 4 * (nt - 1), "potrf": 4, "masked_trailing_update": 4 * (nt - 1)}
    trace, merged, export_s = traced(
        "distL", ["--dlaf:step-impl=fused", "--dlaf:cholesky-lookahead=1"],
        lambda: Matrix.from_element_fn(hpd_element_fn(n, np.float32), GlobalElementSize(n, n),
                                       block, grid, dtype=np.float32),
        lambda m: cholesky("L", m, donate=True), expect)
    dt, cp, out, clis = attribution("distL", trace, merged, "--require-devtrace",
                                    "--require-critpath", top=nt)
    prog = show("distL", f"dist-L N={n} nb={nb} f32 2x2 on one card", dt, cp, "cholesky", out,
                export_s, clis)
    got = {name: dt.get("kernels", {}).get(name, {}).get("launches", 0)
           for name, _ in DIST_L_TRACE_KERNELS}
    want = {name: sum(expect[w] for w in ws) if dev.type == "cuda" else 0
            for name, ws in DIST_L_TRACE_KERNELS}
    print(f"[devtrace] dist-L hand kernels in the trace {got}, the wrappers' counts give "
          f"{want}; launches without a device op {dt.get('lost_launches')}", flush=True)
    if prog["n_steps"] != nt or got != want or dt.get("lost_launches", 0):
        raise AssertionError(f"devtrace dist-L: {prog['n_steps']} steps (want {nt}), "
                             f"kernels {got} (want {want}), {dt.get('lost_launches')} lost")

    # -- drill: 5 ms before step nt/2 of the distilled trace ----------------
    k = nt // 2
    distilled = at("distL.distilled.json.gz")
    records = critpath.load_records(at("distL.enriched.jsonl"))
    joined = critpath._joined_events(devtrace.load_trace(distilled), records)[0]
    table = critpath._step_table([e for e in joined if e["algo"] == "cholesky"], nt)
    same = all(abs(a["wall_s"] - b["wall_s"]) < 1e-9 for a, b in zip(table, prog["steps"]))
    # the boundary before step k: overlapped (lookahead) or a gap already
    lead = table[k]["start_s"] - table[k - 1]["end_s"]
    overlap, gap0 = max(0.0, -lead), max(0.0, lead)
    _obs_cli_ok(root, "critpath", distilled, at("distL.enriched.jsonl"), "--inject-gap",
                f"cholesky.step{k:03d}=5", "--json", at("distL.inject.json"), "--top", "0")
    gap = json.load(open(at("distL.inject.json")))["programs"]["cholesky"]["steps"][k - 1][
        "gap_after_s"]
    # [5 ms - the overlap, 5 ms + 1 us], shifted by a gap the boundary had
    # (1 ns under the lower end for the seconds' rounding)
    lo, hi = 5e-3 - overlap + gap0 - 1e-9, 5e-3 + gap0 + 1e-6
    print(f"[devtrace] drill --inject-gap cholesky.step{k:03d}=5 on the distilled trace "
          f"({os.path.getsize(distilled)} bytes; its step walls {'equal' if same else 'DIFFER from'}"
          f" the full trace's): gap after step {k - 1} {gap * 1e3:.4f} ms, band "
          f"[{lo * 1e3:.4f}, {hi * 1e3:.4f}] ms (lookahead overlap {overlap * 1e3:.4f} ms, "
          f"gap before {gap0 * 1e3:.4f} ms)", flush=True)
    if not (same and lo <= gap <= hi):
        raise AssertionError("devtrace drill: the injected gap is not recovered")

    # -- config #2's solve: library products, its own step structure --------
    tnt = -(-trsm_n // nb)
    tsize = GlobalElementSize(trsm_n, trsm_n)
    am = Matrix.from_element_fn(
        lambda i, j: 1.0 / (1.0 + (i - j).abs()) + 2.0 * trsm_n * (i == j), tsize, block, grid,
        dtype=np.float64)
    trace_t, merged_t, export_t = traced(
        "trsmD", ["--dlaf:dist-step-mode=unrolled"],
        lambda: Matrix.from_element_fn(lambda i, j: torch.cos(0.001 * (i + 1))
                                       + torch.sin(0.002 * (j + 1)), tsize, block, grid,
                                       dtype=np.float64),
        lambda b: triangular_solve("L", "L", "N", "N", 1.0, am, b, donate_b=True), {})
    del am
    dt_t, cp_t, out_t, clis_t = attribution("trsmD", trace_t, merged_t, "--require-critpath",
                                            top=tnt)
    prog_t = show("trsmD", f"trsm-d N={trsm_n} nb={nb} f64 LLNN 2x2 unrolled on one card", dt_t,
                  cp_t, "trsm", out_t, export_t, clis_t)
    if prog_t["n_steps"] != tnt:
        raise AssertionError(f"devtrace trsm-d: {prog_t['n_steps']} steps, want {tnt}")

    # -- must-trips: no step names; no device activity -----------------------
    mnt = -(-main_n // nb)
    trace_m, merged_m, _ = traced(
        "mainL", list(OBS_MAIN_L[4:]),
        lambda: Matrix.from_element_fn(hpd_element_fn(main_n, np.float32),
                                       GlobalElementSize(main_n, main_n), block, None,
                                       dtype=np.float32, device=dev),
        lambda m: cholesky("L", m, donate=True), {"step": mnt - 1, "potrf": 1})
    rc_m, _, err_m, _ = _obs_cli(root, "critpath", trace_m, merged_m)
    snt = -(-small_n // nb)
    config.initialize(argv=["--dlaf:step-impl=fused"])
    small = Matrix.from_element_fn(hpd_element_fn(small_n, np.float32),
                                   GlobalElementSize(small_n, small_n), block, grid,
                                   dtype=np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        counted(kmods, launches, {"factor_solve": 4 * (snt - 1), "potrf": 4,
                                  "masked_trailing_update": 4 * (snt - 1)}
                if dev.type == "cuda" else {},
                lambda: (cholesky("L", small, donate=True), _sync(torch, dev)),
                "devtrace CPU-only trace")
    del small
    config.initialize()
    prof.export_chrome_trace(at("cpu_only.json"))
    rc_c, _, err_c, _ = _obs_cli(root, "devtrace", at("cpu_only.json"), merged)
    print(f"[devtrace] must-trips: critpath on main-L N={main_n} exit {rc_m} "
          f"({err_m.strip().splitlines()[-1] if err_m.strip() else ''}); devtrace on a "
          f"CPU-activity trace exit {rc_c} "
          f"({err_c.strip().splitlines()[-1] if err_c.strip() else ''})", flush=True)
    if rc_m != 1 or rc_c != 1:
        raise AssertionError("devtrace must-trips: an exit code is not 1")
    wall = time.perf_counter() - t_all
    if wall > budget:
        raise AssertionError(f"devtrace phase: {wall:.1f} s, above its {budget:.0f} s budget")


#: The analysis phase's budget (seconds).
ANALYSIS_BUDGET_S = 60.0


def _analysis_cli(root: str, device: str, out_path: str):
    """``python -m dlaf_tpu_torch.analysis --device <device>`` started in
    the background, its output to ``out_path``; returns the process."""
    env = {**os.environ, "PYTHONPATH": root}
    for k in [k for k in env if k.startswith("DLAF_")]:
        env.pop(k)
    return subprocess.Popen([sys.executable, "-m", "dlaf_tpu_torch.analysis", "--device",
                             device, "--root", root], cwd=root, env=env,
                            stdout=open(out_path, "w"), stderr=subprocess.STDOUT)


def _analysis_gate_line(path: str) -> tuple:
    """(the graph summary line, (findings, new, baselined, stale)) of a
    gate run's output."""
    import re

    text = open(path).read()
    graph = next((ln for ln in text.splitlines() if ln.startswith("graph: ")), "")
    m = re.search(r"(\d+) finding\(s\) \((\d+) new, (\d+) baselined\), (\d+) stale", text)
    return graph, tuple(int(g) for g in m.groups()) if m else None


def analysis_phase(torch, card, kmods, launches, out_dir, n: int = 16384, nb: int = 256,
                   device: str = "cuda", budget: float = ANALYSIS_BUDGET_S) -> None:
    """The static-analysis layer on the card (``dlaf_tpu_torch/analysis``);
    artifacts under ``out_dir``.

    a. The gate, ``python -m dlaf_tpu_torch.analysis``, with ``--device
       cuda`` and ``--device cpu`` (two processes, started once b's calls
       have run, in the background while b's checks and d run): both exit
       0 with no stale baseline key, so their finding keys are the
       committed baseline's, equal.
    b. main-L (float32, N=``n``, one rank, fused step, lookahead) and
       dist-L (the same on 2x2, with the update kernel), each recorded
       (``analysis.depgraph.trace``) after one warm call and one timed
       unrecorded call, with no other process of the phase running, under
       ``torch.cuda.set_sync_debug_mode("warn")``:
       the kernel nodes equal the launch counts (main-L: step nt-1, potrf
       1), the runtime's sync warnings the tape's host-sync entries, the
       audit (under the matrix's names ``cholesky.entry.*``) finds
       nothing outside the baseline, and for every step k of dist-L step
       k+1's panel all_gather is issued before step k's bulk and depends
       on none of it. Printed: nodes, ops, tape bytes, the recorded wall
       beside the unrecorded one, the largest intermediate over one
       rank's input bytes beside the peak allocation's rise, and the
       kernel launches whose output nothing reads.
    d. ``--drill host_callback`` on a CUDA tensor: exit code 1, and one
       sync warning of the runtime for each host-sync finding.

    (c, the processes' verb schedules, runs in the multi-process phase.)
    Fails above ``budget`` seconds."""
    import collections
    import warnings

    import numpy as np

    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.analysis import BASELINE_PATH, findings
    from dlaf_tpu_torch.analysis import depgraph as dg
    from dlaf_tpu_torch.analysis import graphcheck
    from dlaf_tpu_torch.analysis.__main__ import main as analysis_main
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import GlobalElementSize, TileElementSize
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp.generators import hpd_element_fn

    t_all = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    dev = torch.device(device)
    baseline = findings.load_baseline(os.path.join(root, BASELINE_PATH))

    def sync_warnings(caught):
        return [w for w in caught if "synchroniz" in str(w.message)]

    def record(argv, make, expect, label):
        """One warm call, one timed call with no tape, one recorded call:
        (tape, unrecorded s, recorded s, sync warnings, peak rise)."""
        config.initialize(argv=argv)
        cholesky("L", make(), donate=True)            # warm
        _sync(torch, dev)
        mat = make()
        _sync(torch, dev)
        t0 = time.perf_counter()
        cholesky("L", mat, donate=True)
        _sync(torch, dev)
        plain_s = time.perf_counter() - t0
        del mat
        mat = make()
        _sync(torch, dev)
        base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                tape = counted(kmods, launches, expect if dev.type == "cuda" else {},
                               lambda: dg.trace(lambda m: cholesky("L", m, donate=True), mat,
                                                device=dev.type), f"analysis {label}")
                _sync(torch, dev)
                rec_s = time.perf_counter() - t0
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        peak = (torch.cuda.max_memory_allocated() - base) if dev.type == "cuda" else 0
        del mat
        config.initialize()
        return tape, plain_s, rec_s, sync_warnings(caught), peak

    def check(label, name, expect, rec):
        tape, plain_s, rec_s, warned, peak = rec
        syncs = dg.host_syncs(tape)
        kern = dg.kernels(tape)
        want = {k: v for k, v in expect.items() if v} if dev.type == "cuda" else kern
        found = graphcheck.audit_tape(name, tape)
        new = [f for f in found if f.key not in baseline]
        top = [x for x in dg.iter_ops(tape) if x.kind in ("op", "kernel")]
        big = max(top, key=lambda x: x.out_bytes)
        dead = collections.Counter(x.name.split(":", 1)[1]
                                   for x in graphcheck.dead_outputs(tape) if x.kind == "kernel")
        summ = dg.summary(tape)
        print(f"[analysis] {label} N={n} nb={nb} f32: {summ['nodes']} nodes, {summ['ops']} "
              f"ops, {summ['collectives']} collectives, kernel nodes {kern} (launches "
              f"{want}), host syncs on the tape {len(syncs)}, runtime sync warnings "
              f"{len(warned)}, tape {summ['tape_bytes'] / 2 ** 20:.1f} MiB; recorded wall "
              f"{rec_s:.3f} s against {plain_s:.3f} s unrecorded ({rec_s / plain_s:.1f}x; "
              f"both with no other process of the phase running) [{card}]", flush=True)
        print(f"[analysis] {label}: largest intermediate {big.name} {big.out_bytes} bytes = "
              f"{big.out_bytes / tape.rank_bytes:.3f}x one rank's {tape.rank_bytes} input "
              f"bytes; peak allocation rise over the call {peak} bytes = "
              f"{peak / tape.rank_bytes:.3f}x; kernel launches whose output nothing reads "
              f"{dict(dead)} of {kern}; findings {len(found)} "
              f"({len({f.key for f in found})} keys), outside the baseline {len(new)}",
              flush=True)
        for f in new:
            print(f"[analysis] {label} NEW {f}", flush=True)
        if len(syncs) != len(warned):
            for x in syncs:
                print(f"[analysis] {label} tape sync {x.name} at {x.site}", flush=True)
            for w in warned:
                print(f"[analysis] {label} runtime warning at {w.filename}:{w.lineno}",
                      flush=True)
        if kern != want or len(syncs) != len(warned) or new:
            raise AssertionError(f"analysis {label}: kernel nodes {kern} (want {want}), "
                                 f"syncs {len(syncs)} against {len(warned)} warnings, "
                                 f"{len(new)} new findings")
        with open(os.path.join(out_dir, f"{label}.json"), "w") as fh:
            json.dump({"summary": summ, "plain_s": plain_s, "recorded_s": rec_s,
                       "largest": [big.name, big.out_bytes], "rank_bytes": tape.rank_bytes,
                       "peak_rise": peak, "dead_kernels": dict(dead),
                       "findings": sorted({f.key for f in found}),
                       "structure": dg.step_structure(tape)}, fh, indent=1)

    nt = -(-n // nb)
    size, block = GlobalElementSize(n, n), TileElementSize(nb, nb)
    # cuda's routes, named (graphcheck.ENTRY_ROUTES): the same on a CPU
    # rehearsal
    argv = [f"--dlaf:{k.replace('_', '-')}={v}" for k, v in graphcheck.ENTRY_ROUTES.items()]
    # -- b: both cells timed and recorded before a gate starts, so no other
    # process of the phase loads the host under their walls --------------
    main_expect = {"step": nt - 1, "potrf": 1}
    main_rec = record(argv, lambda: Matrix.from_element_fn(
        hpd_element_fn(n, np.float32), size, block, None, dtype=np.float32, device=dev),
        main_expect, "main-L")
    grid = shared_grid(2, 2, dev)
    dist_expect = {"factor_solve": 4 * (nt - 1), "potrf": 4,
                   "masked_trailing_update": 4 * (nt - 1)}
    dist_rec = record(argv, lambda: Matrix.from_element_fn(
        hpd_element_fn(n, np.float32), size, block, grid, dtype=np.float32),
        dist_expect, "dist-L")
    # -- a: the gate on both devices, in the background from here ---------
    gates = {d: _analysis_cli(root, d, os.path.join(out_dir, f"gate.{d}.txt"))
             for d in (device, "cpu")}
    check("main-L", "cholesky.entry.main-L", main_expect, main_rec)
    del main_rec
    check("dist-L", "cholesky.entry.dist-L", dist_expect, dist_rec)
    tape = dist_rec[0]
    del dist_rec
    # the look-ahead pin at full width, every step: one pass of the
    # bulk steps each node depends on
    bulk_steps = dg.ancestor_steps(tape, dg.is_bulk)
    pairs = 0
    gathers = 0
    for k in range(nt - 1):
        # every verb of step k+1's panel chain: the diagonal tile's
        # bcast2d, the panel's bcast and the transposed panel's all_gather
        chain = [x for x in dg.collectives(tape) if x.parent is None
                 and dg.step_scope_of(x) == ("cholesky", k + 1, "panel")]
        bulk = [x for x in dg.iter_ops(tape) if dg.is_bulk(x)
                and dg.step_scope_of(x)[:2] == ("cholesky", k)]
        if not chain or not bulk:
            continue
        late = [x for x in chain if x.index > bulk[0].index or bulk_steps[x.index] >> k & 1]
        if late:
            raise AssertionError(f"analysis dist-L: step {k + 1}'s panel {late[0].name} "
                                 f"(node {late[0].index}) is not ahead of and independent of "
                                 f"step {k}'s bulk (node {bulk[0].index})")
        pairs += 1
        gathers += any(x.name == "all_gather" for x in chain)
    print(f"[analysis] dist-L look-ahead pin: step k+1's panel collectives ahead of and "
          f"independent of step k's bulk for {pairs} of {nt - 1} step pairs ({gathers} with "
          f"the transposed panel's all_gather)", flush=True)
    if pairs != nt - 1:
        raise AssertionError(f"analysis dist-L: the pin covered {pairs} of {nt - 1} pairs")
    del tape

    # -- d: the host-sync drill on the card ---------------------------------
    if dev.type == "cuda":
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, \
                contextlib.redirect_stdout(io.StringIO()) as buf:
            warnings.simplefilter("always")
            rc = analysis_main(["--drill", "host_callback", "--device", dev.type])
    finally:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    hits = buf.getvalue().count("[graph-host-callback]")
    warned = len(sync_warnings(caught))
    print(f"[analysis] drill host_callback on {dev.type}: exit {rc}, {hits} host-sync "
          f"findings, {warned} runtime sync warnings", flush=True)
    if rc != 1 or not hits or (dev.type == "cuda" and warned != hits):
        raise AssertionError(f"analysis drill: exit {rc}, {hits} findings, {warned} warnings")

    # -- a: the two gates ----------------------------------------------------
    for d, proc in gates.items():
        try:
            rc = proc.wait(timeout=max(budget - (time.perf_counter() - t_all), 5))
        except subprocess.TimeoutExpired:
            for p in gates.values():
                p.kill()
            raise AssertionError(f"analysis gate --device {d}: over the phase's budget")
        graph, counts = _analysis_gate_line(os.path.join(out_dir, f"gate.{d}.txt"))
        print(f"[analysis] gate --device {d}: exit {rc}; {graph}; findings/new/baselined/"
              f"stale {counts}", flush=True)
        if rc != 0 or counts is None or counts[1] or counts[3]:
            print(open(os.path.join(out_dir, f"gate.{d}.txt")).read()[-4000:], flush=True)
            raise AssertionError(f"analysis gate --device {d}: exit {rc}, {counts}")
    # no new key and no stale one: each run's keys are the baseline's
    print(f"[analysis] the gate's finding keys on {device} equal the cpu's: the committed "
          f"baseline's {len(set(baseline))}", flush=True)
    wall = time.perf_counter() - t_all
    if wall > budget:
        raise AssertionError(f"analysis phase: {wall:.1f} s, above its {budget:.0f} s budget")


def _strict(config, on: bool) -> None:
    """``DLAF_STRICT`` on or off for this process and the ones it starts."""
    os.environ["DLAF_STRICT"] = "1" if on else "0"
    config.initialize()


def _new_fallbacks(registry, before: dict) -> dict:
    """``{(site, reason): count}`` the registry counted since ``before``."""
    now = registry.fallback_counts()
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}


def _evp_counted(kmods, launches, what: str, fn):
    """``fn()`` with the kernels' counts from 0: fails if a kernel other
    than the Givens undo launched (the float64 eigensolver's default routes
    launch none), adds the counts to ``launches``."""
    for m in kmods:
        m.reset_launches()
    out = fn()
    counts = {k: v for m in kmods for k, v in m.LAUNCHES.items()}
    if any(v for k, v in counts.items() if k != "givens_undo"):
        raise AssertionError(f"{what}: launches {counts}, expected the Givens undo's only")
    for k, v in counts.items():
        launches[k] += v
    return out


class _StageIO:
    """Times ``matrix.checkpoint``'s stage writes and loads (bytes of each
    payload file, seconds of each call) while the ``with`` block runs."""

    def __init__(self, ckpt):
        self.ckpt = ckpt
        self.writes, self.loads = {}, {}

    def __enter__(self):
        save, load = self.ckpt.save_stage, self.ckpt.load_stage
        self._orig = save, load

        def timed_save(directory, stage, arrays, fingerprint):
            t0 = time.perf_counter()
            out = save(directory, stage, arrays, fingerprint)
            self.writes[stage] = (os.path.getsize(os.path.join(directory, f"{stage}.npz")),
                                  time.perf_counter() - t0)
            return out

        def timed_load(directory, stage):
            t0 = time.perf_counter()
            out = load(directory, stage)
            self.loads[stage] = time.perf_counter() - t0
            return out

        self.ckpt.save_stage, self.ckpt.load_stage = timed_save, timed_load
        return self

    def __exit__(self, *exc):
        self.ckpt.save_stage, self.ckpt.load_stage = self._orig


def resilience_phase(torch, dev, card, kmods, launches, drive, out_dir, main_n: int = 16384,
                     oz_n: int = 8192, deg=(1024, 256, 64), evp=(8192, 512, 128, (4, 4)),
                     small_n: int = 4096, stream: int = 256, coll_n: int = 4096, nb: int = 256,
                     app_args=()) -> None:
    """The resilience layer on the card (``health.inject``, ``registry``,
    ``resume``, ``matrix.checkpoint``), ``DLAF_STRICT`` off but where a
    case asks for it:

    * degradations: main-L under ``disable_pallas`` (#1–#4 0 launches, the
      fallback counted at ``panel``/``step``, the miniapp's residual check;
      under ``DLAF_STRICT=1`` the same call raises ``DegradationError``);
      dist-L 2x2 under ``disable_pallas`` (#5 0); the distributed f64
      ``ozaki_impl=pallas`` route under ``disable_ozaki`` (#6, #7 0); the
      eigensolver at ``deg`` (n, nb, band) under ``force_native_failure``
      (``secular``, ``deflate`` and ``band_to_tridiag`` counted, the
      eigenpairs within budget);
    * kill and resume: evp-d's kind of A, grid, block and band at
      ``evp``'s order: one uninterrupted call, ``preempt("b2t")``,
      ``resume=True``, the eigenpairs bitwise the uninterrupted call's, each
      stage's checkpoint bytes and write seconds and the load seconds of
      the stages the resume loads; at ``small_n`` a preempt and resume at
      each of the five boundaries, each bitwise, with every stage's bytes
      and write and load seconds;
    * serve: ``stream`` requests under ``fail_dispatch(nth=3, count=2)``,
      every ticket answered bitwise as a clean pass's, ``dlaf_retry_total``
      > 0; a sustained fault opens the bucket's breaker, and later tickets
      fail fast;
    * collectives: ``corrupt_collective("bcast", nth=1)`` on dist-L 2x2
      with ``with_info``: the NaN detected, the next call clean.

    ``nb`` is the Cholesky cells' block; ``app_args`` go to every miniapp
    run (``("--backend", "cpu")`` with ``dev`` the CPU and small sizes
    rehearse the phase there)."""
    import numpy as np

    from dlaf_tpu_torch import config, obs
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import GlobalElementSize, TileElementSize
    from dlaf_tpu_torch.eigensolver.eigensolver import eigensolver
    from dlaf_tpu_torch.health import inject, registry
    from dlaf_tpu_torch.health.errors import (CircuitOpenError, DegradationError,
                                              PreemptionError)
    from dlaf_tpu_torch.matrix import checkpoint as ckpt
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp import miniapp_cholesky
    from dlaf_tpu_torch.miniapp.generators import hpd_element_fn
    from dlaf_tpu_torch.miniapp.miniapp_eigensolver import eigen_residuals
    from dlaf_tpu_torch.miniapp.miniapp_reduction_to_band import eigenvalue_drift
    from dlaf_tpu_torch.serve import ProgramService, Queue, Request

    t_all = time.perf_counter()
    _strict(config, False)
    share = ["--share-device", "--nruns", "2", "--nwarmups", "1", "--check-result", "last",
             *app_args]
    # main-L's arguments (cuda's panel_impl auto is fused: named here, so
    # that the CPU rehearsal opens the panel route too)
    main_l = ["-m", str(main_n), "-b", str(nb), *OBS_MAIN_L, "--dlaf:panel-impl=fused",
              "--nruns", "2", "--nwarmups", "1", "--check-result", "last", *app_args]

    # ---- degradations ----------------------------------------------------
    def drill(name, ctx, argv, n, want_sites):
        before = registry.fallback_counts()
        t0 = time.perf_counter()
        with ctx():
            wall = drive(argv, n, nb, 3, {})        # every kernel 0 launches
        got = _new_fallbacks(registry, before)
        print(f"[resilience] {name}: best {wall:.6f} s, no kernel of the route launched, "
              f"fallbacks {got} ({time.perf_counter() - t0:.1f} s) [{card}]", flush=True)
        if not all(got.get((s, "injected_off"), 0) > 0 for s in want_sites):
            raise AssertionError(f"{name}: fallbacks {got}, expected {want_sites} counted")

    drill("main-L disable_pallas", inject.disable_pallas, main_l, main_n, ("panel", "step"))
    _strict(config, True)
    try:
        with inject.disable_pallas(), contextlib.redirect_stdout(io.StringIO()):
            miniapp_cholesky.run(main_l)
        raise AssertionError("main-L disable_pallas under DLAF_STRICT=1 did not raise")
    except DegradationError as e:
        print(f"[resilience] main-L disable_pallas under DLAF_STRICT=1: DegradationError at "
              f"site {e.site!r} ({e.reason})", flush=True)
    _strict(config, False)
    drill("dist-L 2x2 disable_pallas", inject.disable_pallas,
          ["-m", str(main_n), "-b", str(nb), "--type", "s", "--uplo", "L", "--grid-rows", "2",
           "--grid-cols", "2", "--dlaf:step-impl=fused", "--dlaf:panel-impl=fused", *share],
          main_n,
          ("panel", "step", "pallas_update"))
    drill("dist-f64 2x2 ozaki_impl=pallas disable_ozaki", inject.disable_ozaki,
          ["-m", str(oz_n), "-b", str(nb), "--type", "d", "--uplo", "L", "--grid-rows", "2",
           "--grid-cols", "2", "--dlaf:f64-gemm=mxu", "--dlaf:f64-trsm=mixed",
           "--dlaf:ozaki-impl=pallas", *share], oz_n, ("ozaki_gemm",))
    def run_evp(a, n, nb_, band, grid, what, **kw):
        g = shared_grid(*grid, dev) if grid else None
        t0 = time.perf_counter()
        res = _evp_counted(kmods, launches, what, lambda: eigensolver(
            "L", Matrix.from_global(a, TileElementSize(nb_, nb_), g, device=dev),
            band_size=band, donate=True, **kw))
        _sync(torch, dev)
        return res, time.perf_counter() - t0

    _wall("resilience degradations", t_all)
    t_sec = time.perf_counter()
    config.initialize()          # the default routes again, after the miniapps' knobs
    n, nb_e, band = deg
    before = registry.fallback_counts()
    a = _random_herm(torch, dev, n, torch.float64, 7)
    with inject.force_native_failure():
        res, t = run_evp(a, n, nb_e, band, None, "eigensolver force_native_failure")
    got = _new_fallbacks(registry, before)
    vals = eigen_residuals(a, None, res.eigenvalues, res.eigenvectors.to_global())
    drift = eigenvalue_drift(torch.linalg.eigvalsh(a).cpu(), torch.as_tensor(res.eigenvalues))
    eps = float(np.finfo(np.float64).eps)
    ok_ = (max(vals.values()) < 200 * n * eps and drift < 100 * n * eps
           and all(got.get((s, "native_unavailable"), 0) > 0
                   for s in ("secular", "deflate", "band_to_tridiag")))
    print(f"[resilience] eigensolver N={n} nb={nb_e} band={band} force_native_failure: "
          f"{t:.6f} s, residual {vals['eigen_residual']:.3e} orthogonality "
          f"{vals['orthogonality']:.3e} drift {drift:.3e} (tol {200 * n * eps:.3e}, drift "
          f"{100 * n * eps:.3e}), fallbacks {got} [{card}]", flush=True)
    if not ok_:
        raise AssertionError("eigensolver under force_native_failure failed its check")
    del a, res
    t_sec = _wall(f"resilience force_native_failure N={n}", t_sec)

    # ---- kill and resume -------------------------------------------------
    root = os.path.join(out_dir, "resume")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    print(f"[resilience] checkpoint disk: {shutil.disk_usage(root).free / 2 ** 30:.1f} GiB free "
          f"under {root}", flush=True)

    def host(res):
        return res.eigenvalues, [x.cpu() for x in res.eigenvectors.shards()]

    def same(res, ref):
        lam, shards = ref
        return (np.array_equal(res.eigenvalues, lam)
                and all(torch.equal(p.cpu(), q) for p, q in zip(res.eigenvectors.shards(),
                                                                shards)))

    def kill_resume(a, n, nb_, band, grid, stage, ref, label):
        rd = os.path.join(root, f"{label}-{stage}")
        os.environ["DLAF_RESUME_DIR"] = rd
        config.initialize()
        try:
            t0 = time.perf_counter()
            try:
                with inject.preempt(stage):
                    run_evp(a, n, nb_, band, grid, f"{label} preempt {stage}")
                raise AssertionError(f"{label}: preempt({stage!r}) did not stop the run")
            except PreemptionError:
                pass
            t_kill = time.perf_counter() - t0
            res, t_res = run_evp(a, n, nb_, band, grid, f"{label} resume", resume=True)
        finally:
            del os.environ["DLAF_RESUME_DIR"]
            config.initialize()
        ok_ = same(res, ref)
        print(f"[resilience] {label} N={n} preempt at {stage}: killed after {t_kill:.3f} s, "
              f"resumed in {t_res:.3f} s, eigenpairs {'bitwise' if ok_ else 'DIFFER from'} "
              f"the uninterrupted call's [{card}]", flush=True)
        if not ok_:
            raise AssertionError(f"{label}: resume after {stage} is not bitwise")

    n, nb_e, band, grid = evp
    a = _random_herm(torch, dev, n, torch.float64, 20 + len("evp-d") + n % 97)
    res, t_ref = run_evp(a, n, nb_e, band, grid, "evp-d uninterrupted")
    ref = host(res)
    del res
    print(f"[resilience] evp-d N={n} nb={nb_e} band={band} {grid[0]}x{grid[1]} "
          f"uninterrupted: {t_ref:.6f} s [{card}]", flush=True)
    if not (np.isfinite(ref[0]).all() and ref[0].shape == (n,)):
        raise AssertionError("evp-d uninterrupted: eigenvalues not finite")
    def stage_io(label, io_, loaded_by):
        for st in RESUME_STAGES:
            nbytes, w = io_.writes[st]
            load = (f"load {io_.loads[st]:.3f} s (warm)" if st in io_.loads
                    else f"not loaded by {loaded_by}")
            print(f"[resilience] {label} checkpoint {st}: {nbytes} bytes, write {w:.3f} s "
                  f"({nbytes / w / 1e9:.2f} GB/s), {load} [{card}]", flush=True)

    # the resume after b2t loads red2band and b2t; the later stages' loads
    # are timed at small_n, where every resume below loads its stage
    with _StageIO(ckpt) as io_:
        kill_resume(a, n, nb_e, band, grid, "b2t", ref, "evp-d")
    stage_io("evp-d", io_, "the b2t resume")
    del ref, a
    t_sec = _wall(f"resilience evp-d N={n} kill at b2t and resume", t_sec)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    a = _random_herm(torch, dev, small_n, torch.float64, 41)
    ref = host(run_evp(a, small_n, nb_e, band, grid, "evp small uninterrupted")[0])
    with _StageIO(ckpt) as io_:
        for st in RESUME_STAGES:
            kill_resume(a, small_n, nb_e, band, grid, st, ref, "evp-small")
    stage_io("evp-small", io_, "a resume")
    del ref, a
    shutil.rmtree(root, ignore_errors=True)
    t_sec = _wall(f"resilience N={small_n} kills at five boundaries", t_sec)

    # ---- serve: a transient and a sustained dispatch fault ----------------
    art = os.path.join(out_dir, "resilience_serve.jsonl")
    if os.path.exists(art):
        os.remove(art)
    os.environ["DLAF_METRICS_PATH"] = art
    config.initialize()
    try:
        reqs = _stream_requests(np, Request, stream, SERVE_SEED + 3)

        def serve(fault):
            q = Queue(ProgramService(device=dev), batch=16, buckets=(32, 64, 128, 256),
                      deadline_s=1e9)
            q.warmup(reqs)
            t0 = time.perf_counter()
            with fault():
                ts = [q.submit(r) for r in reqs]
                q.flush()
            return ts, q, time.perf_counter() - t0

        def retry_total():
            # the process's counter: earlier phases' retries are in it too
            return sum(m["value"] for m in obs.registry().snapshot()
                       if m["name"] == "dlaf_retry_total")

        clean, _, wall_clean = serve(contextlib.nullcontext)
        before = retry_total()
        faulted, q, wall = serve(lambda: inject.fail_dispatch(nth=3, count=2))
        retries = retry_total() - before

        def parts(t):
            out = t.result()
            return out if isinstance(out, tuple) else (out,)

        bitwise = all(t.done and c.done and all(np.array_equal(x, y)
                                                for x, y in zip(parts(t), parts(c)))
                      for t, c in zip(faulted, clean))
        print(f"[resilience] serve {stream} requests under fail_dispatch(nth=3, count=2): "
              f"{sum(t.done for t in faulted)} answered, bitwise the clean pass's: {bitwise}, "
              f"dlaf_retry_total +{retries:g}, {q.stats()['dispatches']} dispatches in "
              f"{wall:.4f} s (the clean pass {wall_clean:.4f} s) [{card}]", flush=True)
        if not (bitwise and retries > 0):
            raise AssertionError("serve under fail_dispatch: not every ticket answered bitwise")
        q = Queue(ProgramService(device=dev), batch=1, buckets=(32,), deadline_s=1e9,
                  retry_attempts=3)
        with inject.fail_dispatch(nth=0, count=10 ** 6):
            try:
                q.submit(Request(op="cholesky", a=np.eye(8)))
                raise AssertionError("sustained fault: the first ticket did not fail")
            except RuntimeError as e:
                first = type(e).__name__
            (bucket,) = q.stats()["buckets"].values()
            state = bucket["breaker"]
            t0 = time.perf_counter()
            try:
                q.submit(Request(op="cholesky", a=np.eye(8)))
                raise AssertionError("sustained fault: the later ticket did not fail fast")
            except CircuitOpenError:
                fast = time.perf_counter() - t0
        print(f"[resilience] serve sustained fault: first ticket {first}, breaker {state}, the "
              f"next ticket CircuitOpenError in {fast * 1e3:.3f} ms", flush=True)
        if state != "open":
            raise AssertionError(f"sustained fault: breaker {state}, expected open")
    finally:
        del os.environ["DLAF_METRICS_PATH"]
        config.initialize()

    t_sec = _wall("resilience serve drills", t_sec)

    # ---- collectives -----------------------------------------------------
    config.initialize(argv=["--dlaf:step-impl=fused"])
    g = shared_grid(2, 2, dev)

    def factor():
        m = Matrix.from_element_fn(hpd_element_fn(coll_n, np.float32),
                                   GlobalElementSize(coll_n, coll_n), TileElementSize(nb, nb),
                                   g, dtype=np.float32)
        _, info = cholesky("L", m, donate=True, with_info=True)
        return int(info)

    with inject.corrupt_collective("bcast", nth=1):
        poisoned = factor()
    clean = factor()
    config.initialize()
    print(f"[resilience] dist-L N={coll_n} 2x2 corrupt_collective('bcast', nth=1): info "
          f"{poisoned}; the next call: info {clean}", flush=True)
    if not (poisoned != 0 and clean == 0):
        raise AssertionError("corrupt_collective: the poison was not detected, or it leaked")
    _wall("resilience corrupt_collective", t_sec)
    print(f"[phase] resilience {time.perf_counter() - t_all:.1f} s", flush=True)


def panel_products(torch, dev, randn, hpd, check, pk, cb) -> None:
    """The strip and slab products alone (``strip_kernel``, ``slab_kernel``
    of ``csrc/panel.cu`` through its C entries) against the plain
    product on the same inputs: ``b @ op(inv)`` with the inverse the card's
    ``trinv_kernel`` made, at transB 1 (the Cholesky paths: rows of the
    inverse) and 0 (``panel_solve`` op 'N': its columns), float32 and
    bfloat16 with the f32 copy ``out32``, d = 256, 200, 129, 9, 8, 1 and
    m = 16128 (the main path's first step), 16127, 4099 and 1000 (row
    tiles of 64, 16 and 8 rows, ragged and not); inf and NaN in ``b`` at k
    that the triangle's skip leaves out (and at k it runs), whose NaN
    masks must equal the dense product's; the masked slab ``c - mask(p
    p[:w]^T)`` at w = d and w < d, with a NaN in p whose products above
    the mask must not reach the output."""
    lib, s = pk.LIBRARY.load(), cb.stream(torch.empty(0, device=dev))
    f32 = torch.float32
    for dt in (f32, torch.bfloat16):
        tname, code = str(dt).split(".")[1], 0 if dt == f32 else 1
        for dd in (256, 200, 129, 9, 8, 1):
            fac = pk.potrf_plain("L", hpd(dd)).float().contiguous()
            inv = torch.empty((dd, dd), dtype=f32, device=dev)
            cb.check(lib.dlaf_trinv(0, fac.data_ptr(), dd, 0, inv.data_ptr(), dd, s), "trinv")
            for mm in ((16128, 16127, 4099, 1000) if dd in (256, 200) else (4099, 1000)):
                b = randn(mm, dd)
                if dd > 64:
                    # rows 0-4: non-finite at k skipped by some column
                    # groups of either orientation, and at k they run
                    for row, k, v in ((0, dd - 1, float("inf")), (1, 0, float("nan")),
                                      (2, dd // 2, -float("inf")), (3, 33, float("nan")),
                                      (4, 7, float("inf")), (4, dd - 2, float("nan"))):
                        b[row, k] = v
                b = b.to(dt)
                for trans in (1, 0):
                    out = torch.empty((mm, dd), dtype=dt, device=dev)
                    out32 = torch.empty((mm, dd), dtype=f32, device=dev) if dt != f32 else None
                    cb.check(lib.dlaf_strip(code, b.data_ptr(), dd, inv.data_ptr(), trans,
                                            out.data_ptr(), dd,
                                            None if out32 is None else out32.data_ptr(), dd,
                                            mm, dd, s), "strip")
                    ref32 = b.float() @ (inv.T if trans else inv)
                    pairs = [(out, ref32.to(dt))]
                    case = f"{tname} d={dd} m={mm} transB={trans}"
                    check("strip", case, pairs, dt, dd)
                    if out32 is not None:
                        check("strip out32", case, [(out32, ref32)], f32, dd)
                    for got, ref in pairs + ([(out32, ref32)] if out32 is not None else []):
                        if not torch.equal(torch.isnan(got.float()), torch.isnan(ref.float())):
                            raise AssertionError(f"strip {case}: NaN masks differ")
        for dd, mm, w in ((256, 16128, 256), (256, 16127, 131), (200, 4099, 200),
                          (200, 1000, 64), (129, 1000, 129), (9, 1000, 9), (1, 1000, 1)):
            p32 = randn(mm, dd)
            p32[0, dd // 2] = float("nan")   # row 0 and column 0 of the product
            c = randn(mm, w).to(dt)
            out = torch.empty((mm, w), dtype=dt, device=dev)
            cb.check(lib.dlaf_slab(code, p32.data_ptr(), dd, c.data_ptr(), w, out.data_ptr(), w,
                                   mm, w, dd, s), "slab")
            mask = (torch.arange(mm, device=dev)[:, None] >= torch.arange(w, device=dev)[None, :])
            ref = (c.float() + torch.where(mask, -(p32 @ p32[:w].T), 0.0)).to(dt)
            case = f"{tname} d={dd} m={mm} w={w}"
            check("slab", case, [(out, ref)], dt, dd)
            if not torch.equal(torch.isnan(out.float()), torch.isnan(ref.float())):
                raise AssertionError(f"slab {case}: NaN masks differ")
    torch.cuda.synchronize()


def givens_lists(np, kind: str, g: int, n: int, seed: int):
    """A seeded ``(g, 4)`` rotation list on ``n`` rows that stresses the
    Givens undo's schedule: ``fresh`` disjoint pairs (the Toeplitz
    merge's structure; a pair returns after n / 2 rotations), ``anchor``
    chains through one row, ``moving`` (the anchor moves to the row just
    written), ``repeat`` (three pairs again and again), ``mixed`` (24
    rows: dependencies at every distance)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    if kind == "fresh":
        rows = perm[np.arange(2 * g) % n].reshape(g, 2)
    elif kind == "anchor":
        rows, anchor, nxt = np.empty((g, 2), dtype=np.int64), perm[0], 1
        for t in range(g):
            if rng.random() < 0.1:
                anchor, nxt = perm[nxt % n], nxt + 1
            j, nxt = perm[nxt % n], nxt + 1
            if j == anchor:
                j, nxt = perm[nxt % n], nxt + 1
            rows[t] = anchor, j
    elif kind == "moving":
        rows = np.stack([perm[np.arange(g) % n], perm[(np.arange(g) + 1) % n]], axis=1)
    elif kind == "repeat":
        rows = perm[:6].reshape(3, 2)[rng.integers(0, 3, g)]
    else:
        rows = np.stack([rng.choice(min(n, 24), 2, replace=False) for _ in range(g)])
    th = rng.uniform(0, 2 * np.pi, g)
    return np.column_stack([rows[:, 0], rows[:, 1], np.cos(th), np.sin(th)])


def givens_checks(torch, dev, gk) -> None:
    """The Givens undo bit for bit against its plain loop on lists that
    stress its schedule (:func:`givens_lists`), with g not a multiple of
    the staging chunk (256) and w not a multiple of the block (128)."""
    import numpy as np

    for kind in ("fresh", "anchor", "moving", "repeat", "mixed"):
        for n, w, g in ((256, 1000, 3001), (4096, 333, 2048), (64, 129, 17)):
            giv = givens_lists(np, kind, g, n, g + n)
            u0 = torch.randn(n, w, dtype=torch.float64, device=dev)
            got = gk.givens_undo(u0.clone(), giv)
            ref = gk.givens_undo_plain(u0.clone(), giv)
            same = torch.equal(got, ref)
            print(f"[kernel] givens_undo  {kind:6s} u ({n}, {w}), {g} rotations: "
                  f"{'bitwise equal' if same else 'DIFFERS'} to the plain loop", flush=True)
            if not same:
                raise AssertionError(f"givens_undo {kind} ({n}, {w}) g={g} differs")


# ---------------------------------------------------------------------------
# The multi-process form: one process per rank
# ---------------------------------------------------------------------------

#: The spawned processes' cases at N=4096, nb=256 on 2x2, every rank on
#: cuda:0 over gloo: (name, kind, dtype letter, knobs).
MP_N, MP_NB = 4096, 256
MP_CASES = (("dist-L", "cholesky", "s", ()),
            ("dist-f64", "cholesky", "d", ("--dlaf:f64-gemm=mxu", "--dlaf:f64-trsm=mixed",
                                           "--dlaf:ozaki-impl=pallas")),
            ("trsm-d", "solve", "d", ()),
            # the eigensolver pipeline: config #3's type by both HEGST
            # forms, reduction to band at config #4's widths (and under
            # f64_gemm=mxu, where the per-rank forming shows in #6's
            # count), the standard eigensolver of a matrix whose D&C
            # deflates by rotations (:func:`_mp_case`) and the generalized
            # one
            ("g2s-z-twosolve", "gen_to_std", "z", ("--dlaf:hegst-impl=twosolve",)),
            ("g2s-z-blocked", "gen_to_std", "z", ("--dlaf:hegst-impl=blocked",)),
            ("red2band-d", "red2band", "d", ()),
            ("red2band-d-mxu", "red2band", "d", ("--dlaf:f64-gemm=mxu",
                                                 "--dlaf:ozaki-impl=pallas")),
            ("evp-d", "eigensolver", "d", ()),
            ("gen-evp-d", "gen_eigensolver", "d", ()))

#: (block, band) of the eigensolver pipeline's cases as multiples of the
#: phase's nb: at nb=256 config #4's widths (512, 128) for the reduction
#: and the standard eigensolver, (256, 128) for the generalized one.
MP_WIDTHS = {"red2band": (2, 0.5), "eigensolver": (2, 0.5), "gen_eigensolver": (1, 0.5)}

#: The largest order of the processes' second run of each case, the one
#: under an armed analysis tape that records their verb schedules: half
#: the cases' N, for room (the schedules' structure, D&C sharding
#: included, is the same; the step counts halve).
MP_SCHEDULE_N = 2048


def _mp_herm(torch):
    """A seeded-free Hermitian element function with a full spectrum: a
    hash of (i + j, i j), so every process evaluates the same matrix."""
    def fn(i, j):
        h = torch.sin((i * j) * 0.7071 + (i + j) * 1.3137) * 43758.5453
        return h - torch.floor(h) - 0.5 + torch.cos(0.001 * (i + j))
    return fn


def _mp_case(kind, letter, knobs, grid, n: int = MP_N, nb: int = MP_NB):
    """One case of :data:`MP_CASES` on ``grid`` (single-controller or
    multi-process): the result's shards this process holds, on the host,
    the kernels' launch counts of the call alone, and the arrays every
    process holds (the taus, the eigenvalues)."""
    import numpy as np
    import torch

    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.algorithms.gen_to_std import gen_to_std
    from dlaf_tpu_torch.algorithms.triangular import triangular_solve
    from dlaf_tpu_torch.comm.sync import barrier
    from dlaf_tpu_torch.common.index2d import GlobalElementSize, TileElementSize
    from dlaf_tpu_torch.eigensolver import eigensolver, reduction_to_band
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp.generators import herm_element_fn, hpd_element_fn
    from dlaf_tpu_torch.tile_ops import givens_kernels as gk
    from dlaf_tpu_torch.tile_ops import ozaki_kernels as ok
    from dlaf_tpu_torch.tile_ops import panel_kernels as pk
    from dlaf_tpu_torch.tile_ops import update_kernels as uk

    config.initialize(argv=list(knobs))
    dtype = {"s": np.float32, "d": np.float64, "z": np.complex128}[letter]
    scale, frac = MP_WIDTHS.get(kind, (1, None))
    band = None if frac is None else int(nb * frac)
    nb = nb * scale
    size, tile = GlobalElementSize(n, n), TileElementSize(nb, nb)

    def mat(fn):
        return Matrix.from_element_fn(fn, size, tile, grid, dtype=dtype)

    if kind == "cholesky":
        args = (mat(hpd_element_fn(n, dtype)),)
        call = lambda m: cholesky("L", m)   # noqa: E731
    elif kind == "solve":   # config #2's solve, LLNN, at N=4096
        am = mat(lambda i, j: 1.0 / (1.0 + (i - j).abs()) + 2.0 * n * (i == j))
        bm = mat(lambda i, j: torch.cos(0.001 * (i + 1)) + torch.sin(0.002 * (j + 1)))
        args = (am, bm)
        call = lambda a, b: triangular_solve("L", "L", "N", "N", 1.0, a, b)   # noqa: E731
    elif kind == "gen_to_std":
        bf = cholesky("L", mat(hpd_element_fn(n, dtype)))
        args = (mat(herm_element_fn(n, dtype)), bf)
        call = lambda a, b: gen_to_std("L", a, b)   # noqa: E731
    elif kind == "red2band":
        args = (mat(_mp_herm(torch)),)
        call = lambda a: reduction_to_band.reduction_to_band(a, band)   # noqa: E731
    elif kind == "eigensolver":
        # the Toeplitz tridiagonal (2, 1): the reduction and the chase
        # leave it as it is, and the D&C's merges of equal-sized halves
        # meet pairs of equal poles, which it deflates by rotations, so
        # the Givens undo runs on rank (0, 0)'s process
        args = (mat(lambda i, j: 2.0 * (i == j) + 1.0 * ((i - j).abs() == 1)),)
        call = lambda a: eigensolver.eigensolver("L", a, band_size=band)   # noqa: E731
    else:
        args = (mat(_mp_herm(torch)), mat(hpd_element_fn(n, dtype)))
        call = lambda a, b: eigensolver.gen_eigensolver("L", a, b,   # noqa: E731
                                                        band_size=band)
    barrier(*args)
    kmods = (pk, ok, uk, gk)
    for m in kmods:
        m.reset_launches()
    out = call(*args)
    arrays = {}
    if kind == "red2band":
        out, arrays = out.matrix, {"taus": out.taus.cpu()}
    elif kind in ("eigensolver", "gen_eigensolver"):
        arrays = {"eigenvalues": torch.as_tensor(out.eigenvalues)}
        out = out.eigenvectors
    barrier(out)
    counts = {k: v for m in kmods for k, v in m.LAUNCHES.items()}
    return {i: s.cpu() for i, s in enumerate(out.storage) if s is not None}, counts, arrays


def _mp_rank(rank: int, world: int, rdv: str, out_dir: str, device: str, n: int,
             nb: int, sched_n: int) -> None:
    """A spawned process: rank ``rank`` of a 2x2 grid on ``device`` over
    gloo; runs :data:`MP_CASES` and saves its shards, counts, arrays and
    wall, then runs each case again at order ``sched_n`` under an armed
    analysis tape and saves the verbs it issued
    (graph-conditional-collective)."""
    import torch

    from dlaf_tpu_torch.analysis import depgraph
    from dlaf_tpu_torch.comm import multihost

    multihost.initialize_multihost(f"file://{rdv}", world, rank, backend="gloo", timeout=600)
    grid = multihost.multihost_grid(2, 2, device=device)
    for name, kind, letter, knobs in MP_CASES:
        t0 = time.perf_counter()
        shards, counts, arrays = _mp_case(kind, letter, knobs, grid, n, nb)
        wall = time.perf_counter() - t0
        tape = depgraph.Tape(torch.device(device).type, ops=False)
        with tape.armed():
            _mp_case(kind, letter, knobs, grid, sched_n, nb)
        torch.save({"shards": shards, "counts": counts, "arrays": arrays, "wall": wall,
                    "schedule": tape.schedule, "grid_rank": tuple(grid.local_ranks[0])},
                   os.path.join(out_dir, f"{name}.r{rank}.pt"))
    multihost.finalize_multihost()


def _mp_compare(torch, got, want_shards, want_arrays):
    """(bitwise equal, max relative difference) of the processes' results
    ``got`` (one dict a process: its rank's shard, its arrays) against the
    single controller's; every process's arrays are compared."""
    same, worst = True, 0.0
    for i, g in enumerate(got):
        (idx, shard), = g["shards"].items()
        pairs = [(shard, want_shards[idx])] + [(g["arrays"][k], want_arrays[k])
                                               for k in want_arrays]
        if idx != i:
            same = False
        for x, y in pairs:
            if x.shape != y.shape or not torch.equal(_bits(torch, x), _bits(torch, y)):
                same = False
                if x.shape == y.shape:
                    worst = max(worst, float((x - y).abs().max() / y.abs().max()))
                else:
                    worst = float("inf")
    return same, worst


def _mp_unshared_counts(grid, kind, letter, knobs, n, nb) -> dict:
    """The single controller's launch counts of a case with every value
    formed per rank (``cc.per_rank_once`` made ``cc.per_rank``), as one
    process per rank forms them."""
    from dlaf_tpu_torch.comm import collectives as cc

    saved = cc.per_rank_once
    cc.per_rank_once = lambda P, Q, key, make: cc.per_rank(P, Q, make)
    try:
        return _mp_case(kind, letter, knobs, grid, n, nb)[1]
    finally:
        cc.per_rank_once = saved


def _bits(torch, t):
    """``t``'s bit patterns as integers (``-0.0`` differs from ``+0.0``)."""
    t = torch.view_as_real(t) if t.is_complex() else t
    if t.is_floating_point():
        t = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def _run_group(cmd, timeout: float, env) -> str:
    """Run ``cmd`` in a session of its own and return its standard output;
    on a timeout kill the whole session (``torchrun`` and its workers) and
    raise; on a nonzero exit raise with the output's tail."""
    import signal

    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=env, start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise AssertionError(f"{' '.join(cmd[3:8])}: no end within {timeout} s")
    if p.returncode:
        ranks = "\n".join([ln for ln in err.splitlines() if ln.startswith("[rank")][-60:])
        raise AssertionError(f"{' '.join(cmd)} exited {p.returncode}:\n{out[-3000:]}\n"
                             f"{ranks}\n{err[-3000:]}")
    return out


#: The eigensolver pipeline's miniapps under ``torchrun`` on 2x2 (app,
#: arguments, what the size is), all three in one launch
#: (:func:`torchrun_apps_beside_single`). One card's four processes run
#: over host-staged gloo, so the wall shows the transport; the orders are
#: cut to where it still does.
MP_TORCHRUN = (
    ("miniapp_gen_to_std", ("-m", "4096", "-b", "256", "--type", "z"),
     "BASELINE config #3's type and block at half its order"),
    ("miniapp_reduction_to_band", ("-m", "8192", "-b", "512", "--band-size", "128", "--type",
                                   "d"),
     "config #4's widths at half its order on 2x2, not its 4x4 (sixteen gloo processes on one "
     "card are not a grid worth timing)"),
    ("miniapp_gen_eigensolver", ("-m", "2048", "-b", "256", "--type", "d"), "f64"))


#: The 2x2 grid of the ``torchrun`` launches, one warm-up and one timed run.
_MP_GRID = ("--grid-rows", "2", "--grid-cols", "2", "--share-device", "--nruns", "1",
            "--nwarmups", "1")


def _beside_single(card, app, args, what, out: str, took: float, grid, with_what: str):
    """Check one ``torchrun`` miniapp's output ``out`` (one ``check:
    PASSED``, one run line), run the single controller on the same
    arguments and grid in this process, and print both walls."""
    import importlib
    import re

    walls = [float(m.group(1)) for m in re.finditer(r"^\[\d+\] ([0-9.]+)s ", out, re.M)]
    if out.count("check: PASSED") != 1 or len(walls) != 1:
        raise AssertionError(f"torchrun {app}: expected one 'check: PASSED' and one run line")
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        single = importlib.import_module(f"dlaf_tpu_torch.miniapp.{app}").run([*args, *grid])
    print(f"[wall] mp torchrun {app} {' '.join(args)}: processes {took:.1f} s, single "
          f"controller {time.perf_counter() - t:.1f} s", flush=True)
    sc = min(r["time_s"] for r in single)
    print(f"[mp] torchrun 4 processes {app} {' '.join(args)} 2x2 --share-device (gloo; {what}): "
          f"wall {walls[0]:.6f} s; single controller on the same grid in this call "
          f"{sc:.6f} s, ratio {walls[0] / sc:.2f} ({took:.1f} s with {with_what}) "
          f"[{card}] (four processes on one card, host-staged gloo: not a multi-card "
          "measurement)", flush=True)


def torchrun_beside_single(card, app, args, what, env, app_args=()) -> None:
    """``app`` under ``torchrun`` with 4 processes on 2x2 sharing this
    card (gloo), one warm-up and one timed run, its one ``check:
    PASSED`` required; then the single controller's run of the same
    arguments on the same grid in this process, and both walls."""
    grid = (*_MP_GRID, *app_args)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", "-m", f"dlaf_tpu_torch.miniapp.{app}", *args, *grid, "--check-result", "last"]
    t = time.perf_counter()
    out = _run_group(cmd, 900, env)
    print(out, end="", flush=True)
    _beside_single(card, app, args, what, out, time.perf_counter() - t, grid,
                   "start-up and check")


#: Room bought in this run for cells added where the script had none
#: (what was cut -> seconds), printed beside those cells' walls.
ROOM: dict = {}


def _torchrun_apps(spec: str) -> int:
    """``torchrun``'s target for :func:`torchrun_apps_beside_single`, in
    each of the launch's processes: bring the world up once, as a
    miniapp's ``select_grid`` does, run each miniapp of ``spec`` (JSON:
    ``[[app, argv], ...]``) in it in turn, its ``select_grid`` joining
    the world that is up, then leave the world. Process 0 prints
    ``[torchrun-app] begin|end <app> <epoch seconds>`` around each."""
    import importlib

    from dlaf_tpu_torch.comm import multihost

    multihost.initialize_multihost(backend="gloo")
    bring_up = multihost.initialize_multihost
    # a second bring-up raises, and a world left and brought up again under
    # one launch reuses its store's keys: the miniapps join this one
    multihost.initialize_multihost = lambda **kw: None
    printer = os.environ.get("RANK", "0") == "0"
    try:
        for app, argv in json.loads(spec):
            if printer:
                print(f"[torchrun-app] begin {app} {time.time():.6f}", flush=True)
            importlib.import_module(f"dlaf_tpu_torch.miniapp.{app}").run(argv)
            if printer:
                print(f"[torchrun-app] end {app} {time.time():.6f}", flush=True)
    finally:
        multihost.initialize_multihost = bring_up
        multihost.finalize_multihost()
    return 0


def torchrun_apps_beside_single(card, apps, env, app_args=()) -> None:
    """The miniapps ``apps`` (:data:`MP_TORCHRUN`) under ONE ``torchrun``
    launch of 4 processes on 2x2 sharing this card (gloo): the launch's
    start-up and shutdown are paid once, not once an app (the room they
    buy goes to :data:`ROOM`). Each app runs one warm-up and one timed
    run, its one ``check: PASSED`` required; then the single controller's
    run of the same arguments on the same grid in this process, and both
    walls, as :func:`torchrun_beside_single` prints them."""
    import re

    grid = (*_MP_GRID, *app_args)
    spec = json.dumps([[app, [*args, *grid, "--check-result", "last"]]
                       for app, args, _ in apps])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", os.path.abspath(__file__), "--torchrun-apps", spec]
    t_launch = time.time()
    out = _run_group(cmd, 900, env)
    t_exit = time.time()
    print(out, end="", flush=True)
    marks = {(m.group(1), m.group(2)): float(m.group(3)) for m in
             re.finditer(r"^\[torchrun-app\] (begin|end) (\S+) ([0-9.]+)$", out, re.M)}
    sections = re.split(r"^\[torchrun-app\] begin \S+ [0-9.]+$", out, flags=re.M)[1:]
    if len(sections) != len(apps) or len(marks) != 2 * len(apps):
        raise AssertionError(f"torchrun {[a for a, _, _ in apps]}: {len(sections)} apps began, "
                             f"{len(marks)} marks, expected {len(apps)} and {2 * len(apps)}")
    for (app, args, what), text in zip(apps, sections):
        _beside_single(card, app, args, what, text, marks["end", app] - marks["begin", app],
                       grid, "warm-up and check")
    start = marks["begin", apps[0][0]] - t_launch
    stop = t_exit - marks["end", apps[-1][0]]
    ROOM["torchrun start-ups"] = (len(apps) - 1) * (start + stop)
    print(f"[mp] torchrun {len(apps)} miniapps in one launch: {t_exit - t_launch:.1f} s, its "
          f"start-up {start:.1f} s and shutdown {stop:.1f} s paid once, not {len(apps)} times: "
          f"about {ROOM['torchrun start-ups']:.1f} s of room bought", flush=True)


def multiprocess_phase(torch, card, launches, device: str = "cuda:0", n: int = MP_N,
                       nb: int = MP_NB, big=("-m", "4096", "-b", "256"),
                       app_args=()) -> None:
    """The multi-process form on this card (module docstring, the
    multi-process phase); fails on any disagreement. ``device``, the
    sizes and ``app_args`` (extra miniapp arguments) let a CPU rehearsal
    run it small (with :data:`MP_TORCHRUN` made small first)."""
    import re
    import tempfile

    from dlaf_tpu_torch.analysis.graphcheck import schedule_findings
    from dlaf_tpu_torch.comm.grid import shared_grid

    # the processes share the card with this one: hand back what its
    # allocator caches from the earlier phases
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    # the single controller's factors, solve and launch counts on 2x2
    grid = shared_grid(2, 2, torch.device(device))
    ref, sc_walls = {}, {}
    for name, kind, letter, knobs in MP_CASES:
        t0 = time.perf_counter()
        ref[name] = _mp_case(kind, letter, knobs, grid, n, nb)
        sc_walls[name] = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="dlaf_mp_")
    ctx = torch.multiprocessing.get_context("spawn")
    sched_n = min(n, MP_SCHEDULE_N)
    procs = [ctx.Process(target=_mp_rank,
                         args=(i, 4, os.path.join(tmp, "rdv"), tmp, device, n, nb, sched_n))
             for i in range(4)]
    t = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + 600
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 1))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung or any(p.exitcode for p in procs):
        raise AssertionError(f"multi-process: exit codes {[p.exitcode for p in procs]}"
                             f"{' (killed at the 600 s timeout)' if hung else ''}")
    print(f"[mp] 4 spawned processes (2x2, {device} each, gloo) ran {len(MP_CASES)} calls at "
          f"N={n} nb={nb}, then each again at N={sched_n} under an armed tape for its verb "
          f"schedule{f' (N cut from {n} for room)' if sched_n < n else ''}, in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for name, kind, letter, knobs in MP_CASES:
        want_shards, want_counts, want_arrays = ref[name]
        got = [torch.load(os.path.join(tmp, f"{name}.r{i}.pt")) for i in range(4)]
        counts = {k: sum(g["counts"].get(k, 0) for g in got) for k in want_counts}
        same, worst = _mp_compare(torch, got, want_shards, want_arrays)
        live = {k: v for k, v in counts.items() if v}
        sc = {k: v for k, v in want_counts.items() if v}
        note = ""
        if name == "red2band-d-mxu" and device != "cpu":
            # #6 exactly: M's partial product once per grid row on the
            # shared card, once per rank in the processes
            for shared, have in ((True, want_counts), (False, counts)):
                f = red2band_mxu_launches(2, 2, n, 2 * nb, nb // 2, shared=shared)
                if have["ozaki_product"] != f:
                    raise AssertionError(f"red2band-d-mxu: #6 {have['ozaki_product']}, "
                                         f"formula {f} (shared={shared})")
        per_rank = counts
        if counts != want_counts and kind in ("red2band", "eigensolver", "gen_eigensolver"):
            # a value every rank of a grid line holds alike is formed once
            # per device by the single controller, once per rank (process)
            # here: its launches with that sharing off must be the sum
            per_rank = _mp_unshared_counts(grid, kind, letter, knobs, n, nb)
            note += (f"; single controller with per-rank forming "
                     f"{ {k: v for k, v in per_rank.items() if v} } (cc.per_rank_once "
                     "shares a grid line's value among the ranks on one device)")
        print(f"[wall] mp {name}: single controller {sc_walls[name]:.1f} s, the slowest "
              f"process {max(g['wall'] for g in got):.1f} s", flush=True)
        print(f"[mp] {name:14s} shards{' and ' + '/'.join(want_arrays) if want_arrays else ''}"
              f" bitwise equal to the single controller's: {same}"
              f"{'' if same else f' (max rel diff {worst:.3e})'}{note}; launches summed over "
              f"the processes {live}, single controller {sc}", flush=True)
        if not same:
            raise AssertionError(f"multi-process {name}: shards differ from the single "
                                 f"controller's (max rel diff {worst:.3e})")
        if counts != per_rank:
            raise AssertionError(f"multi-process {name}: launches {counts}, single "
                                 f"controller {want_counts}, with per-rank forming {per_rank}")
        if kind == "eigensolver" and device != "cpu" and not counts.get("givens_undo"):
            raise AssertionError(f"multi-process {name}: the D&C on rank (0, 0)'s process "
                                 "launched no Givens undo")
        for k, v in counts.items():
            launches[k] += v
        # the processes' verb schedules agree within every group
        schedules = {tuple(g["grid_rank"]): g["schedule"] for g in got}
        bad = schedule_findings(schedules, (2, 2), name=name)
        verbs = {r: len(v) for r, v in sorted(schedules.items())}
        print(f"[analysis] mp {name}: verbs per process {verbs}, graph-conditional-collective "
              f"findings {len(bad)}", flush=True)
        if bad or len(schedules) != 4 or not any(verbs.values()):
            raise AssertionError(f"multi-process {name}: verb schedules {verbs}: "
                                 f"{[str(f) for f in bad]}")
    del ref, grid
    shutil.rmtree(tmp, ignore_errors=True)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    # the user's launch: torchrun, one process per rank, sharing this card
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root, "GLOO_SOCKET_IFNAME": "lo"}
    # float32 only: the spawned processes above hold the float64 Cholesky
    # bitwise, and a second launch costs mostly its start-up
    torchrun_beside_single(card, "miniapp_cholesky", (*big, "--type", "s"), "the Cholesky",
                           env, app_args)
    torchrun_apps_beside_single(card, MP_TORCHRUN, env, app_args)
    visible = torch.cuda.device_count()
    if visible < 4:
        print(f"[mp] NCCL form not run: {visible} visible card(s); NCCL refuses two ranks on "
              "one card, so the form needs one card per rank (4 for 2x2)", flush=True)
        return
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", "-m", "dlaf_tpu_torch.miniapp.miniapp_cholesky", "-m", "16384", "-b", "256",
           "--grid-rows", "2", "--grid-cols", "2", "--type", "s", "--nruns", "2",
           "--check-result", "last"]
    out = _run_group(cmd, 600, env)
    print(out, end="", flush=True)
    walls = [float(m.group(1)) for m in re.finditer(r"^\[\d+\] ([0-9.]+)s ", out, re.M)]
    if out.count("check: PASSED") != 1 or not walls:
        raise AssertionError("torchrun NCCL miniapp_cholesky: no 'check: PASSED' line")
    print(f"[mp] NCCL 4 processes on 4 cards N=16384 nb=256 2x2 type s: best wall "
          f"{min(walls):.6f} s [{card}]", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--torchrun-apps"]:
        return _torchrun_apps(sys.argv[2])
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import numpy as np

    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.common.index2d import TileElementSize
    from dlaf_tpu_torch.health.info import local_factor_info
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp import miniapp_cholesky
    from dlaf_tpu_torch.tile_ops import cuda_build as cb
    from dlaf_tpu_torch.tile_ops import givens_kernels as gk
    from dlaf_tpu_torch.tile_ops import ozaki as oz
    from dlaf_tpu_torch.tile_ops import ozaki_kernels as ok
    from dlaf_tpu_torch.tile_ops import panel_kernels as pk
    from dlaf_tpu_torch.tile_ops import update_kernels as uk

    # every phase but the resilience phase runs strict: a degradation
    # raises (here and in the processes the script starts), and the
    # registry's tally is read before the resilience phase
    os.environ["DLAF_STRICT"] = "1"
    # the miniapps' checks (here and in the processes the script starts)
    # compute the exact residuals
    os.environ["DLAF_ACCURACY"] = "full"
    config.initialize()
    card = smi_line()
    print(f"[card] {card}", flush=True)
    print(f"[versions] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    libs = (pk.LIBRARY, ok.LIBRARY, uk.LIBRARY, gk.LIBRARY)
    cb.build_all(libs)
    for lib in libs:
        lib.load()
    print(f"[build] panel, ozaki, update and givens kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s ({', '.join(lib.path() for lib in libs)})",
          flush=True)
    if all(lib.log for lib in libs):   # built here, not found earlier
        ptxas_report(libs,
                     ("potrf_kernelIf", "potrf_kernelI13__nv_bfloat16", "trinv_kernelIf",
                      "trinv_kernelI13__nv_bfloat16", "slice_fold_kernel",
                      "masked_update_kernelIf", "masked_update_kernelI13__nv_bfloat16",
                      "plan_kernel", "givens_undo_kernel",
                      *(f"{k}_kernelI{t}Li{tm}E" for k in ("strip", "slab")
                        for t in ("f", "13__nv_bfloat16") for tm in (8, 4, 2, 1))))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261016)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    def hpd(d):
        x = randn(d, d)
        return x @ x.T + d * torch.eye(d, device=dev)

    launches = {k: 0 for k in (*pk.LAUNCHES, *ok.LAUNCHES, *uk.LAUNCHES, *gk.LAUNCHES)}

    def drive(argv, n, nb, nfact, expect, app=miniapp_cholesky):
        """One miniapp run; checks its residual line and launch counts and
        returns its fastest timed factorization (solve) (s). The Givens
        undo's launches follow the data: added up, not checked."""
        pk.reset_launches()
        ok.reset_launches()
        uk.reset_launches()
        gk.reset_launches()
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = app.run(argv)
        torch.cuda.synchronize()
        counts = {**pk.LAUNCHES, **ok.LAUNCHES, **uk.LAUNCHES}
        out = buf.getvalue()
        print(out, end="", flush=True)
        nt = -(-n // nb)
        want = {k: expect.get(k, lambda nt: 0)(nt) * nfact for k in counts}
        print(f"[main] launches {counts} expected {want} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
        if "check: PASSED" not in out:
            raise AssertionError("main path: no 'check: PASSED' line")
        if counts != want:
            raise AssertionError(f"main path: launches {counts}, expected {want}")
        for k, v in {**counts, **gk.LAUNCHES}.items():
            launches[k] += v
        return min(r["time_s"] for r in res)

    kmods = (pk, ok, uk, gk)
    artifacts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "smoke_artifacts")

    # ---- phase 1: kernels against their plain versions -------------------
    t_phase = time.perf_counter()
    d, m = 256, 16384 - 256
    rows = {}

    def tol_of(dt, d):
        # f32: different summation order, c*d*eps with c=8 (the reference's
        # fused-vs-composed parity bound); bf16: two ulps of the output type
        return 8 * d * EPS["float32"] if dt == torch.float32 else 2 * EPS["bfloat16"]

    def check(name, case, pairs, dt, d):
        tol = tol_of(dt, d)
        worst_abs, worst_rel = 0.0, 0.0
        for got, ref in pairs:
            a, r = rel_err(torch, got, ref)
            worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        ok_ = worst_rel <= tol
        print(f"[kernel] {name:12s} {case:34s} max_abs_err={worst_abs:.3e} "
              f"rel_err={worst_rel:.3e} tol={tol:.1e} {'ok' if ok_ else 'FAIL'}", flush=True)
        if not ok_:
            raise AssertionError(f"{name} {case}: rel_err {worst_rel} > {tol}")
        return worst_abs

    for dt in (torch.float32, torch.bfloat16):
        tname = str(dt).split(".")[1]
        for dd, mm in ((d, m), (200, 1000)):
            case = f"{tname} d={dd} m={mm}"
            diag, strip = hpd(dd).to(dt), randn(mm, dd).to(dt)
            slab = randn(mm, min(dd, mm)).to(dt)
            for uplo in ("L", "U"):
                dg = diag if uplo == "L" else diag.mT.contiguous()
                err = check("potrf", f"{case} uplo={uplo}",
                            [(pk.potrf(uplo, dg), pk.potrf_plain(uplo, dg))], dt, dd)
                if (dt, dd, uplo) == (torch.float32, d, "L"):
                    rows["potrf"] = {"max_abs_err": err}
            fac = pk.potrf_plain("L", diag)
            # unit-diagonal case: the factor scaled to a unit diagonal, which
            # keeps the solve well conditioned
            unit = (fac.float() / torch.diagonal(fac.float())[None, :]).to(dt)
            for combo, b in ((("R", "L", "C", "N"), strip),
                             (("L", "U", "C", "N"), strip.mT.contiguous()),
                             (("L", "L", "N", "U"), strip.mT.contiguous())):
                t = {"L": unit if combo[3] == "U" else fac, "U": fac.mT.contiguous()}[combo[1]]
                err = check("solve", f"{case} {''.join(combo)}",
                            [(pk.panel_solve(*combo, t, b), pk.panel_solve_plain(*combo, t, b))],
                            dt, dd)
                if (dt, dd, combo[0]) == (torch.float32, d, "R"):
                    rows["solve"] = {"max_abs_err": err}
            for uplo in ("L", "U"):
                args = ((diag, strip, slab) if uplo == "L"
                        else (diag.mT.contiguous(), strip.mT.contiguous(), slab.mT.contiguous()))
                got, ref = pk.step(uplo, *args), pk.step_plain(uplo, *args)
                err = check("step", f"{case} uplo={uplo}", list(zip(got, ref)), dt, dd)
                if (dt, dd, uplo) == (torch.float32, d, "L"):
                    rows["step"] = {"max_abs_err": err}
                got = pk.factor_solve(uplo, *args[:2])
                ref = pk.factor_solve_plain(uplo, *args[:2])
                err = check("factor_solve", f"{case} uplo={uplo}", list(zip(got, ref)), dt, dd)
                if (dt, dd, uplo) == (torch.float32, d, "L"):
                    rows["factor_solve"] = {"max_abs_err": err}
            batch = randn(5, dd, dd).to(dt)
            for uplo in ("L", "U"):
                dg = diag if uplo == "L" else diag.mT.contiguous()
                got, ref = pk.factor_solve(uplo, dg, batch), pk.factor_solve_plain(uplo, dg, batch)
                check("factor_solve", f"{case} batch (5,{dd},{dd}) uplo={uplo}",
                      list(zip(got, ref)), dt, dd)
    # potrf alone at every edge of its micro-panel pairing (d = 1 .. 256)
    for dt in (torch.float32, torch.bfloat16):
        tname = str(dt).split(".")[1]
        for dd in (256, 200, 129, 64, 9, 8, 1):
            diag = hpd(dd).to(dt)
            for uplo in ("L", "U"):
                dg = diag if uplo == "L" else diag.mT.contiguous()
                check("potrf", f"{tname} d={dd} uplo={uplo}",
                      [(pk.potrf(uplo, dg), pk.potrf_plain(uplo, dg))], dt, dd)
    # the triangular inverse through the strip solve at every edge of its
    # doubling levels and 8-row blocks, both diagonals and both triangles
    for dt in (torch.float32, torch.bfloat16):
        tname = str(dt).split(".")[1]
        for dd in (256, 200, 129, 64, 9, 8, 1):
            fac = pk.potrf_plain("L", hpd(dd)).float()
            b = randn(300, dd).to(dt)
            for diag_kind in ("N", "U"):
                # unit: the factor scaled to a unit diagonal (well conditioned)
                low = fac if diag_kind == "N" else fac / torch.diagonal(fac)[None, :]
                for uplo in ("L", "U"):
                    t = (low if uplo == "L" else low.mT.contiguous()).to(dt)
                    combo = ("R", uplo, "C", diag_kind)
                    check("solve", f"{tname} d={dd} {''.join(combo)}",
                          [(pk.panel_solve(*combo, t, b), pk.panel_solve_plain(*combo, t, b))],
                          dt, dd)
    # a NaN pivot in the triangle: the solved strip's NaN columns are the
    # plain version's (uplo L: from the pivot's column on, none before;
    # uplo U takes the inverse's columns, NaN up to the pivot's 8-block end)
    for dd in (256, 200):
        b = randn(300, dd)
        for piv in (1, 8, 9, 38, dd):
            fac = pk.potrf_plain("L", hpd(dd)).float()
            fac[piv - 1, piv - 1] = float("nan")
            for uplo in ("L", "U"):
                t = fac if uplo == "L" else fac.mT.contiguous()
                got = pk.panel_solve("R", uplo, "C", "N", t, b)
                ref = pk.panel_solve_plain("R", uplo, "C", "N", t, b)
                rel_err(torch, got, ref)   # raises when the non-finite patterns differ
                cols_k, cols_p = torch.isnan(got).any(0), torch.isnan(ref).any(0)
                want = torch.arange(dd, device=dev) >= piv - 1
                if not (torch.equal(cols_k, cols_p)
                        and (uplo == "U" or torch.equal(cols_k, want))):
                    raise AssertionError(f"solve d={dd} NaN pivot {piv} uplo={uplo}: NaN "
                                         "columns differ")
                print(f"[kernel] solve        NaN pivot d={dd} at {piv} uplo={uplo}: NaN "
                      f"columns {int(cols_k.sum())} kernel = plain", flush=True)
    # indefinite tiles: the failing column and the whole NaN pattern must
    # match, through the factor alone and the two entries that factor
    # first; pivots at the edges of micro-panels and pairs, and an exactly
    # zero pivot (a zero row and column)
    for dd in (256, 200):
        strip, slab = randn(300, dd), randn(300, dd)
        for piv in (1, 8, 9, 38, dd, "zero"):
            bad = hpd(dd)
            if piv == "zero":
                bad[37, :] = 0.0
                bad[:, 37] = 0.0
            else:
                bad[piv - 1, piv - 1] = -1000.0
            want = 38 if piv == "zero" else piv
            for name, got, ref in (("potrf", (pk.potrf("L", bad),), (pk.potrf_plain("L", bad),)),
                                   ("step", pk.step("L", bad, strip, slab),
                                    pk.step_plain("L", bad, strip, slab)),
                                   ("factor_solve", pk.factor_solve("L", bad, strip),
                                    pk.factor_solve_plain("L", bad, strip))):
                info_k, info_p = int(local_factor_info(got[0])), int(local_factor_info(ref[0]))
                for g, r in zip(got, ref):
                    rel_err(torch, g, r)   # raises when the non-finite patterns differ
                    if not torch.equal(torch.isnan(g.float()), torch.isnan(r.float())):
                        raise AssertionError(f"{name} d={dd} pivot {piv}: NaN masks differ")
                print(f"[kernel] {name:12s} indefinite d={dd} pivot {piv}: info kernel={info_k} "
                      f"plain={info_p}, NaN masks equal", flush=True)
                if not info_k == info_p == want:
                    raise AssertionError(f"{name} d={dd} pivot {piv}: info kernel={info_k} "
                                         f"plain={info_p}, expected {want}")
    torch.cuda.synchronize()
    panel_products(torch, dev, randn, hpd, check, pk, cb)
    givens_checks(torch, dev, gk)

    # Ozaki slice kernels: bit for bit against the plain versions, on the
    # slices of random float64 operands
    def slices(x, dim, s=8):
        sc = oz._scale(x, dim)
        return torch.stack(oz._peel_slices(oz._normalize(x, sc), s))

    # main path, then ragged tiles (M, N not multiples of the 128-row tile,
    # syrk m not a multiple of its 256-row block), every K edge of a
    # 128-byte stage (K=200 is padded to 224), and 1, 2, 8 and 9 slices
    for case, (mm, nn, kk, s) in (("main path", (m, d, d, 8)), ("ragged", (1000, 200, 200, 8)),
                                  ("K=1024", (600, 300, 1024, 8)), ("K=32 s=1", (300, 130, 32, 1)),
                                  ("K=224 s=2", (333, 257, 200, 2)), ("s=9", (129, 77, 256, 9)),
                                  ("K=1024 s=9", (1000, 200, 1024, 9)),
                                  ("K=224 s=9", (513, 9, 200, 9))):
        a, b = randn(mm, kk, dtype=torch.float64), randn(kk, nn, dtype=torch.float64)
        ia, ib = slices(a, -1, s), slices(b, -2, s)
        for name, got, ref in (("ozaki_product", ok.ozaki_product(ia, ib),
                                ok.ozaki_product_plain(ia, ib)),
                               ("ozaki_syrk", ok.ozaki_syrk(ia), ok.ozaki_syrk_plain(ia))):
            same = all(torch.equal(g, r) for g, r in zip(got, ref))
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            shape = f"{mm}x{nn}" if name == "ozaki_product" else f"{mm}x{mm}"
            print(f"[kernel] {name:12s} {case} s={s} {shape} K={kk}: hi and lo "
                  f"{'bitwise equal' if same else 'DIFFER'} (max_abs_err={err:.3e})", flush=True)
            if not same:
                raise AssertionError(f"{name} {case}: not bitwise equal to its plain version")
            if case == "main path":
                rows[name] = {"max_abs_err": err}
    torch.cuda.synchronize()

    # times at the main path's shapes (float32 panels d=256, strip m=16128;
    # Ozaki slices s=8 of (16128, 256) and (256, 256) float64 operands)
    diag, strip, slab = hpd(d), randn(m, d), randn(m, d)
    fac = pk.potrf_plain("L", diag)
    lfac = torch.tril(fac)
    s = 8
    a64, b64 = randn(m, d, dtype=torch.float64), randn(d, d, dtype=torch.float64)
    ia, ib = slices(a64, -1), slices(b64, -2)

    def step_library():
        l = torch.linalg.cholesky(diag)
        p = torch.linalg.solve_triangular(l.mH, strip, upper=True, left=False)
        return slab - torch.tril(p @ p[:d].mH)

    def factor_solve_library():
        l = torch.linalg.cholesky(diag)
        return torch.linalg.solve_triangular(l.mH, strip, upper=True, left=False)

    # syrk work: only the 256-row blocks on and below the block diagonal
    blk = torch.arange(m) // ok.SYRK_BLOCK
    lower_cells = float((blk[None, :] <= blk[:, None]).sum())
    pairs = s * (s + 1) / 2
    w = d
    # name: (kernel, plain, library call, its label, composed (not a single
    # call: printed, left out of library_ms), bytes, ops, peak kind)
    timings = {
        "potrf": (lambda: pk.potrf("L", diag), lambda: pk.potrf_plain("L", diag),
                  lambda: torch.linalg.cholesky(diag), "torch.linalg.cholesky", False,
                  2 * d * d * 4, d ** 3 / 3, "float32"),
        "solve": (lambda: pk.panel_solve("R", "L", "C", "N", fac, strip),
                  lambda: pk.panel_solve_plain("R", "L", "C", "N", fac, strip),
                  lambda: torch.linalg.solve_triangular(lfac.mH, strip, upper=True, left=False),
                  "torch.linalg.solve_triangular", False,
                  (d * d + 2 * m * d) * 4, m * d * d, "float32"),
        "factor_solve": (lambda: pk.factor_solve("L", diag, strip),
                         lambda: pk.factor_solve_plain("L", diag, strip), factor_solve_library,
                         "composed cholesky+solve_triangular", True,
                         (2 * d * d + 2 * m * d) * 4, d ** 3 / 3 + m * d * d, "float32"),
        "step": (lambda: pk.step("L", diag, strip, slab),
                 lambda: pk.step_plain("L", diag, strip, slab), step_library,
                 "composed cholesky+solve_triangular+masked matmul", True,
                 (2 * d * d + 2 * m * d + 2 * m * w) * 4,
                 d ** 3 / 3 + m * d * d + 2 * d * (m * w - w * (w - 1) / 2), "float32"),
        "ozaki_product": (lambda: ok.ozaki_product(ia, ib), lambda: ok.ozaki_product_plain(ia, ib),
                          lambda: a64 @ b64, "float64 torch.matmul", False,
                          s * (m + d) * d + 8 * m * d, pairs * 2 * m * d * d, "int8"),
        "ozaki_syrk": (lambda: ok.ozaki_syrk(ia), lambda: ok.ozaki_syrk_plain(ia),
                       lambda: a64 @ a64.mT, "float64 torch.matmul a@a.T", False,
                       s * m * d + 8 * m * m, pairs * 2 * lower_cells * d, "int8"),
    }
    for name, (kern, plain, lib, label, composed, nbytes, ops, kind) in timings.items():
        lib_ms = time_ms(torch, lib)
        bms, by = bound(nbytes, ops, kind)
        rows[name].update(ms=time_ms(torch, kern), batch_ms=batch_ms(torch, kern),
                          plain_ms=time_ms(torch, plain, reps=10),
                          library_ms=None if composed else lib_ms, bound_ms=bms, bound_by=by)
        r = rows[name]
        print(f"[time] {name:13s} kernel={r['ms']:.4f} ms (batched {r['batch_ms']:.4f} ms) "
              f"plain={r['plain_ms']:.4f} ms {label}={lib_ms:.4f} ms bound={bms:.5f} ms ({by}) "
              f"[{card}]", flush=True)
    # the whole wrappers around the slice kernels (scale, peel, kernel,
    # hi + lo, mirror, scales), beside the same float64 library products
    config.initialize(argv=["--dlaf:ozaki-impl=pallas"])
    print(f"[time] matmul_f64 wrapper (16128x256 @ 256x256) "
          f"{time_ms(torch, lambda: oz.matmul_f64(a64, b64)):.4f} ms; syrk_f64 wrapper "
          f"(16128x256) {time_ms(torch, lambda: oz.syrk_f64(a64), reps=10):.4f} ms [{card}]",
          flush=True)
    del ia, ib, a64, b64
    dist_kernels(torch, dev, randn, rows, check, time_ms, bound, card, uk, ok, oz)
    print(f"[phase] kernels {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 2: the main paths through the miniapp ---------------------

    t_phase = time.perf_counter()
    drive(["-m", "16384", "-b", "256", "--type", "s", "--uplo", "L",
           "--dlaf:step-impl=fused", "--dlaf:cholesky-lookahead=1",
           "--nruns", "2", "--nwarmups", "1", "--check-result", "last"],
          16384, 256, 3, {"step": lambda nt: nt - 1, "potrf": lambda nt: 1})
    drive(["-m", "8192", "-b", "256", "--type", "s", "--uplo", "U",
           "--dlaf:panel-impl=fused", "--dlaf:step-impl=xla",
           "--nruns", "2", "--nwarmups", "1", "--check-result", "last"],
          8192, 256, 3, {"potrf": lambda nt: nt, "solve": lambda nt: nt - 1})
    # f64 "ozaki": per strip-bearing step the panel product and the
    # next-column strip product, and the rest-syrk where rows remain
    drive(["-m", "16384", "-b", "256", "--type", "d", "--uplo", "L",
           "--dlaf:cholesky-trailing=ozaki", "--dlaf:ozaki-impl=pallas",
           "--dlaf:cholesky-lookahead=1",
           "--nruns", "1", "--nwarmups", "1", "--check-result", "last"],
          16384, 256, 2, {"ozaki_product": lambda nt: 2 * (nt - 1),
                          "ozaki_syrk": lambda nt: nt - 2})
    # complex128: 4 products for the panel, 2 syrks + 1 product per herk;
    # ozaki_impl=auto resolves to the kernels on cuda
    drive(["-m", "4096", "-b", "256", "--type", "z", "--uplo", "U",
           "--dlaf:cholesky-trailing=ozaki", "--dlaf:cholesky-lookahead=0",
           "--nruns", "2", "--nwarmups", "1", "--check-result", "last"],
          4096, 256, 3, {"ozaki_product": lambda nt: 5 * (nt - 1),
                         "ozaki_syrk": lambda nt: 2 * (nt - 1)})
    # scan: one fused factor+solve per uniform step, the last included
    drive(["-m", "8192", "-b", "256", "--type", "s", "--uplo", "L",
           "--dlaf:cholesky-trailing=scan", "--dlaf:step-impl=fused",
           "--dlaf:cholesky-lookahead=1",
           "--nruns", "2", "--nwarmups", "1", "--check-result", "last"],
          8192, 256, 3, {"factor_solve": lambda nt: nt})
    print(f"[phase] main path {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 2b: the distributed Cholesky, every rank on this card -----
    # Launches per factorization: each kernel once per rank per step with
    # a trailing update (k < nt-1; the uniform slots keep every rank in
    # every such step), the diagonal tile's factor on every rank.
    t_phase = time.perf_counter()
    share = ["--share-device", "--nruns", "2", "--nwarmups", "1", "--check-result", "last"]
    dist_walls = {}
    for name, argv, n, ranks, letter, expect in (
            ("dist-L", ["--type", "s", "--uplo", "L", "--grid-rows", "2", "--grid-cols", "2",
                        "--dlaf:step-impl=fused"], 16384, 4, "s",
             {"factor_solve": lambda nt: 4 * (nt - 1), "potrf": lambda nt: 4,
              "masked_trailing_update": lambda nt: 4 * (nt - 1)}),
            ("dist-U", ["--type", "s", "--uplo", "U", "--grid-rows", "2", "--grid-cols", "4",
                        "--dlaf:panel-impl=fused", "--dlaf:step-impl=xla"], 8192, 8, "s",
             {"potrf": lambda nt: 8 * nt, "solve": lambda nt: 8 * (nt - 1),
              "masked_trailing_update": lambda nt: 8 * (nt - 1)}),
            # the panel product on every rank and the look-ahead column on
            # the two ranks that own it: slice products; the bulk: the pair
            # kernel
            ("dist-f64", ["--type", "d", "--uplo", "L", "--grid-rows", "2", "--grid-cols", "2",
                          "--dlaf:f64-gemm=mxu", "--dlaf:f64-trsm=mixed"], 16384, 4, "d",
             {"ozaki_product": lambda nt: 6 * (nt - 1),
              "ozaki_masked_product": lambda nt: 4 * (nt - 1)}),
            ("dist-z", ["--type", "z", "--uplo", "U", "--grid-rows", "2", "--grid-cols", "2"],
             4096, 4, "z", {})):
        t = drive(["-m", str(n), "-b", "256", *argv, *share], n, 256, 3, expect)
        dist_walls[name] = t
        flops = n ** 3 / 3 * (4 if letter == "z" else 1)
        print(f"[dist] {name:8s} N={n} nb=256 {ranks} ranks on one card: {t:.6f} s "
              f"{flops / t / 1e9:.2f} GFlop/s [{card}] (collectives are device-local copies "
              "and every rank repeats the diagonal factor: not a communication measurement)",
              flush=True)
    print(f"[phase] distributed {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 2b': the multi-process form, one process per rank ---------
    t_phase = time.perf_counter()
    multiprocess_phase(torch, card, launches)
    print(f"[phase] multi-process {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 2c: the distributed scan Cholesky and the triangular solve
    # and multiply (config #2: double, m = n = 8192, nb=256, 2x2) ----------
    t_phase = time.perf_counter()
    scan_paths(torch, dev, card, drive, pk, ok, oz)
    print(f"[phase] scan and triangular {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 2d: HEGST (BASELINE config #3: complex128, N=8192, nb=256,
    # 2x2 on this card) and the QR T factor --------------------------------
    t_phase = time.perf_counter()
    hegst_paths(torch, dev, card, drive, ok)
    print(f"[phase] hegst {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    qr_phase(torch, dev, card)
    print(f"[phase] qr {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 2e: reduction to band (BASELINE config #4: float64,
    # N=16384, nb=512, band 128, 4x4 on this card) and the chase to a
    # tridiagonal, the pipeline's end-to-end eigenvalue check --------------
    t_phase = time.perf_counter()
    red2band_paths(torch, dev, card, drive, ok)
    print(f"[phase] red2band {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    b2t_paths(torch, dev, card, ok)
    print(f"[phase] band_to_tridiag {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 2f: the eigensolver: evp-d (config #4's shape), the other
    # eigensolver cells, the D&C's route sweep, the miniapp ---------------
    t_phase = time.perf_counter()
    evp_keep = evp_paths(torch, dev, card, (pk, ok, uk, gk), ok, launches)
    print(f"[phase] eigensolver {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    dc_route(torch, dev, card, gk, rows, launches, evp_keep["tridiag"],
             sharded=(evp_keep["eigenvalues"], evp_keep["stages"]["stage.tridiag_solver"]))
    print(f"[phase] dc-route {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    evp_miniapp(torch, drive, card)
    b2t_forms(torch, dev, card, evp_keep)
    print(f"[phase] eigensolver miniapp and bt_b2t forms {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- phase 2g: the rest of the algorithms layer (max_norm and permute
    # at config #4's shape, general_sub_multiply, the generalized miniapp)
    # and the serving entry point --------------------------------------
    t_phase = time.perf_counter()
    algos_phase(torch, dev, card, kmods, launches, drive)
    print(f"[phase] algos {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    serve_phase(torch, dev, card, kmods, launches)
    print(f"[phase] serve {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    fleet_phase(torch, dev, card, os.path.join(artifacts, "fleet"))
    print(f"[phase] fleet {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 2h: the telemetry core (obs): records off and on, the
    # profiler's names, the eigensolver's and the serve stream's artifacts
    # with the live exporter, one artifact per process under torchrun ----
    t_phase = time.perf_counter()
    obs_phase(torch, card, kmods, launches, os.path.join(artifacts, "obs"))
    print(f"[phase] obs {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    accuracy_phase(torch, card, kmods, launches, os.path.join(artifacts, "accuracy"))
    print(f"[phase] accuracy {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    autotune_phase(torch, card, kmods, launches, os.path.join(artifacts, "autotune"))
    print(f"[phase] autotune {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    devtrace_phase(torch, card, kmods, launches, os.path.join(artifacts, "devtrace"))
    print(f"[phase] devtrace {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    analysis_phase(torch, card, kmods, launches, os.path.join(artifacts, "analysis"))
    print(f"[phase] analysis {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 3: the float64 / complex128 routes "auto" picks from ------
    # the default (no knob) beside each route it could resolve to, uplo L,
    # lookahead as the default (1); launch counts per factorization
    t_phase = time.perf_counter()
    trail = "--dlaf:cholesky-trailing="
    oz_d = {"ozaki_product": lambda nt: 2 * (nt - 1), "ozaki_syrk": lambda nt: nt - 2}
    oz_z = {"ozaki_product": lambda nt: 8 * (nt - 1) + nt - 2,
            "ozaki_syrk": lambda nt: 2 * (nt - 2)}
    # scan: the panel product every step, the next-column strip on all but
    # the last, the deferred gram every step
    oz_scan = {"ozaki_product": lambda nt: 2 * nt - 1, "ozaki_syrk": lambda nt: nt}
    for letter, n, routes in (
            ("d", 16384, (("default", [], {}), ("biggemm", [trail + "biggemm"], {}),
                          ("loop", [trail + "loop"], {}),
                          ("ozaki jnp", [trail + "ozaki", "--dlaf:ozaki-impl=jnp"], {}),
                          ("ozaki kernels", [trail + "ozaki"], oz_d),
                          ("scan native", [trail + "scan"], {}),
                          ("scan mixed panels", [trail + "scan", "--dlaf:f64-trsm=mixed"], {}),
                          ("scan mixed+ozaki", [trail + "scan", "--dlaf:f64-trsm=mixed",
                                                "--dlaf:f64-gemm=mxu"], oz_scan))),
            ("z", 8192, (("default", [], {}), ("biggemm", [trail + "biggemm"], {}),
                         ("loop", [trail + "loop"], {}),
                         ("ozaki jnp", [trail + "ozaki", "--dlaf:ozaki-impl=jnp"], {}),
                         ("ozaki kernels", [trail + "ozaki"], oz_z)))):
        walls = {}
        for name, knobs, expect in routes:
            walls[name] = drive(["-m", str(n), "-b", "256", "--type", letter, "--uplo", "L",
                                 *knobs, "--nruns", "1", "--nwarmups", "1",
                                 "--check-result", "last"], n, 256, 2, expect)
        flops = n ** 3 / 3 * (4 if letter == "z" else 1)
        for name, t in walls.items():
            print(f"[route] {letter} N={n} nb=256 uplo L {name:18s} {t:.6f} s "
                  f"{flops / t / 1e9:.2f} GFlop/s [{card}]", flush=True)
        best = min((t, name) for name, t in walls.items() if name != "default")
        print(f"[route] {letter} N={n}: default {walls['default']:.6f} s, fastest listed route "
              f"{best[1]} {best[0]:.6f} s", flush=True)
        # the default resolves to one of the listed routes; a quarter of
        # slack covers the host's noise between two runs of the same route
        if walls["default"] > 1.25 * best[0]:
            raise AssertionError(f"{letter}: the default route is slower than {best[1]}")
    print(f"[phase] routes {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 4: small ragged factors against a float64 reference -------
    t_phase = time.perf_counter()
    t_case = t_phase
    rng = np.random.default_rng(7)
    x = rng.standard_normal((500, 500))
    a = x @ x.T + 500 * np.eye(500)
    ref = np.linalg.cholesky(a)
    for argv, dtype, tol in ((["--dlaf:step-impl=fused"], np.float32, 1e-5),
                             (["--dlaf:panel-impl=fused", "--dlaf:step-impl=xla"],
                              np.float32, 1e-5),
                             (["--dlaf:cholesky-trailing=scan", "--dlaf:step-impl=fused"],
                              np.float32, 1e-5),
                             (["--dlaf:cholesky-trailing=ozaki", "--dlaf:ozaki-impl=pallas"],
                              np.float64, 1e-12)):
        config.initialize(argv=argv)
        mat = Matrix.from_global(a.astype(dtype), TileElementSize(128, 128), device=dev)
        out, info = cholesky("L", mat, with_info=True)
        got = np.tril(out.to_numpy())
        err = np.abs(got - ref).max() / np.abs(ref).max()
        print(f"[small] n=500 nb=128 {np.dtype(dtype).name} {argv} info={int(info)} "
              f"rel_err={err:.3e} tol={tol:.0e} shape={got.shape}", flush=True)
        if not (np.isfinite(got).all() and int(info) == 0 and err < tol):
            raise AssertionError("small ragged factor disagrees with the float64 reference")
    t_case = _wall("small ragged factors", t_case)

    # the f64 default's and dist-scan-L's profiles went to make room for the
    # autotune phase (their last breakdowns: PERF.md §5)
    profile_factorization(torch, dev, ["--dlaf:step-impl=fused", "--dlaf:cholesky-lookahead=1"],
                          "f32", np.float32)
    profile_factorization(torch, dev, ["--dlaf:cholesky-trailing=ozaki",
                                       "--dlaf:ozaki-impl=pallas",
                                       "--dlaf:cholesky-lookahead=1"], "f64", np.float64)
    profile_factorization(torch, dev, ["--dlaf:step-impl=fused"], "dist-L f32", np.float32,
                          grid_shape=(2, 2))
    profile_factorization(torch, dev, ["--dlaf:panel-impl=fused", "--dlaf:step-impl=xla"],
                          "dist-U f32", np.float32, n=8192, grid_shape=(2, 4), uplo="U")
    profile_factorization(torch, dev, ["--dlaf:f64-gemm=mxu", "--dlaf:f64-trsm=mixed"],
                          "dist-f64", np.float64, grid_shape=(2, 2))
    t_case = _wall("profiles: factorizations", t_case)
    for mode in ("unrolled", "scan"):
        profile_trsm(torch, dev, mode)
    profile_red2band(torch, dev)
    profile_evp(torch, dev, evp_keep)
    del evp_keep
    _wall("profiles: trsm, red2band, evp-d", t_case)
    print(f"[phase] small factors and profiles {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 5: the resilience layer (strict off but where it checks
    # the raise), after the strict audit of every phase above ------------
    from dlaf_tpu_torch.health import registry

    tally = registry.fallback_counts()
    print(f"[resilience] strict: dlaf_fallback_total after every earlier phase (the "
          f"registry's tally): {sum(tally.values())} {tally}", flush=True)
    if tally:
        raise AssertionError(f"an earlier phase degraded: {tally}")
    resilience_phase(torch, dev, card, kmods, launches, drive, artifacts)

    order = (("potrf", "panel", "dlaf_tpu/tile_ops/pallas_panel.py:187"),
             ("solve", "panel", "dlaf_tpu/tile_ops/pallas_panel.py:296"),
             ("factor_solve", "panel", "dlaf_tpu/tile_ops/pallas_panel.py:442"),
             ("step", "panel", "dlaf_tpu/tile_ops/pallas_panel.py:508"),
             ("masked_trailing_update", "update", "dlaf_tpu/tile_ops/pallas_kernels.py:69"),
             ("ozaki_product", "ozaki", "dlaf_tpu/tile_ops/pallas_ozaki.py:133"),
             ("ozaki_masked_product", "ozaki", "dlaf_tpu/tile_ops/pallas_ozaki.py:208"),
             ("ozaki_syrk", "ozaki", "dlaf_tpu/tile_ops/pallas_ozaki.py:269"),
             # not a Pallas kernel: the reference's lax.scan of the rotations
             ("givens_undo", "givens", "dlaf_tpu/eigensolver/tridiag_solver.py:314"))
    kernels = [dict(name=name, route="cuda", source=f"dlaf_tpu_torch/csrc/{src}.cu",
                    replaces=rep, launches=launches[name], **rows[name])
               for name, src, rep in order]
    print(f"[wall] chip_smoke.py from its start {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
