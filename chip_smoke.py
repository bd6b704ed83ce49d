#!/usr/bin/env python3
"""Smoke test of the dlaf_tpu_torch port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written panel kernels (``dlaf_tpu_torch/csrc/panel.cu``)
from the checkout, holds each kernel against its plain PyTorch version on
the card (float32, bfloat16, a ragged tile, an indefinite tile), times the
kernel, the plain version and a PyTorch library yardstick with CUDA events,
then drives the port's main path through ``miniapp_cholesky.run``:

1. N=16384, nb=256, float32, uplo L, fused step route, lookahead 1;
2. N=8192, nb=256, float32, uplo U, fused panel route (potrf + strip solve).

It checks the residual lines and the kernels' launch counters of each run,
factors a small ragged matrix against a float64 reference, and prints a
JSON line of per-kernel numbers, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Any failure exits non-zero.
It needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time

#: Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s
#: and operations/s by input type (float32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}

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


def profile_factorization(torch, dev, n: int = 16384, nb: int = 256) -> None:
    """Where the time of one main-path factorization goes: device time by
    kernel from ``torch.profiler``, and the device's busy share of the
    host wall (informational; prints what the profiler saw)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from dlaf_tpu_torch import config
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.common.index2d import GlobalElementSize, TileElementSize
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp.generators import hpd_element_fn

    config.initialize(argv=["--dlaf:step-impl=fused", "--dlaf:cholesky-lookahead=1"])
    ref = Matrix.from_element_fn(hpd_element_fn(n, np.float32), GlobalElementSize(n, n),
                                 TileElementSize(nb, nb), dtype=np.float32, device=dev)
    cholesky("L", ref.with_storage(ref.storage.clone()), donate=True)
    mat = ref.with_storage(ref.storage.clone())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cholesky("L", mat, donate=True)
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
    print(f"[profile] n={n} nb={nb} f32 step route: host wall {wall_us / 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of wall)", flush=True)
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile] {tot / 1e3:9.3f} ms {cnt:6d} launches  {name}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.common.index2d import TileElementSize
    from dlaf_tpu_torch.health.info import local_factor_info
    from dlaf_tpu_torch.matrix.matrix import Matrix
    from dlaf_tpu_torch.miniapp import miniapp_cholesky
    from dlaf_tpu_torch.tile_ops import panel_kernels as pk

    card = smi_line()
    print(f"[card] {card}", flush=True)
    print(f"[versions] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    pk.build()
    pk._load()
    print(f"[build] panel kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({pk.library_path()})", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261016)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32)

    def hpd(d):
        x = randn(d, d)
        return x @ x.T + d * torch.eye(d, device=dev)

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
        ok = worst_rel <= tol
        print(f"[kernel] {name:6s} {case:34s} max_abs_err={worst_abs:.3e} "
              f"rel_err={worst_rel:.3e} tol={tol:.1e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
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
    # indefinite tile: the failing column and the NaN prefix must match
    bad = hpd(d)
    bad[37, 37] = -1000.0
    strip, slab = randn(m, d), randn(m, d)
    for name, got, ref in (("potrf", (pk.potrf("L", bad),), (pk.potrf_plain("L", bad),)),
                           ("step", pk.step("L", bad, strip, slab),
                            pk.step_plain("L", bad, strip, slab))):
        info_k, info_p = int(local_factor_info(got[0])), int(local_factor_info(ref[0]))
        for g, r in zip(got, ref):
            rel_err(torch, g, r)   # raises when the NaN patterns differ
        print(f"[kernel] {name:6s} indefinite tile (pivot 38 < 0)    info kernel={info_k} "
              f"plain={info_p} NaN patterns equal", flush=True)
        if not info_k == info_p == 38:
            raise AssertionError(f"{name}: info kernel={info_k} plain={info_p}, expected 38")
    torch.cuda.synchronize()

    # times at the main path's shapes (float32, d=256, strip m=16128)
    diag, strip, slab = hpd(d), randn(m, d), randn(m, d)
    fac = pk.potrf_plain("L", diag)
    lfac = torch.tril(fac)

    def step_library():
        l = torch.linalg.cholesky(diag)
        p = torch.linalg.solve_triangular(l.mH, strip, upper=True, left=False)
        return slab - torch.tril(p @ p[:d].mH)

    # bound inputs: float32 bytes (4 each), each input read once and each
    # output written once; operations of the work these inputs need
    w = d
    timings = {
        "potrf": (lambda: pk.potrf("L", diag), lambda: pk.potrf_plain("L", diag),
                  lambda: torch.linalg.cholesky(diag),
                  2 * d * d * 4, d ** 3 / 3),
        "solve": (lambda: pk.panel_solve("R", "L", "C", "N", fac, strip),
                  lambda: pk.panel_solve_plain("R", "L", "C", "N", fac, strip),
                  lambda: torch.linalg.solve_triangular(lfac.mH, strip, upper=True, left=False),
                  (d * d + 2 * m * d) * 4, m * d * d),
        "step": (lambda: pk.step("L", diag, strip, slab),
                 lambda: pk.step_plain("L", diag, strip, slab), step_library,
                 (2 * d * d + 2 * m * d + 2 * m * w) * 4,
                 d ** 3 / 3 + m * d * d + 2 * d * (m * w - w * (w - 1) / 2)),
    }
    for name, (kern, plain, lib, nbytes, ops) in timings.items():
        bt, ot = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["float32"] * 1e3
        lib_ms = time_ms(torch, lib)
        # no single PyTorch call computes the fused step: its yardstick is
        # three calls, printed here and left out of library_ms
        rows[name].update(ms=time_ms(torch, kern), plain_ms=time_ms(torch, plain, reps=20),
                          library_ms=None if name == "step" else lib_ms,
                          bound_ms=max(bt, ot),
                          bound_by="bytes" if bt >= ot else "operations")
        r = rows[name]
        what = "composed cholesky+solve_triangular+masked matmul" if name == "step" else "library"
        print(f"[time] {name:6s} kernel={r['ms']:.4f} ms plain={r['plain_ms']:.4f} ms "
              f"{what}={lib_ms:.4f} ms bound={r['bound_ms']:.5f} ms "
              f"({r['bound_by']}) [{card}]", flush=True)
    print(f"[phase] kernels {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 2: the main path through the miniapp ----------------------
    def drive(argv, n, nb, nfact, expect):
        pk.reset_launches()
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            miniapp_cholesky.run(argv)
        torch.cuda.synchronize()
        counts = dict(pk.LAUNCHES)
        out = buf.getvalue()
        print(out, end="", flush=True)
        nt = -(-n // nb)
        want = {k: v(nt) * nfact for k, v in expect.items()}
        print(f"[main] launches {counts} expected {want} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
        if "check: PASSED" not in out:
            raise AssertionError("main path: no 'check: PASSED' line")
        for k, v in want.items():
            if counts[k] != v:
                raise AssertionError(f"main path: {k} launched {counts[k]} times, expected {v}")
        return counts

    t_phase = time.perf_counter()
    c1 = drive(["-m", "16384", "-b", "256", "--type", "s", "--uplo", "L",
                "--dlaf:step-impl=fused", "--dlaf:cholesky-lookahead=1",
                "--nruns", "3", "--nwarmups", "1", "--check-result", "last"],
               16384, 256, 4, {"step": lambda nt: nt - 1, "potrf": lambda nt: 1,
                               "solve": lambda nt: 0})
    c2 = drive(["-m", "8192", "-b", "256", "--type", "s", "--uplo", "U",
                "--dlaf:panel-impl=fused", "--dlaf:step-impl=xla",
                "--nruns", "2", "--nwarmups", "1", "--check-result", "last"],
               8192, 256, 3, {"step": lambda nt: 0, "potrf": lambda nt: nt,
                              "solve": lambda nt: nt - 1})
    print(f"[phase] main path {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 3: a small ragged factor against a float64 reference ------
    import numpy as np

    rng = np.random.default_rng(7)
    x = rng.standard_normal((500, 500))
    a = x @ x.T + 500 * np.eye(500)
    ref = np.linalg.cholesky(a)
    for argv in (["--dlaf:step-impl=fused"], ["--dlaf:panel-impl=fused", "--dlaf:step-impl=xla"]):
        from dlaf_tpu_torch import config

        config.initialize(argv=argv)
        mat = Matrix.from_global(a.astype(np.float32), TileElementSize(128, 128), device=dev)
        out, info = cholesky("L", mat, with_info=True)
        got = np.tril(out.to_numpy())
        err = np.abs(got - ref).max() / np.abs(ref).max()
        print(f"[small] n=500 nb=128 {argv} info={int(info)} rel_err={err:.3e} "
              f"tol=1e-5 shape={got.shape}", flush=True)
        if not (np.isfinite(got).all() and int(info) == 0 and err < 1e-5):
            raise AssertionError("small ragged factor disagrees with the float64 reference")

    profile_factorization(torch, dev)

    order = (("potrf", "dlaf_tpu/tile_ops/pallas_panel.py:187"),
             ("solve", "dlaf_tpu/tile_ops/pallas_panel.py:296"),
             ("step", "dlaf_tpu/tile_ops/pallas_panel.py:508"))
    kernels = [dict(name=name, route="cuda", source="dlaf_tpu_torch/csrc/panel.cu",
                    replaces=rep, launches=c1[name] + c2[name], **rows[name])
               for name, rep in order]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
