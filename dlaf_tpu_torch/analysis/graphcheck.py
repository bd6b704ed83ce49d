"""Tape auditor: semantic invariants over every builder's recorded call.

Port of ``dlaf_tpu/analysis/graphcheck.py``. Records every
factorization, solve and eigensolver builder of the port — unrolled and
scan forms, local and on a 2x2 grid of one device, both uplos, the knob
combinations that change the program — once each on small seeded inputs
(:func:`.depgraph.trace`), and audits each tape for the invariant classes
whose violation is a silent scale-or-correctness bug. The rule ids are
the reference's:

``graph-conditional-collective``
    Under the single controller one verb call spans every rank of its
    line, so its schedule cannot vary by rank. The deadlock class lives
    in the multi-process form (``comm/multihost.py``): there each process
    issues its own verbs, and a process that skips or reorders one hangs
    its group. :func:`schedule_findings` reads one verb schedule per
    process (kind, axis, group, scalar arguments, message shapes and
    dtypes, in order) and reports any two members of one group whose
    schedules differ.

``graph-host-callback``
    A host sync (:func:`.depgraph.host_syncs`: a host read of the
    program's data, a scalar read, a data-dependent shape, a blocking
    copy) inside a hot-path program: the host waits for the device every
    step, and the queue it keeps ahead drains.

``graph-precision-demotion``
    A non-scalar f64/c128 value converted to f32/bf16/f16/c64 by
    ``_to_copy`` or ``copy_`` on the NATIVE route (the Ozaki slicing and
    the mixed f32-seed solver are the gated exceptions: the auditor pins
    those knobs off and records the ``atroute`` specs with
    ``native_route=False``).

``graph-dead-output``
    An op, kernel or verb that is not in place and none of whose output
    ranges is read by a later op, kernel, verb or host read, or handed
    back (the returned tensors, the inputs' written ranges): per-step
    work thrown away, the eager counterpart of a dropped scan output.
    One finding per op and step phase; in an indexed step scope its key
    carries how many such outputs each step holds (:func:`_step_pattern`),
    so a grandfathered key does not hide a new one in another step.
    ``graph-dead-carry`` is not ported: an eager loop has no carry
    (ROADMAP's "Not ported, on purpose").

``graph-hbm-blowup``
    An op or kernel output larger than ``hbm_factor`` times the bytes of
    ONE rank's inputs (the reference's per-shard denominator: a grid
    program's budget is one shard's, not the whole matrix's).

``graph-trace-error``
    A spec that fails to record is itself a finding: the auditor never
    skips.

Audited under a pinned native configuration with ``DLAF_*`` scrubbed
(restored after), so the result does not depend on the caller's
environment.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import depgraph
from .findings import Finding

#: Default materialized-intermediate budget, as a multiple of one rank's
#: input bytes: the builders peak well under 4x (the bulk trailing
#: product and the gathered transposed panels are each at most a shard);
#: 8x trips only on a genuinely materialized broadcast temporary.
DEFAULT_HBM_FACTOR = 8.0

#: Verbs whose values legitimately differ between processes.
RAGGED_VERBS = frozenset({"gather", "scatter", "exchange", "bcast_arrays"})


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One call to record. ``build`` returns ``(fn, args)`` with fresh
    inputs on the spec's device (the builders work in place)."""

    name: str
    build: Callable[[], Tuple[Callable, Tuple]]
    #: the host-sync rule applies (every current builder is a hot path)
    hot_path: bool = True
    #: the precision-demotion rule applies (the native knobs are pinned,
    #: so every demotion is unexpected)
    native_route: bool = True


@contextlib.contextmanager
def pinned_native_config():
    """Scrub ``DLAF_*`` and pin the port's knobs that steer routes to
    their native/serialized choices, so the recorded programs are
    deterministic and the precision rule has no gated exception in
    scope. Only fields of ``dlaf_tpu_torch/config.py`` are pinned (the
    reference's ``qr_panel``, ``dc_level_batch`` and ``bt_lookahead`` are
    not ported). On exit the env is restored and the caller's active
    configuration re-installed."""
    from .. import config

    prev = dataclasses.replace(config.get_configuration())
    saved = {k: os.environ.pop(k) for k in list(os.environ) if k.startswith("DLAF_")}
    try:
        config.initialize(config.Configuration(
            f64_gemm="native", f64_trsm="native", cholesky_trailing="loop",
            cholesky_lookahead="0", comm_lookahead="0", hegst_impl="blocked",
            dist_step_mode="unrolled",
            # an adaptive route table steering mid-audit would make the
            # recorded programs depend on probe history
            autotune="0",
            # the fused routes get their own f32 specs (*.fpanel, *.fstep),
            # built with explicit panel_fused/step_fused
            panel_impl="xla", step_impl="xla",
            # cuda's and the cpu's auto differ: one value for both tapes
            ozaki_impl="pallas", log="off"))
        yield
    finally:
        os.environ.update(saved)
        config.initialize(prev)


def program_specs(rows: int = 2, cols: int = 2, n: int = 24, nb: int = 4,
                  device: str = "cpu") -> List[ProgramSpec]:
    """The audited program matrix: the reference's, spec for spec and
    under its names, on the port's builders. Sizes are tiny (the
    invariants are structure, not size); the grid is 2x2 on one device.

    Left out, with the reason: none of the reference's specs. Added: the
    chip script's main-L and dist-L cells through ``cholesky`` itself
    (``cholesky.entry.*``), whose full-width tapes ``chip_smoke.py``
    phase 36 audits under the same names. The
    ``*_scan`` Cholesky specs record the port's Python-loop scan builders;
    ``solve.dist_scan.*.la1.comm1`` records ``scan=True, lookahead=True``
    (the port's solve has no separate ``comm_la``: its look-ahead form
    issues the exchange ahead of the deferred bulk); the ``fpanel``/
    ``fstep`` grid specs pass ``use_pallas=False`` as the reference's do
    (kernel #5 is recorded at full width in ``chip_smoke.py`` phase 36)."""
    import numpy as np
    import torch

    from ..algorithms.cholesky import (_cholesky_dist, _cholesky_dist_scan, _cholesky_local,
                                       _cholesky_local_scan)
    from ..algorithms.gen_to_std import _hegst_dist
    from ..algorithms.triangular import _dist_mult, _dist_solve
    from ..autotune.routes import LADDER_F64
    from ..autotune.routes import applied as _route_applied
    from ..comm import collectives as cc
    from ..comm.grid import shared_grid
    from ..common.index2d import TileElementSize
    from ..eigensolver.back_transform import _dist_bt_b2t, _dist_bt_r2b, _dist_bt_r2b_scan
    from ..eigensolver.band_to_tridiag import band_to_tridiag
    from ..eigensolver.reduction_to_band import (_red2band_dist, _red2band_dist_scan,
                                                 _red2band_local, _red2band_local_scan,
                                                 extract_band, reduction_to_band)
    from ..matrix.matrix import Matrix
    from ..serve.programs import cholesky_spec, eigh_spec, program_builder, solve_spec

    dev = torch.device(device)
    grid = shared_grid(rows, cols, dev)
    block = TileElementSize(nb, nb)
    P, Q = rows, cols

    def hpd(dtype, seed=0):
        x = np.random.default_rng(seed).standard_normal((n, n))
        return (x @ x.T / n + np.eye(n) * 2).astype(dtype)

    def herm(dtype, seed=1):
        x = np.random.default_rng(seed).standard_normal((n, n))
        return ((x + x.T) / 2).astype(dtype)

    def lower(dtype, seed=2):
        x = np.tril(np.random.default_rng(seed).standard_normal((n, n))) / n
        return (x + np.eye(n) * 2).astype(dtype)

    def local(a):
        return torch.as_tensor(a, device=dev).clone()

    def mat(a):
        return Matrix.from_global(a, block, grid, device=dev)

    def lts(m):
        return cc.per_rank(P, Q, lambda r, c: m.storage[r * Q + c])

    f64, f32 = np.float64, np.float32
    specs: List[ProgramSpec] = []

    def entry_cell(a, on_grid):
        m = Matrix.from_global(a, block, on_grid, device=dev)
        return entry_call, (m,)

    def add(name, make, **kw):
        specs.append(ProgramSpec(name=name, build=make, **kw))

    # ---- local Cholesky (unrolled trailing forms + scan form) ----
    for uplo in ("L", "U"):
        for trailing in ("loop", "biggemm"):
            for la in (False, True):
                add(f"cholesky.local.{trailing}.{uplo}.la{int(la)}",
                    lambda uplo=uplo, trailing=trailing, la=la: (
                        lambda x: _cholesky_local(x, uplo=uplo, nb=nb, trailing=trailing,
                                                  lookahead=la), (local(hpd(f64)),)))
        add(f"cholesky.local_scan.{uplo}.la1",
            lambda uplo=uplo: (
                lambda x: _cholesky_local_scan(x, uplo=uplo, nb=nb, lookahead=True),
                (local(hpd(f64)),)))

    # ---- distributed Cholesky (unrolled + scan, knob combos) ----
    def dist_chol(uplo, dtype=f64, scan=False, **kw):
        m = mat(hpd(dtype))
        if scan:
            return (lambda x: _cholesky_dist_scan(x, m.dist, uplo=uplo, **kw)), (lts(m),)
        return (lambda x: _cholesky_dist(x, m.dist, uplo=uplo, **kw)), (lts(m),)

    for uplo in ("L", "U"):
        for la, comm in ((False, False), (True, True)):
            add(f"cholesky.dist.{uplo}.la{int(la)}.comm{int(comm)}",
                lambda uplo=uplo, la=la, comm=comm: dist_chol(uplo, lookahead=la,
                                                              comm_la=comm))
        add(f"cholesky.dist_scan.{uplo}.la1",
            lambda uplo=uplo: dist_chol(uplo, scan=True, lookahead=True))
    add("cholesky.dist.L.la1.comm1.info",
        lambda: dist_chol("L", lookahead=True, comm_la=True, with_info=True))

    # ---- the fused panel route (f32, the route's dtype) ----
    for uplo in ("L", "U"):
        add(f"cholesky.local.fpanel.{uplo}.la1",
            lambda uplo=uplo: (
                lambda x: _cholesky_local(x, uplo=uplo, nb=nb, trailing="loop", lookahead=True,
                                          panel_fused=True), (local(hpd(f32)),)))
        add(f"cholesky.dist.fpanel.{uplo}.la1.comm1",
            lambda uplo=uplo: dist_chol(uplo, f32, lookahead=True, comm_la=True,
                                        panel_fused=True))
    add("cholesky.dist_scan.fpanel.L.la1",
        lambda: dist_chol("L", f32, scan=True, lookahead=True, panel_fused=True))

    # ---- the fused step route (f32) ----
    for uplo in ("L", "U"):
        add(f"cholesky.local.fstep.{uplo}.la1",
            lambda uplo=uplo: (
                lambda x: _cholesky_local(x, uplo=uplo, nb=nb, trailing="loop", lookahead=True,
                                          step_fused=True), (local(hpd(f32)),)))
        add(f"cholesky.dist.fstep.{uplo}.la1.comm1",
            lambda uplo=uplo: dist_chol(uplo, f32, lookahead=True, comm_la=True,
                                        step_fused=True))
    add("cholesky.local_scan.fstep.L.la1",
        lambda: (lambda x: _cholesky_local_scan(x, uplo="L", nb=nb, lookahead=True,
                                                step_fused=True), (local(hpd(f32)),)))
    add("cholesky.dist_scan.fstep.L.la1",
        lambda: dist_chol("L", f32, scan=True, lookahead=True, step_fused=True))

    # ---- autotune-routed programs: the Ozaki slicing and the mixed f32
    # seed are the demotion rule's gated exceptions, recorded ON ----
    def under_route(rung: int, make):
        route = LADDER_F64.rungs[rung]

        def build():
            fn, args = make()

            def routed(*xs):
                with _route_applied(route):
                    return fn(*xs)

            return routed, args

        return build

    add("cholesky.dist.atroute.rung0.L.la1",
        under_route(0, lambda: dist_chol("L", use_mxu=True, use_mixed=True, use_oz_pallas=True,
                                         lookahead=True)), native_route=False)
    add("cholesky.dist.atroute.top.L.la1",
        under_route(len(LADDER_F64.rungs) - 1,
                    lambda: dist_chol("L", use_mxu=True, lookahead=True)), native_route=False)

    # ---- distributed triangular solve / multiply ----
    def tri_args(dtype, side):
        a = mat(lower(dtype))
        b = mat(np.random.default_rng(3).standard_normal((n, n)).astype(dtype))
        return a, b

    def dist_solve(side, uplo, op, dtype=f64, **kw):
        a, b = tri_args(dtype, side)
        return (lambda x, y: _dist_solve(x, y, a.dist, b.dist, side=side, uplo=uplo, op=op,
                                         diag="N", **kw)), (lts(a), lts(b))

    for side, uplo, op in (("L", "L", "N"), ("R", "U", "C")):
        add(f"solve.dist.{side}{uplo}{op}",
            lambda side=side, uplo=uplo, op=op: dist_solve(side, uplo, op, panel_fused=False))
        add(f"solve.dist_scan.{side}{uplo}{op}.la1.comm1",
            lambda side=side, uplo=uplo, op=op: dist_solve(side, uplo, op, panel_fused=False,
                                                           scan=True, lookahead=True))
    add("solve.dist.fpanel.LLN",
        lambda: dist_solve("L", "L", "N", f32, panel_fused=True))
    add("solve.dist_scan.fpanel.LLN.la1",
        lambda: dist_solve("L", "L", "N", f32, panel_fused=True, scan=True, lookahead=True))

    def dist_mult(scan):
        a, b = tri_args(f64, "L")
        return (lambda x, y: _dist_mult(x, y, a.dist, b.dist, side="L", uplo="L", op="N",
                                        diag="N", scan=scan)), (lts(a), lts(b))

    add("mult.dist.LLN", lambda: dist_mult(False))
    add("mult.dist_scan.LLN", lambda: dist_mult(True))

    # ---- distributed HEGST (blocked two-sided update) ----
    def hegst(uplo, dtype=f64, **kw):
        a = mat(herm(dtype))
        fac = np.linalg.cholesky(hpd(f64)).astype(dtype)
        lm = mat(fac if uplo == "L" else fac.T.copy())
        return (lambda x, y: _hegst_dist(x, y, a.dist, uplo=uplo, **kw)), (lts(a), lts(lm))

    for uplo in ("L", "U"):
        for la, comm in ((False, False), (True, True)):
            add(f"hegst.dist.{uplo}.la{int(la)}.comm{int(comm)}",
                lambda uplo=uplo, la=la, comm=comm: hegst(uplo, lookahead=la, comm_la=comm))
    add("hegst.dist.fpanel.L.la1.comm1",
        lambda: hegst("L", f32, lookahead=True, comm_la=True, panel_fused=True))

    # ---- reduction to band (local + dist, unrolled + scan) ----
    add("red2band.local",
        lambda: (lambda x: _red2band_local(x, nb=nb), (local(herm(f64)),)))
    add("red2band.local_scan",
        lambda: (lambda x: _red2band_local_scan(x, nb=nb), (local(herm(f64)),)))

    def red2band(scan, comm=False):
        m = mat(herm(f64))
        if scan:
            return (lambda x: _red2band_dist_scan(x, m.dist, nb)), (lts(m),)
        return (lambda x: _red2band_dist(x, m.dist, nb, comm_la=comm)), (lts(m),)

    for comm in (False, True):
        add(f"red2band.dist.comm{int(comm)}", lambda comm=comm: red2band(False, comm))
    add("red2band.dist_scan", lambda: red2band(True))

    # ---- back-transforms ----
    def bt_r2b(scan, la=False):
        red = reduction_to_band(mat(herm(f64)), band_size=nb)
        c = mat(np.random.default_rng(4).standard_normal((n, n)))
        a = red.matrix
        if scan:
            return (lambda x, t, y: _dist_bt_r2b_scan(x, t, y, a.dist, c.dist, nb)), \
                (lts(a), red.taus, lts(c))
        return (lambda x, t, y: _dist_bt_r2b(x, t, y, a.dist, c.dist, nb, la=la)), \
            (lts(a), red.taus, lts(c))

    for la in (False, True):
        add(f"bt_r2b.dist.la{int(la)}", lambda la=la: bt_r2b(False, la))
    add("bt_r2b.dist_scan.la1", lambda: bt_r2b(True))

    def bt_b2t():
        red = reduction_to_band(mat(herm(f64)), band_size=nb)
        tri = band_to_tridiag(extract_band(red), red.band)
        c = mat(np.random.default_rng(5).standard_normal((n, n)))
        return (lambda t, m: _dist_bt_b2t(t, m)), (tri, c)

    add("bt_b2t.dist", bt_b2t)

    # ---- the chip script's main-L and dist-L cells (the port's own):
    # miniapp_cholesky's entry with cuda's routes named (the fused step,
    # biggemm, both look-aheads, the update kernel), at this size ----
    add("cholesky.entry.main-L", lambda: entry_cell(hpd(f32), None))
    add("cholesky.entry.dist-L", lambda: entry_cell(hpd(f32), grid))

    # ---- the serve bucket programs, through the service's own builder
    # (f64, with_info on: the serving default) ----
    serve_specs = [
        cholesky_spec(batch=3, n=n, nb=nb, dtype="float64", uplo="L"),
        cholesky_spec(batch=3, n=n, nb=nb, dtype="float64", uplo="U"),
        solve_spec(batch=3, n=n, nrhs=nb, nb=nb, dtype="float64",
                   side="L", uplo="L", transa="N", diag="N"),
        solve_spec(batch=3, n=n, nrhs=nb, nb=nb, dtype="float64",
                   side="R", uplo="U", transa="C", diag="N"),
        eigh_spec(batch=3, n=n, nb=nb, dtype="float64", uplo="L"),
    ]

    def serve_args(sspec, shapes):
        out = []
        for i, (shape, dt) in enumerate(shapes):
            if i == 0:
                base = torch.as_tensor(hpd(f64) if sspec.op != "solve" else lower(f64))
                out.append(base.to(dev, dt).expand(shape).clone())
            elif len(shape) == 1:
                out.append(torch.ones(shape, dtype=dt, device=dev))
            else:
                g = np.random.default_rng(6).standard_normal(shape)
                out.append(torch.as_tensor(g, dtype=dt, device=dev))
        return tuple(out)

    for sspec in serve_specs:
        tag = (f"{sspec.side}{sspec.uplo}{sspec.transa}"
               if sspec.op == "solve" else sspec.uplo)

        def make(sspec=sspec):
            fn, shapes, _ = program_builder(sspec)
            return fn, serve_args(sspec, shapes)

        add(f"serve.{sspec.op}.batched.{tag}", make)
    return specs


# ---------------------------------------------------------------------------
# Checks over one tape
# ---------------------------------------------------------------------------

#: cuda's routes of ``cholesky``'s float32 cells, named for both devices.
ENTRY_ROUTES = dict(step_impl="fused", panel_impl="fused", cholesky_trailing="biggemm",
                    cholesky_lookahead="1",
                    comm_lookahead="1")


def entry_call(mat):
    """``cholesky("L", mat, donate=True)`` under :data:`ENTRY_ROUTES` and
    with the update kernel's route open on the CPU too (its plain
    version there; the reference's test hook), as the chip script's
    main-L and dist-L cells run it on the card."""
    from .. import config
    from ..algorithms.cholesky import cholesky

    prev = config.get_configuration()
    hook = os.environ.get(
        "DLAF_FORCE_PALLAS_UPDATE"  # dlaf: disable=lint-unregistered-knob(the update route's test hook, saved to be restored)
    )
    os.environ["DLAF_FORCE_PALLAS_UPDATE"] = "1"
    config.initialize(dataclasses.replace(prev, **ENTRY_ROUTES))
    try:
        return cholesky("L", mat, donate=True)
    finally:
        if hook is None:
            os.environ.pop("DLAF_FORCE_PALLAS_UPDATE")  # dlaf: disable=lint-unregistered-knob(the test hook, restored)
        else:
            os.environ["DLAF_FORCE_PALLAS_UPDATE"] = hook
        config.initialize(prev)


def _where(node) -> str:
    key = depgraph.step_scope_of(node)
    if key is None:
        return "top"
    algo, step, phase = key
    return f"{algo}.{'scanstep' if step < 0 else 'step'}.{phase}"


def _short(site: str) -> str:
    """``dlaf_tpu_torch/...:line`` of a node's site."""
    i = site.rfind("dlaf_tpu_torch" + os.sep)
    return site[i:] if i >= 0 else os.path.basename(site)


def dead_outputs(tape) -> list:
    """The top-level op, kernel and verb nodes of ``tape`` that are not in
    place and none of whose output ranges is read or handed back
    (constant factories are not held to it)."""
    return [n for n in depgraph.iter_ops(tape)
            if n.kind in ("op", "kernel", "collective") and not n.inplace and n.out_bytes
            and n.name not in depgraph.FACTORIES and not tape.was_read(n)]


def _steps_per_algo(tape) -> Dict[str, int]:
    """``{algo: steps}``: one more than the largest step index of each
    stepped algorithm on the tape."""
    out: Dict[str, int] = {}
    for n in depgraph.iter_ops(tape):
        key = depgraph.step_scope_of(n)
        if key is not None and key[1] >= 0:
            out[key[0]] = max(out.get(key[0], 0), key[1] + 1)
    return out


def _step_name(k: int, steps: int) -> str:
    """Step ``k`` of ``steps`` named from the nearer end."""
    back = steps - 1 - k
    if k < back:
        return f"step{k}"
    return "last" if back == 0 else f"last-{back}"


def _step_pattern(nodes, n_steps: Dict[str, int]) -> str:
    """How many of ``nodes`` (one op in one phase) each step of an indexed
    step scope holds, as ``"<c> a step"`` (the count most steps hold)
    and the steps that differ, named from the nearer end (``step1``,
    ``last``, ``last-1``), so the same program gives the same text at
    any order: a new dead output in any step changes the key. Empty for
    unscoped and scan-step nodes."""
    keys = [depgraph.step_scope_of(n) for n in nodes]
    if not keys or any(k is None or k[1] < 0 for k in keys):
        return ""
    steps = n_steps[keys[0][0]]
    counts = [0] * steps
    for k in keys:
        counts[k[1]] += 1
    common = min(set(counts), key=lambda c: (-counts.count(c), c))
    odd = [f"{_step_name(k, steps)}:{c}" for k, c in enumerate(counts) if c != common]
    return f"{common} a step" + (f" ({', '.join(odd)})" if odd else "")


def audit_tape(name: str, tape, *, hot_path: bool = True, native_route: bool = True,
               hbm_factor: float = DEFAULT_HBM_FACTOR) -> List[Finding]:
    """All graph findings for one recorded call (the module docstring
    has the rules). Under the single controller a verb spans its whole
    line, so ``graph-conditional-collective`` reads the per-process
    schedules instead (:func:`schedule_findings`)."""
    findings: List[Finding] = []

    if hot_path:
        for n in depgraph.host_syncs(tape):
            findings.append(Finding(
                "graph-host-callback", name,
                f"host sync {n.name} inside a hot-path program (scope "
                f"{n.scope or 'top'}; {n.site}) — the host waits for the device",
                key_detail=f"{name}|{n.name}"))

    if native_route:
        for n in tape.nodes:
            if n.demotion:
                findings.append(Finding(
                    "graph-precision-demotion", name,
                    f"{n.demotion} conversion ({n.name}, shape "
                    f"{n.shapes[0] if n.shapes else ()}) on the native route — "
                    f"silent mantissa loss outside the gated mxu/mixed routes",
                    key_detail=f"{name}|{n.demotion}"))

    dead: Dict[Tuple[str, str], list] = {}
    for n in dead_outputs(tape):
        dead.setdefault((n.name, _where(n)), []).append(n)
    n_steps = _steps_per_algo(tape)
    for (op, where), nodes in sorted(dead.items()):
        sites = sorted({_short(n.site) for n in nodes})
        pattern = _step_pattern(nodes, n_steps)
        findings.append(Finding(
            "graph-dead-output", name,
            f"{op} in {where} writes {len(nodes)} output(s) that nothing reads "
            f"({', '.join(sites)}{'; ' + pattern if pattern else ''}) — work computed and "
            f"thrown away",
            key_detail=f"{name}|{op}|{where}" + (f"|{pattern}" if pattern else "")))

    budget = hbm_factor * tape.rank_bytes
    for n in depgraph.iter_ops(tape):
        if n.kind in ("op", "kernel") and n.out_bytes > budget:
            findings.append(Finding(
                "graph-hbm-blowup", name,
                f"{n.name} materializes {n.out_bytes} bytes — "
                f"{n.out_bytes / tape.rank_bytes:.1f}x one rank's {tape.rank_bytes} input "
                f"bytes (scope {n.scope or 'top'}, budget {hbm_factor}x)",
                key_detail=f"{name}|{n.name}|{n.out_bytes // tape.rank_bytes}x"))
    return findings


def _group_members(group: str, P: int, Q: int) -> list:
    if group.startswith("col"):
        return [(i, int(group[3:])) for i in range(P)]
    if group.startswith("row"):
        return [(int(group[3:]), j) for j in range(Q)]
    return [(i, j) for i in range(P) for j in range(Q)]


def _sig(entry) -> tuple:
    """What every member of a group must agree on: a ragged verb's values
    (one owner's pieces, a rank's count of tiles) differ by design, so
    only its kind, axis and arguments."""
    kind, axis, _group, params, shapes, dtypes = entry
    if kind in RAGGED_VERBS:
        return (kind, axis, params)
    return (kind, axis, params, shapes, dtypes)


def schedule_findings(schedules: Dict[Tuple[int, int], Sequence], grid,
                      name: str = "multiprocess") -> List[Finding]:
    """``graph-conditional-collective`` over the verb schedules that the
    processes of one multi-process run saved (``Tape.schedule``, keyed by
    grid rank ``(r, c)``; ``grid`` is ``(P, Q)`` or a grid): every member
    of a group (a grid column for ``row`` verbs, a grid row for ``col``
    verbs, the world for the rest) must issue that group's verbs in the
    same order with the same kind, arguments and message shapes."""
    P, Q = (grid.size.row, grid.size.col) if hasattr(grid, "size") else tuple(grid)
    groups = sorted({e[2] for sched in schedules.values() for e in sched})
    findings: List[Finding] = []
    for group in groups:
        members = [m for m in _group_members(group, P, Q) if m in schedules]
        seqs = {m: [_sig(e) for e in schedules[m] if e[2] == group] for m in members}
        first = members[0]
        for m in members[1:]:
            a, b = seqs[first], seqs[m]
            if a == b:
                continue
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            got_a = a[i][0] if i < len(a) else "nothing"
            got_b = b[i][0] if i < len(b) else "nothing"
            findings.append(Finding(
                "graph-conditional-collective", name,
                f"group {group}: rank {first} issues {got_a} and rank {m} issues {got_b} "
                f"as verb {i} ({len(a)} against {len(b)} verbs) — a rank-varying "
                f"collective schedule deadlocks the processes",
                key_detail=f"{name}|{group}|{got_a if got_a != 'nothing' else got_b}"))
    return findings


def run(hbm_factor: float = DEFAULT_HBM_FACTOR, specs: Optional[Sequence[ProgramSpec]] = None,
        device: str = "cpu", stats: Optional[dict] = None,
        tapes: Optional[dict] = None) -> List[Finding]:
    """Record and audit every spec under the pinned native config, with
    one intra-op thread (the calls are tiny: more threads only contend).
    A spec that fails to record is a finding (``graph-trace-error``): the
    auditor fails loudly, never skips. ``stats``, when given, receives
    per-spec counts (nodes, ops, kernel nodes, collectives, seconds);
    ``tapes``, when given, each spec's tape."""
    import torch

    findings: List[Finding] = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pinned_native_config():
            if specs is None:
                specs = program_specs(device=device)
            for spec in specs:
                try:
                    fn, args = spec.build()
                    tape = depgraph.trace(fn, *args, device=torch.device(device).type)
                except Exception as e:   # noqa: BLE001 — converted to a finding
                    findings.append(Finding(
                        "graph-trace-error", spec.name,
                        f"builder failed to record: {type(e).__name__}: {e}",
                        key_detail=f"{spec.name}|{type(e).__name__}"))
                    continue
                if stats is not None:
                    stats[spec.name] = depgraph.summary(tape)
                if tapes is not None:
                    tapes[spec.name] = tape
                findings.extend(audit_tape(spec.name, tape, hot_path=spec.hot_path,
                                           native_route=spec.native_route,
                                           hbm_factor=hbm_factor))
    finally:
        torch.set_num_threads(threads)
    return findings
