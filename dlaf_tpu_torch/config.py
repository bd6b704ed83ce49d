"""Runtime configuration: the knobs the ported algorithms read.

Counterpart of ``dlaf_tpu/config.py``, cut to the knobs of the local and
distributed Cholesky, the triangular solve and multiply
(``dist_step_mode``, ``trsm_rhs_chunk``), HEGST (``hegst_impl``), the
band-to-tridiagonal chase (``chase_threads``), the divide-and-conquer
tridiagonal solver (``secular_device_min_k``) and their f64/complex128
routes; and the serving layer's (``serve_*``, the finite guard ``check``)
the circuit breakers' (``circuit_*``), the resilience layer's (``strict``,
``resume_dir``; :mod:`.health.registry`, :mod:`.health.resume`), and the
observability layer's
(``log``, ``metrics_path``, ``trace_dir``, ``metrics_port``, ``slo_*``,
``flight_recorder``; :mod:`.obs`), with the reference's environment
names, defaults and validation (``config.py:400-417, 504-568, 617-624,
635-670, 776-793, 812-866``). :func:`initialize` configures :mod:`.obs`
from the resolved knobs, as the reference's does (``config.py:935-939``).
Same layering (highest wins):
``--dlaf:<knob>=<value>`` arguments > ``DLAF_<KNOB>`` environment
variables > a user ``Configuration`` > the defaults.

"auto" resolves per DEVICE TYPE of the call (the JAX package resolves per
process backend). On ``cpu`` as the reference does there: trailing
"loop", panel/step "xla", lookahead 0, ``f64_gemm``/``f64_trsm``
"native", ``ozaki_impl`` "jnp", ``comm_lookahead`` 0. On ``cuda`` by
what the H100 measured (``chip_smoke.py``'s route phase; numbers in
PERF.md): fused step and panel, lookahead 1, trailing "biggemm" and ``f64_gemm``/``f64_trsm``
"native", because the card's native float64 tensor-core products beat the
Ozaki int8 route that the reference picks on its TPU (there f64 is
emulated); ``ozaki_impl`` "pallas", so a call that asks for the Ozaki
route runs its hand-written kernels; ``comm_lookahead`` 1, since the
hoisted panel chain is what lets the collectives' copies overlap the bulk
update there; ``hegst_impl`` "twosolve" (two whole solves beat the
blocked transform's per-step panel chain in complex128 and float32, on a
2x2 grid and on one rank), where ``cpu`` takes the reference's "blocked".
``f64_gemm_slices=0`` resolves to 8 on both: the reference's choice where
f64 is native. Every auto
resolution is announced once on stderr so the route in effect is never
silent.

Not ported: ``ozaki_dot``, ``ozaki_group`` and ``ozaki_accum``. They pick
the TPU's schedule of the same integer sums and give bit-identical
results; the port has one schedule per route. ``qr_panel`` neither: the
port's panel QR is always geqrf, the reference's choice off its TPU.
``secular_impl`` and ``band_to_tridiag_impl`` neither: the merge's host
secular solve, its deflation scan and the chase are always the native
ones; a failed build or load of their library degrades to the numpy twins
through :mod:`.health.registry` (counted; ``strict`` raises).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

#: Trailing-update formulations (the reference's ``VALID_TRAILING``).
VALID_TRAILING = ("loop", "biggemm", "invgemm", "xla", "ozaki", "scan")


@dataclasses.dataclass
class Configuration:
    #: Blocked-Cholesky trailing update: "loop" (per block column herk +
    #: gemm, exact flops), "biggemm" (one masked whole product per step),
    #: "invgemm" (biggemm with the panel formed from the explicit tile
    #: inverse), "xla" (one whole-matrix library cholesky), "ozaki"
    #: (f64/complex128: mixed-precision panels and Ozaki int8 products;
    #: other types run biggemm), "scan" (uniform masked steps over
    #: telescoped segments), or "auto".
    cholesky_trailing: str = "auto"
    #: Look-ahead step order: "1" updates the next panel column first and
    #: carries it to the next step, "0" the plain order; "auto" per device.
    #: The factor is bitwise the same either way.
    cholesky_lookahead: str = "auto"
    #: Communication look-ahead of the distributed Cholesky (it needs
    #: ``cholesky_lookahead``): "1" runs step k+1's whole panel chain, its
    #: collectives included, before step k's bulk update, "0" after it;
    #: "auto" per device. The factor is bitwise the same either way.
    comm_lookahead: str = "auto"
    #: How a device list fills a grid: "row-major" or "col-major".
    grid_ordering: str = "row-major"
    #: Diagonal-tile potrf and panel strip solve: "fused" (the hand-written
    #: kernels of ``tile_ops/panel_kernels.py``), "xla" (the composed
    #: torch.linalg route, named after the reference's), or "auto".
    panel_impl: str = "auto"
    #: Whole blocked step (potrf + strip solve + adjacent trailing column)
    #: through the fused step kernels: "fused", "xla" or "auto".
    step_impl: str = "auto"
    #: Ozaki slice reduction: "jnp" (exact integer group sums, full-f64
    #: fold; the reference's composed route keeps its name), "pallas"
    #: (the hand-written slice kernels of ``tile_ops/ozaki_kernels.py``:
    #: double-f32 fold, about 48 mantissa bits; named after the
    #: reference's route) or "auto". Contractions deeper than 1024 stay
    #: on "jnp".
    ozaki_impl: str = "auto"
    #: int8 slices per operand on the Ozaki route (1..9; 0 = auto, which
    #: is 8: 56 mantissa bits, 36 slice products per real product).
    f64_gemm_slices: int = 0
    #: f64/complex128 products of the scan builder: "mxu" (Ozaki int8
    #: slices, named after the reference's route), "native" or "auto".
    f64_gemm: str = "auto"
    #: f64/complex128 panel factor and solve of the scan builder: "mixed"
    #: (f32 seed + one Newton step, ``tile_ops/mixed.py``), "native" or
    #: "auto".
    f64_trsm: str = "auto"
    #: Smallest block size for which ``f64_gemm="mxu"`` reroutes.
    f64_gemm_min_dim: int = 128
    #: Conditioning guard of the mixed panels: a limit on the squared
    #: diagonal ratio of the f32 seed factor; blocks above it take the
    #: native f64 factor.
    mixed_cond_limit: float = 100.0
    #: Per-k step form of the distributed triangular solve and multiply:
    #: "unrolled" (exact per-step shapes), "scan" (uniform masked steps
    #: over telescoped windows, the reference's compile-latency form) or
    #: "auto" (:func:`resolve_step_mode`). The Cholesky picks its scan form
    #: with ``cholesky_trailing="scan"``.
    dist_step_mode: str = "auto"
    #: Free-axis chunk width of a local whole-matrix triangular solve (rhs
    #: columns, rows for side 'R'): chunks are independent, so the result
    #: is bitwise the same. 0 = off; -1 = auto, which chunks only where the
    #: reference measured its memory limit, on the TPU, so 0 here.
    trsm_rhs_chunk: int = -1
    #: Seed of the mixed panels: "xla" (one library f32 cholesky + one
    #: triangular solve, named after the reference's) or "recursive"
    #: (recursive blocks whose leaves are library calls).
    mixed_seed: str = "xla"
    #: Leaf size of the recursive seed.
    mixed_seed_base: int = 64
    #: HEGST formulation: "blocked" (the per-step two-sided update with
    #: deferred solves, about n^3 real operations), "twosolve" (hermitianize,
    #: then two whole triangular solves, about twice the operations) or
    #: "auto". The scan step mode always takes twosolve.
    hegst_impl: str = "auto"
    #: Worker threads of the native chase's pipelined sweeps: 0 = the
    #: process's CPU affinity count, 1 = sequential. Any count gives
    #: bitwise the same result.
    chase_threads: int = 0
    #: Deflated merge size from which the D&C merge's secular solve and
    #: Gu-Eisenstat refinement run on the device (float64 torch, 300
    #: bisection halvings over a k x k array) instead of the host's native
    #: solver and numpy; 0 = auto (:func:`resolve_secular_device_min_k`).
    secular_device_min_k: int = 0
    #: Opt-in finite guard (``DLAF_CHECK``): the recovery drivers check
    #: their inputs and outputs for non-finite values and raise
    #: ``health.CheckError``. Off by default; the guard syncs with the host.
    check: bool = False
    #: Strict degradation mode (``DLAF_STRICT``): a registered fallback
    #: (:mod:`.health.registry`: the native secular solver, deflation scan
    #: and chase -> their numpy twins, an explicitly asked fused panel or
    #: step -> the composed route, a route a drill closed) raises
    #: ``health.DegradationError`` instead of taking the degraded path.
    strict: bool = False
    #: Stage-checkpoint directory of the eigensolver pipeline
    #: (``DLAF_RESUME_DIR``; :mod:`.health.resume`): when set, each of the
    #: five stages (red2band, b2t, tridiag, bt_b2t, bt_r2b) writes an atomic
    #: checkpoint, and ``eigensolver(..., resume=True)`` loads every stage
    #: whose manifest matches the run's fingerprint instead of recomputing
    #: it. Single controller only. Empty (default): no checkpoints.
    resume_dir: str = ""
    #: Bucket ceilings of the serving layer (``DLAF_SERVE_BUCKETS``): a
    #: comma-separated ascending list of matrix orders that
    #: :class:`..serve.Queue` rounds request shapes up to, one bucket
    #: program per ceiling. Empty = the next power of two >= max(n, 8); a
    #: request above the largest ceiling falls back to that too.
    serve_buckets: str = ""
    #: Lanes per batched serve dispatch (``DLAF_SERVE_BATCH``); a dispatch
    #: that leaves on its deadline pads the missing lanes with identities.
    serve_batch: int = 16
    #: Queue deadline, milliseconds (``DLAF_SERVE_DEADLINE_MS``): a bucket
    #: whose oldest request is older dispatches at the next submit or poll
    #: even if not full. No background thread: the injected clock is read
    #: at those calls.
    serve_deadline_ms: float = 50.0
    #: Admission bound (``DLAF_SERVE_MAX_DEPTH``): the most pending
    #: requests across every bucket; at the bound a submit sheds or
    #: dispatches the fullest bucket (``serve_shed``). 0 = unbounded.
    serve_max_depth: int = 0
    #: At the bound: True sheds the submit with ``health.OverloadError``,
    #: False dispatches the fullest bucket inline (backpressure).
    serve_shed: bool = True
    #: Total attempts of one batch dispatch under ``health.RetryPolicy``
    #: (``DLAF_SERVE_RETRY_ATTEMPTS``); 1 = no retry.
    serve_retry_attempts: int = 3
    #: Base backoff between dispatch attempts, milliseconds
    #: (``DLAF_SERVE_RETRY_BACKOFF_MS``; exponential, seeded jitter).
    serve_retry_backoff_ms: float = 0.0
    #: Consecutive failures at one site before its circuit breaker opens
    #: (``DLAF_CIRCUIT_THRESHOLD``).
    circuit_threshold: int = 3
    #: Seconds an open breaker rejects calls before it admits one
    #: half-open probe (``DLAF_CIRCUIT_COOLDOWN_S``).
    circuit_cooldown_s: float = 30.0
    #: Structured-log level of :mod:`.obs.logging` (``DLAF_LOG``): "debug",
    #: "info", "warning", "error" or "off". The once-per-choice auto-knob
    #: notices go through it, so ``DLAF_LOG=off`` silences them.
    log: str = "info"
    #: JSON-lines artifact of the observability layer
    #: (``DLAF_METRICS_PATH``): span records, metrics snapshots
    #: (collective counts and bytes, step and tile-op counts, span
    #: durations), log events, resilience and serve records; checked by
    #: ``python -m dlaf_tpu_torch.obs.validate``. ``%r`` becomes the
    #: process rank. Empty (default) keeps every instrumented site a no-op.
    metrics_path: str = ""
    #: ``torch.profiler`` trace directory (``DLAF_TRACE_DIR``): spans and
    #: per-step phases carry ``record_function`` names and one Chrome trace
    #: per process is written there at exit. Empty (default): off.
    trace_dir: str = ""
    #: Live ``/metrics`` + ``/healthz`` endpoint on 127.0.0.1
    #: (``DLAF_METRICS_PORT``); arming it also turns the metrics registry
    #: on without a metrics path. 0 (default): no thread, no socket.
    metrics_port: int = 0
    #: Rolling latency objective, milliseconds (``DLAF_SLO_P99_MS``): each
    #: latency recorded by ``obs.observe_latency`` (the serve queue per
    #: request, ``health.policy.with_policy`` per successful call) above it
    #: counts one ``dlaf_slo_breach_total{op}``. 0 (default): no objective.
    slo_p99_ms: float = 0.0
    #: Rolling SLO window length, seconds (``DLAF_SLO_WINDOW_S``), of the
    #: ``dlaf_serve_latency_window`` quantile gauges.
    slo_window_s: float = 60.0
    #: Breaches of one op inside one SLO window that dump the flight
    #: recorder with reason ``slo_breach_burst`` (``DLAF_SLO_BURST``); 0
    #: disables the trigger.
    slo_burst: int = 5
    #: Flight-recorder ring depth (``DLAF_FLIGHT_RECORDER``): the last N
    #: records, dumped atomically to ``<metrics_path>.flight.jsonl`` on an
    #: incident (breaker open, overload shed, recovery exhausted, /healthz
    #: failure, SLO breach burst). Needs ``metrics_path``. 0 (default): off.
    flight_recorder: int = 0


_VALID_CHOICES = {
    "cholesky_trailing": VALID_TRAILING + ("auto",),
    "cholesky_lookahead": ("0", "1", "auto"),
    "comm_lookahead": ("0", "1", "auto"),
    "grid_ordering": ("row-major", "col-major"),
    "panel_impl": ("fused", "xla", "auto"),
    "step_impl": ("fused", "xla", "auto"),
    "ozaki_impl": ("jnp", "pallas", "auto"),
    "f64_gemm": ("native", "mxu", "auto"),
    "f64_trsm": ("native", "mixed", "auto"),
    "mixed_seed": ("xla", "recursive"),
    "dist_step_mode": ("unrolled", "scan", "auto"),
    "hegst_impl": ("blocked", "twosolve", "auto"),
    "log": ("debug", "info", "warning", "error", "off"),
}

#: auto resolution per device type: (cuda choice, cpu choice).
_AUTO = {
    "cholesky_trailing": ("biggemm", "loop"),
    "cholesky_lookahead": ("1", "0"),
    "comm_lookahead": ("1", "0"),
    "panel_impl": ("fused", "xla"),
    "step_impl": ("fused", "xla"),
    "f64_gemm": ("native", "native"),
    "f64_trsm": ("native", "native"),
    "ozaki_impl": ("pallas", "jnp"),
    # cuda: twosolve was the faster in each cell of chip_smoke.py's HEGST
    # route phase (nb=256, one H100 80GB HBM3 at 700 W, PERF.md): 0.222925
    # s against blocked's 0.303872 s at BASELINE config #3 (complex128,
    # N=8192, 2x2), 0.447194 s against 0.698919 s (float32, N=16384, 2x2),
    # 0.116541 s against 0.151974 s (complex128, N=8192, one rank) and
    # 0.040097 s against 0.055603 s (float32, N=8192, one rank); float64
    # was not timed. cpu: the reference's choice off its TPU
    "hegst_impl": ("twosolve", "blocked"),
}

#: ``secular_device_min_k=0`` per device type: cuda by the dc-route sweep
#: of ``chip_smoke.py`` (DC_AUTO_NOTE); cpu never (the reference's CPU
#: rule: its device route lost to the native host solver at every size).
SECULAR_DEVICE_MIN_K_AUTO = {"cuda": 2048, "cpu": 1 << 62}

#: Where cuda's auto of ``secular_device_min_k`` comes from: the D&C of a
#: random A's tridiagonal at N=16384 (leaves 512) on one H100 80GB HBM3 at
#: 700 W, in two calls of chip_smoke.py's dc-route sweep: device secular
#: solve from k=2048 3.547 / 3.094 s, from 4096 5.378 / 5.180 s, from 8192
#: 8.682 / 7.793 s, host only 15.145 / 14.545 s (PERF.md §6).
DC_AUTO_NOTE = ("dc-route sweep, N=16384, two calls: from k=2048 3.547/3.094 s, "
                "4096 5.378/5.180, 8192 8.682/7.793, host-only 15.145/14.545")

#: ``f64_gemm_slices=0`` resolves to this on every device (native f64).
AUTO_SLICES = 8


def _validate(cfg: Configuration) -> None:
    for name, allowed in _VALID_CHOICES.items():
        if getattr(cfg, name) not in allowed:
            raise ValueError(f"configuration {name}={getattr(cfg, name)!r}: "
                             f"must be one of {allowed}")
    if not 0 <= cfg.f64_gemm_slices <= 9:
        raise ValueError(f"f64_gemm_slices={cfg.f64_gemm_slices}: must be in [1, 9], "
                         "or 0 for auto")
    if cfg.trsm_rhs_chunk < -1:
        raise ValueError(f"trsm_rhs_chunk={cfg.trsm_rhs_chunk}: must be -1 (auto), 0 (off) "
                         "or a positive width")
    if cfg.mixed_seed_base < 1:
        raise ValueError(f"mixed_seed_base={cfg.mixed_seed_base}: must be >= 1")
    if cfg.serve_batch < 1:
        raise ValueError(f"serve_batch={cfg.serve_batch}: must be >= 1 "
                         "(lanes per batched serve dispatch)")
    if not cfg.serve_deadline_ms >= 0:
        raise ValueError(f"serve_deadline_ms={cfg.serve_deadline_ms}: must "
                         "be >= 0 (0 = dispatch at the first poll)")
    if cfg.serve_max_depth < 0:
        raise ValueError(f"serve_max_depth={cfg.serve_max_depth}: must be "
                         ">= 0 (0 = unbounded pending depth)")
    if cfg.serve_retry_attempts < 1:
        raise ValueError(f"serve_retry_attempts={cfg.serve_retry_attempts}: "
                         "must be >= 1 (1 = no dispatch retry)")
    if not cfg.serve_retry_backoff_ms >= 0:
        raise ValueError(f"serve_retry_backoff_ms="
                         f"{cfg.serve_retry_backoff_ms}: must be >= 0")
    if cfg.circuit_threshold < 1:
        raise ValueError(f"circuit_threshold={cfg.circuit_threshold}: must "
                         "be >= 1 (consecutive failures before opening)")
    if not cfg.circuit_cooldown_s >= 0:
        raise ValueError(f"circuit_cooldown_s={cfg.circuit_cooldown_s}: "
                         "must be >= 0 (open -> half-open probe delay)")
    if not 0 <= cfg.metrics_port <= 65535:
        raise ValueError(f"metrics_port={cfg.metrics_port}: must be in "
                         "[0, 65535] (0 = live exporter off)")
    if not cfg.slo_p99_ms >= 0:
        raise ValueError(f"slo_p99_ms={cfg.slo_p99_ms}: must be >= 0 "
                         "(0 = no latency objective)")
    if not cfg.slo_window_s > 0:
        raise ValueError(f"slo_window_s={cfg.slo_window_s}: must be > 0 "
                         "(the rolling quantile window length)")
    if cfg.slo_burst < 0:
        raise ValueError(f"slo_burst={cfg.slo_burst}: must be >= 0 "
                         "(0 = breach-burst flight trigger off)")
    if cfg.flight_recorder < 0:
        raise ValueError(f"flight_recorder={cfg.flight_recorder}: must be "
                         ">= 0 (0 = flight recorder off; N = ring depth)")
    parse_serve_buckets(cfg.serve_buckets)   # raises on a malformed list


def parse_serve_buckets(value: str) -> tuple:
    """``serve_buckets`` parsed to an ascending tuple of positive ints
    (empty tuple = the power-of-two policy). A malformed list fails at
    initialize(), not by misrouting every request."""
    if not str(value).strip():
        return ()
    try:
        buckets = tuple(int(tok) for tok in str(value).split(","))
    except ValueError:
        raise ValueError(f"serve_buckets={value!r}: must be a "
                         "comma-separated list of positive ints")
    if any(b < 1 for b in buckets) or list(buckets) != sorted(set(buckets)):
        raise ValueError(f"serve_buckets={value!r}: ceilings must be "
                         "positive, strictly ascending, and unique")
    return buckets


def _parse(value: str, typ):
    """An environment or argument value as the field's type; a bool is
    true for 1/true/yes/on, as the reference reads it."""
    if typ is bool:
        return value.strip().lower() in ("1", "true", "yes", "on")
    return typ(value.strip())


def update_configuration(user: Optional[Configuration] = None,
                         argv: Optional[Sequence[str]] = None) -> Configuration:
    """Resolve the effective configuration from the layers above. Values
    from the environment and the arguments take the field's type."""
    cfg = dataclasses.replace(user) if user is not None else Configuration()
    kinds = {f.name: type(getattr(Configuration(), f.name))
             for f in dataclasses.fields(cfg)}

    def put(name, raw):
        setattr(cfg, name, _parse(raw, kinds[name]))

    for name in kinds:
        env = os.environ.get("DLAF_" + name.upper())
        if env is not None:
            put(name, env)
    for arg in argv or ():
        if not arg.startswith("--dlaf:") or "=" not in arg:
            continue
        key, val = arg[len("--dlaf:"):].split("=", 1)
        key = key.replace("-", "_")
        if key in kinds:
            put(key, val)
    _validate(cfg)
    return cfg


_active: Optional[Configuration] = None


def initialize(user: Optional[Configuration] = None,
               argv: Optional[Sequence[str]] = None) -> Configuration:
    """Resolve and activate the configuration, and bring the
    observability layer in line with its knobs; safe to call again."""
    global _active
    cfg = update_configuration(user, argv)
    from . import obs

    obs.configure(log_level=cfg.log, metrics_path=cfg.metrics_path,
                  trace_dir=cfg.trace_dir, metrics_port=cfg.metrics_port,
                  flight_recorder=cfg.flight_recorder)
    _active = cfg
    return _active


def get_configuration() -> Configuration:
    """Active configuration, initializing with defaults on first use."""
    return _active if _active is not None else initialize()


def announce_once(key, message: str) -> None:
    """Announce ``message`` once per ``key`` through the ``config`` logger
    (:meth:`.obs.logging.Logger.warning_once`): route choices are
    announced, never silent, unless ``DLAF_LOG`` silences warnings."""
    from .obs import get_logger

    get_logger("config").warning_once(key, message)


def _announce(knob: str, device_type: str, choice) -> None:
    announce_once((knob, device_type, choice),
                  f"{knob}=auto resolved to {choice!r} for device {device_type!r} — set the "
                  "knob explicitly to override")


def resolve(knob: str, device_type: str) -> str:
    """``knob``'s value with "auto" resolved for ``device_type`` ("cuda"
    or "cpu"), announced once per (knob, device type, choice)."""
    value = getattr(get_configuration(), knob)
    if value != "auto":
        return value
    choice = _AUTO[knob][0 if device_type == "cuda" else 1]
    _announce(knob, device_type, choice)
    return choice


def resolve_slices() -> int:
    """``f64_gemm_slices`` with 0 resolved to :data:`AUTO_SLICES`."""
    s = get_configuration().f64_gemm_slices
    if s:
        return s
    _announce("f64_gemm_slices", "any", AUTO_SLICES)
    return AUTO_SLICES


def resolve_secular_device_min_k(device_type: str) -> int:
    """``secular_device_min_k`` with 0 resolved for ``device_type``,
    announced once per (device type, choice)."""
    s = get_configuration().secular_device_min_k
    if s != 0:
        return s
    s = SECULAR_DEVICE_MIN_K_AUTO.get(device_type, SECULAR_DEVICE_MIN_K_AUTO["cpu"])
    _announce("secular_device_min_k", device_type, "host-always" if s >= 1 << 62 else s)
    return s


#: Step counts at which ``dist_step_mode="auto"`` picks the scan form, per
#: device type. The reference's numbers are compile constants: 32 on its
#: TPU, 128 on the CPU. Eager PyTorch compiles nothing, so cuda takes the
#: CPU rule until the card's own unrolled-against-scan times
#: (``chip_smoke.py``) argue another value.
STEP_MODE_AUTO_SCAN_AT = {"cpu": 128, "cuda": 128}


def resolve_step_mode(steps: int, device_type: str) -> str:
    """``dist_step_mode`` for an algorithm of ``steps`` per-k steps, "auto"
    resolved per device type (announced once per choice)."""
    mode = get_configuration().dist_step_mode
    if mode != "auto":
        return mode
    at = STEP_MODE_AUTO_SCAN_AT.get(device_type, 128)
    choice = "scan" if steps >= at else "unrolled"
    announce_once(("dist_step_mode", device_type, at),
                  f"dist_step_mode=auto switches to 'scan' at {at} steps on device "
                  f"{device_type!r} (the reference's cpu rule) — set the knob explicitly "
                  "to override")
    return choice
