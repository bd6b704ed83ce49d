"""Shape-bucketed program service.

Port of ``dlaf_tpu/serve/programs.py``: a :class:`ProgramService` holds one
bucket program per :class:`ProgramSpec` key ``(op, batch, n, nrhs, nb,
dtype, uplo/side/op/diag, with_info, donate)`` and serves it warm:

* :meth:`ProgramService.warmup` readies a bucket set (the server bring-up
  step);
* :meth:`ProgramService.evict` drops one bucket program;
* :meth:`ProgramSpec.to_wire` / :meth:`ProgramSpec.from_wire` carry a
  spec across a process boundary (the fleet router's ``warmup``);
* every lookup counts a hit, miss, warmup or eviction, as the reference's
  ``programs.py:191-376``, in :meth:`ProgramService.stats` and in
  ``dlaf_serve_cache_total{event,op}`` (:mod:`..obs`); each warmup compile
  is a ``serve.warmup`` span.

In the port a bucket program is the lane program of
:mod:`..algorithms.batched` bound to its spec. Eager PyTorch compiles
nothing ahead of time, so a program's "compile" is its first warm call on
inert operands (identity matrices, zero right-hand sides), timed as
``compile_s``: it loads the library's kernels and fills the allocator's
cache for the bucket's shapes. A bound program holds no device memory, so
the reference's LRU byte budget (``serve_cache_bytes``, and the
``dlaf_serve_cache_bytes`` gauge) and its pins, which would evict objects
whose eviction frees nothing, are not ported;
they return with a bucket program that owns memory (a CUDA graph per
bucket). Not ported yet either: the persistent compile cache.

The spec's ``route`` member (reference ``programs.py:64-79``) is the
bucket's autotune route (``Route.key()`` pairs, :mod:`..autotune`): a
learned route change is a NEW bucket program (a visible miss and its
compile, a site with a ``.rt_<tag>`` suffix), never a change under a warm
one. An eager program reads the routed knobs as it runs, so the bound
program applies its spec's route around every call, whatever thread
dispatches it. Each compile is one program telemetry event at the
bucket's site (:func:`..obs.telemetry.aot_compile`, the reference's
``programs.py:250-260``): ``dlaf_retrace_total{site=serve.*}`` stays 1 per
bucket unless a program is compiled again (evicted, then missed).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Optional

import torch

from .. import obs
from ..types import torch_dtype


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One bucket program's identity: the cache key."""

    op: str                 # "cholesky" | "solve" | "eigh"
    batch: int              # lanes per dispatch (B)
    n: int                  # bucket matrix order (the shape ceiling)
    nb: int                 # block size (bucket-key member)
    dtype: str              # dtype name ("float64", "complex128", ...)
    uplo: str = "L"
    side: str = "L"         # solve only
    transa: str = "N"       # solve only: op(A)
    diag: str = "N"         # solve only
    nrhs: int = 0           # solve only: rhs free-axis width
    with_info: bool = True
    donate: bool = False
    #: the bucket's autotune route (``Route.key()`` pairs; () = none)
    route: tuple = ()

    @property
    def site(self) -> str:
        """Per-bucket label (the breaker, stats and telemetry site); a
        route adds at most one label per ladder rung."""
        extra = (f".{self.side}{self.uplo}{self.transa}{self.diag}.r{self.nrhs}"
                 if self.op == "solve" else f".{self.uplo}")
        if self.route:
            from ..autotune.routes import Route

            extra += f".rt_{Route(**dict(self.route)).tag()}"
        return (f"serve.{self.op}.b{self.batch}n{self.n}nb{self.nb}.{self.dtype}{extra}"
                + (".info" if self.with_info else "") + (".don" if self.donate else ""))

    def to_wire(self) -> dict:
        """JSON-safe form (the fleet router's ``warmup`` message): every
        field is a JSON scalar but ``route``, whose pairs ride as lists."""
        doc = dataclasses.asdict(self)
        doc["route"] = [list(pair) for pair in self.route]
        return doc

    @classmethod
    def from_wire(cls, doc: dict) -> "ProgramSpec":
        """Inverse of :meth:`to_wire`: the route pairs become tuples again,
        so a spec that went through the wire is ``==`` to the original."""
        doc = dict(doc)
        doc["route"] = tuple(tuple(pair) for pair in doc.get("route", ()))
        return cls(**doc)


def cholesky_spec(*, batch: int, n: int, nb: int, dtype: str, uplo: str = "L",
                  with_info: bool = True, donate: bool = False, route: tuple = ()) -> ProgramSpec:
    return ProgramSpec(op="cholesky", batch=int(batch), n=int(n), nb=int(nb), dtype=str(dtype),
                       uplo=uplo, with_info=bool(with_info), donate=bool(donate),
                       route=tuple(route))


def solve_spec(*, batch: int, n: int, nrhs: int, nb: int, dtype: str, side: str = "L",
               uplo: str = "L", transa: str = "N", diag: str = "N", with_info: bool = True,
               donate: bool = False, route: tuple = ()) -> ProgramSpec:
    return ProgramSpec(op="solve", batch=int(batch), n=int(n), nb=int(nb), dtype=str(dtype),
                       uplo=uplo, side=side, transa=transa, diag=diag, nrhs=int(nrhs),
                       with_info=bool(with_info), donate=bool(donate), route=tuple(route))


def eigh_spec(*, batch: int, n: int, nb: int, dtype: str, uplo: str = "L",
              with_info: bool = True, donate: bool = False, route: tuple = ()) -> ProgramSpec:
    return ProgramSpec(op="eigh", batch=int(batch), n=int(n), nb=int(nb), dtype=str(dtype),
                       uplo=uplo, with_info=bool(with_info), donate=bool(donate),
                       route=tuple(route))


def program_builder(spec: ProgramSpec):
    """``(program, argument (shape, dtype) pairs, donated argument
    indices)`` for one bucket spec: the lane program of
    :mod:`..algorithms.batched` bound to the spec."""
    from ..algorithms import batched as bt

    dt = torch_dtype(spec.dtype)
    b_, n = spec.batch, spec.n
    a_st = ((b_, n, n), dt)
    if spec.op == "cholesky":
        fn = functools.partial(bt.cholesky_one, uplo=spec.uplo, nb=spec.nb,
                               with_info=spec.with_info, donate=spec.donate)
        return fn, (a_st,), ((0,) if spec.donate else ())
    if spec.op == "solve":
        rhs_shape = (b_, n, spec.nrhs) if spec.side == "L" else (b_, spec.nrhs, n)
        fn = functools.partial(bt.solve_one, side=spec.side, uplo=spec.uplo, op=spec.transa,
                               diag=spec.diag, with_info=spec.with_info, donate=spec.donate)
        return fn, (a_st, (rhs_shape, dt), ((b_,), dt)), ((1,) if spec.donate else ())
    if spec.op == "eigh":
        fn = functools.partial(bt.eigh_one, uplo=spec.uplo, with_info=spec.with_info,
                               donate=spec.donate)
        return fn, (a_st,), ((0,) if spec.donate else ())
    raise ValueError(f"unknown serve op {spec.op!r}")


def _inert_args(args, device) -> list:
    """Inert operands of the argument shapes: identity matrices, zero
    right-hand sides, unit scales."""
    out = []
    for i, (shape, dt) in enumerate(args):
        if i == 0:
            out.append(torch.eye(shape[-1], dtype=dt, device=device).expand(shape).clone())
        elif len(shape) == 1:
            out.append(torch.ones(shape, dtype=dt, device=device))
        else:
            out.append(torch.zeros(shape, dtype=dt, device=device))
    return out


class _Routed:
    """A bucket program bound to its spec's autotune route: the route is
    applied around every call (an eager program reads the routed knobs as
    it runs, and a dispatch thread inherits no contextvar)."""

    def __init__(self, fn, route: tuple):
        from ..autotune.routes import Route

        self.fn = fn
        self.route = Route(**dict(route))

    def __call__(self, *args):
        from ..autotune.routes import applied

        with applied(self.route):
            return self.fn(*args)


@dataclasses.dataclass
class _Entry:
    program: object
    compile_s: float


#: stats key -> the event label of ``dlaf_serve_cache_total``.
_EVENTS = {"hits": "hit", "misses": "miss", "warmups": "warmup", "evictions": "evict"}


class ProgramService:
    """Keyed bucket-program cache with warmup and evict (module
    docstring); programs are readied on ``device``. Thread-safe: a serving
    front end submits from request threads."""

    def __init__(self, *, device="cuda"):
        self._entries: dict = {}
        self._lock = threading.RLock()
        self.device = torch.device(device)
        self._stats = {"hits": 0, "misses": 0, "warmups": 0, "evictions": 0,
                       "compiles": 0, "compile_s": 0.0}

    # -- compile / lookup ------------------------------------------------

    def _count(self, event: str, spec: ProgramSpec) -> None:
        self._stats[event] += 1
        obs.counter("dlaf_serve_cache_total", event=_EVENTS[event], op=spec.op).inc()

    def _compile(self, spec: ProgramSpec) -> _Entry:
        """Bind the spec's program (with its route) and run it once on
        inert operands, fenced (the "compile", a telemetry event at the
        bucket's site); its wall is ``compile_s``."""
        fn, args, _ = program_builder(spec)
        if spec.route:
            fn = _Routed(fn, spec.route)
        prog = obs.telemetry.aot_compile(spec.site, fn, *_inert_args(args, self.device))
        self._stats["compiles"] += 1
        self._stats["compile_s"] += prog.compile_s
        return _Entry(program=fn, compile_s=prog.compile_s)

    def get(self, spec: ProgramSpec):
        """The program for ``spec``: compiled on a miss (counted ``miss``),
        counted ``hit`` when warm."""
        with self._lock:
            entry = self._entries.get(spec)
            if entry is not None:
                self._count("hits", spec)
                return entry.program
            entry = self._entries[spec] = self._compile(spec)
            self._count("misses", spec)
            return entry.program

    def run(self, spec: ProgramSpec, *args):
        """Dispatch ``args`` through the bucket program (the batched entry
        points' call path)."""
        return self.get(spec)(*args)

    def warmup(self, *specs: ProgramSpec) -> dict:
        """Ready every missing spec (counted ``warmup``, never ``miss``);
        returns ``{spec: compile seconds}`` (0.0 for already-warm ones).
        After warmup an in-bucket request stream is all hits."""
        walls = {}
        for spec in specs:
            with self._lock:
                if spec in self._entries:
                    walls[spec] = 0.0
                    continue
                with obs.span("serve.warmup", op=spec.op, site=spec.site):
                    entry = self._entries[spec] = self._compile(spec)
                self._count("warmups", spec)
                walls[spec] = entry.compile_s
        return walls

    def evict(self, spec: ProgramSpec) -> bool:
        """Drop one cached program; its next request compiles it again.
        False when it was not resident."""
        with self._lock:
            if self._entries.pop(spec, None) is None:
                return False
            self._count("evictions", spec)
            return True

    # -- introspection ---------------------------------------------------

    def stats(self) -> dict:
        """The counts ``hits``/``misses``/``warmups``/``evictions``/
        ``compiles``/``compile_s``, the live ``entries``, and ``hit_rate``
        = hits / (hits + misses) (1.0 when nothing was served)."""
        with self._lock:
            served = self._stats["hits"] + self._stats["misses"]
            return dict(self._stats, entries=len(self._entries),
                        hit_rate=(self._stats["hits"] / served if served else 1.0))

    def specs(self) -> tuple:
        with self._lock:
            return tuple(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_SERVICE: Optional[ProgramService] = None
_SERVICE_LOCK = threading.Lock()


def get_service() -> ProgramService:
    """The process-default program service, on ``cuda`` (what the batched
    entry points and ``serve.Queue`` use unless handed another one)."""
    global _SERVICE
    if _SERVICE is None:
        with _SERVICE_LOCK:
            if _SERVICE is None:
                _SERVICE = ProgramService()
    return _SERVICE


def warmup(*specs: ProgramSpec) -> dict:
    """``get_service().warmup(*specs)``: the one-line server bring-up."""
    return get_service().warmup(*specs)
