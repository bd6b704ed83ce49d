"""ctypes bindings of the native host code: the band-to-tridiagonal chase
and the divide-and-conquer merge's secular solver and deflation scan.

Port of ``dlaf_tpu/native/bindings.py:69-241``: the port's own copies
``band_to_tridiag.cpp``, ``secular.cpp`` and ``deflate.cpp`` (plain C
ABI) are compiled with g++ at first use into ``dlaf_tpu_torch/_build/``
(listed in ``.gitignore``), two libraries (the chase; the secular solver
with the deflation scan), each keyed by a hash of its sources, the flags
and the host's instruction set (a ``-march=native`` library is never
loaded on another CPU), and loaded with ``ctypes``. ``-march=native`` is
tried first, then the build without it, as in the reference. A failed
build or load raises, the first time and then from the cache of the error
(the compiler is not respawned on each call), and is logged once at error
level; the callers' numpy twins take over through
:mod:`..health.registry` (counted, ``DLAF_STRICT`` raises).
``health.inject.force_native_failure`` makes every load fail as a build
would (:data:`_FORCE_BUILD_FAILURE`). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

from ..types import ceil_div

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def _cpu_tag() -> str:
    """A short tag of this host's instruction set."""
    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    ident += line
                    break
    except OSError:
        ident += platform.processor()
    return hashlib.sha1(ident.encode()).hexdigest()[:10]


#: Test hook (``health.inject.force_native_failure``): when True, every
#: :meth:`NativeLibrary.load` fails as if the compiler or the loader had,
#: exercising the cached-error re-raise and every native -> numpy chain
#: without breaking a real toolchain.
_FORCE_BUILD_FAILURE = False


def _reset_for_tests(force_failure: bool = False) -> None:
    """Drop both libraries' cached library and error and (un)arm the
    forced failure, so an injection context neither sees a loaded library
    nor leaks its failure to later callers."""
    global _FORCE_BUILD_FAILURE
    for lib in (LIBRARY, DC_LIBRARY):
        with lib._lock:
            lib._lib = None
            lib._error = None
    _FORCE_BUILD_FAILURE = bool(force_failure)


def _bind_chase(lib) -> None:
    for name in ("dlaf_band_to_tridiag_d", "dlaf_band_to_tridiag_z"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                       ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_double), ctypes.c_void_p, ctypes.c_long]


def _bind_dc(lib) -> None:
    fn = lib.dlaf_secular_roots_d_nt
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    fn = lib.dlaf_deflate_scan_d
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]


class NativeLibrary:
    """One shared library of native host code: its build from ``src`` (a
    source or a tuple of them), load and ctypes binding (``bind``). A
    failed build or load is kept and raised again by every later
    :meth:`load`, so the compiler is not respawned on each call."""

    def __init__(self, src=os.path.join(_HERE, "band_to_tridiag.cpp"),
                 build_dir: str = BUILD_DIR, cxx: str = "g++", *, name: str = "b2t",
                 bind=_bind_chase):
        self.srcs = (src,) if isinstance(src, str) else tuple(src)
        self.src = self.srcs[0]
        self.build_dir = build_dir
        self.cxx = cxx
        self.name = name
        self._bind = bind
        self._lock = threading.Lock()
        self._lib = None
        self._error: Exception | None = None

    def path(self) -> str:
        key = b""
        for src in self.srcs:
            with open(src, "rb") as f:
                key += f.read()
        key += " ".join(CXX_FLAGS).encode() + _cpu_tag().encode()
        return os.path.join(self.build_dir,
                            f"libdlaf_{self.name}-{hashlib.sha256(key).hexdigest()[:12]}.so")

    def build(self) -> str:
        """Compile the source unless its library exists; returns its path.
        The library is written under a temporary name and renamed, so a
        concurrent build never loads a partial file."""
        path = self.path()
        if os.path.exists(path):
            return path
        os.makedirs(self.build_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
        os.close(fd)
        base = [self.cxx, *CXX_FLAGS, *self.srcs, "-o", tmp, "-lpthread"]
        try:
            try:
                subprocess.run([base[0], "-march=native", *base[1:]], check=True,
                               capture_output=True)
            except subprocess.CalledProcessError:
                subprocess.run(base, check=True, capture_output=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return path

    def load(self):
        with self._lock:
            if self._lib is not None:
                return self._lib
            if self._error is not None:
                raise self._error
            try:
                if _FORCE_BUILD_FAILURE:
                    raise OSError("forced build failure (health.inject test hook)")
                lib = ctypes.CDLL(self.build())
                self._bind(lib)
            except (OSError, AttributeError, subprocess.CalledProcessError) as e:
                self._error = RuntimeError(f"native {self.name}: build or load failed: {e!r}")
                from ..obs import get_logger

                # error level: an order-of-magnitude slowdown stays visible
                # even where DLAF_LOG=error
                get_logger("native").error(
                    f"{self.name}: build/load failed ({e!r}); numpy fallbacks in effect")
                raise self._error from e
            self._lib = lib
            return lib


#: The library the chase uses.
LIBRARY = NativeLibrary()

#: The library of the D&C merge: the secular solver and the deflation scan.
DC_LIBRARY = NativeLibrary((os.path.join(_HERE, "secular.cpp"),
                            os.path.join(_HERE, "deflate.cpp")), name="dc", bind=_bind_dc)


def chase_threads() -> int:
    """Worker count of the pipelined sweeps: ``chase_threads``, 0 resolving
    to the process's CPU affinity count (oversubscribed spinning workers
    would thrash, not idle). Any count gives bitwise the same result."""
    from ..config import get_configuration

    t = get_configuration().chase_threads
    if t <= 0:
        try:
            t = len(os.sched_getaffinity(0))
        except AttributeError:
            t = os.cpu_count() or 1
    return t


def band_to_tridiag(band: np.ndarray, b: int, nthreads: int | None = None):
    """The native chase: a :class:`..eigensolver.band_to_tridiag.TridiagResult`
    (the reference numpy chase's contract). ``nthreads``: None or <= 0 takes :func:`chase_threads`; 1 is
    sequential."""
    from ..eigensolver.band_to_tridiag import TridiagResult

    n = band.shape[1]
    cplx = np.issubdtype(band.dtype, np.complexfloating)
    work_dtype = np.complex128 if cplx else np.float64
    band_w = np.ascontiguousarray(band, dtype=work_dtype)
    if band_w.shape != (b + 1, n):
        raise ValueError(f"band_to_tridiag: band of shape {band.shape}, expected {(b + 1, n)}")
    n_sweeps = max(n - 2, 0)
    n_steps = ceil_div(max(n - 1, 1), b) if n > 1 else 0
    v = np.zeros((n_sweeps, max(n_steps, 1), b), dtype=work_dtype)
    tau = np.zeros((n_sweeps, max(n_steps, 1)), dtype=work_dtype)
    d = np.zeros(n, dtype=np.float64)
    e_raw = np.zeros(max(n - 1, 0), dtype=work_dtype)
    if n > 0:
        lib = LIBRARY.load()
        fn = lib.dlaf_band_to_tridiag_z if cplx else lib.dlaf_band_to_tridiag_d
        rc = fn(band_w.ctypes.data, n, b, max(n_steps, 1), v.ctypes.data, tau.ctypes.data,
                d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), e_raw.ctypes.data,
                nthreads if nthreads is not None and nthreads > 0 else chase_threads())
        if rc != 0:
            raise RuntimeError(f"native band_to_tridiag failed rc={rc}")
    phase = np.ones(n, dtype=work_dtype)
    if cplx:
        e = np.zeros(max(n - 1, 0), dtype=np.float64)
        for j in range(n - 1):
            mag = np.abs(e_raw[j])
            ph = e_raw[j] / mag if mag > 0 else 1.0
            phase[j + 1] = phase[j] * ph
            e[j] = mag
    else:
        e = np.real(e_raw)
    return TridiagResult(d=d, e=e, v=v[:, :n_steps], tau=tau[:, :n_steps], phase=phase, band=b)


def secular_roots(ds: np.ndarray, zs: np.ndarray, rho: float, nthreads: int | None = None):
    """The native secular solver (``secular.cpp``, safeguarded Newton, the
    laed4 analog): ``(anchor, mu)`` with the contract of the numpy twin
    ``tridiag_solver._secular_roots``. ``nthreads``: None or <= 0 lets the
    library pick (hardware concurrency, at least 64 roots a worker), as
    the reference; any count gives bitwise the same roots."""
    ds = np.ascontiguousarray(ds, dtype=np.float64)
    zs = np.ascontiguousarray(zs, dtype=np.float64)
    k = ds.shape[0]
    if zs.shape != (k,):
        raise ValueError(f"secular_roots: z of shape {zs.shape}, expected {(k,)}")
    anchor = np.zeros(k, dtype=np.int64)
    mu = np.zeros(k, dtype=np.float64)
    if k == 0:
        return anchor, mu
    rc = DC_LIBRARY.load().dlaf_secular_roots_d_nt(
        ds.ctypes.data, zs.ctypes.data, float(rho), k, anchor.ctypes.data, mu.ctypes.data,
        nthreads if nthreads is not None and nthreads > 0 else 0)
    if rc != 0:
        raise RuntimeError(f"native secular_roots failed rc={rc}")
    return anchor, mu


def deflate_scan(ds: np.ndarray, zs: np.ndarray, live: np.ndarray, tol: float):
    """The native near-equal-pole deflation scan (``deflate.cpp``; DLA-Future
    ``merge.h:443-508``). Updates ``zs`` (float64) and ``live`` (bool) in
    place, both contiguous arrays the caller owns, and returns the Givens
    rotations ``(i, j, c, s)`` in application order."""
    n = ds.shape[0]
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0), np.zeros(0))
    if not (zs.dtype == np.float64 and live.dtype == np.bool_ and zs.shape == (n,)
            and live.shape == (n,) and zs.flags.c_contiguous and live.flags.c_contiguous):
        raise ValueError("deflate_scan: z (float64) and live (bool) must be contiguous "
                         "arrays of the poles' length")
    ds = np.ascontiguousarray(ds, dtype=np.float64)
    gi = np.zeros(n, dtype=np.int64)
    gj = np.zeros(n, dtype=np.int64)
    gc = np.zeros(n, dtype=np.float64)
    gs = np.zeros(n, dtype=np.float64)
    g = DC_LIBRARY.load().dlaf_deflate_scan_d(
        ds.ctypes.data, zs.ctypes.data, live.ctypes.data, n, float(tol), gi.ctypes.data,
        gj.ctypes.data, gc.ctypes.data, gs.ctypes.data)
    if g < 0:
        raise RuntimeError(f"native deflate_scan failed rc={g}")
    return gi[:g], gj[:g], gc[:g], gs[:g]
