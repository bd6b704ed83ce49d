"""Build and bind the hand-written CUDA sources of ``csrc/``.

Each source has a plain C interface. It is compiled by ``nvcc`` for
``sm_90a`` into a shared library under ``dlaf_tpu_torch/_build/`` (listed
in ``.gitignore``) at first use, keyed by a hash of the source and the
flags, and loaded with ``ctypes``. :func:`build_all` starts one ``nvcc``
per source together and waits for all of them, so the build takes as long
as the slowest source. Nothing here runs at import time.

A ctypes launch goes to the CUDA device that is current, which PyTorch's
own operators set for themselves and a raw launch does not: every kernel
wrapper is decorated with :func:`on_device`, so that a grid whose ranks sit
on several cards launches each rank's kernels on that rank's card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Callable, Sequence

_PKG = os.path.dirname(os.path.dirname(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use and "
                       "need the CUDA toolkit")


class CudaLibrary:
    """One ``csrc/<name>.cu`` source, its build and its ctypes binding.
    ``bind(lib)`` sets the argument types of the library's functions."""

    def __init__(self, name: str, extra_flags: Sequence[str], bind: Callable):
        self.name = name
        self.src = os.path.join(_PKG, "csrc", f"{name}.cu")
        self.flags = [*NVCC_FLAGS, *extra_flags]
        self._bind = bind
        self._lib = None
        #: The compiler's output of the last build in this process (``-Xptxas
        #: -v``: registers, shared memory and spills of each kernel).
        self.log = ""

    def path(self) -> str:
        """Path of the shared library for the current source and flags."""
        with open(self.src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(self.flags).encode()).hexdigest()[:12]
        return os.path.join(BUILD_DIR, f"libdlaf_{self.name}-{digest}.so")

    def _start(self):
        """Start nvcc unless the library exists: ``(process, tmp, cmd)``."""
        if os.path.exists(self.path()):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *self.flags, "-Xptxas", "-v", "-o", tmp, self.src]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True), tmp, cmd

    def _finish(self, started) -> None:
        proc, tmp, cmd = started
        try:
            out, _ = proc.communicate()
            self.log = out
            sys.stderr.write(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
            os.replace(tmp, self.path())
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def build(self) -> str:
        """Compile the source unless its library exists; returns its path.
        The compiler's output goes to stderr."""
        build_all([self])
        return self.path()

    def load(self):
        if self._lib is None:
            lib = ctypes.CDLL(self.build())
            self._bind(lib)
            self._lib = lib
        return self._lib


def build_all(libs: Sequence[CudaLibrary]) -> None:
    """Build every library that is missing, one nvcc each, all at once."""
    started = [(lib, lib._start()) for lib in libs]
    errors = []
    for lib, st in started:
        if st is None:
            continue
        try:
            lib._finish(st)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("; ".join(errors))


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream(t) -> int:
    """The raw handle of the current CUDA stream of ``t``'s device."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(fn):
    """Decorator for a kernel wrapper: run it with the CUDA device of its
    first tensor argument current."""
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        import torch

        t = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if t is None or not t.is_cuda:
            return fn(*args, **kw)
        with torch.cuda.device(t.device):
            return fn(*args, **kw)

    return wrapper
