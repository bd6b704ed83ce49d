"""A process of the resilience tests (``tests/test_torch_resilience.py``).

    python tests/torch_resilience_worker.py kill <out-dir> <stage>
    python tests/torch_resilience_worker.py resume <out-dir>
    python tests/torch_resilience_worker.py world <init-url> <rank> <world> <out-dir>

``kill``: the eigensolver of :func:`problem` with ``DLAF_RESUME_DIR`` at
``<out-dir>/rd``, preempted at ``stage`` (after its checkpoint landed);
the process then ends at once, with exit code 3, as a killed one would.
``resume``: the same call with ``resume=True``; the eigenpairs go to
``<out-dir>/resumed.npz``. ``world``: one rank of a 2x2 gloo world over
a ``file://`` rendezvous: a distributed Cholesky with ``with_info`` whose
first broadcast is poisoned, then a clean one, then the eigensolver with
``DLAF_RESUME_DIR`` set (ignored with a warning in such a world) and
``resume=True`` (refused); the outcomes go to ``<out-dir>/world.r<rank>.json``.
This module imports only the port.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from dlaf_tpu_torch import config
from dlaf_tpu_torch.common.index2d import TileElementSize
from dlaf_tpu_torch.eigensolver.eigensolver import eigensolver
from dlaf_tpu_torch.health import inject
from dlaf_tpu_torch.health.errors import PreemptionError, ResumeError
from dlaf_tpu_torch.matrix.matrix import Matrix

N, NB, BAND = 32, 8, 4


def problem(seed: int = 0) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((N, N))
    return (x + x.T) / 2


def matrix(grid=None):
    return Matrix.from_global(problem(), TileElementSize(NB, NB), grid=grid, device="cpu")


def world(url: str, rank: int, size: int, out_dir: str) -> int:
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.comm import multihost

    multihost.initialize_multihost(url, size, rank, backend="gloo", timeout=120.0)
    grid = multihost.multihost_grid(2, 2, device="cpu")
    x = np.random.default_rng(1).standard_normal((16, 16))
    a = x @ x.T + 16 * np.eye(16)

    def factor():
        _, info = cholesky("L", Matrix.from_global(a, TileElementSize(4, 4), grid=grid),
                           with_info=True)
        return int(info)

    out = {}
    with inject.corrupt_collective("bcast", nth=0, seed=3):
        out["poisoned"] = factor()
    out["clean"] = factor()
    os.environ["DLAF_RESUME_DIR"] = os.path.join(out_dir, "rd")
    config.initialize()
    res = eigensolver("L", matrix(grid), band_size=BAND)
    out["lam"] = [float(v) for v in res.eigenvalues]
    try:
        eigensolver("L", matrix(grid), band_size=BAND, resume=True)
        out["resume"] = "ran"
    except ResumeError as e:
        out["resume"] = str(e)
    with open(os.path.join(out_dir, f"world.r{rank}.json"), "w") as f:
        json.dump(out, f)
    multihost.finalize_multihost()
    return 0


def main(argv) -> int:
    mode = argv[0]
    if mode == "world":
        return world(argv[1], int(argv[2]), int(argv[3]), argv[4])
    out_dir = argv[1]
    os.environ["DLAF_RESUME_DIR"] = os.path.join(out_dir, "rd")
    config.initialize()
    if mode == "kill":
        try:
            with inject.preempt(argv[2]):
                eigensolver("L", matrix(), band_size=BAND)
        except PreemptionError:
            os._exit(3)
        return 1
    res = eigensolver("L", matrix(), band_size=BAND, resume=True)
    np.savez(os.path.join(out_dir, "resumed.npz"), lam=res.eigenvalues,
             vecs=res.eigenvectors.to_numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
