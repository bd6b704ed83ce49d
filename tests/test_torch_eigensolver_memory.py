"""The generalized eigensolver's memory on BASELINE config #5's grid shape
(8x8, every rank on one device), counted on the CPU.

A dispatch mode counts the bytes of the storages that ops create and that
are still alive, and each stage's rise above its entry, in units of one
``n x n`` float64 matrix. The count on the CPU is the count on the card:
the routes are set to cuda's (``biggemm`` Cholesky, twosolve HEGST, the
look-aheads on), and the same allocations happen on either device. On a
shared device the D&C's sharded merges used to give every rank of a grid
line its own copy of the ``qc`` columns and of the row panel of
``blkdiag(Q1, Q2)``, and the chase back-transform padded the reflectors
and E to twice their rows; the bounds hold those copies out.
"""

import contextlib
import importlib
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from dlaf_tpu_torch import config
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common import timer
from dlaf_tpu_torch.common.index2d import TileElementSize
from dlaf_tpu_torch.matrix.matrix import Matrix

pe = importlib.import_module("dlaf_tpu_torch.eigensolver.eigensolver")

#: cuda's auto routes, set explicitly so that the CPU takes them
CUDA_ROUTES = {"CHOLESKY_TRAILING": "biggemm", "CHOLESKY_LOOKAHEAD": "1",
               "COMM_LOOKAHEAD": "1", "HEGST_IMPL": "twosolve"}


class LiveBytes(TorchDispatchMode):
    """Bytes of the storages created by ops under this mode that some
    tensor still holds (``cur``), and their most since ``peak`` was last
    set."""

    def __init__(self):
        super().__init__()
        self.cur = self.peak = 0
        self.refs = {}

    def _drop(self, key):
        entry = self.refs[key]
        entry[0] -= 1
        if entry[0] == 0:
            self.cur -= entry[1]
            del self.refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = st.data_ptr()
                if key == 0:
                    continue
                entry = self.refs.setdefault(key, [0, st.nbytes()])
                if entry[0] == 0:
                    self.cur += entry[1]
                    self.peak = max(self.peak, self.cur)
                entry[0] += 1
                weakref.finalize(t, self._drop, key)
        return out


@pytest.fixture(autouse=True)
def _cuda_routes(monkeypatch):
    for knob, value in CUDA_ROUTES.items():
        monkeypatch.setenv("DLAF_" + knob, value)
    config.initialize()
    yield
    monkeypatch.undo()
    config.initialize()


def test_stage_rises_on_a_shared_8x8_grid(monkeypatch):
    """Each stage's rise above its entry, in matrices, at n=256, nb=16
    (each rank owns 2 x 2 tiles), band 16, the D&C's merges of order 64 and
    more sharded over the 64 ranks (the threshold lowered from 512): the
    D&C's within 5 and the chase back-transform's within 11 (2.5 and 8.6;
    16.5 and 19.4 with the per-rank copies), and no stage's above 11."""
    ts = importlib.import_module("dlaf_tpu_torch.eigensolver.tridiag_solver")
    monkeypatch.setattr(ts, "_SHARD_MERGE_MIN_N", 64)
    n, nb = 256, 16
    rng = np.random.default_rng(21)
    x = rng.standard_normal((n, n))
    a = (x + x.T) / 2
    b = x @ x.T / n + np.eye(n)
    grid = shared_grid(8, 8, "cpu")
    am = Matrix.from_global(a, TileElementSize(nb, nb), grid, device="cpu")
    bm = Matrix.from_global(b, TileElementSize(nb, nb), grid, device="cpu")
    mode = LiveBytes()
    rises = {}
    phase = timer.PhaseTimer.phase

    @contextlib.contextmanager
    def counted(self, name, **attrs):
        entry = mode.peak = mode.cur
        with phase(self, name, **attrs):
            yield
        rises[name] = (mode.peak - entry) / (n * n * 8)

    monkeypatch.setattr(timer.PhaseTimer, "phase", counted)
    with mode:
        res = pe.gen_eigensolver("L", am, bm, band_size=16, donate=True)
    assert rises["stage.tridiag_solver"] < 5, rises
    assert rises["stage.bt_band_to_tridiag"] < 11, rises
    assert max(rises.values()) < 11, rises
    w = np.linalg.eigvalsh(np.linalg.solve(np.linalg.cholesky(b), a)
                           @ np.linalg.inv(np.linalg.cholesky(b)).T)
    np.testing.assert_allclose(res.eigenvalues, w, rtol=0, atol=1e-11 * np.abs(w).max())
