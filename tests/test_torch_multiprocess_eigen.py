"""The multi-process form of the eigensolver pipeline, against the port's
single controller and against the JAX reference, on the CPU.

``tests/test_torch_multiprocess.py``'s harness with worlds of their own
(the 2x2 grid with source rank (0, 1) and the 1x3 grid with uneven tiles,
one process per rank running ``torch_mp_worker.EIGEN_CASES``): reduction
to band (unrolled, with look-ahead, scan, on the Ozaki route; the band and
the taus), the band's gather on rank (0, 0)'s process, both
back-transforms and the standard and generalized eigensolvers, each held
bitwise to ``shared_grid(P, Q, "cpu")``. The chase and the D&C run on
rank (0, 0)'s process only, and the other processes create no
floating-point tensor of ``n x n`` elements from the band's gather to Q's
scatter. With the D&C's sharding threshold lowered for a case, its merges
run sharded on every process, bitwise the single controller's, and no
process creates an ``n x n`` tensor. The 2x2 generalized eigensolver is held against ``dlaf_tpu``'s
distributed one on the virtual CPU devices at the reference's eigenpair
budget, ``200 n eps``.
"""

import importlib
import os
import time

import numpy as np
import pytest
import torch

import torch_mp_worker as w
from dlaf_tpu import config as jcfg
from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu.common.index2d import RankIndex2D as JRankIndex2D
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu_torch import config
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.miniapp.miniapp_eigensolver import eigen_residuals
from test_torch_multiprocess import compare, joined, join, load, single, spawn  # noqa: F401

je = importlib.import_module("dlaf_tpu.eigensolver.eigensolver")

#: Seconds a spawned world may take for all its cases.
TIMEOUT = 150.0


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both grids' eigensolver worlds, spawned together; their output
    directories."""
    dirs = {g: str(tmp_path_factory.mktemp(f"mpe{g}")) for g in w.GRIDS}
    procs = {g: spawn(w.GRIDS[g][0], w.GRIDS[g][1], dirs[g], mode="eigen") for g in w.GRIDS}
    errors = {}
    for g, ps in procs.items():
        try:
            join(ps, TIMEOUT)
        except (TimeoutError, RuntimeError) as e:
            errors[g] = e
    return dirs, errors


@pytest.mark.parametrize("name", list(w.EIGEN_CASES))
@pytest.mark.parametrize("g", list(w.GRIDS))
def test_multiprocess_eigen_bitwise_single_controller(worlds, single, g, name):
    compare(load(worlds, g, name), single(name, g))


@pytest.mark.parametrize("g", list(w.GRIDS))
def test_chase_and_dc_on_rank_00_only(worlds, g):
    """Process 0 drives rank (0, 0): it alone chases the band and runs the
    D&C; the others hold no n x n floating-point tensor between the
    band's gather and Q's scatter, and every process returns the same
    eigenvalues."""
    dirs, errors = worlds
    if g in errors:
        raise errors[g]
    P, Q, _, n, _ = w.GRIDS[g]
    got = [torch.load(os.path.join(dirs[g], f"span.r{i}.pt")) for i in range(P * Q)]
    assert (got[0]["chase"], got[0]["dc"]) == (1, 1)
    assert got[0]["largest"] >= n * n      # Q itself, on rank (0, 0)'s process
    for r in got[1:]:
        assert (r["chase"], r["dc"]) == (0, 0)
        assert 0 < r["largest"] < n * n, r["largest"]
        np.testing.assert_array_equal(r["eigenvalues"].numpy(), got[0]["eigenvalues"].numpy())


@pytest.mark.parametrize("g", list(w.GRIDS))
def test_sharded_dc_holds_no_whole_q(worlds, g):
    """With the D&C's merges sharded, no process creates a floating-point
    tensor of ``n x n`` elements or more (its largest: a row panel of
    ``blkdiag(Q1, Q2)`` or a grid column's ``qc`` columns)."""
    dirs, errors = worlds
    if g in errors:
        raise errors[g]
    P, Q = w.GRIDS[g][:2]
    for i in range(P * Q):
        got = torch.load(os.path.join(dirs[g], f"dcpeak.r{i}.pt"))
        assert 0 < got["largest"] < got["n"] ** 2, (i, got)


@pytest.mark.parametrize("uplo,dtype", [("L", np.float64), ("U", np.complex128)])
def test_multiprocess_gen_eigensolver_matches_reference(worlds, monkeypatch, devices8, uplo,
                                                        dtype):
    """The 2x2 processes' generalized eigenpairs against the reference's
    distributed ``gen_eigensolver``: the eigenvalues, and the eigenpair
    residual and B-orthogonality of the processes' eigenvectors, within
    the reference's ``200 n eps`` (EIGEN_BUDGETS)."""
    P, Q, src, n, nb = w.GRIDS["2x2"]
    name = f"gen_evp-{'d' if dtype == np.float64 else 'z'}-{uplo}"
    for knob in w.KNOBS:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    jcfg.initialize()
    a, b = w.herm(n, dtype), w.hpd(n, dtype, seed=19)
    jgrid = JGrid(P, Q, devices=devices8[:P * Q])
    tile, jsrc = JTileElementSize(nb, nb), JRankIndex2D(*src)
    ref = je.gen_eigensolver(uplo, JMatrix.from_global(w.stored(a, uplo), tile, grid=jgrid,
                                                       source_rank=jsrc),
                             JMatrix.from_global(w.stored(b, uplo), tile, grid=jgrid,
                                                 source_rank=jsrc), band_size=w.BAND)
    ref_lam = np.asarray(ref.eigenvalues)
    base = w.run_case(name, shared_grid(P, Q, "cpu"), monkeypatch.setenv,
                      lambda k: monkeypatch.delenv(k, raising=False))["mat"]
    z = joined(worlds, "2x2", name, base)
    budget = 200 * n * np.finfo(np.float64).eps
    for r in load(worlds, "2x2", name):
        lam = r["ok"]["array"].numpy()
        assert np.abs(lam - ref_lam).max() <= budget * np.abs(ref_lam).max()
        vals = eigen_residuals(torch.as_tensor(a), torch.as_tensor(b), lam, torch.as_tensor(z))
        assert vals["eigen_residual"] < budget, vals
        assert vals["orthogonality"] < budget, vals
    config.initialize()


def test_a_hanging_eigen_world_fails_the_harness(tmp_path):
    """The same hang guard as the other worlds': rank 0 waits in a
    broadcast that rank 1 never joins, and the harness kills both."""
    procs = spawn(1, 2, str(tmp_path), mode="hang")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        join(procs, 12.0)
    assert time.monotonic() - t0 < 30
    assert all(p.poll() is not None for p in procs)
