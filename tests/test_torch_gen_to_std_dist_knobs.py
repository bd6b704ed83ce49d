"""Distributed HEGST of the PyTorch port against the JAX reference: the
routes and knobs (twosolve, the scan step mode, ``f64_gemm=mxu`` with
``f64_trsm=mixed``, ``lookahead`` and ``comm_lookahead``), ``with_info``,
the slot-alignment check and the ``donate=False`` contract.

Inputs and tolerances as in ``test_torch_gen_to_std_dist`` (2x4 grids,
source rank (1, 2) or (0, 0), ragged n, ``2000 eps``). Within the port
``comm_lookahead`` and ``with_info`` are bitwise, and so is ``lookahead``
on the CPU: its strip is a column (row) block of the bulk's pair product.
"""

import numpy as np
import pytest
import torch

from dlaf_tpu.algorithms.gen_to_std import gen_to_std as j_gen_to_std
from dlaf_tpu.tile_ops import ozaki as joz
from dlaf_tpu_torch.algorithms.gen_to_std import gen_to_std
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.asserts import DlafAssertError
from dlaf_tpu_torch.common.index2d import RankIndex2D, TileElementSize
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.tile_ops import ozaki as oz
from test_torch_gen_to_std import _fresh_config  # noqa: F401 (autouse fixture)
from test_torch_gen_to_std import check, count_ozaki, herm, inputs, set_knobs
from test_torch_gen_to_std_dist import run_both


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_twosolve_matches_reference_and_blocked(uplo, devices8, monkeypatch):
    out = {}
    for impl in ("blocked", "twosolve"):
        set_knobs(monkeypatch, {"hegst_impl": impl})
        a, ref, out[impl], f = run_both((2, 4), (1, 2), uplo, np.complex128, 21, 4, devices8)
        check(uplo, a, ref, out[impl], f, np.complex128)
    np.testing.assert_allclose(out["blocked"], out["twosolve"], rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_scan_step_mode_takes_twosolve(uplo, devices8, monkeypatch):
    """``dist_step_mode=scan`` routes to twosolve (whose solves run their
    scan form), whatever ``hegst_impl`` says."""
    set_knobs(monkeypatch, {"hegst_impl": "blocked", "dist_step_mode": "scan"})
    a, ref, got, f = run_both((2, 4), (0, 0), uplo, np.complex128, 21, 4, devices8)
    check(uplo, a, ref, got, f, np.complex128)
    set_knobs(monkeypatch, {"hegst_impl": "twosolve", "dist_step_mode": "scan"})
    np.testing.assert_array_equal(run_both((2, 4), (0, 0), uplo, np.complex128, 21, 4,
                                           devices8)[2], got)


@pytest.mark.parametrize("grid,uplo", [((2, 2), "L"), ((2, 4), "U")])
def test_mxu_mixed_matches_reference(grid, uplo, devices8, monkeypatch):
    """``f64_gemm=mxu`` (``f64_gemm_min_dim=4``, the "jnp" reduction) and
    ``f64_trsm=mixed``: the pair, strip and panel products on the Ozaki
    route in both packages."""
    set_knobs(monkeypatch, {"hegst_impl": "blocked", "f64_gemm": "mxu", "f64_gemm_min_dim": 4,
                            "f64_trsm": "mixed", "ozaki_impl": "jnp"})
    n, nb = 16, 4
    a, b = herm(n, np.float64, 21), herm(n, np.float64, 22, pd=True)
    ja, jb, pa, pb = inputs(uplo, a, b, nb, grid, (1, 1), devices8)
    jcalls = count_ozaki(monkeypatch, joz)
    ref = np.asarray(j_gen_to_std(uplo, ja, jb).to_numpy())
    pcalls = count_ozaki(monkeypatch, oz)
    got = gen_to_std(uplo, pa, pb).to_numpy()
    # the reference traces one program for all ranks, the port calls per
    # rank, so only the route is compared
    assert pcalls[0] > 0 and jcalls[0] > 0
    check(uplo, a, ref, got, pb.to_numpy(), np.float64)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_lookahead_and_comm_lookahead(uplo, dtype, devices8, monkeypatch):
    """On one factor: lookahead on and off bitwise, comm_lookahead on and
    off bitwise, and the reference's lookahead result within its own
    bound, ``1e-13``."""
    n, nb = 21, 4
    a, b = herm(n, dtype, 21), herm(n, dtype, 22, pd=True)
    ja, jb, pa, pb = inputs(uplo, a, b, nb, (2, 4), (1, 2), devices8)
    res = {}
    for la, cla in (("0", "0"), ("1", "0"), ("1", "1")):
        set_knobs(monkeypatch, {"hegst_impl": "blocked", "cholesky_lookahead": la,
                                "comm_lookahead": cla})
        res[la + cla] = gen_to_std(uplo, pa, pb).to_numpy()
    np.testing.assert_array_equal(res["10"], res["00"])
    np.testing.assert_array_equal(res["11"], res["10"])
    ref = np.asarray(j_gen_to_std(uplo, ja, jb).to_numpy())
    np.testing.assert_allclose(res["11"], ref, rtol=1e-13, atol=1e-13)
    check(uplo, a, ref, res["11"], pb.to_numpy(), dtype)


def port_pair(a, f, nb, grid, src_a=(1, 1), src_f=(1, 1)):
    g = shared_grid(*grid, "cpu")
    return (Matrix.from_global(a, TileElementSize(nb, nb), g, source_rank=RankIndex2D(*src_a),
                               device="cpu"),
            Matrix.from_global(f, TileElementSize(nb, nb), g, source_rank=RankIndex2D(*src_f),
                               device="cpu"))


@pytest.mark.parametrize("impl", ["blocked", "twosolve"])
@pytest.mark.parametrize("bad", [None, 9])
def test_with_info(impl, bad, monkeypatch):
    set_knobs(monkeypatch, {"hegst_impl": impl})
    n, nb = 13, 4
    a, b = herm(n, np.float64, 6), herm(n, np.float64, 7, pd=True)
    f = np.linalg.cholesky(b)
    if bad is not None:
        f[bad, bad] = 0.0
    res, info = gen_to_std("L", *port_pair(a, f, nb, (2, 2)), with_info=True)
    plain = gen_to_std("L", *port_pair(a, f, nb, (2, 2)))
    assert int(info) == (0 if bad is None else bad + 1)
    np.testing.assert_array_equal(res.to_numpy(), plain.to_numpy())


def test_misaligned_sources_raise(monkeypatch):
    set_knobs(monkeypatch, {"hegst_impl": "blocked"})
    n, nb = 16, 4
    a, b = herm(n, np.float64, 30), herm(n, np.float64, 31, pd=True)
    am, lm = port_pair(a, np.tril(np.linalg.cholesky(b)), nb, (2, 4), (0, 0), (1, 2))
    with pytest.raises(DlafAssertError, match="misaligned"):
        gen_to_std("L", am, lm)


@pytest.mark.parametrize("impl", ["blocked", "twosolve"])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_donation(impl, uplo, monkeypatch):
    """``donate=False`` leaves every shard of A and of the factor bitwise
    unchanged; the donated call gives the same result, releases A and
    keeps the factor."""
    set_knobs(monkeypatch, {"hegst_impl": impl})
    n, nb = 13, 4
    a, b = herm(n, np.complex128, 8), herm(n, np.complex128, 9, pd=True)
    f = np.linalg.cholesky(b)
    am, bm = port_pair(a, f if uplo == "L" else f.conj().T, nb, (2, 2))
    keep_a, keep_b = [s.clone() for s in am.storage], [s.clone() for s in bm.storage]
    out = gen_to_std(uplo, am, bm)
    assert all(torch.equal(x, y) for x, y in zip(am.storage, keep_a))
    assert all(torch.equal(x, y) for x, y in zip(bm.storage, keep_b))
    donated = gen_to_std(uplo, am, bm, donate=True)
    assert am.storage is None
    assert all(torch.equal(x, y) for x, y in zip(bm.storage, keep_b))
    np.testing.assert_array_equal(donated.to_numpy(), out.to_numpy())
