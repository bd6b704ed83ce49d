"""Distributed HEGST (``gen_to_std`` on a grid) of the PyTorch port against
the JAX reference.

The reference's ``shard_map`` programs run on the virtual CPU mesh; the
port's per-rank loops with every rank on the CPU. B is factored by the
reference, and its shards and A's cross into the port through
``matrix/convert.from_jax_storage`` (see ``test_torch_gen_to_std``), on
2x2, 2x4 and 4x2 grids with the source rank (1, 1) (wrapped to the grid)
or (1, 2), and ragged n. Tolerance: ``2000 eps`` of the type, rtol and
atol, as the reference's ``_tol``. The knobs, ``with_info`` and the
donation contract are in ``test_torch_gen_to_std_dist_knobs``.
"""

import numpy as np
import pytest

from dlaf_tpu.algorithms.gen_to_std import gen_to_std as j_gen_to_std
from dlaf_tpu_torch.algorithms.gen_to_std import gen_to_std
from test_torch_gen_to_std import _fresh_config  # noqa: F401 (autouse fixture)
from test_torch_gen_to_std import check, count_right_solves, herm, inputs, set_knobs

# (grid, source rank, uplo, dtype, n, nb)
CASES = [((2, 2), (1, 1), "L", np.float64, 13, 4), ((2, 2), (1, 1), "U", np.float64, 13, 4),
         ((2, 2), (1, 1), "L", np.complex128, 13, 4), ((2, 2), (1, 1), "U", np.complex128, 13, 4),
         ((2, 2), (1, 1), "L", np.float32, 13, 4), ((2, 2), (1, 1), "U", np.float32, 12, 4),
         ((2, 2), (1, 1), "L", np.float64, 8, 8),
         ((2, 4), (1, 1), "L", np.float64, 21, 4), ((2, 4), (1, 2), "U", np.complex128, 21, 4),
         ((4, 2), (1, 1), "U", np.float64, 21, 4), ((4, 2), (1, 1), "L", np.complex128, 18, 4)]


def case_id(c):
    return f"{c[0][0]}x{c[0][1]}-src{c[1][0]}{c[1][1]}-{c[2]}-{np.dtype(c[3]).name}-{c[4]}-{c[5]}"


def run_both(grid, src, uplo, dtype, n, nb, devices8, seeds=(4, 5)):
    a, b = herm(n, dtype, seeds[0]), herm(n, dtype, seeds[1], pd=True)
    ja, jb, pa, pb = inputs(uplo, a, b, nb, grid, src, devices8)
    ref = np.asarray(j_gen_to_std(uplo, ja, jb).to_numpy())
    return a, ref, gen_to_std(uplo, pa, pb).to_numpy(), pb.to_numpy()


@pytest.mark.parametrize("grid,src,uplo,dtype,n,nb", CASES, ids=[case_id(c) for c in CASES])
def test_blocked_matches_reference(grid, src, uplo, dtype, n, nb, devices8, monkeypatch):
    set_knobs(monkeypatch, {"hegst_impl": "blocked"})
    a, ref, got, f = run_both(grid, src, uplo, dtype, n, nb, devices8)
    check(uplo, a, ref, got, f, dtype)


@pytest.mark.parametrize("grid,uplo", [((2, 2), "L"), ((2, 4), "U")])
def test_fused_panel_matches_reference(grid, uplo, devices8, monkeypatch):
    """float32, ``panel_impl=fused``: every rank solves two diagonal
    strips every step and its panel slot every step but the last
    (P Q (3 nt - 1) strip solves)."""
    set_knobs(monkeypatch, {"hegst_impl": "blocked", "panel_impl": "fused"})
    n, nb = 13, 4
    a, b = herm(n, np.float32, 6), herm(n, np.float32, 7, pd=True)
    ja, jb, pa, pb = inputs(uplo, a, b, nb, grid, (1, 1), devices8)
    ref = np.asarray(j_gen_to_std(uplo, ja, jb).to_numpy())
    calls = count_right_solves(monkeypatch)
    got = gen_to_std(uplo, pa, pb).to_numpy()
    assert calls[0] == grid[0] * grid[1] * (3 * 4 - 1)
    check(uplo, a, ref, got, pb.to_numpy(), np.float32)


@pytest.mark.parametrize("case", ["s-2x2", "s-U-2x4", "s-local", "z-mxu-2x2"])
def test_chip_smoke_launch_formulas_on_cpu(case, monkeypatch):
    """The counts ``chip_smoke.py`` asserts for its HEGST paths (one
    miniapp run: its HEGST calls and the Cholesky of B), held by the calls
    of the kernels' plain versions on the cuda defaults at small nt (a
    left-side solve and an upper factor+solve run as their mirror: counted
    once)."""
    import contextlib
    import io

    import chip_smoke as cs
    from dlaf_tpu_torch.miniapp import miniapp_gen_to_std
    from dlaf_tpu_torch.tile_ops import ozaki_kernels as ok
    from dlaf_tpu_torch.tile_ops import panel_kernels as pk
    from dlaf_tpu_torch.tile_ops import update_kernels as uk

    monkeypatch.setenv("DLAF_FORCE_PALLAS_UPDATE", "1")
    calls = {}
    for mod, name, key, skip in (
            (pk, "panel_solve_plain", "solve", "L"), (pk, "potrf_plain", "potrf", None),
            (pk, "factor_solve_plain", "factor_solve", "U"), (pk, "step_plain", "step", None),
            (ok, "ozaki_product_plain", "ozaki_product", None),
            (uk, "masked_trailing_update_plain", "masked_trailing_update", None)):
        def wrapper(*args, _fn=getattr(mod, name), _key=key, _skip=skip, **kw):
            calls[_key] = calls.get(_key, 0) + (args[0] != _skip)
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, wrapper)
    cuda = ["--dlaf:cholesky-trailing=biggemm", "--dlaf:cholesky-lookahead=1",
            "--dlaf:comm-lookahead=1", "--dlaf:panel-impl=fused", "--dlaf:step-impl=fused",
            "--dlaf:ozaki-impl=pallas", "--dlaf:hegst-impl=blocked", "--backend", "cpu"]
    runs = ["--nruns", "2", "--nwarmups", "1", "--check-result", "last"]
    n, argv, expect = {
        "s-2x2": (48, ["--type", "s", "--grid-rows", "2", "--grid-cols", "2",
                       "--share-device", *runs],
                  cs.hegst_expect(2, 2, 3, ("solve",), cs.CHOL_F32_GRID)),
        "s-U-2x4": (48, ["--type", "s", "--uplo", "U", "--grid-rows", "2", "--grid-cols", "4",
                         "--share-device", *runs],
                    cs.hegst_expect(2, 4, 3, ("solve",), cs.CHOL_F32_GRID)),
        "s-local": (48, ["--type", "s", *runs],
                    cs.hegst_expect(1, 1, 3, ("solve",), cs.CHOL_F32_LOCAL)),
        "z-mxu-2x2": (56, ["--type", "z", "--grid-rows", "2", "--grid-cols", "2",
                           "--share-device", "--nruns", "1", "--nwarmups", "1",
                           "--check-result", "last", "--dlaf:f64-gemm=mxu",
                           "--dlaf:f64-trsm=mixed", "--dlaf:f64-gemm-min-dim=8"],
                      cs.hegst_expect(2, 2, 2, ("ozaki_product",), cs.CHOL_Z_MXU_GRID)),
    }[case]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        miniapp_gen_to_std.run(["-m", str(n), "-b", "8", *argv, *cuda])
    nt = n // 8
    assert "check: PASSED" in buf.getvalue()
    assert {k: v for k, v in calls.items() if v} == {k: f(nt) for k, f in expect.items()}
