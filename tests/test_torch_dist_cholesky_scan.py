"""The distributed scan Cholesky of the PyTorch port against the JAX
reference's ``_build_dist_cholesky_scan``.

One seeded numpy HPD matrix with a ragged last tile goes onto the same
grid (2x2, 2x4 and 4x2, nonzero source ranks) in both packages with
``cholesky_trailing=scan``: the reference's ``shard_map`` scan program on
the virtual CPU mesh, the port's per-rank loop on the CPU (kernel wrappers
run their plain versions). The route each case names is asserted taken on
both sides. Tolerance: the reference's factor budget, ``60 n eps`` of the
type relative to the largest entry of ``A``. Within the port the
reference's knob contracts are bitwise: lookahead and with_info on or off.
The shared helpers are those of ``test_torch_dist_cholesky.py``.
"""

import numpy as np
import pytest

from test_torch_dist_cholesky import (OZ7, _fresh_config, counting, hpd, jax_factor, jchol,
                                      jpo, ok, pk, port_factor, set_knobs, uk)

assert _fresh_config  # the autouse fixture: every test starts from default knobs


# ---------------------------------------------------------------------------
# The distributed scan builder against the JAX scan builder
# ---------------------------------------------------------------------------

SCAN = {"cholesky_trailing": "scan"}
# (name, dtype, n, nb, P, Q, src, knobs, uplo): ragged n, nonzero source ranks
SCAN_CASES = [
    ("einsum", np.float32, 72, 16, 2, 2, (1, 1), {"cholesky_lookahead": 1}, "L"),
    ("einsum", np.float64, 72, 16, 2, 4, (1, 3), {}, "U"),
    ("einsum", np.float64, 72, 16, 4, 2, (3, 1), {"cholesky_lookahead": 1}, "L"),
    ("step-fused", np.float32, 72, 16, 2, 4, (1, 2), {"step_impl": "fused",
                                                      "cholesky_lookahead": 1}, "L"),
    ("step-fused", np.float32, 72, 16, 4, 2, (2, 1), {"step_impl": "fused"}, "U"),
    ("panel-fused", np.float32, 72, 16, 2, 2, (0, 1), {"panel_impl": "fused"}, "U"),
    ("oz-masked", np.float64, 72, 16, 4, 2, (1, 1), {**OZ7, "cholesky_lookahead": 1}, "U"),
    ("oz-masked", np.float64, 72, 16, 2, 4, (1, 2), OZ7, "L"),
    ("native", np.complex128, 56, 16, 2, 2, (1, 0), {"cholesky_lookahead": 1}, "U"),
    ("oz-rect", np.complex128, 40, 16, 4, 2, (1, 1), OZ7, "L"),
]


@pytest.mark.parametrize("name,dtype,n,nb,P,Q,src,knobs,uplo", SCAN_CASES,
                         ids=[f"{c[0]}-{np.dtype(c[1]).name}-{c[4]}x{c[5]}-{c[8]}"
                              for c in SCAN_CASES])
def test_dist_scan_matches_reference(name, dtype, n, nb, P, Q, src, knobs, uplo,
                                     monkeypatch, devices8):
    """The factor against the reference's scan builder at 60 n eps (the
    route the case names taken on both sides), the other triangle passed
    through, info 0."""
    set_knobs(monkeypatch, {**SCAN, **knobs})
    a = hpd(n, dtype, seed=n + P + Q)
    j_oz = counting(monkeypatch, jpo, "masked_slice_product")
    j_fs = counting(monkeypatch, jchol.ppan, "fused_factor_solve")
    ref = jax_factor(a, uplo, nb, P, Q, src, devices8)
    p_oz = counting(monkeypatch, ok, "ozaki_masked_product_plain")
    p_fs = counting(monkeypatch, pk, "factor_solve_plain")
    p_solve = counting(monkeypatch, pk, "panel_solve_plain")
    p_upd = counting(monkeypatch, uk, "masked_trailing_update_plain")
    got, info = port_factor(a, uplo, nb, P, Q, src, with_info=True)
    assert info == 0
    assert (j_oz[0] > 0) == (p_oz[0] > 0) == (name == "oz-masked")
    assert (j_fs[0] > 0) == (p_fs[0] > 0) == (name == "step-fused")
    assert (p_solve[0] > 0) == (name == "panel-fused")
    assert p_upd[0] == 0   # the update kernel is unrolled-only
    eps = np.finfo(dtype).eps
    assert np.abs(got - ref).max() / np.abs(a).max() <= 60 * n * eps
    other = np.triu if uplo == "L" else np.tril
    kk = 1 if uplo == "L" else -1
    np.testing.assert_array_equal(other(got, kk), other(a, kk))


SCAN_BITWISE = [
    ("einsum", np.float64, {}),
    ("step-fused", np.float32, {"step_impl": "fused"}),
    ("mixed", np.float64, {"f64_trsm": "mixed"}),
    ("oz-masked", np.float64, OZ7),
    ("native", np.complex128, {}),
]


@pytest.mark.parametrize("P,Q,src", [(2, 4, (1, 3)), (4, 2, (2, 1))])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("name,dtype,knobs", SCAN_BITWISE, ids=[c[0] for c in SCAN_BITWISE])
def test_dist_scan_lookahead_and_info_bitwise(name, dtype, knobs, uplo, P, Q, src,
                                              monkeypatch):
    """Within the port: lookahead on and off and with_info on and off give
    the same factor bit for bit (nt = 9 over several telescope windows),
    within 60 n eps of numpy's."""
    n = 136
    a = hpd(n, dtype, seed=11)
    results = []
    for la in (0, 1):
        set_knobs(monkeypatch, {**SCAN, **knobs, "cholesky_lookahead": la})
        results.append(port_factor(a, uplo, 16, P, Q, src))
    got, info = port_factor(a, uplo, 16, P, Q, src, with_info=True)
    assert info == 0
    np.testing.assert_array_equal(results[1], results[0])
    np.testing.assert_array_equal(got, results[0])
    f = np.linalg.cholesky(a.astype(np.complex128 if np.dtype(dtype).kind == "c"
                                    else np.float64))
    keep = np.tril if uplo == "L" else np.triu
    want = f if uplo == "L" else f.conj().T
    tol = 60 * n * np.finfo(dtype).eps * np.abs(a).max()
    assert np.abs(keep(got) - want).max() <= tol


@pytest.mark.parametrize("knobs,col", [({}, 32), ({"step_impl": "fused"}, 37),
                                       ({"panel_impl": "fused"}, 21)])
def test_dist_scan_info_matches_reference(knobs, col, monkeypatch, devices8):
    """A failing pivot under scan: the same info as the reference's scan
    builder (the composed route compared on a tile boundary, as in the
    unrolled test)."""
    set_knobs(monkeypatch, {**SCAN, **knobs, "cholesky_lookahead": 1})
    a = hpd(72, np.float32, seed=4)
    a[col, col] = -1000.0
    _, ref = jax_factor(a, "L", 16, 2, 4, (1, 2), devices8, with_info=True)
    _, info = port_factor(a, "L", 16, 2, 4, (1, 2), with_info=True)
    assert info == ref == col + 1


def test_dist_scan_launch_formulas_on_cpu(monkeypatch):
    """The counts ``chip_smoke.py`` asserts for its scan paths, held by the
    plain versions' calls: every rank runs the panel site (factor+solve,
    or potrf and solve) at every step, the last included (nt per rank);
    the f64 Ozaki route runs the pair
    product every step on every rank (the first on the zero pending
    panel), a slice product for every rank's mixed panel and one for the
    eager next row on the Q ranks that own it (k < nt-1)."""
    n, nb, P, Q = 64, 8, 2, 2
    nt = n // nb
    set_knobs(monkeypatch, {**SCAN, "step_impl": "fused", "cholesky_lookahead": 1})
    fs = counting(monkeypatch, pk, "factor_solve_plain")
    port_factor(hpd(n, np.float32, seed=3), "L", nb, P, Q)
    assert fs[0] == P * Q * nt
    set_knobs(monkeypatch, {**SCAN, "panel_impl": "fused", "step_impl": "xla"})
    potrf = counting(monkeypatch, pk, "potrf_plain")
    # a left-side solve runs as the right-side one transposed: count that
    solve = counting(monkeypatch, pk, "panel_solve_plain", when=lambda side, *_: side == "R")
    port_factor(hpd(n, np.float32, seed=3), "U", nb, P, Q)
    assert potrf[0] == solve[0] == P * Q * nt
    set_knobs(monkeypatch, {**SCAN, **OZ7, "f64_gemm_min_dim": 8, "cholesky_lookahead": 1})
    masked = counting(monkeypatch, ok, "ozaki_masked_product_plain")
    prod = counting(monkeypatch, ok, "ozaki_product_plain")
    port_factor(hpd(n, np.float64, seed=6), "U", nb, P, Q)
    assert masked[0] == P * Q * nt
    assert prod[0] == P * Q * nt + Q * (nt - 1)
