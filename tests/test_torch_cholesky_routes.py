"""The local Cholesky routes of the PyTorch port beyond loop and biggemm, against
the JAX reference: trailing "ozaki" (f64/complex128 mixed panels + Ozaki
products), "scan" (the telescoped uniform-step builder with the fused
factor+solve kernel or the f64 routes), "invgemm" and "xla".

Both packages read the same knobs from the environment
(``DLAF_<KNOB>``), so each case sets them once and factors one seeded
numpy HPD matrix with a ragged last tile through
``dlaf_tpu.algorithms.cholesky.cholesky`` (Pallas kernels in interpret
mode) and through the port's ``cholesky`` on CPU tensors, where each kernel
wrapper runs its plain version.

Tolerances: the factors agree to the reference's residual budget
``60 * n * eps`` relative to the largest entry (the mixed panels' f32 seeds
come from two libraries). ``factor_solve``'s plain version agrees with the
Pallas kernel to ``8 * d * eps_f32`` (same math, another summation order).
Inside the port the knob contracts are bitwise: lookahead on/off and
with_info on/off.

The "loop" route's per-column herk and gemm follow ``f64_gemm`` in both
packages: under "mxu" both make the same (nonzero) number of Ozaki calls.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlaf_tpu import config as jcfg
from dlaf_tpu.algorithms.cholesky import cholesky as jax_cholesky
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu.tile_ops import ozaki as joz
from dlaf_tpu.tile_ops import pallas_panel as ppan
from dlaf_tpu_torch import config
from dlaf_tpu_torch.algorithms.cholesky import cholesky
from dlaf_tpu_torch.common.index2d import TileElementSize
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.miniapp import miniapp_cholesky
from dlaf_tpu_torch.tile_ops import ozaki as oz
from dlaf_tpu_torch.tile_ops import ozaki_kernels as ok
from dlaf_tpu_torch.tile_ops import panel_kernels as pk

KNOBS = ("CHOLESKY_TRAILING", "CHOLESKY_LOOKAHEAD", "PANEL_IMPL", "STEP_IMPL", "OZAKI_IMPL",
         "F64_GEMM", "F64_TRSM", "F64_GEMM_SLICES", "F64_GEMM_MIN_DIM")
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    jcfg.initialize()
    yield
    for knob in KNOBS:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    jcfg.initialize()


def set_knobs(monkeypatch, knobs):
    for k, v in knobs.items():
        monkeypatch.setenv("DLAF_" + k.upper(), str(v))
    config.initialize()
    jcfg.initialize()


def hpd(n, dtype, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal((n, n))
    return (x @ x.conj().T + n * np.eye(n)).astype(dtype)


def port_factor(a, uplo, nb, **kw):
    out = cholesky(uplo, Matrix.from_global(a, TileElementSize(nb, nb), device="cpu"), **kw)
    if kw.get("with_info"):
        return out[0].to_numpy(), int(out[1])
    return out.to_numpy()


def jax_factor(a, uplo, nb):
    return np.asarray(jax_cholesky(uplo, JMatrix.from_global(a, JTileElementSize(nb, nb)))
                      .to_numpy())


OZAKI = {"cholesky_trailing": "ozaki"}
# f64_gemm_min_dim at the tests' block sizes, so that both packages put the
# scan builder's products on the Ozaki route
SCAN_F64 = {"cholesky_trailing": "scan", "f64_gemm": "mxu", "f64_trsm": "mixed",
            "ozaki_impl": "pallas", "f64_gemm_min_dim": 16}

# (name, dtype, n, nb, knobs, uplo)
CASES = [
    ("ozaki-jnp", np.float64, 72, 32, {**OZAKI, "cholesky_lookahead": 1}, "L"),
    ("ozaki-jnp", np.complex128, 48, 32, OZAKI, "U"),
    ("ozaki-pallas", np.float64, 72, 32, {**OZAKI, "ozaki_impl": "pallas"}, "U"),
    ("ozaki-pallas", np.complex128, 48, 32,
     {**OZAKI, "ozaki_impl": "pallas", "cholesky_lookahead": 1}, "L"),
    ("ozaki-pallas", np.complex128, 48, 32, {**OZAKI, "ozaki_impl": "pallas"}, "U"),
    ("scan-step", np.float32, 72, 16, {"cholesky_trailing": "scan", "step_impl": "fused"}, "L"),
    ("scan-step", np.float32, 72, 16,
     {"cholesky_trailing": "scan", "step_impl": "fused", "cholesky_lookahead": 1}, "U"),
    ("scan-f64", np.float64, 72, 32, {**SCAN_F64, "cholesky_lookahead": 1}, "L"),
    ("scan-f64", np.float64, 72, 32, SCAN_F64, "U"),
    ("scan-f64", np.complex128, 48, 32, SCAN_F64, "L"),
    ("scan-f64", np.complex128, 48, 32, {**SCAN_F64, "cholesky_lookahead": 1}, "U"),
    ("invgemm", np.float64, 72, 32, {"cholesky_trailing": "invgemm"}, "L"),
    ("invgemm", np.complex128, 48, 32,
     {"cholesky_trailing": "invgemm", "cholesky_lookahead": 1}, "U"),
    ("xla", np.float64, 72, 32, {"cholesky_trailing": "xla"}, "U"),
    ("xla", np.complex128, 48, 32, {"cholesky_trailing": "xla"}, "L"),
]


def count_ozaki_calls(monkeypatch):
    """Calls of the two Ozaki reductions: the slice kernels' plain versions
    ("pallas" on CPU tensors) and the composed group sums ("jnp")."""
    calls = {"kernels": 0, "jnp": 0}

    def counted(key, fn):
        def wrapper(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    for name in ("ozaki_product_plain", "ozaki_syrk_plain"):
        monkeypatch.setattr(ok, name, counted("kernels", getattr(ok, name)))
    monkeypatch.setattr(oz, "_composed", counted("jnp", oz._composed))
    return calls


@pytest.mark.parametrize("name,dtype,n,nb,knobs,uplo", CASES,
                         ids=[f"{c[0]}-{np.dtype(c[1]).name}-{c[5]}" for c in CASES])
def test_route_matches_reference(name, dtype, n, nb, knobs, uplo, monkeypatch):
    set_knobs(monkeypatch, knobs)
    a = hpd(n, dtype)
    ref = jax_factor(a, uplo, nb)
    calls = count_ozaki_calls(monkeypatch)
    got, info = port_factor(a, uplo, nb, with_info=True)
    assert info == 0
    # the port took the route the case names
    oz_route = name.startswith(("ozaki", "scan-f64"))
    assert (calls["kernels"] > 0) == (oz_route and knobs.get("ozaki_impl") == "pallas")
    assert (calls["jnp"] > 0) == (name == "ozaki-jnp")
    keep = np.tril if uplo == "L" else np.triu
    f = keep(got)
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 60 * n * np.finfo(dtype).eps
    herm = np.tril(a) + np.tril(a, -1).conj().T if uplo == "L" else \
        np.triu(a) + np.triu(a, 1).conj().T
    rec = f @ f.conj().T if uplo == "L" else f.conj().T @ f
    assert np.abs(rec - herm).max() / np.abs(herm).max() <= 60 * n * np.finfo(dtype).eps
    # the opposite triangle passes through untouched
    other = (np.triu if uplo == "L" else np.tril)
    k = 1 if uplo == "L" else -1
    np.testing.assert_array_equal(other(got, k), other(a, k))


# the routes whose two orders compute the same products (see the module
# docstring of dlaf_tpu_torch.algorithms.cholesky)
BITWISE = [
    ("ozaki-jnp", np.float64, {**OZAKI}),
    ("ozaki-pallas", np.float64, {**OZAKI, "ozaki_impl": "pallas"}),
    ("scan-step", np.float32, {"cholesky_trailing": "scan", "step_impl": "fused"}),
    ("scan-f64", np.float64, SCAN_F64),
    # complex Ozaki products are not bitwise across the two orders (the
    # strip is four real products where the other order forms it inside a
    # herk), so the complex case holds the mixed panels on native products
    ("scan-f64", np.complex128, {**SCAN_F64, "f64_gemm_min_dim": 128}),
    ("scan-native", np.complex128, {"cholesky_trailing": "scan"}),
    ("invgemm", np.float64, {"cholesky_trailing": "invgemm"}),
]


@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("name,dtype,knobs", BITWISE,
                         ids=[f"{c[0]}-{np.dtype(c[1]).name}" for c in BITWISE])
def test_lookahead_and_info_bitwise_within_port(name, dtype, knobs, uplo, monkeypatch):
    a = hpd(72, dtype, seed=8)
    set_knobs(monkeypatch, {**knobs, "cholesky_lookahead": 0})
    r0 = port_factor(a, uplo, 16)
    set_knobs(monkeypatch, {**knobs, "cholesky_lookahead": 1})
    r1, info = port_factor(a, uplo, 16, with_info=True)
    np.testing.assert_array_equal(r1, r0)
    assert info == 0


@pytest.mark.parametrize("knobs,col", [
    ({"cholesky_trailing": "scan", "step_impl": "fused"}, 37),
    (OZAKI, 40),
    ({"cholesky_trailing": "xla"}, 40),
])
def test_info_on_indefinite_matrix(knobs, col, monkeypatch):
    """First failing column, 1-based: the fused factor locates it inside
    its tile; the native f64 factors (the mixed panel's fallback, the
    whole-matrix library call) at the column itself."""
    set_knobs(monkeypatch, knobs)
    dtype = np.float32 if "step_impl" in knobs else np.float64
    a = hpd(72, dtype, seed=4)
    a[col, col] = -1000.0
    _, info = port_factor(a, "L", 16, with_info=True)
    assert info == col + 1


@pytest.mark.parametrize("d,rows", [(16, 40), (20, 70), (16, 0)])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_factor_solve_plain_matches_fused_factor_solve(uplo, d, rows):
    rng = np.random.default_rng(d + rows)
    x = rng.standard_normal((d, d))
    diag = (x @ x.T + d * np.eye(d)).astype(np.float32)
    strip = rng.standard_normal((rows, d)).astype(np.float32)
    if uplo == "U":
        diag, strip = diag.T.copy(), strip.T.copy()
    rf, rp = ppan.fused_factor_solve(uplo, jnp.asarray(diag), jnp.asarray(strip), interpret=True)
    gf, gp = pk.factor_solve(uplo, torch.tensor(diag), torch.tensor(strip))
    assert tuple(gp.shape) == strip.shape
    tol = 8 * d * EPS32
    assert np.abs(gf.numpy() - np.asarray(rf)).max() / np.abs(np.asarray(rf)).max() <= tol
    if rows:
        assert np.abs(gp.numpy() - np.asarray(rp)).max() / np.abs(np.asarray(rp)).max() <= tol


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_factor_solve_plain_matches_fused_factor_solve_batched(uplo):
    """A stacked (R, d, d) tile batch, flattened to rows as the reference
    does (pallas_panel.py:483-492)."""
    d = 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((d, d))
    diag = (x @ x.T + d * np.eye(d)).astype(np.float32)
    batch = rng.standard_normal((3, d, d)).astype(np.float32)
    rf, rp = ppan.fused_factor_solve(uplo, jnp.asarray(diag), jnp.asarray(batch),
                                     interpret=True)
    gf, gp = pk.factor_solve(uplo, torch.tensor(diag), torch.tensor(batch))
    assert tuple(gp.shape) == (3, d, d)
    tol = 8 * d * EPS32
    for g, r in ((gf, rf), (gp, rp)):
        assert np.abs(g.numpy() - np.asarray(r)).max() / np.abs(np.asarray(r)).max() <= tol


def test_scan_route_counts_factor_solve_calls_not_launches(monkeypatch):
    """On CPU tensors the scan route runs the plain factor+solve once per
    step and launches nothing; the Ozaki route launches nothing either."""
    pk.reset_launches()
    ok.reset_launches()
    set_knobs(monkeypatch, {"cholesky_trailing": "scan", "step_impl": "fused"})
    port_factor(hpd(72, np.float32), "L", 16)
    set_knobs(monkeypatch, {**OZAKI, "ozaki_impl": "pallas"})
    port_factor(hpd(72, np.float64), "U", 32)
    assert set(pk.LAUNCHES.values()) == {0} and set(ok.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("letter,uplo,extra", [
    ("d", "L", ["--dlaf:cholesky-trailing=ozaki", "--dlaf:ozaki-impl=pallas",
                "--dlaf:cholesky-lookahead=1"]),
    ("z", "U", ["--dlaf:cholesky-trailing=ozaki", "--dlaf:ozaki-impl=pallas"]),
    ("d", "U", ["--dlaf:cholesky-trailing=scan", "--dlaf:f64-gemm=mxu",
                "--dlaf:f64-trsm=mixed", "--dlaf:f64-gemm-min-dim=32"]),
])
def test_miniapp_f64_routes_on_cpu(letter, uplo, extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = miniapp_cholesky.run(["-m", "72", "-b", "32", "--type", letter, "--uplo", uplo,
                                    "--backend", "cpu", "--nruns", "1",
                                    "--check-result", "last", *extra])
    lines = buf.getvalue().splitlines()
    assert len(res) == 1
    assert f" {letter}{uplo} (72, 72) (32, 32) (1, 1) " in lines[0]
    assert lines[-1].startswith("check: PASSED residual=")


def count_entry_calls(monkeypatch, module):
    """Calls of ``module``'s real Ozaki entries (``matmul_f64``,
    ``syrk_f64``): every product and gram on the Ozaki route."""
    calls = [0]
    for name in ("matmul_f64", "syrk_f64"):
        fn = getattr(module, name)

        def wrapper(*args, _fn=fn, **kw):
            calls[0] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("dtype,impl", [(np.float64, "jnp"), (np.float64, "pallas"),
                                        (np.complex128, "jnp")])
def test_loop_route_follows_f64_gemm(dtype, impl, monkeypatch):
    """``cholesky_trailing=loop`` under ``f64_gemm=mxu``: the per-column
    herk and gemm take the Ozaki route in the port as in the reference
    (equal, nonzero call counts: the reference's program is traced afresh
    for the knobs), and the factors agree."""
    set_knobs(monkeypatch, {"cholesky_trailing": "loop", "f64_gemm": "mxu",
                            "f64_gemm_min_dim": 16, "ozaki_impl": impl})
    n = 64
    a = hpd(n, dtype, seed=5)
    jcalls = count_entry_calls(monkeypatch, joz)
    ref = jax_factor(a, "L", 16)
    pcalls = count_entry_calls(monkeypatch, oz)
    got = port_factor(a, "L", 16)
    assert pcalls[0] == jcalls[0] > 0
    eps = np.finfo(dtype).eps
    assert np.abs(np.tril(got) - np.tril(ref)).max() / np.abs(ref).max() <= 60 * n * eps
