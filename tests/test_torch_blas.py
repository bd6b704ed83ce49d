"""The port's BLAS tile operations against the JAX reference's
(``dlaf_tpu/tile_ops/blas.py``): ``gemm``, ``herk``, ``hemm`` and
``her2k`` on the same seeded operands, float64 and complex128, both
triangles and ops, under ``f64_gemm`` "native" and "mxu" (at
``f64_gemm_min_dim=16``, the "jnp" reduction in both packages). Under
"mxu" both packages make the same, nonzero, number of Ozaki calls.
Tolerance: ``1e-13`` relative to the largest entry (the same products;
the library's summation order may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlaf_tpu import config as jcfg
from dlaf_tpu.tile_ops import blas as jtb
from dlaf_tpu.tile_ops import ozaki as joz
from dlaf_tpu_torch import config
from dlaf_tpu_torch.tile_ops import blas as tb
from dlaf_tpu_torch.tile_ops import ozaki as oz
from test_torch_cholesky_routes import count_entry_calls

KNOBS = ("F64_GEMM", "F64_GEMM_MIN_DIM", "OZAKI_IMPL")


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


def _tile_op_case(name, dtype, rng):
    def mat(*shape):
        x = rng.standard_normal(shape)
        if np.dtype(dtype).kind == "c":
            x = x + 1j * rng.standard_normal(shape)
        return x.astype(dtype)

    a, b, c = mat(24, 16), mat(16, 20), mat(24, 20)
    sq, sq2, cs = mat(24, 24), mat(24, 16), mat(24, 24)
    return {
        "gemm": (lambda m: m.gemm(a, b, c, alpha=-1.0, beta=1.0),
                 lambda m: m.gemm(sq2, sq2, cs, alpha=0.5, beta=2.0, op_b="C")),
        "herk": (lambda m: m.herk("L", "N", sq2, cs, alpha=-1.0),
                 lambda m: m.herk("U", "C", a.T.copy(), cs, alpha=0.5, beta=2.0)),
        "hemm": (lambda m: m.hemm("L", "L", sq, sq2, sq2, alpha=-1.0, beta=1.0),
                 lambda m: m.hemm("R", "U", sq, c.T.copy(), alpha=2.0)),
        "her2k": (lambda m: m.her2k("L", "N", sq2, a, cs, alpha=-1.0),
                  lambda m: m.her2k("U", "C", sq2.T.copy(), a.T.copy(), cs, alpha=0.5, beta=2.0)),
    }[name]


@pytest.mark.parametrize("f64_gemm", ["native", "mxu"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("name", ["gemm", "herk", "hemm", "her2k"])
def test_tile_ops_match_reference(name, dtype, f64_gemm, monkeypatch):
    """Two calls per op (both triangles, both ops); under mxu both
    packages take the Ozaki route."""
    for k, v in {"f64_gemm": f64_gemm, "f64_gemm_min_dim": 16, "ozaki_impl": "jnp"}.items():
        monkeypatch.setenv("DLAF_" + k.upper(), str(v))
    config.initialize()
    jcfg.initialize()
    for fn in _tile_op_case(name, dtype, np.random.default_rng(7)):
        jcalls = count_entry_calls(monkeypatch, joz)
        ref = np.asarray(fn(_Jax()))
        pcalls = count_entry_calls(monkeypatch, oz)
        got = fn(_Port()).numpy()
        assert pcalls[0] == jcalls[0] and (pcalls[0] > 0) == (f64_gemm == "mxu")
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13 * np.abs(ref).max())


class _Jax:
    """The reference's tile ops on numpy operands."""

    def __getattr__(self, name):
        fn = getattr(jtb, name)
        return lambda *args, **kw: fn(*(jnp.asarray(x) if isinstance(x, np.ndarray) else x
                                        for x in args), **kw)


class _Port:
    """The port's tile ops on numpy operands (CPU tensors)."""

    def __getattr__(self, name):
        fn = getattr(tb, name)
        return lambda *args, **kw: fn(*(torch.tensor(x) if isinstance(x, np.ndarray) else x
                                        for x in args), **kw)
