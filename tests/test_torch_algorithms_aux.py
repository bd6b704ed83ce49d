"""The rest of the port's algorithms layer against the JAX reference:
``max_norm`` (``dlaf_tpu/algorithms/norm.py``), ``general_sub_multiply``
(``general.py``), the grid ``permute`` (``permutations.py``), and the
small helpers ``layout_info``, ``round_robin``, ``printing`` and
``miniapp_gen_eigensolver``.

The same numpy-seeded matrices go through both packages without a grid,
on a 1x1 grid and on 2x2 and 2x3 grids with nonzero source ranks and a
ragged last tile (the port's ranks all on the CPU). ``max_norm`` and
``permute`` only take maxima of absolute values and move entries, so they
agree bitwise (a complex ``max_norm`` too, on unit-modulus matrices where
every entry is a candidate for the maximum: the port evaluates numpy's and
XLA's complex absolute value, not torch's, on the device);
``general_sub_multiply`` agrees at ``60 k eps`` relative
(k the range's order) under ``f64_gemm`` native and mxu (the Ozaki route,
``f64_gemm_min_dim`` lowered so it engages at these sizes).
"""

import io

import numpy as np
import pytest
import torch

from dlaf_tpu import config as jcfg
from dlaf_tpu.algorithms.general import general_sub_multiply as j_gemm
from dlaf_tpu.algorithms.norm import max_norm as j_max_norm
from dlaf_tpu.algorithms.permutations import permute as j_permute
from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu.common.index2d import LocalElementSize as JLocalElementSize
from dlaf_tpu.common.index2d import LocalTileIndex as JLocalTileIndex
from dlaf_tpu.common.index2d import RankIndex2D as JRankIndex2D
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.common.round_robin import RoundRobin as JRoundRobin
from dlaf_tpu.matrix import layout_info as jli
from dlaf_tpu.matrix import printing as jprinting
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu_torch import algorithms, config
from dlaf_tpu_torch.algorithms import general_sub_multiply, max_norm, permute
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import (LocalElementSize, LocalTileIndex, RankIndex2D,
                                           TileElementSize)
from dlaf_tpu_torch.common.round_robin import RoundRobin
from dlaf_tpu_torch.matrix import layout_info as li
from dlaf_tpu_torch.matrix import printing
from dlaf_tpu_torch.matrix.matrix import Matrix

# (grid, source rank, n, nb): local, 1x1 grid, 2x2 and 2x3 with a source
# rank offset and a partial last tile
LAYOUTS = [(None, (0, 0), 13, 4), ((1, 1), (0, 0), 13, 4), ((2, 2), (1, 1), 13, 4),
           ((2, 3), (1, 2), 21, 4), ((2, 3), (0, 1), 30, 8)]
IDS = ["local", "1x1", "2x2", "2x3", "2x3-nb8"]

DTYPES = {"d": np.float64, "s": np.float32, "z": np.complex128}


@pytest.fixture(autouse=True)
def _fresh_config(monkeypatch):
    for knob in ("F64_GEMM", "F64_GEMM_MIN_DIM", "OZAKI_IMPL"):
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    config.initialize()
    jcfg.initialize()
    yield
    config.initialize()
    jcfg.initialize()


def rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def both(a, layout, devices8):
    grid, src, _, nb = layout
    jgrid = JGrid(*grid, devices=devices8[:grid[0] * grid[1]]) if grid else None
    pgrid = shared_grid(*grid, "cpu") if grid else None
    jm = JMatrix.from_global(a, JTileElementSize(nb, nb), grid=jgrid,
                             source_rank=JRankIndex2D(*src))
    pm = Matrix.from_global(a, TileElementSize(nb, nb), pgrid, source_rank=RankIndex2D(*src),
                            device="cpu")
    return jm, pm


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
@pytest.mark.parametrize("uplo", ["G", "L"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_max_norm_bitwise(layout, uplo, dt, devices8):
    a = rand((layout[2], layout[2]), DTYPES[dt], 1)
    # the largest entry above the diagonal, so 'L' must leave it out
    a[0, layout[2] - 1] = 50
    jm, pm = both(a, layout, devices8)
    got = max_norm(pm, uplo)
    want = np.abs(np.tril(a) if uplo == "L" else a).max()
    assert got == float(want)
    assert got == j_max_norm(jm, uplo)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
@pytest.mark.parametrize("uplo", ["G", "L"])
@pytest.mark.parametrize("cdt", [np.complex128, np.complex64], ids=["z", "c"])
def test_max_norm_unit_modulus_bitwise(layout, uplo, cdt, devices8, monkeypatch):
    """Entries exp(i theta): all moduli within an ulp or two of 1, so the
    maximum is decided by the last bit of each absolute value. The port's
    chunked form (a 7-element chunk here) must pick the reference's."""
    from dlaf_tpu_torch.algorithms import norm

    monkeypatch.setattr(norm, "_CHUNK", 7)
    n = layout[2]
    theta = np.random.default_rng(7).uniform(0, 2 * np.pi, (n, n))
    a = np.exp(1j * theta).astype(cdt)
    jm, pm = both(a, layout, devices8)
    got = max_norm(pm, uplo)
    assert got == float(np.abs(np.tril(a) if uplo == "L" else a).max())
    assert got == j_max_norm(jm, uplo)


@pytest.mark.parametrize("cdt", [np.complex128, np.complex64], ids=["z", "c"])
def test_complex_abs_is_numpys_elementwise(cdt):
    """The port's complex absolute value equals numpy's bitwise on unit
    modulus, Gaussian, huge, subnormal, skewed and integer entries, and on
    zeros, infinities and NaNs."""
    from dlaf_tpu_torch.algorithms.norm import _cabs

    rng = np.random.default_rng(3)
    m = 20000
    g = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    fams = [np.exp(1j * rng.uniform(0, 2 * np.pi, m)), g, g * 1e300, g * 1e-310,
            g.real + 1j * g.imag * 10.0 ** rng.uniform(-20, 0, m),
            rng.integers(-2 ** 20, 2 ** 20, m) + 1j * rng.integers(-2 ** 20, 2 ** 20, m),
            np.array([0, 1j, -1, complex(np.inf, 1), complex(1, -np.inf), complex(np.nan, 1),
                      complex(np.inf, np.nan), 1e-320 + 1e-320j, 5e-324j])]
    for z in fams:
        with np.errstate(all="ignore"):
            z = z.astype(cdt)
            want = np.abs(z)
        got = _cabs(torch.from_numpy(z)).numpy()
        np.testing.assert_array_equal(got, want)


def test_max_norm_empty():
    pm = Matrix.from_global(np.zeros((0, 0)), TileElementSize(4, 4), device="cpu")
    assert max_norm(pm, "G") == max_norm(pm, "L") == 0.0


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
@pytest.mark.parametrize("coord", ["Row", "Col"])
@pytest.mark.parametrize("rng_tiles", [(0, None), (1, 3), (2, None)], ids=["all", "1-3", "2-"])
def test_permute_bitwise(layout, coord, rng_tiles, devices8):
    n, nb = layout[2], layout[3]
    t0, t1 = rng_tiles
    a0, a1 = t0 * nb, n if t1 is None else min(t1 * nb, n)
    perm = np.random.default_rng(a0 + n).permutation(a1 - a0)
    a = rand((n, n), np.float64, 2)
    jm, pm = both(a, layout, devices8)
    before = [s.clone() for s in pm.shards()]
    got = permute(coord, perm, pm, t0, t1).to_numpy()
    np.testing.assert_array_equal(got, np.asarray(j_permute(coord, perm, jm, t0, t1).to_numpy()))
    want = a.copy()
    if coord == "Row":
        want[a0:a1] = a[a0 + perm]
    else:
        want[:, a0:a1] = a[:, a0 + perm]
    np.testing.assert_array_equal(got, want)
    assert all(torch.equal(x, y) for x, y in zip(pm.shards(), before))


def test_permute_complex_and_rejects_bad_perm(devices8):
    layout = LAYOUTS[3]
    a = rand((21, 21), np.complex128, 3)
    jm, pm = both(a, layout, devices8)
    perm = np.random.default_rng(0).permutation(13)
    np.testing.assert_array_equal(permute("Col", perm, pm, 2, None).to_numpy(),
                                  np.asarray(j_permute("Col", perm, jm, 2, None).to_numpy()))
    with pytest.raises(AssertionError):
        permute("Row", np.arange(5), pm, 2, None)


def test_permute_range_check_is_heavy(devices8, monkeypatch):
    """The grid permute's index range check is the heavy tier in both
    packages (the reference's ``permutations.py:138``): on, it raises;
    off, both give the same rows (an index past the range reads zeros)."""
    from dlaf_tpu.common import asserts as jasserts
    from dlaf_tpu_torch.common import asserts as passerts

    a = rand((21, 21), np.float64, 3)
    jm, pm = both(a, LAYOUTS[3], devices8)
    perm = np.arange(13)
    perm[4] = 13
    for mod in (jasserts, passerts):
        monkeypatch.setattr(mod, "ASSERT_HEAVY_ENABLED", True)
    for fn, m, err in ((permute, pm, passerts.DlafAssertError),
                       (j_permute, jm, jasserts.DlafAssertError)):
        with pytest.raises(err, match=r"^\[DLAF_ASSERT_HEAVY\] permute: perm indices outside"):
            fn("Row", perm, m, 2, None)
    for mod in (jasserts, passerts):
        monkeypatch.setattr(mod, "ASSERT_HEAVY_ENABLED", False)
    got = permute("Row", perm, pm, 2, None).to_numpy()
    np.testing.assert_array_equal(got, np.asarray(j_permute("Row", perm, jm, 2, None).to_numpy()))
    assert not got[12].any()


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
@pytest.mark.parametrize("f64_gemm", ["native", "mxu"])
@pytest.mark.parametrize("dt", ["d", "z"])
def test_general_sub_multiply(layout, f64_gemm, dt, devices8, monkeypatch):
    monkeypatch.setenv("DLAF_F64_GEMM", f64_gemm)
    monkeypatch.setenv("DLAF_F64_GEMM_MIN_DIM", "4")
    config.initialize()
    jcfg.initialize()
    n, nb = layout[2], layout[3]
    t0, t1 = 1, 3
    a0, a1 = t0 * nb, min(t1 * nb, n)
    A, B, C = (rand((n, n), DTYPES[dt], s) for s in (4, 5, 6))
    alpha, beta = 0.75, -1.5
    (ja, pa), (jb, pb), (jc, pc) = (both(x, layout, devices8) for x in (A, B, C))
    before = [s.clone() for s in pc.shards()]
    got = general_sub_multiply(alpha, pa, pb, beta, pc, t0, t1).to_numpy()
    ref = np.asarray(j_gemm(alpha, ja, jb, beta, jc, t0, t1).to_numpy())
    sl = slice(a0, a1)
    k = a1 - a0
    scale = (abs(alpha) * np.abs(A[sl, sl]).max() * np.abs(B[sl, sl]).max() * k
             + abs(beta) * np.abs(C[sl, sl]).max())
    assert np.abs(got - ref).max() <= 60 * k * np.finfo(np.float64).eps * scale
    # outside the range C passes through exactly
    mask = np.ones((n, n), bool)
    mask[sl, sl] = False
    np.testing.assert_array_equal(got[mask], C[mask])
    assert all(torch.equal(x, y) for x, y in zip(pc.shards(), before))


def test_algorithms_exports_match_reference():
    import dlaf_tpu.algorithms as jalg

    assert sorted(algorithms.__all__) == sorted(jalg.__all__)


@pytest.mark.parametrize("kind", ["col_major", "tile"])
def test_layout_info_matches_reference(kind):
    for m, n, mb, nb in [(13, 9, 4, 4), (8, 8, 8, 8), (0, 5, 4, 4), (17, 3, 5, 2)]:
        if kind == "col_major":
            ld = max(1, m) + 3
            p = li.col_major_layout(LocalElementSize(m, n), TileElementSize(mb, nb), ld)
            j = jli.col_major_layout(JLocalElementSize(m, n), JTileElementSize(mb, nb), ld)
        else:
            p = li.tile_layout(LocalElementSize(m, n), TileElementSize(mb, nb))
            j = jli.tile_layout(JLocalElementSize(m, n), JTileElementSize(mb, nb))
        assert p.min_mem_size() == j.min_mem_size() and p.nr_tiles == j.nr_tiles
        for r in range(p.nr_tiles[0]):
            for c in range(p.nr_tiles[1]):
                assert p.tile_offset(LocalTileIndex(r, c)) == j.tile_offset(JLocalTileIndex(r, c))
                assert tuple(p.tile_size_of(LocalTileIndex(r, c))) == \
                    tuple(j.tile_size_of(JLocalTileIndex(r, c)))


def test_round_robin_matches_reference():
    p, j = RoundRobin("abc"), JRoundRobin("abc")
    seq = [(p.next_resource(), j.next_resource()) for _ in range(7)]
    assert all(x == y for x, y in seq)
    assert p.current_resource() == j.current_resource() and len(p) == 3
    assert list(p) == ["a", "b", "c"]
    with pytest.raises(ValueError):
        RoundRobin([])


@pytest.mark.parametrize("layout", LAYOUTS[:3], ids=IDS[:3])
def test_printing_matches_reference(layout, devices8):
    a = rand((layout[2], layout[2]), np.float64, 7)
    jm, pm = both(a, layout, devices8)
    for fn, jfn in ((printing.print_numpy, jprinting.print_numpy),
                    (printing.print_csv, jprinting.print_csv)):
        assert fn(pm, file=io.StringIO()) == jfn(jm, file=io.StringIO())


def test_miniapp_gen_eigensolver_cpu(capsys):
    from dlaf_tpu_torch.miniapp import miniapp_gen_eigensolver

    res = miniapp_gen_eigensolver.run(["-m", "24", "-b", "8", "--type", "d", "--backend", "cpu",
                                       "--nruns", "1", "--nwarmups", "0",
                                       "--check-result", "last"])
    out = capsys.readouterr().out
    assert len(res) == 1 and " gen_evp " in out and "check: PASSED" in out
