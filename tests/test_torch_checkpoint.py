"""The port's matrix and stage checkpoints (``dlaf_tpu_torch/matrix/
checkpoint.py``) against the JAX reference's (``dlaf_tpu/matrix/
checkpoint.py``).

Whole-matrix round trips (one rank, a 2x2 grid with a source rank off
(0, 0)) are bitwise, and every tampered-metadata case of the reference's
``tests/test_checkpoint.py`` raises the same ValueError naming its field
(the port stores the reference's 8-int payload ``meta`` vector, not one
entry per field, so a malformed field shows as a wrong ``meta`` shape).
The stage payload of a matrix is the reference's, array for array, and a
stage the port writes is read by the reference's ``load_stage`` (and the
reverse): the same npz payload and JSON manifest. Manifests are written
atomically, a torn one is loud, and stage names are bare identifiers.
"""

import json
import os

import numpy as np
import pytest
import torch

from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu.common.index2d import RankIndex2D as JRankIndex2D
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix import checkpoint as jckpt
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import RankIndex2D, TileElementSize
from dlaf_tpu_torch.matrix import checkpoint
from dlaf_tpu_torch.matrix.matrix import Matrix


def _a(n=12, seed=0):
    return np.random.default_rng(seed).standard_normal((n, n))


def _mat(n=12, nb=4, grid=None, seed=0, src=(0, 0)):
    g = shared_grid(*grid, "cpu") if grid else None
    return Matrix.from_global(_a(n, seed), TileElementSize(nb, nb), grid=g,
                              source_rank=RankIndex2D(*src), device="cpu")


#: The untampered ``meta`` vector of :func:`_mat`'s 12x12 matrix in 4x4
#: tiles on one rank: size, block_size, grid_size, source_rank.
META = [12, 12, 4, 4, 1, 1, 0, 0]


def test_roundtrip_local(tmp_path):
    mat = _mat()
    checkpoint.save(str(tmp_path / "ckpt"), mat)
    back = checkpoint.load(str(tmp_path / "ckpt"), device="cpu")
    assert torch.equal(back.storage, mat.storage)
    np.testing.assert_array_equal(back.to_numpy(), mat.to_numpy())
    assert back.dist.size == mat.dist.size and back.dist.block_size == mat.dist.block_size
    assert not [f for f in os.listdir(tmp_path / "ckpt") if ".tmp." in f]


def test_roundtrip_distributed(tmp_path):
    mat = _mat(16, 4, grid=(2, 2), src=(1, 0))
    checkpoint.save(str(tmp_path / "ckpt"), mat)
    back = checkpoint.load(str(tmp_path / "ckpt"), grid=shared_grid(2, 2, "cpu"))
    assert all(torch.equal(x, y) for x, y in zip(back.shards(), mat.shards()))
    np.testing.assert_array_equal(back.to_numpy(), mat.to_numpy())
    assert back.dist.source_rank == mat.dist.source_rank


def test_grid_size_mismatch_names_field(tmp_path):
    checkpoint.save(str(tmp_path / "ckpt"), _mat())
    with pytest.raises(ValueError, match="grid_size mismatch"):
        checkpoint.load(str(tmp_path / "ckpt"), grid=shared_grid(2, 2, "cpu"))
    checkpoint.save(str(tmp_path / "dckpt"), _mat(16, 4, grid=(2, 2)))
    with pytest.raises(ValueError, match="grid_size mismatch"):
        checkpoint.load(str(tmp_path / "dckpt"), device="cpu")   # no grid passed


TAMPERED = [  # (name, meta edit, message)
    ("missing source_rank", lambda m: m[:6], "'source_rank' is missing"),
    ("source_rank outside", lambda m: m[:6] + [1, 0], "source_rank .* outside"),
    ("block_size", lambda m: m[:2] + [6, 6] + m[4:], "storage shape .* inconsistent"),
    ("size", lambda m: [20, 20] + m[2:], "storage shape .* inconsistent"),
    ("malformed size", lambda m: [12, 12, 12] + m[2:], r"meta shape \(9,\)"),
    ("negative size", lambda m: [-1, 12] + m[2:], "is negative"),
    ("zero block", lambda m: m[:2] + [0, 4] + m[4:], "must be >= 1"),
]


@pytest.mark.parametrize("name,edit,message", TAMPERED, ids=[t[0] for t in TAMPERED])
def test_tampered_metadata_names_field(name, edit, message, tmp_path):
    mat = _mat()
    os.makedirs(tmp_path / "ckpt")
    checkpoint._write_npz(str(tmp_path / "ckpt" / checkpoint.MATRIX_FILE),
                          {"matrix.storage": mat.storage.numpy(),
                           "matrix.meta": np.array(edit(list(META)), dtype=np.int64)})
    with pytest.raises(ValueError, match=message):
        checkpoint.load(str(tmp_path / "ckpt"), device="cpu")
    checkpoint.save(str(tmp_path / "ckpt"), mat)       # the untampered payload loads
    assert torch.equal(checkpoint.load(str(tmp_path / "ckpt"), device="cpu").storage,
                       mat.storage)


def test_not_a_checkpoint(tmp_path):
    np.savez(str(tmp_path / "x.npz"), storage=np.zeros(2))
    os.makedirs(tmp_path / "ckpt")
    os.replace(tmp_path / "x.npz", tmp_path / "ckpt" / checkpoint.MATRIX_FILE)
    with pytest.raises(ValueError, match="missing 'meta'/'storage'"):
        checkpoint.load(str(tmp_path / "ckpt"), device="cpu")


@pytest.mark.parametrize("grid,src", [(None, (0, 0)), ((2, 2), (0, 0)), ((2, 3), (1, 2))])
def test_matrix_payload_roundtrip_bitwise_and_the_reference(grid, src, devices8):
    a = np.arange(13 * 13, dtype=np.float64).reshape(13, 13)
    g = shared_grid(*grid, "cpu") if grid else None
    mat = Matrix.from_global(a, TileElementSize(4, 4), grid=g, source_rank=RankIndex2D(*src),
                             device="cpu")
    arrays = checkpoint.matrix_arrays(mat, "m")
    back = checkpoint.matrix_from_arrays(arrays, "m", g, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(back.shards(), mat.shards()))
    np.testing.assert_array_equal(back.to_numpy(), a)
    jg = JGrid(*grid, devices=devices8[:grid[0] * grid[1]]) if grid else None
    jm = JMatrix.from_global(a, JTileElementSize(4, 4), grid=jg, source_rank=JRankIndex2D(*src))
    want = jckpt.matrix_arrays(jm, "m")
    assert sorted(arrays) == sorted(want)
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], np.asarray(want[k]))
    # the reference rebuilds the port's payload, bit for bit
    np.testing.assert_array_equal(np.asarray(jckpt.matrix_from_arrays(arrays, "m", jg)
                                             .to_numpy()), a)
    if grid is not None:
        with pytest.raises(ValueError, match="grid"):
            checkpoint.matrix_from_arrays(arrays, "m", None)
        with pytest.raises(ValueError, match="grid_size mismatch"):
            checkpoint.matrix_from_arrays(arrays, "m", shared_grid(1, 2, "cpu"))
    bad = dict(arrays, **{"m.meta": arrays["m.meta"][:7]})
    with pytest.raises(ValueError, match="meta shape"):
        checkpoint.matrix_from_arrays(bad, "m", g, device="cpu")
    bad = dict(arrays, **{"m.storage": arrays["m.storage"][:1]})
    with pytest.raises(ValueError, match="inconsistent"):
        checkpoint.matrix_from_arrays(bad, "m", g, device="cpu")


def test_stage_checkpoint_roundtrip_and_manifest(tmp_path):
    d = str(tmp_path / "ck")
    arrays = {"x": np.arange(6.0).reshape(2, 3), "y": np.int64(7)}
    checkpoint.save_stage(d, "s1", arrays, {"n": 8, "dtype": "float64"})
    man = checkpoint.stage_manifest(d, "s1")
    assert man["version"] == checkpoint.STAGE_MANIFEST_VERSION
    assert man["fingerprint"] == {"n": 8, "dtype": "float64"}
    assert man["keys"] == ["x", "y"] and man["stage"] == "s1"
    out, man2 = checkpoint.load_stage(d, "s1")
    np.testing.assert_array_equal(out["x"], arrays["x"])
    assert int(out["y"]) == 7 and man2 == man
    assert checkpoint.stage_manifest(d, "nope") is None
    with pytest.raises(ValueError, match="not completed"):
        checkpoint.load_stage(d, "nope")
    assert not [f for f in os.listdir(d) if ".tmp." in f]
    for name in ("../evil", "a/b", ""):
        with pytest.raises(ValueError, match="bare identifier"):
            checkpoint.save_stage(d, name, arrays, {})


def test_stage_files_cross_between_the_packages(tmp_path):
    """A stage the port writes is the reference's format, and the reverse."""
    arrays = {"lam": np.linspace(0, 1, 5), "z": np.eye(3), "band": np.int64(2)}
    fp = {"n": 5, "backend": "cpu"}
    checkpoint.save_stage(str(tmp_path / "p"), "tridiag", arrays, fp)
    jckpt.save_stage(str(tmp_path / "j"), "tridiag", arrays, fp)
    got, gman = jckpt.load_stage(str(tmp_path / "p"), "tridiag")
    want, wman = checkpoint.load_stage(str(tmp_path / "j"), "tridiag")
    assert gman == wman
    for k in arrays:
        np.testing.assert_array_equal(got[k], arrays[k])
        np.testing.assert_array_equal(want[k], arrays[k])
    with open(tmp_path / "p" / "tridiag.json") as f, open(tmp_path / "j" / "tridiag.json") as g:
        assert json.load(f) == json.load(g)


def test_stage_checkpoint_corrupt_or_torn_is_loud(tmp_path):
    d = str(tmp_path / "ck")
    checkpoint.save_stage(d, "s1", {"x": np.zeros(2)}, {})
    with open(os.path.join(d, "s1.json"), "w") as f:
        f.write("{torn")
    with pytest.raises(ValueError, match="corrupt"):
        checkpoint.stage_manifest(d, "s1")
    with open(os.path.join(d, "s1.json"), "w") as f:
        f.write("[1, 2]")
    with pytest.raises(ValueError, match="not an object"):
        checkpoint.stage_manifest(d, "s1")
    checkpoint.save_stage(d, "s2", {"x": np.zeros(2)}, {})
    with open(os.path.join(d, "s2.npz"), "wb") as f:
        np.savez(f, x=np.zeros(2), extra=np.ones(1))
    with pytest.raises(ValueError, match="torn or edited"):
        checkpoint.load_stage(d, "s2")


def test_atomic_replace_leaves_the_old_file_on_a_failed_write(tmp_path):
    path = str(tmp_path / "f.json")
    with open(path, "w") as f:
        f.write("old")

    def failing(tmp):
        with open(tmp, "w") as f:
            f.write("half")
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        checkpoint._atomic_replace(path, failing)
    assert open(path).read() == "old"
    assert os.listdir(tmp_path) == ["f.json"]
