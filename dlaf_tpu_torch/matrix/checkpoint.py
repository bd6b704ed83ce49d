"""Matrix and pipeline-stage persistence (application-owned checkpoints).

Port of ``dlaf_tpu/matrix/checkpoint.py``. Nothing in the algorithms
checkpoints implicitly (DLA-Future leaves persistence to the
application); this module gives the application two layers over one
matrix layout:

* **Matrix payload** (:func:`matrix_arrays` / :func:`matrix_from_arrays`):
  the raw tile storage, edge padding included, in the reference's
  ``(P*ltr, Q*ltc, mb, nb)`` layout (a grid's shards joined), and the
  reference's 8-int ``meta`` vector (``size``, ``block_size``,
  ``grid_size``, ``source_rank``, two ints each), so a round trip is
  bitwise. One validator checks every field against the stored tiles and
  the caller's grid before any Matrix is built, with the reference's
  errors, each naming its field.
* **Whole-matrix round trip** (:func:`save` / :func:`load`): that payload,
  under the prefix ``matrix``, as one ``.npz`` in the directory ``path``,
  written atomically. The reference writes an orbax tree with one entry
  per field; the port keeps the one payload format.
* **Stage checkpoints** (:func:`save_stage` / :func:`load_stage` /
  :func:`stage_manifest`): versioned ``.npz`` payloads and JSON
  manifests carrying the run's fingerprint, beneath ``DLAF_RESUME_DIR``
  (:mod:`..health.resume`). The payload is written first and the
  manifest second, each to a temporary file renamed into place
  (``os.replace``), and the manifest's presence marks the stage complete:
  a process killed mid-write leaves nothing or a whole stage.

Both layers are single-controller: a multi-process grid's matrix holds
only this process's shard, and saving it raises.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..common.index2d import GlobalElementSize, RankIndex2D, TileElementSize
from . import tiling
from .matrix import Matrix, _make_dist

#: The layout fields of a matrix payload's ``meta`` vector, two ints
#: each, in this order.
_META_FIELDS = ("size", "block_size", "grid_size", "source_rank")

#: File of a whole-matrix checkpoint inside its directory.
MATRIX_FILE = "matrix.npz"

#: Manifest schema version; a loader that meets another version refuses
#: (the resume layer raises ResumeError), never misreads.
STAGE_MANIFEST_VERSION = 1


def _storage(mat: Matrix) -> np.ndarray:
    """The raw tile storage on the host, a grid's shards joined in the
    reference's layout."""
    if not mat.distributed:
        return mat.storage.detach().cpu().numpy()
    if mat.grid.multi_process:
        raise ValueError("checkpoint: a multi-process grid's matrix holds one shard per "
                         "process; checkpoints are single-controller only")
    return tiling.join_shards(mat.storage, mat.dist, torch.device("cpu")).numpy()


def matrix_arrays(mat: Matrix, prefix: str = "m") -> dict:
    """``mat`` as a payload array dict: the RAW tile storage (edge padding
    included, so a restored matrix holds exactly the bytes the
    uninterrupted run held) and the layout metadata."""
    d = mat.dist
    return {f"{prefix}.storage": _storage(mat),
            f"{prefix}.meta": np.array([d.size.row, d.size.col, d.block_size.row,
                                        d.block_size.col, d.grid_size.row, d.grid_size.col,
                                        d.source_rank.row, d.source_rank.col], dtype=np.int64)}


def _rebuild(arrays: dict, prefix: str, grid, device, where: str) -> Matrix:
    """The Matrix of a :func:`matrix_arrays` payload, every ``meta`` field
    checked against the stored tiles and ``grid`` first: a mismatch raises
    a ValueError that starts with ``where`` and names the field (size /
    block_size / grid_size / source_rank / storage shape)."""
    meta = np.asarray(arrays[f"{prefix}.meta"]).reshape(-1)
    if meta.shape != (2 * len(_META_FIELDS),):
        why = (f"field {_META_FIELDS[meta.size // 2]!r} is missing"
               if meta.size < 2 * len(_META_FIELDS) else f"more than the fields {_META_FIELDS}")
        raise ValueError(f"{where}: meta shape {meta.shape}, expected (8,): {why} — not a "
                         "dlaf_tpu_torch matrix payload, or written by an incompatible version")
    gr, gc, sr, sc = (int(meta[i]) for i in (4, 5, 6, 7))
    if grid is None:
        if gr * gc != 1:
            raise ValueError(f"{where}: grid_size mismatch — saved on a {gr}x{gc} grid; pass a "
                             "grid= of that shape")
    elif (grid.size.row, grid.size.col) != (gr, gc):
        raise ValueError(f"{where}: grid_size mismatch — saved {gr}x{gc}, loading onto "
                         f"{grid.size.row}x{grid.size.col}")
    size = GlobalElementSize(int(meta[0]), int(meta[1]))
    block = TileElementSize(int(meta[2]), int(meta[3]))
    if size.row < 0 or size.col < 0:
        raise ValueError(f"{where}: size {size} is negative")
    if block.row < 1 or block.col < 1:
        raise ValueError(f"{where}: block_size {block} must be >= 1")
    if not (0 <= sr < gr and 0 <= sc < gc):
        raise ValueError(f"{where}: source_rank ({sr}, {sc}) outside the saved {gr}x{gc} grid")
    dist = _make_dist(size, block, grid, RankIndex2D(sr, sc))
    storage = np.asarray(arrays[f"{prefix}.storage"])
    Sr, Sc, _, _ = tiling.storage_tile_grid(dist)
    expect = (Sr, Sc, block.row, block.col)
    if tuple(storage.shape) != expect:
        raise ValueError(f"{where}: storage shape {tuple(storage.shape)} inconsistent with "
                         f"metadata (size={size}, block_size={block}, grid_size={gr}x{gc} => "
                         f"expected {expect}) — the checkpoint is corrupt or its metadata was "
                         "edited")
    t = torch.from_numpy(np.ascontiguousarray(storage))
    if grid is None or grid.num_devices == 1:
        dev = grid.device(0, 0) if grid is not None else device
        return Matrix(dist, t.to(dev, copy=True), grid)
    return Matrix(dist, tiling.split_shards(t, dist, grid.devices), grid)


def matrix_from_arrays(arrays: dict, prefix: str = "m", grid=None, *,
                       device="cuda") -> Matrix:
    """Rebuild a Matrix from a :func:`matrix_arrays` payload, on
    ``device`` without a grid, else on ``grid``'s devices. ``grid`` must
    have the saved grid's shape (None only for a one-rank save)."""
    return _rebuild(arrays, prefix, grid, device, f"stage payload {prefix!r}")


def save(path: str, mat: Matrix) -> None:
    """Write ``mat``'s payload (:func:`matrix_arrays`, prefix ``matrix``)
    to ``path`` (a directory)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _write_npz(os.path.join(path, MATRIX_FILE), matrix_arrays(mat, "matrix"))


def load(path: str, grid=None, *, device="cuda") -> Matrix:
    """Rebuild a Matrix from ``path``, on ``device`` without a grid, else
    on ``grid``'s devices; ``grid`` must have the saved grid's shape (or be
    omitted for a matrix saved on one rank). Validated as
    :func:`matrix_from_arrays` validates."""
    path = os.path.abspath(path)
    with np.load(os.path.join(path, MATRIX_FILE), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    if not {"matrix.meta", "matrix.storage"} <= set(arrays):
        raise ValueError(f"checkpoint {path!r}: missing 'meta'/'storage' entries — not a "
                         "dlaf_tpu_torch matrix checkpoint")
    return _rebuild(arrays, "matrix", grid, device, f"checkpoint {path!r}")


def _atomic_replace(path: str, write_fn) -> None:
    """Write through a same-directory temporary file and ``os.replace``
    (atomic on POSIX): readers see the old file or the new one."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _stage_paths(directory: str, stage: str) -> tuple:
    if not stage or any(c in stage for c in "/\\"):
        raise ValueError(f"stage name {stage!r} must be a bare identifier")
    return (os.path.join(directory, f"{stage}.npz"), os.path.join(directory, f"{stage}.json"))


def _write_npz(path: str, arrays: dict) -> None:
    """``arrays`` as one uncompressed ``.npz`` at ``path``, atomically."""

    def write(tmp):
        # through an open file: np.savez(path) would append its own .npz
        # suffix and break the rename
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)

    _atomic_replace(path, write)


def save_stage(directory: str, stage: str, arrays: dict, fingerprint: dict) -> str:
    """Persist one completed stage: the array payload (atomic ``.npz``)
    first, then the manifest (atomic JSON), whose presence marks the stage
    complete. Returns the manifest's path."""
    os.makedirs(directory, exist_ok=True)
    data_path, man_path = _stage_paths(directory, stage)
    _write_npz(data_path, arrays)
    manifest = {"version": STAGE_MANIFEST_VERSION, "stage": stage,
                "arrays": os.path.basename(data_path), "keys": sorted(arrays),
                "fingerprint": dict(fingerprint)}

    def write_json(tmp):
        with open(tmp, "w") as f:
            json.dump(manifest, f, sort_keys=True)

    _atomic_replace(man_path, write_json)
    return man_path


def stage_manifest(directory: str, stage: str) -> Optional[dict]:
    """The stage's manifest, or None when the stage has not completed (no
    manifest). An unreadable manifest raises ValueError: corruption is
    loud, not "not completed"."""
    _, man_path = _stage_paths(directory, stage)
    if not os.path.exists(man_path):
        return None
    with open(man_path) as f:
        try:
            manifest = json.load(f)
        except ValueError as e:
            raise ValueError(f"stage manifest {man_path!r} is corrupt: {e}")
    if not isinstance(manifest, dict):
        raise ValueError(f"stage manifest {man_path!r}: not an object")
    return manifest


def load_stage(directory: str, stage: str) -> tuple:
    """``(arrays, manifest)`` of a completed stage; raises ValueError when
    the stage is incomplete or its payload disagrees with the manifest's
    key list."""
    manifest = stage_manifest(directory, stage)
    if manifest is None:
        raise ValueError(f"stage {stage!r} has no manifest under {directory!r} — not "
                         "completed")
    data_path, _ = _stage_paths(directory, stage)
    with np.load(data_path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    if sorted(arrays) != manifest.get("keys", sorted(arrays)):
        raise ValueError(f"stage {stage!r}: payload keys {sorted(arrays)} != manifest keys "
                         f"{manifest.get('keys')} — checkpoint is torn or edited")
    return arrays, manifest
