"""Preemption-safe pipeline resume.

Port of ``dlaf_tpu/health/resume.py`` (docs/robustness.md §5): the layer
above :mod:`..matrix.checkpoint`'s stage primitives.

* a :class:`StageCheckpointer` bound to ``DLAF_RESUME_DIR`` (config
  ``resume_dir``) and a run FINGERPRINT (shape, dtype, grid, band, device
  type, input hash: the identity of the numerical run);
* ``commit(stage, arrays)`` persists a completed stage atomically (payload
  then manifest), writes a ``resilience`` ``checkpoint`` record, and THEN
  consults :func:`.inject.maybe_preempt`, so a drill's kill lands exactly
  at the recoverable boundary;
* with ``resume=True``, ``completed(stage)`` is True iff the stage's
  manifest exists and its fingerprint matches this run's; a manifest of
  another run raises :class:`.errors.ResumeError` naming the keys that
  differ, rather than recomputing, or loading, someone else's numbers.
  Each stage loaded writes a ``resume`` record.

The pipeline (``eigensolver(..., resume=True)``) owns the payloads; this
module owns directories, manifests, fingerprints and the records.
"""

from __future__ import annotations

import os
from typing import Optional

from .. import obs
from ..matrix import checkpoint as _ckpt
from .errors import ResumeError
from .inject import maybe_preempt


def fingerprint_mismatch(saved: dict, current: dict) -> list:
    """Keys on which two fingerprints disagree (a missing key counts)."""
    keys = set(saved) | set(current)
    return sorted(k for k in keys if saved.get(k) != current.get(k))


class StageCheckpointer:
    """One pipeline run's checkpoints (module docstring).

    ``directory`` empty disables persistence (commits still consult the
    preemption hook, so ``inject.preempt`` drills work without a
    directory); ``resume=True`` with no directory raises
    :class:`ResumeError`: a silent full recompute is not what the caller
    asked for."""

    def __init__(self, pipeline: str, directory: str, fingerprint: dict, *,
                 resume: bool = False):
        self.pipeline = str(pipeline)
        self.directory = os.path.join(directory, self.pipeline) if directory else ""
        self.fingerprint = {k: fingerprint[k] for k in sorted(fingerprint)}
        self.resume = bool(resume)
        if self.resume and not self.directory:
            raise ResumeError("", "resume=True but no checkpoint directory is configured — "
                                  "set DLAF_RESUME_DIR (config resume_dir)")

    def completed(self, stage: str) -> bool:
        """Can ``stage`` be loaded: manifest present, version compatible,
        fingerprint matching? Only under ``resume=True``: a fresh run
        never skips a stage, whatever is on disk."""
        if not (self.resume and self.directory):
            return False
        manifest = _ckpt.stage_manifest(self.directory, stage)
        if manifest is None:
            return False
        if manifest.get("version") != _ckpt.STAGE_MANIFEST_VERSION:
            raise ResumeError(stage, f"manifest version {manifest.get('version')!r} != "
                                     f"{_ckpt.STAGE_MANIFEST_VERSION} — written by an "
                                     "incompatible version; clear the resume dir")
        saved = manifest.get("fingerprint") or {}
        bad = fingerprint_mismatch(saved, self.fingerprint)
        if bad:
            raise ResumeError(stage, "checkpoint fingerprint mismatch on "
                              + ", ".join(f"{k} (saved {saved.get(k)!r}, run "
                                          f"{self.fingerprint.get(k)!r})" for k in bad)
                              + " — these checkpoints belong to a different run; clear the "
                                "resume dir or fix the configuration")
        return True

    def load(self, stage: str) -> dict:
        """The completed stage's arrays; writes the ``resume`` record."""
        arrays, _ = _ckpt.load_stage(self.directory, stage)
        obs.emit_event("resilience", site=f"{self.pipeline}.{stage}", event="resume",
                       attrs={"stage": stage})
        obs.get_logger("health").info(f"{self.pipeline}: stage {stage!r} resumed from "
                                      f"checkpoint ({self.directory})", stage=stage)
        return arrays

    def commit(self, stage: str, arrays: Optional[dict] = None) -> None:
        """Mark ``stage`` complete: persist (with a directory), record, then
        give the preemption hook its window, AFTER the write."""
        if self.directory and arrays is not None:
            _ckpt.save_stage(self.directory, stage, arrays, self.fingerprint)
            obs.emit_event("resilience", site=f"{self.pipeline}.{stage}", event="checkpoint",
                           attrs={"stage": stage})
        maybe_preempt(stage)


_warned_multiprocess = False


def _multi_process() -> bool:
    """Is this process one of a ``torch.distributed`` world of several?"""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def stage_checkpointer(pipeline: str, fingerprint: dict, *,
                       resume: bool = False) -> StageCheckpointer:
    """The pipeline's checkpointer under the ``resume_dir`` knob
    (``DLAF_RESUME_DIR``); no persistence when the knob is empty (and
    ``resume=True`` then raises, :class:`StageCheckpointer`).

    Stage checkpoints are SINGLE-CONTROLLER only: a process of a
    multi-process world holds one shard, and every
    process would race ``os.replace`` on the same manifests. There the
    knob is ignored with a warning, once a process (the pipeline still
    runs: losing the checkpoints must not kill the job they protect), and
    ``resume=True`` raises."""
    from ..config import get_configuration

    directory = get_configuration().resume_dir
    if directory and _multi_process():
        if resume:
            raise ResumeError("", "DLAF_RESUME_DIR stage checkpoints are single-controller "
                                  "only (a process holds one shard, and processes would "
                                  "race on the manifest files) — resume on a single "
                                  "controller")
        global _warned_multiprocess
        if not _warned_multiprocess:
            _warned_multiprocess = True
            obs.get_logger("health").warning("DLAF_RESUME_DIR is ignored in a "
                                             "multi-process world: stage checkpoints are "
                                             "single-controller only")
        directory = ""
    return StageCheckpointer(pipeline, directory, fingerprint, resume=resume)
