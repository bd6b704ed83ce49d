"""dlaf_tpu_torch.serve: the batched many-problem serving layer.

Port of ``dlaf_tpu/serve`` (docs/serving.md): millions of small factor,
solve and EVP requests, bucketed, padded and batched into one warm program
per bucket. Three surfaces:

* the batched entry points (:mod:`..algorithms.batched`, re-exported
  here): ``cholesky_batched``, ``solve_batched``, ``eigh_batched`` over a
  leading batch axis, with per-lane ``info`` vectors;
* the program service (:mod:`.programs`): the bucket cache with
  ``warmup``, ``evict`` and hit/miss/warmup/eviction counts;
* the request queue (:mod:`.queue`): buckets incoming requests to the
  nearest ceiling, pads, dispatches a bucket's program when its batch
  fills or its deadline passes, and unpads.

Entry points run on ``cuda`` unless given CPU tensors or a service made
with ``device="cpu"``.
"""

from __future__ import annotations

from ..algorithms.batched import cholesky_batched, eigh_batched, solve_batched  # noqa: F401
from .programs import (ProgramService, ProgramSpec, cholesky_spec,  # noqa: F401
                       eigh_spec, get_service, program_builder, solve_spec, warmup)
from .queue import OPS, Queue, Request, Ticket, bucket_ceiling, rhs_ceiling  # noqa: F401

__all__ = [
    "OPS", "ProgramService", "ProgramSpec", "Queue", "Request", "Ticket",
    "bucket_ceiling", "cholesky_batched", "cholesky_spec", "eigh_batched",
    "eigh_spec", "get_service", "program_builder", "rhs_ceiling",
    "solve_batched", "solve_spec", "warmup",
]
