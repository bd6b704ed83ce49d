"""Collective verbs over per-rank values.

Counterpart of ``dlaf_tpu/comm/collectives.py``. There each verb runs
inside ``shard_map`` on one rank's value and lowers to an XLA collective
over a mesh axis. Here one controller holds every rank's value: a verb
takes them all, as a nested list ``xs[r][c]`` over the grid (each on its
rank's device), and returns the per-rank results in the same form, each on
the receiving rank's device.

Every result is a new tensor that the receiving rank owns. Where two ranks
share a device a received value is never the sender's storage, so the
port's in-place updates of one rank's tensors cannot reach another's.

Semantics follow the reference (``collectives.py:69-255``):

* :func:`bcast` and :func:`bcast2d` deliver the source's value plus 0.0.
  The reference's default broadcast is mask-then-``psum``, whose sum
  turns a ``-0.0`` into ``+0.0`` wherever another rank contributes
  ``+0.0``; the port adds the ``+0.0`` itself. A broadcast moves only the
  source's value, so other ranks' values (their non-finite entries
  included) are not summed in. ``bcast_impl="tree"`` (the same broadcast
  scheduled as ``ppermute`` rounds on the TPU's interconnect) is not
  ported.
* :func:`all_reduce` folds the values along the axis in rank order;
  :func:`reduce` gives the root that fold and every other rank zeros.
* :func:`send_recv` gives ``dst`` the value of ``src`` (per line along the
  axis) and every other rank zeros, as ``ppermute``.
* :func:`all_gather` stacks the values along the axis in rank order.
* :func:`all_to_all` is the tiled all-to-all: each rank cuts its value
  into as many chunks along ``split_axis`` as the axis has ranks, sends
  chunk ``j`` to rank ``j`` and joins what it receives along
  ``concat_axis`` in rank order.

``axis`` ``"row"`` runs along grid rows, among the ranks of one grid
column (the reference's column communicator), ``"col"`` among the ranks
of one grid row.

``shared=True`` (:func:`bcast`, :func:`all_reduce`, :func:`all_gather`)
is for receivers that only read the result: the ranks of one line that
share a device then get one tensor, formed once (:func:`per_rank_once`),
instead of a copy each. The values are the same either way; with one
device per rank nothing is shared.
"""

from __future__ import annotations

import torch

from .grid import COL_AXIS, ROW_AXIS


def grid_shape(xs) -> tuple[int, int]:
    """(P, Q) of a nested per-rank list."""
    return len(xs), len(xs[0])


def per_rank(P: int, Q: int, fn) -> list:
    """``[[fn(r, c) for c] for r]``: one value per rank."""
    return [[fn(r, c) for c in range(Q)] for r in range(P)]


def _line(xs, axis: str, r: int, c: int) -> list:
    """The values of the ranks that rank (r, c) communicates with along
    ``axis``, in rank order along it."""
    if axis == ROW_AXIS:
        return [xs[i][c] for i in range(len(xs))]
    if axis == COL_AXIS:
        return list(xs[r])
    raise ValueError(f"unknown axis {axis!r}")


def _pos(axis: str, r: int, c: int) -> int:
    return r if axis == ROW_AXIS else c


def per_rank_once(P: int, Q: int, key, make) -> list:
    """``per_rank`` of ``make``, called once per ``key(r, c)``: the ranks
    with one key share the result and only read it."""
    done = {}

    def one(r, c):
        k = key(r, c)
        if k not in done:
            done[k] = make(r, c)
        return done[k]

    return per_rank(P, Q, one)


def _per_receiver(xs, axis: str, shared: bool, fn):
    """``per_rank`` of ``fn``; with ``shared`` once per (line, device)."""
    P, Q = grid_shape(xs)
    if not shared:
        return per_rank(P, Q, fn)
    return per_rank_once(P, Q, lambda r, c: (c if axis == ROW_AXIS else r, xs[r][c].device), fn)


def _received(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The broadcast's received value on ``like``'s device: a new tensor,
    ``x + 0.0`` for floating types."""
    y = x.to(like.device, copy=True)
    return y.add_(0.0) if (y.is_floating_point() or y.is_complex()) else y


def bcast(xs, axis: str, src: int, *, shared: bool = False):
    """Broadcast the value of rank ``src`` along ``axis`` (reference
    ``kernels/broadcast.h``)."""
    return _per_receiver(xs, axis, shared,
                         lambda r, c: _received(_line(xs, axis, r, c)[src], xs[r][c]))


def bcast2d(xs, owner_r: int, owner_c: int):
    """Broadcast rank ``(owner_r, owner_c)``'s value to the whole grid in
    one step: the diagonal-tile broadcast of every blocked step."""
    P, Q = grid_shape(xs)
    return per_rank(P, Q, lambda r, c: _received(xs[owner_r][owner_c], xs[r][c]))


_FOLD = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def all_reduce(xs, axis: str, op: str = "sum", *, shared: bool = False):
    """All-reduce along ``axis`` (reference ``kernels/all_reduce.h``)."""
    if op not in _FOLD:
        raise ValueError(f"unsupported reduce op {op!r}")

    def one(r, c):
        dev = xs[r][c].device
        vals = _line(xs, axis, r, c)
        acc = vals[0].to(dev, copy=True)
        for v in vals[1:]:
            acc = _FOLD[op](acc, v.to(dev))
        return acc

    return _per_receiver(xs, axis, shared, one)


def reduce(xs, axis: str, root: int, op: str = "sum"):
    """Reduce to ``root`` along ``axis``; the other ranks get zeros (the
    reference's contract defines only the root's result)."""
    full = all_reduce(xs, axis, op)
    P, Q = grid_shape(xs)
    return per_rank(P, Q, lambda r, c: full[r][c] if _pos(axis, r, c) == root
                    else torch.zeros_like(full[r][c]))


def send_recv(xs, axis: str, src: int, dst: int):
    """Move the value of ``src`` to ``dst`` along ``axis`` (reference
    ``kernels/p2p.h``); every other rank gets zeros."""
    P, Q = grid_shape(xs)
    return per_rank(P, Q, lambda r, c: _line(xs, axis, r, c)[src].to(xs[r][c].device, copy=True)
                    if _pos(axis, r, c) == dst else torch.zeros_like(xs[r][c]))


def all_gather(xs, axis: str, *, tiled: bool = False, concat_axis: int = 0,
               shared: bool = False):
    """Every rank's value along ``axis`` on every rank: stacked on a new
    axis ``concat_axis`` (of the axis' size), or concatenated along it
    when ``tiled``."""
    join = torch.cat if tiled else torch.stack

    def one(r, c):
        dev = xs[r][c].device
        return join([v.to(dev) for v in _line(xs, axis, r, c)], dim=concat_axis)

    return _per_receiver(xs, axis, shared, one)


def all_to_all(xs, axis: str, *, split_axis: int, concat_axis: int):
    """Tiled all-to-all along ``axis`` (reference ``collectives.py:231``,
    the layout transpose of the distributed chase back-transform). Every
    value's ``split_axis`` must divide by the axis' rank count."""
    def one(r, c):
        dev = xs[r][c].device
        line = _line(xs, axis, r, c)
        me = _pos(axis, r, c)
        parts = [v.chunk(len(line), dim=split_axis)[me].to(dev) for v in line]
        return torch.cat(parts, dim=concat_axis)

    for v in (x for row in xs for x in row):
        if v.shape[split_axis] % len(_line(xs, axis, 0, 0)):
            raise ValueError(f"all_to_all: axis {split_axis} of {tuple(v.shape)} does not "
                             f"divide by the {len(_line(xs, axis, 0, 0))} ranks along {axis!r}")
    P, Q = grid_shape(xs)
    return per_rank(P, Q, one)


def barrier_value(xs, axis: str):
    """``x`` plus a zero reduced along ``axis``: the reference's
    order-enforcing no-op (a fence between programs there)."""
    P, Q = grid_shape(xs)
    return per_rank(P, Q, lambda r, c: xs[r][c] + torch.zeros((), dtype=xs[r][c].dtype,
                                                               device=xs[r][c].device))
