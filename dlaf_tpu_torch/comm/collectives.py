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
* :func:`scatter` sends each rank its own piece of one rank's per-rank
  values, :func:`gather` brings every rank's value (of any leading
  extent) to one rank, and :func:`exchange` moves values between named
  pairs of ranks only: the verbs by which a matrix that one rank holds
  is distributed (``Matrix.from_global(root=)``), the band's tiles reach
  rank (0, 0), and a mirror tile is fetched from its owner.
* :func:`bcast_arrays` gives every process, bit for bit and without a
  ``+ 0.0``, host arrays that one rank's process formed alone (the
  chase's result); under the single controller it returns them as they
  are.

A received value has, in both forms, the layout the single controller's
copy gives it: a broadcast's or an all-gather's that of its sender where
the sender's value is dense (``x.to(copy=True)``; the transport carries
the sender's memory order in its header), a scatter's, gather's or
exchange's contiguous. A library product may sum in another order for
another layout of its operands, so the layouts must agree for the bits
to.

``axis`` ``"row"`` runs along grid rows, among the ranks of one grid
column (the reference's column communicator), ``"col"`` among the ranks
of one grid row.

``shared=True`` (:func:`bcast`, :func:`all_reduce`, :func:`all_gather`)
is for receivers that only read the result: the ranks of one line that
share a device then get one tensor, formed once (:func:`per_rank_once`),
instead of a copy each. The values are the same either way; with one
device per rank nothing is shared.

**The multi-process form.** :func:`.multihost.multihost_grid` installs its
grid as this process's world (:func:`install_world`). From then on
:func:`per_rank` evaluates ``fn`` only for the rank this process drives
and leaves ``None`` at every other rank, and each verb reads this rank's
value, runs one ``torch.distributed`` collective on the line's process
group (a grid row's or column's; the world for :func:`bcast2d`) and
returns this rank's result in the same nested form. The values are
bitwise the single controller's: a broadcast is ``broadcast`` from the
source's process and the receivers (the source included) add 0.0; a
``"sum"`` all-reduce is an all-gather and then the same fold in rank
order (a ring sum would add in another order); :func:`all_reduce`'s
other ops, :func:`reduce` and :func:`send_recv` (a broadcast along the
line, kept on ``dst``) are formed the same way; :func:`scatter` is
``scatter`` from the owner's process, :func:`gather` point-to-point sends
to it, and :func:`exchange` and :func:`all_to_all` one batch of
point-to-point sends and receives (each peer of the line receives only
the chunk it keeps). Every process of a line
must call the verb with a value of one shape and dtype, as the uniform
slots of the distributed builders give (a gather's leading extents may
differ; an exchange's pairs agree on what crosses); :func:`_transport`
checks that before it moves data, so a mismatch raises on every process
instead of hanging. With no world installed every function is the single
controller's.

**Accounting** (reference ``collectives.py:42-56, 158-167``). Each verb
call adds one to ``dlaf_comm_collective_count_total{kind,axis}`` and one
rank's payload (``numel * element_size`` of this process's first rank's
value) to ``dlaf_comm_collective_bytes_total{kind,axis}``, under the
reference's kinds and, for the port's own verbs, ``scatter``, ``gather``,
``exchange`` (the bytes this process's first rank sends) and
``bcast_arrays`` along axis ``"grid"``; :func:`bcast2d` counts along both
axes, as the reference's. The reference counts when a program is traced;
the port per call (:mod:`..obs`). :func:`record_overlapped` counts the
collectives a builder hoists ahead of the previous step's bulk update
(``comm_lookahead``). With metrics off each is one attribute read.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..common.asserts import dlaf_assert
from .grid import COL_AXIS, ROW_AXIS

#: Axis label of the verbs that run over the whole grid at once.
GRID_AXIS = "grid"

#: The multi-process grid this process drives one rank of (None: the
#: single controller). Process-wide, as the ``torch.distributed`` world it
#: stands for is.
_WORLD = None


#: Payload-corruption hook, installed ONLY by
#: ``health.inject.corrupt_collective`` (fault drills); None otherwise, so
#: its cost is one module-attribute read a verb call. It sees (kind, axis,
#: the verb's nested per-rank values) and returns them, possibly poisoned.
#: It runs before a verb's two forms part, so in the multi-process form the
#: value :func:`_transport` carries is the poisoned one.
_INJECT_HOOK = None


def _maybe_inject(kind: str, axis: str, xs):
    if _INJECT_HOOK is None:
        return xs
    return _INJECT_HOOK(kind, axis, xs)


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _record(kind: str, axis: str, nbytes: int) -> None:
    """Count one verb call of ``kind`` along ``axis`` moving ``nbytes`` of
    one rank's payload (module docstring)."""
    if not obs.metrics_active():
        return
    obs.counter("dlaf_comm_collective_count_total", kind=kind, axis=axis).inc()
    obs.counter("dlaf_comm_collective_bytes_total", kind=kind, axis=axis).inc(nbytes)


def _record_value(kind: str, axis: str, xs, src=None) -> None:
    """:func:`_record` of this process's first rank's value, or under the
    single controller of rank ``src`` (a broadcast's source, whose value is
    the payload where the other ranks pass placeholders)."""
    if obs.metrics_active():
        x = xs[src[0]][src[1]] if src is not None and _WORLD is None else local_value(xs)
        _record(kind, axis, _nbytes(x))


def record_overlapped(algo: str, axis: str, n: int = 1) -> None:
    """Count ``n`` collectives along ``axis`` that ``algo`` runs ahead of
    the previous step's bulk update (``comm_lookahead``): transfers that
    can overlap it. ``dlaf_comm_overlapped_total{algo,axis}``, per call."""
    if obs.metrics_active() and n:
        obs.counter("dlaf_comm_overlapped_total", algo=algo, axis=axis).inc(n)


def install_world(grid) -> None:
    """Make ``grid`` (a multi-process :class:`.grid.Grid`, or None) the
    world the verbs run on."""
    global _WORLD
    dlaf_assert(grid is None or grid.multi_process, "install_world: not a multi-process grid")
    _WORLD = grid


def world():
    """The installed multi-process grid, or None."""
    return _WORLD


def grid_shape(xs) -> tuple[int, int]:
    """(P, Q) of a nested per-rank list."""
    return len(xs), len(xs[0])


def local_ranks(P: int, Q: int) -> list:
    """The ranks ``(r, c)`` of a P x Q grid this process drives, row-major:
    every rank under the single controller, one in the multi-process
    form."""
    if _WORLD is None:
        return [(r, c) for r in range(P) for c in range(Q)]
    dlaf_assert((P, Q) == (_WORLD.size.row, _WORLD.size.col),
                f"a {P}x{Q} per-rank value in a {_WORLD.size.row}x{_WORLD.size.col} "
                "multi-process world")
    return _WORLD.local_ranks


def is_local(r: int, c: int) -> bool:
    """Does this process drive rank ``(r, c)``?"""
    return _WORLD is None or _WORLD.is_local(r, c)


def local_value(xs):
    """The value of the first rank this process drives (rank (0, 0)'s under
    the single controller): where every rank holds the same value, as after
    an all-reduce, the one to read."""
    r, c = local_ranks(*grid_shape(xs))[0]
    return xs[r][c]


def gather_grid(xs) -> list:
    """Every rank's value of a nested per-rank list on this process: ``xs``
    itself under the single controller; in the multi-process form the
    values (of one shape on every rank) all-gathered along both grid
    axes."""
    if _WORLD is None:
        return xs
    full = local_value(_all_gather(_all_gather(xs, COL_AXIS), ROW_AXIS))
    return [[full[r, c] for c in range(full.shape[1])] for r in range(full.shape[0])]


def per_rank(P: int, Q: int, fn) -> list:
    """``[[fn(r, c) for c] for r]``: one value per rank, evaluated only for
    the ranks this process drives (None elsewhere)."""
    out = [[None] * Q for _ in range(P)]
    for r, c in local_ranks(P, Q):
        out[r][c] = fn(r, c)
    return out


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


def _copy(x: torch.Tensor, device) -> torch.Tensor:
    """A new contiguous copy of ``x`` on ``device``: what :func:`scatter`,
    :func:`gather` and :func:`exchange` hand a receiver in both forms."""
    return x.to(device, memory_format=torch.contiguous_format, copy=True)


def _received(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The broadcast's received value on ``like``'s device: a new tensor
    in ``x``'s layout where ``x`` is dense, ``x + 0.0`` for floating
    types."""
    return _plus_zero(x.to(like.device, copy=True))


def _plus_zero(y: torch.Tensor) -> torch.Tensor:
    return y.add_(0.0) if (y.is_floating_point() or y.is_complex()) else y


# ---------------------------------------------------------------------------
# The multi-process transport
# ---------------------------------------------------------------------------

_MAX_DIMS = 8
_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128, torch.bfloat16,
           torch.float16, torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64,
           torch.bool)
_KEY = 2 + _MAX_DIMS      # the header's dtype, rank and extents; then the layout


def _order(x: torch.Tensor) -> list:
    """``x``'s dims from the outermost in memory to the innermost where
    ``x`` is dense (``x.permute(order)`` is contiguous), else the identity:
    the layout a copy keeps (``x.to(copy=True)`` keeps a dense tensor's
    strides and makes any other contiguous)."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    return order if x.permute(order).is_contiguous() else list(range(x.dim()))


def _header(x: torch.Tensor, device) -> torch.Tensor:
    """dtype, rank and extents of ``x``, then its layout (:func:`_order`),
    as a small int64 tensor."""
    dlaf_assert(x.dim() <= _MAX_DIMS, f"a {x.dim()}-d value: at most {_MAX_DIMS} dims")
    dlaf_assert(x.dtype in _DTYPES, f"no transport for dtype {x.dtype}")
    pad = [-1] * (_MAX_DIMS - x.dim())
    h = [_DTYPES.index(x.dtype), x.dim(), *x.shape] + pad + _order(x) + pad
    return torch.tensor(h, dtype=torch.int64, device=device)


def _in_order(x: torch.Tensor) -> torch.Tensor:
    """``x``'s elements in its memory order (:func:`_order`), flat, as the
    wire carries them."""
    return _wire(x.detach().permute(_order(x))).reshape(-1)


def _from_wire(flat: torch.Tensor, head: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The sender's value from its flat elements and its header: its
    extents and its layout, on ``like``'s device."""
    nd = int(head[1])
    shape = [int(v) for v in head[2:2 + nd]]
    order = [int(v) for v in head[_KEY:_KEY + nd]]
    t = flat.to(like.device)
    stored = tuple(shape[d] for d in order)
    if like.is_complex():
        t = torch.view_as_complex(t.view(stored + (2,)))
    else:
        t = _unwire(t, like).view(stored)
    inv = sorted(range(nd), key=lambda d: order[d])
    return t.permute(inv)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the collective sends it: complex as its real view, bool as
    bytes (both bitwise)."""
    if x.is_complex():
        return torch.view_as_real(x)
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        return torch.view_as_complex(t)
    return t.view(torch.bool) if like.dtype == torch.bool else t


def _check_heads(kind: str, heads: list, x: torch.Tensor, *, rows_may_differ: bool = False):
    """Raise on every process when the group's headers disagree (the
    leading extent may differ with ``rows_may_differ``)."""
    def key(h):
        return torch.cat([h[:2], h[3:_KEY]]) if rows_may_differ else h[:_KEY]

    if any(not torch.equal(key(h), key(heads[0])) for h in heads):
        shapes = [tuple(int(v) for v in h[2:2 + int(h[1])]) if int(h[0]) >= 0 else "bad pieces"
                  for h in heads]
        raise ValueError(f"{kind}: the processes of the group hold values of different "
                         f"shapes or dtypes {shapes} (this process: {tuple(x.shape)} "
                         f"{x.dtype}); every process must pass the source's shape and dtype")


def _p2p(sends: dict, recvs: dict) -> None:
    """Post every send (``{global rank: tensor}``) and receive (``{global
    rank: buffer}``) of this process at once and wait for them (one batch:
    NCCL pairs them in one group, so two processes that send each other
    first cannot deadlock)."""
    ops = [dist.P2POp(dist.isend, t, peer) for peer, t in sorted(sends.items())]
    ops += [dist.P2POp(dist.irecv, t, peer) for peer, t in sorted(recvs.items())]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _transport(kind: str, x: torch.Tensor, group, src: int = -1, *, pieces=None, expect=None):
    """The one place a value crosses processes. ``src`` is a global
    process rank; every result is a new tensor on ``x``'s device.

    * "broadcast": the source's value;
    * "all_gather": every group member's value, in group rank order
      (ascending global rank);
    * "scatter": ``pieces[i]`` of the source (a list in group rank order,
      each of ``x``'s shape and dtype; None elsewhere) to member ``i``;
    * "gather": every member's value on the source, a list in group rank
      order (None elsewhere); the values may differ in their leading
      extent, as a rank's count of tiles does;
    * "exchange": pairwise, ``pieces`` ``{global rank: tensor}`` sent to
      each peer and ``expect`` ``{global rank: tensor}`` of the shapes and
      dtypes each peer sends here; returns ``{global rank: tensor}``
      (``x`` gives the device). A process passes neither to itself.

    Every member first all-gathers the values' dtypes and shapes (for an
    exchange: of every piece it sends and expects) and raises when they
    disagree, so a mismatch fails on every process instead of hanging in
    the data collective. On a gloo group a CUDA tensor is staged through
    host memory: copied to the host, the collective runs there, the
    result is copied back to the device (gloo's own CUDA support covers
    some collectives only, and is not relied on). NCCL groups move CUDA
    tensors directly."""
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    wdev = torch.device("cpu") if staged else x.device
    n = dist.get_world_size(group)
    if kind == "exchange":
        return _exchange(x, group, pieces, expect, wdev)
    head = _header(x, wdev)
    if kind == "scatter" and dist.get_rank() == src:
        if len(pieces) != n or any(p.dtype != x.dtype or p.shape != x.shape for p in pieces):
            head[0] = -2     # the source's pieces disagree: every member raises
    heads = [torch.empty_like(head) for _ in range(n)]
    dist.all_gather(heads, head, group=group)
    _check_heads(kind, heads, x, rows_may_differ=kind == "gather")

    def back(buf):
        return _unwire(buf.to(x.device), x) if staged else _unwire(buf, x)

    members = sorted(dist.get_process_group_ranks(group))
    w = _wire(x.detach())
    if kind == "broadcast":
        # the value arrives in its sender's layout, as a copy keeps it
        # under the single controller; a receiver's ``x`` gives only the
        # extents the header checked (its elements are never read)
        if dist.get_rank() == src:
            buf = _in_order(x).to(wdev, copy=True)
        else:
            buf = torch.empty(w.numel(), dtype=w.dtype, device=wdev)
        dist.broadcast(buf, src=src, group=group)
        return _from_wire(buf, heads[members.index(src)], x)
    if kind == "all_gather":
        flat = _in_order(x).to(wdev)
        bufs = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(bufs, flat, group=group)
        return [_from_wire(b, h, x) for b, h in zip(bufs, heads)]
    if kind == "scatter":
        buf = torch.empty(w.shape, dtype=w.dtype, device=wdev)
        parts = ([_wire(p.detach()).to(wdev).contiguous() for p in pieces]
                 if dist.get_rank() == src else None)
        dist.scatter(buf, parts, src=src, group=group)
        return back(buf)
    dlaf_assert(kind == "gather", f"unknown transport {kind!r}")
    me = dist.get_rank()
    if me != src:
        _p2p({src: w.to(wdev).contiguous()} if w.numel() else {}, {})
        return None
    bufs = {g: torch.empty((int(h[2]), *w.shape[1:]), dtype=w.dtype, device=wdev)
            for g, h in zip(members, heads) if g != me}
    _p2p({}, {g: b for g, b in bufs.items() if b.numel()})
    return [_copy(x.detach(), x.device) if g == me else back(bufs[g]) for g in members]


def _exchange(x, group, pieces: dict, expect: dict, wdev):
    """The pairwise exchange of :func:`_transport` (its "exchange")."""
    n = dist.get_world_size(group)
    members = sorted(dist.get_process_group_ranks(group))
    me = dist.get_rank()
    none = torch.full((_KEY + _MAX_DIMS,), -1, dtype=torch.int64, device=wdev)
    # every member's manifest: the header of what it sends to and expects
    # from each member, in group order
    man = torch.stack([_header(pieces[g], wdev) if g in pieces else none for g in members]
                      + [_header(expect[g], wdev) if g in expect else none for g in members])
    mans = [torch.empty_like(man) for _ in range(n)]
    dist.all_gather(mans, man, group=group)
    def what(h):
        return "nothing" if int(h[0]) < 0 else tuple(int(v) for v in h[2:2 + int(h[1])])

    for i, gi in enumerate(members):
        for j, gj in enumerate(members):
            sent, wanted = mans[i][j][:_KEY], mans[j][n + i][:_KEY]
            if not torch.equal(sent, wanted):
                raise ValueError(f"exchange: process {gi} sends process {gj} {what(sent)} but "
                                 f"it expects {what(wanted)}")
    sends = {g: _wire(t.detach()).to(wdev).contiguous() for g, t in pieces.items()}
    bufs = {g: torch.empty(_wire(t).shape, dtype=_wire(t).dtype, device=wdev)
            for g, t in expect.items()}
    dlaf_assert(me not in sends and me not in bufs, "exchange: a process sends to itself")
    _p2p(sends, bufs)
    return {g: (_unwire(b.to(x.device), expect[g]) if wdev != x.device
                else _unwire(b, expect[g])) for g, b in bufs.items()}


def _world_line(axis: str):
    """This process's rank, its line's group along ``axis`` and the global
    process ranks of the line in rank order along the axis."""
    r, c = _WORLD.local_ranks[0]
    P, Q = _WORLD.size.row, _WORLD.size.col
    if axis == ROW_AXIS:
        return (r, c), _WORLD.col_group(c), [_WORLD.process_rank(i, c) for i in range(P)]
    if axis == COL_AXIS:
        return (r, c), _WORLD.row_group(r), [_WORLD.process_rank(r, j) for j in range(Q)]
    raise ValueError(f"unknown axis {axis!r}")


def _gather_line(xs, axis: str) -> list:
    """Every value of this process's line along ``axis``, in rank order
    along it (multi-process form)."""
    (r, c), group, line = _world_line(axis)
    got = _transport("all_gather", xs[r][c], group)
    order = sorted(line)
    return [got[order.index(g)] for g in line]


def _only_local(xs, value) -> list:
    """A nested per-rank list holding ``value`` at this process's rank."""
    r, c = _WORLD.local_ranks[0]
    out = [[None] * len(xs[0]) for _ in range(len(xs))]
    out[r][c] = value
    return out


# ---------------------------------------------------------------------------
# The verbs
# ---------------------------------------------------------------------------

def bcast(xs, axis: str, src: int, *, shared: bool = False):
    """Broadcast the value of rank ``src`` along ``axis`` (reference
    ``kernels/broadcast.h``)."""
    _record_value("bcast", axis, xs, (src, 0) if axis == ROW_AXIS else (0, src))
    xs = _maybe_inject("bcast", axis, xs)
    if _WORLD is not None:
        (r, c), group, line = _world_line(axis)
        return _only_local(xs, _plus_zero(_transport("broadcast", xs[r][c], group,
                                                     src=line[src])))
    return _per_receiver(xs, axis, shared,
                         lambda r, c: _received(_line(xs, axis, r, c)[src], xs[r][c]))


def bcast2d(xs, owner_r: int, owner_c: int):
    """Broadcast rank ``(owner_r, owner_c)``'s value to the whole grid in
    one step: the diagonal-tile broadcast of every blocked step."""
    P, Q = grid_shape(xs)
    _record_value("bcast2d", ROW_AXIS, xs, (owner_r, owner_c))
    _record_value("bcast2d", COL_AXIS, xs, (owner_r, owner_c))
    xs = _maybe_inject("bcast2d", ROW_AXIS, xs)
    if _WORLD is not None:
        r, c = _WORLD.local_ranks[0]
        return _only_local(xs, _plus_zero(_transport(
            "broadcast", xs[r][c], dist.group.WORLD, src=_WORLD.process_rank(owner_r, owner_c))))
    return per_rank(P, Q, lambda r, c: _received(xs[owner_r][owner_c], xs[r][c]))


_FOLD = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def _fold(vals: list, op: str, dev) -> torch.Tensor:
    acc = vals[0].to(dev, copy=True)
    for v in vals[1:]:
        acc = _FOLD[op](acc, v.to(dev))
    return acc


def all_reduce(xs, axis: str, op: str = "sum", *, shared: bool = False):
    """All-reduce along ``axis`` (reference ``kernels/all_reduce.h``): the
    fold of the values in rank order along the axis. :func:`reduce` runs
    through here and counts under this kind, as the reference's."""
    _record_value("all_reduce", axis, xs)
    return _all_reduce(_maybe_inject("all_reduce", axis, xs), axis, op, shared=shared)


def _all_reduce(xs, axis: str, op: str = "sum", *, shared: bool = False):
    if op not in _FOLD:
        raise ValueError(f"unsupported reduce op {op!r}")
    if _WORLD is not None:
        r, c = _WORLD.local_ranks[0]
        return _only_local(xs, _fold(_gather_line(xs, axis), op, xs[r][c].device))
    return _per_receiver(xs, axis, shared,
                         lambda r, c: _fold(_line(xs, axis, r, c), op, xs[r][c].device))


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
    _record_value("send_recv", axis, xs)
    P, Q = grid_shape(xs)
    if _WORLD is not None:
        (r, c), group, line = _world_line(axis)
        got = _transport("broadcast", xs[r][c], group, src=line[src])
        return _only_local(xs, got if _pos(axis, r, c) == dst else torch.zeros_like(xs[r][c]))
    return per_rank(P, Q, lambda r, c: _line(xs, axis, r, c)[src].to(xs[r][c].device, copy=True)
                    if _pos(axis, r, c) == dst else torch.zeros_like(xs[r][c]))


def all_gather(xs, axis: str, *, tiled: bool = False, concat_axis: int = 0,
               shared: bool = False):
    """Every rank's value along ``axis`` on every rank: stacked on a new
    axis ``concat_axis`` (of the axis' size), or concatenated along it
    when ``tiled``."""
    _record_value("all_gather", axis, xs)
    return _all_gather(_maybe_inject("all_gather", axis, xs), axis, tiled=tiled,
                       concat_axis=concat_axis, shared=shared)


def _all_gather(xs, axis: str, *, tiled: bool = False, concat_axis: int = 0,
                shared: bool = False):
    join = torch.cat if tiled else torch.stack
    if _WORLD is not None:
        return _only_local(xs, join(_gather_line(xs, axis), dim=concat_axis))

    def one(r, c):
        dev = xs[r][c].device
        return join([v.to(dev) for v in _line(xs, axis, r, c)], dim=concat_axis)

    return _per_receiver(xs, axis, shared, one)


def all_to_all(xs, axis: str, *, split_axis: int, concat_axis: int):
    """Tiled all-to-all along ``axis`` (reference ``collectives.py:231``,
    the layout transpose of the distributed chase back-transform). Every
    value's ``split_axis`` must divide by the axis' rank count."""
    _record_value("all_to_all", axis, xs)
    xs = _maybe_inject("all_to_all", axis, xs)
    P, Q = grid_shape(xs)
    size = P if axis == ROW_AXIS else Q
    for r, c in local_ranks(P, Q):
        v = xs[r][c]
        if v.shape[split_axis] % size:
            raise ValueError(f"all_to_all: axis {split_axis} of {tuple(v.shape)} does not "
                             f"divide by the {size} ranks along {axis!r}")
    if _WORLD is not None:
        # pairwise: each peer of the line receives its chunk only
        (r, c), group, line = _world_line(axis)
        me = _pos(axis, r, c)
        chunks = xs[r][c].chunk(size, dim=split_axis)
        peers = {g: j for j, g in enumerate(line) if j != me}
        got = _transport("exchange", xs[r][c], group,
                         pieces={g: chunks[j] for g, j in peers.items()},
                         expect={g: chunks[me] for g in peers})
        return _only_local(xs, torch.cat([chunks[me] if j == me else got[g]
                                          for j, g in enumerate(line)], dim=concat_axis))

    def one(r, c):
        dev = xs[r][c].device
        me = _pos(axis, r, c)
        parts = [v.chunk(size, dim=split_axis)[me].to(dev) for v in _line(xs, axis, r, c)]
        return torch.cat(parts, dim=concat_axis)

    return per_rank(P, Q, one)


def scatter(parts, owner_r: int, owner_c: int, like):
    """Rank ``(owner_r, owner_c)``'s per-rank values to their ranks: rank
    ``(r, c)`` gets ``parts[r][c]`` as a new tensor on ``like[r][c]``'s
    device. Only the owner's process reads ``parts`` (a full nested list
    there; None elsewhere); ``like[r][c]`` gives every rank's shape and
    dtype, the same on every rank. Nothing else crosses: each process
    receives its rank's piece only."""
    _record_value("scatter", GRID_AXIS, like)
    P, Q = grid_shape(like)
    if _WORLD is not None:
        r, c = _WORLD.local_ranks[0]
        owner = _WORLD.process_rank(owner_r, owner_c)
        pieces = None
        if dist.get_rank() == owner:
            order = sorted((_WORLD.process_rank(i, j), (i, j)) for i in range(P)
                           for j in range(Q))
            pieces = [parts[i][j] for _, (i, j) in order]
        return _only_local(like, _transport("scatter", like[r][c], dist.group.WORLD,
                                            src=owner, pieces=pieces))
    return per_rank(P, Q, lambda r, c: _copy(parts[r][c], like[r][c].device))


def gather(xs, owner_r: int, owner_c: int):
    """Every rank's value on rank ``(owner_r, owner_c)``: a nested per-rank
    list of new tensors on the owner's device, returned where the owner's
    rank is driven (None on the other processes). The values may differ
    in their leading extent (a count of tiles), not otherwise."""
    _record_value("gather", GRID_AXIS, xs)
    P, Q = grid_shape(xs)
    if _WORLD is not None:
        r, c = _WORLD.local_ranks[0]
        owner = _WORLD.process_rank(owner_r, owner_c)
        got = _transport("gather", xs[r][c], dist.group.WORLD, src=owner)
        if got is None:
            return None
        order = sorted(range(P * Q), key=lambda i: _WORLD.process_rank(i // Q, i % Q))
        out = [[None] * Q for _ in range(P)]
        for i, v in zip(order, got):
            out[i // Q][i % Q] = v
        return out
    dev = xs[owner_r][owner_c].device
    return [[_copy(xs[r][c], dev) for c in range(Q)] for r in range(P)]


def bcast_arrays(arrays, owner_r: int, owner_c: int, specs) -> list:
    """Host arrays formed once, on the process that drives rank
    ``(owner_r, owner_c)``, on every process, bit for bit: ``arrays`` (a
    list of numpy arrays) there, None elsewhere; ``specs`` their ``(shape,
    dtype)`` on every process. The owner keeps its own arrays; each crosses
    to the others by one broadcast of the transport, through host memory
    on gloo and through this process's device on NCCL. Without a world,
    ``arrays``."""
    if obs.metrics_active():
        _record("bcast_arrays", GRID_AXIS, sum(int(np.prod(shape)) * np.dtype(dtype).itemsize
                                               for shape, dtype in specs))
    if _WORLD is None:
        return arrays
    owner = _WORLD.process_rank(owner_r, owner_c)
    mine = dist.get_rank() == owner
    dev = (torch.device("cpu") if dist.get_backend() == "gloo"
           else _WORLD.device(*_WORLD.local_ranks[0]))
    out = []
    for i, (shape, dtype) in enumerate(specs):
        x = (torch.from_numpy(arrays[i]).to(dev) if mine else
             torch.empty(tuple(shape), dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                         device=dev))
        got = _transport("broadcast", x, dist.group.WORLD, src=owner)
        out.append(arrays[i] if mine else got.cpu().numpy())
    return out


def exchange(sends, expect):
    """Pairwise exchange between ranks: ``sends[r][c]`` maps a destination
    rank ``(r2, c2)`` to the value rank ``(r, c)`` sends it, and
    ``expect[r][c]`` maps a source rank to a tensor of the shape and dtype
    rank ``(r, c)`` receives from it. Returns per rank ``{source rank:
    value}``, each a new tensor on the device of the ``expect`` entry.
    Only the named pairs move data: no rank receives what another rank
    was sent. A rank's value to itself is a copy."""
    P, Q = grid_shape(expect)
    if obs.metrics_active():
        r0, c0 = local_ranks(P, Q)[0]
        _record("exchange", GRID_AXIS, sum(_nbytes(v) for v in (sends[r0][c0] or {}).values()))

    def take(r, c):
        out = {}
        for (r2, c2), like in expect[r][c].items():
            if is_local(r2, c2):
                out[(r2, c2)] = _copy(sends[r2][c2][(r, c)], like.device)
        return out

    local = per_rank(P, Q, take)
    if _WORLD is None:
        return local
    r, c = _WORLD.local_ranks[0]
    pr = _WORLD.process_rank
    pieces = {pr(*k): v for k, v in sends[r][c].items() if not is_local(*k)}
    wanted = {pr(*k): v for k, v in expect[r][c].items() if not is_local(*k)}
    got = _transport("exchange", torch.empty(0, device=_WORLD.device(r, c)), dist.group.WORLD,
                     pieces=pieces, expect=wanted)
    where = {pr(i, j): (i, j) for i in range(P) for j in range(Q)}
    local[r][c].update({where[g]: v for g, v in got.items()})
    return local


def barrier_value(xs, axis: str):
    """``x`` plus a zero reduced along ``axis``: the reference's
    order-enforcing no-op (a fence between programs there). In the
    multi-process form the zero is all-reduced along the line."""
    P, Q = grid_shape(xs)
    zero = per_rank(P, Q, lambda r, c: torch.zeros((), dtype=xs[r][c].dtype,
                                                   device=xs[r][c].device))
    _record_value("barrier", axis, zero)
    if _WORLD is not None:
        zero = _all_reduce(zero, axis)
    return per_rank(P, Q, lambda r, c: xs[r][c] + zero[r][c])
