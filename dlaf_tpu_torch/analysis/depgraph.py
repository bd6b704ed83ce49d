"""The eager op tape: one real call recorded op by op, and the dependency
vocabulary the structural pins and :mod:`.graphcheck` are written in.

Port of ``dlaf_tpu/analysis/depgraph.py``. The reference walks traced
jaxprs; the port has no traced program, so :func:`trace` runs ``fn``
once, eagerly, and records everything it does into a :class:`Tape`:

* **ATen ops**, from a ``TorchDispatchMode``: name, dtypes, shapes and
  device of each, and the element ranges it reads and writes. In-place and
  ``out=`` writes come from the schema's ``alias_info.is_write``; a
  ``copy_``/``fill_``/``zero_`` target and an ``out=`` argument are
  written and not read. Pure views (every result an alias that is not
  written) are ``view`` nodes that read and write nothing.
* **Host reads**, from a ``TorchFunctionMode``: ``.item()``, ``.cpu()``,
  ``.numpy()``, ``.tolist()``, ``bool()``/``int()``/``float()``, and a
  tensor's ``__array__``/``__repr__``/``__format__`` (on the CPU several
  of these reach no ATen op). Each is one ``host`` node; the ATen ops it
  runs nest under it. A host read of a tensor on the program's device is
  a **host sync**, and so are the ops of :data:`SYNC_OPS` (``.item()``'s
  ``_local_scalar_dense``, ops whose output shape depends on the data,
  the library's error checks), a blocking copy between the host and the
  card, and a ``torch.tensor``/``as_tensor`` of host data onto the card.
  This one table is what the card's runtime warnings are held against
  (``chip_smoke.py`` phase 36 b). ``torch.cuda.synchronize()`` and an
  event's or a stream's ``synchronize()`` reach neither mode and are not
  recorded: the linter's ``lint-host-sync`` catches them.
* **Hand kernels**: a launch goes through ctypes and never reaches the
  dispatcher, so each kernel wrapper notes one ``kernel:<name>`` node
  (``obs.trace.kernel_node``) reading its tensor arguments and writing
  its results. On the CPU the plain version's ops nest under the node; on
  the card the wrapper's own ops do. A tape of the card and one of the
  CPU agree once each kernel node is collapsed (:func:`iter_ops`).
* **Collectives**: each verb of ``comm/collectives.py`` is one
  ``collective`` node (kind, axis, scalar arguments, per-rank shapes and
  dtypes); its copies nest under it. The tape also keeps each process's
  verb schedule (:attr:`Tape.schedule`) with the group each verb ran on,
  the input of :func:`.graphcheck.schedule_findings`.
* **Step scopes**: ``obs.named_span``/``obs.scoped_step`` push their name
  on the armed tape, so each node carries its innermost
  ``<algo>.step<k>[.<phase>]`` or ``<algo>.scanstep`` scope. The tape
  arms through ``obs.STATE.tape``, never through ``STATE.annotate``
  (which would make ``obs.enabled()`` true and start the profiler): the
  recorded call is the plain one.

**Dataflow by element range, not by storage.** A rank's tiles are views
of one ``(ltr, ltc, mb, nb)`` shard, so a panel is strided. A view's
bytes are the exact runs its strides give (inner dims merged while
contiguous); each storage keeps the last writer of every byte range, and
an op depends on the last writers of the ranges it reads. Two tile views
of one shard make no edge. Two places are conservative where exactness
would cost too much: a view of more than :data:`MAX_RUNS` runs is its
hull, and a kernel or verb writes its whole result (the update kernel's
mode table lives on the card: its write is the whole trailing block).

**Why not ``make_fx``, ``torch.export`` or ``torch.compile``.** They
bake ``.item()`` into constants or break the graph at it, which hides
exactly the syncs this audit looks for, and they see nothing of a ctypes
kernel. The eager tape sees both, at the cost of running the call.

**What the reference has that the tape does not.** ``shard_map_body``,
``scan_eqns``, ``scan_body`` and ``subjaxprs`` descend into nested
programs; an eager call has none (a scan form is a Python loop whose
steps sit one after another on the tape), so they are not ported. Nor
are ``scan_carry_slots``/``dropped_outputs``: an eager loop has no
carry; per-step work thrown away is a dead output
(``graphcheck``'s ``graph-dead-output``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import sys
import time
from typing import Callable, Iterator, Tuple, Union

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

#: ATen ops that always make the host wait for the device: a scalar read,
#: ops whose output shape depends on the data, the library's error checks.
#: A copy between host and card, a boolean index and a ``repeat_interleave``
#: without ``output_size`` are decided per call (:meth:`Tape._op_sync`).
SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::is_nonzero", "aten::equal",
    "aten::nonzero", "aten::nonzero_numpy", "aten::argwhere", "aten::masked_select",
    "aten::_unique", "aten::_unique2", "aten::unique_dim", "aten::unique_consecutive",
    "aten::unique_dim_consecutive", "aten::bincount", "aten::_linalg_check_errors",
})

#: Tensor methods whose call reads a tensor's data on the host.
HOST_READS = frozenset({
    "item", "cpu", "numpy", "tolist", "__bool__", "__int__", "__float__", "__index__",
    "__array__", "__repr__", "__str__", "__format__",
})

#: Mutating ops whose target is written and not read.
WRITE_ONLY = frozenset({
    "aten::copy_", "aten::fill_", "aten::zero_", "aten::normal_", "aten::uniform_",
    "aten::random_", "aten::exponential_", "aten::bernoulli_", "aten::resize_",
})

#: Ops that make a constant from no tensor data (an allocation, a fill,
#: an index ramp): never a dead output, which is computed work.
FACTORIES = frozenset({
    "aten::empty", "aten::empty_like", "aten::empty_strided", "aten::new_empty",
    "aten::new_empty_strided", "aten::zeros", "aten::zeros_like", "aten::new_zeros",
    "aten::ones", "aten::ones_like", "aten::new_ones", "aten::full", "aten::full_like",
    "aten::new_full", "aten::eye", "aten::arange", "aten::scalar_tensor",
})

#: Runs above which a view's range is its hull.
MAX_RUNS = 1 << 20

#: The grid axes, as the verbs name them.
_ROW, _COL = "row", "col"

#: Frames a node's site skips: this layer, the telemetry wrappers, the
#: kernel hook and the kernels' build helper.
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP_FRAMES = tuple(os.path.join(_PKG, p) for p in (
    "analysis" + os.sep, "obs" + os.sep, os.path.join("tile_ops", "cuda_build.py")))


# ---------------------------------------------------------------------------
# Element ranges
# ---------------------------------------------------------------------------

def _runs(t: torch.Tensor):
    """``(storage key, starts, ends)``: the byte runs of ``t``'s view,
    sorted and disjoint, relative to its storage; None for no bytes."""
    if t.numel() == 0 or t.layout != torch.strided:
        return None
    st = t.untyped_storage()
    base = st.data_ptr()
    if not base:
        return None
    isz = t.element_size()
    dims = sorted(((sz, sd) for sz, sd in zip(t.shape, t.stride()) if sz != 1 and sd != 0),
                  key=lambda d: -abs(d[1]))
    run = 1
    while dims and dims[-1][1] == run:
        run *= dims[-1][0]
        dims.pop()
    off = t.storage_offset()
    count = 1
    for sz, _ in dims:
        count *= sz
    if count > MAX_RUNS:
        lo = off + sum((sz - 1) * sd for sz, sd in dims if sd < 0)
        hi = off + sum((sz - 1) * sd for sz, sd in dims if sd > 0) + run
        starts, ends = np.array([lo], np.int64), np.array([hi], np.int64)
    else:
        starts = np.array([off], np.int64)
        for sz, sd in dims:
            starts = (starts[:, None] + np.arange(sz, dtype=np.int64) * sd).ravel()
        starts.sort()
        ends = starts + run
        if len(starts) > 1 and (starts[1:] <= ends[:-1]).any():
            starts, ends = _merge(starts, ends)
    return (t.device.type, base), starts * isz, ends * isz


def _merge(starts, ends):
    """Sorted overlapping or touching runs merged into disjoint ones."""
    reach = np.maximum.accumulate(ends)
    new = np.empty(len(starts), bool)
    new[0] = True
    new[1:] = starts[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    return starts[idx], np.append(reach[idx[1:] - 1], reach[-1])


class _Owners:
    """The last writer of every byte of one storage: a piecewise-constant
    map (breakpoints ``b``, owners ``o``, -1 for none). A write or a read
    works on the slice of breakpoints its runs span only."""

    __slots__ = ("b", "o")

    def __init__(self):
        self.b = np.zeros(1, np.int64)
        self.o = np.full(1, -1, np.int64)

    def _span(self, s, e):
        """Breakpoint indices ``[lo, hi)`` of the segments that
        ``[s[0], e[-1])`` touches."""
        b = self.b
        return (int(np.searchsorted(b, s[0], "right")) - 1,
                int(np.searchsorted(b, e[-1], "left")))

    def query(self, s, e) -> np.ndarray:
        lo, hi = self._span(s, e)
        b, o = self.b[lo:hi], self.o[lo:hi]
        if len(b) == 1 or len(s) == 1:
            own = o
        else:
            i0 = np.searchsorted(b, s, "right") - 1
            i1 = np.searchsorted(b, e, "left") - 1
            d = np.bincount(i0, minlength=len(b) + 1) - np.bincount(i1 + 1, minlength=len(b) + 1)
            own = o[np.cumsum(d[:-1]) > 0]
        own = own[own >= 0]
        # node indices are small: a count is cheaper than a sort
        return np.flatnonzero(np.bincount(own)) if len(own) > 64 else np.unique(own)

    def assign(self, s, e, w: int) -> None:
        lo, hi = self._span(s, e)
        b, o = self.b[lo:hi], self.o[lo:hi]
        # the span's breakpoints (kind 0), the runs' starts (+1) and ends
        # (-1), merged stably: the three inputs are sorted, the sort is a
        # linear merge, and among equal values the last entry carries both
        # the previous owner (the last breakpoint at or before it) and the
        # depth (inside a run or not: the runs are disjoint)
        vals = np.concatenate([b, s, e])
        kind = np.concatenate([np.zeros(len(b), np.int64), np.ones(len(s), np.int64),
                               np.full(len(e), -1, np.int64)])
        order = np.argsort(vals, kind="stable")
        vals, kind = vals[order], kind[order]
        last_b = np.cumsum(kind == 0) - 1
        depth = np.cumsum(kind)
        keep = np.empty(len(vals), bool)
        keep[-1] = True
        keep[:-1] = vals[:-1] != vals[1:]
        nb = vals[keep]
        no = np.where(depth[keep] > 0, w, o[last_b[keep]])
        if hi < len(self.b) and self.b[hi] == nb[-1]:
            # the segment after the span starts there, with its own owner
            nb, no = nb[:-1], no[:-1]
        full_b = np.concatenate([self.b[:lo], nb, self.b[hi:]])
        full_o = np.concatenate([self.o[:lo], no, self.o[hi:]])
        keep = np.empty(len(full_o), bool)
        keep[0] = True
        keep[1:] = full_o[1:] != full_o[:-1]
        self.b, self.o = full_b[keep], full_o[keep]


# ---------------------------------------------------------------------------
# Nodes and the tape
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class Node:
    """One recorded event. ``kind``: ``op`` (an ATen op), ``view`` (an
    ATen op whose results alias its inputs), ``kernel`` (a hand kernel
    launch), ``collective`` (a verb), ``host`` (a host read). ``parent``
    is the kernel, verb or host read it nests under (None at the top);
    ``scope`` the named scopes around it, outermost first;
    ``step_id`` numbers the entries of step scopes, so the nodes of one
    scan step (whose name has no index) can be told from the next's."""

    index: int
    kind: str
    name: str
    scope: str = ""
    parent: int | None = None
    device: str = ""
    dtypes: Tuple[str, ...] = ()
    shapes: Tuple[Tuple[int, ...], ...] = ()
    producers: Tuple[int, ...] = ()
    inplace: bool = False
    sync: bool = False
    out_bytes: int = 0
    demotion: str | None = None
    step_id: int = -1
    launched: bool = True
    axis: str | None = None
    params: Tuple = ()
    site: str = ""


class _Frame:
    """An open kernel, verb or host read: the node, and the storages its
    nested ops wrote."""

    __slots__ = ("node", "writes")

    def __init__(self, node):
        self.node, self.writes = node, []


class Tape:
    """What one call did (see the module docstring). ``ops=False``
    records the verbs and scopes only (the schedule form: no dispatch
    mode, nothing per op). ``device``: the program's device type, whose
    data a host read syncs on."""

    def __init__(self, device: str = "cpu", *, ops: bool = True):
        self.device = device
        self.ops = ops
        self.nodes: list = []
        self.schedule: list = []
        self.result = None
        self.wall_s = 0.0
        self.rank_bytes = 1
        self._read: bytearray = bytearray()
        self._owners: dict = {}
        self._scopes: list = [""]
        self._step_ids: list = [-1]
        self._steps = 0
        self._frames: list = []
        self._busy = False

    def __bool__(self) -> bool:
        return True

    # -- recording --------------------------------------------------------

    def _new(self, kind: str, name: str, **kw) -> Node:
        node = Node(len(self.nodes), kind, name, scope=self._scopes[-1],
                    step_id=self._step_ids[-1],
                    parent=self._frames[-1].node.index if self._frames else None, **kw)
        self.nodes.append(node)
        self._read.append(0)
        return node

    def _producers(self, tensors) -> Tuple[int, ...]:
        """The last writers of what ``tensors`` view, each marked read."""
        got = set()
        for t in tensors:
            r = _runs(t)
            if r is None:
                continue
            own = self._owners.get(r[0])
            if own is not None:
                got.update(own.query(r[1], r[2]).tolist())
        for i in got:
            self._read[i] = 1
        return tuple(sorted(got))

    def _write(self, tensors, owner: int) -> None:
        for t in tensors:
            r = _runs(t)
            if r is None:
                continue
            own = self._owners.get(r[0])
            if own is None:
                own = self._owners[r[0]] = _Owners()
            own.assign(r[1], r[2], owner)

    def _site(self) -> str:
        """``file:line`` of the innermost Python frame outside torch and
        this module: where a host sync was asked for."""
        f = sys._getframe(2)
        while f is not None:
            fn = f.f_code.co_filename
            if not (fn.startswith(_SKIP_FRAMES) or os.sep + "torch" + os.sep in fn):
                return f"{fn}:{f.f_lineno}"
            f = f.f_back
        return ""

    def _op_sync(self, name: str, args, kwargs, reads) -> bool:
        on_dev = any(t.device.type == self.device for t in reads)
        if name in SYNC_OPS:
            return on_dev
        if name in ("aten::_to_copy", "aten::copy_") and self.device != "cpu":
            if kwargs.get("non_blocking") or (name == "aten::copy_" and len(args) > 2
                                              and args[2]):
                return False
            if name == "aten::_to_copy":
                src, dst = args[0].device.type, str(kwargs.get("device") or args[0].device)
                dst = torch.device(dst).type
            else:
                src, dst = args[1].device.type if isinstance(args[1], torch.Tensor) else "cpu", \
                    args[0].device.type
            return src != dst and self.device in (src, dst)
        if name in ("aten::index", "aten::index_put_", "aten::index_put"):
            return on_dev and any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
                                  for t in _tensors(list(args[1:2]), []))
        if name == "aten::repeat_interleave":
            return on_dev and kwargs.get("output_size") is None
        return False

    def record_op(self, func, args, kwargs, out) -> None:
        name, arg_info, ret_info, pure_view = _schema_info(func)
        if pure_view:
            self._new("view", name)
            return
        reads, writes, inplace = [], [], False
        for i, (aname, is_write) in enumerate(arg_info):
            val = args[i] if i < len(args) else kwargs.get(aname)
            ts = _tensors(val, [])
            if not ts:
                continue
            if is_write:
                inplace = True
                writes += ts
                if aname == "self" and name not in WRITE_ONLY:
                    reads += ts
            else:
                reads += ts
        outs = out if isinstance(out, (tuple, list)) else (out,)
        fresh = []
        for ret, o in zip(ret_info, outs):
            if ret is None:
                _tensors(o, fresh)
        shown = fresh or writes
        node = self._new("op", name, device=_dev(reads + shown), inplace=inplace,
                         dtypes=tuple(_dt(t) for t in shown),
                         shapes=tuple(tuple(t.shape) for t in shown),
                         out_bytes=max((t.numel() * t.element_size() for t in fresh), default=0))
        node.sync = self._op_sync(name, args, kwargs, reads) and not self._in_host_frame()
        node.demotion = _demotion(name, args, out)
        if self._frames:
            if node.sync:
                node.site = self._site()
            self._frames[-1].writes += writes
            return
        node.site = self._site()
        node.producers = self._producers(reads)
        self._write(writes + fresh, node.index)

    def host_read(self, name: str, func, args, kwargs):
        t = args[0]
        node = self._new("host", f"host:{name}", device=t.device.type, dtypes=(_dt(t),),
                         shapes=(tuple(t.shape),))
        node.sync = t.device.type == self.device and not self._in_host_frame()
        if node.sync:
            node.site = self._site()
        self._frames.append(_Frame(node))
        try:
            out = func(*args, **(kwargs or {}))
        finally:
            self._frames.pop()
        if self._frames:
            return out
        node.producers = self._producers([t])
        fresh = [o for o in _tensors(out, []) if not _same_view(o, t)]
        self._write(fresh, node.index)
        return out

    def _in_host_frame(self) -> bool:
        return any(f.node.kind == "host" for f in self._frames)

    def host_transfer(self, name: str, device) -> None:
        """A ``torch.tensor``/``as_tensor`` of host data onto the card: a
        blocking copy (one sync) that reaches no mode's op."""
        node = self._new("host", f"host:{name}", device=torch.device(device).type)
        node.sync = node.device == self.device
        if node.sync:
            node.site = self._site()

    def scope(self, label: str):
        return _Scope(self, label)

    def kernel(self, key: str, fn, args, kwargs, launches: dict):
        """One ``kernel:<key>`` node around the wrapper's call (see
        ``obs.trace.kernel_node``)."""
        if self._frames or not self.ops:
            return fn(*args, **kwargs)
        ins = _tensors((args, kwargs), [])
        node = self._new("kernel", f"kernel:{key}", device=_dev(ins), site=self._site())
        before = launches.get(key, 0)
        frame = _Frame(node)
        self._frames.append(frame)
        try:
            out = fn(*args, **kwargs)
        finally:
            self._frames.pop()
        outs = _tensors(out, [])
        node.launched = node.device == "cpu" or launches.get(key, 0) > before
        node.dtypes = tuple(_dt(t) for t in outs)
        node.shapes = tuple(tuple(t.shape) for t in outs)
        in_keys = {_key(t) for t in ins}
        node.inplace = any(_key(t) in in_keys for t in outs)
        node.out_bytes = max((t.numel() * t.element_size() for t in outs
                              if _key(t) not in in_keys), default=0)
        node.producers = self._producers(ins)
        self._write(outs + [t for t in frame.writes if _key(t) in in_keys], node.index)
        return out

    def verb(self, kind: str, fn, args, kwargs):
        """One ``collective`` node around a verb (see
        ``comm.collectives._verb``); the schedule entry of this process."""
        if self._frames:
            return fn(*args, **kwargs)
        from ..comm import collectives as cc

        axis = kwargs.get("axis", args[1] if len(args) > 1 and args[1] in (_ROW, _COL)
                          else None)
        params = tuple(a for a in args[1:] if isinstance(a, (int, str)) and a not in (_ROW, _COL))
        params += tuple((k, v) for k, v in sorted(kwargs.items())
                        if isinstance(v, (int, str, bool)) and k != "axis")
        ins = _tensors(args[:1], [])
        rest = _tensors((args[1:], kwargs), [])
        node = self._new("collective", kind, device=_dev(ins), axis=axis, params=params,
                         site=self._site(),
                         dtypes=tuple(_dt(t) for t in ins),
                         shapes=tuple(tuple(t.shape) for t in ins))
        world = cc.world()
        if world is None:
            group = "all"
        else:
            r, c = world.local_ranks[0]
            group = f"col{c}" if axis == _ROW else f"row{r}" if axis == _COL else "world"
        self.schedule.append((kind, axis, group, params, node.shapes, node.dtypes))
        if not self.ops:
            return fn(*args, **kwargs)
        frame = _Frame(node)
        self._frames.append(frame)
        try:
            out = fn(*args, **kwargs)
        finally:
            self._frames.pop()
        node.producers = self._producers(ins + rest)
        sigs = {_view_sig(t) for t in ins + rest}
        outs = [t for t in _tensors(out, []) if _view_sig(t) not in sigs]
        node.out_bytes = max((t.numel() * t.element_size() for t in outs), default=0)
        in_keys = {_key(t) for t in ins + rest}
        self._write(outs + [t for t in frame.writes if _key(t) in in_keys], node.index)
        return out

    # -- arming -----------------------------------------------------------

    @contextlib.contextmanager
    def armed(self):
        """Record while inside: ``obs.STATE.tape`` set, and with ``ops``
        the function and dispatch modes entered."""
        from ..obs import STATE

        if STATE.tape is not None:
            raise RuntimeError("a tape is already armed")
        STATE.tape = self
        modes = [_Functions(self), _Dispatch(self)] if self.ops else []
        try:
            with contextlib.ExitStack() as stack:
                for m in modes:
                    stack.enter_context(m)
                yield self
        finally:
            STATE.tape = None

    def finish(self, result, args) -> None:
        """Mark what the call hands back as read: its results and the
        ranges of its inputs (written in place)."""
        self._producers(_held_tensors((result, args), []))

    def was_read(self, node) -> bool:
        return bool(self._read[node.index if isinstance(node, Node) else node])

    def nbytes(self) -> int:
        """An estimate of the tape's host footprint: 200 bytes a node,
        8 a producer edge, and the owner maps' arrays."""
        per_node = 200
        owners = sum(o.b.nbytes + o.o.nbytes for o in self._owners.values())
        return per_node * len(self.nodes) + owners + sum(8 * len(n.producers)
                                                         for n in self.nodes)


class _Scope:
    __slots__ = ("tape", "label")

    def __init__(self, tape, label):
        self.tape, self.label = tape, label

    def __enter__(self):
        tape = self.tape
        top = tape._scopes[-1]
        tape._scopes.append(f"{top}/{self.label}" if top else self.label)
        if STEP_SCOPE_RE.fullmatch(self.label) or SCAN_SCOPE_RE.fullmatch(self.label):
            tape._steps += 1
            tape._step_ids.append(tape._steps)
        else:
            tape._step_ids.append(tape._step_ids[-1])
        return self

    def __exit__(self, *exc):
        self.tape._scopes.pop()
        self.tape._step_ids.pop()
        return False


class _Dispatch(TorchDispatchMode):
    def __init__(self, tape):
        super().__init__()
        self.tape = tape

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        tape = self.tape
        if not tape._busy:
            tape._busy = True
            try:
                tape.record_op(func, args, kwargs, out)
            finally:
                tape._busy = False
        return out


class _Functions(TorchFunctionMode):
    def __init__(self, tape):
        super().__init__()
        self.tape = tape

    def __torch_function__(self, func, types, args=(), kwargs=None):
        tape = self.tape
        name = getattr(func, "__name__", "")
        if not tape._busy:
            if name in HOST_READS and args and isinstance(args[0], torch.Tensor):
                return tape.host_read(name, func, args, kwargs)
            if name in ("tensor", "as_tensor") and tape.device != "cpu":
                dev = (kwargs or {}).get("device")
                data = args[0] if args else (kwargs or {}).get("data")
                if dev is not None and torch.device(dev).type != "cpu" and not (
                        isinstance(data, torch.Tensor) and data.device.type != "cpu"):
                    tape.host_transfer(name, dev)
        return func(*args, **(kwargs or {}))


_SCHEMAS: dict = {}


def _schema_info(func):
    """``(name, ((arg name, written), ...), (return alias: None fresh,
    False view, True written), pure view)`` of an op, cached."""
    info = _SCHEMAS.get(func)
    if info is None:
        sch = func._schema
        arg_info = tuple((a.name, bool(a.alias_info is not None and a.alias_info.is_write))
                         for a in sch.arguments)
        ret_info = tuple(None if r.alias_info is None else bool(r.alias_info.is_write)
                         for r in sch.returns)
        pure = bool(ret_info) and all(r is False for r in ret_info) \
            and not any(w for _, w in arg_info)
        info = _SCHEMAS[func] = (sch.name, arg_info, ret_info, pure)
    return info


def _tensors(x, out: list) -> list:
    """The tensors in ``x`` (nested lists, tuples, dicts), appended to
    ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _held_tensors(x, out: list) -> list:
    """:func:`_tensors`, and the tensors a result object holds: a
    ``Matrix``'s shards, a dataclass's fields (``BandReduction``,
    ``TridiagResult``, the eigensolver's result)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _held_tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _held_tensors(y, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _held_tensors(getattr(x, f.name), out)
    elif hasattr(x, "storage") and hasattr(x, "dist"):
        _held_tensors(x.storage, out)
    return out


def _dt(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _dev(ts) -> str:
    return ts[0].device.type if ts else ""


def _key(t):
    st = t.untyped_storage()
    return (t.device.type, st.data_ptr())


def _view_sig(t):
    return (_key(t), t.storage_offset(), tuple(t.shape), tuple(t.stride()), t.dtype)


def _same_view(a, b) -> bool:
    return _view_sig(a) == _view_sig(b)


_WIDE = {torch.float64, torch.complex128}
_NARROW = {torch.float32, torch.bfloat16, torch.float16, torch.complex64}


def _demotion(name: str, args, out):
    """``"float64->float32"`` when the op converts a non-scalar wide value
    to a narrow type (``_to_copy`` or ``copy_``), else None."""
    if name == "aten::_to_copy" and isinstance(out, torch.Tensor):
        src, dst = args[0], out
    elif name == "aten::copy_" and len(args) > 1 and isinstance(args[1], torch.Tensor):
        src, dst = args[1], args[0]
    else:
        return None
    if src.dtype in _WIDE and dst.dtype in _NARROW and src.numel() > 1:
        return f"{_dt(src)}->{_dt(dst)}"
    return None


# ---------------------------------------------------------------------------
# Tracing entry point
# ---------------------------------------------------------------------------

def _device_of(args) -> str:
    ts = _tensors(args, [])
    return ts[0].device.type if ts else "cpu"


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, np.ndarray):
        return x.nbytes
    return 0


def rank_bytes(args) -> int:
    """The bytes of ONE rank's inputs (the reference's per-shard
    denominator): a grid value ``xs[r][c]`` and a distributed ``Matrix``
    count rank (0, 0)'s shard; a tensor, a numpy array, and the arrays of
    any other object's attributes count whole."""
    total = 0
    for a in args:
        if isinstance(a, (torch.Tensor, np.ndarray)):
            total += _nbytes(a)
        elif isinstance(a, (list, tuple)) and a and isinstance(a[0], (list, tuple)):
            total += _nbytes(a[0][0])
        elif hasattr(a, "storage") and hasattr(a, "dist"):
            st = a.storage
            total += _nbytes(st[0] if isinstance(st, (list, tuple)) else st)
        elif dataclasses.is_dataclass(a):
            total += sum(_nbytes(getattr(a, f.name)) for f in dataclasses.fields(a))
    return max(total, 1)


def trace(fn, *args, device: str | None = None, ops: bool = True) -> Tape:
    """Run ``fn(*args)`` once, eagerly, and return its :class:`Tape`
    (``tape.result`` holds what ``fn`` returned, ``tape.rank_bytes`` one
    rank's input bytes). ``device``: the program's device type (default:
    that of the first tensor in ``args``)."""
    tape = Tape(device or _device_of(args), ops=ops)
    tape.rank_bytes = rank_bytes(args)
    t0 = time.perf_counter()
    with tape.armed():
        tape.result = fn(*args)
    tape.wall_s = time.perf_counter() - t0
    if ops:
        tape.finish(tape.result, args)
    return tape


# ---------------------------------------------------------------------------
# Queries (the reference's vocabulary on the tape)
# ---------------------------------------------------------------------------

Predicate = Callable[[Node], bool]


def _as_predicate(pred: Union[str, Predicate]) -> Predicate:
    """A node name (``"aten::mm"``, ``"kernel:step"``, a verb kind) as
    shorthand for a node predicate."""
    if isinstance(pred, str):
        name = pred
        return lambda n: n.name == name
    return pred


def iter_ops(tape: Tape, collapsed: bool = True) -> Iterator[Node]:
    """The nodes in emission order (the reference's ``iter_eqns``);
    ``collapsed`` (the default) leaves out what nests under a kernel, a
    verb or a host read."""
    for n in tape.nodes:
        if not collapsed or n.parent is None:
            yield n


def producers(tape: Tape) -> dict:
    """Each top-level node's index -> the indices of the nodes whose
    writes it read (the last writers of its ranges)."""
    return {n.index: n.producers for n in iter_ops(tape)}


def closure(tape: Tape, seeds) -> list:
    """Transitive producer closure of ``seeds`` (nodes or indices): every
    node they (transitively) read from, in emission order."""
    if isinstance(seeds, (Node, int)):
        seeds = [seeds]
    todo = []
    for s in seeds:
        todo.extend(tape.nodes[s].producers if isinstance(s, int) else s.producers)
    seen: set = set()
    while todo:
        i = todo.pop()
        if i in seen:
            continue
        seen.add(i)
        todo.extend(tape.nodes[i].producers)
    return [tape.nodes[i] for i in sorted(seen)]


def depends_on(tape: Tape, node_or_index, pred: Union[str, Predicate]) -> bool:
    """True iff the node transitively depends on a node matching
    ``pred``."""
    pred = _as_predicate(pred)
    return any(pred(d) for d in closure(tape, node_or_index))


def positions(tape: Tape, pred: Union[str, Predicate]) -> list:
    """Emission-order indices of the top-level nodes matching ``pred``:
    what "issued before" compares."""
    pred = _as_predicate(pred)
    return [n.index for n in iter_ops(tape) if pred(n)]


def collectives(tape: Tape) -> list:
    """Every verb of the call, in emission order."""
    return [n for n in tape.nodes if n.kind == "collective"]


def kernels(tape: Tape) -> dict:
    """Launched kernel nodes by kernel name (``potrf``, ``step``, ...)."""
    out: dict = {}
    for n in tape.nodes:
        if n.kind == "kernel" and n.launched:
            key = n.name.split(":", 1)[1]
            out[key] = out.get(key, 0) + 1
    return out


def host_syncs(tape: Tape) -> list:
    """Every host sync of the call, nested ones included (the reference's
    ``callbacks``): must be empty for a hot-path program."""
    return [n for n in tape.nodes if n.sync]


def contains_op(tape: Tape, names) -> bool:
    """True if any node (nested ones included) has a name in ``names``."""
    if isinstance(names, str):
        names = {names}
    names = set(names)
    return any(n.name in names for n in tape.nodes)


def is_collective(n: Node) -> bool:
    return n.kind == "collective"


# ---------------------------------------------------------------------------
# Per-step scope structure
# ---------------------------------------------------------------------------

#: The per-step scope convention every pipelined builder names
#: (``<algo>.step<k>.<phase>``, obs.named_span) and the index-free scan
#: form (``<algo>.scanstep[.<phase>]``, obs.scoped_step); textually the
#: reference's, and obs.critpath's.
STEP_SCOPE_RE = re.compile(
    r"([A-Za-z0-9_]+)\.step(\d+)(?:\.(panel|strip|bulk))?")
SCAN_SCOPE_RE = re.compile(
    r"([A-Za-z0-9_]+)\.scanstep(?:\.(panel|strip|bulk))?")


def step_scope_of(node: Node) -> Tuple[str, int, str] | None:
    """``(algo, step, phase)`` of a node's innermost step scope, or None.
    A scan step carries no index and reports step -1; phase defaults to
    ``other``."""
    stack = node.scope
    hits = list(STEP_SCOPE_RE.finditer(stack))
    if hits:
        h = hits[-1]  # innermost scope wins (comm-lookahead hoisting)
        return (h.group(1), int(h.group(2)), h.group(3) or "other")
    hits = list(SCAN_SCOPE_RE.finditer(stack))
    if hits:
        h = hits[-1]
        return (h.group(1), -1, h.group(2) or "other")
    return None


def is_bulk(node: Node) -> bool:
    """An op or kernel node in a ``.bulk`` phase: the bulk trailing work
    (the reference's 4-D ``dot_general`` rule)."""
    if node.kind not in ("op", "kernel"):
        return False
    key = step_scope_of(node)
    return key is not None and key[2] == "bulk"


def ancestor_steps(tape: Tape, pred: Union[str, Predicate]) -> list:
    """Per node index, a bitmask of the step indices of the nodes matching
    ``pred`` that the node transitively depends on (one pass in emission
    order; nested nodes get 0): ``ancestor_steps(t, is_bulk)[i] >> k & 1``
    asks whether node i depends on step k's bulk."""
    pred = _as_predicate(pred)
    own = [0] * len(tape.nodes)
    out = [0] * len(tape.nodes)
    for n in iter_ops(tape):
        acc = 0
        for p in n.producers:
            acc |= out[p] | own[p]
        out[n.index] = acc
        if pred(n):
            key = step_scope_of(n)
            if key is not None and key[1] >= 0:
                own[n.index] = 1 << key[1]
    return out


def step_groups(tape: Tape) -> dict:
    """Top-level nodes grouped by step scope: ``{(algo, step, phase):
    [node, ...]}`` in emission order; unscoped nodes are left out."""
    out: dict = {}
    for n in iter_ops(tape):
        key = step_scope_of(n)
        if key is not None:
            out.setdefault(key, []).append(n)
    return out


def step_edges(tape: Tape) -> set:
    """``(src, dst)`` where some node of group ``dst`` transitively depends
    on a node of group ``src`` (the static step DAG the critpath model
    walks; the lookahead pins read it)."""
    groups = step_groups(tape)
    keys = sorted(groups)
    bit = {k: 1 << i for i, k in enumerate(keys)}
    owner = {n.index: bit[k] for k, ns in groups.items() for n in ns}
    anc: dict = {}
    edges: set = set()
    for n in iter_ops(tape):
        acc = 0
        for p in n.producers:
            acc |= owner.get(p, 0) | anc.get(p, 0)
        anc[n.index] = acc
        mine = owner.get(n.index)
        if mine is not None and acc:
            for k in keys:
                if acc & bit[k] and bit[k] != mine:
                    edges.add((k, keys[mine.bit_length() - 1]))
    return edges


def step_structure(tape: Tape) -> dict:
    """The per-step phase structure of a call, JSON-ready:
    ``{"groups": {key: n_nodes}, "edges": [...], "algos": {algo:
    {"steps": K, "scan": bool}}}``, keys ``"<algo>.step<k>.<phase>"``
    (scan: ``"<algo>.scanstep.<phase>"``)."""
    groups = step_groups(tape)
    edges = step_edges(tape)

    def render(key) -> str:
        algo, step, phase = key
        stem = f"{algo}.scanstep" if step < 0 else f"{algo}.step{step:03d}"
        return f"{stem}.{phase}"

    algos: dict = {}
    for algo, step, _phase in groups:
        a = algos.setdefault(algo, {"steps": 0, "scan": False})
        if step < 0:
            a["scan"] = True
        else:
            a["steps"] = max(a["steps"], step + 1)
    return {
        "groups": {render(k): len(v) for k, v in sorted(groups.items())},
        "edges": sorted((render(a), render(b)) for a, b in edges),
        "algos": algos,
    }


def summary(tape: Tape) -> dict:
    """Counts for a report line: nodes, top-level ops, kernel nodes,
    collectives, host syncs, the tape's bytes and the recorded wall."""
    top = list(iter_ops(tape))
    return {"nodes": len(tape.nodes), "ops": sum(n.kind == "op" for n in top),
            "kernels": kernels(tape), "collectives": len(collectives(tape)),
            "host_syncs": len(host_syncs(tape)), "tape_bytes": tape.nbytes(),
            "wall_s": tape.wall_s}


__all__ = ["Node", "Tape", "trace", "iter_ops", "producers", "closure", "depends_on",
           "positions", "collectives", "kernels", "host_syncs", "contains_op", "is_collective",
           "is_bulk", "step_scope_of", "step_groups", "step_edges", "step_structure",
           "ancestor_steps",
           "summary", "STEP_SCOPE_RE", "SCAN_SCOPE_RE", "SYNC_OPS", "HOST_READS"]
