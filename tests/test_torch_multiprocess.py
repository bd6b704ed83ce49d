"""The multi-process form of the port, against its single controller and
against the JAX reference, on the CPU.

Each grid (2x2 with source rank (0, 1), and 1x3 with uneven tiles; n is
not a multiple of nb on both) is spawned once for the module: one process
per rank (``tests/torch_mp_worker.py``, which imports only the port), a
gloo world over a ``file://`` rendezvous in the module's temporary
directory. The processes run every case of ``torch_mp_worker.CASES``
through the port's entry points and write what their rank holds; each
test computes one case on the single-controller grid
(``shared_grid(P, Q, "cpu")``) here and holds the processes' results to
it bitwise: the Cholesky factor and info on every route and knob, the
triangular solve and multiply, max_norm, ``from_element_fn``,
``to_global`` and each verb (a ``"sum"`` all-reduce of values spanning
16 decades, whose bits depend on the order of the sum; a complex128
broadcast; the scatter from one process, the ragged gather to one and the
pairwise exchange), ``from_global(root=)`` and ``gather_global``, the
transposed-tile exchange (transpose, hermitianize), HEGST in both forms
(blocked, with look-ahead, on the Ozaki route, with info; twosolve), the
QR T factor, permute and general_sub_multiply. Worlds of their own (2x2
and 3x1, ``torch_mp_worker.A2A_CASES``) hold the pairwise all-to-all
along the row axis, alone and inside the chase back-transform, and with
the transport watched, that each call receives only the peers' chunks
through one pairwise exchange. Each case's verb schedules, saved by the
processes, agree within every group (graph-conditional-collective). The
2x2 Cholesky factor
is also held against ``dlaf_tpu``'s distributed builder on the virtual CPU
devices at ``60 n eps``, and its HEGST at ``100 n eps``. A process that
does not finish within its timeout fails the harness instead of hanging
it. The eigensolver pipeline's worlds are
``tests/test_torch_multiprocess_eigen.py``'s.
"""

import importlib
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_mp_worker as w
from dlaf_tpu import config as jcfg
from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu.common.index2d import RankIndex2D as JRankIndex2D
from dlaf_tpu.common.index2d import TileElementSize as JTileElementSize
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu_torch import config
from dlaf_tpu_torch.comm import collectives as cc
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.matrix.matrix import Matrix

jchol = importlib.import_module("dlaf_tpu.algorithms.cholesky")
jg2s = importlib.import_module("dlaf_tpu.algorithms.gen_to_std")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mp_worker.py")
#: Seconds a spawned world may take for all its cases.
TIMEOUT = 150.0


def spawn(P, Q, out_dir, mode="cases"):
    """Start one worker process per rank of a P x Q grid; returns the
    processes."""
    os.makedirs(out_dir, exist_ok=True)
    url = f"file://{out_dir}/rdv"
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, WORKER, url, str(i), str(P * Q), str(P), str(Q),
                              str(out_dir), mode], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
            for i in range(P * Q)]


def join(procs, timeout):
    """Wait for every process until ``timeout`` seconds have passed; on
    timeout kill them all and raise ``TimeoutError``, on a failed process
    ``RuntimeError`` with its output."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise TimeoutError(f"a spawned process did not finish within {timeout} s")
    for i, p in enumerate(procs):
        out = p.stdout.read().decode(errors="replace")
        p.stdout.close()
        if p.returncode:
            raise RuntimeError(f"process {i} exited with {p.returncode}:\n{out[-4000:]}")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both grids' worlds, spawned together; their output directories."""
    dirs = {g: str(tmp_path_factory.mktemp(f"mp{g}")) for g in w.GRIDS}
    procs = {g: spawn(w.GRIDS[g][0], w.GRIDS[g][1], dirs[g]) for g in w.GRIDS}
    errors = {}
    for g, ps in procs.items():
        try:
            join(ps, TIMEOUT)
        except (TimeoutError, RuntimeError) as e:
            errors[g] = e
    return dirs, errors


@pytest.fixture(scope="module")
def a2a_worlds(tmp_path_factory):
    """The all-to-all's worlds (``torch_mp_worker.A2A_GRIDS``), spawned
    together; their output directories."""
    dirs = {g: str(tmp_path_factory.mktemp(f"a2a{g}")) for g in w.A2A_GRIDS}
    procs = {g: spawn(*w.A2A_GRIDS[g][:2], dirs[g], mode="a2a") for g in w.A2A_GRIDS}
    errors = {}
    for g, ps in procs.items():
        try:
            join(ps, TIMEOUT)
        except (TimeoutError, RuntimeError) as e:
            errors[g] = e
    return dirs, errors


def load(worlds, g, name):
    """Every process's result of case ``name`` on grid ``g``."""
    dirs, errors = worlds
    if g in errors:
        raise errors[g]
    P, Q = {**w.GRIDS, **w.A2A_GRIDS}[g][:2]
    res = [torch.load(os.path.join(dirs[g], f"{name}.r{i}.pt")) for i in range(P * Q)]
    for r in res:
        assert "error" not in r, r["error"]
    return res


@pytest.fixture
def single(monkeypatch):
    """``run(name, g)``: the case on the single-controller grid, one thread
    as in the spawned processes; the knobs are restored afterwards."""
    def run(name, g):
        P, Q = {**w.GRIDS, **w.A2A_GRIDS}[g][:2]
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return w.run_case(name, shared_grid(P, Q, "cpu"), monkeypatch.setenv,
                              lambda k: monkeypatch.delenv(k, raising=False))
        finally:
            torch.set_num_threads(threads)

    yield run
    monkeypatch.undo()
    config.initialize()


def bits(t):
    """``t``'s bit patterns as integers: equal only where every bit is
    (``-0.0`` is not ``+0.0``; NaNs compare by payload)."""
    t = t.detach()
    if t.is_complex():
        t = torch.view_as_real(t)
    if t.is_floating_point():
        t = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t.numpy()


def layout(t):
    """``t``'s strides where its extent is above 1 (the strides of unit
    dimensions address nothing)."""
    return tuple(st for st, n in zip(t.stride(), t.shape) if n > 1)


def expected_shards(res):
    """The single controller's per-rank values, keyed as the processes'."""
    if "mat" in res:
        return {f"{i}": s for i, s in enumerate(res["mat"].storage)}
    Q = len(res["ranks"][0])
    return {f"{r * Q + c}": v for r, row in enumerate(res["ranks"]) for c, v in enumerate(row)}


def compare(got, ref):
    """Hold every process's result of one case (``got``, in process order)
    bitwise to the single controller's ``ref``: info and values, arrays
    every process holds, the one process's ``root_array``, and each
    rank's shard or value from exactly the process that drives it."""
    want = expected_shards(ref) if ("mat" in ref or "ranks" in ref) else {}
    seen = set()
    roots = []
    for i, r in enumerate(got):
        res = r["ok"]
        for key in ("info", "value"):
            if key in ref:
                assert repr(res[key]) == repr(ref[key]), \
                    f"process {i}: {key} {res[key]} != {ref[key]}"
        if "array" in ref:
            np.testing.assert_array_equal(bits(res["array"]), bits(ref["array"]))
        if res.get("root_array") is not None:
            roots.append(res["root_array"])
        for k, v in res.get("shards", {}).items():
            assert v.dtype == want[k].dtype and v.shape == want[k].shape
            if "ranks" in ref:   # a verb's result: the single controller's layout too
                assert layout(v) == layout(want[k]), (k, v.stride(), want[k].stride())
            np.testing.assert_array_equal(bits(v), bits(want[k]), err_msg=f"rank {k}")
            seen.add(k)
    if "root_array" in ref:
        # the value reaches one process only
        assert len(roots) == 1, len(roots)
        np.testing.assert_array_equal(bits(roots[0]), bits(ref["root_array"]))
    # every rank's value came from exactly the process that drives it
    assert seen == set(want), (seen, set(want))


@pytest.mark.parametrize("name", list(w.CASES))
@pytest.mark.parametrize("g", list(w.GRIDS))
def test_multiprocess_bitwise_single_controller(worlds, single, g, name):
    compare(load(worlds, g, name), single(name, g))


@pytest.mark.parametrize("name", list(w.A2A_CASES))
@pytest.mark.parametrize("g", list(w.A2A_GRIDS))
def test_multiprocess_all_to_all_bitwise_single_controller(a2a_worlds, single, g, name):
    """The pairwise all-to-all (each process receives its chunk from each
    peer only) gives the single controller's bits, alone and in the chase
    back-transform, whose two all-to-alls run along the row axis."""
    compare(load(a2a_worlds, g, name), single(name, g))


@pytest.mark.parametrize("g", list(w.A2A_GRIDS))
def test_multiprocess_all_to_all_receives_peer_chunks_only(a2a_worlds, g):
    """Every ``cc.all_to_all`` call (the verb's and the chase
    back-transform's two) crosses processes through one pairwise
    exchange: each process receives (P-1)/P of its value's bytes, its
    chunk from each peer, and no all-gather of the whole line."""
    dirs, errors = a2a_worlds
    if g in errors:
        raise errors[g]
    P, Q = w.A2A_GRIDS[g][:2]
    for i in range(P * Q):
        calls = torch.load(os.path.join(dirs[g], f"traffic.r{i}.pt"))
        assert len(calls) == 3
        for call in calls:
            size, value = call["size"], call["value"]
            assert [k for k, _ in call["moves"]] == ["exchange"]
            assert call["moves"][0][1] * size == value * (size - 1)


@pytest.mark.parametrize("name", list(w.CASES))
@pytest.mark.parametrize("g", list(w.GRIDS))
def test_multiprocess_verb_schedules_agree(worlds, g, name):
    """graph-conditional-collective on the spawned world: every member of
    a group (a grid column for row-axis verbs, a grid row for col-axis
    verbs, the world for the rest) issued that group's verbs in one order,
    with one kind, arguments and message shapes (``analysis.graphcheck.
    schedule_findings`` over the schedules the processes saved)."""
    from dlaf_tpu_torch.analysis.graphcheck import schedule_findings

    P, Q = w.GRIDS[g][:2]
    res = load(worlds, g, name)
    schedules = {tuple(r["grid_rank"]): r["schedule"] for r in res}
    assert len(schedules) == P * Q
    assert schedule_findings(schedules, (P, Q), name=name) == []


@pytest.mark.parametrize("g", list(w.GRIDS))
def test_multiprocess_verb_schedules_are_recorded(worlds, g):
    """The schedules the agreement test reads are not empty: every
    Cholesky case's processes issued verbs, on every axis group."""
    chol = [name for name, spec in w.CASES.items() if spec["kind"] == "cholesky"]
    assert chol
    for name in chol:
        for r in load(worlds, g, name):
            groups = {e[2] for e in r["schedule"]}
            assert r["schedule"] and len(groups) >= 2, (name, groups)


@pytest.mark.parametrize("g", list(w.GRIDS))
def test_processes_import_only_the_port(worlds, g):
    for r in load(worlds, g, "modules"):
        assert r["modules"] == []
        assert "multihost_grid" in r["single_controller_refused"]


def test_multiprocess_factor_matches_reference(worlds, monkeypatch, devices8):
    """The 2x2 processes' float64 factor (uplo L, default routes) against
    the reference's distributed builder at 60 n eps of the largest entry."""
    P, Q, src, n, nb = w.GRIDS["2x2"]
    for knob in w.KNOBS:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    jcfg.initialize()
    a = w.hpd(n, np.float64)
    jchol._dist_cholesky_cached.cache_clear()
    jm = JMatrix.from_global(a, JTileElementSize(nb, nb), JGrid(P, Q, devices=devices8[:P * Q]),
                             source_rank=JRankIndex2D(*src))
    ref = np.tril(np.asarray(jchol.cholesky("L", jm).to_numpy()))
    # the processes' shards, joined by the port's single-controller layout
    base = w.run_case("chol-d-L", shared_grid(P, Q, "cpu"), monkeypatch.setenv,
                      lambda k: monkeypatch.delenv(k, raising=False))["mat"]
    got = np.tril(joined(worlds, "2x2", "chol-d-L", base))
    err = np.abs(got - ref).max() / np.abs(a).max()
    assert err <= 60 * n * np.finfo(np.float64).eps, err
    config.initialize()


@pytest.mark.parametrize("uplo,dtype", [("L", np.float64), ("U", np.complex128)])
def test_multiprocess_gen_to_std_matches_reference(worlds, monkeypatch, devices8, uplo, dtype):
    """The 2x2 processes' HEGST (blocked) against the reference's
    distributed builder at ``100 n eps`` of the largest entry of A (the
    reference's c = 100), B factored by each side's own Cholesky."""
    P, Q, src, n, nb = w.GRIDS["2x2"]
    name = f"g2s-blocked-{'d' if dtype == np.float64 else 'z'}-{uplo}"
    for knob in w.KNOBS:
        monkeypatch.delenv("DLAF_" + knob, raising=False)
    jcfg.initialize()
    jgrid = JGrid(P, Q, devices=devices8[:P * Q])
    tile, jsrc = JTileElementSize(nb, nb), JRankIndex2D(*src)
    a = w.stored(w.herm(n, dtype), uplo)
    jb = jchol.cholesky(uplo, JMatrix.from_global(w.hpd(n, dtype, seed=11), tile, grid=jgrid,
                                                  source_rank=jsrc))
    ja = JMatrix.from_global(a, tile, grid=jgrid, source_rank=jsrc)
    ref = np.asarray(jg2s.gen_to_std(uplo, ja, jb).to_numpy())
    base = w.run_case(name, shared_grid(P, Q, "cpu"), monkeypatch.setenv,
                      lambda k: monkeypatch.delenv(k, raising=False))["mat"]
    got = joined(worlds, "2x2", name, base)
    keep = np.tril if uplo == "L" else np.triu
    err = np.abs(keep(got) - keep(ref)).max() / np.abs(a).max()
    assert err <= 100 * n * np.finfo(np.float64).eps, err
    config.initialize()


def joined(worlds, g, name, base):
    """The processes' shards of case ``name`` as one global array, joined
    by the single controller's layout ``base`` (a Matrix of that case)."""
    P, Q = w.GRIDS[g][:2]
    shards = [None] * (P * Q)
    for r in load(worlds, g, name):
        for k, v in r["ok"]["shards"].items():
            shards[int(k)] = v
    return Matrix(base.dist, shards, base.grid).to_numpy()


def test_a_hanging_process_fails_the_harness(tmp_path):
    """Rank 0 waits in a broadcast that rank 1 never joins: the harness
    kills both at its timeout and raises."""
    procs = spawn(1, 2, str(tmp_path), mode="hang")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        join(procs, 12.0)
    assert time.monotonic() - t0 < 30
    assert all(p.poll() is not None for p in procs)


def test_no_world_is_installed_here():
    """The test process itself stays a single controller."""
    assert cc.world() is None
