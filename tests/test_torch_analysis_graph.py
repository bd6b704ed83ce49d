"""The port's graph auditor (``dlaf_tpu_torch/analysis/depgraph.py``,
``graphcheck.py``): the eager op tape, the audited matrix and the
structural pins, on the CPU.

The tape on small functions: two tile views of one shard make no edge and
a strided panel view makes edges to the tiles it covers only; an in-place
write is a producer; a kernel node stands in for its plain version's ops;
a CPU ``.cpu()``/``.numpy()``/``.tolist()``/``.item()`` is a host sync;
``step_scope_of``/``step_edges`` read ``obs.named_span`` scopes (innermost
wins); an armed tape leaves ``obs.enabled()`` false and starts no profiler.

The matrix (``graphcheck.program_specs``, the reference's names, recorded
once for the module): every spec records, every grid spec issues verbs and
every stepped spec has step groups, the audit equals the committed
baseline, the hbm budget is per rank and configurable.

The pins, the counterparts of the reference's jaxpr pins
(``tests/test_comm_overlap.py``) on the port's builders: with look-ahead
the next step's panel ``all_gather`` is issued before this step's bulk and
does not depend on it, for every step of the Cholesky (unrolled and scan),
HEGST, reduction to band and the reflector back-transform (unrolled and
scan) and the distributed solve's scan form; the serialized forms keep the
dependency (or, where the chain reads only constant storage, the order),
so a stale pin cannot pass. The multi-process schedule check rides on
``tests/test_torch_multiprocess.py``'s spawned worlds; here its dry-
transport drill and its comparison on hand-made schedules.
"""

import os

import numpy as np
import pytest
import torch

from dlaf_tpu_torch import obs
from dlaf_tpu_torch.analysis import BASELINE_PATH, depgraph as dg, drills, findings, graphcheck
from dlaf_tpu_torch.comm import collectives as cc
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import TileElementSize
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.tile_ops import panel_kernels as pk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Specs whose builders name per-step scopes.
STEPPED = ("cholesky.dist", "solve.dist", "mult.dist", "hegst.dist", "red2band.dist",
           "bt_r2b.dist")


@pytest.fixture(scope="module")
def matrix():
    """Every spec recorded once: (tapes by name, findings)."""
    tapes = {}
    found = graphcheck.run(tapes=tapes)
    return tapes, found


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the tape on small functions
# ---------------------------------------------------------------------------

def test_tile_views_make_no_edge_and_a_panel_covers_its_tiles():
    shard = torch.zeros((3, 3, 4, 4), dtype=torch.float64)

    def fn(s):
        s[0, 1].add_(1.0)            # A: tile (0, 1)
        s[1, 1].add_(2.0)            # B: tile (1, 1)
        s[2, 0].add_(3.0)            # C: tile (2, 0)
        panel = s[0:2, 1].sum()      # D: the strided panel of column 1, rows 0-1
        other = s[2, 2].clone()      # E: a tile nothing wrote since the zeros
        return panel, other

    tape = dg.trace(fn, shard)
    ops = [n for n in dg.iter_ops(tape) if n.kind == "op"]
    a, b, c, d, e = ops[-5:]
    assert (a.name, b.name, c.name) == ("aten::add_",) * 3
    assert set(d.producers) == {a.index, b.index}
    assert not set(e.producers) & {a.index, b.index, c.index}
    assert not dg.depends_on(tape, e, lambda n: n.index in (a.index, b.index, c.index))
    assert dg.depends_on(tape, d, "aten::add_")


def test_an_in_place_write_is_a_producer():
    def fn(x):
        y = x * 2.0
        y.mul_(3.0)
        return y + 1.0

    tape = dg.trace(fn, torch.ones(4, dtype=torch.float64))
    mul, mul_, add = [n for n in dg.iter_ops(tape) if n.kind == "op"]
    assert mul_.inplace and not mul.inplace
    assert add.producers == (mul_.index,)
    assert mul_.producers == (mul.index,)
    assert [n.name for n in dg.closure(tape, add)] == ["aten::mul", "aten::mul_"]


def test_a_kernel_node_stands_in_for_its_plain_version():
    x = torch.randn(8, 8, dtype=torch.float32)
    a = x @ x.T + 8 * torch.eye(8)
    tape = dg.trace(lambda t: pk.potrf("L", t) + 1.0, a)
    top = list(dg.iter_ops(tape))
    kern = [n for n in top if n.kind == "kernel"]
    assert [n.name for n in kern] == ["kernel:potrf"]
    assert dg.kernels(tape) == {"potrf": 1}
    nested = [n for n in tape.nodes if n.parent == kern[0].index]
    assert nested and all(n not in top for n in nested)
    add = [n for n in top if n.name == "aten::add"][-1]
    assert add.producers == (kern[0].index,)


@pytest.mark.parametrize("read", ["cpu", "numpy", "tolist", "item", "bool", "float"])
def test_cpu_host_reads_are_host_syncs(read):
    def fn(x):
        y = x * 2.0
        if read == "bool":
            bool(y[0] > 0)
        elif read == "float":
            float(y[0])
        elif read == "item":
            y[0].item()
        else:
            getattr(y, read)()
        return y

    tape = dg.trace(fn, torch.ones(3, dtype=torch.float64))
    syncs = dg.host_syncs(tape)
    assert len(syncs) == 1 and syncs[0].kind in ("host", "op"), [n.name for n in syncs]
    assert syncs[0].site.endswith(".py:" + syncs[0].site.rsplit(":", 1)[1])
    assert dg.contains_op(tape, syncs[0].name)


def test_no_host_sync_in_device_work():
    tape = dg.trace(lambda x: (x @ x).tril(), torch.ones(4, 4))
    assert dg.host_syncs(tape) == []


def test_step_scopes_read_named_spans_innermost_first():
    def fn(x):
        with obs.named_span("algo.step%03d", 0):
            with obs.named_span("algo.step%03d.panel", 0):
                p = x * 2.0
            with obs.named_span("algo.step%03d.panel", 1):    # hoisted
                q = x + 1.0
            with obs.named_span("algo.step%03d.bulk", 0):
                b = p @ p
        with obs.named_span("algo.step%03d.bulk", 1):
            c = q @ b
        return c

    tape = dg.trace(fn, torch.ones(3, 3))
    keys = {n.name: dg.step_scope_of(n) for n in dg.iter_ops(tape) if n.kind == "op"}
    assert keys["aten::mul"] == ("algo", 0, "panel")
    assert keys["aten::add"] == ("algo", 1, "panel")
    groups = dg.step_groups(tape)
    assert set(groups) == {("algo", 0, "panel"), ("algo", 1, "panel"), ("algo", 0, "bulk"),
                           ("algo", 1, "bulk")}
    edges = dg.step_edges(tape)
    assert (("algo", 0, "panel"), ("algo", 0, "bulk")) in edges
    assert (("algo", 0, "bulk"), ("algo", 1, "bulk")) in edges
    assert not any(dst == ("algo", 1, "panel") for _, dst in edges)
    st = dg.step_structure(tape)
    assert st["algos"] == {"algo": {"steps": 2, "scan": False}}
    assert "algo.step001.panel" in st["groups"]
    assert all(dg.is_bulk(n) for n in groups[("algo", 1, "bulk")])


def test_a_scan_scope_has_no_index():
    def fn(x):
        # wrapped while the tape is armed (outside, scoped_step is fn)
        step = obs.scoped_step("algo.scanstep", lambda y: y * 2.0)
        return step(step(x))

    tape = dg.trace(fn, torch.ones(2))
    ops = [n for n in dg.iter_ops(tape) if n.kind == "op"]
    assert [dg.step_scope_of(n) for n in ops] == [("algo", -1, "other")] * 2
    assert ops[0].step_id != ops[1].step_id


def test_an_armed_tape_is_not_the_profiler():
    assert obs.STATE.tape is None

    def fn(x):
        assert obs.STATE.tape is not None
        assert not obs.enabled()
        with obs.named_span("algo.step%03d.panel", 0):
            assert not obs.STATE.profiler_started
            return x + 1.0

    dg.trace(fn, torch.ones(2))
    assert obs.STATE.tape is None and not obs.STATE.profiler_started
    # with no tape and no profiler the sites are the no-op singletons
    assert obs.named_span("algo.step%03d", 0) is obs.NOOP_CTX


def test_a_verb_is_one_collective_node_with_per_rank_shapes():
    xs = cc.per_rank(2, 2, lambda r, c: torch.full((3,), float(r * 2 + c)))
    tape = dg.trace(lambda v: cc.all_reduce(v, "row", "max"), xs)
    [node] = dg.collectives(tape)
    assert (node.name, node.axis, node.shapes) == ("all_reduce", "row", ((3,),) * 4)
    assert node.parent is None and all(n.parent == node.index for n in tape.nodes
                                       if n is not node)
    assert tape.schedule == [("all_reduce", "row", "all", ("max",), ((3,),) * 4,
                              ("float32",) * 4)]


def test_precision_demotion_needs_a_wide_non_scalar():
    tape = dg.trace(lambda x: (x.to(torch.float32), x[0].to(torch.float32)),
                    torch.ones(4, dtype=torch.float64))
    assert [n.demotion for n in tape.nodes if n.demotion] == ["float64->float32"]


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------

def test_every_spec_records(matrix):
    tapes, found = matrix
    names = [s.name for s in graphcheck.program_specs()]
    # the reference's 57, and the chip script's two cells through the entry
    assert len(names) == len(set(names)) == 59
    assert [n for n in names if n.startswith("cholesky.entry.")] == [
        "cholesky.entry.main-L", "cholesky.entry.dist-L"]
    assert sorted(tapes) == sorted(names)
    assert not [f for f in found if f.rule == "graph-trace-error"]


def test_the_matrix_is_not_vacuous(matrix):
    tapes, _ = matrix
    for name, tape in tapes.items():
        assert list(dg.iter_ops(tape)), name
        if ".dist" in name:
            assert dg.collectives(tape), name
        if name.startswith(STEPPED):
            assert dg.step_groups(tape), name
        if ".fpanel." in name or ".fstep." in name:
            assert dg.kernels(tape), name


def test_the_audit_equals_the_committed_baseline(matrix):
    _, found = matrix
    base = [k for k in findings.load_baseline(os.path.join(REPO, BASELINE_PATH))
            if k.startswith("graph-")]
    new, stale = findings.diff_baseline(found, base)
    assert new == [] and stale == []


def test_the_hbm_budget_is_per_rank_and_configurable(matrix):
    tapes, _ = matrix
    tape = tapes["cholesky.dist.L.la1.comm1"]
    shard = (3, 3, 4, 4)            # n=24, nb=4 on 2x2: one rank's (ltr, ltc, mb, nb)
    assert tape.rank_bytes == np.prod(shard) * 8
    assert not [f for f in graphcheck.audit_tape("x", tape) if f.rule == "graph-hbm-blowup"]
    tight = graphcheck.audit_tape("x", tape, hbm_factor=0.5)
    assert [f for f in tight if f.rule == "graph-hbm-blowup"]
    # the local program's budget is its whole input
    assert tapes["cholesky.local.loop.L.la0"].rank_bytes == 24 * 24 * 8


def test_a_dead_output_key_counts_it_per_step():
    """A grandfathered dead output does not hide a new one in another
    step: the key carries how many each step holds, steps named from the
    nearer end."""
    def fn(x, dead_steps):
        for k in range(6):
            with obs.named_span("algo.step%03d.panel", k):
                x.add_(1.0)
                if k in dead_steps:
                    _ = x * 2.0
        return x

    def keys(dead_steps):
        tape = dg.trace(lambda x: fn(x, dead_steps), torch.ones(3, 3))
        return [f.key for f in graphcheck.audit_tape("s", tape)]

    assert keys({4}) == ["graph-dead-output|s|aten::mul|algo.step.panel|0 a step (last-1:1)"]
    assert keys({0, 4}) == [
        "graph-dead-output|s|aten::mul|algo.step.panel|0 a step (step0:1, last-1:1)"]
    assert keys(set(range(6))) == ["graph-dead-output|s|aten::mul|algo.step.panel|1 a step"]
    assert keys(set()) == []


def test_the_entry_cells_dead_output_keys_hold_at_any_order():
    """The chip script audits ``cholesky.entry.*`` at full width under the
    gate's baseline, taken at n=24: the same program at another order
    gives the same keys."""
    def audit(n):
        with graphcheck.pinned_native_config():
            specs = {s.name: s for s in graphcheck.program_specs(n=n)}
            out = {}
            for name in ("cholesky.entry.main-L", "cholesky.entry.dist-L"):
                fn, args = specs[name].build()
                out[name] = sorted(f.key for f in graphcheck.audit_tape(name,
                                                                        dg.trace(fn, *args)))
            return out

    small, large = audit(24), audit(64)
    assert small == large
    assert any("kernel:factor_solve" in k for k in small["cholesky.entry.dist-L"])


def test_the_baseline_workflow(matrix, tmp_path):
    _, found = matrix
    path = str(tmp_path / "b.json")
    findings.write_baseline(path, found)
    new, stale = findings.diff_baseline(found, findings.load_baseline(path))
    assert new == [] and stale == []
    keys = findings.load_baseline(path)
    new, _ = findings.diff_baseline(found, keys[1:])
    assert [f.key for f in new] and all(f.key == keys[0] for f in new)


# ---------------------------------------------------------------------------
# structural pins on the port's builders
# ---------------------------------------------------------------------------

def _ag(tape, algo, step):
    return [n for n in dg.collectives(tape) if n.name == "all_gather" and n.parent is None
            and (dg.step_scope_of(n) or ("", None))[:2] == (algo, step)]


def _bulk_of(algo, step):
    return lambda n: dg.is_bulk(n) and dg.step_scope_of(n)[:2] == (algo, step)


def _steps(tape, algo):
    return 1 + max(k[1] for k in dg.step_groups(tape) if k[0] == algo)


def _hoisted_every_step(tape, algo, order=range):
    """For every step k with a next step: the next step's first panel
    all_gather is issued before step k's first bulk node and does not
    depend on any node of step k's bulk; returns the steps checked."""
    nt = _steps(tape, algo)
    checked = 0
    for k in order(nt):
        nxt = k + 1 if order is range else k - 1
        ag = _ag(tape, algo, nxt)
        bulk = [n for n in dg.iter_ops(tape) if _bulk_of(algo, k)(n)]
        if not ag or not bulk:
            continue
        assert ag[0].index < bulk[0].index, (k, ag[0].index, bulk[0].index)
        assert not dg.depends_on(tape, ag[0], _bulk_of(algo, k)), k
        checked += 1
    return checked


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_dist_cholesky_lookahead_pin(matrix, uplo):
    tapes, _ = matrix
    assert _hoisted_every_step(tapes[f"cholesky.dist.{uplo}.la1.comm1"], "cholesky") == 4
    serial = tapes[f"cholesky.dist.{uplo}.la0.comm0"]
    assert dg.depends_on(serial, _ag(serial, "cholesky", 1)[0], _bulk_of("cholesky", 0)), \
        "the serialized form lost its bulk dependency: the pin is stale"


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_dist_hegst_lookahead_pin(matrix, uplo):
    tapes, _ = matrix
    assert _hoisted_every_step(tapes[f"hegst.dist.{uplo}.la1.comm1"], "hegst") == 4
    serial = tapes[f"hegst.dist.{uplo}.la0.comm0"]
    assert dg.depends_on(serial, _ag(serial, "hegst", 1)[0], _bulk_of("hegst", 0))


def test_dist_red2band_lookahead_pin(matrix):
    tapes, _ = matrix
    assert _hoisted_every_step(tapes["red2band.dist.comm1"], "red2band") == 4
    serial = tapes["red2band.dist.comm0"]
    assert dg.depends_on(serial, _ag(serial, "red2band", 1)[0], _bulk_of("red2band", 0))


def test_dist_bt_r2b_lookahead_pin(matrix):
    """The sweep runs backwards (panel p, then p-1). The chain reads only
    the constant V and taus, so it is bulk-independent either way: the
    serialized pin is the order (gather p-1 after bulk p)."""
    tapes, _ = matrix

    def backwards(nt):
        return range(nt - 1, 0, -1)

    assert _hoisted_every_step(tapes["bt_r2b.dist.la1"], "bt_r2b", order=backwards) == 4
    serial = tapes["bt_r2b.dist.la0"]
    nt = _steps(serial, "bt_r2b")
    for p in range(nt - 1, 0, -1):
        ag = _ag(serial, "bt_r2b", p - 1)[0]
        bulk = [n for n in dg.iter_ops(serial) if _bulk_of("bt_r2b", p)(n)]
        assert ag.index > bulk[0].index, "bt_lookahead=0 no longer serial: the pin is stale"
        assert not dg.depends_on(serial, ag, _bulk_of("bt_r2b", p))


def _scan_bodies(tape):
    """The nodes of each scan step, in order (one ``scanstep`` entry
    each)."""
    out = {}
    for n in dg.iter_ops(tape):
        key = dg.step_scope_of(n)
        if key is not None and key[1] == -1:
            out.setdefault(n.step_id, []).append(n)
    return [v for _, v in sorted(out.items())]


def _scan_bulk(n):
    """A scan step's bulk: the in-place update of the (4-D) trailing
    window of a rank's shard."""
    return n.kind in ("op", "kernel") and n.inplace and any(len(s) == 4 for s in n.shapes)


def _mat(a, grid, nb=4):
    return Matrix.from_global(a, TileElementSize(nb, nb), grid, device="cpu")


def _lts(m):
    return cc.per_rank(2, 2, lambda r, c: m.storage[r * 2 + c])


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_dist_cholesky_scan_pin(matrix, uplo):
    """With look-ahead a scan step's (deferred) bulk consumes none of its
    own step's all_gathers, issued ahead of it; the serial body's bulk
    consumes its own transposed panel."""
    from dlaf_tpu_torch.algorithms.cholesky import _cholesky_dist_scan

    tapes, _ = matrix
    bodies = _scan_bodies(tapes[f"cholesky.dist_scan.{uplo}.la1"])
    assert len(bodies) == 6
    for body in bodies:
        ags = [n for n in body if n.name == "all_gather"]
        bulk = [n for n in body if _scan_bulk(n)]
        assert ags and bulk and ags[0].index < bulk[0].index
        assert not set(dg.closure(tapes[f"cholesky.dist_scan.{uplo}.la1"], bulk[0])) & set(ags)
    x = np.random.default_rng(0).standard_normal((24, 24))
    m = _mat(x @ x.T / 24 + 2 * np.eye(24), shared_grid(2, 2, "cpu"))
    with graphcheck.pinned_native_config():
        serial = dg.trace(lambda lts: _cholesky_dist_scan(lts, m.dist, uplo=uplo,
                                                          lookahead=False), _lts(m))
    body = _scan_bodies(serial)[0]
    bulk = [n for n in body if _scan_bulk(n)][0]
    assert set(dg.closure(serial, bulk)) & {n for n in body if n.name == "all_gather"}, \
        "the serial scan body lost its panel->bulk chain: the pin is stale"


@pytest.mark.parametrize("side,uplo,op", [("L", "L", "C"), ("R", "U", "C")])
def test_dist_solve_scan_pin(side, uplo, op):
    """The pipelined solve issues each step's A-panel exchange ahead of
    the deferred bulk, which consumes the previous step's panel and not
    this one; the exchange reads only A and depends on no bulk; serially
    (no look-ahead) the bulk consumes its own step's exchange."""
    from dlaf_tpu_torch.algorithms.triangular import _dist_solve

    rng = np.random.default_rng(1)
    grid = shared_grid(2, 2, "cpu")
    tapes = {}
    for la in (True, False):
        a = _mat(np.tril(rng.standard_normal((24, 24))) / 24 + 2 * np.eye(24), grid)
        b = _mat(rng.standard_normal((24, 24)), grid)
        with graphcheck.pinned_native_config():
            tapes[la] = dg.trace(
                lambda x, y: _dist_solve(x, y, a.dist, b.dist, side=side, uplo=uplo, op=op,
                                         diag="N", panel_fused=False, scan=True, lookahead=la),
                _lts(a), _lts(b))
    for la, tape in tapes.items():
        bodies = _scan_bodies(tape)
        assert len(bodies) == 6
        for i, body in enumerate(bodies):
            ags = [n for n in body if n.name == "all_gather"]
            bulk = [n for n in body if _scan_bulk(n)]
            if not ags or not bulk:
                continue
            assert ags[0].index < bulk[0].index
            assert not dg.depends_on(tape, ags[0], _scan_bulk)
            own = set(dg.closure(tape, bulk[0])) & set(ags)
            if la:
                assert not own, i
            elif i == 0:
                assert own, "the serial solve lost its exchange->bulk chain: the pin is stale"


def test_dist_bt_r2b_scan_pin(matrix):
    tapes, _ = matrix
    tape = tapes["bt_r2b.dist_scan.la1"]
    bodies = _scan_bodies(tape)
    assert bodies
    for body in bodies:
        ags = [n for n in body if n.name == "all_gather"]
        bulk = [n for n in body if _scan_bulk(n)]
        assert ags and bulk and ags[0].index < bulk[0].index
        assert not dg.depends_on(tape, ags[0], _scan_bulk)


# ---------------------------------------------------------------------------
# the multi-process schedule check
# ---------------------------------------------------------------------------

def test_the_dry_transport_drill_trips():
    found, rules = drills.run("rank_varying_collective")
    assert {f.rule for f in found} == set(rules) == {"graph-conditional-collective"}
    assert sorted(f.key for f in found) == [
        "graph-conditional-collective|drill.rank_varying_collective|col0|bcast",
        "graph-conditional-collective|drill.rank_varying_collective|col1|bcast"]


def test_equal_schedules_make_no_finding():
    entry = ("bcast", "row", "col0", (0,), ((4, 4),), ("float32",))
    same = {(0, 0): [entry], (1, 0): [entry]}
    assert graphcheck.schedule_findings(same, (2, 1)) == []
    shape = ("bcast", "row", "col0", (0,), ((4, 5),), ("float32",))
    differ = {(0, 0): [entry], (1, 0): [shape]}
    assert [f.rule for f in graphcheck.schedule_findings(differ, (2, 1))] == \
        ["graph-conditional-collective"]
    # a ragged verb's values may differ between members
    g1 = ("gather", None, "world", (0, 0), ((3, 4),), ("float32",))
    g2 = ("gather", None, "world", (0, 0), ((1, 4),), ("float32",))
    assert graphcheck.schedule_findings({(0, 0): [g1], (1, 0): [g2]}, (2, 1)) == []
