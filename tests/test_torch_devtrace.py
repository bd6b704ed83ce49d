"""Device-timeline attribution of the port (``dlaf_tpu_torch/obs/devtrace.py``)
against the JAX reference's (``dlaf_tpu/obs/devtrace.py``).

* ``classify_op`` gives the reference's ``(category, kind)`` on its own
  cases, and the card's categories on Kineto names.
* The reference's committed fixture (``tests/fixtures/devtrace/``, an
  XLA:CPU trace and its merged artifact) goes through both packages'
  ``attribute``: equal reports (every number within 1e-12 relative),
  ``records_from_report`` equal but ``ts``.
* The port's own join on synthetic Kineto traces built from a seed
  (``tests/torch_kineto_synth.py``): by launch, innermost range first,
  ``gpu_user_annotation`` and runtime events never ops, ``comm.<verb>``
  ranges make collectives of the verb's kind, one device one overlap
  domain, the ``ac2g`` flow where a kernel carries no correlation.
* The records under both validators, and the reject cases in both.
* The card's fixture (``tests/fixtures/torch_devtrace/``: a distilled
  dist-L trace of the H100, N=2048, nb=256, f32, 2x2 on one card, and
  its merged artifact): it replays, the hand kernels at their launch
  counts, the CLIs and ``validate --require-devtrace --require-critpath``.
* On the CPU end to end: a dist-L call under ``trace_dir`` has the step
  and ``comm.<verb>`` ranges, and the CLI exits 1 on it (no device op).
"""

import contextlib
import copy
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from dlaf_tpu.obs import devtrace as jdev
from dlaf_tpu.obs.aggregate import merge_artifacts as jmerge
from dlaf_tpu.obs.sinks import validate_records as jvalidate
from dlaf_tpu_torch.obs import devtrace as pdev
from dlaf_tpu_torch.obs import validate as pvalidate_cli
from dlaf_tpu_torch.obs.aggregate import merge_artifacts as pmerge
from dlaf_tpu_torch.obs.sinks import DEVTRACE_COVERAGE_FLOOR
from dlaf_tpu_torch.obs.sinks import validate_records as pvalidate
from torch_kineto_synth import Trace, span

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REF_FIXTURE = os.path.join(HERE, "fixtures", "devtrace")
CARD_FIXTURE = os.path.join(HERE, "fixtures", "torch_devtrace")
CARD_TRACE = os.path.join(CARD_FIXTURE, "trace.json.gz")
CARD_JSONL = os.path.join(CARD_FIXTURE, "merged.jsonl")

#: The card fixture's dist-L call: N=2048, nb=256 (nt = 8), 2x2 on one
#: card; each hand kernel's launches from its wrappers' counts
#: (factor_solve and the update 4 (nt - 1), potrf 4).
CARD_NT = 8
CARD_KERNELS = {"potrf_kernel": 4 * CARD_NT, "trinv_kernel": 4 * (CARD_NT - 1),
                "strip_kernel": 4 * (CARD_NT - 1), "plan_kernel": 4 * (CARD_NT - 1),
                "masked_update_kernel": 4 * (CARD_NT - 1)}


def _close(a, b, path="report"):
    """``a`` equals ``b``: the same keys and strings, numbers within 1e-12
    relative."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), f"{path}: keys {set(a) ^ set(b)}"
        for k in a:
            _close(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), f"{path}: {a} != {b}"
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


# ---------------------------------------------------------------------------
# op classification
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "dot.24", "bitcast_dot_fusion.1", "convolution.2", "all-reduce.11", "all-gather.5",
    "reduce-scatter", "collective-permute.3", "gather.7", "copy_dynamic-update-slice_fusion",
    "transpose.1", "custom-call.2", "add.174", "while.1", "partition-id",
    "ThunkExecutor::Execute", "TfrtCpuExecutable::ExecuteHelper",
    "ThunkExecutor::Execute (wait for completion)", ""])
def test_classify_op_is_the_references(name):
    assert pdev.classify_op(name) == jdev.classify_op(name)


@pytest.mark.parametrize("name,cat,want", [
    ("void potrf_kernel<float>(float const*, int, float*, int, float*, int)", "kernel", "mxu"),
    ("void trinv_kernel<float>(float const*, int, int, float*, int)", "kernel", "mxu"),
    ("void strip_kernel<float, 8>(CUtensorMap_st, CUtensorMap_st, StripParams)", "kernel",
     "mxu"),
    ("void masked_update_kernel<float, 1, 1>(Params<float>)", "kernel", "mxu"),
    ("slice_fold_kernel(CUtensorMap_st, CUtensorMap_st, FoldParams)", "kernel", "mxu"),
    ("nvjet_tst_128x64_64x8_1x2_h_bz_TNT", "kernel", "mxu"),
    ("sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize64x64x16", "kernel", "mxu"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_d884gemm_64x64_16x4_nn_align1>(Params)",
     "kernel", "mxu"),
    ("void trsm_left_kernel<double, 256, 4, false>(cublasTrsmParams<double>)", "kernel",
     "mxu"),
    ("void at::native::elementwise_kernel<128, 2, at::native::direct_copy_kernel_cuda>()",
     "kernel", "copy"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, 4>(float*)",
     "kernel", "copy"),
    ("void at::native::index_elementwise_kernel<128, 4>(long, at::native::gpu_index)",
     "kernel", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>()",
     "kernel", "compute"),
    ("void plan_kernel(int const*, int, int, int*)", "kernel", "compute"),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", "copy"),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", "host_callback"),
    ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", "host_callback"),
    ("Memset (Device)", "gpu_memset", "copy"),
])
def test_classify_kineto_ops(name, cat, want):
    assert pdev.classify_op(name, cat) == (want, None)


@pytest.mark.parametrize("name,kind", [
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "all-reduce"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "all-gather"),
    ("ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "collective-broadcast"),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", "collective-permute"),
    ("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "reduce-scatter"),
])
def test_classify_nccl_kernels_by_name(name, kind):
    assert pdev.classify_op(name, "kernel") == ("collective", kind)


def test_short_names():
    assert pdev.short_name("void potrf_kernel<float>(float const*, int)") == "potrf_kernel"
    assert pdev.short_name("void at::native::(anonymous namespace)::CatArrayBatchedCopy<"
                           "float, unsigned int, 4, 64, 64>(float*)") == \
        "at::native::CatArrayBatchedCopy"
    assert pdev.short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"


# ---------------------------------------------------------------------------
# the reference's fixture through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_fixture():
    return (jdev.load_trace(os.path.join(REF_FIXTURE, "trace.json.gz")),
            jmerge([os.path.join(REF_FIXTURE, "merged.jsonl")]))


def test_reference_fixture_report_equal(ref_fixture):
    events, records = ref_fixture
    want = jdev.attribute(events, records)
    got = pdev.attribute(events, pmerge([os.path.join(REF_FIXTURE, "merged.jsonl")]))
    _close(got, want)
    assert got["join"] == "annotation"
    assert round(got["coverage"], 4) == 0.7601


def test_reference_fixture_records_equal_but_ts(ref_fixture):
    events, records = ref_fixture
    trace = os.path.join(REF_FIXTURE, "trace.json.gz")
    want = jdev.records_from_report(jdev.attribute(events, records), trace)
    got = pdev.records_from_report(pdev.attribute(events, records), trace)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close({k: v for k, v in g.items() if k != "ts"}, {k: v for k, v in w.items() if k != "ts"})
    assert not jvalidate(got, require_devtrace=True)
    assert not pvalidate(got, require_devtrace=True)


def test_reference_fixture_distill_replays(ref_fixture):
    events, records = ref_fixture
    assert pdev.attribute(pdev.distill(events, records), records) == \
        pdev.attribute(events, records)


# ---------------------------------------------------------------------------
# the port's join on synthetic Kineto traces
# ---------------------------------------------------------------------------

def test_kernel_after_its_range_closed_is_attributed_by_launch():
    """The host runs ahead: the panel's kernel executes inside the bulk
    range's time (the reference's midpoint join would give it there) but
    was launched in the panel range."""
    t = Trace(1)
    t.range("cholesky", 0.0, 2000.0)
    t.range("cholesky.step000.panel", 0.0, 100.0)
    t.range("cholesky.step000.bulk", 100.0, 1900.0)
    t.launch(50.0, "void potrf_kernel<float>(float const*)", 1200.0, 100.0)
    t.launch(150.0, "void masked_update_kernel<float, 1, 1>(Params<float>)", 1300.0, 300.0)
    rep = pdev.attribute(t.shuffled(), [span("cholesky", flops=6e6)])
    assert rep["join"] == "annotation" and rep["coverage"] == 1.0
    assert rep["phases"]["cholesky.step000.panel"]["busy_s"] == pytest.approx(100e-6)
    assert rep["phases"]["cholesky.step000.bulk"]["busy_s"] == pytest.approx(300e-6)
    assert "cholesky" not in rep["phases"]
    assert rep["kernels"]["potrf_kernel"] == {"launches": 1, "busy_s": pytest.approx(100e-6),
                                              "category": "mxu"}


def test_innermost_range_wins_for_steps_and_lookahead_panels():
    t = Trace(2)
    t.range("cholesky", 0.0, 1000.0)
    t.range("cholesky.step000", 0.0, 900.0)
    t.range("cholesky.step000.strip", 0.0, 200.0)
    t.range("cholesky.step001.panel", 200.0, 200.0)     # hoisted into step 0
    t.range("cholesky.step000.bulk", 400.0, 500.0)
    t.launch(100.0, "void trinv_kernel<float>(float const*)", 2000.0, 10.0)
    t.launch(300.0, "void potrf_kernel<float>(float const*)", 2010.0, 20.0)
    t.launch(500.0, "void masked_update_kernel<float, 1, 1>(Params<float>)", 2030.0, 40.0)
    t.launch(950.0, "void strip_kernel<float, 8>(Params)", 2070.0, 80.0)  # entry only
    rep = pdev.attribute(t.events, [span("cholesky")])
    busy = {k: round(v["busy_s"] * 1e6, 6) for k, v in rep["phases"].items()}
    assert busy == {"cholesky.step000.strip": 10.0, "cholesky.step001.panel": 20.0,
                    "cholesky.step000.bulk": 40.0, "cholesky": 80.0}


def test_annotation_mirrors_and_runtime_events_are_never_ops():
    t = Trace(3)
    t.range("cholesky.step000.panel", 0.0, 100.0)
    t.launch(10.0, "void potrf_kernel<float>(float const*)", 500.0, 30.0)
    t.launch(20.0, "Memset (Device)", 530.0, 5.0, cat="gpu_memset")
    # launches whose device ops the trace lost: one in a range, one before
    for ts, c in ((30.0, 1), (-50.0, 2)):
        t.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                         "pid": 4242, "tid": 4242, "ts": ts, "dur": 2.0,
                         "args": {"correlation": c}})
    rep = pdev.attribute(t.events, [])
    assert rep["events"] == 2 and rep["lost_launches"] == 1
    assert rep["device_busy_s"] == pytest.approx(35e-6)
    assert pdev.device_events(t.events)[0][2:4] == ("mxu", None)
    assert all(o["launch"] is not None for o in pdev.device_ops(t.events))


def test_comm_ranges_make_collectives_of_the_verbs_kind():
    """Ops launched in a ``comm.<verb>`` range are collectives of the
    verb's kind; their phase is the step range around it; an NCCL kernel
    outside every comm range is a collective by name."""
    t = Trace(4)
    t.range("cholesky.step000.panel", 0.0, 300.0)
    t.range("comm.bcast2d", 10.0, 50.0)
    t.launch(20.0, "Memcpy DtoD (Device -> Device)", 1000.0, 40.0, cat="gpu_memcpy")
    t.launch(30.0, "void at::native::vectorized_elementwise_kernel<4, "
             "at::native::CUDAFunctor_add<float>>()", 1040.0, 10.0)
    t.range("comm.all_gather", 60.0, 40.0)
    t.launch(70.0, "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>()",
             1050.0, 20.0)
    t.launch(150.0, "void potrf_kernel<float>(float const*)", 1030.0, 60.0, stream=13)
    t.launch(200.0, "ncclDevKernel_AllReduce_Sum_f32_RING_LL(Args)", 1200.0, 50.0)
    rep = pdev.attribute(t.shuffled(), [])
    assert "comm.bcast2d" not in rep["phases"] and "comm.all_gather" not in rep["phases"]
    cell = rep["phases"]["cholesky.step000.panel"]
    assert cell["categories"] == {"collective": pytest.approx(120e-6),
                                  "mxu": pytest.approx(60e-6)}
    (row,) = rep["overlap"]
    assert row["algo"] == "cholesky.step000.panel"
    assert row["kinds"] == {"collective-broadcast": pytest.approx(50e-6),
                            "all-gather": pytest.approx(20e-6),
                            "all-reduce": pytest.approx(50e-6)}
    # potrf [1030, 1090] on another stream of the same device overlaps the
    # copy [1000, 1040] by 10 us, the add by 10, the cat by 20
    assert row["overlapped_s"] == pytest.approx(40e-6)
    assert row["mxu_busy_s"] == pytest.approx(60e-6)
    # the kernel table keeps each op's own category
    assert rep["kernels"]["Memcpy DtoD"]["category"] == "copy"


def test_one_device_is_one_overlap_domain():
    t = Trace(5)
    t.range("trsm.step000.panel", 0.0, 100.0)
    t.range("comm.bcast", 0.0, 20.0)
    t.launch(5.0, "Memcpy DtoD (Device -> Device)", 100.0, 200.0, cat="gpu_memcpy", stream=7)
    t.launch(50.0, "nvjet_tst_128x64_64x8_1x2_h_bz_TNT", 200.0, 300.0, stream=21)
    t.launch(60.0, "nvjet_tst_128x64_64x8_1x2_h_bz_TNT", 100.0, 200.0, device=1, stream=7)
    rep = pdev.attribute(t.events, [])
    assert rep["domains"] == 2
    (row,) = rep["overlap"]
    # the device-0 GEMM covers half the copy; device 1's never counts
    assert row["overlap_frac"] == pytest.approx(0.5)


def test_flow_joins_a_kernel_without_correlation():
    t = Trace(6)
    t.range("hegst.step002.bulk", 0.0, 100.0)
    t.launch(10.0, "void slab_kernel<float, 8>(Params)", 900.0, 50.0, correlation=False)
    (op,) = pdev.device_ops(t.events)
    assert op["launch"][2] == 10.0
    assert set(pdev.attribute(t.events, [])["phases"]) == {"hegst.step002.bulk"}


def test_rebase_join_without_ranges():
    t = Trace(7)
    t.launch(10.0, "void potrf_kernel<float>(float const*)", 900.0, 50.0)
    rep = pdev.attribute(t.events, [span("cholesky", ts=1.0, dur_s=1.0)])
    assert rep["join"] == "rebase" and rep["coverage"] == 1.0


def test_empty_and_zero_duration_traces_raise():
    with pytest.raises(ValueError, match="no device op events"):
        pdev.attribute(Trace(8).events, [])
    t = Trace(9)
    t.launch(10.0, "void potrf_kernel<float>(float const*)", 900.0, 0.0)
    with pytest.raises(ValueError, match="no device op events"):
        pdev.attribute(t.events, [])


def test_distill_keeps_what_the_join_needs():
    t = Trace(10)
    t.range("cholesky.step000.panel", 0.0, 100.0)
    t.range("not.in.vocabulary", 0.0, 100.0)
    t.launch(10.0, "void potrf_kernel<float>(float const*)", 900.0, 50.0)
    t.launch(20.0, "void trinv_kernel<float>(float const*)", 950.0, 50.0, correlation=False)
    t.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
                     "pid": 4242, "tid": 4242, "ts": 30.0, "dur": 2.0,
                     "args": {"correlation": 2}})
    kept = pdev.distill(t.events, [])
    assert not any(e.get("cat") in ("cpu_op", "gpu_user_annotation") for e in kept)
    assert not any(e.get("name") == "cudaStreamSynchronize" for e in kept)
    assert not any(e.get("name") == "not.in.vocabulary" for e in kept)
    assert pdev.attribute(kept, []) == pdev.attribute(t.events, [])


# ---------------------------------------------------------------------------
# records under both validators
# ---------------------------------------------------------------------------

def _records(events=None, records=()):
    if events is None:
        t = Trace(11)
        t.range("cholesky", 0.0, 500.0)
        t.range("cholesky.step000.panel", 0.0, 100.0)
        t.range("comm.bcast", 10.0, 20.0)
        t.launch(15.0, "Memcpy DtoD (Device -> Device)", 600.0, 40.0, cat="gpu_memcpy")
        t.launch(50.0, "void potrf_kernel<float>(float const*)", 640.0, 60.0)
        t.launch(300.0, "void masked_update_kernel<float, 1, 1>(Params<float>)", 700.0, 90.0)
        events = t.events
        records = [span("cholesky", flops=2e9, lookahead=1)]
    return pdev.records_from_report(pdev.attribute(events, list(records)), "t.json.gz")


def test_records_pass_both_validators():
    recs = _records()
    for validate in (jvalidate, pvalidate):
        assert not validate(recs)
        assert not validate(recs, require_devtrace=True)
    assert [r["type"] for r in recs] == ["devtrace", "measured_overlap"]


@pytest.mark.parametrize("case", ["zero_collectives", "low_coverage", "nan_wall"])
def test_reject_cases_in_both_packages(case):
    recs = _records()
    require = True
    if case == "zero_collectives":
        recs = [r for r in recs if r["type"] != "measured_overlap"]
        want = "no measured_overlap"
    elif case == "low_coverage":
        recs[0]["coverage"] = DEVTRACE_COVERAGE_FLOOR - 0.01
        want = "coverage"
    else:
        recs[0]["phases"]["cholesky.step000.panel"]["wall_s"] = float("nan")
        want, require = "wall_s", False
    for validate in (jvalidate, pvalidate):
        errors = validate(copy.deepcopy(recs), require_devtrace=require)
        assert any(want in e for e in errors), (validate, errors)


# ---------------------------------------------------------------------------
# the card's fixture
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    return pdev.load_trace(CARD_TRACE), pmerge([CARD_JSONL])


def test_card_fixture_replays(card):
    events, records = card
    rep = pdev.attribute(events, records)
    assert rep["join"] == "annotation"
    assert rep["coverage"] >= DEVTRACE_COVERAGE_FLOOR
    assert rep["domains"] == 1
    got = {k: rep["kernels"][k]["launches"] for k in CARD_KERNELS}
    assert got == CARD_KERNELS and rep["lost_launches"] == 0
    assert rep["overlap"] and rep["categories"]["collective"] > 0
    # every step's phases are there
    for k in range(CARD_NT):
        assert f"cholesky.step{k:03d}.panel" in rep["phases"] or k == 0
    assert pdev.attribute(pdev.distill(events, records), records) == rep


def test_card_fixture_cli_and_validator(tmp_path):
    enriched = str(tmp_path / "enriched.jsonl")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert pdev.main([CARD_TRACE, CARD_JSONL, "-o", enriched, "--json",
                          str(tmp_path / "r.json"), "--top", "5"]) == 0
        from dlaf_tpu_torch.obs import critpath
        assert critpath.main([CARD_TRACE, enriched, "-o", enriched, "--top", "2"]) == 0
        assert pvalidate_cli.main([enriched, "--require-devtrace", "--require-critpath"]) == 0
    out = buf.getvalue()
    assert "kernel" in out and "masked_update_kernel" in out and "VALID" in out
    recs = [json.loads(line) for line in open(enriched)]
    assert not jvalidate(recs, require_devtrace=True, require_critpath=True)
    (dt,) = [r for r in recs if r["type"] == "devtrace"]
    assert {k: dt["attrs"]["kernels"][k]["launches"] for k in CARD_KERNELS} == CARD_KERNELS


def test_cli_usage_errors():
    with contextlib.redirect_stderr(io.StringIO()):
        assert pdev.main([CARD_TRACE]) == 2
        assert pdev.main([CARD_TRACE, CARD_JSONL, "--bogus"]) == 2
        assert pdev.main([CARD_TRACE, CARD_JSONL, "-o"]) == 2
        assert pdev.main([os.path.join(HERE, "no_such_trace.json"), CARD_JSONL]) == 1


# ---------------------------------------------------------------------------
# the CPU end to end: the ranges are there, no device op
# ---------------------------------------------------------------------------

def test_cpu_dist_cholesky_trace_has_ranges_and_the_cli_exits_1(tmp_path):
    from dlaf_tpu_torch import config, obs
    from dlaf_tpu_torch.algorithms.cholesky import cholesky
    from dlaf_tpu_torch.comm.grid import shared_grid
    from dlaf_tpu_torch.common.index2d import TileElementSize
    from dlaf_tpu_torch.matrix.matrix import Matrix

    art = str(tmp_path / "art.jsonl")
    config.initialize(config.Configuration(metrics_path=art, trace_dir=str(tmp_path / "tr"),
                                           log="off"))
    try:
        x = np.random.default_rng(0).standard_normal((256, 256))
        m = Matrix.from_global(x @ x.T + 256 * np.eye(256), TileElementSize(32, 32),
                               grid=shared_grid(2, 2, "cpu"))
        cholesky("L", m)
        obs.flush()
        path = obs.stop_profiler()
    finally:
        obs._reset_for_tests()
        config.initialize()
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {f"cholesky.step{k:03d}.{ph}" for k in range(8)
            for ph in ("panel", "strip", "bulk")} <= names
    assert {"comm.bcast", "comm.bcast2d", "comm.all_gather"} <= names
    out = subprocess.run([sys.executable, "-m", "dlaf_tpu_torch.obs.devtrace", path, art],
                         capture_output=True, text=True, cwd=ROOT, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 1, out.stderr
    assert "no device op events" in out.stderr
