"""The accuracy probes of the PyTorch port (``dlaf_tpu_torch/obs/accuracy.py``)
against the JAX reference's (``dlaf_tpu/obs/accuracy.py``), on the CPU.

* The probe columns and the eigenpair column sample: bitwise the
  reference's (both draw from numpy's ``default_rng`` with one seed).
* On perturbed outputs (the exact factor, solve, HEGST result or
  eigenvectors with a seeded relative error, so the residual is the
  perturbation's and not rounding: 1e-6 in float64; in float32, whose
  products round at about 1e-6 of |A| at this size, 1e-4) every
  estimator agrees with the reference's within 1e-9 relative in float64
  and 1e-3 in float32, in modes ``"1"`` and ``"full"``, on one rank and
  on a 2x2 grid (the reference on 4 of its 8 virtual CPU devices).
* On true outputs each estimate, the port's and the reference's, is under
  its budget (``c n eps``).
* ``emit``'s records pass both validators under ``--require-accuracy``,
  a non-finite value is flagged and breaches trip the flight recorder;
  the miniapps' checks go through the estimator and their timed runs
  emit records under ``DLAF_ACCURACY=1``; the D&C emits one deflation
  record per level.
"""

import json

import numpy as np
import pytest
import torch

from dlaf_tpu import config as jcfg
from dlaf_tpu.comm.grid import Grid as JGrid
from dlaf_tpu.common.index2d import TileElementSize as JTile
from dlaf_tpu.matrix.matrix import Matrix as JMatrix
from dlaf_tpu.obs import accuracy as jacc
from dlaf_tpu.obs import sinks as jsinks
from dlaf_tpu_torch import config, obs
from dlaf_tpu_torch.comm.grid import shared_grid
from dlaf_tpu_torch.common.index2d import TileElementSize
from dlaf_tpu_torch.matrix.matrix import Matrix
from dlaf_tpu_torch.obs import accuracy as pacc

N, NB = 40, 8
RTOL = {np.float64: 1e-9, np.float32: 1e-3}
PERTURB = {np.float64: 1e-6, np.float32: 1e-4}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("DLAF_ACCURACY", raising=False)
    monkeypatch.delenv("DLAF_METRICS_PATH", raising=False)
    config.initialize()
    jcfg.initialize()
    yield
    obs._reset_for_tests()
    config.initialize()
    jcfg.initialize()


def test_probe_columns_bitwise_the_reference():
    for n, mode, k in ((40, "1", 8), (5, "1", 8), (1, "1", 8), (40, "full", 8)):
        om, scale = pacc._probe_columns(n, mode, k, pacc.PROBE_SEED)
        jom, jscale = jacc._probe_columns(n, mode, k, jacc.PROBE_SEED)
        assert scale == jscale
        assert (om is None) == (jom is None)
        if om is not None:
            assert om.tobytes() == jom.tobytes()
        np.testing.assert_array_equal(pacc._sample_columns(n, mode, k, pacc.PROBE_SEED),
                                      jacc._sample_columns(n, mode, k, jacc.PROBE_SEED))
    a, ka, sa = pacc._eigen_probe(40, "1", 8, pacc.PROBE_SEED)
    b, kb, sb = jacc._eigen_probe(40, "1", 8, jacc.PROBE_SEED)
    assert a.tobytes() == b.tobytes() and (ka, sa) == (kb, sb)
    assert (pacc.DEFAULT_PROBES, pacc.PROBE_SEED) == (jacc.DEFAULT_PROBES, jacc.PROBE_SEED)


def hpd(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    return (x @ x.T + n * np.eye(n)).astype(dtype)


def perturb(x, seed):
    """``x`` with a seeded relative error (:data:`PERTURB`)."""
    rel = PERTURB[np.dtype(x.dtype).type]
    rng = np.random.default_rng(seed)
    return (x * (1 + rel * rng.standard_normal(x.shape))).astype(x.dtype)


def mats(arrays, grid, devices8):
    """Each host array as the port's Matrix and the reference's (one rank,
    or 2x2)."""
    pg = shared_grid(2, 2, "cpu") if grid else None
    jg = JGrid(2, 2, devices=devices8[:4]) if grid else None
    return ([Matrix.from_global(torch.as_tensor(a), TileElementSize(NB, NB), pg, device="cpu")
             for a in arrays],
            [JMatrix.from_global(a, JTile(NB, NB), grid=jg) for a in arrays])


def close(got, want, dtype):
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= RTOL[dtype] * abs(want), (got, want)


LAYOUTS = [pytest.param(False, id="local"), pytest.param(True, id="2x2")]
MODES = ["1", "full"]


@pytest.mark.parametrize("grid", LAYOUTS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("uplo,dtype", [("L", np.float64), ("U", np.float64),
                                        ("L", np.float32)])
def test_cholesky_residual_matches_reference(devices8, grid, mode, uplo, dtype):
    a = hpd(N, dtype)
    f = np.linalg.cholesky(a.astype(np.float64))
    f = (f if uplo == "L" else f.T).astype(dtype)
    (pa, pf), (ja, jf) = mats([a, perturb(f, 1)], grid, devices8)
    close(pacc.cholesky_residual(uplo, pa, pf, mode), jacc.cholesky_residual(uplo, ja, jf, mode),
          dtype)
    (pa, pf), (ja, jf) = mats([a, f], grid, devices8)
    budget = 60 * N * np.finfo(dtype).eps
    assert pacc.cholesky_residual(uplo, pa, pf, mode) < budget
    assert jacc.cholesky_residual(uplo, ja, jf, mode) < budget


@pytest.mark.parametrize("grid", LAYOUTS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("combo", ["LLNN", "LUCU", "RLTN"])
def test_trsm_residual_matches_reference(devices8, grid, mode, combo):
    side, uplo, op, diag = combo
    rng = np.random.default_rng(5)
    # off-diagonal entries small enough that the unit triangle is well
    # conditioned too
    a = 0.05 * rng.standard_normal((N, N)) + 2 * N * np.eye(N)
    b = rng.standard_normal((N, N))
    t = np.tril(a) if uplo == "L" else np.triu(a)
    if diag == "U":
        np.fill_diagonal(t, 1.0)
    t = {"N": t, "T": t.T, "C": t.T}[op]
    x = np.linalg.solve(t, 0.5 * b) if side == "L" else np.linalg.solve(t.T, 0.5 * b.T).T
    (pa, pb, px), (ja, jb, jx) = mats([a, b, perturb(x, 2)], grid, devices8)
    close(pacc.trsm_residual(side, uplo, op, diag, 0.5, pa, pb, px, mode),
          jacc.trsm_residual(side, uplo, op, diag, 0.5, ja, jb, jx, mode), np.float64)
    (pa, pb, px), (ja, jb, jx) = mats([a, b, x], grid, devices8)
    budget = 60 * N * np.finfo(np.float64).eps
    assert pacc.trsm_residual(side, uplo, op, diag, 0.5, pa, pb, px, mode) < budget
    assert jacc.trsm_residual(side, uplo, op, diag, 0.5, ja, jb, jx, mode) < budget


@pytest.mark.parametrize("grid", LAYOUTS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_hegst_residual_matches_reference(devices8, grid, mode, uplo):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((N, N))
    a = (x + x.T) / 2
    b = hpd(N, np.float64, seed=7)
    lf = np.linalg.cholesky(b)
    li = np.linalg.inv(lf)
    c = li @ a @ li.T
    f, stored_c = (lf, c) if uplo == "L" else (lf.T, c)
    (pa, pf, pc), (ja, jf, jc) = mats([a, f, perturb(stored_c, 3)], grid, devices8)
    close(pacc.hegst_residual(uplo, pa, pf, pc, mode), jacc.hegst_residual(uplo, ja, jf, jc, mode),
          np.float64)
    (pa, pf, pc), (ja, jf, jc) = mats([a, f, stored_c], grid, devices8)
    budget = 100 * N * np.finfo(np.float64).eps
    assert pacc.hegst_residual(uplo, pa, pf, pc, mode) < budget
    assert jacc.hegst_residual(uplo, ja, jf, jc, mode) < budget


@pytest.mark.parametrize("grid", LAYOUTS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind,dtype", [("standard", np.float64), ("generalized", np.float64),
                                        ("standard", np.float32)])
def test_eigen_residuals_match_reference(devices8, grid, mode, kind, dtype):
    import scipy.linalg as sla

    rng = np.random.default_rng(8)
    x = rng.standard_normal((N, N))
    a = ((x + x.T) / 2).astype(dtype)
    b = hpd(N, dtype, seed=9) if kind == "generalized" else None
    lam, z = sla.eigh(a.astype(np.float64), None if b is None else b.astype(np.float64))
    z = z.astype(dtype)
    arrays = [a, perturb(z, 4)] + ([b] if b is not None else [])
    ps, js = mats(arrays, grid, devices8)
    got = pacc.eigen_residuals("L", ps[0], lam, ps[1], ps[2] if b is not None else None, mode)
    want = jacc.eigen_residuals("L", js[0], lam, js[1], js[2] if b is not None else None, mode)
    for key in ("eigen_residual", "eigenpair_max", "orthogonality"):
        if kind == "generalized" and key == "orthogonality":
            # Z is B-orthonormal, not orthonormal: both report the same large defect
            assert abs(got[key] - want[key]) <= RTOL[dtype] * want[key]
            continue
        close(got[key], want[key], dtype)
    ps, js = mats([a, z] + ([b] if b is not None else []), grid, devices8)
    tol = 200 * N * np.finfo(dtype).eps
    for acc, m in ((pacc, ps), (jacc, js)):
        true = acc.eigen_residuals("L", m[0], lam, m[1], m[2] if b is not None else None, mode)
        assert true["eigen_residual"] < tol and true["eigenpair_max"] < tol
        if kind == "standard":
            assert true["orthogonality"] < tol


@pytest.mark.parametrize("mode", MODES)
def test_array_orthogonality_matches_reference(mode):
    q, _ = np.linalg.qr(np.random.default_rng(10).standard_normal((N, N)))
    qp = perturb(q, 5)
    close(pacc.array_orthogonality(torch.as_tensor(qp), mode),
          jacc.array_orthogonality(qp, mode), np.float64)
    assert pacc.array_orthogonality(torch.as_tensor(q), mode) < 200 * N * np.finfo(float).eps


def read(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def test_records_pass_both_validators(tmp_path):
    """``emit``'s records, the gauge, the non-finite counter and the
    breach trigger; both validators accept the artifact under
    --require-accuracy, and reject one with only informational records."""
    path = str(tmp_path / "acc.jsonl")
    config.initialize(config.Configuration(metrics_path=path, log="off", accuracy="1",
                                            flight_recorder=16))
    ok = pacc.emit("miniapp_cholesky", "cholesky_residual", 1e-16, n=64, nb=16, c=60.0,
                   dtype=np.float64, of=torch.zeros(1), attrs={"run": 0})
    assert ok.passed and ok.bound_ratio == pytest.approx(1e-16 / (60 * 64 * 2.0 ** -52))
    info = pacc.emit("tridiag_solver", "dc_deflation_fraction", 0.25, n=64, nb=16, c=None,
                     dtype=np.float64)
    assert info.passed and info.bound_ratio is None
    bad = pacc.emit("serve", "cholesky_residual", float("nan"), n=8, nb=8, c=60.0,
                    dtype=torch.float32)
    assert not bad.passed
    obs.flush()
    records = read(path)
    acc = [r for r in records if r["type"] == "accuracy"]
    assert [r["site"] for r in acc] == ["miniapp_cholesky", "tridiag_solver", "serve"]
    assert acc[0]["platform"] == "cpu" and acc[0]["attrs"] == {"run": 0, "mode": "1"}
    assert acc[2]["nonfinite"] is True and acc[2]["value"] is None and acc[2]["dtype"] == "float32"
    for validate in (obs.validate_records, jsinks.validate_records):
        assert validate(records, require_accuracy=True) == []
        assert validate(records[1:2], require_accuracy=True) == [
            "artifact contains no accuracy record with finite value and bound_ratio"]
    snap = {(m["name"], tuple(sorted(m["labels"].items()))): m["value"]
            for m in obs.registry().snapshot()}
    assert snap[("dlaf_accuracy_nonfinite_total",
                 (("metric", "cholesky_residual"), ("site", "serve")))] == 1
    flight = read(path + ".flight.jsonl")
    assert flight[0]["reason"] == "accuracy_breach"
    assert obs.exporter.healthz_payload()["accuracy"]["worst_bound_ratio"] == \
        pytest.approx(ok.bound_ratio)
    lines = [{**{k: r[k] for k in ("site", "metric", "platform", "dtype", "n", "nb", "value",
                                   "bound_ratio")}, "ts": "t", "source": "s"} for r in acc[:1]]
    assert obs.sinks.validate_history_records(lines) == []
    assert jsinks.validate_history_records(lines, "accuracy") == []


def test_validate_cli_accuracy_flags(tmp_path, capsys):
    from dlaf_tpu_torch.obs import validate

    path = str(tmp_path / "a.jsonl")
    config.initialize(config.Configuration(metrics_path=path, log="off"))
    pacc.emit("x", "cholesky_residual", 1e-15, n=8, nb=8, c=60.0, dtype=np.float64)
    obs.flush()
    assert validate.main([path, "--require-accuracy"]) == 0
    hist = tmp_path / "h.jsonl"
    hist.write_text(json.dumps({"site": "x", "metric": "m", "platform": "cpu",
                                "dtype": "float64", "ts": "t", "source": "s", "value": 1.0,
                                "bound_ratio": 0.1, "n": 8, "nb": 8}) + "\n")
    assert validate.main([str(hist), "--accuracy-history"]) == 0
    assert validate.main([path, "--accuracy-history"]) == 1
    assert validate.main([path, "--accuracy-history", "--require-accuracy"]) == 2


@pytest.mark.parametrize("app,argv,site,metrics", [
    ("miniapp_cholesky", ["-m", "40", "-b", "8"], "miniapp_cholesky", {"cholesky_residual"}),
    ("miniapp_triangular_solver", ["-m", "40", "-n", "16", "-b", "8"],
     "miniapp_triangular_solver", {"trsm_residual"}),
    ("miniapp_gen_to_std", ["-m", "40", "-b", "8"], "miniapp_gen_to_std", {"hegst_residual"}),
    ("miniapp_eigensolver", ["-m", "40", "-b", "8", "--band-size", "4"], "miniapp_eigensolver",
     {"eigen_residual", "eigenpair_max", "orthogonality"}),
])
@pytest.mark.parametrize("grid", [[], ["--grid-rows", "2", "--grid-cols", "2",
                                       "--share-device"]], ids=["local", "2x2"])
def test_miniapp_records_and_check(tmp_path, capsys, app, argv, site, metrics, grid):
    """``--check-result`` goes through the estimator (its line keeps its
    format); under DLAF_ACCURACY=1 every timed run emits its records (the
    checked run through the check)."""
    import importlib

    path = str(tmp_path / "m.jsonl")
    mod = importlib.import_module(f"dlaf_tpu_torch.miniapp.{app}")
    mod.run([*argv, "--backend", "cpu", "--type", "d", "--nruns", "2", "--nwarmups", "0",
             "--check-result", "last", *grid, f"--dlaf:metrics-path={path}", "--dlaf:accuracy=1",
             "--dlaf:log=off"])
    out = capsys.readouterr().out
    assert out.count("check: PASSED") == 1 and "residual=" in out and "tol=" in out
    acc = [r for r in read(path) if r["type"] == "accuracy" and r["site"] == site]
    assert {r["metric"] for r in acc} == metrics
    assert len(acc) == 2 * len(metrics)
    assert sum(bool(r["attrs"].get("check")) for r in acc) == len(metrics)
    assert all(r["bound_ratio"] < 1 for r in acc if "bound_ratio" in r)
    assert not obs.validate_records(read(path), require_accuracy=True)
    assert not jsinks.validate_records(read(path), require_accuracy=True)


def test_dc_emits_deflation_fraction_per_level(tmp_path):
    from dlaf_tpu_torch.eigensolver import tridiag_solver as ts

    path = str(tmp_path / "dc.jsonl")
    config.initialize(config.Configuration(metrics_path=path, log="off", accuracy="1"))
    d, e = np.full(64, 2.0), np.full(63, 1.0)
    stats = []
    ts.tridiag_solver(d, e, 8, device="cpu", stats=stats)
    obs.flush()
    acc = [r for r in read(path) if r["type"] == "accuracy"]
    levels = sorted({s.level for s in stats})
    assert [r["attrs"]["level"] for r in acc] == levels
    for r in acc:
        ss = [s for s in stats if s.level == r["attrs"]["level"]]
        assert r["metric"] == "dc_deflation_fraction" and "bound_ratio" not in r
        assert r["attrs"]["merges"] == len(ss)
        assert r["value"] == pytest.approx(sum(s.n - s.k for s in ss) / sum(s.n for s in ss))
    assert not jsinks.validate_records(read(path))
