"""The port's static-analysis layer (``dlaf_tpu_torch/analysis/``): the
findings workflow, the convention linter, the CLI and the drills.

Held against the reference (``dlaf_tpu.analysis.findings`` and
``dlaf_tpu.analysis.lint``, which load without jax on their own; the
reference's ``depgraph``, ``graphcheck``, ``drills`` and ``__main__`` are
not imported): ``Finding.key``/``str``, ``diff_baseline`` and the baseline
files give equal results through both packages, malformed files
included; the reference's lint cases (its ``tests/test_analysis.py``),
with paths and package names mapped ``dlaf_tpu/`` -> ``dlaf_tpu_torch/``,
give the same rules and the same keys (modulo the prefix) through both
linters. The port's own: the host-sync vocabulary of PyTorch, the
``np.*``-on-tensor rule, ``lint-forbidden-import``, the lint run on the
port's tree against the committed baseline, and the CLI's exit codes
(every drill 1, an unknown drill 2, a clean gate 0). The graph auditor's
tests are ``tests/test_torch_analysis_graph.py``.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

from dlaf_tpu.analysis import findings as jfindings
from dlaf_tpu.analysis import lint as jlint
from dlaf_tpu_torch.analysis import BASELINE_PATH, drills, findings, graphcheck, lint
from dlaf_tpu_torch.analysis.__main__ import main as analysis_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALGO = "algorithms/fake.py"


def _port_rules(src, path="dlaf_tpu_torch/" + ALGO):
    return {f.rule for f in lint.lint_source(src, path)}


# ---------------------------------------------------------------------------
# findings: the reference's behaviour through both packages
# ---------------------------------------------------------------------------

FINDING_ARGS = [("lint-host-sync", "dlaf_tpu/x.py:3", "msg", "dlaf_tpu/x.py|sync|print|f"),
                ("graph-dead-output", "cholesky.dist.L.la1.comm1", "m", None),
                ("graph-hbm-blowup", "spec", "a message", "spec|aten::mul|64x")]


@pytest.mark.parametrize("args", FINDING_ARGS)
def test_finding_key_and_str_match_reference(args):
    a, b = findings.Finding(*args), jfindings.Finding(*args)
    assert a.key == b.key and str(a) == str(b)


def test_diff_baseline_matches_reference():
    fs = [findings.Finding(*a) for a in FINDING_ARGS]
    jfs = [jfindings.Finding(*a) for a in FINDING_ARGS]
    base = [fs[0].key, "graph-trace-error|gone", fs[2].key]
    new, stale = findings.diff_baseline(fs, base)
    jnew, jstale = jfindings.diff_baseline(jfs, base)
    assert [f.key for f in new] == [f.key for f in jnew] == [fs[1].key]
    assert stale == jstale == ["graph-trace-error|gone"]


def test_baseline_files_round_trip_through_both(tmp_path):
    fs = [findings.Finding(*a) for a in FINDING_ARGS]
    mine, theirs = tmp_path / "port.json", tmp_path / "ref.json"
    findings.write_baseline(str(mine), fs)
    jfindings.write_baseline(str(theirs), [jfindings.Finding(*a) for a in FINDING_ARGS])
    for path in (mine, theirs):
        assert findings.load_baseline(str(path)) == jfindings.load_baseline(str(path))
    assert json.load(open(mine))["findings"] == json.load(open(theirs))["findings"]
    # a missing file is an empty baseline in both
    assert findings.load_baseline(str(tmp_path / "nope.json")) == []
    assert jfindings.load_baseline(str(tmp_path / "nope.json")) == []


@pytest.mark.parametrize("doc", [[1, 2], {"findings": "x"}, {"findings": [1]}, {"other": []}])
def test_malformed_baselines_raise_in_both(tmp_path, doc):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError):
        findings.load_baseline(str(path))
    with pytest.raises(ValueError):
        jfindings.load_baseline(str(path))


# ---------------------------------------------------------------------------
# lint: the reference's cases through both linters
# ---------------------------------------------------------------------------

_TRACED = ('from dlaf_tpu import obs\n'
           'def _build_x(dist, mesh):\n'
           '    def fn(s):\n'
           '        obs.counter("dlaf_x_total", mode="a").inc()\n'
           '        return s\n'
           '    return fn\n')
_BARE = ('import os\nV = os.environ.get("DLAF_NOT_A_KNOB")'
         '  # dlaf: disable=lint-unregistered-knob\n')

#: name -> (source, path under the package); the reference's cases.
REFERENCE_CASES = {
    "knob-trip": ('import os\nV = os.environ.get("DLAF_NOT_A_KNOB")\n', ALGO),
    "knob-registered": ('import os\nV = os.environ.get("DLAF_LOG")\n', ALGO),
    "knob-suppressed": ('import os\nV = os.environ.get("DLAF_NOT_A_KNOB")'
                        '  # dlaf: disable=lint-unregistered-knob(test hook)\n', ALGO),
    "knob-multiline": ('import os\nV = os.environ.get(\n    "DLAF_NOT_A_KNOB"'
                       '  # dlaf: disable=lint-unregistered-knob(test hook)\n)\n', ALGO),
    "knob-other-env": ('import os\nV = os.environ.get("JAX_PLATFORMS")\n', ALGO),
    "metric-trip": (_TRACED, ALGO),
    "metric-guarded": (_TRACED.replace(
        '        obs.counter("dlaf_x_total", mode="a").inc()\n',
        '        if obs.metrics_active():\n'
        '            obs.counter("dlaf_x_total", mode="a").inc()\n'), ALGO),
    "metric-suppressed": (_TRACED.replace(
        '.inc()\n', '.inc()  # dlaf: disable=lint-unguarded-traced-metric(host-side '
        'builder accounting, runs once per build)\n'), ALGO),
    "metric-outside-layers": (_TRACED, "health/fake.py"),
    "suppression-bare": (_BARE, ALGO),
    "suppression-reason": (_BARE.replace("disable=lint-unregistered-knob",
                                         "disable=lint-unregistered-knob(justified)"), ALGO),
    "env-write": ('import os\nos.environ["DLAF_NOT_A_KNOB"] = "1"\n', ALGO),
    "env-read": ('import os\nV = os.environ["DLAF_NOT_A_KNOB"]\n', ALGO),
    "string-doc": ('"""Usage: append # dlaf: disable=lint-host-sync to a line."""\n', ALGO),
    "string-quoted": ('import os\nV = os.environ.get("DLAF_NOT_A_KNOB"), '
                      '"# dlaf: disable=lint-unregistered-knob(quoted)"\n', ALGO),
    "syntax-error": ("def f(:\n", ALGO),
    "line-moved": ('import os\n\n\nV = os.environ.get("DLAF_NOPE")\n', ALGO),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_lint_reference_cases_match(case):
    src, rel = REFERENCE_CASES[case]
    ref = jlint.lint_source(src, "dlaf_tpu/" + rel)
    mine = lint.lint_source(src.replace("from dlaf_tpu import", "from dlaf_tpu_torch import"),
                            "dlaf_tpu_torch/" + rel)
    assert sorted(f.rule for f in mine) == sorted(f.rule for f in ref)
    assert sorted(f.key.replace("dlaf_tpu_torch/", "dlaf_tpu/") for f in mine) == \
        sorted(f.key for f in ref)
    assert [f.site.replace("dlaf_tpu_torch/", "dlaf_tpu/") for f in mine] == \
        [f.site for f in ref]


def test_lint_reference_cases_are_not_vacuous():
    """The parity cases trip every rule the reference's tests trip there."""
    tripped = set()
    for src, rel in REFERENCE_CASES.values():
        tripped |= {f.rule for f in jlint.lint_source(src, "dlaf_tpu/" + rel)}
    assert tripped == {"lint-unregistered-knob", "lint-unguarded-traced-metric",
                       "lint-suppression-reason", "lint-syntax-error"}


# ---------------------------------------------------------------------------
# lint: the port's own rules
# ---------------------------------------------------------------------------

HOST_SYNCS = {
    ".item()": "def f(a):\n    return a.item()\n",
    ".cpu()": "def f(a):\n    return a.cpu()\n",
    ".numpy()": "def f(a):\n    return a.numpy()\n",
    ".tolist()": "def f(a):\n    return a.tolist()\n",
    "torch.cuda.synchronize()": "import torch\ndef f():\n    torch.cuda.synchronize()\n",
    "stream.synchronize()": "import torch\ndef f(s):\n    s.synchronize()\n",
    "event.synchronize()": "import torch\ndef f():\n    torch.cuda.Event().synchronize()\n",
    "print": "def f(x):\n    print(x)\n",
}


@pytest.mark.parametrize("form", sorted(HOST_SYNCS))
def test_lint_host_sync_vocabulary(form):
    src = HOST_SYNCS[form]
    assert "lint-host-sync" in _port_rules(src)
    assert "lint-host-sync" in _port_rules(src, "dlaf_tpu_torch/tile_ops/fake.py")
    # allow-listed host boundaries pass
    for rel in ("miniapp/fake.py", "obs/fake.py", "serve/fake.py", "fleet/fake.py",
                "eigensolver/tridiag_solver.py", "matrix/checkpoint.py", "health/resume.py"):
        assert "lint-host-sync" not in _port_rules(src, "dlaf_tpu_torch/" + rel), rel
    # outside the package (tests, scripts) the rule does not apply
    assert "lint-host-sync" not in _port_rules(src, "scripts/fake.py")
    line = src.rstrip("\n").splitlines()[-1]
    sup = src.replace(line, line + "  # dlaf: disable=lint-host-sync(a host boundary)")
    assert "lint-host-sync" not in _port_rules(sup)


def test_lint_host_sync_key_names_form_and_function():
    [f] = lint.lint_source(HOST_SYNCS[".item()"], "dlaf_tpu_torch/" + ALGO)
    assert f.key == "lint-host-sync|dlaf_tpu_torch/algorithms/fake.py|sync|.item()|f"


def test_lint_np_on_tensor_parameters():
    trip = ("import numpy as np\nimport torch\n"
            "def f(a: torch.Tensor, n: int):\n    return np.abs(a)\n")
    assert "lint-np-in-traced" in _port_rules(trip)
    # a string annotation and a bare Tensor count too
    assert "lint-np-in-traced" in _port_rules(trip.replace("a: torch.Tensor", "a: 'torch.Tensor'"))
    # index math on a non-tensor parameter, and numpy-typed host control, pass
    assert "lint-np-in-traced" not in _port_rules(trip.replace("np.abs(a)", "np.arange(n)"))
    host = ("import numpy as np\n"
            "def f(d: np.ndarray, e: np.ndarray):\n    return np.argsort(d)\n")
    assert "lint-np-in-traced" not in _port_rules(host)
    assert "lint-np-in-traced" in _port_rules(trip, "dlaf_tpu_torch/eigensolver/fake.py")
    # outside algorithms/ and eigensolver/ the rule does not apply
    assert "lint-np-in-traced" not in _port_rules(trip, "dlaf_tpu_torch/comm/fake.py")
    sup = trip.replace("np.abs(a)\n", "np.abs(a)  # dlaf: disable=lint-np-in-traced(why)\n")
    assert "lint-np-in-traced" not in _port_rules(sup)


def test_lint_np_on_a_recorded_program_body():
    """The builders the graph auditor records take per-rank tensor lists
    (``cc.Shards``) or a ``Matrix``: ``np.*`` on them, in the body or a
    nested def, is flagged."""
    body = ("import numpy as np\n"
            "from ..comm import collectives as cc\n"
            "def _cholesky_dist(lts: cc.Shards, dist, *, uplo):\n"
            "    nt = np.ceil(3.5)\n"
            "    def step(k):\n"
            "        return np.abs(lts[0][0])\n"
            "    return step\n")
    found = lint.lint_source(body, "dlaf_tpu_torch/" + ALGO)
    assert [f.key for f in found] == [
        "lint-np-in-traced|dlaf_tpu_torch/algorithms/fake.py|np|_cholesky_dist|abs"]
    mat = body.replace("lts: cc.Shards", "lts: Matrix")
    assert "lint-np-in-traced" in _port_rules(mat)
    assert "lint-np-in-traced" not in _port_rules(body.replace("lts: cc.Shards", "lts"))


def _recorded_builders():
    """The private builders ``graphcheck.program_specs`` imports, from its
    source: ``{name: module path}``."""
    src = open(os.path.join(REPO, "dlaf_tpu_torch", "analysis", "graphcheck.py")).read()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "program_specs")
    out = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.ImportFrom) and node.level == 2:
            for alias in node.names:
                if alias.name.startswith("_"):
                    out[alias.name] = os.path.join("dlaf_tpu_torch",
                                                   *node.module.split(".")) + ".py"
    return out


def test_every_recorded_builder_declares_its_tensor_parameters():
    """``lint-np-in-traced`` covers every program body the graph auditor
    records through the builders' own annotations: a builder renamed or
    re-signed without them fails here."""
    builders = _recorded_builders()
    assert {"_cholesky_dist", "_hegst_dist", "_dist_bt_b2t", "_red2band_local"} <= set(builders)
    for name, path in builders.items():
        tree = ast.parse(open(os.path.join(REPO, path)).read())
        [fn] = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name]
        assert lint._tensor_params(fn), f"{path}:{fn.lineno} {name} names no tensor parameter"


FORBIDDEN = ["import jax\n", "import jax.numpy as jnp\n", "from jax import numpy as jnp\n",
             "from jax.experimental import pallas\n", "import jaxlib\n", "import dlaf_tpu\n",
             "from dlaf_tpu.obs import metrics\n", "from dlaf_tpu import config\n",
             "import dlaf_tpu.analysis.lint\n"]
ALLOWED = ["import dlaf_tpu_torch\n", "from dlaf_tpu_torch.obs import metrics\n",
           "from dlaf_tpu_torch import config\n", "from . import lint\n",
           "from ..obs import trace\n", "import jaxtyping_is_not_jax\n"]


@pytest.mark.parametrize("src", FORBIDDEN)
def test_lint_forbidden_import_trips(src):
    found = lint.lint_source(src, "dlaf_tpu_torch/" + ALGO)
    assert [f.rule for f in found] == ["lint-forbidden-import"]
    # everywhere in the package, not only the hot layers
    assert "lint-forbidden-import" in _port_rules(src, "dlaf_tpu_torch/obs/fake.py")
    # the tests import both packages
    assert "lint-forbidden-import" not in _port_rules(src, "tests/test_torch_fake.py")


@pytest.mark.parametrize("src", ALLOWED)
def test_lint_forbidden_import_passes_the_port(src):
    assert _port_rules(src) == set()


def test_lint_port_tree_equals_the_committed_baseline():
    """The acceptance pin: the port's tree lints to exactly the lint keys
    of the committed baseline (none), the three findings the reference's
    linter found in it repaired; no module imports jax or dlaf_tpu."""
    got = lint.run(REPO)
    base = [k for k in findings.load_baseline(os.path.join(REPO, BASELINE_PATH))
            if k.startswith("lint-")]
    assert sorted(f.key for f in got) == sorted(base)
    assert not [f for f in got if f.rule == "lint-forbidden-import"]


def test_lint_empty_walk_refuses_to_pass(tmp_path):
    with pytest.raises(FileNotFoundError, match="vacuously"):
        lint.run(str(tmp_path))
    with pytest.raises(SystemExit) as e:
        analysis_main(["--lint-only", "--root", str(tmp_path)])
    assert e.value.code == 2


def test_pinned_native_config_restores_the_callers_config():
    from dlaf_tpu_torch import config

    config.initialize(config.Configuration(hegst_impl="twosolve", step_impl="fused"))
    try:
        with graphcheck.pinned_native_config():
            cfg = config.get_configuration()
            assert (cfg.hegst_impl, cfg.step_impl, cfg.autotune) == ("blocked", "xla", "0")
        cfg = config.get_configuration()
        assert (cfg.hegst_impl, cfg.step_impl) == ("twosolve", "fused")
    finally:
        config.initialize(config.Configuration())


def test_pinned_native_config_pins_only_port_fields():
    from dlaf_tpu_torch import config

    import dataclasses
    names = {f.name for f in dataclasses.fields(config.Configuration)}
    for gone in ("qr_panel", "dc_level_batch", "bt_lookahead"):
        assert gone not in names


# ---------------------------------------------------------------------------
# CLI and drills
# ---------------------------------------------------------------------------

@pytest.fixture
def few_specs(monkeypatch):
    """The graph half of the CLI over three specs of the matrix (the whole
    matrix is the graph test file's)."""
    keep = ("cholesky.local.loop.L.la0", "cholesky.dist.L.la1.comm1", "serve.eigh.batched.L")
    real = graphcheck.program_specs

    def few(*args, **kw):
        return [s for s in real(*args, **kw) if s.name in keep]

    monkeypatch.setattr(graphcheck, "program_specs", few)
    return keep


def test_cli_lint_only_clean(capsys):
    assert analysis_main(["--lint-only", "--root", REPO]) == 0
    assert "analysis gate: PASSED" in capsys.readouterr().out


def test_cli_lint_only_fails_on_a_seeded_file(tmp_path, capsys):
    pkg = tmp_path / "dlaf_tpu_torch" / "algorithms"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text("import jax\n")
    assert analysis_main(["--lint-only", "--root", str(tmp_path), "--device", "cpu"]) == 1
    assert "lint-forbidden-import" in capsys.readouterr().out


def test_cli_graph_only_clean(few_specs, capsys):
    assert analysis_main(["--graph-only", "--root", REPO, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "graph: 3 programs recorded on cpu" in out and "PASSED" in out


def test_cli_write_baseline_to_tmp(few_specs, tmp_path, capsys):
    path = tmp_path / "baseline.json"
    assert analysis_main(["--root", REPO, "--device", "cpu", "--baseline", str(path),
                          "--write-baseline"]) == 0
    keys = findings.load_baseline(str(path))
    assert all(k.split("|")[1] in few_specs for k in keys)
    # the written baseline makes the same run pass
    assert analysis_main(["--root", REPO, "--device", "cpu", "--baseline", str(path)]) == 0
    # a partial run may not overwrite the shared baseline
    with pytest.raises(SystemExit) as e:
        analysis_main(["--lint-only", "--write-baseline", "--baseline", str(path)])
    assert e.value.code == 2


def test_cli_new_finding_fails(few_specs, tmp_path, capsys):
    path = tmp_path / "empty.json"
    findings.write_baseline(str(path), [])
    rc = analysis_main(["--graph-only", "--device", "cpu", "--baseline", str(path)])
    assert rc == 1 and "NEW" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(drills.DRILLS))
def test_cli_every_drill_trips(name, capsys):
    assert analysis_main(["--drill", name, "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    for rule in drills.DRILLS[name][1]:
        assert rule in out
    assert f"drill {name}: tripped" in out


def test_cli_unknown_drill_is_a_usage_error():
    with pytest.raises(SystemExit) as e:
        analysis_main(["--drill", "no_such_drill", "--device", "cpu"])
    assert e.value.code == 2


def test_cli_cuda_without_a_card_is_a_usage_error():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        analysis_main(["--graph-only"])
    assert e.value.code == 2


def test_cli_list_drills(capsys):
    assert analysis_main(["--list-drills"]) == 0
    assert capsys.readouterr().out.split() == sorted(drills.DRILLS)
    assert set(drills.DRILLS) == {"rank_varying_collective", "host_callback",
                                  "dropped_output", "hbm_blowup", "precision_demotion",
                                  "lint_violation"}


def test_drill_lost_teeth_exits_3(monkeypatch):
    monkeypatch.setitem(drills.DRILLS, "hbm_blowup",
                        (lambda device="cpu": [], ("graph-hbm-blowup",)))
    assert analysis_main(["--drill", "hbm_blowup", "--device", "cpu"]) == 3


def test_cli_exit_code_in_a_process():
    """The one CLI run in a process of its own: a drill's exit code 1."""
    out = subprocess.run([sys.executable, "-m", "dlaf_tpu_torch.analysis", "--device", "cpu",
                          "--drill", "precision_demotion"], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    assert "graph-precision-demotion" in out.stdout


def test_lint_drill_source_trips_each_rule_once():
    found = drills.run("lint_violation")[0]
    rules = sorted(f.rule for f in found)
    assert set(rules) == set(drills.DRILLS["lint_violation"][1])
    assert drills.LINT_DRILL_PATH.startswith("dlaf_tpu_torch/algorithms/")
