"""AST-based repo-convention linter for the port.

Port of ``dlaf_tpu/analysis/lint.py``: the same token scan for
suppressions, the same scope machinery and the same walk, with the rules
scoped to ``dlaf_tpu_torch/`` and the host-sync vocabulary of PyTorch:

``lint-unregistered-knob``
    A literal ``DLAF_<NAME>`` environment read inside ``dlaf_tpu_torch/``
    whose ``<name>`` is not a registered ``Configuration`` field of
    ``dlaf_tpu_torch/config.py``: an unlayered side-channel knob that
    ``--dlaf:`` flags, the struct API and ``print_config`` cannot see.

``lint-unguarded-traced-metric``
    Metric mutation (``...counter(...).inc/observe``) in the hot layers
    (``algorithms/``, ``comm/``, ``eigensolver/``, ``tile_ops/``) in a
    function with no ``metrics_active()`` guard. Nothing is traced in
    the port, but the guard keeps a record site free (no registry
    lookup, no label dict) when metrics are off, as in the reference.

``lint-np-in-traced``
    ``np.*`` applied to a tensor parameter in ``algorithms/`` or
    ``eigensolver/``: a parameter annotated as holding tensors
    (:data:`TENSOR_ANNOTATIONS`: ``torch.Tensor``, the per-rank
    ``cc.Shards`` that the program bodies the graph auditor records take,
    ``Matrix``; the port has no ``jax.jit`` and no ``_build_*``), used in
    the body or in a def nested in it. On a CUDA
    tensor such a call raises; on the CPU it silently copies, so it is a
    fault only the card shows. Dataflow is one hop: only direct uses of
    the parameters are flagged. The D&C's numpy host control
    (``tridiag_solver.py``) takes numpy arrays and is not flagged.

``lint-host-sync``
    ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``, a
    ``synchronize()`` (``torch.cuda.synchronize()``, a stream's or an
    event's) or ``print()`` outside the allow-listed host-boundary sites
    (:data:`HOST_SYNC_ALLOWED`). Hot-path library code must stay
    asynchronous. The rule is syntactic: a numpy array's ``.tolist()``
    is flagged too, and a host-side site says so in a suppression.

``lint-forbidden-import``
    A module of the port that imports ``jax``/``jaxlib`` or anything of
    the JAX package ``dlaf_tpu`` (``dlaf_tpu_torch`` is the port itself):
    the port stands alone (ROADMAP's North star).
    ``tests/test_torch_isolation.py`` checks the same at import time.

``lint-suppression-reason``
    A ``# dlaf: disable=RULE`` comment with no parenthesized reason:
    every suppression must say why, or it rots.

Suppression: append ``# dlaf: disable=RULE(reason)`` to the offending
line (any line of a multi-line statement). The reason is mandatory; the
comment suppresses only that rule on that line. Only real comment
tokens count — docstrings and string literals quoting the syntax, like
this one, are ignored.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .findings import Finding

#: The port's package, the root of every rule's scope.
PACKAGE = "dlaf_tpu_torch/"

#: Paths (posix, repo-root-relative prefixes) where each rule applies.
TRACED_DIRS = ("dlaf_tpu_torch/algorithms/", "dlaf_tpu_torch/comm/",
               "dlaf_tpu_torch/eigensolver/", "dlaf_tpu_torch/tile_ops/")
NP_TRACED_DIRS = ("dlaf_tpu_torch/algorithms/", "dlaf_tpu_torch/eigensolver/")

#: Sites where a host sync IS the contract:
#:
#: * the reference's list, mapped: the miniapps print results, the obs
#:   layer is the host boundary, ``config.py``'s ``print_config``, the
#:   sync modules block by definition, ``matrix/printing.py``, the D&C's
#:   host control (``tridiag_solver.py``, the documented host-sequential
#:   stage), the native host code, the analysis layer itself (a host
#:   CLI), the serving front end (host batching, deadlines, fenced
#:   latency records); ``matrix/memory.py`` and ``tpu_info.py`` are not
#:   ported;
#: * the port's own host boundaries: ``fleet/`` (frames, JSON and base64
#:   of the arrays a worker returns), ``health/resume.py`` and
#:   ``matrix/checkpoint.py`` (a checkpoint is host bytes), and
#:   ``matrix/convert.py`` (the conversions to numpy the user asks for).
HOST_SYNC_ALLOWED = (
    "dlaf_tpu_torch/miniapp/", "dlaf_tpu_torch/obs/", "dlaf_tpu_torch/config.py",
    "dlaf_tpu_torch/common/sync.py", "dlaf_tpu_torch/comm/sync.py",
    "dlaf_tpu_torch/matrix/printing.py",
    "dlaf_tpu_torch/eigensolver/tridiag_solver.py",
    "dlaf_tpu_torch/native/",
    "dlaf_tpu_torch/analysis/",
    "dlaf_tpu_torch/serve/",
    "dlaf_tpu_torch/fleet/",
    "dlaf_tpu_torch/health/resume.py", "dlaf_tpu_torch/matrix/checkpoint.py",
    "dlaf_tpu_torch/matrix/convert.py",
)

#: Annotations (the last dotted name) that mark a parameter as holding
#: tensors: a tensor, the per-rank shards the distributed builders take
#: (``comm.collectives.Shards``), a distributed ``Matrix``.
TENSOR_ANNOTATIONS = ("Tensor", "Shards", "Matrix")

#: Literal DLAF_* env names that are deliberately NOT Configuration
#: fields. Keep this list short and justified; prefer an in-code
#: ``# dlaf: disable=lint-unregistered-knob(reason)`` for one-off test
#: hooks so the justification sits next to the read.
NON_KNOB_ENV: Set[str] = set()

#: Method names whose call reads a tensor's data on the host.
HOST_READS = ("item", "cpu", "numpy", "tolist")

_SUPPRESS_RE = re.compile(
    r"#\s*dlaf:\s*disable=([A-Za-z0-9_-]+)\s*(\(([^)]*)\))?")

_ENV_READ_FUNCS = {"get", "setdefault", "pop"}


def _config_knob_names() -> Set[str]:
    """Registered Configuration field names of the port (no torch import
    needed)."""
    from dlaf_tpu_torch.config import Configuration

    return {f.name for f in dataclasses.fields(Configuration)}


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------

def _attr_chain(node) -> List[str]:
    """['obs', 'counter'] for ``obs.counter``; [] for non-name chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif parts:
        parts.append("<expr>")
    return list(reversed(parts))


def _contains_name(node, name: str) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == name:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == name:
            return True
    return False


def _is_env_read(call: ast.Call) -> Optional[str]:
    """The literal env-var name read by this call, if it is one."""
    chain = _attr_chain(call.func)
    literal = None
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        literal = call.args[0].value
    if chain[-2:] in (["environ", f] for f in _ENV_READ_FUNCS) \
            or chain[-2:] == ["os", "getenv"]:
        return literal
    return None


def _env_subscript_name(node: ast.Subscript) -> Optional[str]:
    # Load context only: os.environ["DLAF_X"] = v is a WRITE (propagating
    # a setting to a child process), not an unregistered-knob read
    if not isinstance(node.ctx, ast.Load):
        return None
    chain = _attr_chain(node.value)
    if chain[-1:] == ["environ"] and isinstance(node.slice, ast.Constant) \
            and isinstance(node.slice.value, str):
        return node.slice.value
    return None


def _tensor_params(fn) -> Set[str]:
    """Parameters of ``fn`` annotated with one of
    :data:`TENSOR_ANNOTATIONS` (``torch.Tensor``, ``cc.Shards``,
    ``Matrix``, or a string annotation naming one)."""
    out = set()
    for a in fn.args.args + fn.args.posonlyargs + fn.args.kwonlyargs:
        ann = a.annotation
        if ann is None:
            continue
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            text = ann.value
        else:
            text = ".".join(_attr_chain(ann))
        if text.split(".")[-1] in TENSOR_ANNOTATIONS:
            out.add(a.arg)
    return out


def _forbidden_module(name: Optional[str]) -> bool:
    if not name:
        return False
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "dlaf_tpu")


@dataclasses.dataclass
class _Scope:
    """Lexical function-nesting info for every AST node."""

    parents: Dict[int, ast.AST]

    def chain(self, node) -> List[ast.FunctionDef]:
        """Enclosing FunctionDefs, innermost first."""
        out = []
        cur = self.parents.get(id(node))
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(cur)
            cur = self.parents.get(id(cur))
        return out

    def tensor_uses(self, node, used: Set[str]):
        """The innermost enclosing function one of whose tensor
        parameters (:func:`_tensor_params`) is among ``used``, with the
        names hit; ``(None, set())`` for none."""
        for fn in self.chain(node):
            hit = _tensor_params(fn) & used
            if hit:
                return fn, hit
        return None, set()


def _parent_map(tree) -> Dict[int, ast.AST]:
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return parents


# ---------------------------------------------------------------------------
# Per-file lint
# ---------------------------------------------------------------------------

def _suppressions(src: str) -> Tuple[Dict[int, Set[str]], List[Tuple[int, str]]]:
    """Line -> suppressed rules, plus (line, rule) for reason-less ones.

    Scans real COMMENT tokens only (tokenize, not raw lines), so a
    docstring or string literal QUOTING the suppression syntax is
    neither a phantom bare-suppression finding nor a silent suppressor.
    Tokenization errors end the scan early; such files surface as
    ``lint-syntax-error`` from the AST parse."""
    import io
    import tokenize

    by_line: Dict[int, Set[str]] = {}
    bad: List[Tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type != tokenize.COMMENT:
                continue
            for m in _SUPPRESS_RE.finditer(tok.string):
                rule, reason = m.group(1), (m.group(3) or "").strip()
                if reason:
                    by_line.setdefault(tok.start[0], set()).add(rule)
                else:
                    bad.append((tok.start[0], rule))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return by_line, bad


def _host_sync_kind(call: ast.Call) -> Optional[str]:
    chain = _attr_chain(call.func)
    if chain == ["print"]:
        return "print"
    if isinstance(call.func, ast.Attribute):
        if call.func.attr in HOST_READS:
            return f".{call.func.attr}()"
        if call.func.attr == "synchronize":
            return ("torch.cuda.synchronize()" if chain[-3:] == ["torch", "cuda", "synchronize"]
                    else ".synchronize()")
    return None


def lint_source(src: str, path: str) -> List[Finding]:
    """All lint findings for one file's source. ``path`` must be the
    repo-root-relative posix path — the rules scope on it."""
    path = path.replace(os.sep, "/")
    findings: List[Finding] = []
    suppressed, bare = _suppressions(src)

    def emit(rule: str, node, message: str, detail: str) -> None:
        lineno = getattr(node, "lineno", 0)
        end = getattr(node, "end_lineno", None) or lineno
        # a multi-line statement is suppressible from any of its lines
        if any(rule in suppressed.get(ln, ()) for ln in range(lineno, end + 1)):
            return
        findings.append(Finding(rule, f"{path}:{lineno}", message,
                                key_detail=f"{path}|{detail}"))

    for lineno, rule in bare:
        node = ast.Constant(value=None)
        node.lineno = lineno
        emit("lint-suppression-reason", node,
             f"suppression of {rule} carries no (reason) — say why or "
             f"remove it", f"bare-suppression|{rule}")

    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        findings.append(Finding("lint-syntax-error", f"{path}:{e.lineno}",
                                f"file does not parse: {e.msg}",
                                key_detail=f"{path}|syntax"))
        return findings

    scope = _Scope(_parent_map(tree))
    knobs = _config_knob_names()
    in_package = path.startswith(PACKAGE)
    in_traced_dirs = path.startswith(TRACED_DIRS)
    in_np_dirs = path.startswith(NP_TRACED_DIRS)
    host_sync_applies = in_package and not path.startswith(HOST_SYNC_ALLOWED)

    for node in ast.walk(tree):
        # ---- lint-forbidden-import ----
        if in_package and isinstance(node, (ast.Import, ast.ImportFrom)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                names = [node.module] if node.level == 0 else []
            for name in names:
                if _forbidden_module(name):
                    emit("lint-forbidden-import", node,
                         f"import of {name} — the port imports torch and "
                         f"numpy, never jax and nothing of dlaf_tpu (keep "
                         f"a copy of what it needs)", f"import|{name}")

        # ---- lint-unregistered-knob ----
        env_name = None
        if isinstance(node, ast.Call):
            env_name = _is_env_read(node)
        elif isinstance(node, ast.Subscript):
            env_name = _env_subscript_name(node)
        if env_name and env_name.startswith("DLAF_") \
                and env_name not in NON_KNOB_ENV \
                and env_name[len("DLAF_"):].lower() not in knobs:
            emit("lint-unregistered-knob", node,
                 f"env read of {env_name} which is not a registered "
                 f"Configuration field — unlayered side-channel knob "
                 f"(register it in dlaf_tpu_torch/config.py or suppress "
                 f"with a reason)", f"knob|{env_name}")

        if not isinstance(node, ast.Call):
            continue

        # ---- lint-unguarded-traced-metric ----
        if in_traced_dirs and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("inc", "observe"):
            recv = node.func.value
            is_metric = isinstance(recv, ast.Call) and \
                _attr_chain(recv.func)[-1:] in (["counter"], ["gauge"],
                                                ["histogram"])
            if is_metric:
                fns = scope.chain(node)
                guarded = any(_contains_name(fn, "metrics_active")
                              for fn in fns)
                if not guarded:
                    emit("lint-unguarded-traced-metric", node,
                         "metric mutation in a hot layer without a "
                         "metrics_active() guard — guard it as "
                         "comm.collectives._record does",
                         f"metric|{_attr_chain(recv.func)[-1]}|"
                         f"{fns[0].name if fns else '<module>'}")

        # ---- lint-np-in-traced ----
        if in_np_dirs:
            chain = _attr_chain(node.func)
            if len(chain) >= 2 and chain[0] == "np":
                used = {sub.id for arg in list(node.args)
                        + [k.value for k in node.keywords]
                        for sub in ast.walk(arg) if isinstance(sub, ast.Name)}
                fn, hit = scope.tensor_uses(node, used)
                if fn is not None:
                    emit("lint-np-in-traced", node,
                         f"np.{'.'.join(chain[1:])} applied to tensor "
                         f"parameter(s) {sorted(hit)} of {fn.name}() — "
                         f"raises on a CUDA tensor, copies on the CPU; "
                         f"use torch",
                         f"np|{fn.name}|{'.'.join(chain[1:])}")

        # ---- lint-host-sync ----
        if host_sync_applies:
            sync_kind = _host_sync_kind(node)
            if sync_kind:
                fns = scope.chain(node)
                emit("lint-host-sync", node,
                     f"{sync_kind} outside the allow-listed host-boundary "
                     f"sites — hot-path library code must stay async "
                     f"(allowlist in analysis/lint.py, or suppress with "
                     f"a reason)",
                     f"sync|{sync_kind}|{fns[0].name if fns else '<module>'}")

    return findings


# ---------------------------------------------------------------------------
# Repo walk
# ---------------------------------------------------------------------------

def iter_py_files(root: str, subdirs: Sequence[str] = ("dlaf_tpu_torch",),
                  ) -> Iterable[str]:
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git", "_build"))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def run(root: str = ".", subdirs: Sequence[str] = ("dlaf_tpu_torch",),
        ) -> List[Finding]:
    """Lint every ``.py`` file under ``root``'s ``subdirs``. An empty
    walk raises: zero files scanned must never report as a clean gate
    (a wrong ``--root`` would otherwise silently disable the linter)."""
    findings: List[Finding] = []
    paths = list(iter_py_files(root, subdirs))
    if not paths:
        raise FileNotFoundError(
            f"no .py files under {root!r} subdirs {tuple(subdirs)} — "
            f"wrong --root? the lint gate refuses to pass vacuously")
    for path in paths:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        rel = os.path.relpath(path, root)
        findings.extend(lint_source(src, rel))
    return findings
