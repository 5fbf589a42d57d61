"""Discipline linter: AST checks encoding the port's written invariants.

Port of ``keystone_tpu/tools/lint.py``. Runnable as a CLI (``python -m
keystone_tpu_torch.tools.lint [paths...]``; with no path it lints
:func:`default_paths`: ``keystone_tpu_torch/``, ``tests/test_torch_*.py``,
``chip_smoke.py`` and ``scripts/torch_*.py``) and as a tier-1 test
(``tests/test_torch_lint.py``). The registries it checks against are
parsed from the port's own modules, never imported, so it works on a
broken tree. The reference's three JAX rules have torch counterparts, each
renamed, with its own marker:

``device-off-thread`` (the reference's ``jax-off-thread``)
    No CUDA work reachable from a background-thread target: a
    ``threading.Thread(target=...)`` or a task submitted to the
    data-plane runtime's pool (``x.submit("<lane>", fn, ...)``, a lambda
    walked in place). CUDA work is ``torch.cuda.*``, the kernel wrappers
    (``cuda_ops`` / ``cuda_images``), ``.cuda()``, and a ``.to(...)`` or
    factory call on a device (a ``device=`` keyword other than ``"cpu"``,
    or a ``.to`` whose argument names a device). Reachability is
    per-module and depth-limited: the target plus the local / same-class
    helpers it calls. A function that owns device work on purpose opts
    out with ``# lint: device-owner-thread`` on its ``def`` line (or the
    line above), followed by its reason.

``thread-join``
    Every scope (class or function) that ``.start()``s a
    ``threading.Thread`` must also ``.join()`` one on its shutdown path.

``retry-transient``
    ``RetryPolicy(transient=...)`` tuples never include
    ``ShardCorrupted``: a checksum mismatch is persistent state.

``fault-site``
    Fault-injection site names (``faults.maybe_fail(...)``,
    ``faults.corrupt_array(...)``, ``FaultRule(site=...)``) exist in the
    ``SITE_*`` registry of :mod:`keystone_tpu_torch.utils.faults`.

``bench-row``
    Bench result rows are built through ``make_row``; a raw ``{"metric":
    ..., "value": ..., "detail": ...}`` literal bypasses its checks.

``metric-name``
    Every metrics-registry register / lookup site (``*.counter(...)``,
    ``*.gauge(...)``, ``*.histogram(...)``, ``*.bucketed_histogram(...)``)
    uses a name of the ``METRIC_*`` catalogue of
    :mod:`keystone_tpu_torch.obs.metrics`.

``mesh-axis-name``
    Mesh axis names come from the ``DATA_AXIS`` / ``MODEL_AXIS`` registry
    of :mod:`keystone_tpu_torch.parallel.mesh`. The port's collectives take
    lists of shards, not axis names, so the rule checks the literals where
    the port names an axis: ``shard_map(..., axis=)``, ``axis_index(...)``,
    ``axis_size(mesh, ...)``, ``shard_rows(..., axis=)`` /
    ``shard_local_rows``, the axis names of ``Mesh(...)``,
    ``make_mesh(...)`` and ``make_hybrid_mesh(...)``, and
    ``mesh.axis_devices(...)``.

``explicit-seed``
    Randomized library code takes an explicit integer seed: inside the
    package, a hardcoded integer literal in ``torch.manual_seed(...)`` or
    ``torch.Generator(...).manual_seed(...)``, or a ``seed`` parameter
    whose default is not an int literal, is flagged. Tests, scripts and
    ``chip_smoke.py`` pin literal seeds on purpose and are exempt.

``decision-event``
    Every ``*.decision`` event emitted inside the package carries the
    audit schema ``candidates`` / ``winner`` / ``reason`` (literal
    keywords or a resolvable ``**spread``).

``torch-clean-module`` (the reference's ``jax-clean-module``)
    A module carrying ``# lint: torch-clean-module`` in its first 40
    lines imports torch nowhere, at no scope: the fleet router's
    modules (``serving/fleet.py``, ``serving/fleet_rpc.py``), whose
    process owns no device work.

Findings are ``path:line: [rule] message``; the CLI exits 1 on any.
"""

from __future__ import annotations

import ast
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "lint_file", "lint_paths", "main", "RULES"]

RULES = (
    "device-off-thread",
    "thread-join",
    "retry-transient",
    "fault-site",
    "bench-row",
    "metric-name",
    "mesh-axis-name",
    "explicit-seed",
    "decision-event",
    "torch-clean-module",
)

_WRAPPER_MODULES = {"cuda_ops", "cuda_images"}
_OWNER_MARK = "lint: device-owner-thread"
_CALL_DEPTH = 6  # transitive same-scope helper expansion bound


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ---------------------------------------------------------------------------
# Site registry (parsed from utils/faults.py, never imported — the linter
# must work on a broken tree)
# ---------------------------------------------------------------------------


def _faults_module_path() -> Path:
    return Path(__file__).resolve().parent.parent / "utils" / "faults.py"


def _metrics_module_path() -> Path:
    return Path(__file__).resolve().parent.parent / "obs" / "metrics.py"


def _parse_prefixed_constants(path: Path, prefix: str) -> Dict[str, str]:
    """``{ATTR_NAME: "string value"}`` for top-level ``PREFIX_* = "..."``
    assignments — the shared not-imported parsing both registries
    (fault sites, metric names) use, so the linter works on a broken
    tree."""
    tree = ast.parse(path.read_text())
    registry: Dict[str, str] = {}
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id.startswith(prefix)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
        ):
            registry[node.targets[0].id] = node.value.value
    return registry


def fault_site_registry(path: Optional[Path] = None) -> Dict[str, str]:
    """``{SITE_ATTR_NAME: "site.string"}`` parsed from faults.py."""
    return _parse_prefixed_constants(
        path or _faults_module_path(), "SITE_"
    )


def metric_name_registry(path: Optional[Path] = None) -> Dict[str, str]:
    """``{METRIC_ATTR_NAME: "dotted.name"}`` parsed from
    obs/metrics.py — never imported, exactly like the fault sites."""
    return _parse_prefixed_constants(
        path or _metrics_module_path(), "METRIC_"
    )


def _mesh_module_path() -> Path:
    return Path(__file__).resolve().parent.parent / "parallel" / "mesh.py"


def mesh_axis_registry(path: Optional[Path] = None) -> Dict[str, str]:
    """``{AXIS_CONST_NAME: "axis"}`` parsed (never imported) from
    parallel/mesh.py: the top-level ``*_AXIS = "..."`` assignments
    (``DATA_AXIS``, ``MODEL_AXIS``) — the one place axis names exist."""
    tree = ast.parse((path or _mesh_module_path()).read_text())
    registry: Dict[str, str] = {}
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id.endswith("_AXIS")
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
        ):
            registry[node.targets[0].id] = node.value.value
    return registry


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _call_name(func: ast.AST) -> str:
    """Trailing name of a call target: ``faults.maybe_fail`` → maybe_fail."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _names_device(expr: ast.AST) -> bool:
    """A ``.to(...)`` argument that names a device: a ``"cuda..."`` literal,
    ``torch.device(...)``, or a name / attribute spelled like a device."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) and expr.value.startswith("cuda")
    if isinstance(expr, ast.Call):
        return _call_name(expr.func) == "device"
    name = (expr.id if isinstance(expr, ast.Name)
            else expr.attr if isinstance(expr, ast.Attribute) else "")
    return "dev" in name.lower()


def _uses_device(node: ast.AST) -> Optional[ast.AST]:
    """First descendant that does CUDA work (see the module docstring's
    ``device-off-thread``), or None."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == "cuda" and isinstance(
                sub.value, ast.Name) and sub.value.id == "torch":
            return sub
        if isinstance(sub, ast.Name) and sub.id in _WRAPPER_MODULES:
            return sub
        if isinstance(sub, ast.Attribute) and sub.attr in _WRAPPER_MODULES:
            return sub
        if isinstance(sub, (ast.Import, ast.ImportFrom)) and any(
                alias.name.split(".")[-1] in _WRAPPER_MODULES for alias in sub.names):
            return sub
        if not isinstance(sub, ast.Call):
            continue
        if _call_name(sub.func) == "cuda" and isinstance(sub.func, ast.Attribute):
            return sub
        for kw in sub.keywords:
            if kw.arg == "device" and not (
                    isinstance(kw.value, ast.Constant) and kw.value.value in ("cpu", None)):
                return sub
        if (isinstance(sub.func, ast.Attribute) and sub.func.attr == "to" and sub.args
                and _names_device(sub.args[0])):
            return sub
    return None


def _called_local_names(fn: ast.AST) -> Set[str]:
    """Names of functions/methods this function calls that could resolve
    in the same scope: bare ``helper(...)`` and ``self._helper(...)``."""
    out: Set[str] = set()
    for sub in ast.walk(fn):
        if not isinstance(sub, ast.Call):
            continue
        f = sub.func
        if isinstance(f, ast.Name):
            out.add(f.id)
        elif (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id in ("self", "cls")
        ):
            out.add(f.attr)
    return out


def _is_owner_marked(fn: ast.AST, source_lines: Sequence[str]) -> bool:
    """``# lint: device-owner-thread`` on the def line (or the line above)."""
    line = fn.lineno - 1
    for i in (line, line - 1):
        if 0 <= i < len(source_lines) and _OWNER_MARK in source_lines[i]:
            return True
    return False


# ---------------------------------------------------------------------------
# Rule: device-off-thread + thread-join
# ---------------------------------------------------------------------------


def _thread_targets(scope: ast.AST) -> List[Tuple[ast.Call, Optional[str]]]:
    """``threading.Thread(...)`` calls in a scope, with the local name of
    their ``target=`` when resolvable (``self._reader`` / ``reader``)."""
    out = []
    for sub in ast.walk(scope):
        if not isinstance(sub, ast.Call):
            continue
        if _call_name(sub.func) != "Thread":
            continue
        target_name: Optional[str] = None
        for kw in sub.keywords:
            if kw.arg != "target":
                continue
            v = kw.value
            if isinstance(v, ast.Name):
                target_name = v.id
            elif isinstance(v, ast.Attribute) and isinstance(
                v.value, ast.Name
            ) and v.value.id in ("self", "cls"):
                target_name = v.attr
        out.append((sub, target_name))
    return out


def _runtime_submit_targets(
    scope: ast.AST,
) -> List[Tuple[ast.Call, Optional[str], Optional[ast.Lambda]]]:
    """``x.submit("<site>", fn, ...)`` calls — the data-plane runtime's
    task submission (``data/runtime.py``): the callable runs on a pooled
    IO worker, so the device-off-thread rule walks it exactly like a Thread
    target. Matched only when the FIRST argument names a lane — a string
    literal or a ``LANE_*`` constant (``rt.submit(runtime.LANE_READ,
    fn, ...)`` is the production prefetcher's form) — so the serving
    batcher's ``submit(request)`` — data, not a task — never
    false-positives. Returns (call, local name of the submitted fn when
    resolvable, the lambda node when the task is a lambda)."""

    def _is_lane_arg(site: ast.AST) -> bool:
        if isinstance(site, ast.Constant) and isinstance(site.value, str):
            return True
        name = (
            site.id if isinstance(site, ast.Name)
            else site.attr if isinstance(site, ast.Attribute)
            else None
        )
        return name is not None and name.startswith("LANE_")

    out: List[Tuple[ast.Call, Optional[str], Optional[ast.Lambda]]] = []
    for sub in ast.walk(scope):
        if not isinstance(sub, ast.Call) or _call_name(sub.func) != "submit":
            continue
        if len(sub.args) < 2:
            continue
        if not _is_lane_arg(sub.args[0]):
            continue
        tgt = sub.args[1]
        name: Optional[str] = None
        lam: Optional[ast.Lambda] = None
        if isinstance(tgt, ast.Name):
            name = tgt.id
        elif isinstance(tgt, ast.Attribute) and isinstance(
            tgt.value, ast.Name
        ) and tgt.value.id in ("self", "cls"):
            name = tgt.attr
        elif isinstance(tgt, ast.Lambda):
            lam = tgt
        out.append((sub, name, lam))
    return out


def _thread_binding_names(members: Sequence[ast.AST]) -> Set[str]:
    """Names a ``threading.Thread(...)`` result is bound to within a
    scope's members: ``self._thread = Thread(...)`` → ``_thread``,
    ``t = Thread(...)`` → ``t``."""
    out: Set[str] = set()
    for m in members:
        for sub in ast.walk(m):
            if not isinstance(sub, ast.Assign):
                continue
            value = sub.value
            if not (
                isinstance(value, ast.Call)
                and _call_name(value.func) == "Thread"
            ):
                continue
            for target in sub.targets:
                if isinstance(target, ast.Name):
                    out.add(target.id)
                elif isinstance(target, ast.Attribute):
                    out.add(target.attr)
    return out


def _scope_functions(scope: ast.AST) -> Dict[str, ast.AST]:
    """Directly-nested function/method defs of a class or module."""
    body = getattr(scope, "body", [])
    return {
        n.name: n
        for n in body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def _check_thread_rules(
    tree: ast.Module, path: str, source_lines: Sequence[str]
) -> List[Finding]:
    findings: List[Finding] = []
    scopes: List[ast.AST] = [tree] + [
        n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
    ]
    for scope in scopes:
        in_class = isinstance(scope, ast.ClassDef)
        fns = _scope_functions(scope)
        # Class methods' bodies belong to the class scope; the module
        # scope must not double-report what a class scope owns.
        if not in_class:
            members = [
                n for n in tree.body
                if not isinstance(n, ast.ClassDef)
            ]
        else:
            members = scope.body
        threads = []
        submits: List[
            Tuple[ast.Call, Optional[str], Optional[ast.Lambda]]
        ] = []
        for m in members:
            threads.extend(_thread_targets(m))
            submits.extend(_runtime_submit_targets(m))
        if not threads and not submits:
            continue

        # Names threads are bound to in this scope (``self._thread =
        # threading.Thread(...)`` / ``t = Thread(...)``) — a join only
        # counts when called on one of them (or, when no binding is
        # resolvable, on SOME name — never on a string literal:
        # ``", ".join(...)`` must not satisfy the thread contract).
        thread_names = _thread_binding_names(members)

        def _join_receiver_ok(call: ast.Call) -> bool:
            recv = call.func.value if isinstance(
                call.func, ast.Attribute
            ) else None
            if recv is None or isinstance(recv, ast.Constant):
                return False
            name = None
            if isinstance(recv, ast.Name):
                name = recv.id
            elif isinstance(recv, ast.Attribute):
                name = recv.attr
            if thread_names:
                return name in thread_names
            return name is not None

        if threads:
            started = any(
                isinstance(sub, ast.Call)
                and _call_name(sub.func) == "start"
                for m in members
                for sub in ast.walk(m)
            )
            joined = any(
                isinstance(sub, ast.Call)
                and _call_name(sub.func) == "join"
                and _join_receiver_ok(sub)
                for m in members
                for sub in ast.walk(m)
            )
            if started and not joined:
                line = threads[0][0].lineno
                where = (
                    f"class {scope.name}" if in_class else "module scope"
                )
                findings.append(Finding(
                    path, line, "thread-join",
                    f"{where} starts a threading.Thread but never joins "
                    "it — every started thread needs a join on the "
                    "close()/shutdown path (the Prefetcher/"
                    "MicroBatchServer/runtime-lane contract)",
                ))

        # device-off-thread: walk each resolvable worker target (Thread
        # target OR runtime-submitted task) transitively through
        # same-scope helpers.
        targets = [
            (call, name, None) for call, name in threads
        ] + submits
        for call, target_name, lam in targets:
            seen: Set[str] = set()
            if lam is not None:
                if _is_owner_marked(lam, source_lines):
                    continue
                hit = _uses_device(lam)
                if hit is not None:
                    findings.append(Finding(
                        path, getattr(hit, "lineno", lam.lineno),
                        "device-off-thread",
                        f"lambda submitted to an IO worker (submit at "
                        f"line {call.lineno}) does CUDA work — runtime "
                        "workers own disk+numpy only (data/runtime.py "
                        "discipline). Mark the designated owner with "
                        f"`# {_OWNER_MARK}` and its reason if intended",
                    ))
                    continue
                frontier = list(_called_local_names(lam))
            elif target_name is not None and target_name in fns:
                frontier = [target_name]
            else:
                continue
            depth = 0
            while frontier and depth < _CALL_DEPTH:
                nxt: List[str] = []
                for name in frontier:
                    if name in seen or name not in fns:
                        continue
                    seen.add(name)
                    fn = fns[name]
                    if _is_owner_marked(fn, source_lines):
                        # A designated device-owner thread (e.g. the
                        # serving worker that owns its plan's launches).
                        seen.clear()
                        frontier = []
                        nxt = []
                        break
                    hit = _uses_device(fn)
                    if hit is not None:
                        findings.append(Finding(
                            path, getattr(hit, "lineno", fn.lineno),
                            "device-off-thread",
                            f"function {name!r} runs on a background "
                            f"worker (target at line {call.lineno}) "
                            "but does CUDA work — background threads "
                            "and runtime IO workers own disk+numpy "
                            "only (data/prefetch.py + data/runtime.py "
                            "discipline). Mark a designated owner "
                            f"with `# {_OWNER_MARK}` and its reason",
                        ))
                        continue
                    nxt.extend(_called_local_names(fn))
                frontier = nxt
                depth += 1
    return findings


# ---------------------------------------------------------------------------
# Rule: retry-transient
# ---------------------------------------------------------------------------


def _check_retry_rule(tree: ast.Module, path: str) -> List[Finding]:
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _call_name(node.func) != "RetryPolicy":
            continue
        for kw in node.keywords:
            if kw.arg != "transient":
                continue
            for sub in ast.walk(kw.value):
                name = None
                if isinstance(sub, ast.Name):
                    name = sub.id
                elif isinstance(sub, ast.Attribute):
                    name = sub.attr
                if name == "ShardCorrupted":
                    findings.append(Finding(
                        path, node.lineno, "retry-transient",
                        "RetryPolicy transient tuple includes "
                        "ShardCorrupted — checksum corruption is "
                        "persistent state; retrying re-reads the same bad "
                        "bytes and hides the failure (data/durable.py "
                        "invariant)",
                    ))
    return findings


# ---------------------------------------------------------------------------
# Rule: fault-site
# ---------------------------------------------------------------------------


def _check_fault_sites(
    tree: ast.Module, path: str, registry: Dict[str, str]
) -> List[Finding]:
    findings = []
    site_values = set(registry.values())
    site_names = set(registry)

    def check_site_expr(expr: ast.AST, call: ast.Call) -> None:
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            if expr.value not in site_values:
                findings.append(Finding(
                    path, call.lineno, "fault-site",
                    f"fault site {expr.value!r} is not in the faults.py "
                    f"registry {sorted(site_values)} — a typo'd site makes "
                    "the chaos drill a silent no-op",
                ))
        elif isinstance(expr, ast.Attribute) and expr.attr.startswith(
            "SITE_"
        ):
            if expr.attr not in site_names:
                findings.append(Finding(
                    path, call.lineno, "fault-site",
                    f"faults.{expr.attr} is not defined in faults.py "
                    f"(known: {sorted(site_names)})",
                ))

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node.func)
        if name in ("maybe_fail", "corrupt_array") and node.args:
            check_site_expr(node.args[0], node)
        elif name == "FaultRule":
            if node.args:
                check_site_expr(node.args[0], node)
            for kw in node.keywords:
                if kw.arg == "site":
                    check_site_expr(kw.value, node)
    return findings


# ---------------------------------------------------------------------------
# Rule: metric-name
# ---------------------------------------------------------------------------

# Every registry register/lookup door, including the ISSUE-10 mergeable
# bucketed form (the live serving plane's latency store) — a name
# invented at a bucketed_histogram site forks the dashboard namespace
# exactly like the ring form would.
_REGISTRY_METHODS = ("counter", "gauge", "histogram", "bucketed_histogram")


def _check_metric_names(
    tree: ast.Module, path: str, registry: Dict[str, str]
) -> List[Finding]:
    """Every ``*.counter(name, ...)`` / ``*.gauge(...)`` /
    ``*.histogram(...)`` whose first argument is a string literal or a
    ``METRIC_*`` reference must resolve into the parsed catalogue. A
    first argument that is neither (a variable, an f-string) is left
    alone — only literal names can be checked statically, and those are
    the overwhelming call-site form."""
    findings: List[Finding] = []
    names = set(registry)
    values = set(registry.values())
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        # Only attribute calls: bare ``counter(...)`` (e.g. a local
        # helper, itertools.count-style factories) is not a registry
        # lookup; every registry site reads ``<registry>.counter``.
        if not isinstance(node.func, ast.Attribute):
            continue
        if node.func.attr not in _REGISTRY_METHODS:
            continue
        if not node.args:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if arg.value not in values:
                findings.append(Finding(
                    path, node.lineno, "metric-name",
                    f"metric name {arg.value!r} is not in the METRIC_* "
                    "catalogue of keystone_tpu_torch/obs/metrics.py — register "
                    "it there (one place names exist) instead of "
                    "inventing it at the call site",
                ))
        else:
            ref = (
                arg.attr if isinstance(arg, ast.Attribute)
                else arg.id if isinstance(arg, ast.Name)
                else None
            )
            if ref is not None and ref.startswith("METRIC_") \
                    and ref not in names:
                findings.append(Finding(
                    path, node.lineno, "metric-name",
                    f"{ref} is not defined in keystone_tpu_torch/obs/"
                    f"metrics.py (known: {len(names)} catalogue "
                    "entries)",
                ))
    return findings


# ---------------------------------------------------------------------------
# Rule: mesh-axis-name
# ---------------------------------------------------------------------------

# Where the port names an axis: the call's name, the positional slot of its
# axis argument (None: keyword only) and its keyword. ``Mesh`` /
# ``make_mesh`` / ``make_hybrid_mesh`` take a sequence of axis names.
_AXIS_SITES = {
    "shard_map": (None, "axis"),
    "axis_index": (0, "axis"),
    "axis_size": (1, "axis"),
    "shard_rows": (2, "axis"),
    "shard_local_rows": (2, "axis"),
    "axis_devices": (0, "axis"),
    "Mesh": (1, "axis_names"),
    "make_mesh": (1, "axis_names"),
    "make_hybrid_mesh": (2, "axis_names"),
}


def _check_mesh_axis_names(
    tree: ast.Module, path: str, registry: Dict[str, str]
) -> List[Finding]:
    """Every string-literal axis name at an axis site must be one of the
    parsed registry's values; an ``*_AXIS`` constant reference must be
    defined there. Variables and f-strings are left alone: only literals
    can be checked statically, and the rule exists so call sites use the
    constants instead of literals."""
    findings: List[Finding] = []
    values = set(registry.values())
    names = set(registry)

    def check_axis_expr(expr: ast.AST, call: ast.Call) -> None:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                if sub.value not in values:
                    findings.append(Finding(
                        path, call.lineno, "mesh-axis-name",
                        f"mesh axis name {sub.value!r} is not in the "
                        f"parallel/mesh.py registry {sorted(values)} — "
                        "use the DATA_AXIS/MODEL_AXIS constants; a "
                        "typo'd axis reduces over the wrong mesh "
                        "dimension",
                    ))
            elif isinstance(sub, (ast.Name, ast.Attribute)):
                ref = sub.id if isinstance(sub, ast.Name) else sub.attr
                if ref.endswith("_AXIS") and ref not in names:
                    findings.append(Finding(
                        path, call.lineno, "mesh-axis-name",
                        f"{ref} is not defined in parallel/mesh.py "
                        f"(known: {sorted(names)})",
                    ))

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        site = _AXIS_SITES.get(_call_name(node.func))
        if site is None:
            continue
        pos, kwarg = site
        if pos is not None and len(node.args) > pos:
            check_axis_expr(node.args[pos], node)
        for kw in node.keywords:
            if kw.arg == kwarg:
                check_axis_expr(kw.value, node)
    return findings


# ---------------------------------------------------------------------------
# Rule: explicit-seed
# ---------------------------------------------------------------------------

def _is_int_literal(node: Optional[ast.AST]) -> bool:
    # bool is an int subclass; ``seed=True`` is not an explicit seed.
    return (
        isinstance(node, ast.Constant)
        and type(node.value) is int
    )


def _is_seeding_call(call: ast.Call) -> bool:
    """``torch.manual_seed(...)`` or ``<Generator(...)>.manual_seed(...)``
    (a generator made in the same expression, ``torch.Generator`` or a
    bare ``Generator``)."""
    func = call.func
    if not (isinstance(func, ast.Attribute) and func.attr == "manual_seed"):
        return False
    base = func.value
    if isinstance(base, ast.Name):
        return base.id == "torch"
    return isinstance(base, ast.Call) and _call_name(base.func) == "Generator"


def _check_explicit_seed(tree: ast.Module, path: str) -> List[Finding]:
    """Randomized library code must take an explicit integer seed: no
    hardcoded integer-literal seed in ``torch.manual_seed`` /
    ``torch.Generator(...).manual_seed``, and every ``seed`` parameter's
    default (if any) must be an int literal: ``seed=None`` defers the draw
    to an implicit source the caller cannot replay."""
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_seeding_call(node):
            if node.args and _is_int_literal(node.args[0]):
                findings.append(Finding(
                    path, node.lineno, "explicit-seed",
                    f"hardcoded seed literal "
                    f"{ast.literal_eval(node.args[0])!r} at a manual_seed "
                    "call — thread a caller-visible seed parameter instead",
                ))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            pos = list(node.args.posonlyargs) + list(node.args.args)
            defaults = list(node.args.defaults)
            for arg, default in zip(pos[len(pos) - len(defaults):], defaults):
                if arg.arg == "seed" and not _is_int_literal(default):
                    findings.append(Finding(
                        path, node.lineno, "explicit-seed",
                        f"parameter 'seed' of {node.name}() defaults to "
                        "a non-integer — default it to an int literal "
                        "so the draw is replayable",
                    ))
            for arg, default in zip(node.args.kwonlyargs,
                                    node.args.kw_defaults):
                if arg.arg == "seed" and default is not None \
                        and not _is_int_literal(default):
                    findings.append(Finding(
                        path, node.lineno, "explicit-seed",
                        f"parameter 'seed' of {node.name}() defaults to "
                        "a non-integer — default it to an int literal "
                        "so the draw is replayable",
                    ))
    # ast.walk is breadth-first; report in source order.
    return sorted(findings, key=lambda f: f.line)


# ---------------------------------------------------------------------------
# Rule: bench-row
# ---------------------------------------------------------------------------

_ROW_KEYS = {"metric", "value", "detail"}


def _check_bench_rows(tree: ast.Module, path: str) -> List[Finding]:
    findings = []
    # Dict literals inside make_row itself are the one legitimate site.
    allowed: Set[int] = set()
    for node in ast.walk(tree):
        if (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name == "make_row"
        ):
            allowed.update(id(sub) for sub in ast.walk(node))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Dict) or id(node) in allowed:
            continue
        keys = {
            k.value for k in node.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)
        }
        if _ROW_KEYS <= keys:
            findings.append(Finding(
                path, node.lineno, "bench-row",
                "raw bench-row dict literal (metric/value/detail) — build "
                "rows through make_row so the timing convention and "
                "roofline-auditability rules are enforced",
            ))
    return findings


# ---------------------------------------------------------------------------
# decision-event: every *.decision event carries the audit schema
# ---------------------------------------------------------------------------

_DECISION_REQUIRED = ("candidates", "reason", "winner")


def _module_string_constants(tree: ast.Module) -> Dict[str, str]:
    """Top-level ``NAME = "string"`` assignments — how the placement
    engine names its event (``PLACEMENT_EVENT = "placement.decision"``)
    without the linter importing anything."""
    out: Dict[str, str] = {}
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
        ):
            out[node.targets[0].id] = node.value.value
    return out


def _to_args_key_union(tree: ast.Module) -> Set[str]:
    """Union of the string keys any ``to_args`` method in the module
    emits: constant keys of its dict literals plus ``out["k"] = ...``
    subscript stores — the two forms every decision dataclass uses."""
    keys: Set[str] = set()
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.FunctionDef) and node.name == "to_args"
        ):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Dict):
                keys.update(
                    k.value for k in sub.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                )
            elif (
                isinstance(sub, ast.Assign)
                and len(sub.targets) == 1
                and isinstance(sub.targets[0], ast.Subscript)
                and isinstance(sub.targets[0].slice, ast.Constant)
                and isinstance(sub.targets[0].slice.value, str)
            ):
                keys.add(sub.targets[0].slice.value)
    return keys


def _check_decision_events(
    tree: ast.Module, path: str
) -> List[Finding]:
    findings: List[Finding] = []
    consts = _module_string_constants(tree)
    to_args_keys = _to_args_key_union(tree)

    def _event_name(call: ast.Call) -> Optional[str]:
        if _call_name(call.func) != "event" or not call.args:
            return None
        arg = call.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            name = arg.value
        elif isinstance(arg, ast.Name):
            name = consts.get(arg.id)
        else:
            name = None
        if name is None or not name.endswith(".decision"):
            return None
        return name

    def _check_call(call: ast.Call, assigns: Dict[str, ast.AST]) -> None:
        name = _event_name(call)
        if name is None:
            return
        provided: Set[str] = set()
        unresolvable = False
        for kw in call.keywords:
            if kw.arg is not None:
                provided.add(kw.arg)
                continue
            v = kw.value  # a **spread
            if isinstance(v, ast.Call) \
                    and _call_name(v.func) == "to_args":
                provided |= to_args_keys
                continue
            src = assigns.get(v.id) if isinstance(v, ast.Name) else None
            if isinstance(src, ast.Dict) and all(
                isinstance(k, ast.Constant) for k in src.keys
            ):
                provided |= {k.value for k in src.keys}
            elif isinstance(src, ast.Call) \
                    and _call_name(src.func) == "to_args":
                provided |= to_args_keys
            else:
                # A spread the linter cannot see through (e.g. the
                # engine's **context passthrough) could provide
                # anything — static analysis makes no claim.
                unresolvable = True
        missing = [k for k in _DECISION_REQUIRED if k not in provided]
        if missing and not unresolvable:
            findings.append(Finding(
                path, call.lineno, "decision-event",
                f"decision event {name!r} is missing required schema "
                f"key(s) {', '.join(missing)} — every *.decision event "
                "must record its full candidate table, winner and "
                "reason (the audit schema obs/calibrate.py joins and "
                "placement/planner.py replays)",
            ))

    seen: Set[int] = set()
    # Innermost scopes first (ast.walk yields outer before inner), so
    # every emit call is checked against its tightest enclosing
    # function's assignments; the module scope sweeps up the rest.
    fns = [
        node for node in ast.walk(tree)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    scopes: List[Tuple[ast.AST, Dict[str, ast.AST]]] = [
        (fn, {}) for fn in reversed(fns)
    ] + [(tree, {})]
    for scope, assigns in scopes:
        for sub in ast.walk(scope):
            if (
                isinstance(sub, ast.Assign)
                and len(sub.targets) == 1
                and isinstance(sub.targets[0], ast.Name)
            ):
                # Innermost-scope walk runs last and wins, matching
                # Python's name resolution closely enough for the
                # ``rec = decision.to_args()`` emit idiom.
                assigns[sub.targets[0].id] = sub.value
        for sub in ast.walk(scope):
            if isinstance(sub, ast.Call) and id(sub) not in seen:
                if _event_name(sub) is not None:
                    seen.add(id(sub))
                    _check_call(sub, assigns)
    return findings


# ---------------------------------------------------------------------------
# torch-clean-module rule
# ---------------------------------------------------------------------------

_CLEAN_MARK = "lint: torch-clean-module"


def _has_clean_marker(src: str) -> bool:
    return any(
        _CLEAN_MARK in line for line in src.splitlines()[:40]
    )


def _check_torch_clean_module(tree: ast.Module, path: str) -> List[Finding]:
    """Flag EVERY torch import (any scope) in a marked module — see the
    module docstring's ``torch-clean-module`` entry."""
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == "torch":
                    findings.append(Finding(
                        path, node.lineno, "torch-clean-module",
                        f"import {alias.name!r} in a torch-clean module "
                        "— the fleet router process must run without "
                        "torch; move device work into the plane process",
                    ))
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "torch":
                findings.append(Finding(
                    path, node.lineno, "torch-clean-module",
                    f"from {node.module!r} import ... in a torch-clean "
                    "module — the fleet router process must run "
                    "without torch; move device work into the plane "
                    "process",
                ))
    return findings


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

_DISABLE_MARK = "# lint: disable="


def _file_disabled_rules(src: str) -> Set[str]:
    """File-level opt-out: a ``# lint: disable=rule1,rule2`` comment
    anywhere in the file's first 40 lines disables those rules for the
    file. The opt-out is explicit and greppable — e.g. the fault-harness
    unit tests fabricate synthetic site names on purpose."""
    out: Set[str] = set()
    for line in src.splitlines()[:40]:
        idx = line.find(_DISABLE_MARK)
        if idx >= 0:
            spec = line[idx + len(_DISABLE_MARK):].strip()
            out.update(r.strip() for r in spec.split(",") if r.strip())
    return out


def _exempt_from_library_rules(path: Path) -> bool:
    """Tests, scripts and the card's smoke script: outside the library."""
    parts = set(path.parts)
    return (
        "tests" in parts or "scripts" in parts
        or path.name in ("bench.py", "chip_smoke.py", "conftest.py")
        or path.name.startswith("test_")
    )


def lint_file(
    path: Path,
    registry: Optional[Dict[str, str]] = None,
    rules: Optional[Sequence[str]] = None,
    metric_registry: Optional[Dict[str, str]] = None,
    mesh_registry: Optional[Dict[str, str]] = None,
) -> List[Finding]:
    """Lint one file; returns findings (parse failures are findings too —
    a file the linter cannot read is a file nothing checks)."""
    if registry is None:
        registry = fault_site_registry()
    if metric_registry is None:
        metric_registry = metric_name_registry()
    if mesh_registry is None:
        mesh_registry = mesh_axis_registry()
    src = path.read_text()
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(str(path), e.lineno or 0, "parse",
                        f"cannot parse: {e.msg}")]
    enabled = set(rules or RULES) - _file_disabled_rules(src)
    lines = src.splitlines()
    findings: List[Finding] = []
    sp = str(path)
    if {"device-off-thread", "thread-join"} & enabled:
        thread_findings = _check_thread_rules(tree, sp, lines)
        findings.extend(f for f in thread_findings if f.rule in enabled)
    if "retry-transient" in enabled:
        findings.extend(_check_retry_rule(tree, sp))
    if "fault-site" in enabled:
        # faults.py itself defines the registry (and uses site strings in
        # docstrings/constants); skip it.
        if path.name != "faults.py":
            findings.extend(_check_fault_sites(tree, sp, registry))
    if "bench-row" in enabled:
        findings.extend(_check_bench_rows(tree, sp))
    if "metric-name" in enabled:
        # obs/metrics.py itself defines the catalogue; skip it (parity
        # with the faults.py exemption above).
        if not (path.name == "metrics.py" and path.parent.name == "obs"):
            findings.extend(
                _check_metric_names(tree, sp, metric_registry)
            )
    if "mesh-axis-name" in enabled:
        # parallel/mesh.py itself defines the axis registry; skip it
        # (parity with the faults.py / metrics.py exemptions above).
        if not (path.name == "mesh.py" and path.parent.name == "parallel"):
            findings.extend(
                _check_mesh_axis_names(tree, sp, mesh_registry)
            )
    if "explicit-seed" in enabled:
        # Library scope only: the card's smoke script, measurement
        # scripts and the test suite legitimately pin literal demo seeds.
        exempt = _exempt_from_library_rules(path)
        if not exempt:
            findings.extend(_check_explicit_seed(tree, sp))
    if "decision-event" in enabled:
        # Library scope only: the test suite and the scripts fabricate
        # synthetic decision payloads on purpose (same exemption shape
        # as explicit-seed).
        exempt = _exempt_from_library_rules(path)
        if not exempt:
            findings.extend(_check_decision_events(tree, sp))
    if "torch-clean-module" in enabled and _has_clean_marker(src):
        findings.extend(_check_torch_clean_module(tree, sp))
    return findings


def _iter_py(paths: Iterable[Path]) -> Iterable[Path]:
    for p in paths:
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def lint_paths(
    paths: Sequence[Path],
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    registry = fault_site_registry()
    metric_registry = metric_name_registry()
    mesh_registry = mesh_axis_registry()
    findings: List[Finding] = []
    for f in _iter_py(paths):
        if "__pycache__" in f.parts:
            continue
        findings.extend(lint_file(
            f, registry=registry, rules=rules,
            metric_registry=metric_registry,
            mesh_registry=mesh_registry,
        ))
    return findings


def default_paths() -> List[Path]:
    """The enforced surface: the port's package, its tests
    (``tests/test_torch_*.py``), ``chip_smoke.py`` and its measurement
    scripts (``scripts/torch_*.py``)."""
    root = Path(__file__).resolve().parent.parent.parent
    out = [root / "keystone_tpu_torch"]
    out += sorted((root / "tests").glob("test_torch_*.py"))
    if (root / "chip_smoke.py").exists():
        out.append(root / "chip_smoke.py")
    out += sorted((root / "scripts").glob("torch_*.py"))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    paths = [Path(a) for a in args] or default_paths()
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    if findings:
        print(f"{len(findings)} finding(s)")
        return 1
    print("lint clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
