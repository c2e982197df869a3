"""Observability rules (MT-O4xx) — role code reports through obs.

With ``mpit_tpu_torch.obs`` in place, hand-rolled instrumentation in the role
layers (``ps/``, ``ft/``, ``comm/``, plus any ``*client*``/``*server*``
module) is a regression: a ``time.monotonic()`` pair produces a number
nobody exports, and a ``print()`` produces a line nobody can aggregate —
both invisible to the registry snapshot, the Prometheus exposition and
the Chrome trace.  Two rules:

- **MT-O401** — hand-rolled timing: any ``time.time()`` /
  ``time.perf_counter()`` call (role files have no business on the
  wall/bench clocks — deadlines use monotonic arithmetic, durations
  belong to obs spans / ``registry.timer``), or an elapsed-time
  subtraction whose *both* operands derive from clock calls in the same
  scope (``time.monotonic() - t0`` where ``t0`` was read from a clock).
  Deadline arithmetic (``time.monotonic() + ttl``, comparisons,
  ``deadline - time.monotonic()`` remaining-time) is deliberately not
  flagged — bounding a wait is protocol, measuring one is obs's job.
- **MT-O402** — ``print()`` reporting: render from a registry snapshot
  (``Registry.format_summary``) or the module logger instead.
  Deliberate operator output (child-log echo at gang teardown, CLI
  entry points) carries baseline suppressions with reasons.
- **MT-O403** — undocumented metric: every ``mpit_*`` metric name
  instantiated anywhere in the tree (``.counter()`` / ``.gauge()`` /
  ``.histogram()`` / ``.timer()`` with a string-literal name) must
  appear in the tree's ``docs/OBSERVABILITY.md`` catalog — the same
  doc-conformance shape as MT-P502's tag table check.  An instrument
  the catalog doesn't name is invisible to operators reading the doc,
  and dashboards built from the catalog silently miss it.  Trees
  without the doc skip the rule (fixture packages opt in by shipping
  one).
- **MT-O404** — undocumented span phase: every string literal passed to
  the span phase API (``span.mark("...")``) must appear in
  ``docs/OBSERVABILITY.md``'s phase taxonomy (same scan-root-relative
  doc lookup as MT-O403).  The causal analyzer (obs/causal.py) and
  every trace reader key on phase names; a phase the taxonomy doesn't
  list decomposes to nothing and silently skews the attribution.
"""

from __future__ import annotations

import ast
import pathlib
from typing import List, Set, Tuple

from mpit_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    callee_name,
    register_rules,
    root_name,
)

register_rules({
    "MT-O401": ("warn", "hand-rolled clock timing in a role file — use obs "
                        "spans/registry"),
    "MT-O402": ("warn", "print() reporting in a role file — use an obs "
                        "snapshot or the logger"),
    "MT-O403": ("warn", "undocumented mpit_* metric name (missing from "
                        "docs/OBSERVABILITY.md)"),
    "MT-O404": ("warn", "undocumented span phase (missing from the "
                        "docs/OBSERVABILITY.md phase taxonomy)"),
})

_SCOPE_DIRS = {"ps", "ft", "comm"}
_CLOCKS = {"time", "monotonic", "perf_counter"}
_WALL_CLOCKS = {"time", "perf_counter"}


def _in_scope(src: SourceFile) -> bool:
    parts = pathlib.PurePosixPath(src.rel).parts
    if any(p in _SCOPE_DIRS for p in parts[:-1]):
        return True
    stem = src.path.stem.lower()
    return "client" in stem or "server" in stem


def _is_clock_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and callee_name(node) in _CLOCKS
            and isinstance(node.func, ast.Attribute)
            and root_name(node.func) == "time")


def _scopes(tree: ast.Module):
    """(qualname, body-statement list) per function plus the module top
    level; nested defs belong to their own scope."""
    yield "<module>", list(ast.iter_child_nodes(tree))

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield f"{prefix}{child.name}", list(ast.iter_child_nodes(child))
                yield from walk(child, f"{prefix}{child.name}.")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)

    yield from walk(tree, "")


def _walk_shallow(nodes):
    """Walk statements without descending into nested defs (their bodies
    are separate scopes)."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _check_scope(src: SourceFile, qual: str, body,
                 seen: Set[Tuple[str, int]], findings: List[Finding]) -> None:
    clocked: Set[str] = set()
    nodes = list(_walk_shallow(body))
    # Pass 1: names assigned from clock reads (order-free: generators
    # and loops make lexical order unreliable).
    for node in nodes:
        if isinstance(node, ast.Assign) and _is_clock_call(node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    clocked.add(tgt.id)

    def clock_rooted(expr: ast.AST) -> bool:
        return _is_clock_call(expr) or (
            isinstance(expr, ast.Name) and expr.id in clocked)

    def emit(rule: str, node: ast.AST, msg: str) -> None:
        key = (rule, node.lineno)
        if key not in seen:
            seen.add(key)
            findings.append(src.finding(rule, node, msg))

    for node in nodes:
        if _is_clock_call(node) and callee_name(node) in _WALL_CLOCKS:
            emit("MT-O401", node,
                 f"{qual} reads time.{callee_name(node)}() in a role file — "
                 "wall/bench clocks are hand-rolled timing; route durations "
                 "through mpit_tpu_torch.obs (spans or registry.timer)")
        elif (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)
                and clock_rooted(node.left) and clock_rooted(node.right)):
            emit("MT-O401", node,
                 f"{qual} computes an elapsed time by subtracting clock "
                 "reads — use an obs span or registry.timer so the "
                 "measurement reaches the registry/trace")
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "print"):
            emit("MT-O402", node,
                 f"{qual} reports via print() in a role file — render from "
                 "an obs registry snapshot (format_summary/exposition) or "
                 "the module logger")


_METRIC_FACTORIES = {"counter", "gauge", "histogram", "timer"}


def _find_catalog(files: List[SourceFile]) -> "str | None":
    """The tree's docs/OBSERVABILITY.md, located scan-root-relative the
    same way MT-P502 finds PROTOCOL.md (<root>/docs or <root>/../docs —
    never an upward walk, so a fixture tree can't accidentally validate
    against the real repo's catalog)."""
    for src in files:
        rel = pathlib.PurePosixPath(src.rel)
        root = src.path
        for _ in range(len(rel.parts)):
            root = root.parent
        for base in (root, root.parent):
            candidate = base / "docs" / "OBSERVABILITY.md"
            if candidate.is_file():
                return candidate.read_text()
        return None  # one scan root for every file
    return None


def _check_metric_catalog(files: List[SourceFile],
                          findings: List[Finding]) -> None:
    """MT-O403: every instantiated mpit_* metric name must appear in the
    catalog.  Whole-tree scope (metrics live in comm/aio/shardctl too,
    not just role files); one finding per (file, name)."""
    import re

    doc = _find_catalog(files)
    if doc is None:
        return
    seen: Set[Tuple[str, str]] = set()
    for src in files:
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _METRIC_FACTORIES
                    and node.args):
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)
                    and arg.value.startswith("mpit_")):
                continue
            key = (src.rel, arg.value)
            if key in seen:
                continue
            seen.add(key)
            if not re.search(rf"\b{re.escape(arg.value)}\b", doc):
                findings.append(src.finding(
                    "MT-O403", node,
                    f"metric {arg.value} is instantiated here but absent "
                    "from the docs/OBSERVABILITY.md catalog — every "
                    "mpit_* instrument must carry a catalog row"))


def _check_phase_catalog(files: List[SourceFile],
                         findings: List[Finding]) -> None:
    """MT-O404: every span-phase literal (``.mark("phase")``) must
    appear in the docs/OBSERVABILITY.md phase taxonomy.  Whole-tree
    scope like MT-O403 (spans are marked from ps/, ft/ and shardctl
    call sites alike); one finding per (file, phase)."""
    import re

    doc = _find_catalog(files)
    if doc is None:
        return
    seen: Set[Tuple[str, str]] = set()
    for src in files:
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "mark"
                    and len(node.args) == 1
                    and not node.keywords):
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue
            key = (src.rel, arg.value)
            if key in seen:
                continue
            seen.add(key)
            if not re.search(rf"\b{re.escape(arg.value)}\b", doc):
                findings.append(src.finding(
                    "MT-O404", node,
                    f"span phase {arg.value!r} is marked here but absent "
                    "from the docs/OBSERVABILITY.md phase taxonomy — the "
                    "causal analyzer and trace readers key on phase "
                    "names, so every mark() literal must carry a "
                    "taxonomy row"))


def check(files: List[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for src in files:
        if not _in_scope(src):
            continue
        seen: Set[Tuple[str, int]] = set()
        for qual, body in _scopes(src.tree):
            _check_scope(src, qual, body, seen, findings)
    _check_metric_catalog(files, findings)
    _check_phase_catalog(files, findings)
    return findings
