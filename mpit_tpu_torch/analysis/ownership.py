"""MT-D9xx — buffer ownership across the in-place apply seam.

The bug class, from the JAX package (its PR 13): a server's apply reads
its grad argument through a zero-copy alias of host memory.  If the
caller passes a view into a receive ring (``as_bytes_view`` /
``frombuffer`` / ``split_wire``), the apply reads memory the socket loop
is already overwriting — flaky garbage that only shows up under load.
The port does not donate buffers, but the hazard is the same one turned
around: ``torch.from_numpy`` aliases host memory, and kernel K3 (and
every port rule) writes the shard *in place*.  So a borrowed wire or
pool buffer must never become a tensor that is then applied from or
written in place; the seams (``_on_device``/``_owned`` in ps/server.py,
``copy_`` into the slot in dplane/hbm.py, ``device_copy``) copy it
first, and this module makes them machine-checked instead of
conventional.

A small ownership lattice is evaluated over the shared call graph
(mpit_tpu_torch.analysis.callgraph) at every *declared* sink (the
OwnedSink/OwnedPath/DonatedSlot rows in
mpit_tpu_torch.analysis.disciplines):

- **OWNED** — freshly allocated or explicitly copied: ``_chunk_owned``,
  ``device_copy``, ``np.array/empty/zeros/...``, ``.copy()``,
  ``.clone()``, ``.to(..., copy=True)``, or a same-file helper all of
  whose returns classify OWNED.
- **UNOWNED** — a view into memory someone else recycles:
  ``as_bytes_view``, ``frombuffer``, ``memoryview``, ``split_wire``,
  or ``.view()`` / ``torch.from_numpy`` / ``.to(device)`` of a
  non-owned base (each may alias it).
- **UNKNOWN** — a parameter, attribute or expression the lattice cannot
  classify.  At a declared sink, UNKNOWN is still a finding: the
  registry says this path must be *provably* owned.

Rules: **MT-D901** an UNOWNED buffer reaches a declared apply argument;
**MT-D902** a reader of a shard slot hands out the bare device buffer
outside any materialize/copy call; **MT-D903** the declared ownership
wrapper is dropped (an OwnedPath inner call escapes its wrapper, or a
sink argument classifies UNKNOWN).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set, Tuple

from mpit_tpu_torch.analysis import callgraph, disciplines
from mpit_tpu_torch.analysis.core import (ERROR, Finding, SourceFile,
                                          callee_name, register_rules)

register_rules({
    "MT-D901": (ERROR, "unowned buffer view reaches a declared apply"),
    "MT-D902": (ERROR, "shard slot read without materialize guard"),
    "MT-D903": (ERROR, "ownership wrapper dropped on a declared owned path"),
})

OWNED, UNOWNED, UNKNOWN = "owned", "unowned", "unknown"

#: calls that hand back freshly owned memory.
_OWNING_CALLS = {
    "_chunk_owned", "device_copy", "_device_copy", "copy", "deepcopy",
    "empty", "zeros", "ones", "full", "array", "arange", "concatenate",
    "stack", "empty_like", "zeros_like", "ones_like", "full_like",
    "frombuffer_copy", "tobytes", "clone",
}
#: calls that alias recycled memory (the receive-ring producers).
_UNOWNED_CALLS = {
    "as_bytes_view", "frombuffer", "memoryview", "getbuffer", "split_wire",
}
#: ownership-transparent calls: classify their first argument.
_PASSTHROUGH_CALLS = {"asarray", "ascontiguousarray", "place_flat",
                      "from_numpy", "as_tensor"}
#: ownership-transparent methods: classify their receiver (``x.copy_(y)``
#: returns ``x``; ``.to(device)`` without ``copy=True`` may return it).
_PASSTHROUGH_METHODS = {"view", "reshape", "ravel", "squeeze", "astype",
                        "to", "contiguous", "detach", "flatten", "copy_"}


def _copies(call: ast.Call) -> bool:
    """``.to(..., copy=True)``: fresh storage whatever the source."""
    return (callee_name(call) == "to" and any(
        k.arg == "copy" and isinstance(k.value, ast.Constant)
        and k.value.value is True for k in call.keywords))


def _combine(states: Sequence[str]) -> str:
    if any(s == UNOWNED for s in states):
        return UNOWNED
    if states and all(s == OWNED for s in states):
        return OWNED
    return UNKNOWN


def _resolve(graph: callgraph.CallGraph, fn: callgraph.FnInfo,
             call: ast.Call) -> List[callgraph.FnInfo]:
    """Same-file resolution for a raw ast.Call (mirrors
    CallGraph.resolve's bare/self/cls receiver rule)."""
    func = call.func
    if isinstance(func, ast.Name):
        receiver = ""
    elif isinstance(func, ast.Attribute):
        if not (isinstance(func.value, ast.Name)
                and func.value.id in ("self", "cls")):
            return []
        receiver = func.value.id
    else:
        return []
    del receiver
    name = callee_name(call)
    return graph.by_file.get(fn.src.rel, {}).get(name or "", [])


def classify(expr: ast.AST, fn: callgraph.FnInfo,
             graph: callgraph.CallGraph,
             _seen: Optional[Set[Tuple[int, int]]] = None
             ) -> Tuple[str, str]:
    """(state, why) for an expression evaluated inside ``fn``."""
    seen = _seen if _seen is not None else set()
    key = (id(fn.node), id(expr))
    if key in seen:
        return UNKNOWN, "recursive binding"
    seen.add(key)
    try:
        return _classify(expr, fn, graph, seen)
    finally:
        # a guard on the current path only: two uses of one binding
        # (``parts[0] if c else parts``) each classify it
        seen.discard(key)


def _classify(expr: ast.AST, fn: callgraph.FnInfo,
              graph: callgraph.CallGraph, seen: Set[Tuple[int, int]]
              ) -> Tuple[str, str]:

    if isinstance(expr, ast.Call):
        name = callee_name(expr) or ""
        if name in _UNOWNED_CALLS:
            return UNOWNED, f"{name}() view (line {expr.lineno})"
        if name in _OWNING_CALLS or _copies(expr):
            return OWNED, f"{name}() copy"
        if name in _PASSTHROUGH_CALLS:
            if expr.args:
                state, why = classify(expr.args[0], fn, graph, seen)
                return state, f"{name}() of {why}"
            return UNKNOWN, f"{name}() without arguments"
        if (name in _PASSTHROUGH_METHODS
                and isinstance(expr.func, ast.Attribute)):
            state, why = classify(expr.func.value, fn, graph, seen)
            return state, f".{name}() of {why}"
        targets = _resolve(graph, fn, expr)
        if targets:
            states, whys = [], []
            for target in targets:
                if not target.returns:
                    return UNKNOWN, f"{name}() returns nothing trackable"
                for ret in target.returns:
                    state, why = classify(ret, target, graph, seen)
                    states.append(state)
                    whys.append(why)
            return _combine(states), f"{name}() -> {whys[0]}"
        return UNKNOWN, f"call to {name}() (line {expr.lineno})"

    if isinstance(expr, ast.Name):
        if expr.id in fn.params:
            return UNKNOWN, f"parameter '{expr.id}'"
        bindings = fn.assigns.get(expr.id)
        if bindings:
            states, whys = [], []
            for value in bindings:
                state, why = classify(value, fn, graph, seen)
                states.append(state)
                whys.append(why)
            bad = next((w for s, w in zip(states, whys) if s == UNOWNED),
                       whys[0])
            return _combine(states), f"'{expr.id}' = {bad}"
        return UNKNOWN, f"unbound name '{expr.id}'"

    if isinstance(expr, (ast.List, ast.Tuple)):
        if not expr.elts:
            return OWNED, "empty literal"
        states, whys = zip(*(classify(e, fn, graph, seen)
                             for e in expr.elts))
        return _combine(states), whys[0]

    if isinstance(expr, (ast.ListComp, ast.GeneratorExp)):
        state, why = classify(expr.elt, fn, graph, seen)
        return state, f"comprehension of {why}"

    if isinstance(expr, ast.IfExp):
        states, whys = zip(*(classify(e, fn, graph, seen)
                             for e in (expr.body, expr.orelse)))
        return _combine(states), whys[0]

    if isinstance(expr, ast.Starred):
        return classify(expr.value, fn, graph, seen)

    if isinstance(expr, ast.Attribute):
        try:
            return UNKNOWN, f"attribute {ast.unparse(expr)}"
        except Exception:  # pragma: no cover
            return UNKNOWN, "attribute"

    if isinstance(expr, ast.Subscript):
        # a slice/index of any array is a view of it: as owned as its base
        # (an element of a list of owned copies is one of them)
        state, why = classify(expr.value, fn, graph, seen)
        return state, f"subscript of {why}"

    return UNKNOWN, type(expr).__name__


# -- MT-D901 / MT-D903 at declared sinks -------------------------------------


def sink_sites(graph: callgraph.CallGraph, sink: "disciplines.OwnedSink"
               ) -> List[Tuple[callgraph.FnInfo, callgraph.CallSite]]:
    return [(fn, cs)
            for fn in graph.functions_in(sink.file)
            if not sink.fn or fn.name == sink.fn
            for cs in fn.calls
            if cs.callee == sink.callee
            and sink.receiver.lower() in cs.receiver.lower()
            and len(cs.node.args) > sink.arg]


def sink_findings(graph: callgraph.CallGraph, sink: "disciplines.OwnedSink"
                  ) -> List[Finding]:
    findings = []
    for fn, cs in sink_sites(graph, sink):
        state, why = classify(cs.node.args[sink.arg], fn, graph)
        if state == UNOWNED:
            findings.append(fn.src.finding(
                "MT-D901", cs.line,
                f"{fn.qual} passes an unowned buffer ({why}) as argument "
                f"{sink.arg} of {sink.callee}() at the declared ownership "
                f"seam '{sink.name}' — the apply aliases it while the "
                f"receive path recycles it; copy it first (_on_device(), "
                f"device_copy(), .to(..., copy=True))"))
        elif state == UNKNOWN:
            findings.append(fn.src.finding(
                "MT-D903", cs.line,
                f"{fn.qual} drops the ownership wrapper at the declared "
                f"seam '{sink.name}': argument {sink.arg} of "
                f"{sink.callee}() ({why}) cannot be proven owned — route "
                f"it through a copy (_on_device(), device_copy(), "
                f".to(..., copy=True))"))
    return findings


# -- MT-D903 on declared wrapper paths ---------------------------------------


def _inner_calls(fn: callgraph.FnInfo, inner: str, wrapper: str
                 ) -> List[Tuple[ast.Call, bool]]:
    """(inner call, wrapped?) for every ``inner(...)`` in ``fn``:
    wrapped means some enclosing Call's terminal name is ``wrapper``."""
    out = []

    def visit(node: ast.AST, enclosing: Tuple[str, ...]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, ast.Call):
            name = callee_name(node) or ""
            if name == inner:
                out.append((node, wrapper in enclosing))
            enclosing = enclosing + (name,)
        for child in ast.iter_child_nodes(node):
            visit(child, enclosing)

    for child in ast.iter_child_nodes(fn.node):
        visit(child, ())
    return out


def path_sites(graph: callgraph.CallGraph, path: "disciplines.OwnedPath"
               ) -> List[Tuple[callgraph.FnInfo, ast.Call, bool]]:
    return [(fn, call, wrapped)
            for fn in graph.functions_in(path.file, path.fn)
            for call, wrapped in _inner_calls(fn, path.inner, path.wrapper)]


def path_findings(graph: callgraph.CallGraph, path: "disciplines.OwnedPath"
                  ) -> List[Finding]:
    return [fn.src.finding(
        "MT-D903", call.lineno,
        f"{fn.qual} calls {path.inner}() outside the declared "
        f"{path.wrapper}() wrapper of owned path '{path.name}' — the "
        f"result aliases host memory that enters the in-place apply "
        f"chain; {path.doc}")
        for fn, call, wrapped in path_sites(graph, path) if not wrapped]


# -- MT-D902 on shard slot readers -------------------------------------------


def slot_fns(graph: callgraph.CallGraph, slot: "disciplines.DonatedSlot"
             ) -> List[callgraph.FnInfo]:
    return [fn for name in slot.fns
            for fn in graph.functions_in(slot.file, name)]


def slot_findings(graph: callgraph.CallGraph, slot: "disciplines.DonatedSlot"
                  ) -> List[Finding]:
    findings = []
    for fn in slot_fns(graph, slot):

        def visit(node: ast.AST, in_call: bool) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.ctx, ast.Load)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr in slot.attrs
                    and not in_call):
                findings.append(fn.src.finding(
                    "MT-D902", node.lineno,
                    f"{fn.qual} uses the shard slot self.{node.attr} "
                    f"outside any materialize/copy call (discipline "
                    f"'{slot.name}') — the next in-place apply rewrites "
                    f"it under the exposed reference; copy it (.clone(), "
                    f".to(\"cpu\", copy=True)) before it escapes"))
            inside = in_call or isinstance(node, ast.Call)
            for child in ast.iter_child_nodes(node):
                visit(child, inside)

        for child in ast.iter_child_nodes(fn.node):
            visit(child, False)
    return findings


# -- engine entry ------------------------------------------------------------


def check(files: Sequence[SourceFile],
          graph: Optional[callgraph.CallGraph] = None) -> List[Finding]:
    if graph is None:
        graph = callgraph.build_graph(files)
    findings: List[Finding] = []
    retired = [entry for entry, _ in disciplines.RETIRED]
    for sink in (*disciplines.SINKS, *retired):
        if isinstance(sink, disciplines.OwnedSink):
            findings += sink_findings(graph, sink)
    for path in (*disciplines.PATHS, *retired):
        if isinstance(path, disciplines.OwnedPath):
            findings += path_findings(graph, path)
    for slot in disciplines.SLOTS:
        findings += slot_findings(graph, slot)
    return findings
