"""Torch hot-path rules (MT-T3xx) — keep the port's step functions on the card.

The counterpart of the JAX package's MT-J3xx.  The port has no ``jit``:
what XLA traced there runs eagerly here, so the hot set is declared or
found by shape instead.  A function is **hot** when

1. a ``torch.cuda.graph(...)`` capture runs it (the calls in the
   ``with`` body), or ``make_graphed_callables`` wraps it;
2. it is ``forward``/``backward`` of a ``torch.autograd.Function``
   subclass in a file under ``ops/``;
3. it is declared in :data:`HOT_PATHS` (rel-path suffix and qualname) —
   the step functions around kernels K1-K5;

plus every function a hot function calls, followed through same-file
helpers as MT-C2xx follows them (:mod:`mpit_tpu_torch.analysis.callgraph`;
generators and calls through other receivers are not followed, nor
helpers whose name marks deliberate host or timing code —
``host|snapshot|tim|bench``, the device plane's exemption below — which
a hot function may only reach on a host input).  The capture's ``with``
body is itself checked as a hot region.  Inside a hot
function:

- **MT-T301** (error, ↔ J301) — a host sync: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``.synchronize()`` (``torch.cuda``, a stream or an event),
  ``np.asarray``/``np.array`` of a non-literal, and ``float()``/
  ``int()``/``bool()`` of an expression rooted at a ``torch.`` call or a
  tensor method chain (``float(cfg.l2wd)`` reads a config scalar and is
  not one).  Each waits for the card; inside a CUDA-graph capture it
  fails the capture.
- **MT-T302** (warn, ↔ J302) — an ``if``/``while`` whose test calls a
  concretizing ``torch.*`` function, a tensor's ``.any()``/``.all()``/
  ``.item()``, or compares a tensor expression: the branch reads the
  value back to the host (a sync), and a graph replays one branch
  forever.  Use ``torch.where`` or keep the decision on the host.
- **MT-T303** (info, ↔ J303) — an update-shaped hot function (name
  matching ``update|step|train|apply``) rebinds a parameter out of place
  (``w = w - lr * g``) and returns it: a fresh buffer every step, where
  the in-place forms (``sub_``, ``out=``, ``_foreach_*_``, the K
  kernels) keep the state's storage — and a CUDA graph's captured
  addresses — fixed.

Device-plane hygiene (MT-T31x, ↔ J31x) — files under ``dplane/`` keep
shards on the card; functions whose name matches
``apply|exchange|push|pull|sync|grad|submit|service|execute``, except
deliberate host or timing code (``host|snapshot|tim|bench``):

- **MT-T311** — host materialization: ``.cpu()``, ``.numpy()``,
  ``.tolist()``, ``.item()``, ``.to("cpu")``, and ``np.asarray``/
  ``np.array``/``np.frombuffer``/``np.copyto``.
- **MT-T312** — a blocking device sync: ``.synchronize()`` — a barrier
  belongs in timing code only; the exchange overlaps by not fencing.

The rules read source; the card's own check is chip_smoke.py's sync
audit, which calls every :data:`HOT_PATHS` entry under
``torch.cuda.set_sync_debug_mode("error")``.
"""

from __future__ import annotations

import ast
import pathlib
import re
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Set, Tuple

from mpit_tpu_torch.analysis import callgraph
from mpit_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    callee_name,
    register_rules,
    root_name,
)

register_rules({
    "MT-T301": ("error", "host sync inside a hot function"),
    "MT-T302": ("warn", "Python branch on a tensor value inside a hot "
                        "function"),
    "MT-T303": ("info", "hot update/step function rebinds its state out "
                        "of place"),
    "MT-T311": ("warn", "host materialization on a dplane hot path"),
    "MT-T312": ("warn", "blocking device sync on a dplane hot path"),
})


# -- the declared hot table --------------------------------------------------


@dataclass(frozen=True)
class HotPath:
    """One declared hot function: ``qual`` (as ``core.iter_functions``
    spells it, ``Class.method`` or ``outer.inner``) in files whose rel
    path ends with ``file``."""
    file: str
    qual: str
    doc: str = ""

    @property
    def name(self) -> str:
        return self.qual


#: The step functions around the kernels.  The parameter-server shells'
#: wire copies (optim/shells.py, optim/downpour.py, EAMSGD.start/step's
#: host mirrors) are the wire by design and stay out of the table, as the
#: JAX shells' copies stay outside ``jit``.
HOT_PATHS: Tuple[HotPath, ...] = (
    HotPath("parallel/easgd.py", "MeshEASGD.step",
            doc="the on-mesh EASGD step (K1 commits), uncaptured and as the "
                "device loop's captured epoch body"),
    HotPath("optim/msgd.py", "msgd_lookahead",
            doc="Nesterov lookahead, in place"),
    HotPath("optim/msgd.py", "msgd_commit",
            doc="the commit: K1 with momentum, the EASGD retract riding it"),
    HotPath("optim/msgd.py", "msgd_step",
            doc="lookahead, gradient, commit"),
    HotPath("optim/easgd.py", "elastic_step",
            doc="EAMSGD's elastic difference on the card (K2 when the "
                "local rate is 0)"),
    HotPath("optim/rules.py", "adam_apply",
            doc="the servers' Adam rule: the bias correction on the card, "
                "then K3"),
    HotPath("dplane/hbm.py", "HbmSlot.apply_wire",
            doc="a device-resident shard's apply of one wire frame (K3 "
                "under Adam)"),
    HotPath("train/lm_launch.py", "build_step.train_step",
            doc="one LM step: K4 forward, K5 (or K6) backward, K1 commit"),
)


# -- shapes ------------------------------------------------------------------

_NP_ROOTS = {"np", "numpy", "onp"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_UPDATE_NAME = re.compile(r"update|step|train|apply", re.IGNORECASE)
#: names that mark deliberate host or timing code
_HOST_CODE = re.compile(r"host|snapshot|tim|bench", re.IGNORECASE)
#: methods that return a tensor when called on one: an expression ending
#: in one of these is a tensor (``loss.detach()``, ``x.sum()``).
_TENSOR_METHODS = {
    "sum", "mean", "max", "min", "amax", "amin", "norm", "abs", "sqrt",
    "exp", "log", "prod", "std", "var", "any", "all", "detach", "clone",
    "float", "double", "half", "bfloat16", "to", "reshape", "view",
    "flatten", "squeeze", "unsqueeze", "contiguous", "dot", "matmul",
    "isnan", "isinf", "isfinite", "eq", "ne", "gt", "ge", "lt", "le",
    "count_nonzero", "argmax", "argmin", "square", "pow", "neg", "sub",
    "add", "mul", "div", "clamp",
}
#: ``torch.*`` calls that read no tensor value: predicates on metadata,
#: configuration and constructors of descriptors.
_TORCH_HOST_PREFIXES = ("is_", "are_", "get_")
_TORCH_HOST_NAMES = {"device", "dtype", "Size", "finfo", "iinfo",
                     "device_count", "current_device", "current_stream"}


def _is_cpu_target(call: ast.Call) -> bool:
    """``.to("cpu")`` / ``.to(device="cpu")`` / ``.to(torch.device("cpu"))``."""
    def cpu(e: ast.AST) -> bool:
        if isinstance(e, ast.Constant) and e.value == "cpu":
            return True
        return (isinstance(e, ast.Call) and callee_name(e) == "device"
                and bool(e.args) and cpu(e.args[0]))
    return (callee_name(call) == "to" and isinstance(call.func, ast.Attribute)
            and (any(cpu(a) for a in call.args[:1])
                 or any(k.arg == "device" and cpu(k.value)
                        for k in call.keywords)))


def _torch_rooted_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and root_name(node.func) == "torch")


def _reads_value(call: ast.Call) -> bool:
    """A ``torch.*`` call whose result depends on tensor values."""
    name = callee_name(call) or ""
    return not (name.startswith(_TORCH_HOST_PREFIXES)
                or name in _TORCH_HOST_NAMES)


def tensor_expr(e: ast.AST) -> bool:
    """Is ``e`` rooted at a ``torch.`` call or a tensor method chain?"""
    if isinstance(e, ast.Call):
        if _torch_rooted_call(e):
            return _reads_value(e)
        return (isinstance(e.func, ast.Attribute)
                and e.func.attr in _TENSOR_METHODS)
    if isinstance(e, ast.Subscript):
        return tensor_expr(e.value)
    if isinstance(e, ast.BinOp):
        return tensor_expr(e.left) or tensor_expr(e.right)
    if isinstance(e, ast.UnaryOp):
        return tensor_expr(e.operand)
    return False


def _test_concretizes(test: ast.AST) -> bool:
    if tensor_expr(test):
        return True
    for node in ast.walk(test):
        if isinstance(node, ast.Call):
            if _torch_rooted_call(node) and _reads_value(node):
                return True
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("any", "all", "item")):
                return True
        elif isinstance(node, ast.Compare):
            if any(tensor_expr(o) for o in [node.left, *node.comparators]):
                return True
    return False


def _walk_own_body(nodes) -> Iterator[ast.AST]:
    """Walk statements without descending into nested defs (a nested
    helper is hot only when a hot body calls it)."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _literal(e: ast.AST) -> bool:
    if isinstance(e, ast.Constant):
        return True
    if isinstance(e, (ast.List, ast.Tuple)):
        return all(_literal(x) for x in e.elts)
    return False


def _sync_reason(node: ast.Call) -> Optional[str]:
    """Why this call is a host sync, or None."""
    name = callee_name(node)
    is_method = isinstance(node.func, ast.Attribute)
    if is_method and name in _SYNC_METHODS:
        return f".{name}() reads the tensor back to the host"
    if is_method and name == "synchronize":
        return f"{ast.unparse(node.func)}() waits for the card"
    if _is_cpu_target(node):
        return ".to(\"cpu\") copies the tensor to the host"
    if (is_method and name in ("asarray", "array")
            and root_name(node.func) in _NP_ROOTS and node.args
            and not _literal(node.args[0])):
        return f"{ast.unparse(node.func)}() materializes a tensor on the host"
    if (isinstance(node.func, ast.Name) and name in ("float", "int", "bool")
            and node.args and tensor_expr(node.args[0])):
        return f"{name}() of a tensor expression reads its value"
    return None


# -- hot-set discovery -------------------------------------------------------


@dataclass
class HotRegion:
    """A checked region: a function (``fn``) or a capture's ``with`` body
    (``fn`` is the enclosing function, ``nodes`` the body statements)."""
    src: SourceFile
    qual: str
    nodes: List[ast.AST]
    why: str
    fn: Optional[callgraph.FnInfo] = None


def _is_graph_capture(item: ast.withitem) -> bool:
    e = item.context_expr
    return (isinstance(e, ast.Call) and callee_name(e) == "graph"
            and root_name(e.func) == "torch")


def _captures(graph: callgraph.CallGraph):
    """(enclosing fn, with node) for every ``torch.cuda.graph`` capture."""
    for fn in graph.functions:
        for node in _walk_own_body(ast.iter_child_nodes(fn.node)):
            if (isinstance(node, (ast.With, ast.AsyncWith))
                    and any(_is_graph_capture(i) for i in node.items)):
                yield fn, node


def _graphed_callables(graph: callgraph.CallGraph):
    """Functions handed to ``make_graphed_callables`` (same file)."""
    for fn in graph.functions:
        for cs in fn.calls:
            if cs.callee != "make_graphed_callables" or not cs.node.args:
                continue
            arg = cs.node.args[0]
            names = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]
            for n in names:
                if isinstance(n, ast.Name):
                    yield fn, cs, graph.by_file.get(fn.src.rel, {}).get(n.id, [])


def _autograd_functions(graph: callgraph.CallGraph):
    """forward/backward of ``torch.autograd.Function`` subclasses under ops/."""
    for rel, index in graph.by_file.items():
        if "ops" not in pathlib.PurePosixPath(rel).parts[:-1]:
            continue
        for fns in index.values():
            for fn in fns:
                if fn.name not in ("forward", "backward") or "." not in fn.qual:
                    continue
                cls = fn.qual.rsplit(".", 1)[0]
                if cls in _function_classes(fn.src):
                    yield fn


def _function_classes(src: SourceFile) -> Set[str]:
    out = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.ClassDef) and any(
                (isinstance(b, ast.Attribute) and b.attr == "Function")
                or (isinstance(b, ast.Name) and b.id == "Function")
                for b in node.bases):
            out.add(node.name)
    return out


def declared_sites(graph: callgraph.CallGraph, entry: HotPath
                   ) -> List[callgraph.FnInfo]:
    """The functions one HOT_PATHS entry names (none: a stale entry)."""
    return [fn for fn in graph.functions_in(entry.file)
            if fn.qual == entry.qual]


def hot_regions(graph: callgraph.CallGraph,
                hot_paths: Sequence[HotPath] = HOT_PATHS,
                discover: bool = True) -> List[HotRegion]:
    """Every hot region of the tree, each function once (first reason wins),
    in a stable order.  ``discover=False`` takes only ``hot_paths`` and
    what they call (one table row's coverage)."""
    roots: List[Tuple[callgraph.FnInfo, str]] = []
    regions: List[HotRegion] = []
    for fn, with_node in (_captures(graph) if discover else ()):
        regions.append(HotRegion(fn.src, f"{fn.qual}<graph capture:"
                                 f"{with_node.lineno}>", list(with_node.body),
                                 "captured by torch.cuda.graph", fn))
        for cs in fn.calls:
            if with_node.lineno <= cs.line <= with_node.end_lineno:
                roots += [(t, f"called from the capture in {fn.qual}")
                          for t in graph.resolve(fn, cs)]
    for fn, cs, targets in (_graphed_callables(graph) if discover else ()):
        roots += [(t, f"graphed by make_graphed_callables in {fn.qual}")
                  for t in targets]
    roots += [(fn, "autograd.Function under ops/")
              for fn in (_autograd_functions(graph) if discover else ())]
    for entry in hot_paths:
        roots += [(fn, f"declared in HOT_PATHS ({entry.doc})")
                  for fn in declared_sites(graph, entry)]

    seen: Set[callgraph.FnInfo] = set()
    stack = list(reversed(roots))
    ordered: List[Tuple[callgraph.FnInfo, str]] = []
    while stack:
        fn, why = stack.pop()
        if fn in seen or fn.is_generator:
            continue
        seen.add(fn)
        ordered.append((fn, why))
        for cs in fn.calls:
            for target in graph.resolve(fn, cs):
                if target not in seen and not _HOST_CODE.search(target.name):
                    stack.append((target, f"called by hot {fn.qual}"))
    for fn, why in ordered:
        regions.append(HotRegion(fn.src, fn.qual,
                                 list(ast.iter_child_nodes(fn.node)), why, fn))
    return regions


# -- the checks --------------------------------------------------------------


def _params(fn: ast.AST) -> Set[str]:
    args = getattr(fn, "args", None)
    if args is None:
        return set()
    return {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}


def _returned_names(nodes) -> Set[str]:
    out: Set[str] = set()
    for node in _walk_own_body(nodes):
        if isinstance(node, ast.Return) and node.value is not None:
            vals = (node.value.elts if isinstance(node.value, ast.Tuple)
                    else [node.value])
            out |= {v.id for v in vals if isinstance(v, ast.Name)}
    return out


def _out_of_place(value: ast.AST, name: str) -> bool:
    """``name op ...`` or ``torch.f(name, ...)`` without ``out=``."""
    def mentions(e):
        return any(isinstance(n, ast.Name) and n.id == name
                   for n in ast.walk(e))
    if isinstance(value, ast.BinOp):
        return mentions(value)
    if _torch_rooted_call(value):
        fname = callee_name(value) or ""
        return (not fname.endswith("_")
                and not any(k.arg == "out" for k in value.keywords)
                and any(mentions(a) for a in value.args))
    return False


def check_region(region: HotRegion) -> List[Finding]:
    src, qual = region.src, region.qual
    findings: List[Finding] = []
    for node in _walk_own_body(region.nodes):
        if isinstance(node, ast.Call):
            why = _sync_reason(node)
            if why is not None:
                findings.append(src.finding(
                    "MT-T301", node,
                    f"{qual} is hot ({region.why}) but {why} — a host sync "
                    "per step (and a failed capture under a CUDA graph); "
                    "keep it on the card or move it out of the hot path"))
        elif isinstance(node, (ast.If, ast.While)):
            if _test_concretizes(node.test):
                findings.append(src.finding(
                    "MT-T302", node,
                    f"{qual} is hot ({region.why}) but branches in Python on "
                    f"a tensor value ({ast.unparse(node.test)}) — the test "
                    "reads the card back (a sync) and a graph replays one "
                    "branch; use torch.where or decide on the host"))
    fn = region.fn
    if (fn is not None and region.nodes and region.qual == fn.qual
            and _UPDATE_NAME.search(fn.name)):
        params, returned = _params(fn.node), _returned_names(region.nodes)
        for node in _walk_own_body(region.nodes):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            if (name in params and name in returned
                    and _out_of_place(node.value, name)):
                findings.append(src.finding(
                    "MT-T303", node,
                    f"update-shaped hot function {qual} rebinds its state "
                    f"{name!r} out of place ({ast.unparse(node.value)}) and "
                    "returns it — a fresh buffer every step, and stale "
                    "addresses in a captured graph; write it in place "
                    "(sub_, out=, _foreach_*_, the K kernels)"))
    return findings


_DPLANE_HOT = re.compile(
    r"apply|exchange|push|pull|sync|grad|submit|service|execute",
    re.IGNORECASE)
_HOST_XFER_ATTRS = {"asarray", "array", "frombuffer", "copyto"}


def _in_dplane(src: SourceFile) -> bool:
    return "dplane" in pathlib.PurePosixPath(src.rel).parts[:-1]


def _check_dplane(src: SourceFile, findings: List[Finding]) -> None:
    for fn in ast.walk(src.tree):
        if not (isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                and _DPLANE_HOT.search(fn.name)
                and not _HOST_CODE.search(fn.name)):
            continue
        for node in _walk_own_body(ast.iter_child_nodes(fn)):
            if not isinstance(node, ast.Call):
                continue
            name = callee_name(node)
            is_method = isinstance(node.func, ast.Attribute)
            if ((is_method and name in _SYNC_METHODS) or _is_cpu_target(node)
                    or (is_method and name in _HOST_XFER_ATTRS
                        and root_name(node.func) in _NP_ROOTS)):
                findings.append(src.finding(
                    "MT-T311", node,
                    f"{fn.name} calls {ast.unparse(node.func)}() on the "
                    "dplane hot path — a host materialization inside the "
                    "device-resident apply/exchange; route it through the "
                    "per-version snapshot cache (snapshot_host) or keep "
                    "the value a card tensor"))
            elif is_method and name == "synchronize":
                findings.append(src.finding(
                    "MT-T312", node,
                    f"{fn.name} calls {ast.unparse(node.func)}() on the "
                    "dplane hot path — a device barrier belongs in timing "
                    "code only; the exchange overlaps by NOT fencing "
                    "between ops"))


def check(files: Sequence[SourceFile],
          graph: Optional[callgraph.CallGraph] = None,
          hot_paths: Sequence[HotPath] = HOT_PATHS) -> List[Finding]:
    if graph is None:
        graph = callgraph.build_graph(files)
    findings: List[Finding] = []
    for src in files:
        if _in_dplane(src):
            _check_dplane(src, findings)
    seen: Set[Tuple[str, int, str]] = set()
    for region in hot_regions(graph, hot_paths):
        for f in check_region(region):
            key = (f.path, f.line, f.rule)
            if key not in seen:
                seen.add(key)
                findings.append(f)
    return findings

