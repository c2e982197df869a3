"""Shared interprocedural call-graph layer for mtlint.

Every rule family that needs to look *through* a call used to carry its
own ad-hoc walker: MT-P1xx inlined one level of helper calls, MT-C2xx
re-walked every function per file, MT-P203 was purely local.  This
module walks each function exactly ONCE per engine run and records a
:class:`FnInfo` summary — call sites (with held locks and
``BlockingIOError`` guards), yield points, lock-order edges, bindings
and return expressions — that protocol.py, concurrency.py,
disciplines.py and ownership.py all consume.  On top of the summaries
it answers the two interprocedural questions the concurrency
disciplines need, each propagated through one-to-N helper levels:

- :meth:`CallGraph.may_block` — can calling this function block the
  thread (socket recv/accept/connect/sendall, sleep, join, a CUDA
  synchronize, subprocess), resolved through same-file helpers?
  Calls inside a ``try`` whose handler catches ``BlockingIOError`` /
  ``InterruptedError`` are *guarded* — the nonblocking-socket
  convention of comm/tcp.py's ``_nb_*`` helpers — and do not count.
- :meth:`CallGraph.may_yield_call` — can *calling* this function yield
  to the cooperative scheduler?  Crucially this is only true for plain
  functions that re-enter the scheduler (``sched.wait`` / ``ping`` /
  ``ping_pass`` / ``wait_for``): calling a *generator* function merely
  builds the generator (mpit_tpu_torch.aio semantics — ``sched.spawn(gen())``
  inside an atomic section is NOT a yield), so generators never
  propagate may-yield through a bare call.  Direct ``yield`` /
  ``yield from`` / ``await`` nodes are recorded per function and
  checked against declared windows by disciplines.py.

Name resolution is deliberately conservative: a call resolves only
within the same file, and only when its receiver is empty (a bare
name), ``self`` or ``cls`` — resolving ``sock.close()`` to an unrelated
``TcpTransport.close`` by terminal name is exactly the false-positive
class this avoids.  Unresolvable calls contribute nothing.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from mpit_tpu_torch.analysis.core import SourceFile, callee_name, iter_functions, root_name

# -- the blocking-call model (shared with MT-C2xx / MT-P203) ----------------

_LOCK_NAME = re.compile(r"lock|mutex|cv|cond", re.IGNORECASE)

#: attribute / name callees that block the calling thread outright.
BLOCKING_ATTRS = {
    "recv", "recv_into", "recvfrom", "recvmsg", "accept", "connect",
    "sendall", "sleep", "synchronize",
}
#: subprocess helpers — blocking only when called off the subprocess module.
SUBPROCESS_ATTRS = {"run", "call", "check_call", "check_output", "communicate"}

#: exception names whose handlers mark a call *guarded*: the
#: nonblocking-socket convention (socket is O_NONBLOCK; the call returns
#: immediately or raises one of these).  comm/tcp.py's ``_nb_*`` helpers
#: and its lossy ``_wake`` pipe poke are the canonical shapes.
NB_GUARD_EXCS = {"BlockingIOError", "InterruptedError"}

#: plain-function scheduler re-entry points: calling one of these runs
#: *other* tasks (aio/scheduler.py).  Matched only when the receiver
#: expression names a scheduler (contains "sched") — ``ticket.event
#: .wait()`` is a thread block (MT-C202's territory), not a yield.
SCHED_REENTER = {"wait", "wait_for", "ping", "ping_pass"}


def lock_id(expr: ast.AST) -> Optional[str]:
    """Normalized lock identity for a with-item, or None when the
    expression does not look like a lock."""
    try:
        src = ast.unparse(expr)
    except Exception:  # pragma: no cover - unparse is total on 3.10 asts
        return None
    if isinstance(expr, ast.Call):
        # `with self._make_ctx():` — context factories (nullcontext,
        # torch.cuda.device, ...) are not lock acquisitions even when
        # their name happens to contain a lock-ish substring.
        return None
    if not _LOCK_NAME.search(src):
        return None
    # One lock *class* per container: self._out_cv[peer] == self._out_cv[dst].
    return re.sub(r"\[[^\]]*\]", "[*]", src)


def is_blocking(call: ast.Call) -> bool:
    """Does this call block the calling thread outright?"""
    name = callee_name(call)
    if name == "join":
        # Thread/process join blocks; str.join / os.path.join do not.
        if isinstance(call.func, ast.Attribute):
            recv = call.func.value
            if isinstance(recv, (ast.Constant, ast.JoinedStr)):
                return False
            if root_name(call.func) in ("os", "posixpath", "ntpath", "str"):
                return False
        return True
    if name in BLOCKING_ATTRS:
        return True
    if name in SUBPROCESS_ATTRS and root_name(call.func) == "subprocess":
        return True
    return False


def is_sched_reenter(call: ast.Call, receiver: str) -> bool:
    """A direct scheduler re-entry: ``*sched*.wait()/ping()/...``."""
    return (callee_name(call) in SCHED_REENTER
            and "sched" in receiver.lower())


# -- per-function summaries --------------------------------------------------


@dataclass
class CallSite:
    node: ast.Call
    line: int
    callee: str          # terminal name of the called object
    receiver: str        # unparsed ``func.value`` ('' for bare names)
    guarded: bool        # inside a BlockingIOError/InterruptedError try
    lock: Optional[Tuple[str, int]]  # innermost held (lock id, acquire line)


@dataclass
class YieldSite:
    node: ast.AST
    line: int
    lock: Optional[Tuple[str, int]]


@dataclass
class FnInfo:
    src: SourceFile
    qual: str
    name: str            # terminal name (qual's last component)
    node: ast.AST
    is_generator: bool = False
    calls: List[CallSite] = field(default_factory=list)
    yields: List[YieldSite] = field(default_factory=list)
    lock_edges: List[Tuple[str, str, int]] = field(default_factory=list)
    returns: List[ast.expr] = field(default_factory=list)
    assigns: Dict[str, List[ast.expr]] = field(default_factory=dict)
    params: frozenset = frozenset()

    def __hash__(self):  # identity — one FnInfo per def node
        return id(self.node)

    def __eq__(self, other):
        return self is other


def _handler_catches_nb(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    names = []
    if isinstance(t, ast.Tuple):
        names = [getattr(e, "id", getattr(e, "attr", "")) for e in t.elts]
    elif t is not None:
        names = [getattr(t, "id", getattr(t, "attr", ""))]
    return any(n in NB_GUARD_EXCS for n in names)


def _scan_function(src: SourceFile, qual: str, fn: ast.AST) -> FnInfo:
    """The ONE walk over a function body: lock regions, guard regions,
    calls, yields, bindings, returns.  Nested defs are skipped — they
    have their own FnInfo and their bodies run later."""
    info = FnInfo(src=src, qual=qual, name=qual.rsplit(".", 1)[-1], node=fn)
    args = getattr(fn, "args", None)
    if args is not None:
        names = [a.arg for a in (args.posonlyargs + args.args
                                 + args.kwonlyargs)]
        for extra in (args.vararg, args.kwarg):
            if extra is not None:
                names.append(extra.arg)
        info.params = frozenset(names)

    def visit(node: ast.AST, held: List[Tuple[str, int]],
              guarded: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # nested bodies run later, outside this region
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired: List[Tuple[str, int]] = []
            for item in node.items:
                visit(item.context_expr, held + acquired, guarded)
                lock = lock_id(item.context_expr)
                if lock is None:
                    continue
                for outer, _ in held + acquired:
                    if outer != lock:
                        info.lock_edges.append((outer, lock, node.lineno))
                acquired.append((lock, node.lineno))
            for sub in node.body:
                visit(sub, held + acquired, guarded)
            return
        if isinstance(node, ast.Try):
            body_guarded = guarded or any(
                _handler_catches_nb(h) for h in node.handlers)
            for sub in node.body:
                visit(sub, held, body_guarded)
            for part in (node.handlers, node.orelse, node.finalbody):
                for sub in part:
                    visit(sub, held, guarded)
            return
        if isinstance(node, ast.Call):
            func = node.func
            receiver = ""
            if isinstance(func, ast.Attribute):
                try:
                    receiver = ast.unparse(func.value)
                except Exception:  # pragma: no cover
                    receiver = ""
            info.calls.append(CallSite(
                node=node, line=node.lineno,
                callee=callee_name(node) or "", receiver=receiver,
                guarded=guarded, lock=held[-1] if held else None))
        elif isinstance(node, (ast.Yield, ast.YieldFrom, ast.Await)):
            info.is_generator = info.is_generator or isinstance(
                node, (ast.Yield, ast.YieldFrom))
            info.yields.append(YieldSite(
                node=node, line=node.lineno,
                lock=held[-1] if held else None))
        elif isinstance(node, ast.Return) and node.value is not None:
            info.returns.append(node.value)
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    info.assigns.setdefault(tgt.id, []).append(node.value)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name):
                info.assigns.setdefault(node.target.id, []).append(node.value)
        for child in ast.iter_child_nodes(node):
            visit(child, held, guarded)

    for child in ast.iter_child_nodes(fn):
        visit(child, [], False)
    return info


# -- the graph ---------------------------------------------------------------

_RESOLVABLE_RECEIVERS = ("", "self", "cls")


class CallGraph:
    """All FnInfo summaries for one engine run, with conservative
    same-file name resolution and memoized interprocedural predicates."""

    def __init__(self, files: Sequence[SourceFile]):
        self.functions: List[FnInfo] = []
        self.by_file: Dict[str, Dict[str, List[FnInfo]]] = {}
        for src in files:
            index = self.by_file.setdefault(src.rel, {})
            for qual, fn in iter_functions(src.tree):
                info = _scan_function(src, qual, fn)
                self.functions.append(info)
                index.setdefault(info.name, []).append(info)
        self._callers: Optional[Dict[FnInfo, List[FnInfo]]] = None
        self._may_block: Dict[FnInfo, Optional[str]] = {}
        self._may_yield: Dict[FnInfo, Optional[str]] = {}

    # -- resolution ----------------------------------------------------------

    def resolve(self, fn: FnInfo, cs: CallSite) -> List[FnInfo]:
        """Same-file targets of a call — only for bare / self / cls
        receivers (resolving ``sock.close()`` to an unrelated method by
        terminal name is the false-positive class this rules out)."""
        if cs.receiver not in _RESOLVABLE_RECEIVERS:
            return []
        return self.by_file.get(fn.src.rel, {}).get(cs.callee, [])

    def functions_in(self, suffix: str, name: Optional[str] = None
                     ) -> List[FnInfo]:
        """Every function in files whose rel path ends with ``suffix``
        (optionally filtered by terminal name)."""
        out = []
        for rel, index in self.by_file.items():
            if not rel.endswith(suffix):
                continue
            if name is None:
                for fns in index.values():
                    out.extend(fns)
            else:
                out.extend(index.get(name, []))
        return out

    def callers(self, fn: FnInfo) -> List[FnInfo]:
        """Reverse edges (same-file resolution), built lazily once."""
        if self._callers is None:
            rev: Dict[FnInfo, List[FnInfo]] = {}
            for caller in self.functions:
                for cs in caller.calls:
                    for target in self.resolve(caller, cs):
                        if target is not caller:
                            rev.setdefault(target, []).append(caller)
            self._callers = rev
        return self._callers.get(fn, [])

    # -- interprocedural predicates ------------------------------------------

    def may_block(self, fn: FnInfo) -> Optional[str]:
        """A witness description if calling ``fn`` can block the
        thread (unguarded), else None.  Propagates through same-file
        helpers; guarded calls (``_nb_*`` convention) do not count."""
        if fn in self._may_block:
            return self._may_block[fn]
        self._may_block[fn] = None  # cycle guard: recursion can't add blocking
        witness = None
        for cs in fn.calls:
            if cs.guarded:
                continue
            if is_blocking(cs.node):
                witness = f"{fn.name} calls {cs.callee}() (line {cs.line})"
                break
            for target in self.resolve(fn, cs):
                sub = self.may_block(target)
                if sub is not None:
                    witness = f"{fn.name} -> {sub}"
                    break
            if witness:
                break
        self._may_block[fn] = witness
        return witness

    def may_yield_call(self, fn: FnInfo) -> Optional[str]:
        """A witness description if *calling* ``fn`` re-enters the
        cooperative scheduler, else None.  Generators never qualify:
        calling one only builds it (the scheduler steps it later)."""
        if fn in self._may_yield:
            return self._may_yield[fn]
        self._may_yield[fn] = None  # cycle guard
        witness = None
        if not fn.is_generator:
            for cs in fn.calls:
                if is_sched_reenter(cs.node, cs.receiver):
                    witness = (f"{fn.name} re-enters the scheduler via "
                               f"{cs.receiver}.{cs.callee}() (line {cs.line})")
                    break
                for target in self.resolve(fn, cs):
                    sub = self.may_yield_call(target)
                    if sub is not None:
                        witness = f"{fn.name} -> {sub}"
                        break
                if witness:
                    break
        self._may_yield[fn] = witness
        return witness

    def call_may_yield(self, fn: FnInfo, cs: CallSite) -> Optional[str]:
        """Witness if THIS call site can yield to the scheduler."""
        if is_sched_reenter(cs.node, cs.receiver):
            return (f"direct scheduler re-entry "
                    f"{cs.receiver}.{cs.callee}()")
        for target in self.resolve(fn, cs):
            sub = self.may_yield_call(target)
            if sub is not None:
                return sub
        return None

    def reach_calls(self, fn: FnInfo, skip_prefix: str = "_nb_"
                    ) -> Iterator[Tuple[FnInfo, CallSite, str]]:
        """Every call site reachable from ``fn`` through same-file
        helper resolution: yields (owning function, call site, path).
        Traversal does not descend into generator targets (a bare call
        only builds them), nor into helpers named ``skip_prefix*`` (the
        declared guarded seam, e.g. ``_nb_*`` nonblocking helpers)."""
        seen = {fn}
        stack: List[Tuple[FnInfo, str]] = [(fn, fn.name)]
        while stack:
            cur, path = stack.pop()
            for cs in cur.calls:
                yield cur, cs, path
                for target in self.resolve(cur, cs):
                    if (target in seen or target.is_generator
                            or target.name.startswith(skip_prefix)):
                        continue
                    seen.add(target)
                    stack.append((target, f"{path} -> {target.name}"))


def build_graph(files: Sequence[SourceFile]) -> CallGraph:
    return CallGraph(files)
