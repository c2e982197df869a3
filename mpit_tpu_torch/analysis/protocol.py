"""Protocol-conformance rules (MT-P1xx) — the PS wire protocol, checked.

The contract lives in prose today: ps/tags.py documents which direction
each tag flows, which writes carry a 0-byte ``*_ACK`` tail, and which
0-byte headers precede a read (the reference's pclient/pserver
rendezvous conventions).  This pass makes it machine-checked:

- the **tag table** is any module named ``tags.py`` whose module-level
  ``NAME = <int>`` assignments define the channels;
- **role files** are modules whose stem contains ``client`` or
  ``server``; every ``aio_send``/``aio_recv`` and transport-level
  ``isend``/``irecv``/``iprobe`` call site is extracted with its tag
  (attribute ``tags.X``, bare imported name, keyword ``tag=``, or a
  literal int reverse-mapped through the table);
- a per-role send/recv graph is checked for: tags nobody uses
  (MT-P101), sends with no peer-role recv and recvs with no peer-role
  send (MT-P102), write tags whose ``*_ACK`` tail is missing in the
  same function (MT-P103), and request/reply cycles where both roles
  block on recv before their own send — the deadlock shape (MT-P104);
- ``comm/native/specs/*.json`` is checked against the checked-in
  generated bindings by re-running the (stdlib-only) generator and
  comparing output — spec drift is MT-P105.

The MT-P5xx family checks **tag registration**: every tag defined in a
``tags.py`` module must (MT-P501) carry an entry in the module's
``TAG_PAIRS`` conformance table naming its sender/receiver roles, and
(MT-P502) appear in the tree's ``docs/PROTOCOL.md`` normative spec when
one exists.  Entries whose endpoints are not plain client<->server
(controller directives, server<->server migration traffic) are *only*
checkable this way — the binary role model of MT-P101/P102 exempts
them, so the table is what keeps those channels from going dark.

The MT-P2xx family checks **bounded-wait discipline** (the mpit_tpu_torch.ft
contract): in a role file, every ``aio_send``/``aio_recv`` must carry an
explicit ``deadline=`` or ``abort=`` keyword (MT-P201) — a bare ``live=``
only covers orderly shutdown, not a dead peer — and the blocking
``transport.send()``/``transport.recv()`` conveniences are flagged
outright (MT-P202): they busy-spin with no bound at all.  Genuinely
unbounded-by-design waits (the INIT rendezvous, the rejoin listener)
carry mtlint_torch.toml suppressions with reasons, which is the point: every
unbounded wait in a role file is either a bug or a documented decision.
"""

from __future__ import annotations

import ast
import importlib.util
import pathlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from mpit_tpu_torch.analysis import callgraph
from mpit_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    callee_name,
    iter_functions,
    register_rules,
)

register_rules({
    "MT-P101": ("warn", "tag defined in the tag table but never used by "
                        "any role"),
    "MT-P102": ("error", "send/recv without a matching op in the peer role"),
    "MT-P103": ("error", "write tag missing its *_ACK tail in the same "
                         "function (one helper level followed)"),
    "MT-P104": ("error", "request/reply cycle where both roles block on "
                         "recv"),
    "MT-P105": ("error", "comm/native specs drifted from the checked-in "
                         "bindings"),
    "MT-P201": ("error", "aio send/recv in a role file with no "
                         "deadline=/abort= bound"),
    "MT-P202": ("error", "blocking transport send/recv convenience in a "
                         "role file"),
    "MT-P203": ("error", "blocking socket call / sleep inside an "
                         "event-loop callback (_el_*)"),
    "MT-P204": ("error", "disallowed call inside a SIGTERM handler"),
    "MT-P501": ("warn", "tag has no TAG_PAIRS conformance entry"),
    "MT-P502": ("warn", "tag missing from docs/PROTOCOL.md"),
})

#: callee name -> (op kind, index of the positional tag argument)
_TAG_CALLS = {
    "aio_send": ("send", 3),
    "isend": ("send", 2),
    "aio_recv": ("recv", 2),
    "irecv": ("recv", 1),
    "iprobe": ("recv", 1),
}


@dataclass
class ProtoOp:
    kind: str  # "send" | "recv"
    tag: str  # tag-table name
    line: int
    via: str = ""  # helper qualname when the op was inlined from a callee


@dataclass
class ParamTagOp:
    """A send/recv whose tag is one of the enclosing function's
    parameters — resolvable only at a call site (`_send_chunk_ack`'s
    ``aio_send(..., tag, ...)`` shape)."""
    kind: str
    param: str
    line: int


@dataclass
class HelperCall:
    """One call site inside a role function (candidate helper edge)."""
    name: str
    node: ast.Call
    line: int


@dataclass
class RoleFn:
    """One function in a role file: its concrete tag ops in source
    order, its parameter-tagged ops, and its call sites.  ``exp`` is the
    interprocedural view — own ops plus ops inlined from one level of
    same-role helper calls (tag parameters resolved per call site),
    positioned at the call-site line."""
    role: str
    qual: str
    src: SourceFile
    ops: List[ProtoOp]
    params: List[str] = field(default_factory=list)
    param_ops: List[ParamTagOp] = field(default_factory=list)
    calls: List[HelperCall] = field(default_factory=list)
    exp: List[ProtoOp] = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.qual.rsplit(".", 1)[-1]

    def sends(self, tag: str) -> List[ProtoOp]:
        return [op for op in self.exp if op.kind == "send" and op.tag == tag]

    def recvs(self, tag: str) -> List[ProtoOp]:
        return [op for op in self.exp if op.kind == "recv" and op.tag == tag]


def _load_tag_table(files: List[SourceFile]):
    """Merge every tags.py module-level ``NAME = int`` into one table."""
    table: Dict[str, int] = {}
    lines: Dict[str, Tuple[SourceFile, int]] = {}
    for src in files:
        if src.path.stem != "tags":
            continue
        for node in src.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, int)
                    and not isinstance(node.value.value, bool)):
                name = node.targets[0].id
                table[name] = node.value.value
                lines[name] = (src, node.lineno)
    return table, lines


def _load_tag_pairs(files: List[SourceFile]) -> Dict[str, Tuple[str, str]]:
    """Merge every tags.py ``TAG_PAIRS = {"NAME": (sender, receiver)}``
    literal into one conformance pairing table (the MT-P5xx anchor)."""
    pairs: Dict[str, Tuple[str, str]] = {}
    for src in files:
        if src.path.stem != "tags":
            continue
        for node in src.tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "TAG_PAIRS"
                    and isinstance(node.value, ast.Dict)):
                continue
            for key, value in zip(node.value.keys, node.value.values):
                if not (isinstance(key, ast.Constant)
                        and isinstance(key.value, str)):
                    continue
                roles = []
                if isinstance(value, ast.Tuple):
                    roles = [e.value for e in value.elts
                             if isinstance(e, ast.Constant)
                             and isinstance(e.value, str)]
                if len(roles) == 2:
                    pairs[key.value] = (roles[0], roles[1])
    return pairs


def _binary_pair(pair: "Tuple[str, str] | None") -> bool:
    """True when the pairing entry describes plain client<->server
    traffic — the only shape the binary role model (MT-P101/P102) can
    check.  Controller / server<->server / multi-role entries are
    validated against the table + PROTOCOL.md instead (MT-P5xx)."""
    if pair is None:
        return True  # unregistered: legacy default (and MT-P501 fires)
    return set(pair) == {"client", "server"}


def _role_of(src: SourceFile) -> Optional[str]:
    stem = src.path.stem.lower()
    if "client" in stem:
        return "client"
    if "server" in stem:
        return "server"
    return None


def _tag_of(node: ast.AST, table: Dict[str, int]) -> Optional[str]:
    if isinstance(node, ast.Attribute) and node.attr in table:
        return node.attr
    if isinstance(node, ast.Name) and node.id in table:
        return node.id
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        for name, value in table.items():
            if value == node.value:
                return name
    return None


def _fn_params(node: ast.AST) -> List[str]:
    args = getattr(node, "args", None)
    if args is None:
        return []
    return [a.arg for a in (args.posonlyargs + args.args)]


def _collect_role_fns(files: List[SourceFile], table) -> List[RoleFn]:
    """Every function in every role file — including op-less helpers
    (they may carry parameter-tagged ops the expansion resolves) — with
    the one-level interprocedural expansion applied."""
    fns: List[RoleFn] = []
    for src in files:
        role = _role_of(src)
        if role is None:
            continue
        for qual, node in iter_functions(src.tree):
            fn = RoleFn(role=role, qual=qual, src=src, ops=[],
                        params=_fn_params(node))
            _extract_ops_shallow(fn, node, table)
            fns.append(fn)
    callers = _expand(fns, table)
    return fns, callers


def _extract_ops_shallow(fn: RoleFn, node: ast.AST, table) -> None:
    """Populate ``fn``'s own ops, parameter-tagged ops and call sites,
    without descending into nested defs — a nested generator's ops
    belong to the nested function."""

    def walk(parent):
        for child in ast.iter_child_nodes(parent):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Call):
                _extract_ops_call(fn, child, table)
            walk(child)

    walk(node)
    fn.ops.sort(key=lambda op: op.line)


def _extract_ops_call(fn: RoleFn, node: ast.Call, table) -> None:
    name = callee_name(node)
    if name not in _TAG_CALLS:
        if name:
            fn.calls.append(HelperCall(name=name, node=node,
                                       line=node.lineno))
        return
    kind, tag_idx = _TAG_CALLS[name]
    tag_node: Optional[ast.AST] = None
    for kw in node.keywords:
        if kw.arg == "tag":
            tag_node = kw.value
    if tag_node is None and len(node.args) > tag_idx:
        tag_node = node.args[tag_idx]
    if tag_node is None:
        return
    tag = _tag_of(tag_node, table)
    if tag is not None:
        fn.ops.append(ProtoOp(kind=kind, tag=tag, line=node.lineno))
    elif isinstance(tag_node, ast.Name) and tag_node.id in fn.params:
        fn.param_ops.append(ParamTagOp(kind=kind, param=tag_node.id,
                                       line=node.lineno))


def _bind_args(call: ast.Call, params: List[str]) -> dict:
    """Map a helper's parameter names to the call-site argument nodes
    (`self.helper(a, b)` binds past the bound `self`)."""
    argmap: dict = {}
    names = list(params)
    if names and names[0] == "self" and isinstance(call.func, ast.Attribute):
        names = names[1:]
    for name, arg in zip(names, call.args):
        argmap[name] = arg
    for kw in call.keywords:
        if kw.arg is not None:
            argmap[kw.arg] = kw.value
    return argmap


def _expand(fns: List[RoleFn], table) -> "Dict[int, List[RoleFn]]":
    """One level of interprocedural inlining: each function's ``exp``
    op list gains the ops of every same-role helper it calls — concrete
    tags verbatim, parameter tags resolved from the call-site arguments
    — positioned at the call-site line.  Resolution prefers a helper in
    the same file, then any role file of the same role (the §13
    aggregation client rides ps/client.py's chunk-ack machinery).
    Returns callee -> callers (by id) for the ack-discipline pass."""
    by_file: Dict[Tuple[str, str], RoleFn] = {}
    by_role: Dict[Tuple[str, str], List[RoleFn]] = {}
    for f in fns:
        by_file.setdefault((f.src.rel, f.name), f)
        by_role.setdefault((f.role, f.name), []).append(f)

    def resolve(name: str, caller: RoleFn) -> Optional[RoleFn]:
        h = by_file.get((caller.src.rel, name))
        if h is not None:
            return h
        cands = by_role.get((caller.role, name), [])
        return cands[0] if cands else None

    callers: Dict[int, List[RoleFn]] = {}
    for f in fns:
        exp = list(f.ops)
        for hc in f.calls:
            h = resolve(hc.name, f)
            if h is None or h is f:
                continue
            if not (h.ops or h.param_ops):
                continue
            callers.setdefault(id(h), []).append(f)
            argmap = _bind_args(hc.node, h.params)
            for op in h.ops:
                exp.append(ProtoOp(kind=op.kind, tag=op.tag, line=hc.line,
                                   via=h.qual))
            for pop in h.param_ops:
                node = argmap.get(pop.param)
                tag = _tag_of(node, table) if node is not None else None
                if tag is not None:
                    exp.append(ProtoOp(kind=pop.kind, tag=tag, line=hc.line,
                                       via=h.qual))
        exp.sort(key=lambda op: op.line)
        f.exp = exp
    return callers


_PEER = {"client": "server", "server": "client"}


def _check_pairing(table, tag_lines, fns: List[RoleFn],
                   pairs: Dict[str, Tuple[str, str]]) -> List[Finding]:
    findings: List[Finding] = []
    used: set = set()
    by_role: Dict[str, List[RoleFn]] = {"client": [], "server": []}
    for fn in fns:
        by_role[fn.role].append(fn)
        for op in fn.exp:
            used.add(op.tag)

    # MT-P101: tag in the table, never used by any role.  Tags whose
    # pairing entry names non-client/server endpoints (controller,
    # server<->server) live outside the binary role model — their
    # conformance is the MT-P5xx table+doc check.
    for name, (src, line) in sorted(tag_lines.items()):
        if name not in used and _binary_pair(pairs.get(name)):
            findings.append(src.finding(
                "MT-P101", line,
                f"tag {name} is defined but no client/server send or recv "
                "references it"))

    # MT-P102: every (role, kind, tag) must have the complementary op in
    # the peer role.  Reported once per (role, kind, tag) at first use.
    peer_ops: Dict[Tuple[str, str], set] = {}
    for fn in fns:
        for op in fn.exp:
            peer_ops.setdefault((fn.role, op.kind), set()).add(op.tag)
    seen: set = set()
    for fn in fns:
        for op in fn.exp:
            key = (fn.role, op.kind, op.tag)
            if key in seen or not _binary_pair(pairs.get(op.tag)):
                continue
            seen.add(key)
            peer = _PEER[fn.role]
            want = "recv" if op.kind == "send" else "send"
            if op.tag not in peer_ops.get((peer, want), set()):
                verb = "sends" if op.kind == "send" else "receives"
                findings.append(fn.src.finding(
                    "MT-P102", op.line,
                    f"{fn.role} {verb} tag {op.tag} but the {peer} role has "
                    f"no matching {want} — one side of this channel is "
                    "unimplemented"))
    return findings


def _check_tag_registration(tag_lines, pairs,
                            files: List[SourceFile]) -> List[Finding]:
    """MT-P501/MT-P502: every tag must be registered in the TAG_PAIRS
    conformance table and documented in docs/PROTOCOL.md.

    The doc is located relative to the scan root (``<root>/docs`` or
    ``<root>/../docs``) — never by walking arbitrarily upward, so a
    fixture tree can't accidentally validate against the real repo's
    spec.  A tree with no PROTOCOL.md skips MT-P502.
    """
    findings: List[Finding] = []
    doc_text: Optional[str] = None
    for src in files:
        if src.path.stem != "tags":
            continue
        rel = pathlib.PurePosixPath(src.rel)
        root = src.path
        for _ in range(len(rel.parts)):
            root = root.parent
        for base in (root, root.parent):
            candidate = base / "docs" / "PROTOCOL.md"
            if candidate.is_file():
                doc_text = candidate.read_text()
                break
        break
    import re

    for name, (src, line) in sorted(tag_lines.items()):
        if name not in pairs:
            findings.append(src.finding(
                "MT-P501", line,
                f"tag {name} has no entry in the TAG_PAIRS conformance "
                "table — every wire tag must declare its sender/receiver "
                "roles (ps/tags.py)"))
        if doc_text is not None and not re.search(
                rf"\b{re.escape(name)}\b", doc_text):
            findings.append(src.finding(
                "MT-P502", line,
                f"tag {name} does not appear in docs/PROTOCOL.md — the "
                "normative wire spec must document every tag"))
    return findings


def _write_tags(table) -> Dict[str, str]:
    """tag -> its ack tag, for every T with a T_ACK in the table."""
    return {t: f"{t}_ACK" for t in table
            if not t.endswith("_ACK") and f"{t}_ACK" in table}


def _check_ack_discipline(table, fns: List[RoleFn],
                          callers: "Dict[int, List[RoleFn]]"
                          ) -> List[Finding]:
    """MT-P103, interprocedural: a write op's ack tail counts when it is
    observed in the same function, in a helper the function calls (the
    ``exp`` view — `_send_chunk_ack`, `_chunk_acks`), or — for an op
    that itself lives in a helper — anywhere in a function that calls
    the helper (`_forward_chunk`'s REDUCE posts are drained by
    `_drain_parent_acks` in the `_reduce_round` loop).  One level each
    way; the line-order requirement applies only within one body, where
    source order is meaningful."""
    findings: List[Finding] = []
    writes = _write_tags(table)
    for fn in fns:
        for op in fn.ops:
            if op.tag not in writes:
                continue
            ack = writes[op.tag]
            if fn.role == "client" and op.kind == "send":
                want, verb, consequence = "recv", "receives", (
                    "the write completion is unobservable")
            elif fn.role == "server" and op.kind == "recv":
                want, verb, consequence = "send", "sends", (
                    "the peer's blocking wait for the ack will hang")
            else:
                continue
            # Own body + one inlined helper level, in source order.
            if any(a.kind == want and a.tag == ack and a.line > op.line
                   for a in fn.exp):
                continue
            # One caller level up: a same-role caller that observes the
            # ack (any position — cross-function source order is not
            # meaningful) vouches for the helper's naked op.
            cs = callers.get(id(fn), [])
            if cs and any(
                    any(a.kind == want and a.tag == ack for a in c.exp)
                    for c in cs):
                continue
            doing = ("sends write tag" if op.kind == "send"
                     else "receives write tag")
            findings.append(fn.src.finding(
                "MT-P103", op.line,
                f"{fn.qual} {doing} {op.tag} but never {verb} its {ack} "
                "tail in the same function, a called helper, or a "
                f"calling function — {consequence}"))
    return findings


def _check_deadlock_shape(fns: List[RoleFn]) -> List[Finding]:
    """MT-P104: f (role A) blocks on recv(T) before sending U, while
    every send of T in g (role B) happens only after g receives U —
    a request/reply wait cycle with no initiator."""
    findings: List[Finding] = []
    for f in fns:
        if not f.exp:
            continue
        peers = [g for g in fns if g.role == _PEER[f.role] and g.exp]
        # Anchor only on the function's OWN recvs: an inlined helper's
        # internal send->recv order collapses onto one call-site line,
        # which would fabricate "blocks before sending" shapes.  The
        # expanded view still feeds prior_sends / the peer analysis, so
        # helper-split request/reply pairs are followed.
        for r in (op for op in f.ops if op.kind == "recv"):
            prior_sends = {op.tag for op in f.exp
                           if op.kind == "send" and op.line < r.line}
            for g in peers:
                t_sends = g.sends(r.tag)
                if not t_sends:
                    continue
                # Tags g must receive before it can possibly send T:
                # intersect over all send sites (any unconditional send
                # breaks the cycle).
                required: Optional[set] = None
                for s in t_sends:
                    pre = {op.tag for op in g.exp
                           if op.kind == "recv" and op.line < s.line}
                    required = pre if required is None else required & pre
                if not required:
                    continue
                for u in sorted(required):
                    if u in prior_sends:
                        continue
                    later_send = [op for op in f.exp if op.kind == "send"
                                  and op.tag == u and op.line > r.line]
                    if later_send:
                        findings.append(f.src.finding(
                            "MT-P104", r.line,
                            f"deadlock shape: {f.qual} blocks on recv({r.tag}) "
                            f"before sending {u}, but {g.src.rel}:{g.qual} "
                            f"sends {r.tag} only after receiving {u} — both "
                            "roles wait on the other's send"))
    return findings


_BOUND_KWS = {"deadline", "abort"}
_BLOCKING_RECEIVERS = {"transport", "wire"}


def _check_deadline_discipline(files: List[SourceFile]) -> List[Finding]:
    """MT-P201/MT-P202: unbounded blocking calls in role files."""
    findings: List[Finding] = []
    for src in files:
        role = _role_of(src)
        if role is None:
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = callee_name(node)
            if name in ("aio_send", "aio_recv"):
                if not (_BOUND_KWS & {kw.arg for kw in node.keywords}):
                    findings.append(src.finding(
                        "MT-P201", node.lineno,
                        f"{name} in a {role} role file has neither "
                        "deadline= nor abort= — a dead peer blocks this "
                        "service forever (live= only covers orderly "
                        "shutdown); bound it via mpit_tpu_torch.ft or suppress "
                        "with a reason"))
            elif name in ("send", "recv") and isinstance(node.func, ast.Attribute):
                recv = node.func.value
                base = (recv.attr if isinstance(recv, ast.Attribute)
                        else recv.id if isinstance(recv, ast.Name) else None)
                if base in _BLOCKING_RECEIVERS:
                    findings.append(src.finding(
                        "MT-P202", node.lineno,
                        f"blocking transport.{name}() in a {role} role "
                        "file spins with no bound at all — use the aio "
                        "generators with a deadline/abort"))
    return findings


#: direct socket calls that block (or arm blocking) the calling thread —
#: forbidden inside event-loop callbacks, where one blocked peer would
#: stall every peer's I/O at once.
_EL_BLOCKING = {
    "recv", "recv_into", "recvfrom", "recvmsg", "send", "sendall",
    "sendmsg", "accept", "connect", "create_connection", "settimeout",
    "sleep", "_recv_exact",
}


def _check_event_loop_discipline(files: List[SourceFile],
                                 graph: "callgraph.CallGraph"
                                 ) -> List[Finding]:
    """MT-P203: an event-loop transport multiplexes every peer on one
    thread, so its selector-dispatch callbacks (the ``_el_*`` naming
    convention, comm/tcp.py) may only touch sockets through guarded
    nonblocking helpers (``_nb_*``).  A raw ``recv``/``send``/``accept``
    — or worse, ``sendall``/``time.sleep``/``settimeout`` — turns one
    slow peer into a stall of the whole rank's I/O.  Checked
    interprocedurally over the shared call graph: a blocking call
    buried N same-file helpers below the callback is the same stall.
    ``_nb_*`` helpers and ``BlockingIOError``-guarded calls are the
    declared nonblocking seam and exempt; calls to generator functions
    only build the generator and are not descended into."""
    findings: List[Finding] = []
    seen = set()
    for fn in graph.functions:
        if not fn.name.startswith("_el_"):
            continue
        for owner, cs, path in graph.reach_calls(fn):
            if cs.guarded or cs.callee not in _EL_BLOCKING:
                continue
            key = (owner.src.rel, cs.line)
            if key in seen:
                continue
            seen.add(key)
            if owner is fn:
                message = (
                    f"{fn.qual} calls {cs.callee}() inside an event-loop "
                    "callback — one blocked peer stalls every peer's "
                    "I/O; route socket work through the _nb_* "
                    "nonblocking helpers")
            else:
                message = (
                    f"{owner.qual} calls {cs.callee}() and runs inside "
                    f"the event-loop callback {fn.qual} ({path}) — one "
                    "blocked peer stalls every peer's I/O; route socket "
                    "work through the _nb_* nonblocking helpers")
            findings.append(owner.src.finding("MT-P203", cs.line, message))
    return findings


def _walk_el(fn: ast.AST):
    """Walk a callback body without descending into nested defs (their
    bodies run later, off the dispatch path)."""
    for child in ast.iter_child_nodes(fn):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        yield from _walk_el(child)


#: the only calls a SIGTERM handler body may make: a pipe poke
#: (os.write on a pre-opened wake fd).  Everything else — locks,
#: allocation, transport sends, clock reads, logging — can deadlock or
#: corrupt, because the handler interrupts arbitrary bytecode (possibly
#: while the very lock it wants is held).
_SIGTERM_ALLOWED_CALLS = {"write"}


def _sigterm_handler_names(tree) -> "set[str]":
    """Names of functions registered as SIGTERM handlers anywhere in the
    module: ``signal.signal(signal.SIGTERM, fn)`` with ``fn`` a bare
    name or an attribute (``obj.method`` registers ``method``)."""
    names: set = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and callee_name(node) == "signal"
                and len(node.args) >= 2):
            continue
        sig = node.args[0]
        signame = (sig.attr if isinstance(sig, ast.Attribute)
                   else sig.id if isinstance(sig, ast.Name) else "")
        if signame != "SIGTERM":
            continue
        handler = node.args[1]
        if isinstance(handler, ast.Name):
            names.add(handler.id)
        elif isinstance(handler, ast.Attribute):
            names.add(handler.attr)
    return names


def _check_signal_handler_discipline(files: List[SourceFile]
                                     ) -> List[Finding]:
    """MT-P204: a SIGTERM handler may only set flags / write a pipe.
    The preemption contract (ft/elastic.py, PROTOCOL.md §9.3) delivers
    SIGTERM mid-bytecode — a handler that takes a lock the interrupted
    frame holds deadlocks the rank exactly when it must checkpoint and
    drain; allocation and transport calls are the same hazard wearing
    different costumes.  Checked tree-wide: the hazard does not care
    which directory the handler lives in."""
    findings: List[Finding] = []
    for src in files:
        handlers = _sigterm_handler_names(src.tree)
        if not handlers:
            continue
        for qual, fn in iter_functions(src.tree):
            if qual.rsplit(".", 1)[-1] not in handlers:
                continue
            for node in _walk_el(fn):  # shallow: nested defs run later
                if not isinstance(node, ast.Call):
                    continue
                callee = callee_name(node)
                if callee in _SIGTERM_ALLOWED_CALLS:
                    continue
                findings.append(src.finding(
                    "MT-P204", node.lineno,
                    f"{qual} is a SIGTERM handler but calls {callee}() — "
                    "handlers interrupt arbitrary bytecode, so they may "
                    "only set flags or os.write a wake pipe; do the real "
                    "work (checkpoint, drain, report) from the serving "
                    "loop's next poll"))
    return findings


def _check_spec_drift(files: List[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for src in files:
        if src.path.name != "gen_bindings.py":
            continue
        spec_dir = src.path.parent / "specs"
        bindings = src.path.parent / "_bindings.py"
        if not spec_dir.is_dir() or not bindings.is_file():
            continue
        # Validate spec shape first (the generator would KeyError).
        import json

        bad = False
        for spec_path in sorted(spec_dir.glob("*.json")):
            try:
                spec = json.loads(spec_path.read_text())
            except ValueError as exc:
                findings.append(Finding(
                    "MT-P105", _rel_sibling(src, spec_path), 1,
                    f"spec is not valid JSON: {exc}",
                    abspath=spec_path.as_posix()))
                bad = True
                continue
            missing = {"name", "ret", "args", "doc"} - set(spec)
            if missing:
                findings.append(Finding(
                    "MT-P105", _rel_sibling(src, spec_path), 1,
                    f"spec missing required keys {sorted(missing)}",
                    abspath=spec_path.as_posix()))
                bad = True
        if bad:
            continue
        # The generator is stdlib-only (json + pathlib) and anchors on
        # its own __file__, so loading it from the scanned tree and
        # re-running it is safe and exact.
        try:
            spec_mod = importlib.util.spec_from_file_location(
                "_mtlint_gen_bindings", src.path)
            mod = importlib.util.module_from_spec(spec_mod)
            spec_mod.loader.exec_module(mod)
            expected = mod.generate()
        except Exception as exc:  # noqa: BLE001 — report, don't crash the lint
            findings.append(src.finding(
                "MT-P105", 1, f"binding generator failed to run: {exc!r}"))
            continue
        if expected != bindings.read_text():
            findings.append(Finding(
                "MT-P105", _rel_sibling(src, bindings), 1,
                "checked-in _bindings.py does not match gen_bindings.py "
                "output for specs/*.json — regenerate with "
                "`python -m mpit_tpu_torch.comm.native.gen_bindings`",
                abspath=bindings.as_posix()))
    return findings


def _rel_sibling(src: SourceFile, sibling: pathlib.Path) -> str:
    """Display path for a file next to ``src``, in src's rel coordinates."""
    base = pathlib.PurePosixPath(src.rel).parent
    return (base / sibling.name).as_posix()


def check(files: List[SourceFile],
          graph: "Optional[callgraph.CallGraph]" = None) -> List[Finding]:
    if graph is None:
        graph = callgraph.build_graph(files)
    findings: List[Finding] = []
    table, tag_lines = _load_tag_table(files)
    if table:
        pairs = _load_tag_pairs(files)
        fns, callers = _collect_role_fns(files, table)
        findings += _check_pairing(table, tag_lines, fns, pairs)
        findings += _check_ack_discipline(table, fns, callers)
        findings += _check_deadlock_shape(fns)
        findings += _check_tag_registration(tag_lines, pairs, files)
    findings += _check_deadline_discipline(files)
    findings += _check_event_loop_discipline(files, graph)
    findings += _check_signal_handler_discipline(files)
    findings += _check_spec_drift(files)
    return findings
