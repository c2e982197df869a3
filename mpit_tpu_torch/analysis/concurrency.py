"""Concurrency rules (MT-C2xx) — lock discipline and the scheduler
yield contract.

Lock regions are ``with <expr>:`` statements whose context expression
*names* a lock (``lock`` / ``mutex`` / ``cv`` / ``cond`` in the source
text — the naming convention of comm/tcp.py, comm/local.py and the
native build serializer).  The per-function lock/call/yield summaries
come from the shared call graph (mpit_tpu_torch.analysis.callgraph — one AST
walk per function, shared with MT-P1xx/P203 and MT-Y8xx/D9xx), which
also lets MT-C202 see *through* helpers:

- **MT-C201** — the per-file lock-*order* graph (edges from every held
  lock to each newly acquired one, subscripts normalized so
  ``self._out_cv[peer]`` and ``self._out_cv[dst]`` are one lock class)
  must be acyclic between pairs: an A->B edge with a B->A edge
  elsewhere in the same file is an inversion, flagged at both sites.
- **MT-C202** — blocking calls (socket recv*/accept/connect/sendall,
  thread join, time.sleep, a CUDA synchronize, subprocess run
  helpers) must not run while a lock is held — whether the blocking
  call is textually under the ``with`` or buried in a same-file helper
  the lock region calls (resolved through the call graph).  Calls
  guarded by a ``BlockingIOError``/``InterruptedError`` handler are the
  nonblocking-socket convention and exempt; ``Condition.wait`` releases
  its lock and is exempt by design.
- **MT-C203** — a generator must never ``yield`` from inside a lock
  region: on the cooperative scheduler the task is parked mid-step
  *still holding the lock*, and any other task (or transport thread)
  that needs it deadlocks the role process.  Nested defs reset the
  held-set — their bodies run later, not under the enclosing lock.
  (The interprocedural variant — a lock held across a *call* that
  yields — is MT-Y803 in mpit_tpu_torch.analysis.disciplines.)
- **MT-C204** — a blocking worker-pool wait (``Job.result()``, the raw
  ``mt_pool_wait`` it wraps, or the ``mt_pool_close`` thread join) must
  not run while a lock is held NOR inside a declared no-yield atomic
  section (mpit_tpu_torch.analysis.disciplines.SECTIONS): the wait stalls
  the one scheduler thread on work that may be queued *behind* jobs
  only this thread can collect, and inside an atomic window it turns
  "no yield" into "no progress".  Those contexts poll the nonblocking
  ``Job.done()`` between scheduler turns or use the ``*_sync`` seam
  entries (comm/pool.py).  Resolved through same-file helpers like
  MT-C202.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from mpit_tpu_torch.analysis import callgraph, disciplines
from mpit_tpu_torch.analysis.core import Finding, SourceFile, register_rules

# Re-exported for compatibility: the lock/blocking model moved into the
# shared call-graph layer when the one-walk-per-function summaries did.
_lock_id = callgraph.lock_id
_is_blocking = callgraph.is_blocking
_LOCK_NAME = callgraph._LOCK_NAME
_BLOCKING_ATTRS = callgraph.BLOCKING_ATTRS
_SUBPROCESS_ATTRS = callgraph.SUBPROCESS_ATTRS

register_rules({
    "MT-C201": ("error", "lock-order inversion (A->B here, B->A elsewhere)"),
    "MT-C202": ("warn", "blocking call while holding a lock"),
    "MT-C203": ("error", "scheduler yield inside a lock region"),
    "MT-C204": ("error", "blocking worker-pool wait under a lock or inside "
                         "a declared no-yield window"),
})


# -- MT-C204: the blocking-pool-wait model -----------------------------------

#: Terminal callees that stall the calling thread on the native worker
#: pool: the raw per-handle wait and the close-time thread join.
#: ``Job.done()`` is the nonblocking probe and never matches.
_POOL_WAIT_CALLEES = {"mt_pool_wait", "mt_pool_close"}


def _is_pool_wait(cs: callgraph.CallSite) -> bool:
    """Does this call site block on the worker pool?  ``job.result()``
    by the receiver convention of comm/pool.py (a Job is always named
    ``job``/``jobs[...]``/``fold_jobs[...]``), the raw native waits by
    exact name."""
    if cs.callee in _POOL_WAIT_CALLEES:
        return True
    return cs.callee == "result" and "job" in cs.receiver.lower()


def _pool_wait_witness(graph: callgraph.CallGraph, fn: callgraph.FnInfo,
                       _seen=None) -> Optional[str]:
    """Witness string when calling ``fn`` reaches a blocking pool wait
    through any depth of same-file helpers; None otherwise."""
    seen = set() if _seen is None else _seen
    if fn in seen:
        return None
    seen.add(fn)
    for cs in fn.calls:
        if _is_pool_wait(cs):
            recv = cs.receiver + "." if cs.receiver else ""
            return f"{fn.name} calls {recv}{cs.callee}() (line {cs.line})"
        for target in graph.resolve(fn, cs):
            sub = _pool_wait_witness(graph, target, seen)
            if sub is not None:
                return f"{fn.name} -> {sub}"
    return None


def _call_pool_wait(graph: callgraph.CallGraph, fn: callgraph.FnInfo,
                    cs: callgraph.CallSite) -> Optional[str]:
    """Witness if THIS call site blocks on the pool (directly or via
    same-file helpers)."""
    if _is_pool_wait(cs):
        recv = cs.receiver + "." if cs.receiver else ""
        return f"{recv}{cs.callee}()"
    for target in graph.resolve(fn, cs):
        sub = _pool_wait_witness(graph, target)
        if sub is not None:
            return sub
    return None


def check(files: List[SourceFile],
          graph: Optional[callgraph.CallGraph] = None) -> List[Finding]:
    if graph is None:
        graph = callgraph.build_graph(files)
    findings: List[Finding] = []

    # MT-C202 / MT-C203 — straight off the per-function summaries.
    for fn in graph.functions:
        for cs in fn.calls:
            if cs.lock is None or cs.guarded:
                continue
            lock, lline = cs.lock
            if callgraph.is_blocking(cs.node):
                findings.append(fn.src.finding(
                    "MT-C202", cs.node,
                    f"{fn.qual} calls {ast.unparse(cs.node.func)}() while "
                    f"holding {lock} (acquired line {lline}) — the lock is "
                    "pinned for the call's full blocking duration"))
                continue
            # Interprocedural: the blocking call is one-to-N helper
            # levels down (same-file resolution, _nb_*/guarded exempt).
            for target in graph.resolve(fn, cs):
                if target.name.startswith("_nb_"):
                    continue
                witness = graph.may_block(target)
                if witness is not None:
                    findings.append(fn.src.finding(
                        "MT-C202", cs.node,
                        f"{fn.qual} calls {ast.unparse(cs.node.func)}() "
                        f"while holding {lock} (acquired line {lline}) and "
                        f"the callee blocks: {witness} — the lock is pinned "
                        "for the call's full blocking duration"))
                    break
        for ys in fn.yields:
            if ys.lock is None:
                continue
            if isinstance(ys.node, (ast.Yield, ast.YieldFrom)):
                lock, lline = ys.lock
                findings.append(fn.src.finding(
                    "MT-C203", ys.node,
                    f"{fn.qual} yields to the scheduler while holding "
                    f"{lock} (acquired line {lline}) — the parked task "
                    "wedges every other task that needs the lock"))

    # MT-C204 — blocking pool waits: (a) never with a lock held ...
    for fn in graph.functions:
        for cs in fn.calls:
            if cs.lock is None or cs.guarded:
                continue
            witness = _call_pool_wait(graph, fn, cs)
            if witness is not None:
                lock, lline = cs.lock
                findings.append(fn.src.finding(
                    "MT-C204", cs.node,
                    f"{fn.qual} blocks on the worker pool ({witness}) "
                    f"while holding {lock} (acquired line {lline}) — the "
                    "lock is pinned until jobs queued behind this one "
                    "drain; poll Job.done() or wait outside the lock"))
    # ... and (b) never inside a declared no-yield atomic section: the
    # window promised "no scheduler progress needed"; a pool wait makes
    # progress depend on worker scheduling instead.
    for section in disciplines.SECTIONS:
        for fn, start in disciplines._section_windows(graph, section):
            for cs in fn.calls:
                if cs.line < start:
                    continue
                witness = _call_pool_wait(graph, fn, cs)
                if witness is not None:
                    findings.append(fn.src.finding(
                        "MT-C204", cs.node,
                        f"{fn.qual} blocks on the worker pool ({witness}) "
                        f"inside the declared atomic section "
                        f"'{section.name}' (window starts line {start}) — "
                        "use the *_sync seam entries there; "
                        f"{section.doc}"))

    # MT-C201 — pairwise inversions within one file (lock identities
    # are only comparable inside a file: two classes may both name a
    # lock ``self._lock`` without ever sharing it).
    by_file: Dict[str, List[Tuple[str, str, int, callgraph.FnInfo]]] = {}
    for fn in graph.functions:
        for outer, inner, line in fn.lock_edges:
            by_file.setdefault(fn.src.rel, []).append(
                (outer, inner, line, fn))
    for rel, edges in by_file.items():
        pairs: Dict[Tuple[str, str],
                    List[Tuple[int, callgraph.FnInfo]]] = {}
        for outer, inner, line, fn in edges:
            pairs.setdefault((outer, inner), []).append((line, fn))
        reported = set()
        for (a, b), sites in sorted(pairs.items()):
            if (b, a) not in pairs or a == b:
                continue
            for line, fn in sites:
                key = (a, b, line)
                if key in reported:
                    continue
                reported.add(key)
                oline, ofn = pairs[(b, a)][0]
                findings.append(fn.src.finding(
                    "MT-C201", line,
                    f"{fn.qual} acquires {b} while holding {a}, but "
                    f"{ofn.qual} (line {oline}) acquires {a} while "
                    f"holding {b} — two threads taking the locks in "
                    "opposite order deadlock"))
    return findings
