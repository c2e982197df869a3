"""MT-Y8xx — declared concurrency disciplines, verified against the code.

The concurrency spec is prose in the docs: "§11 read-gate/header/
cache-read run without a scheduler yield" (docs/PROTOCOL.md §11.3),
"DevicePlane is drained only by ``_dplane_service``" (§10), "every
inbound frame is copied before the apply reads it".  This module is the
schema.py move applied to that spec: the disciplines are *declared* as
frozen rows below — the JAX package's rows, re-pointed at the port's
code — and *verified* interprocedurally against the tree on every
mtlint run, via the shared call graph
(mpit_tpu_torch.analysis.callgraph).

Rule family:

- **MT-Y801** — a declared no-yield atomic section reaches a scheduler
  yield: a direct ``yield``/``yield from``/``await`` inside the window,
  or a call that re-enters the scheduler resolved through any depth of
  plain same-file helpers.  ``sched.spawn(gen(...))`` is NOT a yield
  (spawn primes only the new task; calling a generator builds it).
- **MT-Y802** — a discipline's guarded mutation (e.g. ``plane.pop()``)
  is reachable from a function outside the declared single-writer set.
  A helper is allowed when every same-file caller is (transitively) a
  declared writer — the dispatcher may delegate, outsiders may not.
- **MT-Y803** — a lock-holding region performs a call that can yield to
  the cooperative scheduler (resolved through helpers).  Yielding with
  a native lock held deadlocks every other task that needs the lock;
  a *direct* ``yield`` under a lock is MT-C203's finding, Y803 owns the
  interprocedural case.  Convention-wide: needs no declaration.

The ownership half of the registry (OwnedSink/OwnedPath/DonatedSlot) is
consumed by mpit_tpu_torch.analysis.ownership (MT-D9xx); it lives here so
one table declares every checked discipline and the ``disciplines`` CLI
can gate on stale rows (a declaration matching zero code sites).  The
same gate covers the torch rules' ``HOT_PATHS`` (an entry naming no
function is stale) and the ``RETIRED`` rows (a retired declaration that
matches a site again must be re-declared).
"""

from __future__ import annotations

import json
import pathlib
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from mpit_tpu_torch.analysis import callgraph
from mpit_tpu_torch.analysis.core import (ERROR, Finding, SourceFile, collect,
                                    register_rules)

register_rules({
    "MT-Y801": (ERROR, "declared atomic section reaches a scheduler yield"),
    "MT-Y802": (ERROR, "guarded mutation reachable outside the declared "
                       "single-writer set"),
    "MT-Y803": (ERROR, "lock held across a call that can yield to the "
                       "scheduler"),
})


# -- registry shapes ---------------------------------------------------------


@dataclass(frozen=True)
class Anchor:
    """Matches a call site by terminal callee name and (optionally) a
    substring of the unparsed receiver: Anchor("pop", "plane") matches
    ``plane.pop()`` and ``self._plane.pop()`` but not ``store.pop()``."""
    callee: str
    receiver: str = ""

    def matches(self, cs: callgraph.CallSite) -> bool:
        return (cs.callee == self.callee
                and self.receiver.lower() in cs.receiver.lower())


@dataclass(frozen=True)
class AtomicSection:
    """A declared no-yield window.  With ``start=None`` the whole body
    of each named function is atomic; with a start anchor the window
    runs from the first matching call to the end of the function (the
    §11 shape: atomic from ``self._read_gate()`` onward)."""
    name: str
    file: str                  # rel-path suffix, e.g. "ps/server.py"
    fns: Tuple[str, ...]
    start: Optional[Anchor] = None
    doc: str = ""


@dataclass(frozen=True)
class SingleWriter:
    """A declared single-writer mutation: every call site matching
    ``guarded`` must be reachable only from the ``writers`` set."""
    name: str
    file: str
    guarded: Anchor
    writers: Tuple[str, ...]
    doc: str = ""


@dataclass(frozen=True)
class OwnedSink:
    """An apply entry point (MT-D901/D903): the ``arg``-th
    positional argument of every matching call must classify OWNED.
    ``fn`` scopes the sink to one enclosing function (for bare callees
    like the per-shard ``apply_fn``)."""
    name: str
    file: str
    callee: str
    arg: int
    receiver: str = ""
    fn: str = ""
    doc: str = ""


@dataclass(frozen=True)
class OwnedPath:
    """A declared ownership wrapper (MT-D903): inside ``fn``, every
    ``inner(...)`` call must sit under a ``wrapper(...)`` call —
    ``device_copy(place_flat(...))`` is the canonical seam."""
    name: str
    file: str
    fn: str
    inner: str
    wrapper: str
    doc: str = ""


@dataclass(frozen=True)
class DonatedSlot:
    """Shard buffers written in place (MT-D902; the reference's donated
    slots): inside the named reader functions, a bare use of
    ``self.<attr>`` (outside any call) leaks a reference that aliases
    the slot; every use must pass through a materialize/copy call
    (``self.param.clone()``)."""
    name: str
    file: str
    attrs: Tuple[str, ...]
    fns: Tuple[str, ...]
    doc: str = ""


# -- the declarations --------------------------------------------------------

SECTIONS: Tuple[AtomicSection, ...] = (
    AtomicSection(
        "ps-read-gate-window", "ps/server.py", ("_dispatch_read",),
        start=Anchor("_read_gate"),
        doc="§11.3: gate check, header build and cache read must see one "
            "consistent (version, bytes) pair — no scheduler yield from "
            "the _read_gate() call to the end of _dispatch_read."),
    AtomicSection(
        "ps-read-path-helpers", "ps/server.py",
        ("_read_gate", "_serve_ok_header", "_snapshot_wire"),
        doc="the read-path helpers the §11 window calls are themselves "
            "yield-free end to end."),
    AtomicSection(
        "cell-read-path-helpers", "cells/cell.py",
        ("_read_gate", "_serve_ok_header", "_snapshot_wire"),
        doc="cell shards serve reads under the same §11 window contract "
            "as the PS (cells/cell.py rebinds the PS dispatcher)."),
    AtomicSection(
        "cell-install-atomic", "cells/cell.py", ("_install", "_apply_diff"),
        doc="§13: installing a received frame/diff into the cell store "
            "must be atomic w.r.t. concurrent cell reads."),
    AtomicSection(
        "agg-fold-window", "agg/client.py", ("_group_fold",),
        start=Anchor("pop", receiver="_pending_tickets"),
        doc="group-plane fold: once the arrival map is popped, folding "
            "and resolving the group ticket must not yield (a yield "
            "would let a late arrival race the fold order)."),
)

WRITERS: Tuple[SingleWriter, ...] = (
    SingleWriter(
        "dplane-single-writer", "ps/server.py",
        Anchor("pop", receiver="plane"), ("_dplane_service",),
        doc="§10: DevicePlane tickets are popped only by the device-plane "
            "service task — the bitwise-determinism anchor."),
    SingleWriter(
        "aggplane-single-writer", "agg/client.py",
        Anchor("pop", receiver="plane"), ("_drain_plane",),
        doc="AggPlane tickets are popped only by the drain task the "
            "group-plane client owns."),
    SingleWriter(
        "reader-single-writer", "ps/server.py",
        Anchor("_dispatch_read"), ("_reader_dispatcher",),
        doc="§11: read frames are dispatched only by the reader "
            "dispatcher task (one reader stream per connection)."),
    SingleWriter(
        "cell-stream-single-writer", "ps/server.py",
        Anchor("_cell_frame"), ("_cell_dispatcher",),
        doc="§13: cell stream frames are applied only by the cell "
            "dispatcher task."),
)

SINKS: Tuple[OwnedSink, ...] = (
    OwnedSink(
        "chunk-apply-owned-seam", "ps/server.py", "apply_wire_chunk", 1,
        receiver="hbm",
        doc="chunk frames land back to back in one reused staging buffer "
            "(no ack round trip separates them): the parts handed to the "
            "slot's in-place apply must be owned card copies "
            "(_on_device), never receive-staging views."),
    OwnedSink(
        "chunk-apply-owned-seam-plain", "ps/server.py", "decode_parts", 0,
        fn="_apply_chunk",
        doc="the plain path (no device plane) has the same contract: the "
            "parts decode_parts reads — and, under an identity codec, "
            "hands back as the gradient itself — must be owned copies."),
    OwnedSink(
        "ps-grad-apply-owned", "ps/server.py", "apply_wire", 1,
        receiver="hbm", fn="_recv_grad",
        doc="unframed GRAD apply, device path: the client's next GRAD "
            "lands in the same staging buffer, so the operand handed to "
            "apply_wire must be an owned copy of the reused gbuf views, "
            "never the views themselves."),
    OwnedSink(
        "ps-grad-apply-owned-plain", "ps/server.py", "decode_parts", 0,
        fn="_recv_grad",
        doc="unframed GRAD apply, plain path: the same contract at the "
            "port's decode."),
    OwnedSink(
        "pool-client-decode-owned", "ps/client.py", "submit_decode", 1,
        receiver="pool",
        doc="pool seam: the wire slice handed to a pooled decode job is "
            "read by a worker thread while the scheduler loop recycles the "
            "rx frame for the next chunk — the caller must submit an owned "
            "snapshot (np.array), never the frame view."),
    OwnedSink(
        "pool-server-scatter-owned", "ps/server.py", "submit_scatter", 5,
        receiver="pool",
        doc="pool seam: the chunk body a pooled scatter reads must be "
            "owned — the server's rx buffer is reused per message while "
            "the job may still be copying from it."),
    OwnedSink(
        "cells-xor-owned-out", "cells/wire.py", "xor_sync", 2,
        receiver="pool",
        doc="§11 DELTA production/install: the XOR kernel's output must "
            "be a fresh owned buffer (np.empty) — reply tasks may still "
            "hold zero-copy views of the old frame (copy-on-write)."),
)

PATHS: Tuple[OwnedPath, ...] = (
    OwnedPath(
        "hbm-seed-owned-copy", "dplane/hbm.py", "seed",
        "_on_device", "copy_",
        doc="seeding writes the slot: the incoming value (on the CPU a "
            "torch.from_numpy alias of the caller's array) is copied into "
            "the slot's storage, never bound as the slot — the caller may "
            "keep using it, and the next apply writes the slot in place."),
    OwnedPath(
        "ps-owned-restore", "ps/server.py", "_owned",
        "from_numpy", "to",
        doc="restore staging: the arrays a checkpoint was loaded into are "
            "aliased by torch.from_numpy and must be copied by .to(device, "
            "copy=True) before they become the shard the rules write in "
            "place."),
    OwnedPath(
        "ps-on-device-owned", "ps/server.py", "_on_device",
        "from_numpy", "to",
        doc="frame staging: a received frame's torch.from_numpy alias is "
            "copied by .to(device, copy=True) before any apply reads it "
            "(the next frame lands in the same staging buffer)."),
    OwnedPath(
        "pool-client-decode-owned-copy", "ps/client.py", "_chunked_read",
        "array", "submit_decode",
        doc="the owning snapshot of the rx frame is constructed exactly "
            "at the pool submit boundary — an np.array in the chunked "
            "read loop outside submit_decode(...) is a stray copy that "
            "hides the ownership transfer."),
    OwnedPath(
        "pool-server-scatter-owned-copy", "ps/server.py",
        "_recv_param_chunked", "array", "submit_scatter",
        doc="same contract on the server scatter side: the owned copy "
            "of the rx body exists only as the pool submit argument."),
)

SLOTS: Tuple[DonatedSlot, ...] = (
    DonatedSlot(
        "hbm-snapshot-materialize", "dplane/hbm.py",
        ("param", "rule_state"), ("snapshot_host", "pull_device"),
        doc="readers of the slot must copy (.to(\"cpu\", copy=True), "
            ".clone()) before handing it out: the next apply writes the "
            "slot in place under any exposed reference."),
)

#: The JAX package's declarations whose code shape the port does not
#: have, kept verbatim with the reason and the port's row that took each
#: one's place.  They are still checked on every run (a tree in the
#: reference's shape, such as the analyzer's fixtures, is held to them),
#: and the stale gate runs the other way round: a retired row must match
#: zero sites in the port, or its shape is back and it must be declared
#: again.
RETIRED: Tuple[Tuple[object, str], ...] = (
    (OwnedSink(
        "chunk-apply-owned-seam-legacy", "ps/server.py", "apply_fn", 1,
        fn="_apply_chunk"),
     "the port has no per-shard apply_fn (the reference's legacy jitted "
     "apply); its plain path decodes with decode_parts — declared as "
     "chunk-apply-owned-seam-plain"),
    (OwnedSink(
        "ps-grad-apply-owned-legacy", "ps/server.py", "apply_fn", 1,
        fn="_recv_grad"),
     "as chunk-apply-owned-seam-legacy, on the unframed GRAD path — "
     "declared as ps-grad-apply-owned-plain"),
    (OwnedPath(
        "hbm-init-owned", "dplane/hbm.py", "__init__",
        "place_flat", "device_copy"),
     "the port's slot is born on the card (torch.zeros(..., device=...)): "
     "no host array enters HbmSlot.__init__, so there is no alias to copy "
     "(the reference wraps place_flat because jnp.asarray of numpy zeros "
     "aliases host memory on its CPU backend)"),
    (OwnedPath(
        "hbm-seed-owned", "dplane/hbm.py", "seed",
        "place_flat", "device_copy"),
     "the port's seed copies the value into the slot's storage with "
     "copy_ instead of binding a device_copy — declared as "
     "hbm-seed-owned-copy"),
    (OwnedPath(
        "ps-place-param-owned", "ps/server.py", "_place_param",
        "place_flat", "device_copy"),
     "the port has no _place_param: a shard-control slot is born on the "
     "card and restore staging goes through _owned — declared as "
     "ps-owned-restore"),
    (OwnedPath(
        "ps-place-param-owned-host", "ps/server.py", "_place_param",
        "asarray", "device_copy"),
     "the host-array half of _place_param: in the port every received or "
     "restored host array is copied by _on_device/_owned — declared as "
     "ps-on-device-owned and ps-owned-restore"),
)


def all_disciplines():
    """Every declared row, as (kind, entry) pairs, registry order."""
    from mpit_tpu_torch.analysis import torchrules  # late: import cycle
    for s in SECTIONS:
        yield "atomic-section", s
    for w in WRITERS:
        yield "single-writer", w
    for s in SINKS:
        yield "owned-sink", s
    for p in PATHS:
        yield "owned-path", p
    for s in SLOTS:
        yield "donated-slot", s
    for h in torchrules.HOT_PATHS:
        yield "hot-path", h


def _kind_of(entry) -> str:
    return {AtomicSection: "atomic-section", SingleWriter: "single-writer",
            OwnedSink: "owned-sink", OwnedPath: "owned-path",
            DonatedSlot: "donated-slot"}[type(entry)]


# -- MT-Y801: declared windows reach no yield --------------------------------


def _section_windows(graph: callgraph.CallGraph, section: AtomicSection
                     ) -> List[Tuple[callgraph.FnInfo, int]]:
    """(fn, window start line) for each declared function that exists
    and (when anchored) actually contains the anchor call."""
    windows = []
    for name in section.fns:
        for fn in graph.functions_in(section.file, name):
            if section.start is None:
                windows.append((fn, fn.node.lineno))
                continue
            starts = [cs.line for cs in fn.calls
                      if section.start.matches(cs)]
            if starts:
                windows.append((fn, min(starts)))
    return windows


def section_findings(graph: callgraph.CallGraph, section: AtomicSection
                     ) -> List[Finding]:
    findings = []
    for fn, start in _section_windows(graph, section):
        for ys in fn.yields:
            if ys.line >= start:
                findings.append(fn.src.finding(
                    "MT-Y801", ys.line,
                    f"{fn.qual} yields to the scheduler inside the "
                    f"declared atomic section '{section.name}' "
                    f"(window starts line {start}); {section.doc}"))
        for cs in fn.calls:
            if cs.line < start:
                continue
            witness = graph.call_may_yield(fn, cs)
            if witness is not None:
                findings.append(fn.src.finding(
                    "MT-Y801", cs.line,
                    f"{fn.qual} calls into the scheduler inside the "
                    f"declared atomic section '{section.name}': "
                    f"{witness}"))
    return findings


# -- MT-Y802: guarded mutations stay inside the writer set -------------------


def writer_sites(graph: callgraph.CallGraph, writer: SingleWriter
                 ) -> List[Tuple[callgraph.FnInfo, callgraph.CallSite]]:
    return [(fn, cs)
            for fn in graph.functions_in(writer.file)
            for cs in fn.calls if writer.guarded.matches(cs)]


def writer_findings(graph: callgraph.CallGraph, writer: SingleWriter
                    ) -> List[Finding]:
    allowed: Dict[callgraph.FnInfo, bool] = {}

    def is_allowed(fn: callgraph.FnInfo) -> bool:
        if fn in allowed:
            return allowed[fn]
        allowed[fn] = False  # pessimistic cycle guard
        if fn.name in writer.writers:
            allowed[fn] = True
        else:
            callers = graph.callers(fn)
            allowed[fn] = bool(callers) and all(
                is_allowed(c) for c in callers)
        return allowed[fn]

    findings = []
    for fn, cs in writer_sites(graph, writer):
        if not is_allowed(fn):
            findings.append(fn.src.finding(
                "MT-Y802", cs.line,
                f"{fn.qual} reaches the guarded mutation "
                f"{cs.receiver + '.' if cs.receiver else ''}{cs.callee}() "
                f"of single-writer discipline '{writer.name}' but is not "
                f"reachable only from its declared writer set "
                f"{sorted(writer.writers)}; {writer.doc}"))
    return findings


# -- MT-Y803: no lock held across a may-yield call ---------------------------


def lock_yield_findings(graph: callgraph.CallGraph) -> List[Finding]:
    findings = []
    for fn in graph.functions:
        for cs in fn.calls:
            if cs.lock is None:
                continue
            witness = graph.call_may_yield(fn, cs)
            if witness is not None:
                lock, lline = cs.lock
                findings.append(fn.src.finding(
                    "MT-Y803", cs.line,
                    f"{fn.qual} holds {lock} (acquired line {lline}) "
                    f"across a call that yields to the cooperative "
                    f"scheduler: {witness} — every other task needing "
                    f"{lock} deadlocks until this task is resumed"))
    return findings


# -- engine entry ------------------------------------------------------------


def check(files: Sequence[SourceFile],
          graph: Optional[callgraph.CallGraph] = None) -> List[Finding]:
    if graph is None:
        graph = callgraph.build_graph(files)
    findings: List[Finding] = []
    for section in SECTIONS:
        findings += section_findings(graph, section)
    for writer in WRITERS:
        findings += writer_findings(graph, writer)
    findings += lock_yield_findings(graph)
    return findings


# -- the coverage report / stale-declaration gate ----------------------------


def _entry_sites(graph: callgraph.CallGraph, kind: str, entry) -> int:
    from mpit_tpu_torch.analysis import ownership, torchrules  # late: cycles
    if kind == "atomic-section":
        return len(_section_windows(graph, entry))
    if kind == "single-writer":
        return len(writer_sites(graph, entry))
    if kind == "owned-sink":
        return len(ownership.sink_sites(graph, entry))
    if kind == "owned-path":
        return len(ownership.path_sites(graph, entry))
    if kind == "donated-slot":
        return len(ownership.slot_fns(graph, entry))
    if kind == "hot-path":
        return len(torchrules.declared_sites(graph, entry))
    raise AssertionError(kind)


def _entry_findings(graph: callgraph.CallGraph, kind: str, entry
                    ) -> List[Finding]:
    from mpit_tpu_torch.analysis import ownership, torchrules  # late: cycles
    if kind == "atomic-section":
        return section_findings(graph, entry)
    if kind == "single-writer":
        return writer_findings(graph, entry)
    if kind == "owned-sink":
        return ownership.sink_findings(graph, entry)
    if kind == "owned-path":
        return ownership.path_findings(graph, entry)
    if kind == "donated-slot":
        return ownership.slot_findings(graph, entry)
    if kind == "hot-path":
        return [f for r in torchrules.hot_regions(graph, (entry,),
                                                   discover=False)
                for f in torchrules.check_region(r)]
    raise AssertionError(kind)


def coverage_report(root) -> dict:
    """Verify every registry row against the tree under ``root`` and
    classify it verified / violated / stale (zero matching sites).
    Schema-versioned like the modelcheck report (mpit_modelcheck/1)."""
    t0 = time.monotonic()
    files, parse_failures = collect(pathlib.Path(root))
    graph = callgraph.build_graph(files)
    rows = []
    for kind, entry in all_disciplines():
        sites = _entry_sites(graph, kind, entry)
        found = _entry_findings(graph, kind, entry)
        if sites == 0:
            status = "stale"
        elif found:
            status = "violated"
        else:
            status = "verified"
        rows.append({
            "name": entry.name, "kind": kind, "file": entry.file,
            "sites": sites, "findings": [f.render() for f in found],
            "status": status, "doc": entry.doc,
        })
    for entry, reason in RETIRED:
        kind = _kind_of(entry)
        sites = _entry_sites(graph, kind, entry)
        rows.append({
            "name": entry.name, "kind": kind, "file": entry.file,
            "sites": sites, "findings": [],
            # a retired row that matches again has gone stale
            "status": "stale" if sites else "retired", "doc": reason,
        })
    counts = {s: sum(1 for r in rows if r["status"] == s)
              for s in ("verified", "violated", "stale", "retired")}
    return {
        "schema": "mpit_disciplines/1",
        "root": pathlib.Path(root).resolve().as_posix(),
        "files": len(files),
        "functions": len(graph.functions),
        "parse_failures": [f.render() for f in parse_failures],
        "disciplines": rows,
        **counts,
        "wall_ms": int((time.monotonic() - t0) * 1000),
    }


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m mpit_tpu_torch.analysis disciplines [--root R] [--report F]``

    Exit 0 when every declared discipline and hot path verifies against
    live code sites; 1 on any violation OR any stale declaration (a row
    matching zero sites, or a retired row matching one — the registry
    drifted from the code, same spirit as a stale baseline entry)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    root, report_path = "mpit_tpu_torch", None
    while argv:
        arg = argv.pop(0)
        if arg == "--root" and argv:
            root = argv.pop(0)
        elif arg == "--report" and argv:
            report_path = argv.pop(0)
        else:
            print(f"usage: disciplines [--root DIR] [--report FILE] "
                  f"(unexpected {arg!r})")
            return 2
    rep = coverage_report(root)
    for row in rep["disciplines"]:
        print(f"{row['status']:>9}  {row['kind']:<14} {row['name']:<32} "
              f"{row['file']} ({row['sites']} site"
              f"{'s' if row['sites'] != 1 else ''})")
        for line in row["findings"]:
            print(f"           {line}")
    print(f"disciplines: {rep['verified']} verified, "
          f"{rep['violated']} violated, {rep['stale']} stale, "
          f"{rep['retired']} retired "
          f"({rep['functions']} functions across {rep['files']} files, "
          f"{rep['wall_ms']} ms)")
    if report_path:
        pathlib.Path(report_path).write_text(
            json.dumps(rep, indent=2) + "\n", encoding="utf-8")
        print(f"wrote {report_path}")
    return 1 if (rep["violated"] or rep["stale"]) else 0
