"""The machine-readable wire schema — one declarative registry for every
tag, INIT version, negotiated flag bit, and frame header layout, plus
the conformance passes (MT-S6xx) that hold the code to it.

The protocol surface outgrew prose-and-pattern checking: 17 tags, INIT
v1–v5, seven negotiated flag bits with a requires/excludes lattice, and
a dozen frame layouts whose pack/unpack widths must agree across
ps/ft/shardctl/cells/agg.  This module makes the spec *executable*:

- the **registry** below is the single source of truth.  PROTOCOL.md's
  §1 tag table and §6.0 flag/version tables are *generated* from it
  (``python -m mpit_tpu_torch.analysis schema --emit-docs``; drift between
  the registry and the checked-in doc fails ``--check`` and CI);
- the **conformance pass** (:func:`check`, wired into the mtlint
  engine) parses the six wire modules (ps/tags.py, ft/wire.py,
  shardctl/wire.py, cells/wire.py, agg/wire.py) and the negotiation
  code in ps/server.py / ps/client.py and reports any constant, struct
  literal, tag registration, INIT-version dispatch, or flag-lattice
  guard that contradicts the registry;
- the **negotiation oracle** (:func:`negotiate`) evaluates the declared
  flag lattice for any (INIT version, flag set, rank posture) — the
  2^7 × v1–v5 matrix test drives the real ``ParamServer._negotiate``
  against it, so the registry and the server cannot quietly diverge;
- the **handshake tables** (:data:`HANDSHAKES`) declare the
  INIT/STOP/RETIRE/PREEMPT/SUBSCRIBE state machines the bounded
  interleaving model checker (mpit_tpu_torch.analysis.modelcheck) explores.

Like the rest of mpit_tpu_torch.analysis this module is stdlib-only and never
imports the code it describes — agreement is *checked*, not assumed.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from mpit_tpu_torch.analysis.core import Finding, SourceFile, register_rules

register_rules({
    # -- schema conformance (the wire registry in this module) -------------
    "MT-S601": ("error", "wire-module constant missing from / contradicting "
                         "the schema registry"),
    "MT-S602": ("error", "struct literal width disagrees with the schema "
                         "frame layout (pack/unpack drift)"),
    "MT-S603": ("error", "ps/tags.py tag id or TAG_PAIRS entry drifted from "
                         "the schema registry"),
    "MT-S604": ("error", "INIT version dispatch/announce drifted from the "
                         "schema's declared versions"),
    "MT-S605": ("error", "negotiation flag guard contradicts the declared "
                         "requires/excludes lattice"),
})


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TagSpec:
    """One wire tag: identity, endpoint roles (must equal the ps/tags.py
    ``TAG_PAIRS`` row — MT-S603), and the generated-doc row text."""

    name: str
    id: int
    sender: str
    receiver: str
    direction: str  # §1 "Direction" column (display form)
    payload: str  # §1 "Payload" column (markdown)
    pairs_with: str  # §1 "Pairs with" column (markdown)
    ack: Optional[str] = None  # the *_ACK tail this write tag expects


#: every tag on the wire, in id order.  The payload/pairs columns are the
#: normative §1 rows — edit them HERE, then `schema --emit-docs`.
TAGS: Tuple[TagSpec, ...] = (
    TagSpec(
        "INIT", 1, "client", "server", "c→s",
        "int64 `[offset, size]` (v1, 16 B), `[offset, size, codec_id]` "
        "(v2, 24 B), `[offset, size, codec_id, epoch, flags]` (v3, 40 B — "
        "§6.0), v3 + `[chunk_elems]` (v5, 48 B — §12.1), or the `-1`-"
        "sentinel shardctl announcement (v4, variable — §7.1)",
        "— (announce; re-sent by a rejoining incarnation, §6.3)"),
    TagSpec(
        "GRAD", 2, "client", "server", "c→s",
        "grad frame for the shard (§3); under FLAG_CHUNKED: K independent "
        "chunk frames (§12.2)",
        "`GRAD_ACK` tail", ack="GRAD_ACK"),
    TagSpec(
        "GRAD_ACK", 3, "server", "client", "s→c",
        "0 B legacy; `[epoch, seq]` echo framed; `[epoch, seq, chunk_idx]` "
        "per admitted chunk (§12.3)",
        "ack of `GRAD` after the update is **applied**"),
    TagSpec(
        "PARAM_REQ", 4, "client", "server", "c→s",
        "0 B legacy; `[epoch, seq]` framed (+ the wall-µs send stamp under "
        "FLAG_TIMING, §6.7)",
        "\"request-to-read\" head of `PARAM`"),
    TagSpec(
        "PARAM", 5, "server", "client", "s→c",
        "current-version snapshot frame (§3); to a READ-ONLY reader: a "
        "status header then (on OK) the frame as its own message (§8); "
        "under FLAG_CHUNKED: version-stamped chunk frames (§12.4)",
        "response to `PARAM_REQ`"),
    TagSpec(
        "PARAM_PUSH", 6, "client", "server", "c→s",
        "whole-shard parameter frame (§3); under FLAG_CHUNKED: K chunk "
        "frames assembled then seeded once (§12.3)",
        "`PARAM_PUSH_ACK` tail", ack="PARAM_PUSH_ACK"),
    TagSpec(
        "PARAM_PUSH_ACK", 7, "server", "client", "s→c",
        "0 B legacy; `[epoch, seq]` echo framed; per-chunk under "
        "FLAG_CHUNKED",
        "ack of `PARAM_PUSH` after the write lands"),
    TagSpec(
        "STOP", 8, "client", "server|controller", "c→s, c→controller",
        "0 B graceful-shutdown signal",
        "— (server exits its per-client services when all clients "
        "**terminal**: stopped or evicted, §6; shardctl clients also stop "
        "the controller, §7)"),
    TagSpec(
        "HEARTBEAT", 9, "client|server", "server|controller",
        "c→s, s→controller",
        "int64 `[epoch, seq]` (16 B; + the send stamp under FLAG_TIMING); "
        "the server→controller form appends a per-shard load report (§7.4)",
        "— (liveness beacon; renews the sender's lease, §6.1 / §7.4)"),
    TagSpec(
        "MAP_UPDATE", 10, "controller|server", "server|client|controller",
        "controller→s/c, s→controller",
        "int64 `[kind, shard_id, peer]` + serialized ShardMap (§7.2); "
        "kinds INSTALL/RELEASE/ACQUIRE/ADOPT/DONE/RETIRE/RETIRED/PREEMPT",
        "directives echo `DONE` back to the controller"),
    TagSpec(
        "SHARD_PULL", 11, "server", "server", "s→s",
        "int64 `[shard_id]` (8 B)",
        "head of the migration transfer (§7.3)"),
    TagSpec(
        "SHARD_STATE", 12, "server", "server", "s→s",
        "meta JSON, then param bytes as zero-copy chunk messages "
        "(MPIT_SC_CHUNK_BYTES), then rule-state arrays (§7.3)",
        "response to `SHARD_PULL`"),
    TagSpec(
        "HEARTBEAT_ECHO", 13, "server", "client", "s→c",
        "int64 `[epoch, seq, t_tx_echo, t_recv, t_ack]` (40 B, §6.7); to a "
        "SUBSCRIBE cell: int64 `[epoch, seq, head_version]` (24 B, §11.3)",
        "— (FLAG_TIMING reply to a timed `HEARTBEAT`; **not** an ack tail — "
        "beats stay fire-and-forget and the client drains echoes "
        "opportunistically.  The subscriber form is the head announcement "
        "a cell's staleness admission keys on)"),
    TagSpec(
        "DIFF", 14, "server", "cell", "s→cell",
        "one snapshot-diff frame of the committed version stream: int64 "
        "`[kind, from_version, to_version, head_version, body_nbytes]` "
        "(40 B) + body, one message (§11.2); to a FLAG_CHUNKED "
        "subscription: self-describing 7-word chunk messages (§11.8)",
        "— (pushed version stream; a broken chain is recovered by "
        "`DIFF_REQ`, not retransmission)"),
    TagSpec(
        "DIFF_REQ", 15, "cell", "server", "cell→s",
        "int64 `[epoch, seq, have_version]` (24 B)",
        "answered by a `DIFF` FULL frame at the current head (§11.2)"),
    TagSpec(
        "REDUCE", 16, "client", "client", "c→c",
        "int64 `[epoch, seq, chunk_idx, chunk_count, nfold]` (40 B) + "
        "partial-sum chunk frame, padded to the uniform stride (§13.3)",
        "`REDUCE_ACK` per admitted chunk", ack="REDUCE_ACK"),
    TagSpec(
        "REDUCE_ACK", 17, "client", "client", "c→c",
        "int64 `[epoch, seq, chunk_idx, status]` (32 B); status `OK`=0 "
        "received, `LATE`=1 the round folded without the sender (§13.4)",
        "ack of one `REDUCE` chunk"),
)

TAGS_BY_NAME: Dict[str, TagSpec] = {t.name: t for t in TAGS}


@dataclass(frozen=True)
class InitVersionSpec:
    """One INIT wire generation (length-distinguished, §6.0)."""

    version: int
    words: int  # int64 payload words (-1: variable, sentinel-distinguished)
    nbytes: int  # -1: variable
    fields: Tuple[str, ...]
    builder: Optional[str]  # the announce-builder fn the client must use
    note: str


INIT_VERSIONS: Tuple[InitVersionSpec, ...] = (
    InitVersionSpec(1, 2, 16, ("offset", "size"), None,
                    "codec `none`, no FT — the legacy announcement"),
    InitVersionSpec(2, 3, 24, ("offset", "size", "codec_id"), None,
                    "no FT"),
    InitVersionSpec(3, 5, 40, ("offset", "size", "codec_id", "epoch",
                               "flags"), "init_v3",
                    "the FT announcement (§6.0)"),
    InitVersionSpec(4, -1, -1, ("-1", "codec_id", "epoch", "flags",
                                "<map words>"), "init_v4",
                    "shardctl: `-1` sentinel + the versioned map (§7.1); "
                    "≥ 8 words"),
    InitVersionSpec(5, 6, 48, ("offset", "size", "codec_id", "epoch",
                               "flags", "chunk_elems"), "init_v5",
                    "v3 + the block-aligned chunk cut (FLAG_CHUNKED, "
                    "§12.1)"),
)

#: minimum int64 words of a v4 announcement (4 head + the smallest map).
INIT_V4_MIN_WORDS = 8

#: fixed-length versions: payload word count -> version (the server's
#: length dispatch must accept exactly these).
INIT_WORDS_TO_VERSION: Dict[int, int] = {
    v.words: v.version for v in INIT_VERSIONS if v.words > 0
}


@dataclass(frozen=True)
class FlagSpec:
    """One negotiated INIT flag bit.

    ``requires``: bits that must be announced alongside or the server
    refuses loudly.  ``refused_with``: ``(other, unless)`` — announcing
    both ``name`` and ``other`` is refused unless ``unless`` is also
    announced (``unless=None``: unconditionally).  ``active_requires`` /
    ``off_with``: the *effective* posture — the feature silently
    negotiates off unless every ``active_requires`` bit is present, and
    whenever any ``off_with`` bit is present (never a refusal).
    """

    name: str
    bit: int
    space: str  # "v3" (INIT v3/v5 flags word) | "v4" (shardctl announce)
    meaning: str
    requires: Tuple[str, ...] = ()
    refused_with: Tuple[Tuple[str, Optional[str]], ...] = ()
    active_requires: Tuple[str, ...] = ()
    off_with: Tuple[str, ...] = ()
    version_only: Optional[int] = None  # bit legal only in this INIT version


FLAGS: Tuple[FlagSpec, ...] = (
    FlagSpec(
        "FRAMED", 1, "v3",
        "FT frame headers for the pair (§6.2): `[epoch, seq]` identity, "
        "deadlines, retry, at-most-once dedup"),
    FlagSpec(
        "HEARTBEAT", 2, "v3",
        "this peer sends `HEARTBEAT` beacons — the server may arm a "
        "lease (§6.1)"),
    FlagSpec(
        "STALENESS", 4, "v3",
        "gradient-staleness telemetry: the 24-byte `[epoch, seq, version]` "
        "header extension (§6.6)",
        active_requires=("FRAMED",), off_with=("READONLY", "CHUNKED")),
    FlagSpec(
        "TIMING", 8, "v3",
        "causal-timing extension (§6.7): send stamps + "
        "`[t_tx_echo, t_recv, t_ack]` ack tails feeding the clock-offset "
        "estimator",
        active_requires=("FRAMED",), off_with=("READONLY",)),
    FlagSpec(
        "READONLY", 16, "v3",
        "READ-ONLY attach posture of the serving tier (§8): status-framed "
        "reads, no grad/push staging; announcing rank must be an expected "
        "reader (or cell)",
        requires=("FRAMED",)),
    FlagSpec(
        "SUBSCRIBE", 32, "v3",
        "replica-cell attach (§11.1): the diff stream replaces reads; "
        "announcing rank must be an expected cell",
        requires=("READONLY",)),
    FlagSpec(
        "CHUNKED", 64, "v3",
        "pipelined streaming transfers (§12) — or a chunk-framed "
        "subscription (§11.8); travels only in the 48-byte v5 "
        "announcement, which carries the chunk cut",
        requires=("FRAMED",), refused_with=(("READONLY", "SUBSCRIBE"),),
        version_only=5),
    FlagSpec(
        "SHARDCTL", 4, "v4",
        "this pair speaks shardctl framing (v4 announcements only; the "
        "`-1` sentinel, not this bit, is what distinguishes v4 on the "
        "wire — §7.1)"),
)

FLAGS_BY_NAME: Dict[str, FlagSpec] = {f.name: f for f in FLAGS}
V3_FLAGS: Tuple[FlagSpec, ...] = tuple(f for f in FLAGS if f.space == "v3")

#: the refusal lattice in normal form: refuse when every flag in
#: ``antecedents`` is announced and ``missing`` is not.  This is exactly
#: what the MT-S605 pass extracts back out of ``ParamServer._negotiate``
#: — an extracted rule not listed here, or a listed rule not enforced
#: there, is a finding.
REFUSALS: Set[Tuple[frozenset, str]] = {
    (frozenset({"SUBSCRIBE"}), "READONLY"),
    (frozenset({"READONLY"}), "FRAMED"),
    (frozenset({"CHUNKED"}), "FRAMED"),
    (frozenset({"CHUNKED", "READONLY"}), "SUBSCRIBE"),
}

#: effective-posture algebra (silent negotiate-off, never a refusal):
#: feature -> (bits that must all be on, bits that force it off).
EFFECTIVE: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "STALENESS": (("FRAMED",), ("READONLY", "CHUNKED")),
    "TIMING": (("FRAMED",), ("READONLY",)),
}


# ---------------------------------------------------------------------------
# Frame layouts — the cross-module pack/unpack width contract
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WireModuleSpec:
    """The schema's view of one wire module: the module-level constants
    it must define (with their values), and the word arity every
    declared packer/parser must exhibit in its struct literals.  Any
    *undeclared* uppercase int constant or struct-writing function in a
    registered wire module is itself a finding — a frame layout that
    bypasses the schema is exactly the drift this pass exists to stop."""

    suffix: str  # path suffix ("ft/wire.py")
    constants: Dict[str, int]
    packers: Dict[str, int]  # fn name -> struct-literal word count
    parsers: Dict[str, int]  # fn name -> unpacked word count


WIRE_MODULES: Tuple[WireModuleSpec, ...] = (
    WireModuleSpec(
        "ft/wire.py",
        constants={
            "HDR_BYTES": 16, "HDR_STALE_BYTES": 24,
            "FLAG_FRAMED": 1, "FLAG_HEARTBEAT": 2, "FLAG_STALENESS": 4,
            "FLAG_TIMING": 8, "FLAG_READONLY": 16, "FLAG_SUBSCRIBE": 32,
            "FLAG_CHUNKED": 64,
            "TIMING_TAIL_WORDS": 3, "TIMING_TAIL_BYTES": 24,
            "ACK_TIMING_WORDS": 5,
            "CHUNK_HDR_BYTES": 32, "CHUNK_ACK_WORDS": 3,
            "CHUNK_ACK_TIMING_WORDS": 6, "CHUNK_REPLY_WORDS": 5,
            "CHUNK_BLOCK": 1024,
        },
        packers={
            "pack_header": 2, "header_frame": 2, "timed_frame": 3,
            "init_v3": 5, "init_v5": 6, "pack_reply_stamps": 3,
            "pack_chunk_header": 4, "pack_chunk_reply": 5,
            "chunk_ack_frame": 3,
        },
        parsers={
            "unpack_header": 2, "unpack_reply_stamps": 3,
            "unpack_chunk_header": 4, "unpack_chunk_reply": 5,
        },
    ),
    WireModuleSpec(
        "shardctl/wire.py",
        constants={
            "SC_HDR_BYTES": 32, "FLAG_SHARDCTL": 4,
            "OK": 0, "NACK_MAP": 1, "BUSY": 2, "GOODBYE": 3,
            "INSTALL": 0, "RELEASE": 1, "ACQUIRE": 2, "ADOPT": 3,
            "DONE": 4, "RETIRE": 5, "RETIRED": 6, "PREEMPT": 7,
        },
        packers={
            "pack_sc_header": 4, "sc_header": 4, "reply_frame": 4,
            "init_v4": 4, "map_update": 3,
        },
        parsers={
            "unpack_sc_header": 4, "parse_reply": 4,
            # the `-1` sentinel is consumed by the dispatch, so the v4
            # parser unpacks the 3 negotiation words after it
            "parse_init_v4": 3, "parse_map_update": 3,
        },
    ),
    WireModuleSpec(
        "cells/wire.py",
        constants={
            "DIFF_HDR_WORDS": 5, "DIFF_HDR_BYTES": 40,
            "DIFF_FULL": 0, "DIFF_DELTA": 1,
            "DIFF_REQ_WORDS": 3, "HEAD_ECHO_WORDS": 3,
            "DIFF_CHUNK_HDR_WORDS": 7, "DIFF_CHUNK_HDR_BYTES": 56,
        },
        packers={
            "pack_diff": 5, "pack_diff_chunks": 7, "diff_req": 3,
            "head_echo": 3,
        },
        parsers={
            "parse_diff": 5, "parse_diff_chunk": 7, "parse_diff_req": 3,
        },
    ),
    WireModuleSpec(
        "agg/wire.py",
        constants={
            "RD_HDR_WORDS": 5, "RD_HDR_BYTES": 40, "RD_ACK_WORDS": 4,
            "RD_OK": 0, "RD_LATE": 1,
        },
        packers={"pack_reduce_header": 5, "reduce_ack_frame": 4},
        parsers={"unpack_reduce_header": 5},
    ),
)

#: every struct arity any schema layout admits — role-file struct
#: literals (ps/client.py, ps/server.py) must land on one of these.
_KNOWN_ARITIES: Set[int] = (
    {v.words for v in INIT_VERSIONS if v.words > 0}
    | {a for m in WIRE_MODULES for a in m.packers.values()}
    | {a for m in WIRE_MODULES for a in m.parsers.values()}
)


# ---------------------------------------------------------------------------
# The negotiation oracle
# ---------------------------------------------------------------------------


@dataclass
class Outcome:
    """What the schema says ``ParamServer._negotiate`` must do with one
    announcement: refuse loudly, or accept with this effective posture."""

    accepted: bool
    reason: str = ""
    # effective per-pair posture (all False/0 when refused)
    framed: bool = False
    heartbeat: bool = False
    staleness: bool = False
    timing: bool = False
    readonly: bool = False
    subscribe: bool = False
    chunked: bool = False
    shardctl: bool = False


def flag_bits(*names: str) -> int:
    """Compose a v3 flags word from flag names (test convenience)."""
    return sum(FLAGS_BY_NAME[n].bit for n in names)


def flag_names(flags: int, space: str = "v3") -> Set[str]:
    return {f.name for f in FLAGS
            if f.space == space and flags & f.bit}


def negotiate(version: int, flags: int = 0, *, reader_rank: bool = False,
              cell_rank: bool = False, serves_readers: bool = False,
              serves_cells: bool = False, sc_server: bool = False,
              splittable_rule: bool = True) -> Outcome:
    """The registry's verdict for one INIT announcement.

    ``reader_rank``/``cell_rank``: the announcing rank's membership in
    the server's expected reader/cell sets.  ``serves_readers``/
    ``serves_cells``: whether the server is configured with a serving
    tier at all (shardctl excludes it).  ``sc_server``: the server is
    already shardctl (a legacy announcement is then refused).
    """

    def refuse(reason: str) -> Outcome:
        return Outcome(False, reason)

    if version == 4:
        if serves_readers or serves_cells:
            return refuse("shardctl excludes the serving tier")
        if not flags & FLAGS_BY_NAME["FRAMED"].bit:
            return refuse("shardctl requires FLAG_FRAMED")
        # Any other bit is ignored on the v4 path: the -1 sentinel (not
        # a flag) is what selects shardctl, and the staleness/timing
        # extensions negotiate off (the 32-byte shard header has no
        # version/stamp slot — §6.6/§6.7).
        return Outcome(True, framed=True, shardctl=True,
                       heartbeat=bool(flags & FLAGS_BY_NAME["HEARTBEAT"].bit))
    if sc_server:
        return refuse("legacy INIT on a shardctl server")
    if version in (1, 2):
        if reader_rank:
            return refuse("reader rank must announce FLAG_READONLY")
        if cell_rank:
            return refuse("cell rank must announce FLAG_SUBSCRIBE")
        return Outcome(True)
    if version not in (3, 5):
        return refuse(f"unknown INIT version {version}")

    names = flag_names(flags, "v3")
    # version <-> bit coupling (CHUNKED travels only in v5, which exists
    # only to carry it).
    for f in V3_FLAGS:
        if f.version_only is not None:
            if (f.name in names) != (version == f.version_only):
                return refuse(
                    f"{f.name} and the v{f.version_only} announcement "
                    "must travel together")
    # the requires/excludes lattice
    for ante, missing in sorted(REFUSALS, key=lambda r: (sorted(r[0]),
                                                         r[1])):
        if ante <= names and missing not in names:
            return refuse(f"{'+'.join(sorted(ante))} requires {missing}")
    # rank-posture membership (role model, not bit lattice)
    ro, sub = "READONLY" in names, "SUBSCRIBE" in names
    if sub and not cell_rank:
        return refuse("FLAG_SUBSCRIBE from a non-cell rank")
    if cell_rank and not sub:
        return refuse("cell rank must announce FLAG_SUBSCRIBE")
    if ro and not sub and not reader_rank:
        return refuse("FLAG_READONLY from a non-reader rank")
    if reader_rank and not ro:
        return refuse("reader rank must announce FLAG_READONLY")
    if "CHUNKED" in names and not sub and not splittable_rule:
        return refuse("FLAG_CHUNKED needs an element-wise (splittable) rule")

    out = Outcome(True)
    out.framed = "FRAMED" in names
    out.heartbeat = "HEARTBEAT" in names
    out.readonly = ro
    out.subscribe = sub
    out.chunked = "CHUNKED" in names
    for feature, (need, off) in EFFECTIVE.items():
        active = (feature in names
                  and all(n in names for n in need)
                  and not any(o in names for o in off))
        setattr(out, feature.lower(), active)
    return out


# ---------------------------------------------------------------------------
# Conformance (MT-S6xx) — hold the tree to the registry
# ---------------------------------------------------------------------------

import re as _re

_UPPER_INT = _re.compile(r"^[A-Z][A-Z0-9_]*$")


def _module_consts(tree: ast.Module) -> Dict[str, Tuple[int, int]]:
    """Module-level UPPERCASE integer constants: name -> (value, line).
    A tiny const folder covers the derived forms the wire modules use
    (``TIMING_TAIL_BYTES = 8 * TIMING_TAIL_WORDS``)."""
    consts: Dict[str, Tuple[int, int]] = {}

    def fold(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, int) \
                and not isinstance(node.value, bool):
            return node.value
        if isinstance(node, ast.Name) and node.id in consts:
            return consts[node.id][0]
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            v = fold(node.operand)
            return -v if v is not None else None
        if isinstance(node, ast.BinOp):
            lo, hi = fold(node.left), fold(node.right)
            if lo is None or hi is None:
                return None
            if isinstance(node.op, ast.Add):
                return lo + hi
            if isinstance(node.op, ast.Sub):
                return lo - hi
            if isinstance(node.op, ast.Mult):
                return lo * hi
            if isinstance(node.op, ast.FloorDiv) and hi:
                return lo // hi
        return None

    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            name = node.targets[0].id
            if not _UPPER_INT.match(name):
                continue
            value = fold(node.value)
            if value is not None:
                consts[name] = (value, node.lineno)
    return consts


def _is_int_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "int")


def _struct_evidence(fnode: ast.AST) -> List[Tuple[int, int, str]]:
    """(arity, line, kind) evidence of struct widths in one function
    body.  ``pack``: a tuple/list literal written into a sliced buffer
    view or passed to ``np.asarray``/``np.array``.  ``parse``: a
    tuple-unpack over a words generator, or a returned tuple of ≥2
    ``int(...)`` elements."""
    ev: List[Tuple[int, int, str]] = []
    for node in ast.walk(fnode):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt, val = node.targets[0], node.value
            if isinstance(tgt, ast.Subscript) and \
                    isinstance(val, (ast.Tuple, ast.List)):
                ev.append((len(val.elts), node.lineno, "pack"))
            elif isinstance(tgt, ast.Tuple) and \
                    isinstance(val, ast.GeneratorExp) and \
                    _is_int_call(val.elt):
                ev.append((len(tgt.elts), node.lineno, "parse"))
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else ""
            if name in ("asarray", "array") and node.args and \
                    isinstance(node.args[0], (ast.Tuple, ast.List)):
                ev.append((len(node.args[0].elts), node.lineno, "pack"))
        elif isinstance(node, ast.Return) and \
                isinstance(node.value, ast.Tuple):
            ints = [e for e in node.value.elts if _is_int_call(e)]
            if len(ints) >= 2:
                ev.append((len(ints), node.lineno, "parse"))
    return ev


def _top_functions(tree: ast.Module) -> Dict[str, ast.AST]:
    """Terminal name -> def node, every nesting level (first wins)."""
    from mpit_tpu_torch.analysis.core import iter_functions
    out: Dict[str, ast.AST] = {}
    for qual, node in iter_functions(tree):
        out.setdefault(qual.rsplit(".", 1)[-1], node)
    return out


def _check_wire_module(spec: WireModuleSpec,
                       src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    consts = _module_consts(src.tree)
    for name in sorted(spec.constants):
        want = spec.constants[name]
        got = consts.get(name)
        if got is None:
            findings.append(src.finding(
                "MT-S601", 1,
                f"wire constant {name} (= {want} per the schema registry) "
                f"is missing from {spec.suffix}"))
        elif got[0] != want:
            findings.append(src.finding(
                "MT-S601", got[1],
                f"wire constant {name} = {got[0]} contradicts the schema "
                f"registry (= {want}) — pack/unpack widths diverge across "
                "modules the moment this lands"))
    for name, (value, line) in sorted(consts.items()):
        if name not in spec.constants:
            findings.append(src.finding(
                "MT-S601", line,
                f"wire constant {name} = {value} is not in the schema "
                "registry — declare it in analysis/schema.py "
                f"(WIRE_MODULES[{spec.suffix!r}]) so conformance and the "
                "generated docs can see it"))
    fns = _top_functions(src.tree)
    for kind, declared in (("pack", spec.packers), ("parse", spec.parsers)):
        for fname in sorted(declared):
            arity = declared[fname]
            node = fns.get(fname)
            if node is None:
                findings.append(src.finding(
                    "MT-S602", 1,
                    f"schema-declared {kind}er {fname}() is missing from "
                    f"{spec.suffix}"))
                continue
            ev = [e for e in _struct_evidence(node) if e[2] == kind]
            if not any(a == arity for a, _, _ in ev):
                findings.append(src.finding(
                    "MT-S602", node.lineno,
                    f"{fname}() shows no {arity}-word {kind} struct "
                    f"literal (schema layout width {arity}) — the "
                    "pack/unpack width drifted from the registry"))
            for a, line, _ in ev:
                if a != arity:
                    findings.append(src.finding(
                        "MT-S602", line,
                        f"{fname}() {kind}s a {a}-word struct but the "
                        f"schema layout is {arity} words"))
    declared_fns = set(spec.packers) | set(spec.parsers)
    for fname, node in sorted(fns.items()):
        if fname in declared_fns:
            continue
        for a, line, kind in _struct_evidence(node):
            if kind == "pack":
                findings.append(src.finding(
                    "MT-S602", line,
                    f"{fname}() writes a {a}-word struct literal that is "
                    "not derived from the schema — register the layout in "
                    "analysis/schema.py before shipping it"))
    return findings


def _check_tags_module(src: SourceFile) -> List[Finding]:
    """MT-S603: ps/tags.py ids and TAG_PAIRS rows vs the registry."""
    findings: List[Finding] = []
    ids: Dict[str, Tuple[int, int]] = {}
    pairs: Dict[str, Tuple[str, str, int]] = {}
    for node in src.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        if isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, int) and \
                not isinstance(node.value.value, bool):
            ids[name] = (node.value.value, node.lineno)
        elif name == "TAG_PAIRS" and isinstance(node.value, ast.Dict):
            for key, value in zip(node.value.keys, node.value.values):
                if not (isinstance(key, ast.Constant)
                        and isinstance(key.value, str)
                        and isinstance(value, ast.Tuple)
                        and len(value.elts) == 2):
                    continue
                roles = [e.value for e in value.elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str)]
                if len(roles) == 2:
                    pairs[key.value] = (roles[0], roles[1], key.lineno)
    for t in TAGS:
        got = ids.get(t.name)
        if got is None:
            findings.append(src.finding(
                "MT-S603", 1,
                f"schema tag {t.name} (= {t.id}) is missing from "
                "ps/tags.py"))
        elif got[0] != t.id:
            findings.append(src.finding(
                "MT-S603", got[1],
                f"tag {t.name} = {got[0]} contradicts the schema "
                f"registry (= {t.id})"))
        pr = pairs.get(t.name)
        if pr is None:
            findings.append(src.finding(
                "MT-S603", 1,
                f"schema tag {t.name} has no TAG_PAIRS row in ps/tags.py"))
        elif (pr[0], pr[1]) != (t.sender, t.receiver):
            findings.append(src.finding(
                "MT-S603", pr[2],
                f"TAG_PAIRS[{t.name!r}] = ({pr[0]!r}, {pr[1]!r}) "
                f"contradicts the schema registry "
                f"({t.sender!r}, {t.receiver!r})"))
    for name, (value, line) in sorted(ids.items()):
        if name not in TAGS_BY_NAME:
            findings.append(src.finding(
                "MT-S603", line,
                f"tag {name} = {value} is not in the schema registry — "
                "add a TagSpec to analysis/schema.py (the generated "
                "PROTOCOL.md §1 table starts there)"))
    for name, (_, _, line) in sorted(pairs.items()):
        if name not in TAGS_BY_NAME:
            findings.append(src.finding(
                "MT-S603", line,
                f"TAG_PAIRS row {name!r} names a tag the schema registry "
                "does not declare"))
    return findings


def _flag_resolver(neg_fn: ast.AST):
    """Build a resolver mapping expressions inside ``_negotiate`` to v3
    flag names, via the function's own aliases: ``sub = bool(flags &
    FLAG_SUBSCRIBE)`` name aliases, ``self._framed[crank] = bool(flags &
    FLAG_FRAMED)`` attribute aliases, and direct ``flags & FLAG_X``
    tests."""
    name_alias: Dict[str, str] = {}
    attr_alias: Dict[str, str] = {}

    def flag_of_bitand(node) -> Optional[str]:
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitAnd):
            for side in (node.left, node.right):
                fname = (side.attr if isinstance(side, ast.Attribute)
                         else side.id if isinstance(side, ast.Name) else "")
                if fname.startswith("FLAG_") and \
                        fname[5:] in FLAGS_BY_NAME:
                    return fname[5:]
        return None

    def unwrap_bool(node):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "bool" and len(node.args) == 1:
            return node.args[0]
        return node

    for node in ast.walk(neg_fn):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        flag = flag_of_bitand(unwrap_bool(node.value))
        if flag is None:
            continue
        tgt = node.targets[0]
        if isinstance(tgt, ast.Name):
            name_alias[tgt.id] = flag
        elif isinstance(tgt, ast.Subscript) and \
                isinstance(tgt.value, ast.Attribute):
            attr_alias[tgt.value.attr] = flag

    def resolve(node) -> Optional[str]:
        node = unwrap_bool(node)
        direct = flag_of_bitand(node)
        if direct is not None:
            return direct
        if isinstance(node, ast.Name):
            return name_alias.get(node.id)
        if isinstance(node, ast.Subscript) and \
                isinstance(node.value, ast.Attribute):
            return attr_alias.get(node.value.attr)
        return None

    return resolve


def _split_flag_test(test: ast.AST, resolve):
    """Decompose an ``if`` test into (positive flags, negated flags,
    pure): pure means every conjunct is a flag test or its negation —
    only pure tests participate in the lattice comparison (membership
    and version guards are outside the bit algebra)."""
    conjuncts = (test.values if isinstance(test, ast.BoolOp)
                 and isinstance(test.op, ast.And) else [test])
    pos: List[str] = []
    neg: List[str] = []
    pure = True
    for c in conjuncts:
        if isinstance(c, ast.UnaryOp) and isinstance(c.op, ast.Not):
            flag = resolve(c.operand)
            if flag is None:
                pure = False
            else:
                neg.append(flag)
        else:
            flag = resolve(c)
            if flag is None:
                pure = False
            else:
                pos.append(flag)
    return pos, neg, pure


def _extract_refusals(neg_fn: ast.AST, resolve):
    """Every pure-flag refusal rule enforced by ``_negotiate``:
    (antecedent flag set, missing flag, line)."""
    rules: List[Tuple[frozenset, str, int]] = []

    def walk(stmt, ctx: frozenset):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if isinstance(stmt, ast.If):
            pos, neg, pure = _split_flag_test(stmt.test, resolve)
            raises = any(isinstance(n, ast.Raise) for n in stmt.body)
            if pure and raises and len(neg) == 1 and (ctx or pos):
                rules.append((ctx | frozenset(pos), neg[0], stmt.lineno))
            body_ctx = ctx | frozenset(pos) if pure and not neg else ctx
            for n in stmt.body:
                walk(n, body_ctx)
            for n in stmt.orelse:
                walk(n, ctx)
            return
        for child in ast.iter_child_nodes(stmt):
            walk(child, ctx)

    for n in neg_fn.body:
        walk(n, frozenset())
    return rules


def _extract_effective(neg_fn: ast.AST, resolve):
    """The effective-posture assignments (`self._stale_track[crank] =
    framed and not ro and ... and bool(flags & FLAG_X)`): feature ->
    (required-on set, off-with set, line)."""
    out: Dict[str, Tuple[Set[str], Set[str], int]] = {}
    for node in ast.walk(neg_fn):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        val = node.value
        if not (isinstance(val, ast.BoolOp) and isinstance(val.op, ast.And)):
            continue
        pos, neg, pure = _split_flag_test(val, resolve)
        if not pure:
            continue
        for feature in EFFECTIVE:
            if feature in pos:
                need = {p for p in pos if p != feature}
                out[feature] = (need, set(neg), node.lineno)
    return out


def _defines_param_server(tree: ast.Module) -> bool:
    return any(isinstance(node, ast.ClassDef) and node.name == "ParamServer"
               for node in ast.walk(tree))


def _defines_param_client(tree: ast.Module) -> bool:
    return any(isinstance(node, ast.ClassDef) and node.name == "ParamClient"
               for node in ast.walk(tree))


def _declares_wire_names(spec: WireModuleSpec, src: SourceFile) -> bool:
    """Is this file plausibly the registry's wire module — i.e. does it
    declare any of the spec's constants or pack/parse functions?"""
    consts = _module_consts(src.tree)
    if any(name in consts for name in spec.constants):
        return True
    fns = _top_functions(src.tree)
    return any(name in fns for name in (*spec.packers, *spec.parsers))


def _check_negotiation(src: SourceFile) -> List[Finding]:
    """MT-S604/MT-S605 over ``ParamServer._negotiate``: the INIT length
    dispatch must accept exactly the schema's versions, and the pure
    flag guards must enforce exactly the declared lattice."""
    findings: List[Finding] = []
    fns = _top_functions(src.tree)
    neg = fns.get("_negotiate")
    if neg is None:
        return [src.finding(
            "MT-S604", 1,
            "ps/server.py has no _negotiate — the INIT dispatch the "
            "schema describes is gone")]
    # -- version dispatch (MT-S604) --------------------------------------
    sizes: Set[int] = set()
    sentinel = False
    for node in ast.walk(neg):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1:
            continue
        left, op, right = node.left, node.ops[0], node.comparators[0]
        rv = None
        if isinstance(right, ast.Constant) and isinstance(right.value, int):
            rv = right.value
        elif isinstance(right, ast.UnaryOp) and \
                isinstance(right.op, ast.USub) and \
                isinstance(right.operand, ast.Constant):
            rv = -right.operand.value
        if rv is None:
            continue
        if isinstance(op, ast.Eq) and isinstance(left, ast.Attribute) \
                and left.attr == "size":
            sizes.add(rv)
        elif isinstance(op, ast.Eq) and rv == -1:
            sentinel = True
    want_sizes = set(INIT_WORDS_TO_VERSION)
    for missing in sorted(want_sizes - sizes):
        findings.append(src.finding(
            "MT-S604", neg.lineno,
            f"_negotiate never dispatches on a {missing}-word INIT "
            f"(schema v{INIT_WORDS_TO_VERSION[missing]}) — a declared "
            "wire generation is unservable"))
    for extra in sorted(sizes - want_sizes):
        findings.append(src.finding(
            "MT-S604", neg.lineno,
            f"_negotiate dispatches on a {extra}-word INIT the schema "
            "does not declare — register the version in "
            "analysis/schema.py INIT_VERSIONS first"))
    if not sentinel:
        findings.append(src.finding(
            "MT-S604", neg.lineno,
            "_negotiate never tests the -1 shardctl sentinel (schema "
            "v4) — v4 announcements would be mis-parsed as a legacy "
            "length"))
    # -- flag lattice (MT-S605) ------------------------------------------
    resolve = _flag_resolver(neg)
    extracted = _extract_refusals(neg, resolve)
    got_rules = {(ante, missing) for ante, missing, _ in extracted}
    for ante, missing in sorted(REFUSALS,
                                key=lambda r: (sorted(r[0]), r[1])):
        if (ante, missing) not in got_rules:
            findings.append(src.finding(
                "MT-S605", neg.lineno,
                f"declared lattice rule '{'+'.join(sorted(ante))} "
                f"requires {missing}' is not enforced by any pure flag "
                "guard in _negotiate"))
    for ante, missing, line in extracted:
        if (ante, missing) not in REFUSALS:
            findings.append(src.finding(
                "MT-S605", line,
                f"_negotiate refuses '{'+'.join(sorted(ante))} without "
                f"{missing}', which the schema lattice does not declare "
                "— update REFUSALS in analysis/schema.py or fix the "
                "guard"))
    effective = _extract_effective(neg, resolve)
    for feature, (need, off) in sorted(EFFECTIVE.items()):
        got = effective.get(feature)
        if got is None:
            findings.append(src.finding(
                "MT-S605", neg.lineno,
                f"no effective-posture assignment for {feature} found in "
                "_negotiate (schema declares a negotiate-off rule for "
                "it)"))
        elif (got[0], got[1]) != (set(need), set(off)):
            findings.append(src.finding(
                "MT-S605", got[2],
                f"{feature} negotiates on under "
                f"requires={sorted(got[0])} off-with={sorted(got[1])}, "
                f"but the schema declares requires={sorted(need)} "
                f"off-with={sorted(off)}"))
    return findings


def _check_announce(src: SourceFile) -> List[Finding]:
    """MT-S604 (client side): every schema-declared announce builder
    must be what ps/client.py actually calls."""
    findings: List[Finding] = []
    called = {
        (n.func.attr if isinstance(n.func, ast.Attribute)
         else n.func.id if isinstance(n.func, ast.Name) else "")
        for n in ast.walk(src.tree) if isinstance(n, ast.Call)
    }
    for v in INIT_VERSIONS:
        if v.builder and v.builder not in called:
            findings.append(src.finding(
                "MT-S604", 1,
                f"ps/client.py never calls {v.builder}() — the v"
                f"{v.version} announcement is built somewhere the schema "
                "cannot vouch for"))
    return findings


def check(files: List[SourceFile]) -> List[Finding]:
    """The schema-conformance pass (wired into the mtlint engine)."""
    findings: List[Finding] = []
    for src in files:
        rel = src.rel
        for spec in WIRE_MODULES:
            # Scoped to files that declare at least one registry name:
            # ownership-discipline fixtures reuse a wire-module path
            # suffix (e.g. cells/wire.py) to pick up the declared pool
            # disciplines without carrying the full frame vocabulary.
            # The real module always declares some of them, so any
            # single deletion/drift still fails conformance.
            if rel.endswith(spec.suffix) and _declares_wire_names(spec, src):
                findings += _check_wire_module(spec, src)
        if rel.endswith("ps/tags.py"):
            findings += _check_tags_module(src)
        if rel.endswith("ps/server.py") and _defines_param_server(src.tree):
            # Scoped to the file that defines ParamServer (the contract
            # _check_negotiation documents): concurrency-discipline
            # fixtures reuse the ps/server.py path suffix to pick up the
            # declared disciplines without carrying a full INIT dispatch.
            findings += _check_negotiation(src)
        if rel.endswith("ps/client.py") and _defines_param_client(src.tree):
            # Same scoping for the client side (ParamClient).
            findings += _check_announce(src)
    return findings


# ---------------------------------------------------------------------------
# Generated documentation — PROTOCOL.md §1 / §6.0 tables
# ---------------------------------------------------------------------------

def _gen_begin(name: str) -> str:
    # The marker text is the JAX package's, character for character: one
    # PROTOCOL.md carries one wire, whose tables both registries render.
    return (f"<!-- BEGIN GENERATED: mtlint-schema {name} "
            "(edit analysis/schema.py, then `python -m mpit_tpu.analysis "
            "schema --emit-docs`) -->")


def _gen_end(name: str) -> str:
    return f"<!-- END GENERATED: mtlint-schema {name} -->"


def render_tag_table() -> str:
    lines = ["| Tag (id) | Direction | Payload | Pairs with |",
             "|---|---|---|---|"]
    for t in TAGS:
        lines.append(f"| `{t.name}` ({t.id}) | {t.direction} | {t.payload} "
                     f"| {t.pairs_with} |")
    return "\n".join(lines)


def render_init_table() -> str:
    lines = ["| version | bytes | payload | |",
             "|---|---|---|---|"]
    for v in INIT_VERSIONS:
        nbytes = str(v.nbytes) if v.nbytes > 0 else "≥ 64"
        payload = "`[" + ", ".join(v.fields) + "]`"
        lines.append(f"| v{v.version} | {nbytes} | {payload} | {v.note} |")
    return "\n".join(lines)


def render_flag_table() -> str:
    lines = ["| Flag (value) | Requires | Refused with | Negotiated off "
             "under | Meaning |",
             "|---|---|---|---|---|"]
    for f in FLAGS:
        req = list(f.requires)
        if f.version_only is not None:
            req.append(f"the v{f.version_only} announcement")
        if f.space == "v4":
            req.append("a v4 announcement")
        refused = ", ".join(
            f"`{other}`" + (f" (unless `{unless}`)" if unless else "")
            for other, unless in f.refused_with) or "—"
        off = []
        for need in f.active_requires:
            off.append(f"missing `{need}`")
        for o in f.off_with:
            off.append(f"`{o}`")
        lines.append(
            f"| `FLAG_{f.name}` ({f.bit}) | "
            + (", ".join(f"`{r}`" if not r.startswith("the ")
                         and not r.startswith("a ") else r
                         for r in req) or "—")
            + f" | {refused} | " + (", ".join(off) or "—")
            + f" | {f.meaning} |")
    return "\n".join(lines)


#: marker name -> renderer; PROTOCOL.md carries one BEGIN/END pair per
#: entry and `--emit-docs` rewrites exactly what sits between them.
DOC_SECTIONS = {
    "tag-table": render_tag_table,
    "init-table": render_init_table,
    "flag-table": render_flag_table,
}


def emit_docs(doc_path, check: bool = False) -> List[str]:
    """Rewrite (or, with ``check``, diff) the generated regions of
    ``doc_path``.  Returns the list of drift descriptions; empty means
    the doc already matches the registry.  Missing markers are drift —
    a hand-deleted generated table must fail the gate, not skip it."""
    import pathlib
    doc_path = pathlib.Path(doc_path)
    if not doc_path.is_file():
        return [f"{doc_path}: missing (generated tables have nowhere "
                "to live)"]
    text = doc_path.read_text(encoding="utf-8")
    drift: List[str] = []
    out = text
    for name, render in DOC_SECTIONS.items():
        begin, end = _gen_begin(name), _gen_end(name)
        i = out.find(begin)
        j = out.find(end)
        if i < 0 or j < 0 or j < i:
            drift.append(f"{doc_path.name}: generated marker pair for "
                         f"{name!r} not found")
            continue
        body = out[i + len(begin):j]
        want = "\n" + render() + "\n"
        if body != want:
            drift.append(f"{doc_path.name}: generated {name} drifted "
                         "from the schema registry")
            out = out[:i + len(begin)] + want + out[j:]
    if not check and out != text:
        doc_path.write_text(out, encoding="utf-8")
    return drift


# ---------------------------------------------------------------------------
# Handshake state machines (explored by mpit_tpu_torch.analysis.modelcheck)
# ---------------------------------------------------------------------------

#: Transition: (state, action, tag, peer, next_state, opts) with action
#: in {"send", "recv", "tau"} (tau transitions use tag for the label and
#: peer "").  opts: "expects" (ack tag this send awaits before the role
#: may rest at a terminal state), "drop"/"dup" (fault toggles the
#: protocol claims to tolerate on this hop).  Tags are message labels in
#: the model: wire tags verbatim, plus MAP_UPDATE kinds (RETIRE, DONE,
#: RETIRED, PREEMPT) spelled out — the §7.2 directive word is what
#: distinguishes them on the one MAP_UPDATE channel.
HANDSHAKES: Tuple[dict, ...] = (
    {
        "name": "init-grad-stop",
        "doc": "per-pair lifecycle (§2, §6.2): announce, framed write "
               "rounds with the GRAD_ACK tail, graceful stop; GRAD may "
               "duplicate (dedup re-acks)",
        "channel_cap": 2,
        "roles": {
            "client": {
                "start": "boot", "terminal": ["done"],
                "transitions": [
                    ("boot", "send", "INIT", "server", "running", {}),
                    ("running", "send", "GRAD", "server", "awaiting",
                     {"expects": "GRAD_ACK", "dup": True}),
                    ("awaiting", "recv", "GRAD_ACK", "server", "running",
                     {}),
                    # §6.2: stale/duplicate ack echoes are consumed and
                    # dropped — without this the dup toggle's extra ack
                    # would wedge the bounded ack channel.
                    ("running", "recv", "GRAD_ACK", "server", "running",
                     {}),
                    ("done", "recv", "GRAD_ACK", "server", "done", {}),
                    ("running", "send", "STOP", "server", "done", {}),
                ],
            },
            "server": {
                "start": "wait", "terminal": ["done"],
                "transitions": [
                    ("wait", "recv", "INIT", "client", "serving", {}),
                    ("serving", "recv", "GRAD", "client", "applying", {}),
                    ("applying", "send", "GRAD_ACK", "client", "serving",
                     {}),
                    ("serving", "recv", "STOP", "client", "done", {}),
                ],
            },
        },
    },
    {
        "name": "param-read",
        "doc": "the read rendezvous (§1): PARAM_REQ head, exactly one "
               "PARAM reply, never unsolicited",
        "channel_cap": 2,
        "roles": {
            "client": {
                "start": "running", "terminal": ["done"],
                "transitions": [
                    ("running", "send", "PARAM_REQ", "server", "waiting",
                     {"expects": "PARAM"}),
                    ("waiting", "recv", "PARAM", "server", "running", {}),
                    ("running", "send", "STOP", "server", "done", {}),
                ],
            },
            "server": {
                "start": "serving", "terminal": ["done"],
                "transitions": [
                    ("serving", "recv", "PARAM_REQ", "client", "replying",
                     {}),
                    ("replying", "send", "PARAM", "client", "serving", {}),
                    ("serving", "recv", "STOP", "client", "done", {}),
                ],
            },
        },
    },
    {
        "name": "retire",
        "doc": "scale-down (§9.2): drain, RETIRE directive, DONE echo, "
               "RETIRED broadcast — retire-vs-crash is first-class",
        "channel_cap": 2,
        "roles": {
            "controller": {
                "start": "idle", "terminal": ["done"],
                "transitions": [
                    ("idle", "send", "RETIRE", "server", "awaiting",
                     {"expects": "DONE"}),
                    ("awaiting", "recv", "DONE", "server", "committing",
                     {}),
                    ("committing", "send", "RETIRED", "client", "done",
                     {}),
                ],
            },
            "server": {
                "start": "owning", "terminal": ["exited"],
                "transitions": [
                    ("owning", "tau", "drain", "", "drained", {}),
                    ("drained", "recv", "RETIRE", "controller", "retiring",
                     {}),
                    ("retiring", "send", "DONE", "controller", "exited",
                     {}),
                ],
            },
            "client": {
                "start": "running", "terminal": ["done"],
                "transitions": [
                    ("running", "recv", "RETIRED", "controller", "done",
                     {}),
                ],
            },
        },
    },
    {
        "name": "preempt",
        "doc": "graceful preemption (§9.3): SIGTERM flag, checkpoint on "
               "the next poll, PREEMPT report; the controller drains "
               "when grace allows or leaves failover to the checkpoint",
        "channel_cap": 2,
        "roles": {
            "server": {
                "start": "running", "terminal": ["draining", "exited"],
                "transitions": [
                    ("running", "tau", "sigterm", "", "noticed", {}),
                    ("noticed", "tau", "checkpoint", "", "ready", {}),
                    ("ready", "send", "PREEMPT", "controller", "draining",
                     {}),
                    ("draining", "recv", "RETIRE", "controller",
                     "retiring", {}),
                    ("retiring", "send", "DONE", "controller", "exited",
                     {}),
                ],
            },
            "controller": {
                "start": "idle", "terminal": ["done"],
                "transitions": [
                    ("idle", "recv", "PREEMPT", "server", "deciding", {}),
                    ("deciding", "send", "RETIRE", "server", "awaiting",
                     {"expects": "DONE"}),
                    ("awaiting", "recv", "DONE", "server", "done", {}),
                    ("deciding", "tau", "leave_to_failover", "", "done",
                     {}),
                ],
            },
        },
    },
    {
        "name": "subscribe",
        "doc": "the diff stream (§11): FULL on attach, XOR deltas after "
               "every commit (drop-tolerated — DIFF_REQ resync is the "
               "recovery path), stop like any client",
        "channel_cap": 2,
        "roles": {
            "cell": {
                "start": "attach", "terminal": ["done"],
                "transitions": [
                    ("attach", "send", "INIT", "server", "syncing", {}),
                    ("syncing", "recv", "DIFF_FULL", "server", "installed",
                     {}),
                    ("syncing", "recv", "DIFF_DELTA", "server", "syncing",
                     {}),
                    ("installed", "recv", "DIFF_DELTA", "server",
                     "installed", {}),
                    ("installed", "tau", "gap_detected", "", "resync", {}),
                    ("resync", "send", "DIFF_REQ", "server", "syncing",
                     {}),
                    ("installed", "send", "STOP", "server", "done", {}),
                ],
            },
            "server": {
                "start": "wait", "terminal": ["done"],
                "transitions": [
                    ("wait", "recv", "INIT", "cell", "seeding", {}),
                    ("seeding", "send", "DIFF_FULL", "cell", "streaming",
                     {}),
                    ("streaming", "tau", "commit", "", "delta_ready", {}),
                    ("delta_ready", "send", "DIFF_DELTA", "cell",
                     "streaming", {"drop": True}),
                    ("streaming", "recv", "DIFF_REQ", "cell", "seeding",
                     {}),
                    ("streaming", "recv", "STOP", "cell", "done", {}),
                    ("delta_ready", "recv", "STOP", "cell", "done", {}),
                ],
            },
        },
    },
)


# ---------------------------------------------------------------------------
# CLI — python -m mpit_tpu_torch.analysis schema
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import pathlib

    ap = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.analysis schema",
        description="wire-schema registry tooling: generate the "
        "PROTOCOL.md §1/§6.0 tables and check the tree's conformance")
    ap.add_argument("--emit-docs", action="store_true",
                    help="rewrite the generated doc regions in place")
    ap.add_argument("--check", action="store_true",
                    help="report drift (doc AND code) without writing; "
                    "nonzero exit on any")
    ap.add_argument("--root", type=pathlib.Path, default=pathlib.Path("."),
                    help="tree root (contains docs/PROTOCOL.md and the "
                    "scanned modules; default: cwd)")
    args = ap.parse_args(argv)

    root = args.root.resolve()
    doc = root / "docs" / "PROTOCOL.md"
    scan = (root / "mpit_tpu_torch" if (root / "mpit_tpu_torch").is_dir()
            else root)
    rc = 0

    if args.check or not args.emit_docs:
        from mpit_tpu_torch.analysis.core import collect

        files, parse_failures = collect(scan)
        findings = list(parse_failures) + check(files)
        for f in sorted(findings, key=lambda f: f.sort_key()):
            print(f.render())
        if findings:
            rc = 1
        drift = emit_docs(doc, check=True)
        for d in drift:
            print(f"doc drift: {d}")
        if drift:
            rc = 1
        if rc == 0:
            print(f"schema: conformant ({len(files)} files, "
                  f"{len(TAGS)} tags, {len(FLAGS)} flags, "
                  f"{len(INIT_VERSIONS)} INIT versions)")
    if args.emit_docs and not args.check:
        drift = emit_docs(doc, check=False)
        unfixable = [d for d in drift if "not found" in d or "missing" in d]
        for d in drift:
            print(("rewrote: " if d not in unfixable else "") + d)
        if unfixable:
            rc = 1
        elif not drift:
            print(f"docs already match the registry ({doc})")
    return rc
