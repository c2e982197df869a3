"""AggClient — hierarchical quantized aggregation under the PS model.

The port of ``mpit_tpu/agg/client.py``.  A
:class:`~mpit_tpu_torch.ps.client.ParamClient` front (the ExchangeClient
shape) that turns N flat GRAD pushes into one: colocated clients
pre-reduce on the card through the group plane
(:mod:`mpit_tpu_torch.agg.node`) and representatives reduce across hosts
through a deterministic REDUCE tree (:mod:`mpit_tpu_torch.agg.plan`), so
the servers see a single gradient per round carrying the whole gang's fold
(PROTOCOL.md §13).  REDUCE frames and acks are the JAX package's bytes, so
port and JAX nodes form one tree.

The three invariants everything below is arranged around:

- **fixed reduction order** — every fold (group and tree) runs in
  ascending contributor-rank order over per-contributor staging, never
  in arrival order, so the pushed value is a pure function of the
  gradients and the plan: bitwise-reproducible whatever the wire did.
  Arrival order is still first-class — contributions *land* whenever
  they land (staged per sender, per chunk), only the fold is ordered.
- **exactly-once contribution** — REDUCE hops reuse the §12 chunk
  discipline ([epoch, seq] identity, per-chunk acks, resend-missing,
  per-(sender, seq, chunk) dedup), and the straggler path is
  all-or-nothing per sender: a sender is either folded into the round
  or LATE-acked and re-routed to a direct wire push of its partial —
  never half-included, so nothing is lost and nothing double-folds.
- **per-hop error feedback** — quantized hops (the int8 codec) hold the
  EF residual at the *sender* of each hop, folded exactly once per
  block at that hop's single encode; the representative's upstream
  push uses the inner client's own per-server residual unchanged.

Straggling: a node waits ``AggConfig.deadline_s`` (wall-bounded) for
missing contributions, then folds what it has and moves on — the late
sender's contribution arrives at the server via its own direct push
(loud, counted).  A sender that *committed* to the round (delivered its
first chunk on time) and then goes silent fails loudly after the hard
bound — RetryExhausted with a flight dump, never a hang.

The group fold on the card: a member hands its representative a card
copy of its gradient mirror, made at submit on the member's stream with a
CUDA event recorded behind it; the representative's stream waits on the
event and records itself as a user of the tensor
(:func:`~mpit_tpu_torch.dplane.exchange.take`), then :func:`card_fold`
adds the members to the representative's own gradient one ``torch.add``
at a time in ascending rank order and copies the sum to the host once.
Float32 adds are exact IEEE operations on both devices, so the card fold
equals the host fold bit for bit; a reduction kernel would not (its
summation order is not the rank order).  On the CPU the fold stays the
host ``+=``, as in the JAX package.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict, Generator, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from mpit_tpu_torch.agg import node as agg_node
from mpit_tpu_torch.agg.plan import AggConfig, ReductionPlan
from mpit_tpu_torch.agg.wire import (
    RD_ACK_WORDS,
    RD_HDR_BYTES,
    RD_LATE,
    RD_OK,
    pack_reduce_header,
    reduce_ack_frame,
    unpack_reduce_header,
)
from mpit_tpu_torch.aio import EXEC, aio_send, deadline_at
from mpit_tpu_torch.comm import pool as comm_pool
from mpit_tpu_torch.dplane.exchange import mark_ready, take
from mpit_tpu_torch.ft import (
    RetryExhausted,
    chunk_elems_for,
    chunk_spans,
    chunk_stride,
    pack_chunk_header,
    pack_tx_stamp,
)
from mpit_tpu_torch.obs import clock as obs_clock
from mpit_tpu_torch.obs.flight import get_flight
from mpit_tpu_torch.obs.metrics import obs_enabled, registry_or_local
from mpit_tpu_torch.obs.spans import get_recorder
from mpit_tpu_torch.obs.statusd import register_provider as register_status_provider
from mpit_tpu_torch.ps import tags
from mpit_tpu_torch.utils.logging import get_logger
from mpit_tpu_torch.utils.platform import resolve_device

#: default REDUCE hop chunk size when neither AggConfig nor FTConfig
#: pins one (1 MiB of float32 — block-aligned by construction).
DEFAULT_CHUNK_BYTES = 1 << 20


def card_fold(out: np.ndarray, base: np.ndarray,
              tickets: Sequence[agg_node.AggTicket], device: torch.device) -> None:
    """``out = ((base + t0) + t1) + ...`` on ``device``, the tickets' card
    payloads added one ``torch.add`` at a time in the given (ascending
    rank) order, then one copy to the host.  The current stream waits on
    each payload's ready event and becomes a user of its memory first."""
    fold = torch.from_numpy(base).to(device, copy=True)
    for ticket in tickets:
        take(ticket.payload, ticket.ready)
        fold = torch.add(fold, ticket.payload)
    np.copyto(out, fold.cpu().numpy())


class _ChildRound:
    """One child's staged contribution to one round: per-chunk decoded
    float32 spans plus the admission set (the per-(sender, seq, chunk)
    dedup state — a duplicate chunk re-acks, never re-folds)."""

    __slots__ = ("buf", "seen", "count", "nfold")

    def __init__(self, size: int):
        self.buf = np.zeros(size, np.float32)
        self.seen: Set[int] = set()
        self.count = 0
        self.nfold = 0


class AggClient:
    """ParamClientAPI front implementing the §13 aggregation modes.

    ``mode='off'`` is a strict passthrough (byte-for-byte the flat
    wire).  ``'prereduce'`` folds colocated groups on-device and has
    every representative push its group's fold.  ``'tree'`` adds the
    cross-host REDUCE tree: only the root pushes upstream."""

    def __init__(self, inner, cranks: List[int],
                 cfg: Optional[AggConfig] = None, namespace: str = "",
                 device: Any = None):
        self.pc = inner
        self.cfg = cfg if cfg is not None else AggConfig.from_env()
        self.namespace = namespace
        #: the group plane's device (None: the card): members hand card
        #: tensors to a card representative, host copies to a CPU one
        self._device_name = device
        self._device: Optional[torch.device] = None
        self.rank = inner.rank
        self.log = get_logger("agg", inner.rank)
        self._enabled = self.cfg.enabled
        if self._enabled and getattr(inner, "_sc", False):
            raise ValueError(
                "aggregation composes with the static shard map only — "
                "shardctl ops re-route mid-reduction (no single fold "
                "point); run --agg off under shardctl")
        if self._enabled and not inner.ft.framed:
            raise ValueError(
                "aggregation needs op deadlines + retry (FTConfig."
                "op_deadline_s > 0): REDUCE hops ride the [epoch, seq] "
                "resend/dedup discipline")
        self.plan = ReductionPlan.build(
            cranks, groups=self.cfg.groups, fanin=self.cfg.fanin,
            seed=self.cfg.tree_seed) if self._enabled else None
        tree = self._enabled and self.cfg.mode == "tree"
        self._is_rep = bool(self._enabled and self.plan.is_rep(self.rank))
        self._members = self.plan.members(self.rank) if self._is_rep else []
        self._parent = (self.plan.parent(self.rank)
                        if tree and self._is_rep else None)
        self._children = (self.plan.children(self.rank)
                          if tree and self._is_rep else [])
        #: round counter == the REDUCE op seq (one reduction per round,
        #: strictly serialized — the §12 one-op-in-flight shape).
        self._round = 0
        self._folded_round = 0
        #: the last round whose fold is complete (gates the root's queued
        #: whole-frame push)
        self._fold_done = 0
        self._plane: Optional[agg_node.AggPlane] = None
        self._rep_plane: Optional[agg_node.AggPlane] = None
        self._tickets: List[agg_node.AggTicket] = []
        #: rep: tickets stashed by round (arrival order is free; the
        #: fold order is not)
        self._pending_tickets: Dict[int, Dict[int, agg_node.AggTicket]] = {}
        #: rep: per-child staged rounds + per-(child, round) outcomes
        self._child_rounds: Dict[int, Dict[int, _ChildRound]] = {
            c: {} for c in self._children}
        self._child_outcome: Dict[int, Dict[int, str]] = {
            c: {} for c in self._children}
        #: serialized reduction rounds (the _scq pattern)
        self._aggq: Deque[Tuple[Generator, str]] = deque()
        self._agg_pump_live = False
        self._agg_pump_task: Optional[object] = None
        # buffers sized at start() when the vector length is known
        self._ugrad: Optional[np.ndarray] = None
        self._uparam: Optional[np.ndarray] = None
        self._acc: Optional[np.ndarray] = None
        self._own: Optional[np.ndarray] = None
        self._spans_of: List[Tuple[int, int]] = []
        self._stride = 0
        self._rd_wire: Optional[np.ndarray] = None
        self._rd_rx: Optional[np.ndarray] = None
        self._rd_ack: Optional[np.ndarray] = None
        self._hop_residual: Optional[np.ndarray] = None
        self._on_cpu = True  # resolved at start() (the plane's device)
        self._spans = get_recorder()
        self._flight = get_flight()
        _m = registry_or_local()
        self._m_rounds = _m.counter("mpit_agg_rounds_total", rank=self.rank)
        self._m_late = _m.counter("mpit_agg_late_folds_total",
                                  rank=self.rank)
        self._m_fallbacks = _m.counter("mpit_agg_direct_fallbacks_total",
                                       rank=self.rank)
        self._m_chunks = _m.counter("mpit_agg_chunks_forwarded_total",
                                    rank=self.rank)
        self._m_fanin = _m.gauge("mpit_agg_fanin", rank=self.rank)
        self._m_group = _m.gauge("mpit_agg_group_size", rank=self.rank)
        if obs_enabled():
            register_status_provider(f"agg{self.rank}",
                                     self._status_section)

    # -- mirrors (the optimizer-facing buffers stay the user's) --------------

    @property
    def param(self) -> np.ndarray:
        return self._uparam if self._uparam is not None else self.pc.param

    @property
    def grad(self) -> np.ndarray:
        return self._ugrad if self._ugrad is not None else self.pc.grad

    @property
    def codec(self):
        return self.pc.codec

    @property
    def ft(self):
        return self.pc.ft

    @property
    def retries(self) -> int:
        return self.pc.retries

    def residual_norm(self) -> float:
        base = self.pc.residual_norm()
        if self._hop_residual is None:
            return base
        hop = float(np.dot(self._hop_residual, self._hop_residual))
        return float(np.sqrt(base * base + hop))

    # -- live introspection --------------------------------------------------

    def _status_section(self) -> Dict[str, object]:
        role = "flat"
        if self._enabled:
            if not self._is_rep:
                role = "member"
            elif self._parent is None and self.cfg.mode == "tree":
                role = "root"
            elif self._children or self._parent is not None:
                role = "interior" if self._children else "leaf"
            else:
                role = "rep"
        return {
            "role": "agg",
            "rank": self.rank,
            "mode": self.cfg.mode,
            "agg_role": role,
            "rep": self.plan.rep(self.rank) if self._enabled else None,
            "parent": self._parent,
            "children": list(self._children),
            "group": ([self.rank] + self._members) if self._is_rep else [],
            "round": self._folded_round,
            "fanin": int(self._m_fanin.value),
            "late_folds": int(self._m_late.value),
            "fallbacks": int(self._m_fallbacks.value),
        }

    # -- lifecycle -----------------------------------------------------------

    def start(self, param: np.ndarray, grad: np.ndarray) -> None:
        """Wire handshake first (INIT/seed are protocol, not data), then
        publish/attach the group plane and size the reduction staging."""
        if self._enabled and param.dtype != np.float32:
            raise ValueError(
                "aggregation folds float32 gradients; got dtype "
                f"{param.dtype} (run --agg off for other dtypes)")
        self.pc.start(param, grad)
        self._uparam, self._ugrad = param, grad
        if not self._enabled:
            return
        self._device = (self._device_name if isinstance(self._device_name, torch.device)
                        else resolve_device(self._device_name))
        self._on_cpu = self._device.type == "cpu"
        size = len(param)
        if self._is_rep:
            # The representative's inner client ships the *fold*, never
            # its raw mirror: retarget the inner grad buffer onto the
            # accumulator (reset keeps shards + residuals intact).
            self._acc = np.zeros(size, np.float32)
            self._own = np.zeros(size, np.float32)
            self.pc.reset(param, self._acc)
            self._m_group.set(1 + len(self._members))
            if self._members:
                self._plane = agg_node.publish(self.rank, self.namespace,
                                               self._device)
            chunk_bytes = (self.cfg.chunk_bytes
                           or self.pc.ft.chunk_bytes
                           or DEFAULT_CHUNK_BYTES)
            chunk_elems = chunk_elems_for(chunk_bytes, 4)
            self._spans_of = chunk_spans(size, chunk_elems)
            full = min(chunk_elems, size)
            cbody = self.pc.codec.wire_nbytes(full)
            self._stride = chunk_stride(RD_HDR_BYTES, cbody)
            if self._children:
                self._rd_rx = np.zeros(self._stride, np.uint8)
            if self._parent is not None:
                self._rd_wire = np.zeros(
                    self._stride * len(self._spans_of), np.uint8)
                self._rd_ack = np.zeros(RD_ACK_WORDS, np.int64)
                if self.pc.codec.uses_residual:
                    self._hop_residual = np.zeros(size, np.float32)
        else:
            # Member: attach to the representative's plane, verifying
            # the declared colocation against the dplane fingerprint —
            # a misdeclared group must fail loudly, not fold garbage.
            rep = self.plan.rep(self.rank)
            bound = time.monotonic() + max(self.cfg.deadline_s, 1.0) * 4
            while True:
                plane = agg_node.lookup(rep, self.namespace)
                if plane is not None:
                    break
                if time.monotonic() > bound:
                    raise agg_node.AggPlaneClosed(
                        f"representative {rep} never published a group "
                        f"plane for rank {self.rank} (is it running in "
                        "this process with --agg on?)")
                self.pc.ping()
                time.sleep(0.002)
            fp = agg_node.backend_fingerprint(self._device)
            if plane.fingerprint != fp:
                raise ValueError(
                    f"rank {self.rank} is declared colocated with rep "
                    f"{rep} but backend fingerprints differ "
                    f"({fp} vs {plane.fingerprint}) — fix the --agg "
                    "group declaration")
            self._rep_plane = plane

    def reset(self, param: np.ndarray, grad: np.ndarray) -> None:
        if self._enabled and self._is_rep:
            self.pc.reset(param, self._acc)
            self._uparam, self._ugrad = param, grad
            return
        self.pc.reset(param, grad)
        self._uparam, self._ugrad = param, grad

    # -- ParamClientAPI ------------------------------------------------------

    def async_send_grad(self) -> None:
        if not self._enabled:
            self.pc.async_send_grad()
            return
        self._round += 1
        if self._is_rep:
            self._enqueue_round(self._reduce_round(self._round),
                                f"reduce:{self._round}")
            return
        # Member: hand the gradient to the representative as a
        # submit-time snapshot (the mirror may be rewritten the moment
        # wait() returns), arrival-order free.  On the card the snapshot
        # is a card copy made on this thread's stream, with an event
        # behind it for the representative's stream to wait on, and the
        # fold runs as card adds; on the CPU a card round-trip would only
        # re-buy the same IEEE adds at copy cost, so the snapshot stays a
        # host copy — bitwise-identical fold either way (float32 addition
        # is the op, not the device).
        ready = None
        if self._on_cpu:
            payload = self._ugrad.copy()
        else:
            payload = torch.from_numpy(self._ugrad).to(self._device, copy=True)
            ready = mark_ready(payload)
        ticket = agg_node.AggTicket(self.rank, self._round, payload, ready)
        self._rep_plane.submit(ticket)
        self._tickets.append(ticket)

    def async_recv_param(self) -> None:
        self.pc.async_recv_param()

    def async_send_param(self) -> None:
        self.pc.async_send_param()

    def ping(self, n: int = 1) -> None:
        if self._is_rep:
            self._drain_plane(folding=None)
            if self._children and not self._agg_pump_live \
                    and self._rd_rx is not None:
                # Idle between rounds: stale REDUCE frames (a straggler
                # retrying into dead air) still get their definitive
                # answer — LATE for excluded rounds, OK re-acks for
                # folded ones — so a late child re-routes instead of
                # burning its whole retry budget against silence.
                self._drain_children(self._folded_round + 1, set())
        self.pc.ping(n)

    def wait(self) -> None:
        self.pc.wait()
        if not self._enabled or self._is_rep:
            return
        tickets, self._tickets = self._tickets, []
        hard = max(self.cfg.deadline_s, 0.1) * (
            self.pc.ft.max_retries + 2) + 30.0
        for ticket in tickets:
            bound = time.monotonic() + hard
            while not ticket.event.wait(0.002):
                self.pc.ping()
                if self._rep_plane.folded_round >= ticket.round \
                        and not ticket.event.is_set():
                    # The round is definitively over without us (the
                    # fold can no longer include this ticket) — don't
                    # wait for the idle rep to drain its queue.
                    ticket.resolve(agg_node.TICKET_LATE)
                    break
                if time.monotonic() > bound:
                    raise agg_node.AggPlaneClosed(
                        f"rank {self.rank}'s round {ticket.round} ticket "
                        f"was never resolved by rep "
                        f"{self.plan.rep(self.rank)} within {hard:.0f}s")
            if ticket.error is not None:
                raise ticket.error
            if ticket.status == agg_node.TICKET_LATE:
                self._direct_fallback(f"group round {ticket.round}")

    def stop(self) -> None:
        if self._plane is not None:
            agg_node.withdraw(self.rank, self.namespace)
            self._plane = None
        self.pc.stop()

    def enqueue_wire_op(self, srank: int, gen: Generator,
                        name: str) -> None:
        self.pc.enqueue_wire_op(srank, gen, name)

    # -- the direct-push fallback (the LATE re-route) ------------------------

    def _direct_fallback(self, why: str) -> None:
        """Push this node's partial (members: the raw mirror; reps: the
        accumulator the inner client already targets) as a plain GRAD —
        the contribution arrives exactly once, one fold later."""
        self._m_fallbacks.inc()
        self.log.warning(
            "late for %s: falling back to a direct GRAD push", why)
        for srank, shard in zip(self.pc.sranks, self.pc.shards):
            self.pc.enqueue_wire_op(
                srank, self.pc._send_grad(srank, shard), "send_grad")
        self.pc.wait()

    # -- group-plane draining ------------------------------------------------

    def _drain_plane(self, folding: Optional[int]) -> None:
        """Pop every queued ticket: stash rounds still foldable, LATE
        anything whose round already folded (a straggler that missed
        its fold must learn immediately, not at the next round)."""
        if self._plane is None:
            return
        while True:
            ticket = self._plane.pop()
            if ticket is None:
                return
            if ticket.round <= self._folded_round and \
                    ticket.round != folding:
                # Counted at exclusion time (_group_fold); here the
                # straggler merely *learns* so it can re-route now.
                ticket.resolve(agg_node.TICKET_LATE)
                continue
            self._pending_tickets.setdefault(ticket.round, {})[
                ticket.rank] = ticket

    # -- the reduction round (representatives) -------------------------------

    def _enqueue_round(self, gen: Generator, name: str) -> None:
        self._aggq.append((gen, name))
        if not self._agg_pump_live:
            self._agg_pump_live = True
            self._agg_pump_task = None
            task = self.pc.sched.spawn(self._agg_pump(),
                                       name=f"aggpump:{name}")
            self._agg_pump_task = task

    def _agg_pump(self):
        """Rounds run strictly in order — the accumulator and the hop
        residual are per-node singletons, and the one-op-in-flight
        shape is what keeps the per-(sender, seq) dedup complete."""
        queue = self._aggq
        try:
            while queue:
                gen, name = queue.popleft()
                task = self._agg_pump_task
                if task is not None:
                    task.name = f"aggpump:{name}"
                yield from gen
        finally:
            self._agg_pump_live = False

    def _chunk_body(self, elems: int) -> int:
        return self.pc.codec.wire_nbytes(elems)

    def _group_fold(self, seq: int, span) -> int:
        """Phase 1: collect the colocated members' tickets (device
        plane), fold on the plane's device in ascending rank order into
        ``_own``.  Returns the number of gradients folded (group fan-in)."""
        span.mark("group")
        bound = time.monotonic() + self.cfg.deadline_s
        want = set(self._members)
        while want - set(self._pending_tickets.get(seq, {})):
            self._drain_plane(folding=seq)
            if not (want - set(self._pending_tickets.get(seq, {}))):
                break
            if time.monotonic() > bound:
                break
            yield EXEC
        arrived = self._pending_tickets.pop(seq, {})
        late = want - set(arrived)
        if self._on_cpu:
            np.copyto(self._own, self._ugrad)
            for m in sorted(arrived):
                self._own += arrived[m].payload
        else:
            card_fold(self._own, self._ugrad,
                      [arrived[m] for m in sorted(arrived)], self._device)
        for m in sorted(arrived):
            arrived[m].resolve(agg_node.TICKET_OK)
        for m in sorted(late):
            # Resolved the moment its ticket shows up (_drain_plane);
            # count the exclusion here, where the fold decided it.
            self._m_late.inc()
            self.log.warning(
                "round %d folded without colocated rank %d "
                "(straggler deadline %.1fs)", seq, m, self.cfg.deadline_s)
        span.note(group=1 + len(arrived), group_late=len(late))
        return 1 + len(arrived)

    def _ack_child(self, child: int, epoch: int, seq: int, idx: int,
                   status: int) -> None:
        self.pc.sched.spawn(
            aio_send(self.pc.transport,
                     reduce_ack_frame(epoch, seq, idx, status), child,
                     tags.REDUCE_ACK, live=self.pc.live,
                     deadline=deadline_at(self.pc.ft.op_deadline_s or 5.0)),
            name=f"agg:ack:{child}:{seq}:{idx}")

    def _drain_children(self, seq: int, late_children: Set[int]) -> None:
        """Admit every waiting REDUCE frame from every child: decode
        into the (child, round) staging, ack OK on admission, re-ack
        duplicates, LATE anything for a round (or a child) the fold
        already excluded.  Never blocks — arrival order is free."""
        epoch = self.pc.ft.epoch
        for child in self._children:
            while self.pc.transport.iprobe(child, tags.REDUCE):
                handle = self.pc.transport.irecv(child, tags.REDUCE,
                                                 out=self._rd_rx)
                while not self.pc.transport.test(handle):
                    pass  # iprobe saw a fully-assembled message
                fepoch, fseq, idx, count, nfold = unpack_reduce_header(
                    self._rd_rx)
                if fepoch < epoch:
                    continue  # dead incarnation's leftovers: drop
                if fepoch > epoch:
                    raise RuntimeError(
                        f"REDUCE from rank {child} is ahead of this "
                        f"epoch: got {fepoch}, at {epoch}")
                outcome = self._child_outcome[child].get(fseq)
                if fseq <= self._folded_round or outcome is not None \
                        or (fseq == seq and child in late_children):
                    # A finished (or excluded) round's chunk: re-ack
                    # with its recorded outcome so a sender that lost
                    # acks still converges — folded re-acks OK, late
                    # re-acks LATE (and is counted once, at exclusion).
                    status = (RD_OK if outcome == "folded" else RD_LATE)
                    self._ack_child(child, fepoch, fseq, idx, status)
                    continue
                if fseq > seq + 1:
                    continue  # too far ahead: no ack, the resend waits
                rounds = self._child_rounds[child]
                state = rounds.get(fseq)
                if state is None:
                    state = rounds[fseq] = _ChildRound(len(self._acc))
                if idx in state.seen or not (0 <= idx <
                                             len(self._spans_of)):
                    self._ack_child(child, fepoch, fseq, idx, RD_OK)
                    continue
                lo, hi = self._spans_of[idx]
                body = self._rd_rx[RD_HDR_BYTES:
                                   RD_HDR_BYTES + self._chunk_body(hi - lo)]
                if self.pc.codec.identity:
                    state.buf[lo:hi].view(np.uint8)[:] = body
                else:
                    self.pc.codec.decode_into(body, state.buf[lo:hi])
                state.seen.add(idx)
                state.count = count
                state.nfold = int(nfold)
                self._ack_child(child, fepoch, fseq, idx, RD_OK)

    def _reduce_round(self, seq: int):
        """One full reduction at this node: group fold, then the
        chunk-granular tree fold — chunk k folds (and forwards, when
        there is a parent) the moment every committed child delivered
        it, while chunk k+1 is still arriving — then the upstream push
        (root) or the per-chunk ack wait (interior/leaf)."""
        span = self._spans.op(
            "REDUCE",
            peer=self._parent if self._parent is not None else "root",
            side="client", rank=self.rank)
        span.note(epoch=self.pc.ft.epoch, seq=seq,
                  chunks=len(self._spans_of))
        # Root + chunked upstream wire: the §13.3/§12 pipeline
        # composition — gated GRAD streams start NOW and ship each
        # server chunk the moment the fold covers it, so the upstream
        # wire moves while later REDUCE chunks are still arriving.
        self._fold_elems = 0
        self._fold_failed = False
        streaming_push = (self._parent is None and self.pc._chunked)
        if streaming_push:
            for srank, shard in zip(self.pc.sranks, self.pc.shards):
                self.pc.enqueue_wire_op(
                    srank, self._gated_push(srank, shard), "send_grad")
        elif self._parent is None:
            # The root's whole-frame push rides the inner client's
            # per-server FIFO as well, gated on this round's fold (the JAX
            # client pushes it from this task, beside the FIFO): a PARAM
            # read queued after the round's GRAD then reads its apply, so a
            # one-worker gang repeats bit for bit.
            for srank, shard in zip(self.pc.sranks, self.pc.shards):
                self.pc.enqueue_wire_op(
                    srank, self._gated_send(srank, shard, seq), "send_grad")
        nfold = yield from self._group_fold(seq, span)
        nchunks = len(self._spans_of)
        t0 = time.monotonic()
        soft = t0 + self.cfg.deadline_s
        hard = t0 + max(self.cfg.deadline_s, 0.1) * (
            self.pc.ft.max_retries + 2) + 30.0
        fold_set: Optional[List[int]] = None
        late_children: Set[int] = set()
        ready = 0
        inflight: Dict[int, object] = {}  # chunk -> send handle
        sent: Set[int] = set()
        acked = [False] * nchunks
        remaining_acks = nchunks if self._parent is not None else 0
        fallback = False
        attempt = 0
        op_dl = self.pc.ft.op_deadline_s or 5.0
        resend_at = time.monotonic() + op_dl
        if not self._children:
            fold_set = []
        pool = comm_pool.get_pool()
        fold_jobs: Dict[int, object] = {}
        span.mark("fold")
        while ready < nchunks or (remaining_acks and not fallback):
            if self._children:
                self._drain_children(seq, late_children)
            # Pump outstanding chunk sends (transports whose progress
            # rides test()); FIFO prefix only, the §12 O(1) discipline.
            for k in sorted(inflight):
                if not self.pc.transport.test(inflight[k]):
                    break
                del inflight[k]
            if fold_set is None:
                have0 = [c for c in self._children
                         if seq in self._child_rounds[c]
                         and 0 in self._child_rounds[c][seq].seen]
                if len(have0) == len(self._children):
                    fold_set = sorted(have0)
                elif time.monotonic() > soft:
                    fold_set = sorted(have0)
                    late_children = set(self._children) - set(fold_set)
                    for c in sorted(late_children):
                        self._m_late.inc()
                        self._child_outcome[c][seq] = "late"
                        self._child_rounds[c].pop(seq, None)
                        self.log.warning(
                            "round %d folding without child %d "
                            "(straggler deadline %.1fs)", seq, c,
                            self.cfg.deadline_s)
                    span.mark("late")
                    span.note(late=len(late_children))
            if fold_set is not None:
                while ready < nchunks and all(
                        ready in self._child_rounds[c][seq].seen
                        for c in fold_set):
                    # Fused fold through the pool seam: one single-pass
                    # kernel replaces copyto + one += sweep per child,
                    # preserving the serial loop's exact association
                    # order ((own + c0) + c1) + ... over the *sorted*
                    # fold_set — the bitwise anchor.  With workers the
                    # fold of chunk k runs off-thread while chunk k+1's
                    # REDUCE frames are still arriving; serial runs it
                    # inline (same bytes either way).
                    if ready not in fold_jobs:
                        fold_jobs[ready] = self._submit_fold(
                            seq, fold_set, ready)
                    nxt = ready + 1
                    if (not pool.serial and nxt < nchunks
                            and nxt not in fold_jobs
                            and all(nxt in self._child_rounds[c][seq].seen
                                    for c in fold_set)):
                        fold_jobs[nxt] = self._submit_fold(
                            seq, fold_set, nxt)
                    if not fold_jobs[ready].done():
                        break  # keep draining children; collect next pass
                    if ready == 0:
                        nfold += sum(self._child_rounds[c][seq].nfold
                                     for c in fold_set)
                    if self._parent is not None and not fallback:
                        inflight[ready] = self._forward_chunk(
                            seq, ready, nchunks, nfold)
                        sent.add(ready)
                    ready += 1
                    self._fold_elems = self._spans_of[ready - 1][1]
                    if ready == nchunks:
                        span.mark("forward")
                        resend_at = time.monotonic() + op_dl
                        for c in fold_set:
                            self._child_outcome[c][seq] = "folded"
                            self._child_rounds[c].pop(seq, None)
                            self._prune_outcomes(c)
                    yield EXEC
            if self._parent is not None and not fallback:
                late = yield from self._drain_parent_acks(seq, acked)
                newly = sum(acked) - (nchunks - remaining_acks)
                if newly:
                    remaining_acks -= newly
                    resend_at = time.monotonic() + op_dl
                if late:
                    # The parent folded without us: finish the local
                    # fold (our children are still committed to THIS
                    # node) and push the partial directly.
                    fallback = True
                    remaining_acks = 0
            if self._parent is not None and not fallback \
                    and remaining_acks and ready == nchunks \
                    and time.monotonic() > resend_at:
                attempt += 1
                if attempt > self.pc.ft.max_retries:
                    span.end("exhausted")
                    self._fold_failed = True
                    self._flight_dump("agg_retry_exhausted", seq=seq,
                                      peer=self._parent)
                    raise RetryExhausted(
                        f"REDUCE to rank {self._parent} (round {seq})",
                        attempt, None)
                span.mark("backoff")
                span.note(retries=attempt)
                for k in range(nchunks):
                    if acked[k] or k not in sent:
                        continue
                    # A still-pending stale handle returns buffer
                    # ownership before the re-post; the parent dedups
                    # any frame that made it through anyway.
                    stale = inflight.pop(k, None)
                    if stale is not None and \
                            not self.pc.transport.test(stale):
                        self.pc.transport.cancel(stale)
                    span.mark("chunk")
                    inflight[k] = self._forward_chunk(
                        seq, k, nchunks, nfold, resend=True)
                resend_at = time.monotonic() + op_dl
            if time.monotonic() > hard:
                span.end("exhausted")
                self._fold_failed = True
                self._flight_dump("agg_round_stalled", seq=seq,
                                  ready=ready, remaining=remaining_acks)
                raise RetryExhausted(
                    f"reduction round {seq} stalled at rank {self.rank} "
                    f"(ready {ready}/{nchunks}, {remaining_acks} acks "
                    "outstanding)", attempt + 1, None)
            if ready < nchunks or (remaining_acks and not fallback):
                yield EXEC
        while inflight:
            # Buffer ownership must return before the round ends — the
            # next round re-encodes the same staging slots.
            for k in sorted(inflight):
                if not self.pc.transport.test(inflight[k]):
                    break
                del inflight[k]
            if inflight:
                yield EXEC
        span.note(nfold=nfold)
        self._fold_done = seq
        self._folded_round = seq
        if self._plane is not None:
            self._plane.folded_round = seq
        # Tickets that arrived after this round's group fold decided:
        # resolved LATE now (their exclusion was already counted).
        for rnd in [r for r in self._pending_tickets if r <= seq]:
            for ticket in self._pending_tickets.pop(rnd).values():
                ticket.resolve(agg_node.TICKET_LATE)
        self._m_rounds.inc()
        self._m_fanin.set(nfold)
        if fallback:
            # The LATE re-route: the inner client's grad buffer IS the
            # accumulator — ship it through the standard framed/chunked
            # GRAD path, per-server residuals intact.
            self._m_fallbacks.inc()
            span.note(fallback=1)
            self.log.warning(
                "round %d LATE at parent %d: pushing the partial "
                "directly", seq, self._parent)
            span.mark("send")
            for srank, shard in zip(self.pc.sranks, self.pc.shards):
                yield from self.pc._send_grad(srank, shard)
        elif self._parent is None:
            span.mark("send")  # the queued pushes own the wire from here
        span.end("ok")
        return True

    def _submit_fold(self, seq: int, fold_set: List[int], idx: int):
        """One pure fold job for chunk ``idx``: own + every committed
        child's chunk, in sorted ``fold_set`` order, into the disjoint
        accumulator slice.  Operands are quiescent until collection —
        child round buffers are only retired after the round's last
        fold is collected, and the Job pins them regardless."""
        lo, hi = self._spans_of[idx]
        return comm_pool.get_pool().submit_fold_f32(
            self._own[lo:hi],
            [self._child_rounds[c][seq].buf[lo:hi] for c in fold_set],
            self._acc[lo:hi])

    def _forward_chunk(self, seq: int, idx: int, count: int, nfold: int,
                       resend: bool = False):
        """Encode chunk ``idx`` of the accumulator into its staging slot
        (exactly once — the hop residual folds at this single encode;
        resends reuse the staged bytes) and post it to the parent.
        Returns the transport send handle."""
        frame = self._rd_wire[idx * self._stride:
                              (idx + 1) * self._stride]
        if not resend:
            lo, hi = self._spans_of[idx]
            body = frame[RD_HDR_BYTES:
                         RD_HDR_BYTES + self._chunk_body(hi - lo)]
            if self.pc.codec.identity:
                body[:] = self._acc[lo:hi].view(np.uint8)
            else:
                residual = (self._hop_residual[lo:hi]
                            if self._hop_residual is not None else None)
                self.pc.codec.encode_into(self._acc[lo:hi], body,
                                          residual=residual)
            pack_reduce_header(frame, self.pc.ft.epoch, seq, idx, count,
                               nfold)
            self._m_chunks.inc()
        return self.pc.transport.isend(frame, self._parent, tags.REDUCE)

    def _gated_send(self, srank: int, shard, seq: int):
        """The root's whole-frame GRAD of round ``seq`` from the inner
        client's per-server FIFO, posted once the round's fold is complete
        (the accumulator is the inner client's grad buffer)."""
        while self._fold_done < seq:
            if self._fold_failed or not self.pc.live.io:
                return None
            yield EXEC
        yield from self.pc._send_grad(srank, shard)

    def _gated_push(self, srank: int, shard):
        """The root's streamed upstream GRAD, gated on fold progress
        (§13.3 composing with §12): chunk k of this server's shard is
        encoded from the accumulator and posted the moment the fold
        covers its elements — the upstream wire moves while later
        REDUCE chunks are still arriving.  Ack handling, missing-chunk
        resends and the int8 per-server residual ride the inner
        client's own chunk machinery unchanged."""
        pc = self.pc
        span = pc._spans.op("GRAD", peer=srank, side="client",
                            rank=pc.rank)
        spans_ = pc._chunk_spans[srank]
        stride = pc._chunk_stride[srank]
        staging = pc._grad_wire[srank]
        view = pc.grad[shard.offset: shard.end]
        residual = pc._residual.get(srank)
        gseq = pc._next_seq(srank, tags.GRAD)
        nchunks = len(spans_)
        span.note(epoch=pc.ft.epoch, seq=gseq, chunks=nchunks)
        span.mark("encode")
        pending: Dict[int, object] = {}
        for k, (lo, hi) in enumerate(spans_):
            while self._fold_elems < shard.offset + hi:
                if self._fold_failed or not pc.live.io:
                    span.end("aborted")
                    return None
                yield EXEC
            frame = staging[k * stride: (k + 1) * stride]
            body = frame[pc._chdr: pc._chdr + pc.codec.wire_nbytes(hi - lo)]
            if pc.codec.identity:
                body[:] = view[lo:hi].view(np.uint8)
            else:
                pc.codec.encode_into(
                    view[lo:hi], body,
                    residual=None if residual is None else residual[lo:hi])
            pack_chunk_header(frame, pc.ft.epoch, gseq, k, nchunks)
            if pc._timing:
                pack_tx_stamp(frame, pc._chdr, obs_clock.wall_us())
            span.mark("send" if k == 0 else "chunk")
            pending[k] = pc.transport.isend(frame, srank, tags.GRAD)
            yield EXEC
        yield from pc._chunk_acks(srank, tags.GRAD, tags.GRAD_ACK, gseq,
                                  staging, pending, span,
                                  f"GRAD to server {srank}")

    def _drain_parent_acks(self, seq: int, acked: List[bool]):
        """Consume waiting REDUCE_ACKs from the parent (never blocks).
        Returns True when any ack carried LATE — the whole op re-routes
        (the parent's exclusion is all-or-nothing, so a LATE round can
        never have been partially folded upstream)."""
        late = False
        while self.pc.transport.iprobe(self._parent, tags.REDUCE_ACK):
            handle = self.pc.transport.irecv(self._parent,
                                             tags.REDUCE_ACK,
                                             out=self._rd_ack)
            while not self.pc.transport.test(handle):
                yield EXEC
            epoch, aseq, idx, status = (int(x) for x in self._rd_ack)
            if epoch != self.pc.ft.epoch or aseq != seq:
                continue  # an earlier round's stale re-ack: drop
            if status == RD_LATE:
                late = True
            elif 0 <= idx < len(acked):
                acked[idx] = True
        return late

    def _prune_outcomes(self, child: int, keep: int = 8) -> None:
        outcomes = self._child_outcome[child]
        while len(outcomes) > keep:
            del outcomes[min(outcomes)]

    def _flight_dump(self, reason: str, **fields) -> None:
        self._flight.record(reason, rank=self.rank, **fields)
        path = self._flight.dump(reason, **fields)
        if path:
            self.log.warning("%s: flight recorder dumped to %s", reason,
                             path)
