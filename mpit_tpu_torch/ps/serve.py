"""Read-mostly parameter-serving tier — reader clients + admission control.

The port of ``mpit_tpu/ps/serve.py``: the same wire, byte for byte, so a
port reader reads a JAX server and a JAX reader a port server.  The shards
these readers read are the port servers' shards on the card — under
``rule="adam"`` applied by K3 — through each server's version-counted
snapshot cache: one device->host copy and one encode per committed version
that someone reads.  Reader code is host code on numpy and the port's
codec (no torch op runs on a reader's thread, and a reader makes no CUDA
context).

The north-star workload ("serve heavy traffic from millions of users")
is read-dominated: many consumers pulling the current parameters, few
writers training them.  This module is the client half and the shared
wire/config of that tier (the server half lives in
:class:`mpit_tpu_torch.ps.server.ParamServer` — ``reader_ranks=``):

- **READ-ONLY attach** (``FLAG_READONLY``, INIT v3 bit 4): a
  :class:`ReaderClient` announces the same ``[offset, size, codec_id,
  epoch, flags]`` words as a worker but promises to only ever send
  ``PARAM_REQ`` / ``HEARTBEAT`` / ``STOP``.  The server allocates no
  gradient/push staging for it and serves every reader from one
  dispatcher task, so a reader costs bytes proportional to one request
  header, not one shard — hundreds of readers attach to one rank (the
  event-loop TCP transport holds the connections; ``comm/tcp.py``).
  Readers attach lazily at any point mid-run.
- **Status-framed replies** (docs/PROTOCOL.md §8): the server answers a
  reader's ``PARAM_REQ [epoch, seq]`` with a 32-byte int64 header
  ``[epoch, seq, status, word]`` — reusing the shard-control status words
  (``OK``/``BUSY``, :mod:`mpit_tpu_torch.shardctl.wire`) — followed, on
  ``OK`` only, by the snapshot frame **as its own message**.  The body
  message is a zero-copy view of the version-counted snapshot cache's
  encoded frame, which is what pushes the N-readers = 1-copy + 1-encode
  invariant to hundreds of connections: every reader's reply views the
  same cached buffer, and ``snapshot_copies`` stays at one per committed
  version.  ``word`` carries the snapshot version on ``OK`` (readers
  assert monotonicity) and the **retry hint in microseconds** on
  ``BUSY``.
- **Admission control** (:class:`ServeConfig`): the server grants a
  read only while its in-flight reply bytes (and optionally reply
  count) fit a per-rank budget; past it, the reply is
  ``BUSY``-with-retry-hint instead of an unbounded queue of
  multi-megabyte snapshot sends.  The hint scales with the bytes ahead
  of the reader (``inflight / drain_bytes_per_s``), and the reader
  honors it through the retry machinery's backoff: deterministic jitter,
  capped escalation on repeated BUSY, a hard bound that raises
  :class:`~mpit_tpu_torch.ft.RetryExhausted` — never a hang, never a
  stampede.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, Generator, List, Optional, Tuple

import numpy as np

from mpit_tpu_torch.aio import (
    DeadlineExceeded,
    LiveFlag,
    Scheduler,
    aio_recv,
    aio_send,
    aio_sleep,
    deadline_at,
)
from mpit_tpu_torch.comm import codec as codec_mod
from mpit_tpu_torch.comm.transport import Transport
from mpit_tpu_torch.ft import (
    FLAG_FRAMED,
    FLAG_HEARTBEAT,
    FLAG_READONLY,
    FTConfig,
    RetryExhausted,
    RetryPolicy,
    header_frame,
    init_v3,
)
from mpit_tpu_torch.obs import (
    get_flight,
    get_recorder,
    obs_enabled,
    register_status_provider,
    registry_or_local,
)
from mpit_tpu_torch.ps import tags
from mpit_tpu_torch.ps.sharding import Shard
from mpit_tpu_torch.shardctl import shardmap as _shardmap
from mpit_tpu_torch.shardctl.wire import GOODBYE, OK
from mpit_tpu_torch.utils.logging import get_logger

#: reader reply header: int64 [epoch, seq, status, word]
SERVE_HDR_BYTES = 32


def serve_reply(epoch: int, seq: int, status: int, word: int) -> np.ndarray:
    """A fresh 32-byte reader reply header (fresh per reply: an
    in-flight zero-copy send must never see its header rewritten)."""
    return np.asarray([epoch, seq, status, word], dtype=np.int64)


def parse_serve_header(payload) -> Tuple[int, int, int, int]:
    """(epoch, seq, status, word) from a reader reply header message.
    Accepts both the 4-word §8 form and the 5-word §11 cell form (whose
    extra word — the serving rank's known head version — is read by
    :func:`serve_head`)."""
    words = np.frombuffer(bytes(payload), np.int64)
    if words.size not in (4, 5):
        raise ValueError(
            f"reader reply header must be 4 or 5 int64 words, got "
            f"{words.size}")
    return int(words[0]), int(words[1]), int(words[2]), int(words[3])


def serve_head(payload) -> Optional[int]:
    """The head-version word of a 5-word cell OK reply (None on the
    4-word direct-server form — a training server IS the head)."""
    words = np.frombuffer(bytes(payload), np.int64)
    return int(words[4]) if words.size == 5 else None


@dataclass(frozen=True)
class ServeConfig:
    """Per-server-rank admission budget for the read-serving tier.

    ``budget_bytes`` bounds the reply bytes in flight (queued to the
    transport but not yet accepted) across all readers; ``budget_reads``
    optionally bounds the reply *count* (0 = unbounded — byte budgets
    are the primary control).  A read that would exceed either gets a
    ``BUSY`` reply whose hint estimates the drain time of the bytes
    ahead of it: ``hint_floor_us + inflight_bytes / drain_bytes_per_s``.
    """

    budget_bytes: int = 64 << 20
    budget_reads: int = 0
    hint_floor_us: int = 2_000
    drain_bytes_per_s: int = 128 << 20

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        fields = dict(
            budget_bytes=int(float(
                os.environ.get("MPIT_SERVE_BUDGET_MB", "64")) * (1 << 20)),
            budget_reads=int(os.environ.get("MPIT_SERVE_BUDGET_READS", "0")),
            hint_floor_us=int(
                os.environ.get("MPIT_SERVE_HINT_FLOOR_US", "2000")),
            drain_bytes_per_s=int(float(
                os.environ.get("MPIT_SERVE_DRAIN_MBPS", "128")) * (1 << 20)),
        )
        fields.update(overrides)
        return cls(**fields)

    def hint_us(self, inflight_bytes: int) -> int:
        """Retry hint for a rejected read: the estimated drain time of
        the reply bytes already in flight, floored so a hint can never
        tell a reader to hammer."""
        return self.hint_floor_us + int(
            inflight_bytes * 1_000_000 // max(self.drain_bytes_per_s, 1))


class ReaderClient:
    """A lightweight read-only consumer of the PS gang: announces the
    READ-ONLY posture to every server, then pulls whole-vector
    snapshots with :meth:`read_params` (or the async pair
    :meth:`async_read_params` / :meth:`poll` for many readers
    multiplexed on one driver thread).  Tracks the per-server snapshot
    version of every read and asserts monotonicity (``monotone``).

    Requires op deadlines (``FTConfig.op_deadline_s > 0``): BUSY
    recovery and dead-server detection both ride the FT retry
    machinery — a reader can never hang on a wedged server."""

    def __init__(
        self,
        rank: int,
        server_ranks: "list[int]",
        transport: Transport,
        scheduler: Optional[Scheduler] = None,
        codec: Optional[str] = None,
        ft: Optional[FTConfig] = None,
        cells: "Optional[Dict[int, list]]" = None,  # fabric routing
        #   (§11.5): {launch server rank -> its replica cell ranks}.
        #   Reads route to one cell per shard by consistent hashing and
        #   fail over to ring siblings instead of exhausting the retry
        #   budget against a dead cell.
        failover_after: int = 2,  # deadline-exceeded attempts against
        #   one cell before failing over to the next ring sibling.
        layout: "Optional[List[Shard]]" = None,  # the weighted cut of the
        #   LM workload: a later slice of the port (refused).
    ):
        if layout is not None:
            raise NotImplementedError(
                "ReaderClient(layout=...) belongs to the weighted shard "
                "layout (slice 7, lm) of the port")
        self.rank = rank
        self.sranks = list(server_ranks)
        self.transport = transport
        self.sched = scheduler or Scheduler()
        self.codec = codec_mod.get(codec)
        self.ft = ft if ft is not None else FTConfig.from_env()
        if self.ft.op_deadline_s <= 0:
            raise ValueError(
                "ReaderClient needs op deadlines (FTConfig.op_deadline_s"
                " > 0): BUSY recovery and dead-server detection ride the"
                " retry machinery")
        self._retry = RetryPolicy(self.ft, key=rank)
        self.live = LiveFlag()
        self.log = get_logger("reader", rank)
        self.param: Optional[np.ndarray] = None
        self.shards: List[Shard] = []
        self._started = False
        self._seq: Dict[int, int] = {}
        # Protocol-state carry-over: True when an earlier (timed-out)
        # attempt consumed an OK header but not its body — the next
        # recv on that channel is the orphaned body, not a header.
        self._half_pair: Dict[int, bool] = {}
        #: last snapshot version observed per server (reads must be
        #: monotone: the serving tier never goes back in time).  Keyed
        #: by the *physical* serving rank — each cell's version stream
        #: is monotone on its own; a fail-over lands on a fresh key.
        self.versions: Dict[int, int] = {}
        #: per *launch server slot* (§11.5), from the last completed
        #: read: the served snapshot version and the observed lag (the
        #: serving rank's stamped head minus that version; 0 against a
        #: direct server — it is the head).  The pair is the client's
        #: staleness envelope: "I hold version v, at most ``lag``
        #: behind what existed when it was served".
        self.read_versions: Dict[int, int] = {}
        self.lags: Dict[int, int] = {}
        self.monotone = True
        self.reads_done = 0
        # Fabric routing (§11.5): a consistent-hash ring of replica
        # cells per launch server slot.  The primary cell is the ring
        # lookup of this reader's rank; deadline exhaustion against a
        # cell marks it down and fails over to the next live sibling
        # with a FRESH attempt budget — RetryExhausted is reserved for
        # "no live cell remains".
        self._rings: Dict[int, Any] = {}
        self._failover_after = max(int(failover_after), 1)
        self.failovers = 0
        if cells:
            from mpit_tpu_torch.cells.ring import CellRing

            for srank in self.sranks:
                fabric = cells.get(srank)
                if not fabric:
                    raise ValueError(
                        f"fabric routing needs cells for every server "
                        f"slot; server {srank} has none")
                self._rings[srank] = CellRing(fabric)
        # Server retirement (§9.4): a GOODBYE reply re-routes this
        # attach slot to the named successor instead of burning the
        # retry budget against a disappearing rank.  ``_route`` maps
        # the launch-time server to wherever its slot is served now;
        # ``_attached`` tracks who has seen our INIT.
        self._route: Dict[int, int] = {}
        self._attached: set = set()
        self._goodbyes: set = set()
        self._announce: Dict[int, Shard] = {}
        self._flags = 0
        self._hb_last = 0.0
        self._hb_seq = 0
        self.metrics = registry_or_local()
        self._spans = get_recorder()
        self._flight = get_flight()
        self._m_busy = self.metrics.counter(
            "mpit_ps_busy_honored_total", rank=rank)
        self._m_reroutes = self.metrics.counter(
            "mpit_ps_reader_reroutes_total", rank=rank)
        self._m_retries = self.metrics.counter(
            "mpit_ft_retries_total", rank=rank)
        self._m_hb = self.metrics.counter(
            "mpit_ft_heartbeats_sent_total", rank=rank)
        #: observed staleness per completed read (§11.5): stamped head
        #: minus served version — 0 against a direct server.
        self._m_lag = self.metrics.histogram(
            "mpit_serve_read_lag", rank=rank)
        if obs_enabled():
            register_status_provider(f"reader{rank}", self._status_section)
        # Per-server FIFO op pumps (the ParamClient pattern): reads to
        # one server serialize, different servers overlap.
        self._opq: Dict[int, Deque[Tuple[Generator, str]]] = {}
        self._pump_live: Dict[int, bool] = {}

    # -- introspection -------------------------------------------------------

    def _status_section(self) -> Dict[str, object]:
        return {
            "role": "reader",
            "rank": self.rank,
            "servers": self.sranks,
            "codec": self.codec.name,
            "epoch": self.ft.epoch,
            "versions": {str(s): v for s, v in self.versions.items()},
            "lags": {str(s): v for s, v in self.lags.items()},
            "monotone": self.monotone,
            "reads_done": self.reads_done,
            "busy_honored": int(self._m_busy.value),
            "fabric": {str(s): {"route": self._route.get(s, s),
                                "live_cells": r.live}
                       for s, r in self._rings.items()},
            "failovers": self.failovers,
        }

    @property
    def busy_honored(self) -> int:
        """BUSY replies absorbed-and-retried (registry-backed)."""
        return int(self._m_busy.value)

    @property
    def retries(self) -> int:
        return int(self._m_retries.value)

    # -- lifecycle -----------------------------------------------------------

    def start(self, param: np.ndarray) -> None:
        """Announce the READ-ONLY posture to every server.  ``param`` is
        the whole-vector host mirror reads decode into; the shard cut is
        the same version-0 equal split every static client derives."""
        if not isinstance(param, np.ndarray) or param.ndim != 1:
            raise TypeError("param must be a 1-D numpy array (host mirror)")
        if not param.flags["C_CONTIGUOUS"]:
            raise ValueError("param must be contiguous (zero-copy rule)")
        if not self.codec.identity and param.dtype != np.float32:
            raise ValueError(
                f"codec {self.codec.name!r} quantizes float32 shards; got "
                f"dtype {param.dtype} (use codec='none' for other dtypes)")
        self.param = param
        smap = _shardmap.ShardMap.initial(len(param), self.sranks)
        self.shards = [e.shard for e in smap.entries]
        flags = FLAG_FRAMED | FLAG_READONLY | (
            FLAG_HEARTBEAT if self.ft.heartbeat_s > 0 else 0)
        self._flags = flags
        attached = set()
        for srank, shard in zip(self.sranks, self.shards):
            self._announce[srank] = shard
            cinfo = init_v3(shard.offset, shard.size, self.codec.wire_id,
                            self.ft.epoch, flags)
            ring = self._rings.get(srank)
            if ring is None:
                targets = [srank]
            else:
                # Fabric (§11.5): announce to EVERY replica cell of the
                # slot — attach is one message, and it buys lazy STOP
                # accounting plus instant fail-over (the sibling already
                # holds our negotiation) — then route reads to the
                # ring's pick for this reader.
                targets = ring.members
                self._route[srank] = ring.lookup(self.rank)
            for target in targets:
                self.sched.spawn(
                    aio_send(self.transport, cinfo, target, tags.INIT,
                             live=self.live, deadline=self._op_deadline()),
                    name=f"send_init:{target}",
                )
            attached.update(targets)
        self.wait()
        self._attached = attached
        self._started = True
        self._hb_last = 0.0

    # -- FT plumbing ---------------------------------------------------------

    def _op_deadline(self) -> Optional[float]:
        return deadline_at(self.ft.deadline_s)

    def _next_seq(self, srank: int) -> int:
        seq = self._seq.get(srank, 0) + 1
        self._seq[srank] = seq
        return seq

    def _busy_sleep_s(self, hint_us: int, busy: int) -> float:
        """Honor the server's retry hint through the FT backoff
        policy: the hint is the floor (the server's own drain
        estimate), the capped-exponential-with-deterministic-jitter
        schedule escalates repeated rejections so N readers never
        resynchronize into a retry stampede."""
        return max(max(hint_us, 0) / 1e6,
                   self._retry.backoff_s(min(max(busy, 1), 8)))

    def _maybe_heartbeat(self) -> None:
        hb = self.ft.heartbeat_s
        if hb <= 0 or not self._started or not self.live.io:
            return
        now = time.monotonic()
        if now - self._hb_last < hb:
            return
        self._hb_last = now
        self._hb_seq += 1
        payload = header_frame(self.ft.epoch, self._hb_seq)
        self._m_hb.inc()
        for srank in self._targets():
            self.sched.spawn(self._hb_send(payload, srank),
                             name=f"heartbeat:{srank}")

    def _hb_send(self, payload: np.ndarray, srank: int):
        try:
            yield from aio_send(
                self.transport, payload, srank, tags.HEARTBEAT,
                live=self.live, deadline=deadline_at(4 * self.ft.heartbeat_s),
            )
        except (DeadlineExceeded, RuntimeError):
            # Liveness is best-effort; the next beat tries again.  A torn
            # link (a SIGKILLed cell) is the read path's to detect and fail
            # over from, never a beat's to fail the reader on.
            pass

    # -- the read op ---------------------------------------------------------

    def _read_op(self, srank: int, shard: Shard):
        """One shard read: request, await the status-framed reply; BUSY
        honors the hint and re-requests the same seq (reads are
        idempotent and never dedup'd); DeadlineExceeded retries under
        the backoff policy; both are bounded — exhaustion raises."""
        span = self._spans.op("PARAM", peer=srank, side="client",
                              rank=self.rank)
        out = self.param[shard.offset: shard.end]
        seq = self._next_seq(srank)
        span.note(epoch=self.ft.epoch, seq=seq)
        req = header_frame(self.ft.epoch, seq)
        attempt = 0
        busy = 0
        max_busy = 64 * self._retry.attempts
        last: Optional[BaseException] = None
        while self.live.io:
            target = self._route.get(srank, srank)
            deadline = self._op_deadline()
            try:
                span.mark("send")
                yield from aio_send(self.transport, req, target,
                                    tags.PARAM_REQ, live=self.live,
                                    deadline=deadline)
                span.mark("recv")
                got_busy_hint: Optional[int] = None
                rerouted = False
                while got_busy_hint is None and not rerouted:
                    if self._half_pair.pop(target, None):
                        # A previous attempt died between an OK header
                        # and its body: the channel's next message is
                        # that orphaned body — consume it to stay in
                        # sync before parsing headers again.
                        stale = yield from aio_recv(
                            self.transport, target, tags.PARAM,
                            live=self.live, deadline=deadline)
                        if stale is None:
                            span.end("aborted")
                            return None
                    raw = yield from aio_recv(
                        self.transport, target, tags.PARAM, live=self.live,
                        deadline=deadline)
                    if raw is None:
                        span.end("aborted")
                        return None
                    epoch, aseq, status, word = parse_serve_header(raw)
                    if status == OK:
                        head = serve_head(raw)
                        self._half_pair[target] = True
                        body = yield from aio_recv(
                            self.transport, target, tags.PARAM,
                            live=self.live, deadline=deadline)
                        if body is None:
                            span.end("aborted")
                            return None
                        self._half_pair.pop(target, None)
                        if epoch == self.ft.epoch and aseq == seq:
                            span.mark("decode")
                            self._decode(body, out)
                            self._note_version(target, word)
                            # Observed staleness (§11.5): the serving
                            # rank's stamped head minus the version we
                            # got — surfaced per read so clients can
                            # assert their own envelope.
                            lag = (max(head - word, 0)
                                   if head is not None else 0)
                            self.read_versions[srank] = word
                            self.lags[srank] = lag
                            self._m_lag.observe(lag)
                            span.note(version=word, lag=lag)
                            span.end("ok")
                            return word
                        continue  # stale pair (earlier attempt): dropped
                    if status == GOODBYE and epoch == self.ft.epoch \
                            and aseq == seq:
                        # Retirement (§9.4): re-attach at the announced
                        # successor and re-issue the same request there —
                        # a redirect, not a failure, so the retry budget
                        # is untouched.
                        yield from self._reroute(srank, target, int(word))
                        span.mark("reroute")
                        rerouted = True
                        continue
                    if epoch == self.ft.epoch and aseq == seq:
                        got_busy_hint = max(int(word), 0)
                    # stale BUSY echoes drop on the unchanged deadline
                if rerouted:
                    continue  # re-issue against the successor
                busy += 1
                self._m_busy.inc()
                span.mark("backoff")
                span.note(busy=busy)
                if busy > max_busy:
                    span.end("exhausted")
                    self._flight_dump("retry_exhausted",
                                      what=f"PARAM read from server {srank}"
                                           " (admission)", busy=busy)
                    raise RetryExhausted(
                        f"PARAM read from server {srank} (admission "
                        f"control never granted it)", busy, last)
                if not (yield from aio_sleep(
                        self._busy_sleep_s(got_busy_hint, busy),
                        live=self.live)):
                    span.end("aborted")
                    return None
                continue  # re-request the same seq after honoring the hint
            except RetryExhausted:
                raise
            except (DeadlineExceeded, RuntimeError) as exc:
                # DeadlineExceeded: the target never answered in time.
                # RuntimeError: the transport's fail-loud raise-once on
                # a torn link (a SIGKILLed cell) — both are the same
                # retryable fact: this target is not answering.
                last = exc
                attempt += 1
                ring = self._rings.get(srank)
                if (ring is not None and attempt >= self._failover_after
                        and len(ring.live) > 1):
                    # Fabric fail-over (§11.5): a dead cell must cost a
                    # reroute, not the retry budget — mark it down,
                    # take the next ring sibling with a FRESH attempt
                    # budget.  Bounded: once no live sibling remains,
                    # the ordinary exhaustion path below is the truth.
                    target = self._route.get(srank, srank)
                    yield from self._cell_failover(srank, target, ring)
                    attempt = 0
                    span.mark("reroute")
                    continue
                if attempt >= self._retry.attempts:
                    span.end("exhausted")
                    self._flight_dump(
                        "retry_exhausted",
                        what=f"PARAM read from server {srank}",
                        attempts=self._retry.attempts)
                    raise RetryExhausted(
                        f"PARAM read from server {srank}",
                        self._retry.attempts, last)
                backoff = self._retry.backoff_s(attempt)
                self._m_retries.inc()
                span.mark("backoff")
                span.note(retries=attempt)
                if not (yield from aio_sleep(backoff, live=self.live)):
                    span.end("aborted")
                    return None
        span.end("aborted")
        return None

    def _reroute(self, srank: int, old: int, succ: int):
        """Follow a GOODBYE to the named successor: record the route
        and, on first contact, announce the same READ-ONLY posture for
        the same shard (the successor's dispatcher attaches us lazily,
        any time mid-run)."""
        if succ < 0 or succ == old:
            raise RetryExhausted(
                f"server {old} retired without a usable successor "
                f"({succ})", 0, None)
        self._m_reroutes.inc()
        self._route[srank] = succ
        self._goodbyes.add(old)
        ring = self._rings.get(srank)
        if ring is not None:
            # A retiring cell leaves the ring for good; the successor
            # may be a fresh (autoscaled) cell outside it — the route
            # override wins either way.
            ring.mark_down(old)
        self.log.warning("server %d retiring: re-attaching its shard "
                         "reads to server %d", old, succ)
        if succ not in self._attached:
            shard = self._announce[srank]
            cinfo = init_v3(shard.offset, shard.size, self.codec.wire_id,
                            self.ft.epoch, self._flags)
            yield from aio_send(self.transport, cinfo, succ, tags.INIT,
                                live=self.live,
                                deadline=self._op_deadline())
            self._attached.add(succ)

    def _cell_failover(self, srank: int, dead: int, ring):
        """Fail a read over to the next live ring sibling after the
        current cell stopped answering (§11.5): mark it down, route to
        the ring's next pick for this reader, re-announce if it never
        saw our INIT, and leave a ``cell_failover`` postmortem naming
        the version window we crossed it with."""
        ring.mark_down(dead)
        try:
            succ = ring.lookup(self.rank)
        except LookupError:
            raise RetryExhausted(
                f"cell {dead} dead and no live sibling remains for "
                f"server slot {srank}", self.failovers, None)
        self._m_reroutes.inc()
        self.failovers += 1
        self._route[srank] = succ
        self.log.warning(
            "cell %d stopped answering: failing shard %d reads over to "
            "cell %d", dead, srank, succ)
        self._flight.record("cell_failover", rank=self.rank,
                            dead=dead, successor=succ)
        self._flight.dump(
            "cell_failover",
            window={"version": self.versions.get(dead, -1),
                    "lag": self.lags.get(srank, 0),
                    "dead": dead, "successor": succ},
            server_slot=srank)
        if succ not in self._attached:
            shard = self._announce[srank]
            cinfo = init_v3(shard.offset, shard.size, self.codec.wire_id,
                            self.ft.epoch, self._flags)
            yield from aio_send(self.transport, cinfo, succ, tags.INIT,
                                live=self.live,
                                deadline=self._op_deadline())
            self._attached.add(succ)

    def _targets(self) -> "List[int]":
        """The physical ranks currently serving this reader's slots."""
        return sorted({self._route.get(s, s) for s in self.sranks})

    def _decode(self, body, out: np.ndarray) -> None:
        frame = np.frombuffer(bytes(body), np.uint8)
        if self.codec.identity:
            out.view(np.uint8)[:] = frame
        else:
            self.codec.decode_into(frame, out)

    def _note_version(self, srank: int, version: int) -> None:
        if version < self.versions.get(srank, -1):
            self.monotone = False
            self.log.warning(
                "server %d served version %d after %d — snapshot "
                "versions must be monotone", srank, version,
                self.versions[srank])
        self.versions[srank] = version

    def _flight_dump(self, reason: str, **fields) -> None:
        self._flight.record(reason, rank=self.rank, **fields)
        self._flight.dump(reason, **fields)

    # -- public surface ------------------------------------------------------

    def _enqueue(self, srank: int, gen: Generator, name: str) -> None:
        queue = self._opq.setdefault(srank, deque())
        queue.append((gen, name))
        if not self._pump_live.get(srank, False):
            self._pump_live[srank] = True
            self.sched.spawn(self._pump(srank), name=f"pump:{srank}:{name}")

    def _pump(self, srank: int):
        queue = self._opq[srank]
        try:
            while queue:
                op, _name = queue.popleft()
                yield from op
        finally:
            self._pump_live[srank] = False

    def async_read_params(self) -> None:
        """Enqueue one whole-vector read (every server's shard)."""
        for srank, shard in zip(self.sranks, self.shards):
            self._enqueue(srank, self._read_op(srank, shard), "read_param")

    def poll(self) -> bool:
        """One scheduler step; True while reads are still in flight.
        Raises the first op error once everything drained — the
        many-readers-one-thread driver primitive."""
        self._maybe_heartbeat()
        self.sched.ping()
        if self.sched.queue:
            return True
        if self.sched.errors:
            raise self.sched.errors.pop(0)
        return False

    def ping(self, n: int = 1) -> None:
        self._maybe_heartbeat()
        for _ in range(n):
            self.sched.ping()

    def wait(self) -> None:
        while self.sched.queue:
            self._maybe_heartbeat()
            self.sched.ping_pass()
        if self.sched.errors:
            raise self.sched.errors.pop(0)

    def read_params(self) -> Dict[int, int]:
        """Blocking whole-vector read; returns {server: version}."""
        self.async_read_params()
        self.wait()
        self.reads_done += 1
        return dict(self.versions)

    def _stop_op(self, srank: int):
        """One best-effort STOP: a target that died (a SIGKILLed cell)
        must not fail the reader's shutdown — the serving side's lease
        machinery owns counting a dead reader out."""
        try:
            yield from aio_send(self.transport, tags.EMPTY, srank,
                                tags.STOP, live=self.live,
                                deadline=self._op_deadline())
        except (DeadlineExceeded, RuntimeError) as exc:
            self.log.debug("STOP to %d undeliverable: %r", srank, exc)

    def stop(self) -> None:
        # A stopping reader stops beating first: the beats ride wait()'s
        # loop, and against a target that died or already stopped each one
        # lives out its deadline (4 beats), so new ones would keep the
        # queue from ever draining.  The JAX reader beats on through its
        # STOPs and can hang here once a sibling cell has gone.
        self._started = False
        # STOP goes to every rank that saw our INIT and is still
        # serving: in fabric mode that is every replica cell (each one
        # counts every expected reader), otherwise wherever each slot
        # is served *now*.  A retired rank already counted us out when
        # it said GOODBYE (§9.4).
        targets = (self._attached | set(self._targets())) - self._goodbyes
        for srank in sorted(targets):
            self._enqueue(srank, self._stop_op(srank), "send_stop")
        self.wait()
        self.live.stop()
