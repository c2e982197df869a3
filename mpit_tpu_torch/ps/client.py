"""ParamClient — shards the flat parameter vector across servers and
drives asynchronous shard transfers.

The port of the core of ``ParamClient`` of ``mpit_tpu/ps/client.py`` (a rebuild
of reference asyncsgd/pclient.lua).  The client registers two host
buffers (``param``, ``grad``: numpy arrays) whose per-server contiguous
slices are the transfer units (numpy views = the reference's zero-copy
storage-offset views, pclient.lua:50-52).  Public surface mirrors
pclient.lua:84-179: ``start``, ``async_send_grad``, ``async_recv_param``,
``async_send_param``, ``ping``, ``wait``, ``reset``, ``stop``.

The comm-aware optimizers (:mod:`mpit_tpu_torch.optim`) drive this class
through the ParamClientAPI protocol; tensors on the card stay in the
optimizer layer — the client only touches the registered host mirrors, so
it is the JAX package's client byte for byte.

Wire codecs: the client announces a codec in its INIT v2 (``MPIT_PS_CODEC``
or the ``codec`` argument) and every GRAD/PARAM/PARAM_PUSH frame to/from
that server travels in that format.  For the lossy ``int8`` codec the
client holds one error-feedback residual per shard: the gradient
quantization error is added back into the next shipped gradient instead of
being lost.  ``codec='none'`` sends the registered slices themselves.

Fault tolerance (:mod:`mpit_tpu_torch.ft`, ``ft=`` or the ``MPIT_FT_*``
environment): with any FT knob on, the client announces INIT v3 with its
incarnation ``epoch`` and flags.  Op deadlines turn on framing: every
GRAD / PARAM_PUSH is encoded once into staging behind an int64
``[epoch, seq]`` header, and a timed-out op resends those same bytes under
the :class:`~mpit_tpu_torch.ft.RetryPolicy` until its seq-matched ack
arrives (the server's dedup table applies it at most once); PARAM reads
carry a seq and discard snapshots that answer an earlier attempt.
Heartbeats ride ``ping``/``wait``.  ``FLAG_STALENESS`` adds the version
word.  ``FLAG_TIMING`` (``FTConfig(timing=True)`` on a framed client) adds
a wall-µs send stamp to every data frame, re-stamped per attempt, and
feeds the ``[t_tx, t_recv, t_ack]`` tails of the server's acks, replies
and heartbeat echoes into a per-server clock-offset estimator.

Shard control (``shardctl=True`` or a ``shard_map``; INIT v4): ops address
*shards* of a versioned :class:`~mpit_tpu_torch.shardctl.shardmap.ShardMap`
(``sc_shards_per_server`` shards per launch server), each framed behind the
32-byte ``[epoch, seq, map_version, shard_id]`` header and encoded once into
per-shard staging (with a per-shard int8 residual); a ``NACK_MAP`` reply
installs the server's newer map and re-routes, ``BUSY`` backs off through a
migration, and the controller's MAP_UPDATE broadcasts are polled in
``ping``/``wait``.  One global FIFO pump serializes shard ops.  Staleness and
timing negotiate off there (the header has no slot for them).  Chunked
streaming and the weighted layout come with later slices: their knobs and
constructor arguments raise ``NotImplementedError`` naming the slice.

Observability (:mod:`mpit_tpu_torch.obs`): every op records a span with
the JAX client's phase marks (encode, send, ack or recv, decode, backoff)
and outcome; retry exhaustion dumps the flight recorder; with obs on the
client registers a ``/status`` section.  Disabled, the recorder and the
flight recorder are the shared null objects and read no clock.

The static shard cut is :func:`mpit_tpu_torch.ps.sharding.shard_layout`'s
equal split, the cut the JAX client's version-0 shard map makes.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict, Generator, List, Optional, Tuple

import numpy as np

from mpit_tpu_torch.aio import (
    DeadlineExceeded,
    LiveFlag,
    Scheduler,
    Task,
    aio_recv,
    aio_send,
    aio_sleep,
    deadline_at,
)
from mpit_tpu_torch.comm import codec as codec_mod
from mpit_tpu_torch.comm.transport import Transport
from mpit_tpu_torch.ft import (
    ACK_TIMING_WORDS,
    FLAG_FRAMED,
    FLAG_HEARTBEAT,
    FLAG_STALENESS,
    FLAG_TIMING,
    FTConfig,
    RetryExhausted,
    RetryPolicy,
    hdr_bytes,
    header_frame,
    init_v3,
    pack_header,
    pack_tx_stamp,
    pack_version,
    reply_hdr_bytes,
    timed_frame,
    unpack_header,
    unpack_reply_stamps,
    unpack_version,
)
from mpit_tpu_torch.obs import clock as obs_clock
from mpit_tpu_torch.obs.flight import get_flight
from mpit_tpu_torch.obs.metrics import obs_enabled, registry_or_local
from mpit_tpu_torch.obs.spans import NULL_SPAN, get_recorder
from mpit_tpu_torch.obs.statusd import register_provider as register_status_provider
from mpit_tpu_torch.ps import tags
from mpit_tpu_torch.ps.server import refuse_later
from mpit_tpu_torch.ps.sharding import Shard, shard_layout
from mpit_tpu_torch.shardctl import shardmap as _shardmap
from mpit_tpu_torch.shardctl import wire as _scwire
from mpit_tpu_torch.utils.logging import get_logger

#: What each refused constructor argument of the JAX client belongs to.
LATER_CLIENT_ARGS = {
    "layout": "the weighted shard layout (slice 7, lm)",
}


class ParamClient:
    def __init__(
        self,
        rank: int,
        server_ranks: List[int],
        transport: Transport,
        seed_servers: bool = False,
        codec: Optional[str] = None,
        ft: Optional[FTConfig] = None,
        shard_map: Optional[_shardmap.ShardMap] = None,
        shardctl: bool = False,
        controller_rank: Optional[int] = None,
        sc_shards_per_server: int = 1,
        **later: Any,
    ):
        refuse_later("ParamClient", later, LATER_CLIENT_ARGS)
        self.rank = rank
        self.sranks = list(server_ranks)
        self.transport = transport
        self.sched = Scheduler()
        self.seed_servers = seed_servers  # this is the first client
        self.codec = codec_mod.get(codec)  # None/'' -> $MPIT_PS_CODEC
        self.ft = ft if ft is not None else FTConfig.from_env()
        # Shard control: ops address *shards*, not servers — the versioned
        # map routes them, a NACK_MAP reply re-routes them, and the
        # controller's MAP_UPDATE broadcasts are polled opportunistically.
        # Needs the framed retry machinery: re-routing is retry, and
        # at-most-once across owners is the transferred dedup state.
        self._sc = bool(shardctl or shard_map is not None)
        self.smap = shard_map
        self.controller_rank = controller_rank
        # Over-partitioning: k shards per launch-time server, so elastic
        # membership has units to move.
        self._sc_cut = max(int(sc_shards_per_server), 1)
        #: servers this incarnation announced itself to; a map may route
        #: shards to ranks that joined after launch — first contact greets
        #: them (the lazy INIT v4).
        self._sc_greeted: set = set()
        self._sc_flags = 0
        #: ranks that left on purpose (RETIRED broadcasts): dropped from
        #: heartbeat and STOP fan-out.
        self._sc_retired: set = set()
        if self._sc and self.ft.op_deadline_s <= 0:
            raise ValueError(
                "shardctl needs op deadlines + retry (FTConfig."
                "op_deadline_s > 0): map re-routing rides the retry path")
        self._retry = RetryPolicy(self.ft, key=rank)
        self.live = LiveFlag()
        self.log = get_logger("pclient", rank)
        self.param: Optional[np.ndarray] = None
        self.grad: Optional[np.ndarray] = None
        self.shards: List[Shard] = []
        self._started = False
        # Staleness telemetry: with FLAG_STALENESS, PARAM replies carry the
        # served snapshot version and the next GRAD echoes the version this
        # client computed against (the 24-byte header).
        # Off under shard control: the 32-byte shard header has no
        # version word.
        self._stale = self.ft.stale_track and not self._sc
        # Causal timing (FLAG_TIMING): data frames carry a wall-µs send
        # stamp and every ack/reply a [t_tx_echo, t_recv, t_ack] tail — the
        # four NTP marks that feed the per-server clock-offset estimator.
        # Rides the framed wire like staleness.
        # Off under shard control, like staleness (no stamp slot).
        self._timing = self.ft.timing_track and not self._sc
        #: per-server param version this client last read (the basis the
        #: next gradient is computed against); 0 until the first read.
        self._basis: Dict[int, int] = {}
        self._hdr = hdr_bytes(self._stale, self._timing) if self.ft.framed else 0
        self._hdr_rx = (reply_hdr_bytes(self._stale, self._timing)
                        if self.ft.framed else 0)
        # Per-server codec state: encode/decode staging sized to the wire
        # format (plus the FT header when framed), the framed reply and ack
        # buffers, and the int8 error-feedback residual (grad path only).
        self._grad_wire: Dict[int, np.ndarray] = {}
        self._param_wire: Dict[int, np.ndarray] = {}
        self._param_rx: Dict[int, np.ndarray] = {}
        self._ack_buf: Dict[int, np.ndarray] = {}
        self._residual: Dict[int, np.ndarray] = {}
        #: per-server clock-offset estimator (fed by FLAG_TIMING tails;
        #: registered so trace exports and flight dumps embed its state).
        self._clock = obs_clock.ClockEstimator()
        obs_clock.register(f"client{rank}", self._clock)
        self._m_clock: Dict[int, Any] = {}
        #: per-(server, tag) op sequence numbers (FT framing identity)
        self._seq: Dict[Tuple[int, int], int] = {}
        self._hb_last = 0.0
        self._hb_seq = 0
        # Protocol counters live in a real registry always (the global one
        # when obs is enabled, a private one otherwise); every op records a
        # span through the recorder (the null recorder when disabled).
        self.metrics = registry_or_local()
        self._spans = get_recorder()
        self._m_retries = self.metrics.counter("mpit_ft_retries_total", rank=rank)
        self._m_backoff = self.metrics.counter(
            "mpit_ft_backoff_seconds_total", rank=rank)
        self._m_hb = self.metrics.counter("mpit_ft_heartbeats_sent_total", rank=rank)
        self._m_nacks = self.metrics.counter("mpit_shardctl_nacks_seen_total", rank=rank)
        self._m_reroutes = self.metrics.counter("mpit_shardctl_reroutes_total",
                                                rank=rank)
        self._m_mapver = self.metrics.gauge("mpit_shardctl_map_version", rank=rank)
        # Flight recorder + live introspection: retry exhaustion dumps the
        # recent-event ring; the status provider feeds /status.  Both are
        # null or absent when obs is disabled.
        self._flight = get_flight()
        if obs_enabled():
            register_status_provider(f"client{rank}", self._status_section)
        # Per-server FIFO op chains: ops addressed to the same server run in
        # issue order (a send_grad's ack completes before a later param
        # request is sent), while different servers stay fully concurrent.
        # Strictly stronger than the reference (which relies on coroutine
        # spawn order for freshness, pclient.lua:84-109).
        # Shard-control state: encode staging and residual keyed by shard id
        # (placement moves, the cut never does), per-(shard, tag) seq
        # streams, and one global FIFO op pump (ops to different owners
        # serialize, so the reply channels never interleave two ops).
        self._sc_wire: Dict[int, np.ndarray] = {}
        self._sc_residual: Dict[int, np.ndarray] = {}
        self._sc_seq: Dict[Tuple[int, int], int] = {}
        self._scq: Deque[Tuple[Generator, str]] = deque()
        self._sc_pump_live = False
        self._sc_pump_task: Optional[Task] = None
        self._opq: Dict[int, Deque[Tuple[Generator, str]]] = {}
        self._pump_live: Dict[int, bool] = {}
        self._pump_task: Dict[int, Optional[Task]] = {}

    # -- lifecycle ----------------------------------------------------------

    def start(self, param: np.ndarray, grad: np.ndarray) -> None:
        """Announce shard layout + codec to every server; the first client
        seeds the servers' shards from ``param`` (reference
        pclient.lua:111-129).  INIT v2: int64 [offset, size, codec_id];
        with any FT feature active, INIT v3 adds [epoch, flags]; under
        shard control, INIT v4 announces the whole versioned map."""
        self._register(param, grad)
        if self._sc:
            self._sc_start(param)
            return
        self.shards = shard_layout(len(param), len(self.sranks))
        flags = (FLAG_FRAMED if self.ft.framed else 0) | (
            FLAG_HEARTBEAT if self.ft.heartbeat_s > 0 else 0) | (
            FLAG_STALENESS if self._stale else 0) | (
            FLAG_TIMING if self._timing else 0)
        for srank, shard in zip(self.sranks, self.shards):
            body = self.codec.wire_nbytes(shard.size)
            if not self.codec.identity or self._hdr:
                # Identity codec under FT framing: raw bytes behind the
                # header (the one staging copy framing costs).
                self._grad_wire[srank] = np.zeros(self._hdr + body, np.uint8)
                self._param_wire[srank] = np.zeros(self._hdr + body, np.uint8)
            if self.codec.uses_residual:
                self._residual[srank] = np.zeros(shard.size, np.float32)
            if self._hdr:
                self._param_rx[srank] = np.zeros(self._hdr_rx + body, np.uint8)
                self._ack_buf[srank] = np.zeros(
                    ACK_TIMING_WORDS if self._timing else 2, np.int64)
            if self.ft.active:
                cinfo = init_v3(shard.offset, shard.size, self.codec.wire_id,
                                self.ft.epoch, flags)
            else:
                cinfo = np.asarray([shard.offset, shard.size, self.codec.wire_id],
                                   dtype=np.int64)
            self.sched.spawn(aio_send(self.transport, cinfo, srank, tags.INIT,
                                      live=self.live,
                                      deadline=self._op_deadline()),
                             name=f"send_init:{srank}")
        self.wait()
        # Beat from the moment the servers know this client's epoch —
        # seeding a large shard below can outlast a lease TTL, and the
        # wait() loop is what pumps the beacons out.
        self._started = True
        self._hb_last = 0.0
        if self.seed_servers:
            self.async_send_param()
            self.wait()

    def _register(self, param: np.ndarray, grad: np.ndarray) -> None:
        if not isinstance(param, np.ndarray) or not isinstance(grad, np.ndarray):
            raise TypeError("param and grad must be numpy arrays (host mirrors)")
        if param.ndim != 1 or grad.shape != param.shape:
            raise ValueError("param and grad must be 1-D with equal shape")
        if param.dtype != np.float32 or grad.dtype != np.float32:
            raise ValueError("param and grad must be float32")
        if not param.flags["C_CONTIGUOUS"] or not grad.flags["C_CONTIGUOUS"]:
            raise ValueError("param and grad must be contiguous (zero-copy rule)")
        self.param, self.grad = param, grad

    def reset(self, param: np.ndarray, grad: np.ndarray) -> None:
        """Retarget transfer buffers without re-announcing shards
        (reference pclient.lua:138-151).  Error-feedback residuals are
        keyed by shard, not by buffer — they survive the retarget."""
        if self.shards and len(param) != self.shards[-1].end:
            raise ValueError("reset buffers must keep the registered length")
        self._register(param, grad)

    # -- live introspection (obs/statusd) ------------------------------------

    def _status_section(self) -> Dict[str, object]:
        """This client's /status section: identity, negotiation posture,
        per-server basis versions and the pending op-pump task table.
        Runs on the statusd thread — reads plain attributes only."""
        try:
            tasks = [t.name for t in list(self.sched.queue)]
        except RuntimeError:  # deque mutated mid-snapshot; next poll wins
            tasks = ["<scheduler busy>"]
        return {
            "role": "client",
            "rank": self.rank,
            "servers": self.sranks,
            "codec": self.codec.name,
            "epoch": self.ft.epoch,
            "framed": self.ft.framed,
            "staleness": self._stale,
            "chunked": False,
            "basis_versions": {str(s): v for s, v in self._basis.items()},
            # the static layout is the JAX client's version-0 map
            "map_version": self.smap.version if self.smap is not None else 0,
            "retries": self.retries,
            "tasks": tasks,
        }

    def _flight_dump(self, reason: str, **fields) -> None:
        """Record + dump the flight ring on a terminal failure (no-op when
        obs is off): the ring of events that led to it plus the live task
        table, beside the raised exception."""
        self._flight.record(reason, rank=self.rank, **fields)
        try:
            tasks = [(t.name, t.state) for t in list(self.sched.queue)]
        except RuntimeError:
            tasks = None
        path = self._flight.dump(reason, tasks=tasks, **fields)
        if path:
            self.log.warning("%s: flight recorder dumped to %s", reason, path)

    @property
    def retries(self) -> int:
        """Resends performed (registry-backed)."""
        return int(self._m_retries.value)

    @property
    def heartbeats_sent(self) -> int:
        return int(self._m_hb.value)

    # -- FT plumbing ---------------------------------------------------------

    def _op_deadline(self) -> Optional[float]:
        """Absolute deadline for one attempt (None when deadlines off)."""
        return deadline_at(self.ft.deadline_s)

    def _next_seq(self, srank: int, tag: int) -> int:
        seq = self._seq.get((srank, tag), 0) + 1
        self._seq[(srank, tag)] = seq
        return seq

    def _backoff(self, attempt: int, span=NULL_SPAN):
        """Sleep before resend ``attempt``; False when the client stopped."""
        backoff = self._retry.backoff_s(attempt)
        self._m_retries.inc()
        self._m_backoff.inc(backoff)
        span.mark("backoff")
        span.note(retries=attempt)
        return (yield from aio_sleep(backoff, live=self.live))

    def _op_with_retry(self, srank: int, payload: np.ndarray, tag: int,
                       ack_tag: int, seq: int, what: str, span=NULL_SPAN):
        """Send the staged frame, await its seq-matched ack; resend the
        same bytes on deadline under the backoff policy.  Exhaustion
        raises :class:`RetryExhausted` — the never-hang guarantee.
        ``span`` gets per-attempt phase marks and the terminal outcome."""
        last: Optional[BaseException] = None
        for attempt in range(self._retry.attempts):
            if attempt:
                self.log.debug("%s: retry %d after %r", what, attempt, last)
                if not (yield from self._backoff(attempt, span)):
                    span.end("aborted")
                    return None
            deadline = self._op_deadline()
            try:
                span.mark("send")
                if self._timing:
                    # Re-stamped per attempt; the server echoes whichever
                    # stamp rode the frame it saw, so the NTP pairing is
                    # exact even when acks and resends cross.
                    pack_tx_stamp(payload, self._hdr, obs_clock.wall_us())
                yield from aio_send(self.transport, payload, srank, tag,
                                    live=self.live, deadline=deadline)
                span.mark("ack")
                got = yield from self._await_ack(srank, ack_tag, seq, deadline,
                                                 span=span)
                if got is not None or not self.live.io:
                    span.end("ok" if got is not None else "aborted")
                    return got
            except DeadlineExceeded as exc:
                last = exc
        span.end("exhausted")
        self._flight_dump("retry_exhausted", what=what,
                          attempts=self._retry.attempts, peer=srank)
        raise RetryExhausted(what, self._retry.attempts, last)

    def _feed_clock(self, srank: int, t_tx: int, t_recv: int, t_ack: int) -> None:
        """One FLAG_TIMING exchange into the per-server estimator (t4 = now
        on this client's time base); accepted samples surface on the
        mpit_clock_offset_us gauge."""
        if self._clock.add_exchange(srank, t_tx, t_recv, t_ack,
                                    obs_clock.wall_us()):
            gauge = self._m_clock.get(srank)
            if gauge is None:
                gauge = self.metrics.gauge("mpit_clock_offset_us",
                                           rank=self.rank, peer=srank)
                self._m_clock[srank] = gauge
            gauge.set(self._clock.peer(srank).offset_us)

    def _await_ack(self, srank: int, ack_tag: int, seq: int,
                   deadline: Optional[float], span=NULL_SPAN):
        """Receive acks until the one echoing ``seq`` for the current
        epoch arrives.  Stale echoes (an earlier attempt's duplicate, a
        previous incarnation's leftovers) are consumed and dropped — on
        the attempt's unchanged deadline, so a trickle of stale acks
        cannot extend it.  Under FLAG_TIMING every current-epoch ack —
        matched or stale — is a complete NTP exchange and feeds the clock
        estimator; the matched one also lands its server stamps on the op
        span, so the trace carries both halves' marks."""
        buf = self._ack_buf[srank]
        while True:
            got = yield from aio_recv(self.transport, srank, ack_tag,
                                      live=self.live, out=buf,
                                      deadline=deadline)
            if got is None:
                return None
            epoch, aseq = int(buf[0]), int(buf[1])
            if self._timing and epoch == self.ft.epoch:
                self._feed_clock(srank, int(buf[2]), int(buf[3]), int(buf[4]))
            if epoch == self.ft.epoch and aseq == seq:
                if self._timing:
                    span.note(tx_us=int(buf[2]), srv_recv_us=int(buf[3]),
                              srv_ack_us=int(buf[4]))
                return got
            if epoch > self.ft.epoch or (epoch == self.ft.epoch and aseq > seq):
                raise RuntimeError(
                    f"ack from server {srank} is ahead of the op stream: "
                    f"got (epoch={epoch}, seq={aseq}), awaiting "
                    f"(epoch={self.ft.epoch}, seq={seq})"
                )

    def _maybe_heartbeat(self) -> None:
        """Emit a HEARTBEAT to every server when the interval elapsed.
        Piggybacks on ping()/wait() — the cadence the trainers already
        drive for comm overlap — so liveness needs no thread.  Sends are
        fire-and-forget with a bounded deadline: a dead server must not
        accumulate unbounded heartbeat tasks in the queue."""
        hb = self.ft.heartbeat_s
        if hb <= 0 or not self._started or not self.live.io:
            return
        now = time.monotonic()
        if now - self._hb_last < hb:
            return
        self._hb_last = now
        self._hb_seq += 1
        # Timing pairs stamp the beat: the server echoes the stamp back
        # with its own receive/send marks (HEARTBEAT_ECHO), so the clock
        # estimator refreshes from the heartbeat stream when no op is in
        # flight.
        payload = (timed_frame(self.ft.epoch, self._hb_seq, obs_clock.wall_us())
                   if self._timing
                   else header_frame(self.ft.epoch, self._hb_seq))
        self._m_hb.inc()
        targets = self._sc_beat_targets() if self._sc else self.sranks
        for srank in targets:
            self.sched.spawn(self._hb_send(payload, srank),
                             name=f"heartbeat:{srank}")

    def _hb_send(self, payload: np.ndarray, srank: int):
        try:
            yield from aio_send(
                self.transport, payload, srank, tags.HEARTBEAT,
                live=self.live, deadline=deadline_at(4 * self.ft.heartbeat_s),
            )
        except DeadlineExceeded:
            pass  # liveness is best-effort; the next beat tries again

    def _drain_clock_echoes(self) -> None:
        """Consume pending HEARTBEAT_ECHO replies (probed, never blocking):
        each carries a complete [t_tx_echo, t_recv, t_ack] exchange,
        refreshing the per-server clock offset while the trainer is
        compute-bound between ops.  A lost or late echo costs nothing."""
        if not self._timing or not self._started:
            return
        for srank in self.sranks:
            while self.transport.iprobe(srank, tags.HEARTBEAT_ECHO):
                handle = self.transport.irecv(srank, tags.HEARTBEAT_ECHO)
                while not self.transport.test(handle):
                    pass  # iprobe saw a fully-assembled message
                tail = np.frombuffer(bytes(self.transport.payload(handle)),
                                     np.int64)
                if len(tail) >= ACK_TIMING_WORDS and int(tail[0]) == self.ft.epoch:
                    self._feed_clock(srank, int(tail[2]), int(tail[3]),
                                     int(tail[4]))

    # -- shard control: shard-addressed ops over the versioned map -----------

    def _sc_start(self, param: np.ndarray) -> None:
        """INIT v4 to every server: codec + FT posture + the whole map.
        Per-shard staging is keyed by shard_id — placement moves, the
        cut never does, so buffers survive any number of migrations."""
        if self.smap is None:
            owners = [s for s in self.sranks for _ in range(self._sc_cut)]
            self.smap = _shardmap.ShardMap.initial(len(param), owners)
        if self.smap.plong != len(param):
            raise ValueError(
                f"shard map covers {self.smap.plong} elements but the "
                f"registered vector has {len(param)}")
        self.shards = [e.shard for e in self.smap.entries]
        self._m_mapver.set(self.smap.version)
        flags = FLAG_FRAMED | _scwire.FLAG_SHARDCTL | (
            FLAG_HEARTBEAT if self.ft.heartbeat_s > 0 else 0
        )
        self._sc_flags = flags
        self._sc_greeted = set(self.sranks)
        for e in self.smap.entries:
            if self.codec.identity:
                nbytes = e.shard.size * param.dtype.itemsize
            else:
                nbytes = self.codec.wire_nbytes(e.shard.size)
                if self.codec.uses_residual:
                    self._sc_residual[e.shard_id] = np.zeros(
                        e.shard.size, np.float32)
            self._sc_wire[e.shard_id] = np.zeros(
                _scwire.SC_HDR_BYTES + nbytes, np.uint8)
        cinfo = _scwire.init_v4(self.codec.wire_id, self.ft.epoch,
                                flags, self.smap)
        for srank in self.sranks:
            self.sched.spawn(
                aio_send(self.transport, cinfo, srank, tags.INIT,
                         live=self.live, deadline=self._op_deadline()),
                name=f"send_init:{srank}",
            )
        self.wait()
        self._started = True
        self._hb_last = 0.0
        if self.controller_rank is not None and self.seed_servers:
            # Hand the controller its first map (it starts blank so it
            # never has to know plong before the clients do).
            self.sched.spawn(
                aio_send(self.transport,
                         _scwire.map_update(_scwire.INSTALL, -1, self.rank,
                                            self.smap),
                         self.controller_rank, tags.MAP_UPDATE,
                         live=self.live, deadline=self._op_deadline()),
                name="send_map:controller",
            )
            self.wait()
        if self.seed_servers:
            self.async_send_param()
            self.wait()

    def _sc_next_seq(self, sid: int, tag: int) -> int:
        seq = self._sc_seq.get((sid, tag), 0) + 1
        self._sc_seq[(sid, tag)] = seq
        return seq

    def _sc_install_wire(self, body) -> bool:
        """Adopt a serialized map if it is newer than ours."""
        m = _shardmap.ShardMap.from_wire(np.frombuffer(bytes(body), np.int64))
        if self.smap is None or m.version > self.smap.version:
            self.smap = m
            self._m_mapver.set(m.version)
            return True
        return False

    def _sc_poll_map(self) -> None:
        """Drain any MAP_UPDATE broadcasts from the controller (probed,
        never blocking): proactive re-routing, and the only way to learn
        a failover map while the old owner is dead air."""
        if not self._sc or self.controller_rank is None:
            return
        while self.transport.iprobe(self.controller_rank, tags.MAP_UPDATE):
            handle = self.transport.irecv(self.controller_rank,
                                          tags.MAP_UPDATE)
            while not self.transport.test(handle):
                pass  # iprobe saw a fully-assembled message
            kind, _sid, peer, m = _scwire.parse_map_update(
                bytes(self.transport.payload(handle)))
            if kind == _scwire.RETIRED:
                # A goodbye, not a crash: drop the rank from beat/STOP
                # fan-out.  Its shards already drained (the map carried
                # here no longer routes anything to it).
                self._sc_retired.add(peer)
            if self.smap is None or m.version > self.smap.version:
                self.smap = m
                self._m_mapver.set(m.version)

    def _sc_write_op(self, sid: int, tag: int, ack_tag: int, what: str):
        """One shard write (GRAD / PARAM_PUSH): encode once into the
        shard's staging frame, then run the attempt loop.  The residual
        folds at this single encode; re-routes resend the same bytes."""
        shard = self.smap.entry(sid).shard
        span = self._spans.op(what, peer=sid, side="client",
                              rank=self.rank)
        view = (self.grad if tag == tags.GRAD else
                self.param)[shard.offset: shard.end]
        wire = self._sc_wire[sid]
        span.mark("encode")
        body = wire[_scwire.SC_HDR_BYTES:]
        if self.codec.identity:
            body[:] = view.view(np.uint8)
        else:
            residual = (self._sc_residual.get(sid)
                        if tag == tags.GRAD else None)
            self.codec.encode_into(view, body, residual=residual)
        seq = self._sc_next_seq(sid, tag)
        span.note(epoch=self.ft.epoch, seq=seq, shard=sid)
        yield from self._sc_attempts(sid, seq, wire, tag, ack_tag,
                                     out=None, span=span,
                                     what=f"{what} for shard {sid}")

    def _sc_read_op(self, sid: int):
        """One shard read: request-by-header, decode the OK reply's
        snapshot frame into the param slice."""
        shard = self.smap.entry(sid).shard
        span = self._spans.op("PARAM", peer=sid, side="client",
                              rank=self.rank)
        out = self.param[shard.offset: shard.end]
        seq = self._sc_next_seq(sid, tags.PARAM_REQ)
        span.note(epoch=self.ft.epoch, seq=seq, shard=sid)
        yield from self._sc_attempts(sid, seq, None, tags.PARAM_REQ,
                                     tags.PARAM, out=out, span=span,
                                     what=f"PARAM read for shard {sid}")

    def _sc_attempts(self, sid: int, seq: int, wire: Optional[np.ndarray],
                     tag: int, ack_tag: int, out: Optional[np.ndarray],
                     span, what: str):
        """The shardctl attempt loop: send to the shard's current owner,
        await the status reply; DeadlineExceeded retries under backoff
        (polling controller broadcasts), NACK_MAP installs the carried
        map and re-routes, BUSY backs off through a migration window.
        A re-route to a *different* owner resets the attempt budget —
        monotone map versions bound the total work.  Exhaustion raises
        :class:`RetryExhausted`; the never-hang guarantee holds."""
        attempt = 0
        nacks = 0
        max_nacks = 16 * (self._retry.attempts + 1)
        last: Optional[BaseException] = None
        while self.live.io:
            owner = self.smap.owner(sid)
            if owner not in self._sc_greeted:
                # First contact with a scaled-up server (§9.1): announce
                # this incarnation before the op — the lazy INIT v4 that
                # makes late membership transparent to the op stream.
                yield from self._sc_greet(owner)
            if wire is not None:
                _scwire.pack_sc_header(wire, self.ft.epoch, seq,
                                       self.smap.version, sid)
                payload: np.ndarray = wire
            else:
                payload = _scwire.sc_header(self.ft.epoch, seq,
                                            self.smap.version, sid)
            deadline = self._op_deadline()
            try:
                span.mark("send")
                yield from aio_send(self.transport, payload, owner, tag,
                                    live=self.live, deadline=deadline)
                span.mark("recv" if out is not None else "ack")
                while True:
                    raw = yield from aio_recv(self.transport, owner, ack_tag,
                                              live=self.live,
                                              deadline=deadline)
                    if raw is None:
                        span.end("aborted")
                        return None
                    epoch, aseq, status, rsid, body = _scwire.parse_reply(
                        bytes(raw))
                    if epoch == self.ft.epoch and rsid == sid and aseq == seq:
                        break
                    if epoch > self.ft.epoch or (
                            epoch == self.ft.epoch and rsid == sid
                            and aseq > seq):
                        raise RuntimeError(
                            f"reply from server {owner} is ahead of the op "
                            f"stream: got (epoch={epoch}, seq={aseq}, "
                            f"shard={rsid}), awaiting (epoch="
                            f"{self.ft.epoch}, seq={seq}, shard={sid})")
                    # stale echo (earlier attempt / other shard): drop on
                    # the unchanged attempt deadline
            except DeadlineExceeded as exc:
                last = exc
                attempt += 1
                if attempt >= self._retry.attempts:
                    span.end("exhausted")
                    self._flight_dump("retry_exhausted", what=what,
                                      attempts=self._retry.attempts,
                                      shard=sid)
                    raise RetryExhausted(what, self._retry.attempts, last)
                backoff = self._retry.backoff_s(attempt)
                self._m_retries.inc()
                self._m_backoff.inc(backoff)
                span.mark("backoff")
                span.note(retries=attempt)
                if not (yield from aio_sleep(backoff, live=self.live)):
                    span.end("aborted")
                    return None
                self._sc_poll_map()
                if self.smap.owner(sid) != owner:
                    # A broadcast re-routed us (failover away from a dead
                    # owner): the new destination gets a fresh budget.
                    self._m_reroutes.inc()
                    span.mark("reroute")
                    attempt = 0
                continue
            if status == _scwire.OK:
                if out is not None:
                    span.mark("decode")
                    self._sc_decode(body, out)
                span.end("ok")
                return True
            # NACK_MAP / BUSY — both may carry the server's newer map.
            nacks += 1
            self._m_nacks.inc()
            span.mark("nack")
            if nacks > max_nacks:
                span.end("exhausted")
                self._flight_dump("retry_exhausted",
                                  what=f"{what} (map churn)", nacks=nacks,
                                  shard=sid)
                raise RetryExhausted(f"{what} (map churn)", nacks, last)
            if len(body) and self._sc_install_wire(body) \
                    and self.smap.owner(sid) != owner:
                self._m_reroutes.inc()
                span.mark("reroute")
                attempt = 0
            if status == _scwire.BUSY:
                # Mid-migration freeze window: give the handoff a beat.
                if not (yield from aio_sleep(self._retry.backoff_s(1),
                                             live=self.live)):
                    span.end("aborted")
                    return None
                self._sc_poll_map()
        span.end("aborted")
        return None

    def _sc_greet(self, owner: int):
        """Announce this client (INIT v4 with the current map) to a
        server that joined after launch.  The server's listener
        negotiates and spawns services before it sees our first op —
        both tags are FIFO per channel, so ordering is the transport's."""
        cinfo = _scwire.init_v4(self.codec.wire_id, self.ft.epoch,
                                self._sc_flags, self.smap)
        yield from aio_send(self.transport, cinfo, owner, tags.INIT,
                            live=self.live, deadline=self._op_deadline())
        self._sc_greeted.add(owner)

    def _sc_beat_targets(self) -> "List[int]":
        """Liveness fan-out under shardctl: everyone this incarnation
        announced itself to, minus clean departures."""
        return sorted(self._sc_greeted - self._sc_retired)

    def _sc_decode(self, body, out: np.ndarray) -> None:
        frame = np.frombuffer(bytes(body), np.uint8)
        if self.codec.identity:
            out.view(np.uint8)[:] = frame
        else:
            self.codec.decode_into(frame, out)

    def _sc_enqueue(self, gen: Generator, name: str) -> None:
        self._scq.append((gen, name))
        if not self._sc_pump_live:
            self._sc_pump_live = True
            self._sc_pump_task = None
            self._sc_pump_task = self.sched.spawn(self._sc_pump(),
                                                  name=f"scpump:{name}")

    def _sc_pump(self):
        """One global FIFO for shard-control ops: strictly serialized, so
        the per-(owner, tag) reply channels never interleave two in-flight
        ops' echoes even when one server owns several shards.  (The static
        path keeps its per-server pumps and full cross-server overlap.)"""
        queue = self._scq
        try:
            while queue:
                op, opname = queue.popleft()
                task = self._sc_pump_task
                if task is not None:
                    task.name = f"scpump:{opname}"
                yield from op
        finally:
            self._sc_pump_live = False

    # -- per-server ops ------------------------------------------------------

    def _encode(self, view: np.ndarray, wire: Optional[np.ndarray],
                residual: Optional[np.ndarray] = None) -> np.ndarray:
        """The slice itself for the unframed identity codec (zero-copy
        send); otherwise the encoded frame in the per-server staging
        buffer — behind the [epoch, seq] header slot when framed.  The
        encode (and its residual fold) happens exactly once per op;
        retries resend these bytes."""
        if wire is None:
            return view
        body = wire[self._hdr:]
        if self.codec.identity:
            body[:] = view.view(np.uint8)
        else:
            self.codec.encode_into(view, body, residual=residual)
        return wire

    def _decode_framed(self, wire: np.ndarray, out: np.ndarray) -> None:
        body = wire[self._hdr_rx:]
        if self.codec.identity:
            out.view(np.uint8)[:] = body
        else:
            self.codec.decode_into(body, out)

    def _write_op(self, srank: int, payload: np.ndarray, tag: int, ack_tag: int,
                  what: str, span):
        """A whole-shard write (GRAD or PARAM_PUSH): unframed, send and
        await the ack; framed, stamp [epoch, seq] (and the basis version)
        and run it under retry."""
        if not self.ft.framed:
            span.mark("send")
            yield from aio_send(self.transport, payload, srank, tag,
                                live=self.live, deadline=self._op_deadline())
            span.mark("ack")
            yield from aio_recv(self.transport, srank, ack_tag, live=self.live,
                                deadline=self._op_deadline())
            span.end("ok")
            return
        seq = self._next_seq(srank, tag)
        span.note(epoch=self.ft.epoch, seq=seq)
        pack_header(payload, self.ft.epoch, seq)
        if self._stale:
            # The param version this write was computed against (the last
            # PARAM read from this server); the server measures the gap.
            # Pushes fill the word too (a uniform layout); the server
            # ignores it there.
            basis = self._basis.get(srank, 0)
            pack_version(payload, basis)
            if tag == tags.GRAD:
                span.note(basis=basis)
        yield from self._op_with_retry(srank, payload, tag, ack_tag, seq,
                                       f"{what} to server {srank}", span=span)

    def _send_grad(self, srank: int, shard: Shard):
        """Ship the grad slice, await the applied ack
        (reference pclient.lua:48-58).  Non-identity codecs encode into
        the per-server staging frame at ship time; the int8 residual is
        folded in and refreshed by the same pass."""
        span = self._spans.op("GRAD", peer=srank, side="client", rank=self.rank)
        span.mark("encode")
        payload = self._encode(self.grad[shard.offset:shard.end],
                               self._grad_wire.get(srank),
                               residual=self._residual.get(srank))
        yield from self._write_op(srank, payload, tags.GRAD, tags.GRAD_ACK,
                                  "GRAD", span)

    def _recv_param(self, srank: int, shard: Shard):
        """Request-to-read header, then receive into the param slice
        (reference pclient.lua:72-82) — via the wire staging frame when
        the codec is not identity.  Framed mode seq-tags the request and
        discards snapshot frames that echo an earlier request."""
        span = self._spans.op("PARAM", peer=srank, side="client", rank=self.rank)
        out = self.param[shard.offset:shard.end]
        if not self.ft.framed:
            wire = self._param_wire.get(srank)
            span.mark("send")
            yield from aio_send(self.transport, tags.EMPTY, srank, tags.PARAM_REQ,
                                live=self.live, deadline=self._op_deadline())
            span.mark("recv")
            got = yield from aio_recv(self.transport, srank, tags.PARAM,
                                      live=self.live,
                                      out=out if wire is None else wire,
                                      deadline=self._op_deadline())
            if got is not None and wire is not None:
                span.mark("decode")
                self.codec.decode_into(wire, out)
            span.end("ok" if got is not None else "aborted")
            return
        seq = self._next_seq(srank, tags.PARAM_REQ)
        span.note(epoch=self.ft.epoch, seq=seq)
        wire = self._param_rx[srank]
        req = (timed_frame(self.ft.epoch, seq, 0) if self._timing
               else header_frame(self.ft.epoch, seq))
        last: Optional[BaseException] = None
        for attempt in range(self._retry.attempts):
            if attempt and not (yield from self._backoff(attempt, span)):
                span.end("aborted")
                return
            deadline = self._op_deadline()
            try:
                span.mark("send")
                if self._timing:
                    req[2] = obs_clock.wall_us()  # re-stamped per attempt
                yield from aio_send(self.transport, req, srank, tags.PARAM_REQ,
                                    live=self.live, deadline=deadline)
                span.mark("recv")
                while True:
                    got = yield from aio_recv(self.transport, srank, tags.PARAM,
                                              live=self.live, out=wire,
                                              deadline=deadline)
                    if got is None:
                        span.end("aborted")
                        return
                    epoch, aseq = unpack_header(wire)
                    if self._timing and epoch == self.ft.epoch:
                        # Any current-epoch reply — matched or a stale
                        # duplicate — is a complete NTP exchange.
                        t_tx, t_recv, t_ack = unpack_reply_stamps(
                            wire, self._hdr_rx - 24)
                        self._feed_clock(srank, t_tx, t_recv, t_ack)
                    if epoch == self.ft.epoch and aseq == seq:
                        if self._stale:
                            # The basis the next gradient to this server echoes.
                            self._basis[srank] = unpack_version(wire)
                        if self._timing:
                            span.note(tx_us=t_tx, srv_recv_us=t_recv,
                                      srv_ack_us=t_ack)
                        span.mark("decode")
                        self._decode_framed(wire, out)
                        span.end("ok")
                        return
                    # a stale snapshot (an earlier request's duplicate): drop
            except DeadlineExceeded as exc:
                last = exc
        span.end("exhausted")
        self._flight_dump("retry_exhausted",
                          what=f"PARAM read from server {srank}",
                          attempts=self._retry.attempts, peer=srank)
        raise RetryExhausted(f"PARAM read from server {srank}",
                             self._retry.attempts, last)

    def _send_param(self, srank: int, shard: Shard):
        """Whole-shard write, await ack (reference pclient.lua:60-70).
        No residual: parameter pushes (seeding / single-worker mirror)
        are one-shot state transfers, not an accumulating signal."""
        span = self._spans.op("PARAM_PUSH", peer=srank, side="client",
                              rank=self.rank)
        span.mark("encode")
        payload = self._encode(self.param[shard.offset:shard.end],
                               self._param_wire.get(srank))
        yield from self._write_op(srank, payload, tags.PARAM_PUSH,
                                  tags.PARAM_PUSH_ACK, "PARAM_PUSH", span)

    def grads_acked(self) -> Dict[str, int]:
        """Per server, the GRADs of this incarnation it has acked (framed:
        the last GRAD seq, once ``wait`` returned); the other half of a
        server's exactly-once accounting."""
        return {str(s): self._seq.get((s, tags.GRAD), 0) for s in self.sranks}

    def residual_norm(self) -> float:
        """L2 norm of the error-feedback residuals across shards (0.0 for
        residual-free codecs)."""
        residuals = list(self._residual.values()) + list(self._sc_residual.values())
        if not residuals:
            return 0.0
        return float(np.sqrt(sum(float(np.dot(r, r)) for r in residuals)))

    # -- public async API (reference pclient.lua:84-109) --------------------

    def _enqueue(self, srank: int, gen: Generator, name: str) -> None:
        queue = self._opq.setdefault(srank, deque())
        queue.append((gen, name))
        if not self._pump_live.get(srank, False):
            self._pump_live[srank] = True
            self._pump_task[srank] = None
            self._pump_task[srank] = self.sched.spawn(
                self._pump(srank), name=f"pump:{srank}:{name}")

    def _pump(self, srank: int):
        """Run this server's queued ops strictly in order, renaming the
        task per dequeued op (so errors name the op that raised)."""
        queue = self._opq[srank]
        try:
            while queue:
                op, opname = queue.popleft()
                task = self._pump_task.get(srank)
                if task is not None:
                    task.name = f"pump:{srank}:{opname}"
                yield from op
        finally:
            self._pump_live[srank] = False

    def async_send_grad(self) -> None:
        if self._sc:
            for e in self.smap.entries:
                self._sc_enqueue(self._sc_write_op(e.shard_id, tags.GRAD,
                                                   tags.GRAD_ACK, "GRAD"),
                                 "send_grad")
            return
        for srank, shard in zip(self.sranks, self.shards):
            self._enqueue(srank, self._send_grad(srank, shard), "send_grad")

    def async_recv_param(self) -> None:
        if self._sc:
            for e in self.smap.entries:
                self._sc_enqueue(self._sc_read_op(e.shard_id), "recv_param")
            return
        for srank, shard in zip(self.sranks, self.shards):
            self._enqueue(srank, self._recv_param(srank, shard), "recv_param")

    def async_send_param(self) -> None:
        if self._sc:
            for e in self.smap.entries:
                self._sc_enqueue(self._sc_write_op(e.shard_id, tags.PARAM_PUSH,
                                                   tags.PARAM_PUSH_ACK, "PARAM_PUSH"),
                                 "send_param")
            return
        for srank, shard in zip(self.sranks, self.shards):
            self._enqueue(srank, self._send_param(srank, shard), "send_param")

    def ping(self, n: int = 1) -> None:
        """Single-step I/O progress to overlap with compute
        (reference pclient.lua:131-136)."""
        self._maybe_heartbeat()
        self._sc_poll_map()
        self._drain_clock_echoes()
        for _ in range(n):
            self.sched.ping()

    def wait(self) -> None:
        if self.ft.heartbeat_s > 0:
            # Keep beating while blocked on slow servers: the wait loop is
            # exactly where a stalled gang would otherwise go silent and
            # get this client evicted.
            while self.sched.queue:
                self._maybe_heartbeat()
                self._sc_poll_map()
                self._drain_clock_echoes()
                self.sched.ping_pass()
            if self.sched.errors:
                raise self.sched.errors.pop(0)
            return
        self.sched.wait()

    # -- shutdown (reference pclient.lua:153-164) ---------------------------

    def stop(self) -> None:
        # Chained per server, so the stop cannot overtake in-flight ops
        # (the reference's drain-then-stop care, init.lua:50-58, README:71).
        if self._sc:
            # The global pump gives the same drain-then-stop order; the
            # controller counts client STOPs too.  Membership may have
            # changed since launch: STOP every server this incarnation
            # greeted plus every current owner (a joiner waits for our STOP
            # like a launch member), never a retired rank.
            self._sc_poll_map()
            owners = set(self.smap.owners()) if self.smap is not None else set()
            stop_to = sorted((set(self._sc_greeted or self.sranks) | owners)
                             - self._sc_retired) + (
                [self.controller_rank] if self.controller_rank is not None else [])
            for dst in stop_to:
                self._sc_enqueue(aio_send(self.transport, tags.EMPTY, dst,
                                          tags.STOP, live=self.live,
                                          deadline=self._op_deadline()),
                                 "send_stop")
            self.wait()
            self.live.stop()
            return
        for srank in self.sranks:
            self._enqueue(srank, aio_send(self.transport, tags.EMPTY, srank,
                                          tags.STOP, live=self.live,
                                          deadline=self._op_deadline()),
                          "send_stop")
        self.wait()
        self.live.stop()
