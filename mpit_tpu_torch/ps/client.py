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
and heartbeat echoes into a per-server clock-offset estimator.  Chunked
streaming, shard control and the weighted layout come with later slices:
their knobs and constructor arguments raise ``NotImplementedError``
naming the slice.

Observability (:mod:`mpit_tpu_torch.obs`): every op records a span with
the JAX client's phase marks (encode, send, ack or recv, decode, backoff)
and outcome; retry exhaustion dumps the flight recorder; with obs on the
client registers a ``/status`` section.  Disabled, the recorder and the
flight recorder are the shared null objects and read no clock.

The shard cut is :func:`mpit_tpu_torch.ps.sharding.shard_layout`'s equal
split, the cut the JAX client's version-0 shard map makes.
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
from mpit_tpu_torch.utils.logging import get_logger

#: What each refused constructor argument of the JAX client belongs to.
LATER_CLIENT_ARGS = {
    "shard_map": "shard control (slice 5, shardctl)",
    "shardctl": "shard control (slice 5, shardctl)",
    "controller_rank": "shard control (slice 5, shardctl)",
    "sc_shards_per_server": "shard control (slice 5, shardctl)",
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
        self._stale = self.ft.stale_track
        # Causal timing (FLAG_TIMING): data frames carry a wall-µs send
        # stamp and every ack/reply a [t_tx_echo, t_recv, t_ack] tail — the
        # four NTP marks that feed the per-server clock-offset estimator.
        # Rides the framed wire like staleness.
        self._timing = self.ft.timing_track
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
        self._opq: Dict[int, Deque[Tuple[Generator, str]]] = {}
        self._pump_live: Dict[int, bool] = {}
        self._pump_task: Dict[int, Optional[Task]] = {}

    # -- lifecycle ----------------------------------------------------------

    def start(self, param: np.ndarray, grad: np.ndarray) -> None:
        """Announce shard layout + codec to every server; the first client
        seeds the servers' shards from ``param`` (reference
        pclient.lua:111-129).  INIT v2: int64 [offset, size, codec_id];
        with any FT feature active, INIT v3 adds [epoch, flags]."""
        self._register(param, grad)
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
            "map_version": 0,  # the static layout: the JAX client's version-0 map
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
        for srank in self.sranks:
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
        for srank, shard in zip(self.sranks, self.shards):
            self._enqueue(srank, self._send_grad(srank, shard), "send_grad")

    def async_recv_param(self) -> None:
        for srank, shard in zip(self.sranks, self.shards):
            self._enqueue(srank, self._recv_param(srank, shard), "recv_param")

    def async_send_param(self) -> None:
        for srank, shard in zip(self.sranks, self.shards):
            self._enqueue(srank, self._send_param(srank, shard), "send_param")

    def ping(self, n: int = 1) -> None:
        """Single-step I/O progress to overlap with compute
        (reference pclient.lua:131-136)."""
        self._maybe_heartbeat()
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
        for srank in self.sranks:
            self._enqueue(srank, aio_send(self.transport, tags.EMPTY, srank,
                                          tags.STOP, live=self.live,
                                          deadline=self._op_deadline()),
                          "send_stop")
        self.wait()
        self.live.stop()
