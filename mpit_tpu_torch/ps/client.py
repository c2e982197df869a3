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
word.  Causal timing, chunked streaming, shard control and the weighted
layout come with later slices: their knobs and constructor arguments
raise ``NotImplementedError`` naming the slice.

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
    FLAG_FRAMED,
    FLAG_HEARTBEAT,
    FLAG_STALENESS,
    FTConfig,
    RetryExhausted,
    RetryPolicy,
    hdr_bytes,
    header_frame,
    init_v3,
    pack_header,
    pack_version,
    reply_hdr_bytes,
    unpack_header,
    unpack_version,
)
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
        #: per-server param version this client last read (the basis the
        #: next gradient is computed against); 0 until the first read.
        self._basis: Dict[int, int] = {}
        self._hdr = hdr_bytes(self._stale, False) if self.ft.framed else 0
        self._hdr_rx = reply_hdr_bytes(self._stale, False) if self.ft.framed else 0
        # Per-server codec state: encode/decode staging sized to the wire
        # format (plus the FT header when framed), the framed reply and ack
        # buffers, and the int8 error-feedback residual (grad path only).
        self._grad_wire: Dict[int, np.ndarray] = {}
        self._param_wire: Dict[int, np.ndarray] = {}
        self._param_rx: Dict[int, np.ndarray] = {}
        self._ack_buf: Dict[int, np.ndarray] = {}
        self._residual: Dict[int, np.ndarray] = {}
        #: per-(server, tag) op sequence numbers (FT framing identity)
        self._seq: Dict[Tuple[int, int], int] = {}
        self._hb_last = 0.0
        self._hb_seq = 0
        self.retries = 0  # resends performed
        self.heartbeats_sent = 0
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
            FLAG_STALENESS if self._stale else 0)
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
                self._ack_buf[srank] = np.zeros(2, np.int64)
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

    # -- FT plumbing ---------------------------------------------------------

    def _op_deadline(self) -> Optional[float]:
        """Absolute deadline for one attempt (None when deadlines off)."""
        return deadline_at(self.ft.deadline_s)

    def _next_seq(self, srank: int, tag: int) -> int:
        seq = self._seq.get((srank, tag), 0) + 1
        self._seq[(srank, tag)] = seq
        return seq

    def _backoff(self, attempt: int):
        """Sleep before resend ``attempt``; False when the client stopped."""
        self.retries += 1
        return (yield from aio_sleep(self._retry.backoff_s(attempt), live=self.live))

    def _op_with_retry(self, srank: int, payload: np.ndarray, tag: int,
                       ack_tag: int, seq: int, what: str):
        """Send the staged frame, await its seq-matched ack; resend the
        same bytes on deadline under the backoff policy.  Exhaustion
        raises :class:`RetryExhausted` — the never-hang guarantee."""
        last: Optional[BaseException] = None
        for attempt in range(self._retry.attempts):
            if attempt:
                self.log.debug("%s: retry %d after %r", what, attempt, last)
                if not (yield from self._backoff(attempt)):
                    return None
            deadline = self._op_deadline()
            try:
                yield from aio_send(self.transport, payload, srank, tag,
                                    live=self.live, deadline=deadline)
                got = yield from self._await_ack(srank, ack_tag, seq, deadline)
                if got is not None or not self.live.io:
                    return got
            except DeadlineExceeded as exc:
                last = exc
        raise RetryExhausted(what, self._retry.attempts, last)

    def _await_ack(self, srank: int, ack_tag: int, seq: int,
                   deadline: Optional[float]):
        """Receive acks until the one echoing ``seq`` for the current
        epoch arrives.  Stale echoes (an earlier attempt's duplicate, a
        previous incarnation's leftovers) are consumed and dropped — on
        the attempt's unchanged deadline, so a trickle of stale acks
        cannot extend it."""
        buf = self._ack_buf[srank]
        while True:
            got = yield from aio_recv(self.transport, srank, ack_tag,
                                      live=self.live, out=buf,
                                      deadline=deadline)
            if got is None:
                return None
            epoch, aseq = int(buf[0]), int(buf[1])
            if epoch == self.ft.epoch and aseq == seq:
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
        payload = header_frame(self.ft.epoch, self._hb_seq)
        self.heartbeats_sent += 1
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
                  what: str):
        """A whole-shard write (GRAD or PARAM_PUSH): unframed, send and
        await the ack; framed, stamp [epoch, seq] (and the basis version)
        and run it under retry."""
        if not self.ft.framed:
            yield from aio_send(self.transport, payload, srank, tag,
                                live=self.live, deadline=self._op_deadline())
            yield from aio_recv(self.transport, srank, ack_tag, live=self.live,
                                deadline=self._op_deadline())
            return
        seq = self._next_seq(srank, tag)
        pack_header(payload, self.ft.epoch, seq)
        if self._stale:
            # The param version this write was computed against (the last
            # PARAM read from this server); the server measures the gap.
            pack_version(payload, self._basis.get(srank, 0))
        yield from self._op_with_retry(srank, payload, tag, ack_tag, seq,
                                       f"{what} to server {srank}")

    def _send_grad(self, srank: int, shard: Shard):
        """Ship the grad slice, await the applied ack
        (reference pclient.lua:48-58).  Non-identity codecs encode into
        the per-server staging frame at ship time; the int8 residual is
        folded in and refreshed by the same pass."""
        payload = self._encode(self.grad[shard.offset:shard.end],
                               self._grad_wire.get(srank),
                               residual=self._residual.get(srank))
        yield from self._write_op(srank, payload, tags.GRAD, tags.GRAD_ACK, "GRAD")

    def _recv_param(self, srank: int, shard: Shard):
        """Request-to-read header, then receive into the param slice
        (reference pclient.lua:72-82) — via the wire staging frame when
        the codec is not identity.  Framed mode seq-tags the request and
        discards snapshot frames that echo an earlier request."""
        out = self.param[shard.offset:shard.end]
        if not self.ft.framed:
            wire = self._param_wire.get(srank)
            yield from aio_send(self.transport, tags.EMPTY, srank, tags.PARAM_REQ,
                                live=self.live, deadline=self._op_deadline())
            got = yield from aio_recv(self.transport, srank, tags.PARAM,
                                      live=self.live,
                                      out=out if wire is None else wire,
                                      deadline=self._op_deadline())
            if got is not None and wire is not None:
                self.codec.decode_into(wire, out)
            return
        seq = self._next_seq(srank, tags.PARAM_REQ)
        wire = self._param_rx[srank]
        req = header_frame(self.ft.epoch, seq)
        last: Optional[BaseException] = None
        for attempt in range(self._retry.attempts):
            if attempt and not (yield from self._backoff(attempt)):
                return
            deadline = self._op_deadline()
            try:
                yield from aio_send(self.transport, req, srank, tags.PARAM_REQ,
                                    live=self.live, deadline=deadline)
                while True:
                    got = yield from aio_recv(self.transport, srank, tags.PARAM,
                                              live=self.live, out=wire,
                                              deadline=deadline)
                    if got is None:
                        return
                    epoch, aseq = unpack_header(wire)
                    if epoch == self.ft.epoch and aseq == seq:
                        if self._stale:
                            # The basis the next gradient to this server echoes.
                            self._basis[srank] = unpack_version(wire)
                        self._decode_framed(wire, out)
                        return
                    # a stale snapshot (an earlier request's duplicate): drop
            except DeadlineExceeded as exc:
                last = exc
        raise RetryExhausted(f"PARAM read from server {srank}",
                             self._retry.attempts, last)

    def _send_param(self, srank: int, shard: Shard):
        """Whole-shard write, await ack (reference pclient.lua:60-70).
        No residual: parameter pushes (seeding / single-worker mirror)
        are one-shot state transfers, not an accumulating signal."""
        payload = self._encode(self.param[shard.offset:shard.end],
                               self._param_wire.get(srank))
        yield from self._write_op(srank, payload, tags.PARAM_PUSH,
                                  tags.PARAM_PUSH_ACK, "PARAM_PUSH")

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
        for _ in range(n):
            self.sched.ping()

    def wait(self) -> None:
        if self.ft.heartbeat_s > 0:
            # Keep beating while blocked on slow servers: the wait loop is
            # exactly where a stalled gang would otherwise go silent and
            # get this client evicted.
            while self.sched.queue:
                self._maybe_heartbeat()
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
