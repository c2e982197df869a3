"""ServingCell — a follower serving rank of the multi-cell fabric
(docs/PROTOCOL.md §11).

The port of ``mpit_tpu/cells/cell.py``.  A cell is host code: it holds
the upstream's encoded frames as numpy bytes, installs deltas with a numpy
XOR, and makes no CUDA context; what it serves is the shard its upstream
applied on the card (K3 under Adam), byte for byte.  A chunk-framed
subscription (``FLAG_CHUNKED``, INIT v5) comes with chunked streaming
(slice 5f): the port's ``FTConfig`` refuses the chunk cut it needs.

A cell attaches to its upstream :class:`~mpit_tpu_torch.ps.server.ParamServer`
with the SUBSCRIBE posture (INIT v3, ``FLAG_READONLY | FLAG_SUBSCRIBE``),
receives the committed version stream as snapshot diffs (full encoded
frame on attach, then XOR deltas out of the upstream's snapshot cache —
:mod:`mpit_tpu_torch.cells.wire`), installs them into its own version-counted
serving cache, and answers READ-ONLY reader traffic **through the server's
reader dispatcher unchanged**: the dispatcher, admission-budget and
reply-task machinery are literally :class:`ParamServer`'s methods bound
to this class, so a reader cannot tell a cell from a training server —
except for the two §11 extensions those methods grew hooks for:

- **lag-gated admission** (:meth:`_read_gate`): a read is granted only
  while ``head_version - installed_version <= max_lag``; past the bound
  (or mid-resync) the reply is BUSY-with-retry-hint, so the staleness
  bound is *enforced* — a cell that fell behind sheds readers instead
  of serving bytes older than it promised.  Head knowledge rides the
  heartbeat channel (the upstream answers every subscriber beat with a
  ``[epoch, seq, head_version]`` echo), so a delayed or dropped diff
  stream *widens the known lag* rather than hiding it.
- **head-stamped OK replies** (:meth:`_serve_ok_header`): the granted
  reply's header carries a fifth word — the cell's known head — so
  readers see both the version they got and how far behind it was
  (the ``mpit_serve_read_lag`` surface, §11.5).

Failure shapes, all reusing proven machinery: the cell leases its
readers (the FT lease registry) and HEARTBEATs its upstream, so a dead cell is
*detected* (upstream lease expiry) not discovered; a broken diff chain
(dropped DELTA ⇒ ``from_version`` mismatch) triggers a DIFF_REQ resync
answered with a FULL frame; a cell beyond the lag bound degrades
gracefully — sheds reads via BUSY, dumps a ``cell_lag_shed`` flight
postmortem with its version window, resyncs, resumes; and retirement
reuses GOODBYE-with-successor so drained readers re-route
without spending their retry budget.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from mpit_tpu_torch.aio import (
    EXEC,
    DeadlineExceeded,
    LiveFlag,
    Scheduler,
    aio_recv,
    aio_send,
    aio_sleep,
    deadline_at,
)
from mpit_tpu_torch.cells import wire as _cellwire
from mpit_tpu_torch.comm import codec as codec_mod
from mpit_tpu_torch.comm.transport import Transport
from mpit_tpu_torch.ft import (
    FLAG_FRAMED,
    FLAG_HEARTBEAT,
    FLAG_READONLY,
    FLAG_SUBSCRIBE,
    FTConfig,
    LeaseRegistry,
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
from mpit_tpu_torch.ps import serve as _psserve
from mpit_tpu_torch.ps import tags
from mpit_tpu_torch.ps.server import ParamServer as _PS
from mpit_tpu_torch.utils.logging import get_logger


class ServingCell:
    """One follower serving rank: subscriber upstream, server downstream.

    ``reader_ranks`` is the full set of readers that *may* attach (the
    fabric's readers announce to every cell so lazy attach, STOP
    accounting and GOODBYE re-routing all work unchanged); ``max_lag``
    is the admission bound in committed versions.  The cell runs until
    every expected reader is terminal (the dispatcher's stop condition,
    exactly a ParamServer's) or :meth:`shutdown` — then it STOPs its
    upstream subscription and returns."""

    # -- the server's serving tier, reused verbatim ("answers reader PARAM
    # -- requests through the reader dispatcher unchanged") -------------------
    _reader_dispatcher = _PS._reader_dispatcher
    _dispatch_read = _PS._dispatch_read
    _dispatch_recv = _PS._dispatch_recv
    _serve_reply = _PS._serve_reply
    _update_reader_gauge = _PS._update_reader_gauge
    _svc_abort = _PS._svc_abort
    retire_serving = _PS.retire_serving

    def __init__(
        self,
        rank: int,
        upstream: int,
        transport: Transport,
        reader_ranks: "list[int]",
        *,
        offset: int = 0,
        size: int,
        dtype=np.float32,
        codec: Optional[str] = None,
        max_lag: int = 4,
        resync_lag: Optional[int] = None,
        shed_hint_us: int = 5_000,
        ft: Optional[FTConfig] = None,
        serve: "Optional[_psserve.ServeConfig]" = None,
        scheduler: Optional[Scheduler] = None,
    ):
        self.rank = rank
        self.upstream = int(upstream)
        self.transport = transport
        self.readers = list(reader_ranks)
        self._reader_set = set(self.readers)
        self.offset, self.size = int(offset), int(size)
        from mpit_tpu_torch.utils.serialize import resolve_dtype

        self.dtype = resolve_dtype(dtype)
        self.codec = codec_mod.get(codec)
        if int(max_lag) < 0:
            raise ValueError(f"max_lag must be >= 0, got {max_lag}")
        self.max_lag = int(max_lag)
        #: beyond this known lag the cell stops replaying deltas and
        #: jumps to head with a FULL resync (graceful degradation).
        self.resync_lag = (int(resync_lag) if resync_lag is not None
                           else max(2 * self.max_lag, self.max_lag + 4))
        self.shed_hint_us = int(shed_hint_us)
        self.ft = ft if ft is not None else FTConfig.from_env()
        if self.ft.heartbeat_s <= 0:
            raise ValueError(
                "a cell needs heartbeats (FTConfig.heartbeat_s > 0): its "
                "upstream lease makes a dead cell detected, and the beat "
                "echoes carry the head version its staleness admission "
                "keys on")
        self.serve_cfg = (serve if serve is not None
                          else _psserve.ServeConfig.from_env())
        self.sched = scheduler or Scheduler()
        self.live = LiveFlag()
        self.log = get_logger("cell", rank)
        # Reader-serving state: exactly the slice of ParamServer state
        # the reused dispatcher methods touch.
        self.leases = LeaseRegistry(self.readers, ttl_s=self.ft.lease_ttl_s)
        self._codecs: Dict[int, codec_mod.Codec] = {}
        self._framed: Dict[int, bool] = {}
        self._hb: Dict[int, bool] = {}
        self._readonly: Dict[int, bool] = {}
        self._gen: Dict[int, int] = {r: 0 for r in self.readers}
        self._req_buf: Dict[int, np.ndarray] = {}
        self._hb_buf: Dict[int, np.ndarray] = {}
        self._serve_inflight_bytes = 0
        self._serve_inflight_reads = 0
        self._serve_successor: Optional[int] = None
        self.retired = False
        # The version-counted serving cache (§11.2): ONE encoded frame
        # (the subscription codec's) per installed version, replaced
        # copy-on-write so in-flight zero-copy replies never tear.
        self._frame: Optional[np.ndarray] = None
        self._snap_version = -1  # nothing installed yet
        self._head = -1  # highest committed version heard of
        self._head_fresh = time.monotonic()
        # The last time the diff stream moved this cell: a frame installed
        # or a resync requested (see _stalled).
        self._diff_progress = time.monotonic()
        self._resyncing = False
        self._shedding = False
        self._sub_epoch = self.ft.epoch
        self._sub_seq = 0
        self._hb_seq = 0
        self._hb_last = 0.0
        self._started = False
        # Observability.
        self.metrics = registry_or_local()
        self._spans = get_recorder()
        self._flight = get_flight()
        _m, _r = self.metrics, rank
        self._m_readers = _m.gauge("mpit_ps_readers", rank=_r)
        self._m_served = _m.counter("mpit_ps_params_served_total", rank=_r)
        self._m_busy = _m.counter("mpit_ps_busy_replies_total", rank=_r)
        self._m_stale = _m.counter("mpit_ps_stale_drops_total", rank=_r)
        self._m_hb_seen = _m.counter("mpit_ps_heartbeats_seen_total",
                                     rank=_r)
        self._m_version = _m.gauge("mpit_cell_version", rank=_r)
        self._m_head = _m.gauge("mpit_cell_head", rank=_r)
        self._m_lag = _m.gauge("mpit_cell_lag", rank=_r)
        self._m_full = _m.counter("mpit_cell_diffs_installed_total",
                                  rank=_r, kind="full")
        self._m_delta = _m.counter("mpit_cell_diffs_installed_total",
                                   rank=_r, kind="delta")
        self._m_resyncs = _m.counter("mpit_cell_resyncs_total", rank=_r)
        self._m_sheds = _m.counter("mpit_cell_lag_sheds_total", rank=_r)
        if obs_enabled():
            register_status_provider(f"cell{rank}", self._status_section)

    # -- introspection -------------------------------------------------------

    @property
    def version(self) -> int:
        """The installed (served) snapshot version."""
        return self._snap_version

    @property
    def head(self) -> int:
        """The highest upstream-committed version this cell knows of."""
        return max(self._head, self._snap_version)

    @property
    def lag(self) -> int:
        """Known staleness in committed versions (0 before attach)."""
        if self._snap_version < 0:
            return 0
        return max(self.head - self._snap_version, 0)

    @property
    def diffs_installed(self) -> int:
        return int(self._m_full.value) + int(self._m_delta.value)

    @property
    def resyncs(self) -> int:
        return int(self._m_resyncs.value)

    @property
    def lag_sheds(self) -> int:
        return int(self._m_sheds.value)

    @property
    def params_served(self) -> int:
        return int(self._m_served.value)

    @property
    def busy_replies(self) -> int:
        return int(self._m_busy.value)

    def _status_section(self) -> Dict[str, Any]:
        return {
            "role": "cell",
            "rank": self.rank,
            "upstream": self.upstream,
            "shard": {"offset": self.offset, "size": self.size},
            "codec": self.codec.name,
            "version": self._snap_version,
            "head": self.head,
            "lag": self.lag,
            "max_lag": self.max_lag,
            "resyncing": self._resyncing,
            "shedding": self._shedding,
            "readers": int(self._m_readers.value),
            "busy_replies": int(self._m_busy.value),
            "diffs_installed": self.diffs_installed,
            "resyncs": self.resyncs,
            "retired": self.retired,
            "retiring_to": self._serve_successor,
            "serve_inflight_bytes": self._serve_inflight_bytes,
        }

    # -- §11 hooks into the reused dispatcher --------------------------------

    def _read_gate(self) -> "Optional[Tuple[int, int]]":
        """Staleness-bounded admission (§11.4): grant only while the
        known lag fits ``max_lag`` and a frame is installed; otherwise
        BUSY-with-hint.  The first rejection of an episode dumps a
        ``cell_lag_shed`` postmortem carrying the version window."""
        from mpit_tpu_torch.shardctl.wire import BUSY

        gated = (self._frame is None or self._resyncing
                 or self.lag > self.max_lag or self._head_stale())
        if not gated:
            if self._shedding:
                self._shedding = False
                self.log.info(
                    "lag recovered (version %d, head %d): admitting "
                    "reads again", self._snap_version, self.head)
            return None
        if not self._shedding:
            self._shedding = True
            self._m_sheds.inc()
            self.log.warning(
                "shedding reads: version %d vs head %d exceeds "
                "max_lag %d%s", self._snap_version, self.head,
                self.max_lag,
                " (resyncing)" if self._resyncing else "")
            self._flight.record("cell_lag_shed", rank=self.rank,
                                version=self._snap_version, head=self.head)
            self._flight.dump(
                "cell_lag_shed",
                window={"version": self._snap_version, "head": self.head,
                        "lag": self.lag, "max_lag": self.max_lag},
                upstream=self.upstream)
        return (BUSY, self.shed_hint_us)

    def _serve_ok_header(self, epoch: int, seq: int) -> np.ndarray:
        """The 5-word OK header: [epoch, seq, OK, version, head] — the
        extra head word is what lets a reader compute its observed lag
        (§11.5).  Readers on a plain server keep the 4-word form."""
        from mpit_tpu_torch.shardctl.wire import OK

        return np.asarray(
            [epoch, seq, OK, self._snap_version, self.head], np.int64)

    def _snapshot_wire(self, codec: "codec_mod.Codec") -> np.ndarray:
        """The serving cache read the dispatcher's grant path calls:
        the installed frame IS the upstream's encoded frame for this
        version, bit-for-bit — no copy, no re-encode (the §11 bitwise
        guarantee)."""
        if codec.name != self.codec.name:
            raise RuntimeError(
                f"cell {self.rank} serves codec {self.codec.name!r} but "
                f"a reader negotiated {codec.name!r} — _negotiate must "
                "gate this")
        if self._frame is None:
            raise RuntimeError("no snapshot installed yet (gate breach)")
        return self._frame

    def _head_stale(self) -> bool:
        """True when the head estimate itself went stale: no diff or
        beat echo for several heartbeat intervals means the known lag
        is a lower bound on the truth — stop trusting it (§11.4)."""
        ttl = max(4.0 * self.ft.heartbeat_s, 1.0)
        return (time.monotonic() - self._head_fresh) > ttl

    # -- reader attach (the dispatcher's negotiate/alloc callbacks) ----------

    def _negotiate(self, crank: int, payload: bytes) -> "codec_mod.Codec":
        """Reader INIT against this cell: v3 READ-ONLY announcements
        only, shard must match the mirrored shard, and the codec must
        equal the subscription codec — the cell holds that codec's
        encoded frames and serving any other would mean re-encoding
        decoded bytes, which breaks the bitwise guarantee."""
        raw = np.frombuffer(payload, dtype=np.int64)
        if raw.size != 5:
            raise ValueError(
                f"rank {crank} announced a {len(payload)}-byte INIT to a "
                "cell — cells serve INIT v3 READ-ONLY readers only")
        offset, size, wire_id, epoch, flags = (int(x) for x in raw)
        if not (flags & FLAG_READONLY) or not (flags & FLAG_FRAMED):
            raise ValueError(
                f"rank {crank} announced without FLAG_READONLY | "
                "FLAG_FRAMED — a cell serves read-only traffic")
        if flags & FLAG_SUBSCRIBE:
            raise ValueError(
                f"rank {crank} announced FLAG_SUBSCRIBE to a cell — "
                "cells subscribe to training servers, not to cells")
        if crank not in self._reader_set:
            raise ValueError(
                f"rank {crank} is not in this cell's reader_ranks "
                f"{sorted(self._reader_set)}")
        if (offset, size) != (self.offset, self.size):
            raise ValueError(
                f"reader {crank} announced shard ({offset},{size}) but "
                f"cell {self.rank} mirrors ({self.offset},{self.size})")
        codec = codec_mod.by_wire_id(wire_id)
        if codec.name != self.codec.name:
            raise ValueError(
                f"reader {crank} negotiated codec {codec.name!r} but "
                f"cell {self.rank} subscribed with {self.codec.name!r} — "
                "a cell serves its subscription codec only (§11.1)")
        self._readonly[crank] = True
        self._framed[crank] = True
        self._hb[crank] = bool(flags & FLAG_HEARTBEAT)
        self.leases.arm(crank, epoch, heartbeats=self._hb[crank])
        return codec

    def _alloc_client(self, crank: int, codec: "codec_mod.Codec") -> None:
        self._codecs[crank] = codec
        self._req_buf[crank] = np.zeros(2, np.int64)
        if self._hb.get(crank):
            self._hb_buf[crank] = np.zeros(2, np.int64)

    # -- the subscription (upstream half) ------------------------------------

    def _note_head(self, head: int) -> None:
        if head > self._head:
            self._head = head
        self._head_fresh = time.monotonic()
        self._m_head.set(self.head)
        self._m_lag.set(self.lag)

    def _install(self, frame: np.ndarray, version: int) -> None:
        self._diff_progress = time.monotonic()
        self._frame = frame
        self._snap_version = version
        self._m_version.set(version)
        self._m_lag.set(self.lag)

    def _request_resync(self, why: str) -> None:
        """The diff chain broke (gap) or fell past the resync horizon:
        ask for a FULL frame at head and ignore deltas meanwhile."""
        if self._resyncing:
            return
        self._resyncing = True
        self._diff_progress = time.monotonic()
        self._m_resyncs.inc()
        self._sub_seq += 1
        self.log.warning("resync (%s): have version %d, head %d",
                         why, self._snap_version, self.head)
        self.sched.spawn(
            self._send_upstream(
                _cellwire.diff_req(self._sub_epoch, self._sub_seq,
                                   self._snap_version),
                tags.DIFF_REQ),
            name="diff_req")

    def _send_upstream(self, payload: np.ndarray, tag: int):
        try:
            yield from aio_send(self.transport, payload, self.upstream,
                                tag, live=self.live,
                                deadline=deadline_at(self.ft.deadline_s))
        except (DeadlineExceeded, RuntimeError) as exc:
            # Upstream unreachable: the beat loop owns re-subscription;
            # this message is re-issued by the next gap/beat cycle.
            self.log.debug("upstream send (tag %d) failed: %r", tag, exc)

    def _subscriber(self):
        """Perpetual service: receive DIFF frames and install them.
        FULL frames install directly (never backwards); DELTA frames
        install only when they extend the installed version exactly —
        anything else is a broken chain and triggers a resync request.
        Duplicated frames (fault injection, resend races) are skipped
        by the same arithmetic, never double-applied."""
        while self.live.on:
            try:
                got = yield from aio_recv(self.transport, self.upstream,
                                          tags.DIFF, live=self.live)
            except RuntimeError as exc:
                # Upstream connection torn mid-run: keep serving inside
                # the staleness envelope; the beat loop re-subscribes
                # when the upstream returns.
                self.log.warning("diff stream broken: %r", exc)
                if not (yield from aio_sleep(self.ft.heartbeat_s,
                                             live=self.live)):
                    return
                continue
            if got is None:
                return
            kind, from_v, to_v, head, body = _cellwire.parse_diff(got)
            self._apply_diff(kind, from_v, to_v, head, body)

    def _apply_diff(self, kind: int, from_v: int, to_v: int, head: int,
                    body: np.ndarray) -> None:
        """Install one assembled FULL/DELTA frame — the §11.2 chain
        arithmetic: FULL never goes backwards, DELTA only extends the
        installed version exactly, anything else resyncs."""
        self._note_head(head)
        if kind == _cellwire.DIFF_FULL:
            if to_v < self._snap_version:
                return  # stale duplicate: versions never go back
            self._install(body, to_v)
            self._m_full.inc()
            self._resyncing = False
            self.log.info("installed FULL frame at version %d "
                          "(head %d)", to_v, head)
            return
        # DELTA
        if self._resyncing:
            return  # waiting for the FULL answer
        if self._frame is None or from_v != self._snap_version:
            if to_v <= self._snap_version:
                return  # duplicate of an already-installed step
            self._request_resync(
                f"gap: delta {from_v}->{to_v} against installed "
                f"{self._snap_version}")
            return
        if self.lag > self.resync_lag:
            # Deep lag: replaying the backlog one delta at a time
            # only chases a moving head — jump to it instead.
            self._request_resync(f"lag {self.lag} > resync_lag "
                                 f"{self.resync_lag}")
            return
        self._install(_cellwire.apply_delta(self._frame, body), to_v)
        self._m_delta.inc()

    def _stalled(self) -> bool:
        """True when the cell cannot serve and the diff stream has not
        moved it for as long as the head estimate stays trusted: no frame
        yet, a resync whose FULL answer never came, or a lag past the bound
        with no frame arriving to close it.  The JAX cell waits here for a
        next commit, which may never come (a dropped resync FULL at the
        end of a training run leaves it shedding for good); the port's
        re-requests, and the upstream answers any DIFF_REQ with a FULL at
        its head."""
        blocked = (self._frame is None or self._resyncing
                   or self.lag > self.max_lag)
        ttl = max(4.0 * self.ft.heartbeat_s, 1.0)
        return blocked and (time.monotonic() - self._diff_progress) > ttl

    def _beat_service(self):
        """Subscriber heartbeats: renew the upstream lease, drain the
        [epoch, seq, head] echoes that keep the staleness bound honest,
        and re-announce the subscription when the upstream came back
        from a restart (RuntimeError on the beat send)."""
        hb = self.ft.heartbeat_s
        echo_buf = np.zeros(_cellwire.HEAD_ECHO_WORDS, np.int64)
        while self.live.on:
            if not (yield from aio_sleep(hb, live=self.live)):
                return
            self._hb_seq += 1
            try:
                yield from aio_send(
                    self.transport, header_frame(self._sub_epoch,
                                                 self._hb_seq),
                    self.upstream, tags.HEARTBEAT, live=self.live,
                    deadline=deadline_at(4 * hb))
            except DeadlineExceeded:
                continue  # best-effort; next beat tries again
            except RuntimeError:
                # Upstream process died and came back (or is gone): try
                # a fresh SUBSCRIBE announce — its cell dispatcher
                # accepts re-attach INITs any time.
                yield from self._resubscribe()
                continue
            try:
                while self.transport.iprobe(self.upstream,
                                            tags.HEARTBEAT_ECHO):
                    got = yield from self._recv_echo(echo_buf)
                    if got is None:
                        break
                    self._note_head(int(echo_buf[2]))
            except RuntimeError:
                continue
            if self._stalled():
                self._resyncing = False  # the request or its answer was lost
                self._request_resync(
                    f"stalled at version {self._snap_version}, head {self.head}")

    def _recv_echo(self, buf: np.ndarray):
        handle = self.transport.irecv(self.upstream, tags.HEARTBEAT_ECHO,
                                      out=buf)
        while not self.transport.test(handle):
            yield EXEC
        return self.transport.payload(handle)

    def _resubscribe(self):
        """Announce the SUBSCRIBE posture (again).  The upstream resets
        the per-cell stream to a FULL frame on every (re)attach."""
        self._sub_epoch += 1
        self._resyncing = True
        cinfo = self._announce()
        try:
            yield from aio_send(self.transport, cinfo, self.upstream,
                                tags.INIT, live=self.live,
                                deadline=deadline_at(self.ft.deadline_s))
            self.log.info("re-subscribed to upstream %d (epoch %d)",
                          self.upstream, self._sub_epoch)
        except (DeadlineExceeded, RuntimeError) as exc:
            self.log.debug("re-subscribe failed (retrying on next "
                           "beat): %r", exc)

    def _sub_flags(self) -> int:
        return FLAG_FRAMED | FLAG_READONLY | FLAG_SUBSCRIBE | FLAG_HEARTBEAT

    def _announce(self) -> np.ndarray:
        """The subscription INIT: v3, byte-identical to the JAX cell's
        (the chunk-framed v5 form is a later slice)."""
        return init_v3(self.offset, self.size, self.codec.wire_id,
                       self._sub_epoch, self._sub_flags())

    # -- lifecycle -----------------------------------------------------------

    def shutdown(self) -> None:
        """Stop serving (thread-safe): services drain, the upstream
        subscription is STOPped, and :meth:`start` returns."""
        self.live.stop()

    def start(self) -> None:
        """Run the cell to completion: subscribe, serve, stop when
        every expected reader is terminal (or on :meth:`shutdown`)."""
        cinfo = self._announce()
        self.sched.spawn(
            aio_send(self.transport, cinfo, self.upstream, tags.INIT,
                     live=self.live,
                     deadline=deadline_at(self.ft.deadline_s)),
            name="subscribe")
        self.sched.wait()
        self._started = True
        self.sched.spawn(self._subscriber(), name="subscriber")
        self.sched.spawn(self._beat_service(), name="beat_service")
        self.sched.spawn(self._reader_dispatcher(),
                         name="reader_dispatcher")
        self.sched.wait()
        # Goodbye upstream: a clean STOP, so the training gang's stop
        # protocol counts this cell out instead of waiting on a lease.
        stop_live = LiveFlag()
        final = Scheduler()
        final.spawn(
            aio_send(self.transport, tags.EMPTY, self.upstream, tags.STOP,
                     live=stop_live, deadline=deadline_at(
                         self.ft.deadline_s or 10.0)),
            name="send_stop")
        try:
            final.wait()
        except (DeadlineExceeded, RuntimeError):
            pass  # upstream already gone — nothing to say goodbye to
        self.log.info(
            "cell stopped: version %d, head %d, served %d, busy %d, "
            "diffs %d (resyncs %d, sheds %d)", self._snap_version,
            self.head, self.params_served, self.busy_replies,
            self.diffs_installed, self.resyncs, self.lag_sheds)
