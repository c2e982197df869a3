"""TcpTransport — cross-host transport for the PS protocol (DCN analog).

The shm transport covers the reference's one-host ``mpirun -np N`` shape;
this covers its multi-node hostfile deployments (reference
BiCNN/hostfiles, README.md:57-61) for the *host-mediated* asynchronous PS
path: the transport for the ParamServer/ParamClient role topology.

The port of the JAX package's ``mpit_tpu/comm/tcp.py``, host code copied
as it is: the 24-byte frame header, the 32-byte handshake and the mesh
digest are the same bytes, so port ranks and JAX ranks form one TCP mesh.
Elastic dialing (``dial_peers``) and reconnect mode are kept as the JAX
package has them; the port's launcher arms them for a supervised gang
(``--supervise``: every rank in reconnect mode, a restarted worker
dialing only its servers), while ``--elastic`` stays refused until shard
control.

Same contract and semantics as
:class:`mpit_tpu_torch.comm.shm.ShmTransport`:
nonblocking (rank, tag)-addressed messaging, FIFO per channel, exact-size
receives, buffer ownership until ``test`` is True, cancel-on-shutdown.

Wire format per message: 24-byte header (tag, size, seq — int64 little
endian) + payload.  Connections form a full mesh at construction: every
rank listens on its ``host:port`` from the address book; rank i dials
every rank j < i and accepts from every j > i (each side identifies
itself with a 32-byte handshake: rank, instance nonce, the highest
sequence it has received from the other side, and the address-book
digest).

**I/O model: one event-loop thread per rank**, multiplexing every peer
through an epoll selector (``selectors.DefaultSelector``) — thread count
is O(1) in the peer count, which is what lets one server rank hold
hundreds of reader connections (the serving tier, docs/PROTOCOL.md §8).
Per peer the loop runs a read state machine (24-byte header, then the
payload assembled incrementally into its own buffer — never a
concatenating byte-string accumulator) and a write state machine that
drains the peer's outbox with scatter-gather ``sendmsg`` (header +
payload to the kernel from their own buffers, partial writes resumed on
the next writable event).  Post-construction accepts, redials and
handshakes are nonblocking state machines inside the same loop; the
only blocking socket work is the construction-time rendezvous, which
runs on the constructing thread before the loop starts.

Loop-callback discipline (machine-checked: mtlint MT-P203): every
selector-dispatch callback is named ``_el_*`` and may only touch sockets
through the ``_nb_*`` nonblocking helpers — a blocking call inside a
callback would stall every peer's I/O at once.

The outbox is zero-copy — queued entries view the caller's buffer
(owned by the transport until ``test`` is True), so a deep backlog costs
O(1) transport-owned memory per message, not a payload copy.
"""

from __future__ import annotations

import errno
import selectors
import socket
import struct
import threading
import time
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mpit_tpu_torch.comm.transport import (
    Handle,
    Transport,
    as_bytes_view,
    as_writable_view,
)
from mpit_tpu_torch.obs import metrics as _obs
from mpit_tpu_torch.utils.logging import get_logger

_HDR = struct.Struct("<qqq")  # tag, size, seq
# rank, instance nonce, last-seq-from-you, address-book digest (the
# digest authenticates the MESH: a stale redial from a dead transport
# instance, or any foreign client, that reaches a reassigned port must
# not be installed as a peer).
_RANK_HDR = struct.Struct("<qqqq")
_EMPTY = memoryview(b"")
# Reserved wire tag: an orderly close() announces itself so the peer's
# read state machine can distinguish graceful shutdown (old
# silent-cancel semantics) from a crash (fail-loud semantics).  User
# tags are non-negative (ps/tags.py, collectives' 2^16+ range), so the
# sentinel can't collide.
_GOODBYE_TAG = -(1 << 62)
# Scatter-gather frame writes (one syscall for header+payload, zero
# concatenation): POSIX-only; Windows sockets lack sendmsg.
_HAS_SENDMSG = hasattr(socket.socket, "sendmsg")
# Per-readable/writable-event byte budgets: a firehose peer must not
# starve its siblings inside one dispatch (level-triggered epoll
# re-reports whatever is left).
_RX_BUDGET = 1 << 20
_TX_BUDGET = 1 << 22
# Nonblocking-connect handshake bounds.
_HS_TIMEOUT_S = 2.0
_DIAL_ATTEMPT_S = 5.0


class MeshMismatchError(ConnectionError):
    """The peer answered the handshake with a different address-book /
    reconnect-mode digest: it belongs to another mesh (or the two sides
    disagree on reconnect mode, which would deadlock ack-based sends).
    Raised immediately — never retried."""
# Reserved wire tag for delivery acknowledgements (reconnect mode): the
# header's seq field carries the highest data sequence received; no
# payload.  Acks are neither retained nor themselves acked — a lost ack
# is superseded by the next one or by the reconnect handshake.
_ACK_TAG = _GOODBYE_TAG + 1


def allocate_local_addresses(nranks: int) -> Tuple[List[str], List[socket.socket]]:
    """Pre-bound localhost listeners with OS-assigned ports, for tests and
    same-host runs: returns (addresses, listeners); pass ``listeners[r]``
    to rank r's transport so no port is lost to a rebind race."""
    addrs, socks = [], []
    for _ in range(nranks):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        s.listen(max(nranks, 64))  # serving-tier gangs burst-dial
        addrs.append(f"127.0.0.1:{s.getsockname()[1]}")
        socks.append(s)
    return addrs, socks


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Blocking exact-size read — construction-time handshakes only
    (never called from the event loop)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            return None  # peer closed
        got += r
    return bytes(buf)


class _Channel:
    __slots__ = ("msgs", "pending")

    def __init__(self):
        self.msgs: deque = deque()      # fully-assembled payloads (bytes)
        self.pending: deque = deque()   # posted recv handles, FIFO


class _Conn:
    """One live peer connection's loop-side state: the read state
    machine's partial header/payload and the write state machine's
    partial frame.  A fresh generation gets a fresh ``_Conn``, so a
    reconnect can never resume mid-frame state from a dead socket."""

    __slots__ = ("peer", "sock", "gen", "graceful", "want_w",
                 "rx_hdr", "rx_hmv", "rx_got", "rx_tag", "rx_seq",
                 "rx_body", "rx_bgot", "tx_entry", "tx_bufs")

    def __init__(self, peer: int, sock: socket.socket, gen: int):
        self.peer = peer
        self.sock = sock
        self.gen = gen
        self.graceful = False   # peer announced an orderly close
        self.want_w = False
        self.rx_hdr = bytearray(_HDR.size)
        self.rx_hmv = memoryview(self.rx_hdr)
        self.rx_got = 0
        self.rx_tag = 0
        self.rx_seq = 0
        self.rx_body: Optional[bytearray] = None
        self.rx_bgot = 0
        self.tx_entry: Optional[Any] = None
        self.tx_bufs: Optional[List[memoryview]] = None


class _Hs:
    """An accepted socket mid-handshake (nonblocking): read the peer's
    32-byte hello, write the 32-byte reply, install."""

    __slots__ = ("sock", "deadline", "state", "inb", "igot", "out",
                 "peer", "pnonce", "peer_last")

    def __init__(self, sock: socket.socket, deadline: float):
        self.sock = sock
        self.deadline = deadline
        self.state = "hello"
        self.inb = bytearray(_RANK_HDR.size)
        self.igot = 0
        self.out: List[memoryview] = []
        self.peer = -1
        self.pnonce = 0
        self.peer_last = 0


class _Dial:
    """A nonblocking redial state machine (reconnect mode): connect_ex →
    write hello → read reply → install, with capped backoff between
    attempts, all inside the event loop (no per-fault dialer thread)."""

    __slots__ = ("peer", "gen", "deadline", "state", "next_at", "backoff",
                 "attempt_deadline", "sock", "out", "inb", "igot")

    def __init__(self, peer: int, gen: int, deadline: float, now: float):
        self.peer = peer
        self.gen = gen
        self.deadline = deadline
        self.state = "wait"
        self.next_at = now
        self.backoff = 0.05
        self.attempt_deadline = 0.0
        self.sock: Optional[socket.socket] = None
        self.out: List[memoryview] = []
        self.inb = bytearray(_RANK_HDR.size)
        self.igot = 0


class TcpTransport(Transport):
    """See module docstring.  ``reconnect`` (seconds, default from
    ``MPIT_TCP_RECONNECT_S``, 0 = off) adds bounded fault recovery: on a
    torn connection the dialing side (higher rank) redials with backoff
    and the accepting side's persistent accept service re-handshakes,
    the write state machine resends every frame not yet fully written
    (frames carry sequence numbers; the receiver drops duplicates), and
    a fresh process re-binding a dead rank's address rejoins the mesh
    (the handshake nonce tells a resumed connection from a restarted
    peer, which resets the dedup horizon).  Only after the window
    expires does the transport fall back to the fail-loud contract.

    ``listen=False`` builds a pure-dialer endpoint (no listener socket
    at all): the serving tier's reader clients dial their servers and
    are never dialed, so hundreds of them don't each burn a listening
    port.  Requires ``dial_peers`` (nobody can connect *in*)."""

    def __init__(
        self,
        rank: int,
        nranks: int,
        addresses: Sequence[str],
        *,
        listener: Optional[socket.socket] = None,
        connect_timeout: float = 60.0,
        reconnect: Optional[float] = None,
        dial_peers: Optional[Sequence[int]] = None,
        listen: bool = True,
    ):
        import os as _os
        import secrets

        if len(addresses) != nranks:
            raise ValueError(f"need {nranks} addresses, got {len(addresses)}")
        self.rank = rank
        self.nranks = nranks
        self.addresses = list(addresses)
        self.reconnect = (
            float(_os.environ.get("MPIT_TCP_RECONNECT_S", "0"))
            if reconnect is None else float(reconnect)
        )
        self._log = get_logger("tcp", rank)
        self._nonce = secrets.randbits(62)
        import hashlib

        # The digest covers the address book AND the reconnect mode: a
        # reconnect>0 sender retains frames until acked, so a mixed-mode
        # pairing (one side acking, one not) would deadlock sends — make
        # it a connect-time refusal instead.
        self._book_hash = int.from_bytes(
            hashlib.blake2b(
                (",".join(self.addresses)
                 + f"|reconnect={'on' if self.reconnect > 0 else 'off'}"
                 ).encode(), digest_size=7).digest(), "little")
        self._lock = threading.Lock()
        self._channels: Dict[Tuple[int, int], _Channel] = defaultdict(_Channel)
        self._peers: Dict[int, socket.socket] = {}
        self._gen: Dict[int, int] = {r: 0 for r in range(nranks)}
        self._peer_nonce: Dict[int, int] = {}
        self._last_seq: Dict[int, int] = {r: 0 for r in range(nranks)}
        self._send_seq: Dict[int, int] = {r: 0 for r in range(nranks)}
        self._outboxes: Dict[int, deque] = {r: deque() for r in range(nranks)}
        # Reconnect mode: frames sent to the kernel but not yet
        # acknowledged by the peer (written != delivered) — resent after
        # a reconnect, released (handle.done) by acks.
        self._unacked: Dict[int, deque] = {r: deque() for r in range(nranks)}
        self._pending_ack: Dict[int, Any] = {}
        # Highest seq each peer has acked — consulted when retaining a
        # just-sent frame: the ack can RACE the retention (arrive between
        # the write completing and the settle), and a frame retained
        # after its own ack would wait forever.
        self._acked_high: Dict[int, int] = {r: 0 for r in range(nranks)}
        self._out_cv: Dict[int, threading.Condition] = {
            r: threading.Condition() for r in range(nranks)
        }
        # Peers whose connection has been declared dead: new isends are
        # cancelled immediately instead of queueing into a box nobody
        # will ever drain.
        self._dead_peers: set = set()
        # Peers whose inbound side has died mid-run: pending receives
        # with no message to match fail loudly (raise-once from test)
        # instead of polling forever on a connection that can never
        # deliver.
        self._dead_readers: set = set()
        self._threads: List[threading.Thread] = []
        self._disconnect_seen: set = set()
        self._closed = False
        # close() handshake: the loop owns connection state, so the loop
        # decides when the goodbye flush is done (a caller-side guess
        # would race the install queue) and signals the event.
        self._closing = False
        self._flushed = threading.Event()
        # -- event-loop plumbing (loop-thread-owned unless noted) ------------
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._conns: Dict[int, _Conn] = {}       # loop-owned
        self._installq: deque = deque()          # any thread appends; loop drains
        self._dirty: set = set()                 # peers with fresh tx (any thread)
        self._watchdogs: Dict[int, Tuple[int, float]] = {}  # loop-owned
        self._dials: Dict[int, _Dial] = {}       # loop-owned
        self._hss: set = set()                   # loop-owned
        # Per-peer traffic counters (obs/metrics): indexed by rank so
        # the hot paths never hash a label dict; the shared null
        # instrument fills every slot when obs is disabled.
        _reg = _obs.get_registry()
        self._m_tx_msgs = [_reg.counter("mpit_tcp_tx_messages_total",
                                        rank=rank, peer=r)
                           for r in range(nranks)]
        self._m_tx_bytes = [_reg.counter("mpit_tcp_tx_bytes_total",
                                         rank=rank, peer=r)
                            for r in range(nranks)]
        self._m_rx_msgs = [_reg.counter("mpit_tcp_rx_messages_total",
                                        rank=rank, peer=r)
                           for r in range(nranks)]
        self._m_rx_bytes = [_reg.counter("mpit_tcp_rx_bytes_total",
                                         rank=rank, peer=r)
                            for r in range(nranks)]
        # Send-queue depth (frames queued to each peer's write state
        # machine) — the live queueing-pressure signal `mpit top`
        # renders: a peer that cannot drain shows a growing depth long
        # before ops start missing deadlines.
        self._m_sendq = [_reg.gauge("mpit_tcp_send_queue_depth",
                                    rank=rank, peer=r)
                         for r in range(nranks)]
        # Live established connections + per-wakeup dispatch time of the
        # one I/O thread: the scale-out health pair (`mpit top`'s conns
        # column; a loop lag histogram drifting up means one rank's
        # event loop is saturating).
        self._m_conns = _reg.gauge("mpit_tcp_connections", rank=rank)
        self._m_lag = _reg.timer("mpit_tcp_event_loop_lag_seconds",
                                 rank=rank)

        if not listen:
            if dial_peers is None:
                raise ValueError(
                    "listen=False builds a pure-dialer endpoint; pass "
                    "dial_peers so it knows who to reach (nobody can "
                    "connect in)")
            self._listener: Optional[socket.socket] = None
        else:
            host, _, port = addresses[rank].rpartition(":")
            if listener is None:
                listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                bind_deadline = time.monotonic() + connect_timeout
                while True:
                    try:
                        listener.bind((host or "0.0.0.0", int(port)))
                        break
                    except OSError as e:
                        # A replacement process rebinding a crashed
                        # rank's address can race the old listener's
                        # teardown — retry EADDRINUSE within the window;
                        # anything else (bad host, privileged port) is a
                        # misconfiguration and fails immediately.
                        if (e.errno != errno.EADDRINUSE
                                or time.monotonic() >= bind_deadline):
                            raise
                        time.sleep(0.1)
                listener.listen(max(nranks, 64))
            self._listener = listener

        # Dial lower ranks, accept higher ranks (deadlock-free full mesh).
        # ``dial_peers`` (FT rejoin / serving-tier attach) restricts
        # construction to the connections this endpoint actually needs: a
        # worker restarted mid-run must reach its *servers*, but a
        # sibling worker may have finished and exited — demanding its
        # listener would turn normal completion into a rejoin failure.
        # Skipped lower ranks are marked dead (sends fail loudly, not
        # silently queue); skipped higher ranks arrive later through the
        # loop's persistent accept service, which is why the restriction
        # requires reconnect mode.
        deadline = time.monotonic() + connect_timeout
        if dial_peers is None:
            to_dial = list(range(rank))
            n_accept = nranks - rank - 1
        else:
            if self.reconnect <= 0:
                raise ValueError(
                    "dial_peers needs reconnect mode (MPIT_TCP_RECONNECT_S"
                    " > 0): undialed peers can only join via the "
                    "persistent accept service"
                )
            to_dial = sorted({int(p) for p in dial_peers} & set(range(rank)))
            self._dead_peers.update(set(range(rank)) - set(to_dial))
            n_accept = 0
        for peer in to_dial:
            conn, pnonce, peer_last = self._dial(addresses[peer], deadline,
                                                 peer)
            self._install_socket(peer, conn, pnonce, peer_last)
        for _ in range(n_accept):
            conn, _addr = self._accept(deadline)
            conn.settimeout(None)  # construction handshakes block
            got = self._handshake_accept(conn)
            if got is None:
                raise ConnectionError("peer closed during handshake")
            self._install_socket(got[0], conn, got[1], got[2])
        # The one I/O thread: every socket from here on is driven by the
        # selector loop.  (Role-named for thread dumps and tests.)
        t = threading.Thread(target=self._io_loop, daemon=True,
                             name=f"_io_loop-{rank}")
        self._threads.append(t)
        t.start()

    # -- construction-time (blocking) connection plumbing --------------------

    def _dial(self, address: str, deadline: float,
              peer_rank: int) -> Tuple[socket.socket, int, int]:
        """Returns (socket, peer nonce, peer's last-received seq from us).
        Construction-thread only; the loop's redial path is the
        nonblocking :class:`_Dial` machine."""
        host, _, port = address.rpartition(":")
        last_err: Optional[Exception] = None
        while time.monotonic() < deadline and not self._closed:
            try:
                conn = socket.create_connection((host, int(port)), timeout=5.0)
                if conn.getsockname() == conn.getpeername():
                    # TCP simultaneous-connect to our own ephemeral
                    # port: the peer's listener is not up yet and the
                    # kernel handed us a loopback self-connection —
                    # worse than useless, it also squats the very port
                    # the peer is trying to bind.  Close (freeing the
                    # port) and retry like any not-up-yet peer.
                    conn.close()
                    raise ConnectionRefusedError(
                        errno.ECONNREFUSED,
                        "self-connect: peer listener not up yet")
                conn.settimeout(None)
                with self._lock:
                    my_last = self._last_seq[peer_rank]
                conn.sendall(_RANK_HDR.pack(self.rank, self._nonce, my_last,
                                            self._book_hash))
                reply = _recv_exact(conn, _RANK_HDR.size)
                if reply is None:
                    raise ConnectionError("peer closed during handshake")
                _prank, pnonce, peer_last, book = _RANK_HDR.unpack(reply)
                if book != self._book_hash:
                    conn.close()
                    raise MeshMismatchError(
                        "peer handshake digest mismatch: different mesh "
                        "or mismatched reconnect mode"
                    )
                return conn, int(pnonce), int(peer_last)
            except MeshMismatchError:
                raise  # misconfiguration — retrying cannot fix it
            except OSError as e:  # peer not up yet
                last_err = e
                time.sleep(0.05)
        raise ConnectionError(f"could not reach {address}: {last_err!r}")

    def _handshake_accept(
        self, conn: socket.socket
    ) -> Optional[Tuple[int, int, int]]:
        """Returns (peer rank, peer nonce, peer's last seq from us).
        Construction-thread only (blocking); the loop accepts through
        the nonblocking :class:`_Hs` machine."""
        peer_hdr = _recv_exact(conn, _RANK_HDR.size)
        if peer_hdr is None:
            return None
        peer, pnonce, peer_last, book = _RANK_HDR.unpack(peer_hdr)
        if not 0 <= peer < self.nranks or book != self._book_hash:
            return None
        with self._lock:
            my_last = self._last_seq[int(peer)]
        conn.sendall(_RANK_HDR.pack(self.rank, self._nonce, my_last,
                                    self._book_hash))
        return int(peer), int(pnonce), int(peer_last)

    def _accept(self, deadline: float) -> Tuple[socket.socket, Any]:
        self._listener.settimeout(max(deadline - time.monotonic(), 0.1))
        try:
            return self._listener.accept()
        except socket.timeout:
            raise ConnectionError("timed out waiting for peer connections")

    def _install_socket(self, peer: int, conn: socket.socket,
                        pnonce: Optional[int], peer_last: int,
                        expect_gen: Optional[int] = None) -> bool:
        """Adopt ``conn`` as the live socket for ``peer`` (initial setup
        and every reconnect), revive the peer's fail-loud state, settle
        the unacked window against the peer's reported horizon, and hand
        the socket to the event loop under a fresh generation.  With
        ``expect_gen`` (a redial) the install is refused when the
        generation moved on (another install won, or the watchdog
        poisoned it)."""
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        cv = self._out_cv[peer]
        with self._lock:
            if self._closed or (expect_gen is not None
                                and self._gen[peer] != expect_gen):
                conn.close()
                return False
            nonce_reset = (pnonce is not None
                           and self._peer_nonce.get(peer) is not None
                           and self._peer_nonce.get(peer) != pnonce)
            if pnonce is not None and self._peer_nonce.get(peer) != pnonce:
                # A RESTARTED peer (fresh process, fresh sequence space),
                # not a resumed connection: reset the dedup horizon.
                self._peer_nonce[peer] = pnonce
                self._last_seq[peer] = 0
            self._peers[peer] = conn
            self._gen[peer] += 1
            gen = self._gen[peer]
            self._dead_readers.discard(peer)
        done_handles = []
        with cv:
            if nonce_reset:
                # Acks already queued for the DEAD instance carry
                # horizons from its sequence space; delivered to the
                # replacement they would release (and un-retain) its
                # entire early window.  Purge them.
                kept = [e for e in self._outboxes[peer]
                        if e[0].tag != _ACK_TAG]
                self._outboxes[peer].clear()
                self._outboxes[peer].extend(kept)
                self._pending_ack[peer] = None
            # Settle the unacked window: frames the peer already holds
            # (seq <= its reported horizon) are delivered; the rest go
            # back to the FRONT of the outbox, in order, for resend.
            ua = self._unacked[peer]
            resend = []
            while ua:
                entry = ua.popleft()
                if entry[3] is not None and entry[3] <= peer_last:
                    done_handles.append(entry[0])
                else:
                    resend.append(entry)
            self._outboxes[peer].extendleft(reversed(resend))
            self._dead_peers.discard(peer)
            cv.notify_all()
        for h in done_handles:
            h.done = True
            h.buf = None
        conn.setblocking(False)
        self._installq.append((peer, _Conn(peer, conn, gen)))
        self._wake()
        return True

    def _current_gen(self, peer: int) -> int:
        with self._lock:
            return self._gen[peer]

    # -- event loop ----------------------------------------------------------

    def _wake(self) -> None:
        """Nudge the loop out of select (any thread; lossy by design —
        a full pipe means a wakeup is already pending)."""
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, InterruptedError, OSError):
            pass

    def _mark_dirty(self, peer: int) -> None:
        self._dirty.add(peer)
        self._wake()

    def _io_loop(self) -> None:
        sel = self._sel
        sel.register(self._wake_r, selectors.EVENT_READ, ("wake", None))
        if self._listener is not None and self.reconnect > 0:
            # Persistent accept service (reconnect mode): any peer —
            # resumed socket, restarted process, late-attaching reader —
            # can dial in and (re)handshake at any time.  (A transport
            # torn down before the loop even starts — tests simulating a
            # hard death — may have closed the listener already.)
            try:
                self._listener.setblocking(False)
                sel.register(self._listener, selectors.EVENT_READ,
                             ("accept", None))
            except (OSError, ValueError, KeyError):
                pass
        try:
            while True:
                self._drain_control()
                if self._closed:
                    return
                events = sel.select(self._timer_timeout())
                if events:
                    with self._m_lag:
                        for key, mask in events:
                            kind, obj = key.data
                            if kind == "wake":
                                self._el_wake()
                            elif kind == "accept":
                                self._el_accept()
                            elif kind == "hs":
                                self._el_hs_event(obj)
                            elif kind == "dial":
                                self._el_dial_event(obj)
                            elif kind == "conn":
                                if mask & selectors.EVENT_READ:
                                    self._el_conn_readable(obj)
                                if (mask & selectors.EVENT_WRITE
                                        and self._conns.get(obj.peer) is obj):
                                    self._el_conn_writable(obj)
                self._run_timers()
                if self._closing and not self._flushed.is_set():
                    # Orderly-shutdown flush: done when no peer the loop
                    # can still reach has queued frames left.
                    reachable = set(self._conns) | {
                        p for p, _c in self._installq}
                    if not any(self._outboxes[p] for p in reachable
                               if p != self.rank):
                        self._flushed.set()
        except Exception:  # pragma: no cover - defensive: loop must not die silently
            if not self._closed:
                self._log.exception("event loop died; transport is wedged")
        finally:
            pass

    def _timer_timeout(self) -> float:
        deadline = time.monotonic() + 0.5
        for hs in self._hss:
            deadline = min(deadline, hs.deadline)
        for d in self._dials.values():
            if d.state == "wait":
                deadline = min(deadline, d.next_at, d.deadline)
            else:
                deadline = min(deadline, d.attempt_deadline, d.deadline)
        for _gen, dl in self._watchdogs.values():
            deadline = min(deadline, dl)
        return max(deadline - time.monotonic(), 0.0)

    def _drain_control(self) -> None:
        """Loop-top housekeeping: adopt handed-off sockets and refresh
        write interest for peers with fresh outbox entries."""
        while self._installq:
            peer, conn = self._installq.popleft()
            old = self._conns.get(peer)
            if old is not None and old.sock is not conn.sock:
                self._drop_conn(old)
            with self._lock:
                stale = self._closed or self._gen[peer] != conn.gen
            if stale:
                try:
                    conn.sock.close()
                except OSError:
                    pass
                continue
            want_w = bool(self._outboxes[peer])
            mask = selectors.EVENT_READ | (
                selectors.EVENT_WRITE if want_w else 0)
            try:
                self._sel.register(conn.sock, mask, ("conn", conn))
            except (KeyError, ValueError, OSError):
                continue
            conn.want_w = want_w
            self._conns[peer] = conn
            self._m_conns.set(len(self._conns))
        if self._dirty:
            dirty, self._dirty = self._dirty, set()
            for peer in dirty:
                conn = self._conns.get(peer)
                if conn is not None and self._outboxes[peer]:
                    self._set_w(conn, True)

    def _set_w(self, conn: _Conn, want: bool) -> None:
        if conn.want_w == want:
            return
        mask = selectors.EVENT_READ | (selectors.EVENT_WRITE if want else 0)
        try:
            self._sel.modify(conn.sock, mask, ("conn", conn))
        except (KeyError, ValueError, OSError):
            return
        conn.want_w = want

    def _drop_conn(self, conn: _Conn) -> None:
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        if self._conns.get(conn.peer) is conn:
            del self._conns[conn.peer]
            self._m_conns.set(len(self._conns))

    def _run_timers(self) -> None:
        now = time.monotonic()
        for hs in list(self._hss):
            if now >= hs.deadline:
                self._drop_hs(hs)
        for peer, d in list(self._dials.items()):
            with self._lock:
                cur = self._gen[peer]
            if cur != d.gen or self._closed or now >= d.deadline:
                self._drop_dial(d)
                continue
            if d.state == "wait" and now >= d.next_at:
                self._dial_connect(d, now)
            elif d.state != "wait" and now >= d.attempt_deadline:
                self._dial_retry(d, now)
        for peer, (gen, dl) in list(self._watchdogs.items()):
            with self._lock:
                cur = self._gen[peer]
            if cur != gen:
                del self._watchdogs[peer]  # replaced — recovery done
                continue
            if now >= dl:
                del self._watchdogs[peer]
                self._expire_window(peer, gen)

    # -- nonblocking socket helpers (the only raw socket calls the loop
    # callbacks may reach — the MT-P203 contract) ----------------------------

    @staticmethod
    def _nb_recv_into(sock: socket.socket, view: memoryview) -> Optional[int]:
        """Bytes read, 0 on EOF, None when the socket has nothing now."""
        try:
            return sock.recv_into(view)
        except (BlockingIOError, InterruptedError):
            return None

    @staticmethod
    def _nb_send(sock: socket.socket, bufs: List[memoryview]) -> Optional[int]:
        """Bytes the kernel took (scatter-gather where available), None
        when the socket cannot take more now."""
        try:
            if _HAS_SENDMSG:
                return sock.sendmsg(bufs)
            return sock.send(bufs[0])
        except (BlockingIOError, InterruptedError):
            return None

    @staticmethod
    def _nb_accept(listener: socket.socket):
        try:
            return listener.accept()
        except (BlockingIOError, InterruptedError):
            return None
        except OSError:
            return None

    @staticmethod
    def _advance(bufs: List[memoryview], sent: int) -> None:
        while bufs and sent >= bufs[0].nbytes:
            sent -= bufs[0].nbytes
            bufs.pop(0)
        if sent and bufs:
            bufs[0] = bufs[0][sent:]

    # -- event-loop callbacks (_el_*: nonblocking ops only — MT-P203) --------

    @staticmethod
    def _nb_drain(sock: socket.socket) -> None:
        """Drain pending wakeup bytes; never blocks."""
        while True:
            try:
                if not sock.recv(4096):
                    return
            except (BlockingIOError, InterruptedError, OSError):
                return

    def _el_wake(self) -> None:
        self._nb_drain(self._wake_r)

    def _el_accept(self) -> None:
        while True:
            got = self._nb_accept(self._listener)
            if got is None:
                return
            conn, _addr = got
            conn.setblocking(False)
            hs = _Hs(conn, time.monotonic() + _HS_TIMEOUT_S)
            try:
                self._sel.register(conn, selectors.EVENT_READ, ("hs", hs))
            except (KeyError, ValueError, OSError):
                conn.close()
                continue
            self._hss.add(hs)

    def _drop_hs(self, hs: _Hs) -> None:
        try:
            self._sel.unregister(hs.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            hs.sock.close()
        except OSError:
            pass
        self._hss.discard(hs)

    def _el_hs_event(self, hs: _Hs) -> None:
        if hs.state == "hello":
            try:
                n = self._nb_recv_into(hs.sock,
                                       memoryview(hs.inb)[hs.igot:])
            except OSError:
                self._drop_hs(hs)
                return
            if n is None:
                return
            if n == 0:
                self._drop_hs(hs)
                return
            hs.igot += n
            if hs.igot < _RANK_HDR.size:
                return
            peer, pnonce, peer_last, book = _RANK_HDR.unpack(hs.inb)
            if not 0 <= peer < self.nranks or book != self._book_hash:
                self._drop_hs(hs)
                return
            hs.peer, hs.pnonce, hs.peer_last = (int(peer), int(pnonce),
                                                int(peer_last))
            with self._lock:
                my_last = self._last_seq[hs.peer]
            hs.out = [memoryview(_RANK_HDR.pack(
                self.rank, self._nonce, my_last, self._book_hash))]
            hs.state = "reply"
            try:
                self._sel.modify(hs.sock, selectors.EVENT_WRITE, ("hs", hs))
            except (KeyError, ValueError, OSError):
                self._drop_hs(hs)
                return
        if hs.state == "reply":
            try:
                sent = self._nb_send(hs.sock, hs.out)
            except OSError:
                self._drop_hs(hs)
                return
            if sent is None:
                return
            self._advance(hs.out, sent)
            if hs.out:
                return
            try:
                self._sel.unregister(hs.sock)
            except (KeyError, ValueError, OSError):
                pass
            self._hss.discard(hs)
            if not self._install_socket(hs.peer, hs.sock, hs.pnonce,
                                        hs.peer_last):
                try:
                    hs.sock.close()
                except OSError:
                    pass

    # -- redial machine ------------------------------------------------------

    def _start_dial(self, peer: int, gen: int) -> None:
        if peer in self._dials:
            return
        now = time.monotonic()
        self._dials[peer] = _Dial(peer, gen, now + self.reconnect, now)

    def _drop_dial(self, d: _Dial) -> None:
        if d.sock is not None:
            try:
                self._sel.unregister(d.sock)
            except (KeyError, ValueError, OSError):
                pass
            try:
                d.sock.close()
            except OSError:
                pass
            d.sock = None
        self._dials.pop(d.peer, None)

    def _dial_retry(self, d: _Dial, now: float) -> None:
        if d.sock is not None:
            try:
                self._sel.unregister(d.sock)
            except (KeyError, ValueError, OSError):
                pass
            try:
                d.sock.close()
            except OSError:
                pass
            d.sock = None
        d.state = "wait"
        d.next_at = now + d.backoff
        d.backoff = min(d.backoff * 2, 1.0)
        d.igot = 0
        d.out = []

    def _dial_connect(self, d: _Dial, now: float) -> None:
        host, _, port = self.addresses[d.peer].rpartition(":")
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        try:
            err = sock.connect_ex((host, int(port)))
        except OSError:
            sock.close()
            self._dial_retry(d, now)
            return
        if err not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK,
                       errno.EALREADY):
            sock.close()
            self._dial_retry(d, now)
            return
        d.sock = sock
        d.state = "connecting"
        d.attempt_deadline = now + _DIAL_ATTEMPT_S
        try:
            self._sel.register(sock, selectors.EVENT_WRITE, ("dial", d))
        except (KeyError, ValueError, OSError):
            sock.close()
            d.sock = None
            self._dial_retry(d, now)

    def _el_dial_event(self, d: _Dial) -> None:
        now = time.monotonic()
        if d.state == "connecting":
            err = d.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err:
                self._dial_retry(d, now)
                return
            try:
                if d.sock.getsockname() == d.sock.getpeername():
                    # Loopback self-connect (see _dial): drop it so the
                    # peer can bind its listener, then redial.
                    self._dial_retry(d, now)
                    return
            except OSError:
                self._dial_retry(d, now)
                return
            with self._lock:
                my_last = self._last_seq[d.peer]
            d.out = [memoryview(_RANK_HDR.pack(
                self.rank, self._nonce, my_last, self._book_hash))]
            d.state = "hello"
        if d.state == "hello":
            try:
                sent = self._nb_send(d.sock, d.out)
            except OSError:
                self._dial_retry(d, now)
                return
            if sent is None:
                return
            self._advance(d.out, sent)
            if d.out:
                return
            d.state = "reply"
            d.igot = 0
            try:
                self._sel.modify(d.sock, selectors.EVENT_READ, ("dial", d))
            except (KeyError, ValueError, OSError):
                self._dial_retry(d, now)
            return
        if d.state == "reply":
            try:
                n = self._nb_recv_into(d.sock, memoryview(d.inb)[d.igot:])
            except OSError:
                self._dial_retry(d, now)
                return
            if n is None:
                return
            if n == 0:
                self._dial_retry(d, now)
                return
            d.igot += n
            if d.igot < _RANK_HDR.size:
                return
            _prank, pnonce, peer_last, book = _RANK_HDR.unpack(d.inb)
            sock = d.sock
            try:
                self._sel.unregister(sock)
            except (KeyError, ValueError, OSError):
                pass
            d.sock = None
            self._dials.pop(d.peer, None)
            if book != self._book_hash:
                # Foreign mesh on a reassigned port: stop redialing (the
                # watchdog fails the window — same as the thread era).
                sock.close()
                return
            # expect_gen: refused atomically if the accept service beat
            # us or the watchdog already poisoned this generation.
            if not self._install_socket(d.peer, sock, int(pnonce),
                                        int(peer_last), expect_gen=d.gen):
                sock.close()

    # -- established-connection callbacks ------------------------------------

    def _el_conn_readable(self, conn: _Conn) -> None:
        budget = _RX_BUDGET
        while budget > 0:
            if conn.rx_body is None:
                try:
                    n = self._nb_recv_into(conn.sock,
                                           conn.rx_hmv[conn.rx_got:])
                except OSError:
                    self._el_conn_dead(conn)
                    return
                if n is None:
                    return
                if n == 0:
                    self._el_conn_dead(conn)
                    return
                conn.rx_got += n
                budget -= n
                if conn.rx_got < _HDR.size:
                    continue
                tag, size, seq = _HDR.unpack(conn.rx_hdr)
                conn.rx_got = 0
                if tag == _GOODBYE_TAG:
                    # The peer is gone by protocol: frames retained for
                    # acks can never be released — settle them silently
                    # (the done-or-cancelled contract), and treat the
                    # coming EOF as orderly.
                    conn.graceful = True
                    self._settle_unacked_silently(conn.peer)
                    continue
                if tag == _ACK_TAG:
                    # Delivery confirmation: release every retained
                    # frame up to the acked sequence.  (Stale-generation
                    # acks are ignored — _process_ack checks.)
                    self._process_ack(conn.peer, int(seq), conn.gen)
                    continue
                conn.rx_tag, conn.rx_seq = int(tag), int(seq)
                if size:
                    conn.rx_body = bytearray(int(size))
                    conn.rx_bgot = 0
                else:
                    self._deliver(conn, b"")
                continue
            try:
                n = self._nb_recv_into(
                    conn.sock, memoryview(conn.rx_body)[conn.rx_bgot:])
            except OSError:
                self._el_conn_dead(conn)
                return
            if n is None:
                return
            if n == 0:
                self._el_conn_dead(conn)
                return
            conn.rx_bgot += n
            budget -= n
            if conn.rx_bgot == len(conn.rx_body):
                payload = bytes(conn.rx_body)
                conn.rx_body = None
                self._deliver(conn, payload)

    def _deliver(self, conn: _Conn, payload: bytes) -> None:
        peer, gen = conn.peer, conn.gen
        with self._lock:
            if self._gen[peer] != gen:
                # Superseded connection (e.g. the peer restarted and the
                # dedup horizon was reset): frames still draining from
                # the old socket's kernel buffer must not advance state
                # in the new seq space.
                return
            if conn.rx_seq > self._last_seq[peer]:
                self._last_seq[peer] = conn.rx_seq
                self._channels[(peer, conn.rx_tag)].msgs.append(payload)
                self._m_rx_msgs[peer].inc()
                self._m_rx_bytes[peer].inc(len(payload))
            # else: duplicate from a reconnect resend — drop it, but
            # still re-ack (the original ack may be exactly what the
            # tear swallowed).
            ack_val = self._last_seq[peer]
        if self.reconnect > 0:
            self._enqueue_ack(peer, ack_val, gen)
            self._set_w(conn, True)

    def _el_conn_writable(self, conn: _Conn) -> None:
        peer, gen = conn.peer, conn.gen
        cv = self._out_cv[peer]
        box = self._outboxes[peer]
        budget = _TX_BUDGET
        while budget > 0:
            if conn.tx_bufs is None:
                with cv:
                    with self._lock:
                        if self._gen[peer] != gen:
                            return  # superseded: successor owns the box
                    if not box:
                        self._set_w(conn, False)
                        return
                    # PEEK, don't pop: the frame stays queued until fully
                    # written, so a reconnect's replacement resends it
                    # whole (the receiver dedups by sequence number).
                    entry = box[0]
                    if entry is self._pending_ack.get(peer):
                        # Detach from coalescing NOW, under the cv: the
                        # header bytes are captured below, and a
                        # delivery overwriting the horizon after that
                        # would be silently lost — the sender it acks
                        # would deadlock.
                        self._pending_ack[peer] = None
                    header, payload = entry[1], entry[2]
                bufs = [memoryview(header)]
                if payload.nbytes:
                    bufs.append(payload)
                conn.tx_entry, conn.tx_bufs = entry, bufs
            try:
                sent = self._nb_send(conn.sock, conn.tx_bufs)
            except OSError:
                self._el_conn_dead(conn)
                return
            if sent is None:
                self._set_w(conn, True)
                return
            budget -= max(sent, 1)
            self._advance(conn.tx_bufs, sent)
            if conn.tx_bufs:
                continue  # partial frame: try again (EAGAIN stops us)
            entry = conn.tx_entry
            conn.tx_entry = conn.tx_bufs = None
            self._settle_sent(conn, entry)

    def _settle_sent(self, conn: _Conn, entry) -> None:
        """One frame fully handed to the kernel: pop it, and in
        reconnect mode retain it until the peer's ack releases it
        (written-to-kernel is NOT delivered-to-peer)."""
        peer, gen = conn.peer, conn.gen
        cv = self._out_cv[peer]
        box = self._outboxes[peer]
        handle, retain_seq = entry[0], entry[3]
        popped = retained = False
        with cv:
            with self._lock:
                if self._gen[peer] != gen:
                    # A reconnect installed mid-write: whatever we wrote
                    # went to a dead socket, and the successor's settle
                    # owns the box — touching it here would strand the
                    # frame.
                    return
            if box and box[0] is entry:
                box.popleft()
                self._m_sendq[peer].set(len(box))
                popped = True
                if (retain_seq is not None and self.reconnect > 0
                        and retain_seq > self._acked_high[peer]):
                    # A frame whose ack already landed — the ack can
                    # race this retention — completes right away.
                    self._unacked[peer].append(entry)
                    retained = True
        if popped and not retained:
            handle.done = True
            handle.buf = None  # ownership back to the caller

    def _el_conn_dead(self, conn: _Conn) -> None:
        peer, gen = conn.peer, conn.gen
        graceful = conn.graceful
        self._drop_conn(conn)
        if graceful or self._closed:
            return
        self._on_disconnect(peer, gen)

    # -- disconnect / recovery ----------------------------------------------

    def _on_disconnect(self, peer: int, gen: int) -> None:
        """Generation ``gen``'s connection died.  Without reconnect:
        fail loudly now.  With reconnect: the dialing side starts the
        in-loop redial machine; both sides arm a watchdog deadline that
        falls back to the fail-loud path if no replacement installs in
        the window.  (Loop-thread only.)"""
        if self._closed or self._current_gen(peer) != gen:
            return  # stale generation or shutdown
        with self._lock:
            if (peer, gen) in self._disconnect_seen:
                return
            self._disconnect_seen = {
                (p, g) for (p, g) in self._disconnect_seen if p != peer
            }
            self._disconnect_seen.add((peer, gen))
        if self.reconnect <= 0:
            self._fail_unmatched_recvs(peer)
            self._drain_outbox(
                peer, error=f"send to rank {peer} failed: connection lost"
            )
            return
        if peer < self.rank:
            self._start_dial(peer, gen)
        self._watchdogs[peer] = (gen, time.monotonic() + self.reconnect)

    def _expire_window(self, peer: int, gen: int) -> None:
        with self._lock:
            if self._closed or self._gen[peer] != gen:
                return
            # Poison the generation: a redial racing this expiry cannot
            # install afterwards (fail everything or recover everything).
            # A LATER fresh connection through the accept service may
            # still revive the peer — the shm transport's
            # late-resurrection semantics — but never one tied to this
            # failed window.
            self._gen[peer] += 1
        d = self._dials.get(peer)
        if d is not None:
            self._drop_dial(d)
        self._fail_unmatched_recvs(peer)
        self._drain_outbox(
            peer,
            error=(f"send to rank {peer} failed: connection lost "
                   f"(no reconnect within {self.reconnect}s)"),
        )

    def _settle_unacked_silently(self, peer: int) -> None:
        cv = self._out_cv[peer]
        with cv:
            ua = self._unacked[peer]
            while ua:
                h = ua.popleft()[0]
                h.cancelled = True
                h.buf = None

    def _process_ack(self, peer: int, acked: int, gen: int) -> None:
        cv = self._out_cv[peer]
        done = []
        with cv:
            with self._lock:
                if self._gen[peer] != gen:
                    return  # ack from a superseded connection
            if acked > self._acked_high[peer]:
                self._acked_high[peer] = acked
            ua = self._unacked[peer]
            while ua and ua[0][3] is not None and ua[0][3] <= acked:
                done.append(ua.popleft()[0])
        for h in done:
            h.done = True
            h.buf = None

    def _enqueue_ack(self, peer: int, acked: int, gen: int) -> None:
        cv = self._out_cv[peer]
        with cv:
            if peer in self._dead_peers or self._closed:
                return
            with self._lock:
                if self._gen[peer] != gen:
                    # A replacement connection installed between the
                    # delivery's gen check and this enqueue.  If the
                    # peer RESTARTED, ``acked`` is a horizon from the
                    # dead instance's sequence space — queued onto the
                    # new connection it would release the restarted
                    # peer's entire unacked window (silent loss under
                    # the exactly-once contract).  Drop it; the new
                    # generation acks its own deliveries.
                    return
            pending = self._pending_ack.get(peer)
            if pending is not None:
                # Acks are cumulative: overwrite the still-queued ack's
                # horizon instead of queueing another (a gradient storm
                # would otherwise double the write syscall count).
                pending[1] = _HDR.pack(_ACK_TAG, 0, acked)
                return
            entry = [Handle(kind="send", peer=peer, tag=_ACK_TAG),
                     _HDR.pack(_ACK_TAG, 0, acked), _EMPTY, None]
            self._pending_ack[peer] = entry
            self._outboxes[peer].append(entry)
            cv.notify()
        self._mark_dirty(peer)

    def _fail_unmatched_recvs(self, peer: int) -> None:
        """A mid-run connection death (peer crashed / link dropped):
        every pending recv beyond the already-delivered backlog can
        never complete — fail them with the raise-once convention, and
        make later irecvs from this peer fail the same way.  Messages
        that arrived before the death still serve matching receives
        (same drain-what-landed semantics as the shm transport's
        remap)."""
        err = f"recv from rank {peer} failed: connection lost"
        with self._lock:
            self._dead_readers.add(peer)
            for (src, _tag), chan in self._channels.items():
                if src != peer:
                    continue
                live = [h for h in chan.pending if not h.cancelled]
                for h in live[len(chan.msgs):]:
                    h.cancelled = True
                    h.meta["error"] = err

    def _drain_outbox(self, peer: int, error: str | None = None) -> None:
        """Cancel every queued send to ``peer``.  With ``error`` (dead
        peer) the handles raise from ``test``; without (orderly close)
        they cancel silently."""
        cv = self._out_cv[peer]
        with cv:
            self._dead_peers.add(peer)
            cv.notify_all()
            for q in (self._unacked[peer], self._outboxes[peer]):
                while q:
                    h = q.popleft()[0]
                    h.cancelled = True
                    h.buf = None
                    if error:
                        h.meta["error"] = error
            self._m_sendq[peer].set(0)

    # -- Transport -----------------------------------------------------------

    def isend(self, data: Any, dst: int, tag: int) -> Handle:
        if dst == self.rank or not 0 <= dst < self.nranks:
            raise ValueError(f"isend to invalid rank {dst}")
        if self._closed:
            raise RuntimeError("isend on a closed transport")
        view = as_bytes_view(b"" if data is None else data)
        handle = Handle(kind="send", peer=dst, tag=tag, buf=data)
        # Zero-copy queue: the outbox holds a *view* over the caller's
        # buffer, not a snapshot — the ownership contract already forbids
        # the caller touching it until test() is True (reported only
        # after the write completes), so transport-owned memory stays
        # O(1) per queued message however deep the backlog, and isend
        # never blocks.
        cv = self._out_cv[dst]
        with cv:
            if dst in self._dead_peers:
                handle.cancelled = True
                handle.buf = None
                handle.meta["error"] = f"rank {dst} unreachable (writer dead)"
                return handle
            self._send_seq[dst] += 1
            self._outboxes[dst].append(
                (handle, _HDR.pack(tag, view.nbytes, self._send_seq[dst]),
                 view, self._send_seq[dst])
            )
            self._m_sendq[dst].set(len(self._outboxes[dst]))
            cv.notify()
        self._mark_dirty(dst)
        self._m_tx_msgs[dst].inc()
        self._m_tx_bytes[dst].inc(view.nbytes)
        return handle

    def irecv(self, src: int, tag: int, out: Any | None = None) -> Handle:
        if src == self.rank or not 0 <= src < self.nranks:
            raise ValueError(f"irecv from invalid rank {src}")
        handle = Handle(kind="recv", peer=src, tag=tag, out=out)
        if out is None:
            handle.meta["as_bytes"] = True
        with self._lock:
            chan = self._channels[(src, tag)]
            if src in self._dead_readers:
                # Only the already-delivered backlog can satisfy receives.
                live = sum(1 for h in chan.pending if not h.cancelled)
                if live >= len(chan.msgs):
                    handle.cancelled = True
                    handle.meta["error"] = (
                        f"recv from rank {src} failed: connection lost"
                    )
                    return handle
            chan.pending.append(handle)
        return handle

    def iprobe(self, src: int, tag: int) -> bool:
        with self._lock:
            if self._channels[(src, tag)].msgs:
                return True
            if src in self._dead_readers:
                # A probe loop on a dead, drained channel can never turn
                # true — fail loudly (the aio schedulers' probe-then-recv
                # pattern, aio/scheduler.py, would otherwise poll forever;
                # the error surfaces from Scheduler.wait with the task
                # attached).
                raise RuntimeError(
                    f"recv from rank {src} failed: connection lost"
                )
            return False

    def test(self, handle: Handle) -> bool:
        if handle.cancelled:
            err = handle.meta.pop("error", None)
            if err:  # raise exactly once, then report not-done quietly
                raise RuntimeError(err)
            return False
        if handle.done:
            return True
        if handle.kind == "send":
            return handle.done
        with self._lock:
            chan = self._channels[(handle.peer, handle.tag)]
            while chan.pending and chan.pending[0].cancelled:
                chan.pending.popleft()
            if not chan.pending or chan.pending[0] is not handle or not chan.msgs:
                return False
            msg = chan.msgs[0]
            if handle.meta.get("as_bytes"):
                chan.msgs.popleft()
                chan.pending.popleft()
                handle.payload = msg
                handle.done = True
                return True
            view = as_writable_view(handle.out)
            if view.nbytes != len(msg):
                handle.cancelled = True
                chan.pending.popleft()  # message stays for a correct recv
                raise ValueError(
                    f"recv size mismatch: message {len(msg)}B does not fit "
                    f"buffer {view.nbytes}B (src={handle.peer}, tag={handle.tag})"
                )
            chan.msgs.popleft()
            chan.pending.popleft()
            view[:] = msg
            handle.done = True
            return True

    def cancel(self, handle: Handle) -> None:
        handle.cancelled = True
        handle.buf = None  # pending-queue entries are reaped lazily in test

    def close(self) -> None:
        if self._closed:
            return
        # Goodbye frames: queue one to every live peer (FIFO after any
        # still-queued user sends) and give the loop a bounded grace
        # period to flush, so readers on the other side see an orderly
        # shutdown rather than a crash.  Best-effort: a dead or
        # backlogged peer just misses the goodbye and reports
        # connection-lost, which is accurate for it.
        zero = np.empty(0, np.uint8)
        for peer in range(self.nranks):
            if peer == self.rank:
                continue
            cv = self._out_cv[peer]
            with cv:
                if peer not in self._dead_peers:
                    self._outboxes[peer].append(
                        (Handle(kind="send", peer=peer, tag=_GOODBYE_TAG),
                         _HDR.pack(_GOODBYE_TAG, 0, 0), zero.view(), None)
                    )
                    cv.notify()
            self._mark_dirty(peer)
        # The loop owns connection state (including installs still in
        # flight right after construction), so the loop decides when the
        # flush is complete; a dead loop just costs the bounded wait.
        self._closing = True
        self._wake()
        self._flushed.wait(1.0)
        self._closed = True
        self._wake()
        for t in self._threads:
            t.join(2)
        # The loop is gone: sockets and selector are ours to tear down.
        # Cancel every queued send left — a blocking sender must observe
        # done-or-cancelled, never an orphaned handle.
        for peer in range(self.nranks):
            if peer != self.rank:
                self._drain_outbox(peer)
        for cv in self._out_cv.values():
            with cv:
                cv.notify_all()
        for conn in self._peers.values():
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()
        for d in list(self._dials.values()):
            if d.sock is not None:
                try:
                    d.sock.close()
                except OSError:
                    pass
        for hs in list(self._hss):
            try:
                hs.sock.close()
            except OSError:
                pass
        for peer, conn in list(self._installq):
            try:
                conn.sock.close()
            except OSError:
                pass
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        try:
            self._sel.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
