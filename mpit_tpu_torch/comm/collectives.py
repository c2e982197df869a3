"""Host-side collectives over the Transport contract.

The reference's rank processes call MPI collectives directly — Allreduce
(reference mpifuncs.c:83), Bcast (reference mpifuncs.c:145), Iallreduce
(reference mpifuncs.c:1357) — and its test suite times them
(reference test/testreduceall.lua:31-33, test/testireduceall.lua:32-39).
This module is the host-side path: role processes (servers, clients,
testers) coordinating over the shm/tcp/in-process transports with no
device in the loop.  The process gang's startup barrier runs on it.

The port of the JAX package's ``mpit_tpu/comm/collectives.py``, unchanged
but for this paragraph: the algorithms and the tag layout are the same,
so a port rank and a JAX rank can run one collective together.

Algorithms are the standard topology-aware ones, built purely from the
nonblocking Transport primitives (isend/irecv/test):

- :meth:`HostCollectives.allreduce` — ring reduce-scatter + all-gather
  for payloads that dwarf the rank count (bandwidth-optimal: each rank
  moves ``2*(n-1)/n`` of the buffer), binomial reduce + bcast below that;
- :meth:`HostCollectives.bcast` — binomial tree, ``ceil(log2 n)`` rounds;
- :meth:`HostCollectives.reduce` — binomial tree onto ``root``;
- :meth:`HostCollectives.barrier` — dissemination barrier, 0-byte
  messages, ``ceil(log2 n)`` rounds;
- :meth:`HostCollectives.allreduce_async` — the Iallreduce analog: the
  same ring on a worker thread, returning a handle with test/wait.

All array ops are in-place on C-contiguous numpy arrays (the transports'
zero-copy rule).  Tags live in a reserved range far above the PS wire
tags (:mod:`mpit_tpu_torch.ps.tags`), with a per-call round counter so
back-to-back collectives never cross-talk.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

_OPS = {
    "sum": lambda acc, other: np.add(acc, other, out=acc),
    "max": lambda acc, other: np.maximum(acc, other, out=acc),
    "min": lambda acc, other: np.minimum(acc, other, out=acc),
}

_TAG_BASE = 1 << 16
_STEPS_PER_ROUND = 1024  # ring needs 2*(n-1) tags -> caps n at 512 ranks
_ROUND_SPAN = 2048


class HostCollectives:
    """Collective operations over every rank of one transport."""

    def __init__(self, transport, tag_base: int = _TAG_BASE):
        self.t = transport
        self.rank = transport.rank
        self.n = transport.nranks
        self._tag_base = tag_base
        self._round = 0
        self._round_lock = threading.Lock()
        if self.n > _STEPS_PER_ROUND // 2:
            raise ValueError(f"HostCollectives supports up to 512 ranks, got {self.n}")

    # -- plumbing ------------------------------------------------------------

    def _tags(self):
        """A fresh tag namespace for one collective call.  Locked: an
        ``allreduce_async`` runs on a worker thread and may overlap other
        collectives on this instance — each in-flight call must own a
        distinct tag block or ranks would fold each other's chunks."""
        with self._round_lock:
            rnd = self._round
            self._round += 1
        base = self._tag_base + (rnd % _ROUND_SPAN) * _STEPS_PER_ROUND
        return lambda step: base + step

    def _drive(self, *handles):
        """Poll handles to completion, interleaved: transports may drive
        send progress from the sender's ``test`` (the local mailbox
        transport does), so blocking on a recv before polling the send
        would deadlock a ring where everyone sends then receives.  Backs
        off to short sleeps so ranks parked in a startup barrier don't
        monopolize cores the straggler they wait for needs."""
        pending = list(handles)
        spins = 0
        while pending:
            pending = [h for h in pending if not self.t.test(h)]
            spins += 1
            if pending and spins > 256:
                time.sleep(0.0005)

    def _send(self, buf, dst, tag):
        self._drive(self.t.isend(buf, dst, tag))

    def _recv(self, buf, src, tag):
        self._drive(self.t.irecv(src, tag, out=buf))

    def _sendrecv(self, sbuf, dst, rbuf, src, tag_s, tag_r):
        """Concurrent blocking send+recv (see :meth:`_drive`)."""
        self._drive(
            self.t.isend(sbuf, dst, tag_s), self.t.irecv(src, tag_r, out=rbuf)
        )

    @staticmethod
    def _flat(arr: np.ndarray) -> np.ndarray:
        if not isinstance(arr, np.ndarray) or not arr.flags["C_CONTIGUOUS"]:
            raise ValueError("host collectives need C-contiguous numpy arrays")
        return arr.reshape(-1)

    # -- collectives ---------------------------------------------------------

    def barrier(self) -> None:
        """Dissemination barrier: after round t every rank has heard
        (transitively) from 2^(t+1) predecessors; log2(n) rounds total."""
        if self.n == 1:
            return
        tag = self._tags()
        step = 1
        t_ = 0
        # Explicit 0-byte recv target: the shm transport's bufferless
        # irecv requires a prior iprobe, which a rendezvous can't do.
        zero = np.empty(0, np.uint8)
        while step < self.n:
            dst = (self.rank + step) % self.n
            src = (self.rank - step) % self.n
            self._sendrecv(zero, dst, zero, src, tag(t_), tag(t_))
            step <<= 1
            t_ += 1

    def bcast(self, arr: np.ndarray, root: int = 0) -> np.ndarray:
        """Binomial-tree broadcast, in place (reference mpifuncs.c:145)."""
        flat = self._flat(arr)
        if self.n == 1:
            return arr
        tag = self._tags()
        vr = (self.rank - root) % self.n
        nrounds = (self.n - 1).bit_length()
        for t_ in range(nrounds):
            span = 1 << t_
            if vr < span:
                if vr + span < self.n:
                    self._send(flat, (self.rank + span) % self.n, tag(t_))
            elif vr < span << 1:
                self._recv(flat, (self.rank - span) % self.n, tag(t_))
        return arr

    def reduce(self, arr: np.ndarray, op: str = "sum", root: int = 0) -> np.ndarray:
        """Binomial-tree reduction onto ``root``, in place there (other
        ranks' buffers are scratch afterwards)."""
        fold = _OPS[op]
        flat = self._flat(arr)
        if self.n == 1:
            return arr
        tag = self._tags()
        vr = (self.rank - root) % self.n
        tmp = np.empty_like(flat)
        nrounds = (self.n - 1).bit_length()
        for t_ in range(nrounds):
            span = 1 << t_
            if vr & span:
                self._send(flat, (self.rank - span) % self.n, tag(t_))
                break  # contributed: done
            if vr + span < self.n:
                self._recv(tmp, (self.rank + span) % self.n, tag(t_))
                fold(flat, tmp)
        return arr

    def allreduce(self, arr: np.ndarray, op: str = "sum") -> np.ndarray:
        """In-place allreduce (reference mpifuncs.c:83).

        Ring reduce-scatter + all-gather when the payload is large enough
        for per-rank chunks to amortize message overhead; binomial
        reduce + bcast otherwise (latency-optimal for small payloads).
        """
        flat = self._flat(arr)
        if self.n == 1:
            return arr
        if flat.size < self.n * 64:
            self.reduce(arr, op=op, root=0)
            return self.bcast(arr, root=0)
        fold = _OPS[op]
        tag = self._tags()
        n, r = self.n, self.rank
        right = (r + 1) % n
        left = (r - 1) % n
        bounds = [0] + list(np.cumsum([len(c) for c in np.array_split(flat, n)]))
        chunk = lambda i: flat[bounds[i % n]:bounds[i % n + 1]]
        tmp = np.empty(max(bounds[i + 1] - bounds[i] for i in range(n)), flat.dtype)

        # Reduce-scatter: after n-1 steps rank r owns the full sum of
        # chunk (r+1) mod n.
        for s in range(n - 1):
            sc, rc = (r - s) % n, (r - s - 1) % n
            rbuf = tmp[: bounds[rc + 1] - bounds[rc]]
            self._sendrecv(chunk(sc), right, rbuf, left, tag(s), tag(s))
            fold(chunk(rc), rbuf)
        # All-gather: circulate the owned chunks.
        for s in range(n - 1):
            sc, rc = (r + 1 - s) % n, (r - s) % n
            self._sendrecv(
                chunk(sc), right, chunk(rc), left, tag(n - 1 + s), tag(n - 1 + s)
            )
        return arr

    def allgather(self, send: np.ndarray, recv: np.ndarray) -> np.ndarray:
        """Equal-block allgather (reference mpifuncs.c:47): every rank's
        ``send`` block lands in ``recv`` at block offset == its rank.
        Ring circulation, ``n-1`` neighbor steps (bandwidth-optimal)."""
        sflat, rflat = self._flat(send), self._flat(recv)
        if rflat.size != sflat.size * self.n:
            raise ValueError(
                f"allgather recv must hold n*send ({self.n}x{sflat.size}), "
                f"got {rflat.size}"
            )
        block = lambda i: rflat[(i % self.n) * sflat.size:
                                (i % self.n + 1) * sflat.size]
        np.copyto(block(self.rank), sflat)
        if self.n == 1:
            return recv
        tag = self._tags()
        right, left = (self.rank + 1) % self.n, (self.rank - 1) % self.n
        for s in range(self.n - 1):
            self._sendrecv(block(self.rank - s), right,
                           block(self.rank - s - 1), left, tag(s), tag(s))
        return recv

    def reduce_scatter(self, arr: np.ndarray, out: np.ndarray,
                       op: str = "sum") -> np.ndarray:
        """Equal-block reduce-scatter (reference mpifuncs.c:1716,
        Reduce_scatter_block semantics): ``arr`` is n equal blocks; rank r
        receives the elementwise reduction of every rank's block r in
        ``out``.  The ring reduce-scatter phase of :meth:`allreduce`;
        ``arr`` is scratch afterwards."""
        fold = _OPS[op]
        flat, oflat = self._flat(arr), self._flat(out)
        if flat.size != oflat.size * self.n:
            raise ValueError(
                f"reduce_scatter arr must be n*out ({self.n}x{oflat.size}), "
                f"got {flat.size}"
            )
        if self.n == 1:
            np.copyto(oflat, flat)
            return out
        tag = self._tags()
        n, r = self.n, self.rank
        right, left = (r + 1) % n, (r - 1) % n
        size = oflat.size
        chunk = lambda i: flat[(i % n) * size:(i % n + 1) * size]
        tmp = np.empty(size, flat.dtype)
        # After n-1 steps rank r holds the full sum of chunk (r+1) mod n
        # (same schedule as allreduce); one extra neighbor hop rehomes it
        # so rank r's out is chunk r, the MPI contract.
        for s in range(n - 1):
            sc, rc = (r - s) % n, (r - s - 1) % n
            self._sendrecv(chunk(sc), right, tmp, left, tag(s), tag(s))
            fold(chunk(rc), tmp)
        self._sendrecv(chunk(r + 1), right, oflat, left,
                       tag(n - 1), tag(n - 1))
        return out

    def scatter(self, arr: Optional[np.ndarray], out: np.ndarray,
                root: int = 0) -> np.ndarray:
        """Equal-block scatter from ``root`` (reference mpifuncs.c:1792):
        block i of root's ``arr`` lands in rank i's ``out``."""
        oflat = self._flat(out)
        tag = self._tags()
        if self.rank == root:
            flat = self._flat(arr)
            if flat.size != oflat.size * self.n:
                raise ValueError(
                    f"scatter arr must be n*out ({self.n}x{oflat.size}), "
                    f"got {flat.size}"
                )
            size = oflat.size
            handles = [
                self.t.isend(flat[i * size:(i + 1) * size], i, tag(0))
                for i in range(self.n) if i != root
            ]
            np.copyto(oflat, flat[root * size:(root + 1) * size])
            self._drive(*handles)
        else:
            self._recv(oflat, root, tag(0))
        return out

    def gather(self, send: np.ndarray, recv: Optional[np.ndarray],
               root: int = 0) -> Optional[np.ndarray]:
        """Equal-block gather onto ``root`` (reference mpifuncs.c:1265):
        rank i's ``send`` lands in block i of root's ``recv``."""
        sflat = self._flat(send)
        tag = self._tags()
        if self.rank == root:
            rflat = self._flat(recv)
            if rflat.size != sflat.size * self.n:
                raise ValueError(
                    f"gather recv must hold n*send ({self.n}x{sflat.size}), "
                    f"got {rflat.size}"
                )
            size = sflat.size
            handles = [
                self.t.irecv(i, tag(0), out=rflat[i * size:(i + 1) * size])
                for i in range(self.n) if i != root
            ]
            np.copyto(rflat[root * size:(root + 1) * size], sflat)
            self._drive(*handles)
            return recv
        self._send(sflat, root, tag(0))
        return None

    def scan(self, arr: np.ndarray, op: str = "sum") -> np.ndarray:
        """Inclusive prefix reduction (reference mpifuncs.c:1780 MPI_Scan):
        rank r ends with fold(rank 0..r inputs), in place.  Linear chain —
        latency n-1 hops, which is fine at role-process counts."""
        fold = _OPS[op]
        flat = self._flat(arr)
        if self.n == 1:
            return arr
        tag = self._tags()
        if self.rank > 0:
            tmp = np.empty_like(flat)
            self._recv(tmp, self.rank - 1, tag(self.rank - 1))
            fold(flat, tmp)
        if self.rank + 1 < self.n:
            self._send(flat, self.rank + 1, tag(self.rank))
        return arr

    def allreduce_async(self, arr: np.ndarray, op: str = "sum"):
        """Nonblocking allreduce (reference mpifuncs.c:1357 Iallreduce;
        Test-before/after-Wait shape of test/testireduceall.lua:32-39).
        The returned handle owns ``arr`` until ``wait`` returns."""
        return _AsyncCollective(self, arr, op)


class _AsyncCollective:
    """Thread-backed in-flight collective with MPI Test/Wait semantics."""

    def __init__(self, coll: HostCollectives, arr: np.ndarray, op: str):
        self._err: Optional[BaseException] = None

        def run():
            try:
                coll.allreduce(arr, op=op)
            except BaseException as e:  # surfaced on wait/test
                self._err = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def test(self) -> bool:
        done = not self._thread.is_alive()
        if done and self._err is not None:
            raise self._err
        return done

    def wait(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("allreduce_async still in flight")
        if self._err is not None:
            raise self._err
