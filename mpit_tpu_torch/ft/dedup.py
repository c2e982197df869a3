"""At-most-once admission for framed PS writes: dedup on (client, epoch,
seq).

A copy of ``mpit_tpu/ft/dedup.py``: the port imports nothing of the JAX
package.

Transports deliver each (src, tag) channel in FIFO order, and a client
resends a timed-out op with its original seq — so per channel the server
sees a non-decreasing seq stream where duplicates are retransmissions of
ops it may already have applied.  One (epoch, last_seq) pair per channel
is therefore a complete dedup state: no windowed history needed.

Verdicts:

- ``FRESH`` — first sighting; apply, then ack.
- ``DUP``   — same epoch, seq already admitted: skip the apply, but
  *re-ack* — the duplicate exists precisely because the client may have
  lost the first ack.  Skipping the apply is what keeps a retried GRAD
  from double-counting (and keeps the client's error-feedback residual
  telescope exact: the applied stream equals the encoded stream).
- ``STALE`` — older epoch: a dead incarnation's leftover traffic.
  Dropped without an ack; the live incarnation matches acks by epoch
  and must never be fed an impostor.

The table serializes to flat JSON (``state()``/``restore()``) so a
server checkpoint carries it: after a server restart, a client retrying
an op the old process already applied-and-checkpointed still gets DUP,
not a second apply.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

FRESH = "fresh"
DUP = "dup"
STALE = "stale"


class DedupTable:
    def __init__(self) -> None:
        #: (crank, tag) -> (epoch, last admitted seq)
        self._last: Dict[Tuple[int, int], Tuple[int, int]] = {}
        #: (crank, tag) -> (epoch, seq, admitted chunk idxs, count) for
        #: the one chunked op in flight on that channel (streaming
        #: transfers, docs/PROTOCOL.md §12).  At most one per channel:
        #: the client never starts op N+1 before op N commits, so a
        #: *newer* seq arriving abandons any partial silently.
        self._partial: Dict[Tuple[int, int], Tuple[int, int, set, int]] = {}

    def admit(self, crank: int, tag: int, epoch: int, seq: int) -> str:
        key = (crank, tag)
        cur = self._last.get(key)
        if cur is not None:
            cur_epoch, cur_seq = cur
            if epoch < cur_epoch:
                return STALE
            if epoch == cur_epoch and seq <= cur_seq:
                return DUP
        self._last[key] = (epoch, seq)
        return FRESH

    def admit_chunk(self, crank: int, tag: int, epoch: int, seq: int,
                    idx: int, count: int) -> Tuple[str, bool]:
        """Per-(op, chunk) admission for streamed transfers (§12):
        ``(verdict, completed)``.  FRESH admits this chunk exactly once;
        ``completed`` is True on the admission that finished the op —
        the caller commits (version bump, counters) exactly there.
        Chunks of an already-committed op verdict DUP (re-ack: the
        client resends precisely because an ack was lost), as do
        duplicate chunks of the in-flight op; older epochs are STALE.
        A newer epoch or seq abandons any in-flight partial — the
        client moved on, and FIFO channels guarantee no stragglers."""
        key = (crank, tag)
        cur = self._last.get(key)
        if cur is not None:
            cur_epoch, cur_seq = cur
            if epoch < cur_epoch:
                return STALE, False
            if epoch == cur_epoch and seq <= cur_seq:
                return DUP, False
        part = self._partial.get(key)
        if part is not None and (epoch, seq) < (part[0], part[1]):
            # A dead incarnation's (or an abandoned attempt's) late
            # chunk must never clobber the live op's partial set.
            return (STALE if epoch < part[0] else DUP), False
        if part is None or part[0] != epoch or part[1] != seq:
            part = (epoch, seq, set(), int(count))
            self._partial[key] = part
        seen = part[2]
        if idx in seen:
            return DUP, False
        seen.add(idx)
        if len(seen) >= part[3]:
            del self._partial[key]
            self._last[key] = (epoch, seq)
            return FRESH, True
        return FRESH, False

    def is_committed(self, crank: int, tag: int, epoch: int,
                     seq: int) -> bool:
        """Whether (epoch, seq) on this channel already committed —
        distinguishes a re-sent chunk of a *finished* op (re-ack it:
        the client lost acks) from a duplicate of the op still in
        flight (stay silent on channels that only ack at commit)."""
        cur = self._last.get((crank, tag))
        if cur is None:
            return False
        cur_epoch, cur_seq = cur
        return epoch < cur_epoch or (epoch == cur_epoch and seq <= cur_seq)

    def drop_partial(self, crank: int, tag: int) -> None:
        """Forget the in-flight chunk set on one channel (the assembly
        paths own their bytes; a server that discards them — e.g. a
        PUSH whose staging is never checkpointed — must discard the
        admissions with them, or resent chunks would dedup into a
        hole)."""
        self._partial.pop((crank, tag), None)

    def last(self, crank: int, tag: int) -> "Tuple[int, int] | None":
        return self._last.get((crank, tag))

    # -- checkpoint round-trip (values live in JSON meta) --------------------

    def state(self) -> Dict[str, list]:
        return {f"{c}:{t}": [e, s] for (c, t), (e, s) in self._last.items()}

    def restore(self, state: Dict[str, list]) -> None:
        for key, (epoch, seq) in (state or {}).items():
            crank, tag = (int(x) for x in key.split(":"))
            self._last[(crank, tag)] = (int(epoch), int(seq))

    def partial_state(self, tags: "Optional[Iterable[int]]" = None
                      ) -> Dict[str, list]:
        """In-flight chunk admissions for checkpointing, restricted to
        ``tags`` (None = all).  Only channels whose partially-admitted
        chunks are *already applied into the checkpointed state* may be
        persisted (the GRAD immediate-apply path): the chunk set and
        the param bytes are one consistency cut, so a restarted server
        re-acks the applied chunks and the client resends only the
        rest.  Assembly channels (PARAM_PUSH) must NOT be included —
        their staged bytes die with the process, and persisting the
        admissions without the bytes would dedup resends into a hole."""
        allow = None if tags is None else set(tags)
        return {
            f"{c}:{t}": [e, s, cnt, sorted(seen)]
            for (c, t), (e, s, seen, cnt) in self._partial.items()
            if allow is None or t in allow
        }

    def restore_partial(self, state: Dict[str, list]) -> None:
        for key, (epoch, seq, count, seen) in (state or {}).items():
            crank, tag = (int(x) for x in key.split(":"))
            self._partial[(crank, tag)] = (
                int(epoch), int(seq), set(int(i) for i in seen), int(count))
