"""Cell-fabric wire framing — the DIFF frame layout and the encoded
frame history the diff producer draws deltas from (docs/PROTOCOL.md §11).

The port of ``mpit_tpu/cells/wire.py``, byte for byte: the same headers,
the same XOR deltas.  Host code on numpy only (no torch op on the cells'
threads).  The JAX package runs the XOR on its ``comm/pool`` worker pool;
the port has no pool yet (it comes with chunked streaming, slice 5f, which
takes the XOR over), so the XOR here is ``np.bitwise_xor`` into the same
fresh ``np.empty`` buffer: the bytes are the same.

The replication invariant the whole fabric rests on: **a cell's serving
cache holds, per installed version, bit-for-bit the encoded snapshot
frame its upstream server's snapshot cache holds for that version and
the negotiated codec.**  Reads answered by a cell are therefore
bitwise-equal to a direct upstream read at the stamped version — not
approximately, not modulo re-encoding, but as the same bytes.

Two frame kinds keep that invariant cheap to maintain:

- ``DIFF_FULL`` — the whole encoded snapshot frame at ``to_version``
  (the attach seed and the resync answer).  One full frame per cell per
  (re)subscription, straight out of the server's version-counted snapshot cache.
- ``DIFF_DELTA`` — the byte-wise XOR of the ``to_version`` and
  ``from_version`` encoded frames.  XOR in the *encoded* domain is what
  makes the chain exact: a float add-of-differences would round, and a
  re-quantization would drift, but ``install = frame ^ delta`` is an
  involution — the cell reconstructs ``to_version``'s frame bit-exactly
  by induction from the attach seed.  Under an int8-negotiated
  subscription the frames (and so the deltas) are the codec's per-1024-
  block layout, ~4x smaller on the wire than the float32 stream — the
  EQuARX block layout cheapening the replication hops exactly as it
  cheapens gradient pushes.

The header is five int64 words travelling in the SAME message as the
body (``[kind, from_version, to_version, head_version, body_nbytes]``):
fault injection acts at message granularity, so a dropped or delayed
DIFF loses header and payload atomically and the cell's gap detection
(``from_version != installed``) is the complete recovery trigger.
``head_version`` rides every frame, but a cell never *depends* on the
diff stream for head knowledge — its HEARTBEAT beacons are answered
with ``[epoch, seq, head_version]`` echoes on a separate channel, so a
delayed diff stream widens the cell's *known* lag instead of hiding it
(that is what makes the staleness bound enforceable, §11.4).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np


#: int64 [kind, from_version, to_version, head_version, body_nbytes]
DIFF_HDR_WORDS = 5
DIFF_HDR_BYTES = 8 * DIFF_HDR_WORDS

#: frame kinds
DIFF_FULL = 0
DIFF_DELTA = 1

#: cell -> server resync request: int64 [epoch, seq, have_version]
DIFF_REQ_WORDS = 3

#: subscriber heartbeat echo: int64 [epoch, seq, head_version]
HEAD_ECHO_WORDS = 3


def as_u8(frame: np.ndarray) -> np.ndarray:
    """A uint8 view of an encoded snapshot frame (identity-codec frames
    are float32; quantized frames already uint8)."""
    return frame.view(np.uint8) if frame.dtype != np.uint8 else frame


def pack_diff(kind: int, from_version: int, to_version: int,
              head_version: int, body: Optional[np.ndarray]) -> np.ndarray:
    """One DIFF message: the 40-byte header then the body bytes.  The
    returned buffer is fresh — an in-flight zero-copy send must never
    see a later frame rewrite it."""
    body_u8 = as_u8(body) if body is not None else None
    nbytes = int(body_u8.size) if body_u8 is not None else 0
    out = np.empty(DIFF_HDR_BYTES + nbytes, np.uint8)
    out[:DIFF_HDR_BYTES].view(np.int64)[:] = (
        kind, from_version, to_version, head_version, nbytes)
    if body_u8 is not None:
        out[DIFF_HDR_BYTES:] = body_u8
    return out


def parse_diff(payload) -> Tuple[int, int, int, int, np.ndarray]:
    """(kind, from_version, to_version, head_version, body) from a DIFF
    message.  Every malformation is loud — a truncated frame must never
    install as a shorter snapshot."""
    raw = np.frombuffer(bytes(payload), np.uint8)
    if raw.size < DIFF_HDR_BYTES:
        raise ValueError(
            f"DIFF frame too short: {raw.size} bytes (need the "
            f"{DIFF_HDR_BYTES}-byte header)")
    kind, from_v, to_v, head, nbytes = (
        int(x) for x in raw[:DIFF_HDR_BYTES].view(np.int64))
    if kind not in (DIFF_FULL, DIFF_DELTA):
        raise ValueError(f"unknown DIFF kind {kind}")
    body = raw[DIFF_HDR_BYTES:]
    if body.size != nbytes:
        raise ValueError(
            f"DIFF body is {body.size} bytes but the header promised "
            f"{nbytes}")
    return kind, from_v, to_v, head, body


#: chunked-subscription DIFF header (docs/PROTOCOL.md §11.8): int64
#: [kind, from_version, to_version, head_version, nbytes, chunk_idx,
#: chunk_count] — a FULL/DELTA body split into chunk_count independent
#: messages so a 640 MB resync never head-of-line-blocks the stream.
#: Sent ONLY to cells whose subscription negotiated FLAG_CHUNKED (the
#: per-cell format is fixed by negotiation — small frames ship as a
#: single chunk message, never the 5-word legacy form).
DIFF_CHUNK_HDR_WORDS = 7
DIFF_CHUNK_HDR_BYTES = 8 * DIFF_CHUNK_HDR_WORDS


def pack_diff_chunks(kind: int, from_version: int, to_version: int,
                     head_version: int, body: np.ndarray,
                     chunk_bytes: int) -> "list[np.ndarray]":
    """One DIFF frame as its chunk-message sequence: byte-granular cuts
    (XOR deltas have no block structure to respect), each message fresh
    and self-describing, FIFO on the one DIFF channel.  Assembly is
    plain concatenation; a lost chunk surfaces exactly like a lost
    whole frame — a broken chain recovered by DIFF_REQ."""
    body_u8 = as_u8(body)
    cut = max(int(chunk_bytes), 1)
    count = max((body_u8.size + cut - 1) // cut, 1)
    msgs = []
    for idx in range(count):
        piece = body_u8[idx * cut:(idx + 1) * cut]
        out = np.empty(DIFF_CHUNK_HDR_BYTES + piece.size, np.uint8)
        out[:DIFF_CHUNK_HDR_BYTES].view(np.int64)[:] = (
            kind, from_version, to_version, head_version, piece.size,
            idx, count)
        out[DIFF_CHUNK_HDR_BYTES:] = piece
        msgs.append(out)
    return msgs


def parse_diff_chunk(payload) -> Tuple[int, int, int, int, int, int,
                                       np.ndarray]:
    """(kind, from_version, to_version, head_version, chunk_idx,
    chunk_count, body) from one chunked-subscription DIFF message."""
    raw = np.frombuffer(bytes(payload), np.uint8)
    if raw.size < DIFF_CHUNK_HDR_BYTES:
        raise ValueError(
            f"chunked DIFF message too short: {raw.size} bytes (need "
            f"the {DIFF_CHUNK_HDR_BYTES}-byte header)")
    kind, from_v, to_v, head, nbytes, idx, count = (
        int(x) for x in raw[:DIFF_CHUNK_HDR_BYTES].view(np.int64))
    if kind not in (DIFF_FULL, DIFF_DELTA):
        raise ValueError(f"unknown DIFF kind {kind}")
    body = raw[DIFF_CHUNK_HDR_BYTES:]
    if body.size != nbytes:
        raise ValueError(
            f"chunked DIFF body is {body.size} bytes but the header "
            f"promised {nbytes}")
    if not (0 <= idx < count):
        raise ValueError(f"chunk {idx} outside count {count}")
    return kind, from_v, to_v, head, idx, count, body


def xor_delta(frame_from: np.ndarray, frame_to: np.ndarray) -> np.ndarray:
    """The DELTA body: byte-wise XOR of two same-version-stream encoded
    frames.  Fails loudly on a size mismatch — frames of one (codec,
    shard) stream are fixed-size by construction."""
    a, b = as_u8(frame_from), as_u8(frame_to)
    if a.size != b.size:
        raise ValueError(
            f"encoded frames differ in size ({a.size} vs {b.size}) — "
            "not one snapshot stream")
    # Synchronous: delta production runs on the serve path (the server
    # answers DIFF_REQ inline).  The output is a fresh buffer an in-flight
    # send of an older delta can never see rewritten.  (The pool of slice
    # 5f takes this XOR over; the bytes stay the same.)
    out = np.empty(a.size, np.uint8)
    np.bitwise_xor(a, b, out=out)
    return out


def apply_delta(frame: np.ndarray, delta: np.ndarray) -> np.ndarray:
    """Install a DELTA: returns a FRESH frame (copy-on-write — a reply
    task may still hold a zero-copy view of the old one)."""
    a = as_u8(frame)
    if a.size != delta.size:
        raise ValueError(
            f"delta is {delta.size} bytes against a {a.size}-byte frame")
    # Synchronous: the caller sits inside the cell's no-yield install
    # window (cells/cell.py _install).
    out = np.empty(a.size, np.uint8)
    np.bitwise_xor(as_u8(delta), a, out=out)
    return out


def diff_req(epoch: int, seq: int, have_version: int) -> np.ndarray:
    """A fresh DIFF_REQ resync-request message."""
    return np.asarray([epoch, seq, have_version], dtype=np.int64)


def parse_diff_req(payload) -> Tuple[int, int, int]:
    """(epoch, seq, have_version) from a DIFF_REQ message."""
    words = np.frombuffer(bytes(payload), np.int64)
    if words.size != DIFF_REQ_WORDS:
        raise ValueError(
            f"DIFF_REQ must be {DIFF_REQ_WORDS} int64 words, got "
            f"{words.size}")
    return int(words[0]), int(words[1]), int(words[2])


def head_echo(epoch: int, seq: int, head_version: int) -> np.ndarray:
    """A fresh subscriber-heartbeat echo ([epoch, seq, head_version] on
    HEARTBEAT_ECHO — the head announcement, §11.3)."""
    return np.asarray([epoch, seq, head_version], dtype=np.int64)


class FrameHistory:
    """Bounded per-version store of encoded snapshot frames for ONE
    (codec, shard) stream — the diff producer's delta source.

    The server records the snapshot cache's frame per committed version
    it ships; ``delta(from, to)`` XORs two stored frames (memoized for
    the common every-cell-at-the-same-version case, so N same-codec
    cells share one XOR per committed version).  Versions older than
    ``keep`` evict — a subscriber further behind than the history
    receives a FULL frame instead, which is exactly the resync path it
    would need anyway.  Frames are stored by reference (the snapshot
    cache already allocates a fresh frame per version), so the history
    costs O(keep) references plus one delta buffer."""

    def __init__(self, keep: int = 16):
        if keep < 2:
            raise ValueError("history must keep >= 2 versions to diff")
        self.keep = int(keep)
        self._frames: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._delta: Optional[Tuple[int, int, np.ndarray]] = None

    def record(self, version: int, frame: np.ndarray) -> None:
        """Remember ``version``'s encoded frame (idempotent)."""
        if version in self._frames:
            return
        self._frames[version] = frame
        while len(self._frames) > self.keep:
            self._frames.popitem(last=False)

    def has(self, version: int) -> bool:
        return version in self._frames

    def frame(self, version: int) -> np.ndarray:
        return self._frames[version]

    def delta(self, from_version: int, to_version: int) -> np.ndarray:
        """The XOR delta between two recorded versions (memoized on the
        last computed pair)."""
        cached = self._delta
        if cached is not None and cached[0] == from_version \
                and cached[1] == to_version:
            return cached[2]
        body = xor_delta(self._frames[from_version],
                         self._frames[to_version])
        self._delta = (from_version, to_version, body)
        return body
