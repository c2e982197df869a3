"""FT wire framing — the [epoch, seq] header and the INIT v3 announce.

A copy of ``mpit_tpu/ft/wire.py``: the port imports nothing of the JAX
package.

Every fault-tolerant retransmission question reduces to "has this exact
op already been applied?", and the answer needs an identity on the wire.
The identity is ``(client rank, epoch, seq)``:

- **epoch** — the client's incarnation number.  A restarted worker
  re-announces with ``epoch + 1``; anything still in flight from the
  dead incarnation is recognizably stale.
- **seq** — a per-(server, tag) counter on the client.  A retried op
  resends the *same* seq, so the server can apply-at-most-once and
  re-ack, and the client can match acks/replies to the attempt it is
  actually waiting on (a stale duplicate ack must never satisfy a newer
  op's wait — that would turn one dropped message into a lost update).

Framed messages prepend ``HDR_BYTES`` of int64 ``[epoch, seq]`` to the
codec frame; acks and read requests are exactly the 16-byte header.  The
header travels *inside* the message (one transport send), so a fault
injected at message granularity drops or duplicates the header and its
payload atomically — there is no torn header/payload state to recover.

Framing is negotiated per client<->server pair in INIT v3 (40 bytes:
``[offset, size, codec_id, epoch, flags]``) and costs one staging copy
per identity-codec frame, which is why it is opt-in (``FLAG_FRAMED``):
heartbeat-only deployments keep the zero-copy legacy frames.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

#: int64 [epoch, seq]
HDR_BYTES = 16

#: int64 [epoch, seq, version] — the staleness-tracking header
#: extension (FLAG_STALENESS): GRAD/PARAM_PUSH frames carry the param
#: version the client last computed against in the third word, and
#: PARAM replies carry the snapshot's version there, so the server can
#: measure gradient staleness (version applied-on minus version
#: computed-against) without any extra messages.  Acks and PARAM_REQ
#: stay 16 bytes — they never need a version slot.
HDR_STALE_BYTES = 24

#: INIT v3 flags bit0: GRAD/PARAM/PARAM_PUSH frames (and their acks /
#: read requests) carry the [epoch, seq] header for this pair.
FLAG_FRAMED = 1

#: INIT v3 flags bit1: this client will send HEARTBEAT beacons — the
#: server may arm a lease for it.  Kept separate from FLAG_FRAMED so a
#: server with a TTL configured never evicts a client that never
#: promised to beat (legacy ranks, framed-but-heartbeatless tests).
FLAG_HEARTBEAT = 2

#: INIT v3 flags bit2: this pair's GRAD/PARAM_PUSH/PARAM frames use the
#: 24-byte [epoch, seq, version] header (HDR_STALE_BYTES) — the
#: gradient-staleness telemetry extension.  Negotiated per pair exactly
#: like framing: a legacy announcement (v1/v2, or v3 without the bit)
#: keeps the 16-byte wire byte-for-byte, and the flag is only
#: meaningful alongside FLAG_FRAMED (staleness needs the op identity).
FLAG_STALENESS = 4

#: INIT v3 flags bit3: the causal-timing extension (docs/PROTOCOL.md
#: §6.7).  Client→server frames append one int64 word — the client's
#: wall-µs send stamp (re-stamped per retry attempt) — and every ack /
#: reply grows a three-word tail ``[t_tx_echo, t_recv, t_ack]``: the
#: echoed client stamp plus the server's receive and ack-send stamps.
#: Echoing t_tx is what makes the NTP exchange retry-safe: the tail
#: pairs with the *attempt the server actually saw*, and a stale
#: pairing just looks slow to the minimum-RTT filter (obs/clock.py).
#: Negotiated per pair like the other bits; requires FLAG_FRAMED and is
#: off under shardctl (the 32-byte shard header has no stamp slot).
FLAG_TIMING = 8

#: INIT v3 flags bit4: READ-ONLY attach (the serving tier,
#: docs/PROTOCOL.md §8).  The announcing client is a *reader*: it will
#: only ever send PARAM_REQ / HEARTBEAT / STOP, so the server allocates
#: no gradient or push staging for it, spawns only the read service,
#: and answers its reads with status-framed replies — int64
#: ``[epoch, seq, status, word]`` then (status OK only) the snapshot
#: frame as its own message, where ``word`` is the snapshot version on
#: OK and the retry hint in microseconds on BUSY (admission control).
#: Requires FLAG_FRAMED (the reply echoes the request identity);
#: readers attach lazily at any point mid-run and may re-announce like
#: a rejoining incarnation.
FLAG_READONLY = 16

#: INIT v3 flags bit5: SUBSCRIBE attach (the multi-cell serving fabric,
#: docs/PROTOCOL.md §11).  The announcing peer is a *replica cell*: a
#: follower serving rank that will never send GRAD/PARAM_PUSH and never
#: request PARAM reads — instead the server streams it the committed
#: version sequence on the DIFF channel (full encoded snapshot on
#: attach, then per-version deltas out of the snapshot cache), and the
#: cell serves READ-ONLY reader traffic from its own installed copy
#: under a declared staleness bound.  Extends the §8 READ-ONLY
#: handshake: FLAG_SUBSCRIBE requires FLAG_READONLY | FLAG_FRAMED, and
#: the subscriber's HEARTBEAT beacons are answered with a 3-word
#: [epoch, seq, head_version] echo so its view of the head version
#: never depends on the (possibly delayed) diff stream itself.
FLAG_SUBSCRIBE = 32

#: INIT v3 flags bit6: pipelined streaming transfers (docs/PROTOCOL.md
#: §12).  A GRAD / PARAM / PARAM_PUSH body ships as K independent chunk
#: frames — each its own transport message with its own
#: ``[epoch, seq, chunk_idx, chunk_count]`` header — so the three
#: serialized phases of a big shard op (encode, wire, apply) overlap:
#: the server decodes+applies chunk *k* while chunk *k+1* is on the
#: wire and the client encodes chunk *k+2* into staging.  Chunks cut on
#: the int8 codec's 1024-element block boundaries, so each chunk frame
#: is bit-identical to the corresponding region of the unchunked frame
#: and the error-feedback residual folds exactly once per block.
#: Requires FLAG_FRAMED (retry resends *missing chunks only*, dedup is
#: per (op, chunk)); announced via INIT v5 (48 bytes — the chunk size
#: travels in the announcement); negotiates FLAG_STALENESS off (the
#: chunked PARAM reply header carries the version in its own word) and
#: composes with FLAG_TIMING; off under shardctl and for READONLY /
#: SUBSCRIBE postures.
FLAG_CHUNKED = 64

#: the timing tail: int64 [t_tx_echo_us, t_recv_us, t_ack_us]
TIMING_TAIL_WORDS = 3
TIMING_TAIL_BYTES = 8 * TIMING_TAIL_WORDS

#: timing acks (GRAD_ACK / PARAM_PUSH_ACK / HEARTBEAT_ECHO): int64
#: [epoch, seq, t_tx_echo, t_recv, t_ack]
ACK_TIMING_WORDS = 5

#: chunked data-frame header: int64 [epoch, seq, chunk_idx, chunk_count]
CHUNK_HDR_BYTES = 32

#: chunked acks: int64 [epoch, seq, chunk_idx] — one ack per admitted
#: chunk, which is what lets a retry resend only the chunks whose acks
#: never arrived.  FLAG_TIMING appends the usual three-word tail.
CHUNK_ACK_WORDS = 3
CHUNK_ACK_TIMING_WORDS = CHUNK_ACK_WORDS + TIMING_TAIL_WORDS

#: chunked PARAM replies: int64 [epoch, seq, chunk_idx, chunk_count,
#: version] — every chunk stamps the snapshot version it was cut from,
#: so the client assembles exactly one version even when a retried
#: request is answered at a newer head (§12.4).
CHUNK_REPLY_WORDS = 5


def hdr_bytes(stale: bool, timing: bool) -> int:
    """Client→server data-frame header size for a negotiated pair:
    [epoch, seq] (+version under FLAG_STALENESS) (+t_tx under
    FLAG_TIMING, always the last word)."""
    return HDR_BYTES + (8 if stale else 0) + (8 if timing else 0)


def reply_hdr_bytes(stale: bool, timing: bool) -> int:
    """PARAM-reply header size: [epoch, seq] (+version) (+ the
    three-word timing tail)."""
    return HDR_BYTES + (8 if stale else 0) + \
        (TIMING_TAIL_BYTES if timing else 0)


def pack_header(buf: np.ndarray, epoch: int, seq: int) -> None:
    """Write the [epoch, seq] header into the first HDR_BYTES of a uint8
    staging buffer."""
    buf[:HDR_BYTES].view(np.int64)[:] = (epoch, seq)


def unpack_header(buf: np.ndarray) -> Tuple[int, int]:
    """(epoch, seq) from the first HDR_BYTES of a uint8 buffer."""
    hdr = buf[:HDR_BYTES].view(np.int64)
    return int(hdr[0]), int(hdr[1])


def pack_version(buf: np.ndarray, version: int) -> None:
    """Write the staleness extension's version word (bytes 16..24 of a
    uint8 staging buffer whose pair negotiated FLAG_STALENESS)."""
    buf[HDR_BYTES:HDR_STALE_BYTES].view(np.int64)[0] = version


def unpack_version(buf: np.ndarray) -> int:
    """The version word of a 24-byte staleness header."""
    return int(buf[HDR_BYTES:HDR_STALE_BYTES].view(np.int64)[0])


def pack_tx_stamp(buf: np.ndarray, hdr: int, t_us: int) -> None:
    """Write the FLAG_TIMING send stamp into the *last* header word of a
    uint8 staging buffer whose header is ``hdr`` bytes (ft retries
    re-stamp this word per attempt — the body bytes stay identical)."""
    buf[hdr - 8:hdr].view(np.int64)[0] = t_us


def unpack_tx_stamp(buf: np.ndarray, hdr: int) -> int:
    """The send-stamp word of a timing header (see pack_tx_stamp)."""
    return int(buf[hdr - 8:hdr].view(np.int64)[0])


def pack_reply_stamps(buf: np.ndarray, base: int, t_tx: int, t_recv: int,
                      t_ack: int) -> None:
    """Write the three-word timing tail of a PARAM reply at byte offset
    ``base`` (= 16, or 24 when the pair also tracks staleness)."""
    buf[base:base + TIMING_TAIL_BYTES].view(np.int64)[:] = (
        t_tx, t_recv, t_ack)


def unpack_reply_stamps(buf: np.ndarray, base: int):
    """(t_tx_echo, t_recv, t_ack) from a PARAM reply's timing tail."""
    tail = buf[base:base + TIMING_TAIL_BYTES].view(np.int64)
    return int(tail[0]), int(tail[1]), int(tail[2])


def header_frame(epoch: int, seq: int) -> np.ndarray:
    """A fresh 16-byte header-only message (acks, PARAM_REQ, HEARTBEAT)."""
    return np.asarray([epoch, seq], dtype=np.int64)


def timed_frame(epoch: int, seq: int, t_us: int) -> np.ndarray:
    """A 24-byte [epoch, seq, t_tx] message — FLAG_TIMING PARAM_REQ and
    HEARTBEAT beacons."""
    return np.asarray([epoch, seq, t_us], dtype=np.int64)


def init_v3(offset: int, size: int, codec_id: int, epoch: int,
            flags: int) -> np.ndarray:
    """The 40-byte INIT v3 announcement payload."""
    return np.asarray([offset, size, codec_id, epoch, flags], dtype=np.int64)


def init_v5(offset: int, size: int, codec_id: int, epoch: int, flags: int,
            chunk_elems: int) -> np.ndarray:
    """The 48-byte INIT v5 announcement: v3 plus the chunk cut (elements
    per chunk) for FLAG_CHUNKED pairs — both sides must derive identical
    chunk layouts, so the cut travels in the announcement."""
    return np.asarray([offset, size, codec_id, epoch, flags, chunk_elems],
                      dtype=np.int64)


# -- chunked streaming (FLAG_CHUNKED, docs/PROTOCOL.md §12) ------------------

#: chunk cuts land on the int8 codec's quantization-block boundaries so
#: each chunk is an independent codec frame bit-identical to the same
#: region of the unchunked frame (comm/codec.py BLOCK).
CHUNK_BLOCK = 1024


def chunk_elems_for(chunk_bytes: int, itemsize: int) -> int:
    """The block-aligned chunk cut (in elements) for a requested chunk
    size in bytes: floor to a CHUNK_BLOCK multiple, never below one
    block.  Pure function of (bytes, dtype) — both sides agree because
    the client announces the result, not the request."""
    elems = max(int(chunk_bytes) // int(itemsize), CHUNK_BLOCK)
    return max(elems // CHUNK_BLOCK, 1) * CHUNK_BLOCK


def chunk_spans(size: int, chunk_elems: int):
    """The [lo, hi) element spans of a ``size``-element shard cut at
    ``chunk_elems``: every span but the last is exactly chunk_elems and
    starts on a block boundary; the last takes the remainder."""
    if size <= 0:
        return [(0, 0)]
    return [(lo, min(lo + chunk_elems, size))
            for lo in range(0, size, chunk_elems)]


def chunk_stride(hdr: int, body: int) -> int:
    """The uniform per-chunk frame size for a (header, full-chunk body)
    pair, rounded up to 64 bytes: every chunk message — the last one
    padded — is exactly this long, so both sides receive into
    fixed-size staging and every embedded int64/float32 view stays
    aligned whatever the codec's frame arithmetic produced."""
    return (hdr + body + 63) // 64 * 64


def chunk_hdr_bytes(timing: bool) -> int:
    """Chunked data-frame header size: [epoch, seq, chunk_idx,
    chunk_count] (+ the t_tx stamp, always the last word, under
    FLAG_TIMING — pack_tx_stamp/unpack_tx_stamp work unchanged)."""
    return CHUNK_HDR_BYTES + (8 if timing else 0)


def chunk_reply_hdr_bytes(timing: bool) -> int:
    """Chunked PARAM-reply header size: [epoch, seq, chunk_idx,
    chunk_count, version] (+ the three-word timing tail)."""
    return 8 * CHUNK_REPLY_WORDS + (TIMING_TAIL_BYTES if timing else 0)


def pack_chunk_header(buf: np.ndarray, epoch: int, seq: int, idx: int,
                      count: int) -> None:
    """Write the chunked data-frame header into the first CHUNK_HDR_BYTES
    of a uint8 staging frame."""
    buf[:CHUNK_HDR_BYTES].view(np.int64)[:] = (epoch, seq, idx, count)


def unpack_chunk_header(buf: np.ndarray) -> Tuple[int, int, int, int]:
    """(epoch, seq, chunk_idx, chunk_count) from a chunked data frame."""
    hdr = buf[:CHUNK_HDR_BYTES].view(np.int64)
    return int(hdr[0]), int(hdr[1]), int(hdr[2]), int(hdr[3])


def pack_chunk_reply(buf: np.ndarray, epoch: int, seq: int, idx: int,
                     count: int, version: int) -> None:
    """Write the chunked PARAM-reply header (the version word makes
    cross-retry assembly single-version, §12.4)."""
    buf[:8 * CHUNK_REPLY_WORDS].view(np.int64)[:] = (
        epoch, seq, idx, count, version)


def unpack_chunk_reply(buf: np.ndarray) -> Tuple[int, int, int, int, int]:
    """(epoch, seq, chunk_idx, chunk_count, version) from a chunked
    PARAM reply."""
    hdr = buf[:8 * CHUNK_REPLY_WORDS].view(np.int64)
    return (int(hdr[0]), int(hdr[1]), int(hdr[2]), int(hdr[3]),
            int(hdr[4]))


def chunk_ack_frame(epoch: int, seq: int, idx: int) -> np.ndarray:
    """A fresh 24-byte chunk ack (non-timing pairs)."""
    return np.asarray([epoch, seq, idx], dtype=np.int64)
