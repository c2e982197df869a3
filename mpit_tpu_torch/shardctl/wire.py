"""shardctl wire framing — shard-addressed op headers, status replies,
the INIT v4 announce, and MAP_UPDATE directives.

A copy of ``mpit_tpu/shardctl/wire.py``: the port imports
nothing of the JAX package.

With a mutable :class:`~mpit_tpu_torch.shardctl.shardmap.ShardMap`, the FT
``[epoch, seq]`` identity (ft/wire.py) is no longer enough: a server may
own several shards of one client (post-failover), and an op may land on
a server that no longer owns the addressed shard.  Shardctl framing
therefore extends the header and gives every reply a status word:

- **op header** (``SC_HDR_BYTES`` = 32): int64 ``[epoch, seq,
  map_version, shard_id]`` prefixes every GRAD / PARAM_PUSH frame and is
  the whole PARAM_REQ payload.  ``seq`` counts per (shard, tag) — the
  stream follows the *shard* through migrations, which is what lets the
  transferred dedup state keep admission exactly-once across owners.
- **replies** (acks and PARAM): int64 ``[epoch, seq, status, shard_id]``
  then the body.  ``OK`` acks are exactly the 32-byte header; an ``OK``
  PARAM reply appends the snapshot frame.  ``NACK_MAP`` means "I do not
  own that shard under my newer map" — the body is the server's
  serialized map, and the client installs it and re-routes (the retry
  machinery's NACK path; no hang, and the shard-scoped dedup state on
  the new owner makes the re-route at-most-once).  ``BUSY`` means "I own
  it but it is frozen mid-migration" — the client backs off and retries
  the same (or by then re-mapped) owner.

INIT v4 is length-distinguished from v1/v2/v3 like its predecessors,
with a ``-1`` sentinel where v1-v3 carry a nonneg shard offset: int64
``[-1, codec_id, epoch, flags, <map words>]``.  The announced map
replaces the per-pair ``[offset, size]`` — the server derives its owned
shards from it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from mpit_tpu_torch.shardctl.shardmap import ShardMap

#: int64 [epoch, seq, map_version, shard_id]
SC_HDR_BYTES = 32

#: INIT v3 flags bit2: this pair speaks shardctl framing (implies
#: FLAG_FRAMED — shardctl needs the retry/dedup machinery under it).
FLAG_SHARDCTL = 4

#: reply status words
OK = 0
NACK_MAP = 1  # not the owner any more; body = my (newer) serialized map
BUSY = 2  # owner, but the shard is frozen mid-migration; retry shortly
GOODBYE = 3  # serving tier (§9.4): this server is retiring; the reply's
#              word names the successor rank — re-attach there.  Never
#              sent on the shardctl data path (drained shards NACK).

#: MAP_UPDATE directive kinds (first word of the payload, then
#: [shard_id, peer_rank], then the serialized map)
INSTALL = 0  # adopt this map (client broadcast / src flip)
RELEASE = 1  # server: freeze shard_id, serve one SHARD_PULL from peer
ACQUIRE = 2  # server: pull shard_id's state from peer, then own it
ADOPT = 3  # server: restore shard_id from its checkpoint (peer is dead)
DONE = 4  # server -> controller: directive completed
RETIRE = 5  # controller -> server: your shards are drained — echo DONE
#             (shard_id -1) and exit cleanly (goodbye, not a crash)
RETIRED = 6  # controller -> clients/servers broadcast: rank ``peer``
#              left the gang on purpose; drop it from stop/beat targets
PREEMPT = 7  # server -> controller: preemption notice received —
#              ``shard_id`` carries the grace window in milliseconds;
#              the controller drains me if the window allows (§9.3)


def pack_sc_header(buf: np.ndarray, epoch: int, seq: int,
                   map_version: int, shard_id: int) -> None:
    """Write the 32-byte shardctl header into a uint8 staging buffer."""
    buf[:SC_HDR_BYTES].view(np.int64)[:] = (epoch, seq, map_version, shard_id)


def unpack_sc_header(buf: np.ndarray) -> Tuple[int, int, int, int]:
    """(epoch, seq, map_version, shard_id) from a uint8 buffer."""
    hdr = buf[:SC_HDR_BYTES].view(np.int64)
    return int(hdr[0]), int(hdr[1]), int(hdr[2]), int(hdr[3])


def sc_header(epoch: int, seq: int, map_version: int,
              shard_id: int) -> np.ndarray:
    """A fresh header-only message (PARAM_REQ)."""
    return np.asarray([epoch, seq, map_version, shard_id], dtype=np.int64)


def reply_frame(epoch: int, seq: int, status: int, shard_id: int,
                body: "np.ndarray | None" = None) -> np.ndarray:
    """A reply: ``[epoch, seq, status, shard_id]`` (+ body bytes)."""
    hdr = np.asarray([epoch, seq, status, shard_id], dtype=np.int64)
    if body is None:
        return hdr
    body_u8 = body.view(np.uint8) if body.dtype != np.uint8 else body
    out = np.empty(SC_HDR_BYTES + body_u8.size, np.uint8)
    out[:SC_HDR_BYTES] = hdr.view(np.uint8)
    out[SC_HDR_BYTES:] = body_u8
    return out


def parse_reply(payload: bytes) -> Tuple[int, int, int, int, bytes]:
    """(epoch, seq, status, shard_id, body) from a reply message."""
    if len(payload) < SC_HDR_BYTES:
        raise ValueError(f"shardctl reply too short: {len(payload)} bytes")
    hdr = np.frombuffer(payload[:SC_HDR_BYTES], np.int64)
    return (int(hdr[0]), int(hdr[1]), int(hdr[2]), int(hdr[3]),
            payload[SC_HDR_BYTES:])


def init_v4(codec_id: int, epoch: int, flags: int,
            smap: ShardMap) -> np.ndarray:
    """The INIT v4 announcement: sentinel, negotiation words, the map."""
    head = np.asarray([-1, codec_id, epoch, flags], dtype=np.int64)
    return np.concatenate([head, smap.to_wire()])


def parse_init_v4(raw: np.ndarray) -> Tuple[int, int, int, ShardMap]:
    """(codec_id, epoch, flags, map) from an INIT v4 int64 payload."""
    if raw.size < 8 or int(raw[0]) != -1:
        raise ValueError("payload is not an INIT v4 announcement")
    codec_id, epoch, flags = (int(x) for x in raw[1:4])
    return codec_id, epoch, flags, ShardMap.from_wire(raw[4:])


def map_update(kind: int, shard_id: int, peer: int,
               smap: ShardMap) -> np.ndarray:
    """A MAP_UPDATE directive: ``[kind, shard_id, peer, <map words>]``."""
    head = np.asarray([kind, shard_id, peer], dtype=np.int64)
    return np.concatenate([head, smap.to_wire()])


def parse_map_update(payload) -> Tuple[int, int, int, ShardMap]:
    """(kind, shard_id, peer, map) from a MAP_UPDATE payload."""
    words = (payload.view(np.int64) if isinstance(payload, np.ndarray)
             else np.frombuffer(payload, np.int64))
    if words.size < 7:
        raise ValueError(f"MAP_UPDATE too short: {words.size} words")
    kind, shard_id, peer = (int(x) for x in words[:3])
    return kind, shard_id, peer, ShardMap.from_wire(words[3:])
