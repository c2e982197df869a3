"""Live shard migration — the state that moves, and how it travels.

The port of ``mpit_tpu/shardctl/migrate.py``.  A slot's ``param`` and
``rule_state`` are torch tensors on the server's device (the card by
default); everything that crosses a wire or a file is host numpy, so the
SHARD_STATE messages and ``shard<id>_latest.npz`` are the JAX package's
bytes and either package adopts the other's shards:

- ``snapshot_host`` / ``pack_shard_state`` copy card -> host with a
  synchronous ``.to("cpu")`` on the copying thread's current stream.  The
  server applies K3 on that same thread and stream (the scheduler runs
  every service of one server on one thread), so the copy is ordered
  after the slot's last apply and returns only once the bytes are on the
  host; a RELEASE freezes the slot first, so no apply can follow it.
- ``recv_shard_state`` / ``load_shard_state`` return host arrays (owned
  copies, never a view of a transport buffer); the server places them on
  its device with fresh storage per slot (``ParamServer._owned``).
- Adam's step counter ``t`` keeps the JAX layout: a 0-d int32 array.

A shard is more than its parameter slice: exact handoff needs the
optimizer (rule) state, the snapshot version counter, and — critically —
the shard-scoped dedup table, because a client may be mid-retry of an op
the old owner already applied.  Transferring the dedup horizon with the
shard is what turns "re-route on NACK" into at-most-once delivery across
owners: the retried frame admits as DUP on the new owner and is re-acked
without a second apply, so a migrated run stays bitwise equal to a
static-map run.

Three pieces live here, all reused by both the live handshake
(RELEASE/ACQUIRE over SHARD_PULL/SHARD_STATE, docs/PROTOCOL.md §7.3) and
the failover path (ADOPT from checkpoint, §7.5):

- :class:`ShardSlot` — one owned shard on a server: device param +
  rule state, the per-codec encoded snapshot cache (the PR 2 cache,
  made per-slot), freeze flag, and the shard-scoped dedup table.
- ``pack_shard_state`` / ``recv_shard_state`` — the SHARD_STATE wire
  sequence: one JSON meta message, then the param bytes (reusing the
  snapshot cache's device→host copy), then one message per rule-state
  array.  All raw little-endian bytes on one FIFO channel; sizes are in
  the meta, so the receiver allocates exactly.
- ``save_shard_state`` / ``load_shard_state`` — shard-oriented
  checkpoints (``shard<id>_latest.npz``), written by whichever server
  currently owns the shard.  Failover restores from these, keyed by
  shard — the replacement owner does not need the dead rank's name in
  the filename.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from mpit_tpu_torch.aio import aio_recv
from mpit_tpu_torch.ft import DedupTable
from mpit_tpu_torch.utils.checkpoint import (
    _pack_array,
    _stamped_atomic_publish,
    _unpack_array,
)

#: per-step deadline for migration-protocol transfers (SHARD_PULL /
#: SHARD_STATE / directive echoes).  Generous: a shard transfer moves
#: real bytes; but bounded: a dead peer mid-migration must surface as a
#: loud DeadlineExceeded, never a wedged server.
SC_DEADLINE_S = float(os.environ.get("MPIT_SC_DEADLINE_S", "60"))

#: chunk cut for the SHARD_STATE param-byte leg (ROADMAP item 1 / §12's
#: streaming applied to migration): a big shard's bytes ship as
#: ceil(n/chunk) messages on the same FIFO channel instead of one, so
#: the wire moves chunk k while the source stages k+1 and the whole
#: transfer never sits behind a single monolithic send — the freeze
#: window shrinks to roughly one chunk of latency plus the wire time.
#: The chunk list travels in the meta JSON, so both sides agree without
#: negotiation and a small shard (or 0 = disabled) keeps the original
#: single-message wire byte-for-byte.
SC_CHUNK_BYTES = int(os.environ.get("MPIT_SC_CHUNK_BYTES",
                                    str(4 << 20)))


def host_copy(value: Any) -> np.ndarray:
    """An owned host array of ``value`` (a tensor on any device, or an
    array): the device->host copy is synchronous on the current stream."""
    if hasattr(value, "detach"):
        return value.detach().to("cpu", copy=True).numpy()
    return np.array(value, copy=True)


class ShardSlot:
    """One owned shard on a server: device state + serving caches."""

    __slots__ = ("shard_id", "offset", "size", "param", "rule_state",
                 "dedup", "frozen", "snap_version", "_snap_host",
                 "_snap_wire", "grads_applied")

    def __init__(self, shard_id: int, offset: int, size: int):
        self.shard_id = shard_id
        self.offset = offset
        self.size = size
        self.param: Any = None  # a tensor on the server's device
        self.rule_state: Optional[Dict[str, Any]] = None
        self.dedup = DedupTable()
        self.frozen = False
        self.snap_version = 0
        self._snap_host: Optional[Tuple[int, np.ndarray]] = None
        self._snap_wire: Dict[str, Tuple[int, np.ndarray]] = {}
        self.grads_applied = 0

    def committed(self) -> None:
        """A new shard version exists (grad applied / seeded / restored)."""
        self.snap_version += 1

    def snapshot_host(self) -> np.ndarray:
        """The current version's device→host copy, cached per version: an
        owned array (K3 updates the slot's tensor in place, so a view of
        it would change under a frame still in flight)."""
        if self._snap_host is None or self._snap_host[0] != self.snap_version:
            self._snap_host = (self.snap_version, host_copy(self.param))
        return self._snap_host[1]

    def snapshot_wire(self, codec) -> Tuple[np.ndarray, bool]:
        """(current version's encoded PARAM frame for ``codec``, was it a
        cache hit) — the PR 2 snapshot cache, scoped to this slot."""
        version = self.snap_version
        cached = self._snap_wire.get(codec.name)
        if cached is not None and cached[0] == version:
            return cached[1], True
        host = self.snapshot_host()
        if codec.identity:
            wire = host
        else:
            wire = np.empty(codec.wire_nbytes(self.size), np.uint8)
            codec.encode_into(host, wire)
        self._snap_wire[codec.name] = (version, wire)
        return wire, False


# ---------------------------------------------------------------------------
# SHARD_STATE wire sequence


def pack_shard_state(slot: ShardSlot,
                     chunk_bytes: Optional[int] = None) -> List[np.ndarray]:
    """The SHARD_STATE message sequence for one frozen slot: meta JSON,
    param bytes (as chunk messages when the shard exceeds the chunk
    cut — zero-copy views of the snapshot, so chunking costs nothing),
    then each rule-state array in meta key order."""
    host = slot.snapshot_host()
    cut = SC_CHUNK_BYTES if chunk_bytes is None else int(chunk_bytes)
    state = dict(slot.rule_state or {})
    state_np = {k: host_copy(v) for k, v in state.items()}
    pbytes = host.view(np.uint8).reshape(-1)
    chunks: List[np.ndarray] = []
    if cut > 0 and pbytes.size > cut:
        chunks = [pbytes[lo:lo + cut]
                  for lo in range(0, pbytes.size, cut)]
    meta = {
        "shard_id": slot.shard_id,
        "offset": slot.offset,
        "size": slot.size,
        "snap_version": slot.snap_version,
        "grads_applied": slot.grads_applied,
        "dedup": slot.dedup.state(),
        "param_dtype": str(host.dtype),
        "state_keys": sorted(state_np),
        "state_dtypes": {k: str(v.dtype) for k, v in state_np.items()},
        "state_shapes": {k: list(v.shape) for k, v in state_np.items()},
    }
    if chunks:
        # Both sides derive the assembly from the meta — no negotiation,
        # and an unchunked sequence stays byte-for-byte the legacy wire.
        meta["param_chunks"] = [int(c.size) for c in chunks]
    msgs = [np.frombuffer(json.dumps(meta).encode(), np.uint8)]
    msgs.extend(chunks if chunks else [pbytes])
    for key in meta["state_keys"]:
        arr = np.ascontiguousarray(state_np[key])
        msgs.append(arr.view(np.uint8).reshape(-1))
    return msgs


def recv_shard_state(transport, src: int, live, deadline=None, abort=None):
    """Generator: receive one SHARD_STATE sequence from ``src``; returns
    a host-side :class:`ShardSlot` (device placement is the caller's —
    the server moves param/state onto its backend) or None on abort."""
    from mpit_tpu_torch.ps import tags
    from mpit_tpu_torch.utils.serialize import resolve_dtype

    raw = yield from aio_recv(transport, src, tags.SHARD_STATE, live=live,
                              deadline=deadline, abort=abort)
    if raw is None:
        return None
    meta = json.loads(bytes(raw).decode())
    slot = ShardSlot(int(meta["shard_id"]), int(meta["offset"]),
                     int(meta["size"]))
    slot.snap_version = int(meta["snap_version"])
    slot.grads_applied = int(meta["grads_applied"])
    slot.dedup.restore(meta.get("dedup") or {})
    pdtype = resolve_dtype(meta["param_dtype"])
    chunk_sizes = meta.get("param_chunks")
    if chunk_sizes:
        # Chunked param leg: assemble in arrival order (one FIFO
        # channel — order is the transport's) into exactly-sized
        # staging; bit-identity with the unchunked wire is plain
        # concatenation.
        buf = np.empty(sum(int(n) for n in chunk_sizes), np.uint8)
        at = 0
        for nbytes in chunk_sizes:
            raw = yield from aio_recv(transport, src, tags.SHARD_STATE,
                                      live=live, deadline=deadline,
                                      abort=abort)
            if raw is None:
                return None
            view = np.frombuffer(bytes(raw), np.uint8)
            if view.size != int(nbytes):
                raise ValueError(
                    f"SHARD_STATE chunk size mismatch: expected {nbytes}"
                    f" bytes, got {view.size}")
            buf[at:at + view.size] = view
            at += view.size
        slot.param = buf.view(pdtype).copy()
    else:
        raw = yield from aio_recv(transport, src, tags.SHARD_STATE,
                                  live=live, deadline=deadline,
                                  abort=abort)
        if raw is None:
            return None
        slot.param = np.frombuffer(bytes(raw), pdtype).copy()
    state: Dict[str, np.ndarray] = {}
    for key in meta["state_keys"]:
        raw = yield from aio_recv(transport, src, tags.SHARD_STATE,
                                  live=live, deadline=deadline, abort=abort)
        if raw is None:
            return None
        dtype = resolve_dtype(meta["state_dtypes"][key])
        shape = tuple(meta["state_shapes"][key])
        state[key] = np.frombuffer(bytes(raw), dtype).reshape(shape).copy()
    slot.rule_state = state or None
    return slot


# ---------------------------------------------------------------------------
# shard-oriented checkpoints (the failover substrate)


def save_shard_state(directory, slot: ShardSlot, rank: int,
                     keep: int = 3) -> pathlib.Path:
    """Checkpoint one slot as ``shard<id>_<ms>.npz`` + the ``_latest``
    alias (the stamped atomic-publish path from utils/checkpoint.py).
    Keyed by *shard*, not server: any surviving rank directed to ADOPT
    the shard opens the same alias regardless of who wrote it."""
    payload: Dict[str, Any] = {}
    _pack_array("param", slot.snapshot_host(), payload)
    state = {k: host_copy(v) for k, v in (slot.rule_state or {}).items()}
    for key, value in state.items():
        _pack_array(f"state_{key}", value, payload)
    payload["meta"] = json.dumps({
        "shard_id": slot.shard_id, "rank": rank,
        "offset": slot.offset, "size": slot.size,
        "snap_version": slot.snap_version,
        "grads_applied": slot.grads_applied,
        "dedup": slot.dedup.state(),
        "state_keys": sorted(state),
    })
    prefix = f"shard{slot.shard_id}"
    path = _stamped_atomic_publish(directory, prefix, payload)
    if keep > 0:
        stamped = sorted(
            p for p in pathlib.Path(directory).glob(f"{prefix}_*.npz")
            if p.name[len(prefix) + 1: -len(".npz")].isdigit()
        )
        for old in stamped[:-keep]:
            old.unlink(missing_ok=True)
    return path


def load_shard_state(directory, shard_id: int) -> ShardSlot:
    """Restore a slot (host-side arrays) from ``shard<id>_latest.npz``."""
    path = pathlib.Path(directory) / f"shard{shard_id}_latest.npz"
    if not path.exists():
        raise FileNotFoundError(
            f"no checkpoint for shard {shard_id}: {path} (failover needs "
            "the owning server to have been checkpointing — ckpt_dir)"
        )
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        slot = ShardSlot(int(meta["shard_id"]), int(meta["offset"]),
                         int(meta["size"]))
        slot.snap_version = int(meta["snap_version"])
        slot.grads_applied = int(meta["grads_applied"])
        slot.dedup.restore(meta.get("dedup") or {})
        slot.param = _unpack_array("param", z)
        state = {key: _unpack_array(f"state_{key}", z)
                 for key in meta["state_keys"]}
        slot.rule_state = state or None
    return slot
