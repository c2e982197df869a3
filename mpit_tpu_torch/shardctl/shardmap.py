"""Versioned shard maps — placement as a first-class, mutable object.

A copy of ``mpit_tpu/shardctl/shardmap.py``: the port imports
nothing of the JAX package.

The seed protocol fixes shard placement at INIT time: ``shard_layout``
cuts the flat vector into equal contiguous slices, one per server rank,
forever.  A hot or slow server therefore throttles every client for the
whole run, and an evicted server's shard is unrecoverable without
restarting the same rank (the imbalanced-arrival pathology, PAPERS.md
arxiv 1804.05349).  A :class:`ShardMap` makes placement data, not
topology:

- every shard has a stable integer ``shard_id`` (its index in the
  initial cut — migration moves owners, never re-cuts);
- every map carries a **monotonic** ``version``; any mutation returns a
  new map with ``version + 1``;
- shards may be unequal (:func:`mpit_tpu_torch.ps.sharding.weighted_layout`)
  and a server may own zero, one, or many shards.

Clients stamp every framed op with their map version; a server that no
longer owns the addressed shard replies ``NACK_MAP`` carrying its newer
map (shardctl/wire.py), which is the entire client-side coherence
protocol — there is no map lock, and a client can never act on a map
older than the one the serving server holds.

The wire form is a flat int64 vector (``to_wire``/``from_wire``) so the
map travels inside NACKs, MAP_UPDATE directives, and INIT v4 announces
over the existing transports.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from mpit_tpu_torch.ps.sharding import Shard, shard_layout, weighted_layout

#: first word of every serialized map (guards against misrouted frames)
MAP_MAGIC = 0x534D4150  # "SMAP"


class ShardEntry(NamedTuple):
    shard_id: int
    shard: Shard
    owner: int  # server rank


class ShardMap:
    """An immutable shard→server assignment with a monotonic version."""

    __slots__ = ("version", "plong", "entries", "_by_id")

    def __init__(self, version: int, plong: int,
                 entries: Sequence[ShardEntry]):
        self.version = int(version)
        self.plong = int(plong)
        self.entries: tuple = tuple(entries)
        self._by_id: Dict[int, ShardEntry] = {
            e.shard_id: e for e in self.entries}
        if len(self._by_id) != len(self.entries):
            raise ValueError("duplicate shard_id in map")
        covered = sorted(self.entries, key=lambda e: e.shard.offset)
        pos = 0
        for e in covered:
            if e.shard.offset != pos or e.shard.size <= 0:
                raise ValueError(
                    f"shards must tile [0, plong) contiguously; entry "
                    f"{e.shard_id} covers [{e.shard.offset}, {e.shard.end})"
                    f" but {pos} elements are assigned so far")
            pos = e.shard.end
        if pos != self.plong:
            raise ValueError(
                f"shards cover {pos} of {self.plong} elements")

    # -- constructors --------------------------------------------------------

    @classmethod
    def initial(cls, plong: int, server_ranks: Sequence[int],
                weights: Optional[Sequence[float]] = None) -> "ShardMap":
        """Version-0 map: one shard per server in rank order — the seed
        layout (equal cuts via ``shard_layout``; ``weights`` switches to
        ``weighted_layout``)."""
        ranks = list(server_ranks)
        if weights is None:
            shards = shard_layout(plong, len(ranks))
        else:
            if len(weights) != len(ranks):
                raise ValueError(
                    f"{len(weights)} weights for {len(ranks)} servers")
            shards = weighted_layout(plong, weights)
        return cls(0, plong, [
            ShardEntry(i, shard, rank)
            for i, (shard, rank) in enumerate(zip(shards, ranks))
        ])

    @classmethod
    def from_shards(cls, shards, server_ranks: Sequence[int],
                    *, version: int = 0) -> "ShardMap":
        """A map over an explicit pre-cut shard list (one owner per
        shard, in order) — the entry point for externally computed
        layouts.  The constructor's tiling validation still applies."""
        shards = list(shards)
        ranks = list(server_ranks)
        if len(shards) != len(ranks):
            raise ValueError(
                f"{len(shards)} shards for {len(ranks)} owners")
        plong = max(s.end for s in shards)
        return cls(version, plong, [
            ShardEntry(i, shard, rank)
            for i, (shard, rank) in enumerate(zip(shards, ranks))
        ])

    def moved(self, shard_id: int, new_owner: int) -> "ShardMap":
        """The same cut with ``shard_id`` reassigned; version + 1."""
        if shard_id not in self._by_id:
            raise KeyError(f"no shard {shard_id} in map v{self.version}")
        return ShardMap(self.version + 1, self.plong, [
            e._replace(owner=new_owner) if e.shard_id == shard_id else e
            for e in self.entries
        ])

    def reassigned(self, dead_rank: int,
                   survivors: Sequence[int]) -> "ShardMap":
        """Failover map: every shard owned by ``dead_rank`` moves to a
        survivor, spreading round-robin over ``survivors`` ordered by
        current shard count (fewest first); version + 1."""
        if not survivors:
            raise ValueError("no survivors to fail over to")
        load = {r: len(self.shards_of(r)) for r in survivors}
        entries = []
        for e in self.entries:
            if e.owner == dead_rank:
                target = min(load, key=lambda r: (load[r], r))
                load[target] += 1
                e = e._replace(owner=target)
            entries.append(e)
        return ShardMap(self.version + 1, self.plong, entries)

    # -- queries -------------------------------------------------------------

    def entry(self, shard_id: int) -> ShardEntry:
        return self._by_id[shard_id]

    def owner(self, shard_id: int) -> int:
        return self._by_id[shard_id].owner

    def shards_of(self, rank: int) -> List[ShardEntry]:
        return [e for e in self.entries if e.owner == rank]

    def owners(self) -> List[int]:
        """Distinct owning ranks, ascending."""
        return sorted({e.owner for e in self.entries})

    def max_shard_size(self) -> int:
        return max(e.shard.size for e in self.entries)

    def __eq__(self, other) -> bool:
        return (isinstance(other, ShardMap)
                and self.version == other.version
                and self.plong == other.plong
                and self.entries == other.entries)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        own = {e.shard_id: e.owner for e in self.entries}
        return f"ShardMap(v{self.version}, plong={self.plong}, {own})"

    # -- wire form -----------------------------------------------------------

    def to_wire(self) -> np.ndarray:
        """int64 ``[MAGIC, version, plong, n, (id, offset, size, owner)*n]``."""
        words = [MAP_MAGIC, self.version, self.plong, len(self.entries)]
        for e in self.entries:
            words += [e.shard_id, e.shard.offset, e.shard.size, e.owner]
        return np.asarray(words, dtype=np.int64)

    @classmethod
    def from_wire(cls, raw) -> "ShardMap":
        if isinstance(raw, np.ndarray):
            words = raw.view(np.int64).ravel()
        else:
            words = np.frombuffer(raw, dtype=np.int64)
        if words.size < 4 or int(words[0]) != MAP_MAGIC:
            raise ValueError("payload is not a serialized ShardMap")
        version, plong, n = (int(x) for x in words[1:4])
        if words.size != 4 + 4 * n:
            raise ValueError(
                f"truncated ShardMap: {words.size} words for {n} entries")
        entries = []
        for i in range(n):
            sid, off, size, owner = (int(x) for x in words[4 + 4 * i: 8 + 4 * i])
            entries.append(ShardEntry(sid, Shard(off, size), owner))
        return cls(version, plong, entries)

    @property
    def wire_nbytes(self) -> int:
        return 8 * (4 + 4 * len(self.entries))
