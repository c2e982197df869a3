"""Flat-parameter shard layout across server ranks.

A copy of ``mpit_tpu/ps/sharding.py``: the equal split and the weighted cut
a :class:`~mpit_tpu_torch.shardctl.shardmap.ShardMap` builds on.  The port
imports nothing of the JAX package.

Mirrors the reference's split exactly (reference asyncsgd/pclient.lua:
111-129): the flat vector of length ``plong`` is cut into
``floor(plong / nservers)``-sized chunks, one per server in rank order,
with the **last** server taking the remainder.  Offsets here are 0-based
(the reference is 1-based Lua).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence


class Shard(NamedTuple):
    offset: int
    size: int

    @property
    def end(self) -> int:
        return self.offset + self.size


def shard_layout(plong: int, nservers: int) -> List[Shard]:
    if nservers < 1:
        raise ValueError("need at least one server")
    if plong < nservers:
        raise ValueError(
            f"cannot shard {plong} parameters across {nservers} servers "
            "(each server needs a nonempty shard)"
        )
    base = plong // nservers
    shards = [Shard(i * base, base) for i in range(nservers - 1)]
    last_offset = (nservers - 1) * base
    shards.append(Shard(last_offset, plong - last_offset))
    return shards


def weighted_layout(plong: int, weights: Sequence[float]) -> List[Shard]:
    """Contiguous shards sized proportionally to ``weights`` (one per
    server, in rank order), generalizing :func:`shard_layout` — equal
    weights reproduce its floor-sized cuts with the remainder in one
    shard, except the remainder goes to the *heaviest* server rather
    than positionally to the last.

    Invariants (property-tested): the shards tile ``[0, plong)`` exactly,
    every shard is nonempty, and shard ``i`` starts where ``i-1`` ends.
    Ties on the heaviest weight resolve to the lowest rank, so the
    layout is a pure function of its arguments.
    """
    n = len(weights)
    if n < 1:
        raise ValueError("need at least one weight")
    if plong < n:
        raise ValueError(
            f"cannot shard {plong} parameters across {n} servers "
            "(each server needs a nonempty shard)"
        )
    if any(w <= 0 for w in weights):
        raise ValueError(f"weights must be positive, got {list(weights)}")
    total = float(sum(weights))
    # Floor-proportional sizes with a floor of 1 element each; whatever
    # the floors leave over goes to the heaviest server in one piece.
    sizes = [max(1, int(plong * (w / total))) for w in weights]
    spare = plong - sum(sizes)
    heaviest = max(range(n), key=lambda i: (weights[i], -i))
    if spare < 0:
        # The 1-element floors overshot on tiny plong: shave the excess
        # off the heaviest shards that can give without going empty.
        for i in sorted(range(n), key=lambda i: -sizes[i]):
            give = min(-spare, sizes[i] - 1)
            sizes[i] -= give
            spare += give
            if spare == 0:
                break
    else:
        sizes[heaviest] += spare
    shards, offset = [], 0
    for size in sizes:
        shards.append(Shard(offset, size))
        offset += size
    return shards
