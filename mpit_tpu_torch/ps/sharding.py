"""Flat-parameter shard layout across server ranks.

A copy of ``shard_layout`` of ``mpit_tpu/ps/sharding.py`` (the weighted cut is
the LM slice's).  The port imports nothing of the JAX package.

Mirrors the reference's split exactly (reference asyncsgd/pclient.lua:
111-129): the flat vector of length ``plong`` is cut into
``floor(plong / nservers)``-sized chunks, one per server in rank order,
with the **last** server taking the remainder.  Offsets here are 0-based
(the reference is 1-based Lua).
"""

from __future__ import annotations

from typing import List, NamedTuple


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
