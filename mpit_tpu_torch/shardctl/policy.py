"""Load-aware rebalance policy — pure decision logic, no I/O.

A copy of ``mpit_tpu/shardctl/policy.py``: the port imports
nothing of the JAX package.

The controller aggregates per-shard load reports from the servers'
beats (busy-seconds and op counts per window, sourced from each
server's obs registry instruments — docs/OBSERVABILITY.md
``mpit_shardctl_*``) and asks the policy one question per window: *does
any shard need to move, and where?*  Keeping the policy a pure function
of ``(map, window loads)`` makes every proposal unit-testable without a
gang, and makes the controller's behavior a replayable function of the
reports it received.

The default policy is a deliberately conservative threshold rule — the
skew it exists to fix (one slow/hot server gating every client, arxiv
1804.05349) produces load ratios far above any noise floor:

- compute per-server busy-seconds over the window;
- if the busiest server's load exceeds ``ratio ×`` the least-busy
  server's (and clears an absolute noise floor), propose moving the
  busiest server's heaviest shard to the least-busy server;
- at most one proposal per ``cooldown_s`` — a migration changes the
  load landscape, so the next window must be measured, not predicted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from mpit_tpu_torch.shardctl.shardmap import ShardMap


@dataclass
class ShardLoad:
    """One shard's load over the current window (from server beats)."""

    ops: int = 0
    busy_s: float = 0.0


@dataclass
class RebalancePolicy:
    #: trigger when max server load >= ratio * min server load
    ratio: float = 3.0
    #: absolute busy-seconds floor — below this the window is noise
    min_busy_s: float = 0.02
    #: minimum seconds between proposals (measure after every move)
    cooldown_s: float = 1.0
    #: master switch (the bench's rebalancing-off leg)
    enabled: bool = True

    def propose(
        self,
        smap: ShardMap,
        loads: Dict[int, Dict[int, ShardLoad]],
    ) -> Optional[Tuple[int, int]]:
        """``(shard_id, dst_rank)`` to migrate, or None.

        ``loads``: server rank -> {shard_id -> ShardLoad} for the
        current window.  Only ranks present in ``loads`` (i.e. that
        reported this window) are candidates — a silent server is the
        lease reaper's problem, not the balancer's.
        """
        if not self.enabled or len(loads) < 2:
            return None
        per_server = {
            rank: sum(sl.busy_s for sl in shards.values())
            for rank, shards in loads.items()
        }
        hot = max(per_server, key=lambda r: (per_server[r], r))
        cold = min(per_server, key=lambda r: (per_server[r], -r))
        if hot == cold or per_server[hot] < self.min_busy_s:
            return None
        if per_server[hot] < self.ratio * max(per_server[cold], 1e-9):
            return None
        hot_shards = {
            e.shard_id: loads[hot].get(e.shard_id, ShardLoad()).busy_s
            for e in smap.shards_of(hot)
        }
        if not hot_shards:
            return None
        heaviest = max(hot_shards, key=lambda s: (hot_shards[s], -s))
        return heaviest, cold
