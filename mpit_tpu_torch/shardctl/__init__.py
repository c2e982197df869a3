"""mpit_tpu_torch.shardctl — versioned shard maps, load-aware rebalancing,
and live shard migration for the PS gang.

The port of ``mpit_tpu/shardctl/``: the same modules and exports.  Only
``migrate.py`` changes for the card: a slot's param and rule state are
tensors on the server's device, and what moves between servers or lands in
a checkpoint is the JAX package's host bytes.  Under ``rule="adam"`` every
admitted GRAD on a slot is one K3 apply on the slot's own tensors, on
whichever server owns the shard at the time.

The seed protocol freezes placement at INIT: equal contiguous shards,
one per server rank, for the life of the run.  That static layout is
the scalability ceiling the related work keeps measuring — a single
slow or hot server gates every client (imbalanced-arrival skew, arxiv
1804.05349), and an evicted server's shard is unrecoverable without a
same-rank restart.  This package makes placement a first-class, mutable
object and threads it through ps/comm/ft/obs/train:

- :mod:`shardmap` — a versioned :class:`ShardMap` (monotonic
  ``version``, shard→server assignment, unequal/weighted shards)
  replacing the raw ``shard_layout()`` call sites.
- :mod:`wire` — shard-addressed op headers ``[epoch, seq, map_version,
  shard_id]``, status replies (OK / NACK_MAP / BUSY), INIT v4, and
  MAP_UPDATE directives.
- :mod:`migrate` — the live migration state machine's data plane:
  per-slot server state (param + optimizer + shard-scoped dedup +
  snapshot cache), the SHARD_PULL/SHARD_STATE transfer, and
  shard-oriented checkpoints for failover.
- :mod:`policy` / :mod:`controller` — the control plane: a lease
  registry over *servers* (PR 3's machinery pointed the other way), a
  load-aware :class:`RebalancePolicy` consuming per-shard busy reports
  (PR 4's obs instruments), and the :class:`ShardController` that
  executes migrations and failovers and distributes committed maps.
- :mod:`autoscale` — the closed loop (docs/OPERATIONS.md): an
  SLO-driven :class:`AutoscalePolicy` (hysteresis bands, cooldown,
  flap-suppression budget, operator precedence) over windowed gang
  telemetry read through the obs/top path, actuated by an
  :class:`Autoscaler` through the controller's existing §9 scale
  verbs, with every decision audited and flight-recorded.

Correctness invariants (held by tests/test_torch_shardctl.py): live
migration and lease-expiry failover both leave final params **bitwise
equal** to a fault-free static-map run, including under drop/dup fault
plans — the shard-scoped dedup state travels with the shard, so a
retried op admits at-most-once across owners.
"""

from mpit_tpu_torch.shardctl.autoscale import (
    AutoscaleConfig,
    AutoscalePolicy,
    Autoscaler,
    Decision,
    HttpSampler,
    RegistrySampler,
    SLOConfig,
    TelemetryWindow,
)
from mpit_tpu_torch.shardctl.controller import ShardController
from mpit_tpu_torch.shardctl.migrate import (
    SC_DEADLINE_S,
    ShardSlot,
    load_shard_state,
    save_shard_state,
)
from mpit_tpu_torch.shardctl.policy import RebalancePolicy, ShardLoad
from mpit_tpu_torch.shardctl.shardmap import ShardEntry, ShardMap
from mpit_tpu_torch.shardctl.wire import (
    ACQUIRE,
    ADOPT,
    BUSY,
    DONE,
    FLAG_SHARDCTL,
    INSTALL,
    NACK_MAP,
    OK,
    RELEASE,
    SC_HDR_BYTES,
)

__all__ = [
    "ShardController", "ShardSlot", "ShardMap", "ShardEntry",
    "RebalancePolicy", "ShardLoad",
    "SLOConfig", "AutoscaleConfig", "AutoscalePolicy", "Autoscaler",
    "Decision", "TelemetryWindow", "RegistrySampler", "HttpSampler",
    "save_shard_state", "load_shard_state",
    "SC_DEADLINE_S", "SC_HDR_BYTES", "FLAG_SHARDCTL",
    "OK", "NACK_MAP", "BUSY",
    "INSTALL", "RELEASE", "ACQUIRE", "ADOPT", "DONE",
]
