"""mpit_tpu_torch.dplane — the device-resident parameter data plane.

The port of ``mpit_tpu/dplane/``.  Without it, every hot path round-trips
host memory: the server snapshots its shard to the host, encodes there and
ships bytes; the client decodes into a host mirror and re-uploads.  This
package keeps the parameters on the card:

- :mod:`mpit_tpu_torch.dplane.partition` — a regex -> ``PartitionSpec``
  rule engine over parameter trees, plus the flat-vector layer: segment
  tables in the JAX package's flatten order, boundary-aligned cuts, and
  ``plan_shard_map`` as the layout source for versioned shard maps.
- :mod:`mpit_tpu_torch.dplane.hbm` — device-resident shard slots: a
  shard's params and optimizer state live as tensors on the card and
  ``rule.apply`` updates them in place (K3 under Adam); per-version
  snapshot (device->host) and pull (device clone) caches keep reads
  one-copy.
- :mod:`mpit_tpu_torch.dplane.exchange` — the client<->server exchange
  that stays on the card when ranks share a backend (a process-local
  plane registry and backend fingerprints decide) and falls back to the
  framed wire path — codecs, retry/dedup, shard maps intact — otherwise
  (``docs/DEVICE.md`` has the decision table).
"""

from mpit_tpu_torch.dplane.partition import (
    Segment,
    aligned_cut,
    flat_segments,
    match_partition_rules,
    match_report,
    named_tree_map,
    plan_shard_map,
    tree_shardings,
)
from mpit_tpu_torch.dplane.hbm import (
    HbmSlot,
    PlaneConfig,
    dedupe_state,
    place_flat,
    place_state,
)
from mpit_tpu_torch.dplane.exchange import (
    DevicePlane,
    ExchangeClient,
    ExchangeError,
    backend_fingerprint,
    lookup,
    publish,
    withdraw,
)

__all__ = [
    "Segment", "aligned_cut", "flat_segments", "match_partition_rules",
    "match_report", "named_tree_map", "plan_shard_map", "tree_shardings",
    "HbmSlot", "PlaneConfig", "dedupe_state", "place_flat", "place_state",
    "DevicePlane", "ExchangeClient", "ExchangeError",
    "backend_fingerprint", "lookup", "publish", "withdraw",
]
