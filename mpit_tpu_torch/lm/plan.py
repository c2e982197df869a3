"""Shard planning for the LM TrainState — partition rules in, layout out.

The port of ``mpit_tpu/lm/plan.py``.  Drives the
:mod:`mpit_tpu_torch.dplane.partition` engine over the LM's
params+optimizer tree and lowers the result to the two placement artifacts
the PS stack consumes:

- :meth:`LmPlan.layout` — a **static weighted aligned cut**: one
  contiguous :class:`~mpit_tpu_torch.ps.sharding.Shard` per server, every
  interior boundary on a parameter boundary, targets skewed by per-server
  weights.  Passed to ``ParamClient(layout=...)`` /
  ``ReaderClient(layout=...)`` it replaces the equal split while keeping
  the whole static feature set (chunked streaming, int8 error feedback,
  staleness, the aggregation tree) negotiable.
- :meth:`LmPlan.shard_map` — the same cut lifted into a versioned shard
  control ShardMap when placement should migrate; per-shard optimizer
  slots move with their shard because the cut never splits a parameter.

The rules match flax path names joined by ``/``, so the plan runs over
the flax-named tree of :meth:`FlatModel.to_jax_params
<mpit_tpu_torch.models.flat.FlatModel.to_jax_params>` (its leaves in the
``ravel_pytree`` order the flat vector uses): the same tree gives the
same cut as the JAX ``plan``.

Footprint model: a server holding ``S`` f32 elements under rule ``R``
allocates ``(1 + STATE_SLOTS[R]) * 4 * S`` bytes (params + per-element
optimizer slots; scalar step counters are free).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence

from mpit_tpu_torch.dplane.partition import (
    PartitionSpec as P,
    Segment,
    aligned_cut,
    flat_segments,
    match_report,
    plan_shard_map,
)
from mpit_tpu_torch.optim.rules import state_slots

#: Ordered partition rules for the TinyDecoder TrainState (params AND the
#: mirrored optimizer slots: an opt_state path like
#: ``opt_state/DecoderBlock_0/Dense_0/kernel/m`` contains the same
#: component names, so one table covers both).  First match wins; no
#: catch-all tail — an unmatched non-scalar leaf is a loud error.
PARTITION_RULES = [
    # token + position embeddings: shard the vocab/position axis
    (r"Embed_\d+/embedding", P("mdl", None)),
    # attention qkv/out + MLP kernels: shard the output features
    (r"Dense_\d+/kernel", P(None, "mdl")),
    # biases, norms (and the per-leaf scalar step counters of the
    # optimizer slots resolve as scalars before any rule is consulted)
    (r"Dense_\d+/bias", P()),
    (r"LayerNorm_\d+/(scale|bias)", P()),
]


def audit_rules(tree: Any, rules=None, *, sep: str = "/") -> Dict[str, int]:
    """:func:`match_report` over ``tree`` with a loud failure if any
    non-scalar leaf is unmatched (report value -2).  Returns the report so
    callers can also assert exactly-once coverage."""
    report = match_report(rules if rules is not None else PARTITION_RULES,
                          tree, sep=sep)
    missing = sorted(name for name, idx in report.items() if idx == -2)
    if missing:
        raise ValueError(
            f"{len(missing)} TrainState leaves match no partition rule: "
            f"{missing[:5]}{' ...' if len(missing) > 5 else ''}")
    return report


class LmPlan(NamedTuple):
    """A computed shard plan over one LM param vector."""

    segments: List[Segment]       # ordered leaf extents of the flat vector
    layout: List[Any]             # one Shard per server (weighted cut)
    plong: int                    # flat vector length
    rule: str                     # server-side optimizer rule
    slots: int                    # vector-shaped state arrays per element
    weights: Optional[List[float]]

    def footprint_bytes(self, i: int) -> int:
        """Bytes server ``i`` holds: its f32 shard + optimizer slots."""
        return self.layout[i].size * 4 * (1 + self.slots)

    def shard_map(self, server_ranks: Sequence[int]):
        """The same cut as a version-0 shard control ShardMap (placement
        can then migrate; slots move with their shard)."""
        from mpit_tpu_torch.shardctl.shardmap import ShardMap

        return ShardMap.from_shards(self.layout, list(server_ranks))

    def summary(self) -> Dict[str, Any]:
        sizes = [s.size for s in self.layout]
        foot = [self.footprint_bytes(i) for i in range(len(self.layout))]
        return {
            "plong": self.plong,
            "segments": len(self.segments),
            "servers": len(self.layout),
            "rule": self.rule,
            "slots": self.slots,
            "shard_elems": sizes,
            "footprint_mb": [round(b / 2**20, 3) for b in foot],
            "total_footprint_mb": round(sum(foot) / 2**20, 3),
            "weights": self.weights,
        }


def plan(params: Any, n_servers: int, *, rule: str = "add",
         server_weights: Optional[Sequence[float]] = None,
         sep: str = "/") -> LmPlan:
    """Cut the raveled ``params`` (a flax-named tree) into ``n_servers``
    aligned shards.  ``server_weights`` skews the cut targets — a server
    with twice the weight aims at twice the elements, to the nearest
    parameter boundary.  ``rule`` names the server-side optimizer whose
    per-element slot count prices the footprint; it never moves the cut."""
    if n_servers < 1:
        raise ValueError("need at least one server")
    segments = flat_segments(params, sep=sep)
    plong = segments[-1].end
    weights = ([float(w) for w in server_weights]
               if server_weights is not None else None)
    layout = aligned_cut(plong, segments, n_servers, weights=weights)
    return LmPlan(segments=segments, layout=layout, plong=plong,
                  rule=rule, slots=state_slots(rule), weights=weights)


__all__ = [
    "PARTITION_RULES", "LmPlan", "audit_rules", "plan", "plan_shard_map",
]
