"""mpit_tpu_torch.agg — hierarchical quantized aggregation under the PS model.

The port of ``mpit_tpu/agg/``.  Pre-reducing N gradients into one before
the servers see them sends fewer bytes upstream (the MXNET-MPI direction,
PAPERS.md 1802.06949):

- :mod:`mpit_tpu_torch.agg.plan` — the deterministic reduction topology:
  colocated groups (dplane-fingerprint equivalence) electing min-rank
  representatives, and a seed-deterministic ``fanin``-ary tree over
  the representatives.  Fixed fold order is the bitwise-parity anchor.
- :mod:`mpit_tpu_torch.agg.node` — the in-process group plane:
  single-writer ticket queue for the group fold on the card.
- :mod:`mpit_tpu_torch.agg.wire` — the REDUCE hop frames: the chunk
  discipline of streamed transfers plus ``nfold`` fan-in accounting and
  the LATE ack status that re-routes stragglers to direct pushes.
- :mod:`mpit_tpu_torch.agg.client` — :class:`AggClient`, the
  ParamClientAPI front that runs the whole thing: arrival-order-tolerant
  folds, per-hop int8 error feedback, wall-bounded straggler deadlines,
  loud-never-hang rails.

docs/PROTOCOL.md §13 is normative.
"""

from mpit_tpu_torch.agg.client import AggClient
from mpit_tpu_torch.agg.node import (
    TICKET_LATE,
    TICKET_OK,
    AggPlane,
    AggPlaneClosed,
    AggTicket,
)
from mpit_tpu_torch.agg.plan import AggConfig, ReductionPlan
from mpit_tpu_torch.agg.wire import (
    RD_ACK_WORDS,
    RD_HDR_BYTES,
    RD_HDR_WORDS,
    RD_LATE,
    RD_OK,
    pack_reduce_header,
    reduce_ack_frame,
    unpack_reduce_header,
)

__all__ = [
    "AggClient",
    "AggConfig",
    "AggPlane",
    "AggPlaneClosed",
    "AggTicket",
    "ReductionPlan",
    "TICKET_LATE",
    "TICKET_OK",
    "RD_ACK_WORDS",
    "RD_HDR_BYTES",
    "RD_HDR_WORDS",
    "RD_LATE",
    "RD_OK",
    "pack_reduce_header",
    "reduce_ack_frame",
    "unpack_reduce_header",
]
