"""REDUCE wire framing — the reduction-tree hop layout (PROTOCOL.md §13).

A copy of ``mpit_tpu/agg/wire.py``: the frames are the JAX package's
bytes, so a port node and a JAX node of one tree read each other.

A REDUCE hop ships one node's *partial sum* (its own gradient folded
with every on-time subtree contribution) to its tree parent as K
independent chunk frames, reusing the §12 streaming discipline: chunks
cut on the int8 codec's BLOCK boundaries so each chunk frame is
bit-identical to the same region of a whole-vector frame (residual fold
included), retries resend only unacked chunks, and dedup on the
receiver is per (child, epoch, seq, chunk) through the standard
:class:`~mpit_tpu_torch.ft.dedup.DedupTable`.

Beyond the §12 chunk header, a REDUCE frame carries ``nfold`` — the
number of leaf gradients already folded into the partial — so the
representative that finally pushes upstream knows the reduction's
fan-in without any side channel, and the causal analyzer can attribute
a round's coverage.

Acks carry a status word because a reduction hop has one outcome a
plain transfer does not: **LATE** — the receiver's straggler deadline
fired and the round folded without this sender.  A LATE ack re-routes
the sender to a direct GRAD push of its partial (loud, counted, never
lost), which is what keeps a straggler from serializing the whole tree
while still never dropping its contribution.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

#: int64 [epoch, seq, chunk_idx, chunk_count, nfold]
RD_HDR_WORDS = 5
RD_HDR_BYTES = 8 * RD_HDR_WORDS

#: int64 [epoch, seq, chunk_idx, status]
RD_ACK_WORDS = 4

#: ack statuses
RD_OK = 0
RD_LATE = 1


def pack_reduce_header(buf: np.ndarray, epoch: int, seq: int, idx: int,
                       count: int, nfold: int) -> None:
    """Write the REDUCE chunk header into the first RD_HDR_BYTES of a
    uint8 staging frame."""
    buf[:RD_HDR_BYTES].view(np.int64)[:] = (epoch, seq, idx, count, nfold)


def unpack_reduce_header(
        buf: np.ndarray) -> Tuple[int, int, int, int, int]:
    """(epoch, seq, chunk_idx, chunk_count, nfold) from a REDUCE frame."""
    hdr = buf[:RD_HDR_BYTES].view(np.int64)
    return (int(hdr[0]), int(hdr[1]), int(hdr[2]), int(hdr[3]),
            int(hdr[4]))


def reduce_ack_frame(epoch: int, seq: int, idx: int,
                     status: int) -> np.ndarray:
    """A fresh 32-byte REDUCE_ACK message."""
    return np.asarray([epoch, seq, idx, status], dtype=np.int64)
