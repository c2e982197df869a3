"""Packed token batches — pure functions of ``(seed, step)``.

A copy of ``mpit_tpu/lm/data.py`` (numpy only).

Sequence packing over the :mod:`mpit_tpu_torch.data.tokens` document stream:
documents are concatenated, EOS-separated, into a flat ``batch *
(seq_len + 1)`` grid and reshaped — no padding, every cell is a real
prediction target.  The ``+ 1`` column lets the trainer slice
``inputs = tokens[:, :-1]`` / ``targets = tokens[:, 1:]`` from one
array.

Determinism contract (tests/test_lm.py and tests/test_torch_lm_gang.py pin
it):

- ``packed_batch(seed, step, ...)`` is a pure function — bitwise-equal
  results across calls, processes and machines (the generator is
  counter-keyed Philox; no global RNG state is read or written);
- a :class:`PackedStream` holds no mutable state, so a supervisor
  restart that re-creates the stream and resumes at step ``k`` sees the
  identical batch the dead incarnation would have seen;
- batches for different steps are decorrelated (fresh Philox key per
  step, not an advanced shared stream).
"""

from __future__ import annotations

import numpy as np

from mpit_tpu_torch.data.tokens import VOCAB, doc_batch

#: Separator written between packed documents (byte 0).
EOS = 0


def packed_batch(seed: int, step: int, *, batch: int,
                 seq_len: int) -> np.ndarray:
    """The ``(batch, seq_len + 1)`` int32 token grid of step ``step``.

    Pure: equal arguments => bitwise-identical array, in any process.
    """
    if batch < 1 or seq_len < 2:
        raise ValueError("need batch >= 1 and seq_len >= 2")
    n_cells = batch * (seq_len + 1)
    flat = np.full(n_cells, EOS, np.int32)
    pos = 0
    # doc_batch returns >= n_cells tokens; with one EOS after each
    # document the packed content always fills the grid (the tail
    # document is truncated at the grid edge).
    for doc in doc_batch(seed, step, budget=n_cells):
        if pos >= n_cells:
            break
        take = min(len(doc), n_cells - pos)
        flat[pos:pos + take] = doc[:take]
        pos += take
        if pos < n_cells:
            flat[pos] = EOS  # separator; also a real prediction target
            pos += 1
    return flat.reshape(batch, seq_len + 1)


class PackedStream:
    """Stateless view of the packed stream: ``batch_at(step)`` is
    :func:`packed_batch` with the construction-time shape bound."""

    def __init__(self, seed: int, batch: int, seq_len: int):
        self.seed = int(seed)
        self.batch = int(batch)
        self.seq_len = int(seq_len)
        self.vocab = VOCAB

    def batch_at(self, step: int) -> np.ndarray:
        return packed_batch(self.seed, step, batch=self.batch,
                            seq_len=self.seq_len)
