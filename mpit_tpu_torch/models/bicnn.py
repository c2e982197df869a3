"""BiCNN answer-selection model — the port of ``mpit_tpu/models/bicnn.py``.

One :class:`BiCNNTower` is applied to the question, the positive answer
and the negative answers: the weights are tied by construction (the
reference aliases four copies of each tensor, BiCNN/bicnn.lua:30-91).  A
tower is embed -> Dense(word_hidden) -> tanh -> Conv1D(num_filters,
conv_width, VALID) -> masked max over time -> ReLU -> L2 normalize, on
``(B, L)`` token batches padded to a static length with a valid-length
vector.

The leaves keep flax's names and layouts, so a flat vector means the same
model in both packages (:mod:`mpit_tpu_torch.models.flat`):
``tower.lookup.embedding`` ``(V, E)``, ``tower.word_hidden.{bias,kernel}``
with the kernel ``(E, H)``, and ``tower.conv.{bias,kernel}`` with the
kernel in flax's ``(k, H, F)``.  The dense layer and the convolution are
cuBLAS products on the card (:class:`Conv1DValid`), as the reference
computes them outside any kernel of its own.

GESD similarity (reference bicnn.lua:98-105):
``sim(u, v) = 1 / ((1 + ||u - v||_2) * (1 + exp(-(u.v + 1))))``.
"""

from __future__ import annotations

import torch
from torch import nn

from mpit_tpu_torch.models.layers import lp_normalize, masked_max_pool
from mpit_tpu_torch.models.mnist import Dense
from mpit_tpu_torch.models.transformer import Embed


class Conv1DValid(nn.Module):
    """flax's ``nn.Conv(features, (k,), padding="VALID")`` over ``(B, L,
    C)``: kernel ``(k, C, F)``, output ``(B, L - k + 1, F)``.

    One matrix product: frame ``t`` is ``x[t:t+k]`` laid end to end, ``k*C``
    wide, against the kernel seen as ``(k*C, F)``.  cuDNN (``conv1d``) takes
    its weight gradient through FFTs at BiCNN's shapes on an H100, 5x
    slower a step at 3,000 filters (``PERF.md``)."""

    def __init__(self, c_in: int, c_out: int, width: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(width, c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, t = self.kernel.shape[0], x.shape[1] - self.kernel.shape[0] + 1
        frames = torch.cat([x[:, i:i + t] for i in range(k)], dim=-1)  # (B, T, k*C)
        return frames @ self.kernel.reshape(-1, self.kernel.shape[-1]) + self.bias


class BiCNNTower(nn.Module):
    """Sentence -> normalized embedding tower (reference bicnn.lua:30-91)."""

    def __init__(self, vocab_size: int, embedding_dim: int = 100,
                 word_hidden_dim: int = 200, num_filters: int = 3000,
                 conv_width: int = 2):
        super().__init__()
        self.conv_width = conv_width
        self.lookup = Embed(vocab_size, embedding_dim)
        self.word_hidden = Dense(embedding_dim, word_hidden_dim)
        self.conv = Conv1DValid(word_hidden_dim, num_filters, conv_width)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """(B, L) int tokens + (B,) valid lengths -> (B, num_filters)."""
        x = torch.tanh(self.word_hidden(self.lookup(tokens)))  # (B, L, H)
        frames = self.conv(x)  # (B, L-k+1, F)
        # A length-l input yields l - k + 1 valid frames (bicnn.lua:78).
        n_valid = torch.clamp(lengths - self.conv_width + 1, min=1)
        x = torch.relu(masked_max_pool(frames, n_valid))
        return lp_normalize(x, p=2.0, axis=-1)  # nn.Normalize(2), bicnn.lua:83


def gesd(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """GESD similarity over (..., F) embedding pairs (bicnn.lua:98-105)."""
    dot = (u * v).sum(dim=-1)
    l2 = torch.sqrt(((u - v) ** 2).sum(dim=-1) + 1e-12)
    return 1.0 / ((1.0 + l2) * (1.0 + torch.exp(-(dot + 1.0))))


class BiCNN(nn.Module):
    """The tied-tower ranking model: :meth:`forward` scores a (q, a+, a-)
    triple (the reference's mmode-1 graph, bicnn.lua:113); :meth:`embed`
    is the single-tower entry of evaluation (bicnn.lua:467-470)."""

    def __init__(self, vocab_size: int, embedding_dim: int = 100,
                 word_hidden_dim: int = 200, num_filters: int = 3000,
                 conv_width: int = 2):
        super().__init__()
        self.tower = BiCNNTower(vocab_size, embedding_dim, word_hidden_dim,
                                num_filters, conv_width)

    def embed(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        return self.tower(tokens, lengths)

    def score_pair(self, q, q_len, a, a_len) -> torch.Tensor:
        return gesd(self.tower(q, q_len), self.tower(a, a_len))

    def forward(self, q, q_len, a_pos, a_pos_len, a_neg, a_neg_len):
        """-> (sim(q, a+), sim(q, a-)), each (B,)."""
        eq = self.tower(q, q_len)
        return gesd(eq, self.tower(a_pos, a_pos_len)), gesd(eq, self.tower(a_neg, a_neg_len))


def margin_ranking_loss(s_pos: torch.Tensor, s_neg: torch.Tensor,
                        margin: float) -> torch.Tensor:
    """MarginRankingCriterion with target 1 (bicnn.lua:121, :380):
    per-example ``max(0, margin - (s_pos - s_neg))``."""
    x = margin - (s_pos - s_neg)
    return torch.maximum(torch.zeros_like(x), x)
