"""Decoder-only transformer with pluggable attention: the long-context LM.

The port of ``mpit_tpu/models/transformer.py``.  The modules keep flax's
names, parameter layouts and defaults, so a flat parameter vector means
the same thing in both packages (:mod:`mpit_tpu_torch.models.flat`):

- ``Embed_i/embedding`` of shape ``(num, features)``, a gather; the
  position table is ``Embed_1`` with ``max_len`` rows;
- ``Dense_i/kernel`` of shape ``(in, out)`` (``x @ kernel``), with a
  ``bias`` where flax has one;
- ``LayerNorm_i/{scale,bias}`` with flax's epsilon, 1e-6;
- the MLP's gelu is the tanh approximation (flax's ``nn.gelu``);
- the fused qkv projection splits into three contiguous thirds.

Attention is injected as ``attn_fn(q, k, v) -> out`` over ``(B, L, H,
D)``; the default is :func:`mpit_tpu_torch.ops.flash_attention`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mpit_tpu_torch.models.mnist import Dense
from mpit_tpu_torch.ops.flash_attention import attention_reference, flash_attention

AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

LN_EPS = 1e-6  # flax nn.LayerNorm's default (PyTorch's is 1e-5)


def default_attn(causal: bool = True, use_flash: bool = True) -> AttnFn:
    """Single-device attention over (B, L, H, D): the flash kernels, or the
    plain reference when the caller asks for it (``use_flash=False``, which
    autograd differentiates without a recompute pass)."""

    def fn(q, k, v):
        # (B, L, H, D) -> (B, H, L, D), copied: the kernels take contiguous
        # (N, L, D) operands.
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if use_flash:
            out = flash_attention(qh, kh, vh, causal=causal)
        else:
            out = attention_reference(qh, kh, vh, causal=causal)
        return out.transpose(1, 2)

    return fn


class LayerNorm(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, eps=LN_EPS)


class Embed(nn.Module):
    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, features))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.embedding)


class DecoderBlock(nn.Module):
    """Pre-LN block: causal self-attention, then a gelu MLP."""

    def __init__(self, d_model: int, n_heads: int, mlp_ratio: int = 4,
                 attn_fn: Optional[AttnFn] = None):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.attn_fn = attn_fn if attn_fn is not None else default_attn()
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, 3 * d_model, use_bias=False)
        self.Dense_1 = Dense(d_model, d_model, use_bias=False)
        self.LayerNorm_1 = LayerNorm(d_model)
        self.Dense_2 = Dense(d_model, mlp_ratio * d_model)
        self.Dense_3 = Dense(mlp_ratio * d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        head = self.d_model // self.n_heads
        qkv = self.Dense_0(self.LayerNorm_0(x))
        q, k, v = (t.reshape(b, l, self.n_heads, head)
                   for t in qkv.split(self.d_model, dim=-1))
        x = x + self.Dense_1(self.attn_fn(q, k, v).reshape(b, l, self.d_model))
        h = F.gelu(self.Dense_2(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_3(h)


class TinyDecoder(nn.Module):
    """Small causal LM: token + learned position embeddings, N pre-LN
    blocks, an untied output head; returns log-probabilities."""

    def __init__(self, vocab: int = 256, d_model: int = 64, n_heads: int = 4,
                 n_layers: int = 2, max_len: int = 1024,
                 attn_fn: Optional[AttnFn] = None):
        super().__init__()
        self.max_len, self.n_layers = max_len, n_layers
        self.Embed_0 = Embed(vocab, d_model)
        self.Embed_1 = Embed(max_len, d_model)
        for i in range(n_layers):
            self.add_module(f"DecoderBlock_{i}",
                            DecoderBlock(d_model, n_heads, attn_fn=attn_fn))
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, vocab, use_bias=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, l = tokens.shape
        if l > self.max_len:
            raise ValueError(f"sequence length {l} > max_len {self.max_len}")
        x = self.Embed_0(tokens)
        x = x + self.Embed_1(torch.arange(l, device=tokens.device))[None, :, :]
        for i in range(self.n_layers):
            x = getattr(self, f"DecoderBlock_{i}")(x)
        logits = self.Dense_0(self.LayerNorm_0(x))
        return F.log_softmax(logits, dim=-1)
