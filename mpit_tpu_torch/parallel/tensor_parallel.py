"""Tensor parallelism on the one-card stand-in mesh: Megatron-style column
and row cut matmul pairs — the port of
``mpit_tpu/parallel/tensor_parallel.py``.

The JAX package cuts weights over the devices of a ``tp`` axis, by output
(column) or input (row) dimension, and pays one ``psum`` a cut block:

- **column-parallel**: ``W1`` cut over its output dim; each rank computes
  a slice of the hidden activations, with no communication;
- **row-parallel**: ``W2`` cut over its input dim; each rank contributes a
  partial product, combined by one ``psum``;
- the same layout over attention heads gives head-parallel attention.

Here the ``tp`` ranks are virtual ranks of one card
(:mod:`mpit_tpu_torch.parallel.mesh`): each cut is a view of the weight
with the ranks first, the ranks' products run as one batched product over
that leading axis (plain products, ``torch.matmul``), and the reduce is
:func:`mpit_tpu_torch.parallel.collective.psum`, rank by rank in rank
order.  Head-parallel attention stacks every rank's heads into the leading
axes of one :func:`mpit_tpu_torch.ops.flash_attention` call: on the card
one K4 launch forward and one K5 (or K6, as the gate decides) backward
serve all ranks; on the CPU the kernels' wrappers run their plain twins.
The JAX body attends with ``attention_reference``; the function is the
same.  Everything is differentiable by autograd.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from mpit_tpu_torch.ops.flash_attention import flash_attention
from mpit_tpu_torch.parallel.collective import psum
from mpit_tpu_torch.parallel.mesh import Mesh

Act = Callable[[torch.Tensor], torch.Tensor]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (PyTorch's default
    is the exact erf form, another function)."""
    return F.gelu(x, approximate="tanh")


def _divide(what: str, size: int, n: int, axis: str) -> int:
    if size % n:
        raise ValueError(f"{what} {size} not divisible by the {n} ranks of axis {axis!r}")
    return size // n


def tp_mlp(mesh: Mesh, axis: str = "tp", activation: Act = gelu):
    """Two-layer MLP with its hidden dim cut over ``axis``.

    ``fn(x, w1, b1, w2, b2)``: ``x (..., d)``, ``w1 (d, h)``, ``b1 (h,)``,
    ``w2 (h, d)``, ``b2 (d,)``, ``h`` divisible by the axis's ranks.
    ``w1`` is cut by columns into ``(n, d, h/n)``, ``w2`` by rows into
    ``(n, h/n, d)``; one batched product each over the rank stack, one
    ``psum``, and ``b2`` added after the reduce."""
    n = mesh.size(axis)
    reduce = psum(mesh, axis)

    def fn(x, w1, b1, w2, b2):
        for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
            mesh.check_device(t, name)
        d, h = w1.shape
        hl = _divide("the hidden width", h, n, axis)
        lead = x.shape[:-1]
        w1s = w1.reshape(d, n, hl).transpose(0, 1)  # (n, d, h/n): column cuts
        hidden = activation(torch.matmul(x.reshape(1, -1, d), w1s)
                            + b1.reshape(n, 1, hl))  # (n, M, h/n), each rank's slice
        partial = torch.matmul(hidden, w2.reshape(n, hl, d))  # row cuts
        return (reduce(partial) + b2).reshape(*lead, d)

    return fn


def tp_self_attention(mesh: Mesh, axis: str = "tp", *, causal: bool = True,
                      sm_scale: Optional[float] = None):
    """Head-parallel self-attention: heads cut over ``axis``.

    ``fn(x, wqkv, wo)``: ``x (B, L, d)``, ``wqkv (d, 3, H, Dh)``, ``wo (H,
    Dh, d)``, ``H`` divisible by the axis's ranks.  The QKV projection is
    local to each rank's heads; every rank's q, k and v are stacked
    ``(n, B, H/n, L, Dh)`` contiguous, so one :func:`flash_attention` call
    (one K4 launch on the card) attends for all ranks; the output projection
    is row-parallel with one ``psum``.  ``Dh`` must be one the kernels take
    (a multiple of 8 up to 128)."""
    n = mesh.size(axis)
    reduce = psum(mesh, axis)

    def fn(x, wqkv, wo):
        for name, t in (("x", x), ("wqkv", wqkv), ("wo", wo)):
            mesh.check_device(t, name)
        b, length, d = x.shape
        _, _, heads, dh = wqkv.shape
        hl = _divide("the head count", heads, n, axis)
        qkv = torch.matmul(x.reshape(b * length, d), wqkv.reshape(d, -1))
        # (B, L, 3, n, H/n, Dh) -> (3, n, B, H/n, L, Dh): q, k and v each one
        # contiguous block, every rank's heads in the kernel's leading axes.
        qkv = qkv.reshape(b, length, 3, n, hl, dh).permute(2, 3, 0, 4, 1, 5).contiguous()
        out = flash_attention(qkv[0], qkv[1], qkv[2], causal=causal, sm_scale=sm_scale)
        partial = torch.einsum("nbhlk,nhkd->nbld", out, wo.reshape(n, hl, dh, d))
        return reduce(partial)

    return fn
