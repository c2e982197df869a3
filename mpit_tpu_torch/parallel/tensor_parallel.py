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

Where ``tp`` spans the processes of a group, each process computes its own
ranks' cuts only (its range of the axis, :mod:`mpit_tpu_torch.parallel.
mesh`), as each JAX device computes its shard.  The functions take the
whole weights, as a JAX mesh takes global arrays, and cut out this
process's ranks (:func:`~mpit_tpu_torch.parallel.collective.take_cuts`);
the reduce all-gathers the line's partials and adds them in rank order.
Two rules keep every process's gradients the JAX package's:

- each whole weight's gradient comes back whole in every process of the
  line, the cuts' gradients all-gathered in one collective a call, so an
  optimizer's replicas stay equal (as ``collective.replicate`` keeps them
  for ``sp``), at the price of that gather (``w1`` and ``w2`` at d 1,024
  and h 4,096 are 16 MB each in float32);
- ``x``, replicated, enters the cut computation through
  :func:`~mpit_tpu_torch.parallel.collective.copy_to_line`: each process
  holds only its ranks' share of ``x``'s gradient, and the line's shares
  are added in rank order.

The outputs and the weights' gradients are then the one-process run's
arithmetic, rank for rank; ``x``'s gradient adds the same shares in
another order.  ``tp_self_attention`` stacks only this process's ranks'
heads into its ``flash_attention`` call: one K4 launch forward a process,
and K5 (or K6) as the gate decides for that smaller stack.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from mpit_tpu_torch.ops.flash_attention import flash_attention
from mpit_tpu_torch.parallel.collective import copy_to_line, psum, take_cuts
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
    ``(n, h/n, d)``; one batched product each over this process's rank
    stack, one ``psum``, and ``b2`` added after the reduce."""
    n, nl = mesh.size(axis), mesh.local_size(axis)
    reduce, enter = psum(mesh, axis), copy_to_line(mesh, axis)
    cuts = take_cuts(mesh, axis, (1, 0, 0))

    def fn(x, w1, b1, w2, b2):
        for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
            mesh.check_device(t, name)
        d, h = w1.shape
        hl = _divide("the hidden width", h, n, axis)
        lead = x.shape[:-1]
        w1, b1, w2 = cuts(w1, b1, w2)  # this process's ranks' columns and rows
        w1s = w1.reshape(d, nl, hl).transpose(0, 1)  # (nl, d, h/n): column cuts
        hidden = activation(torch.matmul(enter(x).reshape(1, -1, d), w1s)
                            + b1.reshape(nl, 1, hl))  # (nl, M, h/n), each rank's slice
        partial = torch.matmul(hidden, w2.reshape(nl, hl, d))  # row cuts
        return (reduce(partial) + b2).reshape(*lead, d)

    return fn


def tp_self_attention(mesh: Mesh, axis: str = "tp", *, causal: bool = True,
                      sm_scale: Optional[float] = None):
    """Head-parallel self-attention: heads cut over ``axis``.

    ``fn(x, wqkv, wo)``: ``x (B, L, d)``, ``wqkv (d, 3, H, Dh)``, ``wo (H,
    Dh, d)``, ``H`` divisible by the axis's ranks.  The QKV projection is
    local to each rank's heads; this process's ranks' q, k and v are
    stacked ``(nl, B, H/n, L, Dh)`` contiguous, so one
    :func:`flash_attention` call (one K4 launch on the card) attends for
    all of them; the output projection is row-parallel with one ``psum``.
    ``Dh`` must be one the kernels take (a multiple of 8 up to 128)."""
    n, nl = mesh.size(axis), mesh.local_size(axis)
    reduce, enter = psum(mesh, axis), copy_to_line(mesh, axis)
    cuts = take_cuts(mesh, axis, (2, 0))

    def fn(x, wqkv, wo):
        for name, t in (("x", x), ("wqkv", wqkv), ("wo", wo)):
            mesh.check_device(t, name)
        b, length, d = x.shape
        _, _, heads, dh = wqkv.shape
        hl = _divide("the head count", heads, n, axis)
        wqkv, wo = cuts(wqkv, wo)  # this process's ranks' heads
        qkv = torch.matmul(enter(x).reshape(b * length, d), wqkv.reshape(d, -1))
        # (B, L, 3, nl, H/n, Dh) -> (3, nl, B, H/n, L, Dh): q, k and v each one
        # contiguous block, every rank's heads in the kernel's leading axes.
        qkv = qkv.reshape(b, length, 3, nl, hl, dh).permute(2, 3, 0, 4, 1, 5).contiguous()
        out = flash_attention(qkv[0], qkv[1], qkv[2], causal=causal, sm_scale=sm_scale)
        partial = torch.einsum("nbhlk,nhkd->nbld", out, wo.reshape(nl, hl, dh, d))
        return reduce(partial)

    return fn
