"""Collective primitives on the one-card stand-in mesh — the port of
``mpit_tpu/parallel/collective.py``.

The JAX package moves parameter and gradient shards between the devices of
a mesh axis with three XLA collectives inside ``shard_map``: **pull** (a
client fetching every server's shard) is ``all_gather``, **push** (each
server receiving its shard of the summed gradients) is a slice or a
``psum`` then a slice, and the **ring transfer** (a neighbour exchange,
the step of ring attention) is ``ppermute``.  On one card the ranks of an
axis are virtual (:mod:`mpit_tpu_torch.parallel.mesh`): every function here
takes and returns rank-stacked tensors, the axis's ranks first, and each
collective is a tensor op on the device:

- pull: the stack seen flat (a view where the stack is contiguous);
- push: the owner's slice of a replicated gradient, or the sum over the
  worker stack and then the slice;
- ``psum``: the sum over an axis's rank stack, rank by rank in rank order,
  the reduce of tensor, pipeline and expert parallelism;
- ring transfer: ``torch.roll`` along the rank axis, so that rank ``i``'s
  block lands at rank ``i + 1``: one device copy a hop, which stands for an
  NVLink hop and is where a multi-card slice puts P2P or NCCL.

The JAX module's ``shard_map`` version shim has no counterpart.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from mpit_tpu_torch.parallel.mesh import Mesh

Fn = Callable[[torch.Tensor], torch.Tensor]


def _ranks(mesh: Mesh, axis: str, x: torch.Tensor, what: str) -> int:
    """The rank count of ``axis``, checking that ``x`` stacks that many
    blocks on the mesh's device."""
    n = mesh.size(axis)
    mesh.check_device(x, what)
    if x.dim() < 1 or x.shape[0] != n:
        raise ValueError(f"{what} must stack the {n} ranks of axis {axis!r} first, "
                         f"got shape {tuple(x.shape)}")
    return n


def _owner_slices(full: torch.Tensor, n: int) -> torch.Tensor:
    """Rank ``r``'s slice of a replicated vector is row ``r`` of the result:
    ``full.shape[0] // n`` elements each, as the reference's
    ``dynamic_slice`` cuts them."""
    size = full.shape[0] // n
    return full[: n * size].reshape(n, size, *full.shape[1:])


def pad_shards(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    """``x`` with its last axis padded with zeros to a multiple of ``n``,
    and the padding: how the JAX package cuts an axis that ``n`` shards do
    not divide (its last shard holds the padding).  ``x`` itself where
    ``n`` divides it."""
    pad = -x.shape[-1] % n
    return (torch.nn.functional.pad(x, (0, pad)) if pad else x), pad


def ps_pull(mesh: Mesh, axis: str = "shard") -> Fn:
    """Full-param fetch: every rank receives the concatenation of all the
    shards, ``(n, s, ...) -> (n * s, ...)``."""

    def _pull(shards: torch.Tensor) -> torch.Tensor:
        _ranks(mesh, axis, shards, "the shard stack")
        return shards.reshape(-1, *shards.shape[2:])

    return _pull


def ps_push(mesh: Mesh, axis: str = "shard", reduce_axis: str | None = None) -> Fn:
    """Grad push: each shard owner receives the slice of the gradient it
    owns, as the stack ``(n, size // n, ...)``.

    Without ``reduce_axis`` the gradient is the replicated ``(size, ...)``
    vector and the push is a slice.  With ``reduce_axis`` (the worker axis)
    it is the ``(n_workers, size, ...)`` stack of per-worker gradients,
    summed over the workers first: the servers' per-client accumulation
    collapsed into one reduce."""

    def _push(grad: torch.Tensor) -> torch.Tensor:
        n = mesh.size(axis)
        if reduce_axis is not None:
            _ranks(mesh, reduce_axis, grad, "the worker gradient stack")
            grad = grad.sum(0)
        else:
            mesh.check_device(grad, "the gradient")
        return _owner_slices(grad, n)

    return _push


def ps_pushpull(
    mesh: Mesh, apply_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    axis: str = "shard",
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """One full PS round: push the gradient (each owner's slice), apply the
    server rule on the shards, pull the updated params.

    ``apply_fn(p_shards, g_shards) -> p_shards`` is the shard rule, given
    the whole ``(n, s)`` stack at once: it must act row by row (an
    elementwise rule does), which is one launch where the reference maps it
    over the devices.  Takes ``(p_shards (n, s), full_grad (n * s,))`` and
    returns ``(new_full_params, new_p_shards)``; the first is the second
    seen flat."""

    def _round(p_shards: torch.Tensor, full_grad: torch.Tensor):
        n = _ranks(mesh, axis, p_shards, "the param shard stack")
        mesh.check_device(full_grad, "the gradient")
        p_shards = apply_fn(p_shards, _owner_slices(full_grad, n))
        return p_shards.reshape(-1, *p_shards.shape[2:]), p_shards

    return _round


def psum(mesh: Mesh, axis: str) -> Fn:
    """The sum over ``axis``'s ranks, ``(n, ...) -> (...)``, as JAX's
    ``psum`` gives every rank of the axis its replicated result.  The ranks
    are added one at a time in rank order, ``((x0 + x1) + x2) + ...``: that
    order fixes the result's bits, where a reduction kernel would choose
    its own.  Differentiable: the gradient of each rank's block is the
    result's."""

    def _psum(blocks: torch.Tensor) -> torch.Tensor:
        n = _ranks(mesh, axis, blocks, "the rank stack")
        out = blocks[0]
        for r in range(1, n):
            out = out + blocks[r]
        return out

    return _psum


def ring_shift(mesh: Mesh, axis: str, *, reverse: bool = False) -> Fn:
    """Neighbour exchange over ``axis``: each rank hands its block to the
    next rank on the ring (``reverse``: to the previous one).  The step of
    ring attention."""
    step = -1 if reverse else 1

    def _shift(blocks: torch.Tensor) -> torch.Tensor:
        _ranks(mesh, axis, blocks, "the block stack")
        return torch.roll(blocks, step, dims=0)

    return _shift


def allreduce_mean(mesh: Mesh, axis: str = "dp") -> Fn:
    """Mean over the worker axis, every rank receiving it: the sync-DP
    gradient combine.  The sum over the ranks divided by their count, as
    JAX's ``pmean`` computes it."""

    def _mean(x: torch.Tensor) -> torch.Tensor:
        n = _ranks(mesh, axis, x, "the worker stack")
        return (x.sum(0, keepdim=True) / n).expand_as(x).contiguous()

    return _mean


def measure_ps_pushpull(mb: float, rounds: int = 20,
                        device: torch.device | str = "cuda") -> dict:
    """Measured PS push/pull bandwidth over the mesh's ``shard`` axis, with
    the reference's payload sizing and formula (``2*size*4/per_round``
    MB/s, after ``asyncsgd/ptest.lua``) and keys.  One plain-add round
    (:func:`ps_pushpull`) is timed by
    :func:`mpit_tpu_torch.utils.timing.timed_per_call` with its
    publishable stop rule (``auto_scale``, ``min_ratio`` 8).  On the one
    card ``shard`` is 1, so the round is the add and no transfer; the
    work must lie on a CUDA device."""
    from mpit_tpu_torch.parallel.mesh import make_mesh
    from mpit_tpu_torch.utils.timing import timed_per_call

    mesh = make_mesh(dp=1, device=device)  # every device on the shard axis
    n = mesh.shape["shard"]
    size = int(mb * (1 << 20) / 4 // n * n)
    roundtrip = ps_pushpull(mesh, lambda p, g: p + g)
    p_shards = torch.zeros((n, size // n), dtype=torch.float32, device=mesh.device)
    grad = torch.ones((size,), dtype=torch.float32, device=mesh.device)
    per_round = timed_per_call(roundtrip, p_shards, grad, iters=rounds,
                               auto_scale=True, min_ratio=8.0)
    mbs = 2 * size * 4 / per_round / 2**20  # reference formula, per round
    return {
        "mbs": mbs, "per_chip": mbs / n, "devices": n,
        "payload_mb": size * 4 / 2**20, "ms_per_round": per_round * 1e3,
    }
