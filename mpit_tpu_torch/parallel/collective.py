"""Collective primitives on the port's meshes — the port of
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

Over a mesh whose ``dp`` axis spans a group of processes
(:mod:`mpit_tpu_torch.parallel.mesh`), each process stacks its own block
of ``dp``.  The reductions over ``dp`` (``psum``, ``allreduce_mean``,
``ps_push(..., reduce_axis="dp")``) first **all-gather** every process's
block into the whole ``(dp, ...)`` stack, in rank order, and then run the
one-process reduction over that stack: every process holds the same
bits, those of a one-process run at the same ``dp``.  That parity has a
price: the all-gather moves ``dp x size`` floats into each process where
an all-reduce would move ``size`` (at the flagship widths, dp 4 x 544,522
floats, 8.7 MB an EASGD exchange).  :func:`gather` is the all-gather
itself (a checkpoint's rows, an epoch's losses) and :func:`process_mean`
the mean of one tensor a process, added in process order (sync-DP's and
the LM's gradient of the global batch).  The ring transfer and the
shard-axis collectives stay inside a process: over an axis that spans
processes they raise ``NotImplementedError`` (ROADMAP §A item 3).

The JAX module's ``shard_map`` version shim has no counterpart.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from mpit_tpu_torch.parallel.mesh import Mesh

Fn = Callable[[torch.Tensor], torch.Tensor]


def _ranks(mesh: Mesh, axis: str, x: torch.Tensor, what: str) -> int:
    """The rank count of ``axis`` in this process, checking that ``x``
    stacks that many blocks on the mesh's device."""
    n = mesh.local_size(axis)
    mesh.check_device(x, what)
    if x.dim() < 1 or x.shape[0] != n:
        whose = (f"this process's {n} of the {mesh.size(axis)}" if mesh.spans(axis)
                 else f"the {n}")
        raise ValueError(f"{what} must stack {whose} ranks of axis {axis!r} first, "
                         f"got shape {tuple(x.shape)}")
    return n


def _in_process(mesh: Mesh, axis: str, op: str) -> None:
    """Raise where ``axis`` spans processes: ``op`` moves blocks between
    ranks, which the port does inside a process only."""
    if mesh.spans(axis):
        raise NotImplementedError(
            f"{op} over {axis!r}, which spans {mesh.processes} processes: the port "
            "moves blocks between processes only by all-gather (ROADMAP §A item 3)")


def _all_gather(x: torch.Tensor, processes: int) -> torch.Tensor:
    """Every process's ``x`` stacked along axis 0 in process order: one
    all-gather over the default group (NCCL, or gloo, which carries a card's
    tensors itself)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(processes)]
    torch.distributed.all_gather(parts, x)
    return torch.cat(parts)


def _whole(mesh: Mesh, axis: str, x: torch.Tensor, what: str) -> torch.Tensor:
    """The whole ``(n, ...)`` stack of ``axis`` from this process's block:
    ``x`` itself where the axis lies in this process."""
    _ranks(mesh, axis, x, what)
    return _all_gather(x, mesh.processes) if mesh.spans(axis) else x


def gather(mesh: Mesh, axis: str = "dp") -> Fn:
    """This process's block of ``axis``'s ranks -> the whole ``(n, ...)``
    stack, in rank order, in every process."""

    def _gather(blocks: torch.Tensor) -> torch.Tensor:
        return _whole(mesh, axis, blocks, "the rank stack")

    return _gather


def process_mean(mesh: Mesh) -> Fn:
    """The mean over the mesh's processes of one tensor each: all gathered
    in process order, added one at a time in that order, divided by their
    count.  ``x`` itself in a one-process mesh."""

    def _mean(x: torch.Tensor) -> torch.Tensor:
        if mesh.processes == 1:
            return x
        mesh.check_device(x, "the tensor")
        parts = _all_gather(x[None], mesh.processes)
        out = parts[0]
        for r in range(1, mesh.processes):
            out = out + parts[r]
        return out / mesh.processes

    return _mean


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
    _in_process(mesh, axis, "ps_pull")

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
    collapsed into one reduce.  Where ``reduce_axis`` spans processes, the
    stack is each process's block of it, all-gathered before the sum."""
    _in_process(mesh, axis, "ps_push")

    def _push(grad: torch.Tensor) -> torch.Tensor:
        n = mesh.size(axis)
        if reduce_axis is not None:
            grad = _whole(mesh, reduce_axis, grad, "the worker gradient stack").sum(0)
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
    _in_process(mesh, axis, "ps_pushpull")

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
    result's (in one process).  Over an axis that spans processes the
    blocks are this process's, all-gathered first."""

    def _psum(blocks: torch.Tensor) -> torch.Tensor:
        blocks = _whole(mesh, axis, blocks, "the rank stack")
        n = blocks.shape[0]
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
    _in_process(mesh, axis, "ring_shift")

    def _shift(blocks: torch.Tensor) -> torch.Tensor:
        _ranks(mesh, axis, blocks, "the block stack")
        return torch.roll(blocks, step, dims=0)

    return _shift


def allreduce_mean(mesh: Mesh, axis: str = "dp") -> Fn:
    """Mean over the worker axis, every rank receiving it: the sync-DP
    gradient combine.  The sum over the ranks divided by their count, as
    JAX's ``pmean`` computes it; over an axis that spans processes, the sum
    of the all-gathered stack, each process receiving its block."""

    def _mean(x: torch.Tensor) -> torch.Tensor:
        full = _whole(mesh, axis, x, "the worker stack")
        return (full.sum(0, keepdim=True) / full.shape[0]).expand_as(x).contiguous()

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
