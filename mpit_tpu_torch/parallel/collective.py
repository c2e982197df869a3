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

Over a mesh whose axes span a group of processes
(:mod:`mpit_tpu_torch.parallel.mesh`), each process stacks its own range
of each axis, and every collective over an axis that spans goes over the
``torch.distributed`` group of this process's **line** of that axis
(:meth:`~mpit_tpu_torch.parallel.mesh.Mesh.line`), never over the default
group: at ``dp 2 x sp 2`` over four processes the ``dp`` gather of
process 0 runs over processes 0 and 2 only.  Each collective only moves
data, so it gives every process the bits of the one-process collective:

- the reductions (``psum``, ``allreduce_mean``, ``ps_push(...,
  reduce_axis=)``) **all-gather** the line's blocks into the whole
  ``(n, ...)`` stack, in rank order, and run the one-process reduction over
  it.  That parity has a price: the all-gather moves ``n x size`` floats
  into each process where an all-reduce would move ``size`` (at the
  flagship widths, dp 4 x 544,522 floats, 8.7 MB an EASGD exchange);
- :func:`gather` is the all-gather itself (a checkpoint's rows, an
  epoch's losses) and :func:`process_mean` the mean of one tensor a process
  of the line, added in rank order (sync-DP's and the LM's gradient of the
  global batch); :func:`replicate` gives a line its first process's
  copy of a value every process of it computed;
- pull is an all-gather of the shard blocks, and push lets each process
  keep the owner rows it holds;
- the ring transfer rolls the process's block in place and moves one
  boundary block a tensor to the next process of the line, receiving one
  from the previous (:class:`RingHop`), differentiable, its backward the
  reverse hop.

The JAX module's ``shard_map`` version shim has no counterpart.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from mpit_tpu_torch.parallel.mesh import Line, Mesh

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


def _gather_line(x: torch.Tensor, line: Line) -> torch.Tensor:
    """Every process's ``x`` on ``line`` stacked along axis 0, in rank
    order: one all-gather over the line's group (NCCL, or gloo, which
    carries a card's tensors itself)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(line.size)]
    torch.distributed.all_gather(parts, x, group=line.group)
    return torch.cat(parts)


def _whole(mesh: Mesh, axis: str, x: torch.Tensor, what: str) -> torch.Tensor:
    """The whole ``(n, ...)`` stack of ``axis`` from this process's block:
    ``x`` itself where the axis lies in this process."""
    _ranks(mesh, axis, x, what)
    return _gather_line(x, mesh.line(axis)) if mesh.spans(axis) else x


def gather(mesh: Mesh, axis: str = "dp") -> Fn:
    """This process's block of ``axis``'s ranks -> the whole ``(n, ...)``
    stack, in rank order, in every process."""

    def _gather(blocks: torch.Tensor) -> torch.Tensor:
        return _whole(mesh, axis, blocks, "the rank stack")

    return _gather


def process_mean(mesh: Mesh, axis: str = "dp") -> Fn:
    """The mean over the processes of this process's line of ``axis`` of
    one tensor each: all gathered in rank order, added one at a time in
    that order, divided by their count.  ``x`` itself where ``axis`` lies in
    this process (the processes of one ``dp`` row, which differ on ``sp``
    or ``shard``, hold the same tensor and take no part)."""

    def _mean(x: torch.Tensor) -> torch.Tensor:
        if not mesh.spans(axis):
            return x
        mesh.check_device(x, "the tensor")
        line = mesh.line(axis)
        parts = _gather_line(x[None], line)
        out = parts[0]
        for r in range(1, line.size):
            out = out + parts[r]
        return out / line.size

    return _mean


def replicate(mesh: Mesh, axis: str) -> Fn:
    """One value for every process of this process's line of ``axis``: the
    line's first process's ``x``, broadcast over the line (``x`` itself
    where ``axis`` lies in this process).  The processes of a line that
    each compute the same replicated value (the dense layers' gradient
    around a ring whose ``sp`` spans them, a worker row's gradient on every
    ``shard`` owner) hold the same bits afterwards, even where the card's
    backward does not repeat its bits from run to run."""

    def _replicate(x: torch.Tensor) -> torch.Tensor:
        if not mesh.spans(axis):
            return x
        mesh.check_device(x, "the tensor")
        line = mesh.line(axis)
        x = x.contiguous()
        torch.distributed.broadcast(x, line.processes[0], group=line.group)
        return x

    return _replicate


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
    shards, ``(n, s, ...) -> (n * s, ...)``: a view where the stack is this
    process's and contiguous; where ``axis`` spans processes the stack is
    this process's block of it, all-gathered over the line."""

    def _pull(shards: torch.Tensor) -> torch.Tensor:
        shards = _whole(mesh, axis, shards, "the shard stack")
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
    stack is each process's block of it, all-gathered before the sum;
    where ``axis`` spans processes, each process keeps the owner rows it
    holds, ``(local n, size // n, ...)``."""

    def _push(grad: torch.Tensor) -> torch.Tensor:
        n = mesh.size(axis)
        if reduce_axis is not None:
            grad = _whole(mesh, reduce_axis, grad, "the worker gradient stack").sum(0)
        else:
            mesh.check_device(grad, "the gradient")
        return _owner_slices(grad, n)[mesh.local_slice(axis)]

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
    seen flat, or, where ``axis`` spans processes (``p_shards`` this
    process's owner rows), every process's pulled."""
    pull = ps_pull(mesh, axis)

    def _round(p_shards: torch.Tensor, full_grad: torch.Tensor):
        _ranks(mesh, axis, p_shards, "the param shard stack")
        mesh.check_device(full_grad, "the gradient")
        owned = _owner_slices(full_grad, mesh.size(axis))[mesh.local_slice(axis)]
        p_shards = apply_fn(p_shards, owned)
        return pull(p_shards), p_shards

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


class RingHop:
    """The ring transfer's hop between processes over one axis's line: each
    of a call's block stacks sends its boundary block (its last rank's, or
    its first's for the reverse hop) to the next process of the line and
    receives the previous process's into its first (or last) rank, the rest
    rolled in place.  All of a call's sends and receives go in one
    ``batch_isend_irecv``, so no process waits on another to post, and
    each stack's pair carries its own tag.  The path is the group's
    backend's: NCCL moves the card's blocks itself; gloo moves host
    tensors, so a card's boundary blocks are copied to the host and back
    (gloo's point-to-point ops take no CUDA tensor)."""

    def __init__(self, mesh: Mesh, axis: str):
        self.line = mesh.line(axis)
        self.staged = mesh.backend == "gloo" and mesh.device.type == "cuda"

    def move(self, blocks: Sequence[torch.Tensor], step: int) -> Tuple[torch.Tensor, ...]:
        """``blocks`` moved one hop along the ring (``step`` 1) or back
        (``step`` -1)."""
        dist = torch.distributed
        dst, src = ((self.line.next, self.line.prev) if step > 0
                    else (self.line.prev, self.line.next))
        ops, bufs = [], []
        for tag, b in enumerate(blocks):
            edge = b[-1 if step > 0 else 0]
            edge = edge.to("cpu") if self.staged else edge.contiguous()
            buf = torch.empty_like(edge)
            ops += [dist.P2POp(dist.isend, edge, dst, self.line.group, tag),
                    dist.P2POp(dist.irecv, buf, src, self.line.group, tag)]
            bufs.append(buf)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        out = []
        for b, buf in zip(blocks, bufs):
            buf = buf.to(b.device)[None]
            out.append(torch.cat([buf, b[:-1]] if step > 0 else [b[1:], buf]))
        return tuple(out)


class _Hop(torch.autograd.Function):
    """:meth:`RingHop.move` under autograd: the gradients take the reverse
    hop."""

    @staticmethod
    def forward(ctx, hop: RingHop, step: int, *blocks):
        ctx.hop, ctx.step = hop, step
        return hop.move(blocks, step)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.hop.move(grads, -ctx.step))


def ring_shift(mesh: Mesh, axis: str, *, reverse: bool = False):
    """Neighbour exchange over ``axis``: each rank hands its block to the
    next rank on the ring (``reverse``: to the previous one).  The step of
    ring attention.  The fn takes one or more block stacks and returns
    each shifted (one tensor for one stack, a tuple for more): inside a
    process ``torch.roll``; where ``axis`` spans processes, one hop between
    processes for all of them (:class:`RingHop`), differentiable."""
    step = -1 if reverse else 1
    hop = RingHop(mesh, axis) if mesh.spans(axis) else None

    def _shift(*blocks: torch.Tensor):
        for b in blocks:
            _ranks(mesh, axis, b, "the block stack")
        if hop is None:
            out = tuple(torch.roll(b, step, dims=0) for b in blocks)
        else:
            out = _Hop.apply(hop, step, *blocks)
        return out[0] if len(blocks) == 1 else out

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
