"""Pipeline parallelism on the one-card stand-in mesh: a GPipe microbatch
pipeline over a ``pp`` axis — the port of ``mpit_tpu/parallel/pipeline.py``.

The JAX package gives each device of the ``pp`` axis one stage's
parameters (stacked leaves, sharded on their leading axis), moves the
microbatched activations stage to stage by ``ppermute`` (one neighbour hop
a tick), and runs the schedule as a ``lax.scan`` of ``m + n - 1`` ticks,
the GPipe fill and drain.  Here the ``n`` stages are virtual ranks of one
card.  The schedule is the same: at tick ``t`` stage ``i`` runs microbatch
``t - i``; the stages' outputs, stacked with the ranks first, move one hop
by :func:`mpit_tpu_torch.parallel.collective.ring_shift`; the last stage's
emits are scattered back to microbatch order and broadcast by one
:func:`~mpit_tpu_torch.parallel.collective.psum` over the ranks (the other
ranks' rows are zeros).

One difference, which changes no result: on one card the stages of a
tick cannot overlap, so the port skips the (stage, tick) cells whose input
is not a live microbatch (the fill and drain bubble) and makes ``n * m``
stage calls.  The JAX body computes those cells (on the zero carry, or on
the clamped last microbatch) and masks them out with ``jnp.where``: their
outputs never reach the result and their gradients are zero, so skipping
them leaves the forward and the backward as they are.  A skipped cell's
carry is zeros, as the reference's initial carry.

The stages are called one at a time, so ``stage_fn`` may launch kernels
whose ``autograd.Function`` has no ``vmap`` rule (K4's): nothing here maps
over stages.

Where ``pp`` spans the processes of a group, each process runs its own
stages (its range of the axis) on the same schedule, as the JAX package's
devices do, in one autograd node (:class:`_PipelineAcross`):

- it takes its stages' rows of the whole stacked leaves, and gives their
  gradients back whole, the line's all-gathered in one collective;
- only stage 0's process feeds the microbatches, and only the last
  stage's emits; the last stage's outputs are broadcast over the line, and
  the microbatches' gradient from stage 0's process;
- the carry crosses processes by :class:`~mpit_tpu_torch.parallel.
  collective.RingHop`, one hop a tick forward and one back, which every
  process posts on every tick, in one order, whether its cells are live or
  bubbles: a process that skipped one would leave its neighbour waiting.
  The last tick's hop, whose carry no stage reads, is skipped by all.

Its backward walks the ticks in reverse, each live cell's part of the
graph by ``torch.autograd.grad``, the hops between ticks; a stage's
gradients add its microbatches' in reverse tick order, the order in which
one process's autograd adds them.  Autograd alone could not keep the hops
in step: it runs a hop's backward only where the hop's carry reaches the
loss, which differs from process to process.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Sequence

import torch

from mpit_tpu_torch.parallel import collective
from mpit_tpu_torch.parallel.collective import RingHop, psum, ring_shift, take_cuts
from mpit_tpu_torch.parallel.mesh import Mesh

Params = Mapping[str, Any]  # str -> tensor, or a nested mapping of them


def _tree_map(fn: Callable, *trees: Params) -> Dict[str, Any]:
    first = trees[0]
    return {key: (_tree_map(fn, *(t[key] for t in trees))
                  if isinstance(first[key], Mapping) else fn(*(t[key] for t in trees)))
            for key in first}


def stack_stage_params(params_per_stage: Sequence[Params]) -> Dict[str, Any]:
    """Stack a list of per-stage parameter dicts (nested dicts of tensors,
    one structure) into the layout :func:`pipeline` takes: every leaf with
    a leading stage axis."""
    return _tree_map(lambda *leaves: torch.stack(leaves), *params_per_stage)


def _live(t: int, i: int, m: int) -> bool:
    """Whether a live microbatch reaches stage ``i`` at tick ``t``."""
    return 0 <= t - i < m


class _PipelineAcross(torch.autograd.Function):
    """This process's stages of a pipeline whose ``pp`` spans processes:
    ``(xs, *leaves) -> outs``, the leaves this process's stages' rows and
    ``outs`` the last stage's, broadcast over the line."""

    @staticmethod
    def forward(ctx, run: "_Across", keys: Sequence[tuple], xs: torch.Tensor,
                *leaves: torch.Tensor):
        ctx.run = run
        n, m, lo, hi = run.n, xs.shape[0], run.lo, run.hi
        params = [[leaf[j].detach().requires_grad_(leaf.requires_grad) for leaf in leaves]
                  for j in range(hi - lo)]
        feed = xs.requires_grad
        zeros = xs.new_zeros(xs.shape[1:])
        carry = zeros.expand(hi - lo, *xs.shape[1:])
        cells, emits = {}, [zeros] * m  # (t, j) -> (input leaf, output)
        with torch.enable_grad():
            for t in range(m + n - 1):
                ys = []
                for j, i in enumerate(range(lo, hi)):
                    if not _live(t, i, m):
                        ys.append(zeros)
                        continue
                    x = (xs[t] if i == 0 else carry[j]).detach().requires_grad_(
                        feed if i == 0 else True)
                    y = run.stage_fn(_unflatten(keys, params[j]), x)
                    cells[t, j] = (x, y)
                    ys.append(y.detach())
                if hi == n and t >= n - 1:
                    emits[t - (n - 1)] = ys[-1]
                if t < m + n - 2:  # the last tick's carry is read by no stage
                    (carry,) = run.hop.move([torch.stack(ys)], 1)
        ctx.cells, ctx.params, ctx.m = cells, params, m
        outs = torch.stack(emits)
        collective.broadcast_line(outs, run.line, run.line.processes[-1])
        # one process's psum adds the other stages' zero rows first: 0 + outs
        return torch.zeros_like(outs) + outs

    @staticmethod
    def backward(ctx, g_outs):
        run, cells, params, m = ctx.run, ctx.cells, ctx.params, ctx.m
        n, lo, hi = run.n, run.lo, run.hi
        want = [li for li, need in enumerate(ctx.needs_input_grad[3:]) if need]
        acc: List[Dict[int, torch.Tensor]] = [{} for _ in range(hi - lo)]
        dxs = [torch.zeros_like(g_outs[0]) for _ in range(m)]
        g_carry = g_outs.new_zeros((hi - lo, *g_outs.shape[1:]))
        for t in reversed(range(m + n - 1)):
            # the carry of the last tick reached no stage: no hop
            g_ys = (run.hop.move([g_carry], -1)[0] if t < m + n - 2
                    else torch.zeros_like(g_carry))
            if hi == n and t >= n - 1:
                g_ys[-1] = g_ys[-1] + g_outs[t - (n - 1)]
            g_carry = torch.zeros_like(g_carry)  # the hop of tick t - 1 brought it
            for j, i in enumerate(range(lo, hi)):
                if (t, j) not in cells:
                    continue
                x, y = cells.pop((t, j))
                feeds = [x] if x.requires_grad else []
                grads = torch.autograd.grad(y, feeds + [params[j][li] for li in want],
                                            g_ys[j], allow_unused=True)
                if feeds:
                    if i == 0:
                        dxs[t] = grads[0]
                    else:
                        g_carry[j] = grads[0]
                for li, g in zip(want, grads[len(feeds):]):
                    if g is not None:  # microbatches added in reverse tick order
                        acc[j][li] = acc[j][li] + g if li in acc[j] else g
        g_xs = None
        if ctx.needs_input_grad[2]:
            g_xs = torch.stack(dxs)
            collective.broadcast_line(g_xs, run.line, run.line.processes[0])
        g_leaves: List[Any] = [None] * len(ctx.needs_input_grad[3:])
        for li in want:
            g_leaves[li] = torch.stack([acc[j][li] if li in acc[j]
                                        else torch.zeros_like(params[j][li])
                                        for j in range(hi - lo)])
        return (None, None, g_xs, *g_leaves)


class _Across:
    """What :class:`_PipelineAcross` needs of the mesh and the stage."""

    def __init__(self, mesh: Mesh, axis: str, stage_fn: Callable):
        self.n = mesh.size(axis)
        self.lo, self.hi = mesh.box[axis]
        self.line = mesh.line(axis)
        self.hop = RingHop(mesh, axis)
        self.stage_fn = stage_fn


def _unflatten(keys: Sequence[tuple], leaves: Sequence[torch.Tensor]) -> Dict[str, Any]:
    """The nested dict of :func:`_flatten`'s paths and ``leaves``."""
    tree: Dict[str, Any] = {}
    for path, leaf in zip(keys, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def _flatten(tree: Params, prefix: tuple = ()) -> List[tuple]:
    """``(path, leaf)`` of every leaf of a nested dict, in its order."""
    out = []
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out += _flatten(value, prefix + (key,))
        else:
            out.append((prefix + (key,), value))
    return out


def pipeline(mesh: Mesh, stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
             axis: str = "pp"):
    """Build ``fn(stacked_params, microbatches) -> outputs``.

    - ``stacked_params``: nested dict of tensors whose leaves lead with the
      stage axis, of size ``n = mesh.size(axis)`` (stage ``i``'s slice is
      stage ``i``'s parameters); whole in every process where ``axis``
      spans processes (each runs its own stages' rows);
    - ``microbatches``: ``(m, B, ...)``, ``m`` microbatches;
    - ``stage_fn(params_i, x) -> y`` with ``y.shape == x.shape`` (equal
      inter-stage width, the GPipe contract).  For an ``nn.Module`` stage,
      ``torch.func.functional_call(module, params_i, (x,))``.

    Returns the ``(m, B, ...)`` outputs of the last stage, in every
    process.  Differentiable by autograd, into the stacked leaves and the
    microbatches."""
    n = mesh.size(axis)
    if mesh.spans(axis):

        def across(stacked: Params, xs: torch.Tensor) -> torch.Tensor:
            mesh.check_device(xs, "the microbatches")
            flat = _flatten(stacked)
            rows = take_cuts(mesh, axis, (0,) * len(flat))(*(leaf for _, leaf in flat))
            return _PipelineAcross.apply(_Across(mesh, axis, stage_fn),
                                         tuple(path for path, _ in flat), xs, *rows)

        return across

    shift = ring_shift(mesh, axis)
    reduce = psum(mesh, axis)

    def fn(stacked: Params, xs: torch.Tensor) -> torch.Tensor:
        mesh.check_device(xs, "the microbatches")
        m = xs.shape[0]
        params: List[Dict[str, Any]] = [_tree_map(lambda a, i=i: a[i], stacked)
                                        for i in range(n)]
        zeros = xs.new_zeros(xs.shape[1:])
        carry = zeros.expand(n, *xs.shape[1:])
        emits: List[torch.Tensor] = [zeros] * m
        for t in range(m + n - 1):
            ys = []
            for i in range(n):
                if _live(t, i, m):  # a live microbatch reaches stage i
                    ys.append(stage_fn(params[i], xs[t] if i == 0 else carry[i]))
                else:  # fill or drain: the reference's masked cell
                    ys.append(zeros)
            if t >= n - 1:  # microbatch t - (n - 1) leaves the last stage
                emits[t - (n - 1)] = ys[-1]
            carry = shift(torch.stack(ys))
        outs = torch.stack(emits)
        # The broadcast from the last stage: every other rank holds zeros.
        return reduce(torch.stack([torch.zeros_like(outs)] * (n - 1) + [outs]))

    return fn
