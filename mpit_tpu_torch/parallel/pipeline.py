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
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Sequence

import torch

from mpit_tpu_torch.parallel.collective import psum, ring_shift
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


def pipeline(mesh: Mesh, stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
             axis: str = "pp"):
    """Build ``fn(stacked_params, microbatches) -> outputs``.

    - ``stacked_params``: nested dict of tensors whose leaves lead with the
      stage axis, of size ``n = mesh.size(axis)`` (stage ``i``'s slice is
      stage ``i``'s parameters);
    - ``microbatches``: ``(m, B, ...)``, ``m`` microbatches;
    - ``stage_fn(params_i, x) -> y`` with ``y.shape == x.shape`` (equal
      inter-stage width, the GPipe contract).  For an ``nn.Module`` stage,
      ``torch.func.functional_call(module, params_i, (x,))``.

    Returns the ``(m, B, ...)`` outputs of the last stage.  Differentiable
    by autograd, into the stacked leaves and the microbatches."""
    n = mesh.size(axis)
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
                if 0 <= t - i < m:  # a live microbatch reaches stage i
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
