"""Flat-parameter view over a ``torch.nn`` module (the getParameters() analog).

The port of :mod:`mpit_tpu.models.flat`.  The reference trains on one flat
f32 vector laid out by ``ravel_pytree`` over flax's parameter tree; this
module keeps that layout exactly:

- leaves in sorted key order at every level (``Conv_0/bias``,
  ``Conv_0/kernel``, ``Conv_1/...``, ``Dense_0/...``), so each bias comes
  before its kernel;
- each leaf in C order, in flax's own shapes (the modules of
  :mod:`mpit_tpu_torch.models.mnist` hold them that way).

:meth:`FlatModel.apply_flat` views the vector as the module's parameters
and runs the module through ``torch.func.functional_call``, so autograd
(and ``torch.func.grad``/``vmap``) differentiate straight into the flat
vector.  :meth:`FlatModel.from_jax_params` and
:meth:`FlatModel.to_jax_params` carry a flax parameter tree (as numpy
arrays) into the vector and back.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# flax's lecun_normal: variance_scaling(1, fan_in, truncated_normal); the
# constant is the std of a standard normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def param_spec(module: nn.Module) -> List[Tuple[str, Tuple[int, ...]]]:
    """``(name, shape)`` of every parameter in ``ravel_pytree``'s order:
    keys sorted level by level (``Conv_0.bias`` before ``Conv_0.kernel``)."""
    return sorted(((name, tuple(p.shape)) for name, p in module.named_parameters()),
                  key=lambda item: tuple(item[0].split(".")))


class FlatModel:
    """A module + the flat-parameter calling convention."""

    def __init__(self, module: nn.Module, w0: torch.Tensor):
        self.module = module
        self.spec = param_spec(module)
        self.size = sum(math.prod(shape) for _, shape in self.spec)
        if w0.shape != (self.size,):
            raise ValueError(f"w0 has shape {tuple(w0.shape)}, the module "
                             f"needs ({self.size},)")
        self.w0 = w0

    def unravel(self, w: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Views of ``w`` named and shaped as the module's parameters."""
        out, off = {}, 0
        for name, shape in self.spec:
            n = math.prod(shape)
            out[name] = w[off:off + n].view(shape)
            off += n
        return out

    def apply_flat(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.module, self.unravel(w), (x,))

    def from_jax_params(self, params: Mapping[str, Any]) -> torch.Tensor:
        """A flax parameter tree (numpy leaves) -> the flat f32 vector."""
        leaves = []
        for name, shape in self.spec:
            node: Any = params
            for key in name.split("."):
                node = node[key]
            arr = np.asarray(node, np.float32)
            if arr.shape != shape:
                raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
            leaves.append(arr.reshape(-1))
        n_leaves = _count_leaves(params)
        if n_leaves != len(self.spec):
            raise ValueError(f"params hold {n_leaves} leaves, the module "
                             f"{len(self.spec)}")
        return torch.from_numpy(np.concatenate(leaves))

    def to_jax_params(self, w: torch.Tensor) -> Dict[str, Any]:
        """The flat vector -> a flax-shaped parameter tree of numpy arrays."""
        tree: Dict[str, Any] = {}
        for name, view in self.unravel(w.detach().cpu()).items():
            *path, leaf = name.split(".")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = view.numpy().copy()
        return tree


def _count_leaves(tree: Any) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def flatten_module(module: nn.Module, seed: int,
                   device: torch.device | str = "cpu") -> FlatModel:
    """Seeded init in flax's defaults: kernels lecun-normal (truncated
    normal, std ``sqrt(1/fan_in)``), biases zero.  The draws come from a
    CPU ``torch.Generator``, so they differ from flax's for the same seed;
    tests share one ``w0`` through :meth:`FlatModel.from_jax_params`."""
    gen = torch.Generator().manual_seed(int(seed))
    leaves = []
    for name, shape in param_spec(module):
        leaf = torch.zeros(shape)
        if name.endswith("kernel"):
            std = math.sqrt(1.0 / math.prod(shape[:-1])) / _TRUNC_STD
            nn.init.trunc_normal_(leaf, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
        leaves.append(leaf.reshape(-1))
    module.to(device)
    return FlatModel(module, torch.cat(leaves).to(device))


def value_and_grad_nll(flat: FlatModel) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """``vgf(w, xb, yb) -> (loss, grad)``: the mean NLL of the labels under
    ``flat``'s log-probs and its gradient with respect to the flat vector.
    Built on ``torch.func`` so callers may ``vmap`` it over worker rows."""

    def loss_fn(w, xb, yb):
        logp = flat.apply_flat(w, xb)
        return -torch.take_along_dim(logp, yb[:, None].long(), dim=1).mean()

    grad_and_value = torch.func.grad_and_value(loss_fn)

    def vgf(w, xb, yb):
        grad, loss = grad_and_value(w, xb, yb)
        return loss, grad

    return vgf


@torch.no_grad()
def error_rate(flat: FlatModel, w: torch.Tensor, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """Share of ``x`` whose arg-max class is not ``y`` (a 0-d tensor)."""
    pred = flat.apply_flat(w, x).argmax(dim=1)
    return (pred != y).float().mean()
