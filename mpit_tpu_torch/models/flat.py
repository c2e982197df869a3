"""Flat-parameter view over a ``torch.nn`` module (the getParameters() analog).

The port of ``mpit_tpu/models/flat.py``.  The reference trains on one flat
f32 vector laid out by ``ravel_pytree`` over flax's parameter tree; this
module keeps that layout exactly:

- leaves in sorted key order at every level (``Conv_0/bias``,
  ``Conv_0/kernel``, ``Conv_1/...``, ``Dense_0/...``), so each bias comes
  before its kernel, and ``DecoderBlock_10`` before ``DecoderBlock_2``;
- each leaf in C order, in flax's own shapes (the modules of
  :mod:`mpit_tpu_torch.models.mnist` and
  :mod:`mpit_tpu_torch.models.transformer` hold them that way).

:meth:`FlatModel.apply_flat` views the vector as the module's parameters
and runs the module (or one of its methods, ``method=BiCNN.embed``)
through ``torch.func.functional_call``, so autograd (and
``torch.func.grad``/``vmap``) differentiate straight into the flat
vector.  :meth:`FlatModel.set_leaf` writes one leaf of a vector, as a
pretrained embedding matrix is put into ``w0``.
:meth:`FlatModel.from_jax_params` and
:meth:`FlatModel.to_jax_params` carry a flax parameter tree (as numpy
arrays), or the JAX package's flat vector, into the vector and back.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

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
        self._bound: Dict[Callable, nn.Module] = {}

    def unravel(self, w: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Views of ``w`` named and shaped as the module's parameters."""
        out, off = {}, 0
        for name, shape in self.spec:
            n = math.prod(shape)
            out[name] = w[off:off + n].view(shape)
            off += n
        return out

    def apply_flat(self, w: torch.Tensor, *inputs: Any,
                   method: Optional[Callable] = None) -> Any:
        """The module's ``forward`` (or ``method``, a function of the module
        and the inputs, such as ``BiCNN.embed``) on ``inputs`` with ``w``'s
        views as its parameters."""
        if method is None:
            return torch.func.functional_call(self.module, self.unravel(w), inputs)
        bound = self._bound.get(method)
        if bound is None:
            bound = self._bound[method] = _Bound(self.module, method)
        params = {f"module.{k}": v for k, v in self.unravel(w).items()}
        return torch.func.functional_call(bound, params, inputs)

    def set_leaf(self, w: torch.Tensor, name: str, value: Any) -> torch.Tensor:
        """Write ``value`` into the leaf ``name`` of ``w`` in place (e.g. the
        pretrained vocabulary into ``tower.lookup.embedding``, reference
        bicnn.lua:34); returns ``w``."""
        view = self.unravel(w)[name]
        value = torch.as_tensor(value, dtype=w.dtype)
        if tuple(value.shape) != tuple(view.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)}, the leaf "
                             f"{tuple(view.shape)}")
        with torch.no_grad():
            view.copy_(value)
        return w

    def from_jax_params(self, params: Any) -> torch.Tensor:
        """A flax parameter tree (numpy leaves), or the JAX package's flat
        vector of it (``FlatModel.w0``, the ``ravel_pytree`` layout this
        vector shares) -> the flat f32 vector."""
        if not isinstance(params, Mapping):
            flat = np.asarray(params, np.float32)
            if flat.shape != (self.size,):
                raise ValueError(f"a flat vector of shape {flat.shape}, the module "
                                 f"needs ({self.size},)")
            return torch.from_numpy(flat.copy())
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


class _Bound(nn.Module):
    """``method`` of ``module`` as a forward, for ``functional_call``."""

    def __init__(self, module: nn.Module, method: Callable):
        super().__init__()
        self.module = module
        self.method = method

    def forward(self, *inputs: Any) -> Any:
        return self.method(self.module, *inputs)


def _count_leaves(tree: Any) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def flatten_module(module: nn.Module, seed: int,
                   device: torch.device | str = "cpu") -> FlatModel:
    """Seeded init in flax's defaults: kernels lecun-normal (truncated
    normal, std ``sqrt(1/fan_in)``), embeddings normal with std
    ``sqrt(1/features)`` (``nn.Embed``'s ``variance_scaling(1, "fan_in",
    "normal", out_axis=0)``), LayerNorm scales one, biases zero.  The draws
    come from a CPU ``torch.Generator``, so they differ from flax's for the
    same seed but not between devices; tests share one ``w0`` through
    :meth:`FlatModel.from_jax_params`."""
    gen = torch.Generator().manual_seed(int(seed))
    leaves = []
    for name, shape in param_spec(module):
        leaf = torch.zeros(shape)
        if name.endswith("kernel"):
            std = math.sqrt(1.0 / math.prod(shape[:-1])) / _TRUNC_STD
            nn.init.trunc_normal_(leaf, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
        elif name.endswith("embedding"):
            leaf.normal_(0.0, math.sqrt(1.0 / shape[-1]), generator=gen)
        elif name.endswith("scale"):
            leaf.fill_(1.0)
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


def value_and_grad_nll_eager(flat: FlatModel) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """The same ``vgf`` as :func:`value_and_grad_nll`, by ``torch.autograd``
    (the same kernels, the same bits), for callers that never ``vmap`` it:
    one worker's trainer.  ``torch.func``'s first call imports
    ``torch._dynamo`` and ``sympy`` (some 840 modules), a cost every new
    worker process of a gang would pay before its first step."""

    def vgf(w, xb, yb):
        with torch.enable_grad():
            leaf = w.detach().requires_grad_(True)
            logp = flat.apply_flat(leaf, xb)
            loss = -torch.take_along_dim(logp, yb[:, None].long(), dim=1).mean()
            (grad,) = torch.autograd.grad(loss, leaf)
        return loss.detach(), grad

    return vgf


@torch.no_grad()
def error_rate(flat: FlatModel, w: torch.Tensor, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """Share of ``x`` whose arg-max class is not ``y`` (a 0-d tensor)."""
    pred = flat.apply_flat(w, x).argmax(dim=1)
    return (pred != y).float().mean()
