"""Transformer-LM TrainState for the PS stack.

The port of ``mpit_tpu/lm/model.py``.  Assembles
:class:`mpit_tpu_torch.models.transformer.TinyDecoder` (whose attention is
the flash kernels K4/K5 on the card and the plain
:func:`~mpit_tpu_torch.ops.flash_attention.attention_reference` on the
CPU) into the flat-vector calling convention the parameter server shards:
a :class:`~mpit_tpu_torch.models.flat.FlatModel` plus a next-token NLL
over packed token grids, differentiated by autograd through the flat
vector, and the params+optimizer tree (:func:`train_state_tree`) that
:mod:`mpit_tpu_torch.lm.plan` drives the partition rules over.

Attention runs in the model's dtype, float32, as in the JAX LM.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpit_tpu_torch.models.flat import FlatModel, flatten_module
from mpit_tpu_torch.models.transformer import TinyDecoder, default_attn
from mpit_tpu_torch.utils.platform import resolve_device


class LmModel(NamedTuple):
    """A built LM: the module, its flat view, and the loss closures."""

    module: Any
    flat: FlatModel
    loss: Callable[..., torch.Tensor]          # (w, tokens) -> scalar NLL
    value_and_grad: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    seq_len: int
    vocab: int


def _resolve_flash(use_flash: Optional[bool], device: torch.device) -> bool:
    """Default: the flash kernels on the card, the plain reference on the
    CPU (which autograd differentiates without a recompute pass) — the
    JAX package's "Pallas on the TPU, jnp elsewhere"."""
    if use_flash is not None:
        return bool(use_flash)
    return device.type == "cuda"


def build(*, vocab: int = 256, d_model: int = 64, n_heads: int = 4,
          n_layers: int = 2, seq_len: int = 128, seed: int = 0,
          use_flash: Optional[bool] = None, device: Any = None,
          w0: Any = None) -> LmModel:
    """Build the decoder, flatten its params onto ``device`` (None: the
    card), and close over the next-token NLL.  ``max_len`` is pinned to
    ``seq_len``, as in the JAX package.  ``w0`` (a flax parameter tree or
    the JAX package's flat ``LmModel.flat.w0``) replaces the seeded draw,
    which is the port's own (:func:`flatten_module`)."""
    dev = resolve_device(device) if not isinstance(device, torch.device) else device
    module = TinyDecoder(
        vocab=vocab, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
        max_len=seq_len,
        attn_fn=default_attn(causal=True, use_flash=_resolve_flash(use_flash, dev)))
    fm = flatten_module(module, seed, dev)
    if w0 is not None:
        fm = FlatModel(module, fm.from_jax_params(w0).to(dev))

    def loss(w: torch.Tensor, tokens: Any) -> torch.Tensor:
        # tokens: (B, seq_len + 1) int32 — packed, every cell real.
        tokens = torch.as_tensor(tokens, device=w.device).long()
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        logp = fm.apply_flat(w, inputs)  # (B, L, V) log-probs
        return -torch.take_along_dim(logp, targets[..., None], dim=-1).mean()

    def value_and_grad(w: torch.Tensor, tokens: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.enable_grad():
            leaf = w.detach().requires_grad_(True)
            value = loss(leaf, tokens)
            (grad,) = torch.autograd.grad(value, leaf)
        return value.detach(), grad

    return LmModel(module=module, flat=fm, loss=loss, value_and_grad=value_and_grad,
                   seq_len=seq_len, vocab=vocab)


def train_state_tree(params: Any, rule_name: str = "adam") -> Dict[str, Any]:
    """The params+optimizer tree the shard plan is computed over: a
    TrainState-shaped dict whose ``opt_state`` mirrors ``params`` (flax
    names, as :meth:`FlatModel.to_jax_params` gives them) with one
    :mod:`mpit_tpu_torch.optim.rules` state dict per parameter (the
    per-parameter optimizer slots the servers allocate beside their
    shard).  Leaves are numpy arrays, made on the host."""
    from mpit_tpu_torch.optim import rules as _rules

    rule = _rules.make(rule_name)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        state = rule.init(torch.as_tensor(np.asarray(node)))
        return {k: v.numpy() for k, v in state.items()}

    return {"params": params, "opt_state": walk(params)}
