"""Custom layers — the reference's hand-written nn modules, in PyTorch.

The port of ``mpit_tpu/models/layers.py``:

- :func:`lp_normalize`, ``nn.Normalize``'s Lp normalization (reference
  BiCNN/Normalize.lua:20-76), whose Jacobian autograd derives;
- :func:`divide_constant`, ``nn.DivideConstant``'s ``c/x``
  (BiCNN/DivideConstant.lua:13-25);
- :func:`masked_max_pool`, the static-shape replacement for the
  reference's per-example ``nn.Max(1)`` over conv frames
  (BiCNN/bicnn.lua:78-81): padded frames are masked before the max.

The max is ``torch.amax``, whose gradient splits evenly over tied maxima,
as JAX's ``max`` does; ``torch.max(dim)`` would send all of it to one index.
"""

from __future__ import annotations

import math

import torch


def lp_normalize(x: torch.Tensor, p: float = 2.0, eps: float = 1e-10,
                 axis: int = -1) -> torch.Tensor:
    """``x / (||x||_p + eps)`` along ``axis`` (Normalize.lua:20-38)."""
    if p == math.inf:
        norm = x.abs().amax(dim=axis, keepdim=True)
    else:
        norm = x.abs().pow(p).sum(dim=axis, keepdim=True).pow(1.0 / p)
    return x / (norm + eps)


def divide_constant(x: torch.Tensor, constant: float = 1.0) -> torch.Tensor:
    """``constant / x`` elementwise (DivideConstant.lua:13-17)."""
    return constant / x


def masked_max_pool(frames: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Max over the time axis of ``frames`` (..., T, F), counting only the
    first ``n_valid`` frames of each example; masked frames take the
    dtype's lowest finite value, as in the reference."""
    t = frames.shape[-2]
    mask = torch.arange(t, device=frames.device) < n_valid[..., None]  # (..., T)
    neg = torch.finfo(frames.dtype).min
    masked = torch.where(mask[..., None], frames, torch.full((), neg, dtype=frames.dtype,
                                                             device=frames.device))
    return masked.amax(dim=-2)
