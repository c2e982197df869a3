"""The MNIST model family as ``torch.nn`` modules, in the reference's layout.

The port of ``mpit_tpu/models/mnist.py``.  The layers keep flax's names
and parameter layouts, so a flat parameter vector means the same thing in
both packages (:mod:`mpit_tpu_torch.models.flat`):

- ``Dense_i``: ``kernel`` of shape ``(in, out)`` and ``bias``;
- ``Conv_i``: ``kernel`` in HWIO, ``(3, 3, in, out)``, and ``bias``;
  flax's ``"SAME"`` padding of a 3x3 kernel is ``padding=1``.

The convolutions run in PyTorch's NCHW.  The reference flattens its NHWC
activations before the dense head, so :class:`MnistCNN` permutes to NHWC
before it flattens; without that the 524,416 weights of ``Dense_0`` (side
32) would each meet the wrong activation.

All models take flattened ``(batch, side*side)`` float inputs and return
log-probabilities.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    """flax's ``nn.Dense``: ``x @ kernel (+ bias)``, kernel ``(in, out)``."""

    def __init__(self, d_in: int, d_out: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class Conv3x3(nn.Module):
    """3x3, stride 1, ``"SAME"`` padding; NCHW activations, HWIO kernel."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 3, c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias, padding=1)


class MnistLinear(nn.Module):
    """Linear(side*side -> 10) + log-softmax (the reference's claunch model;
    its dropout is off by default and is not carried)."""

    def __init__(self, d_in: int, num_classes: int = 10):
        super().__init__()
        self.Dense_0 = Dense(d_in, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.Dense_0(x), dim=-1)


class MnistMLP(nn.Module):
    def __init__(self, d_in: int, hidden: int = 256, num_classes: int = 10):
        super().__init__()
        self.Dense_0 = Dense(d_in, hidden)
        self.Dense_1 = Dense(hidden, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.Dense_1(F.relu(self.Dense_0(x))), dim=-1)


class MnistCNN(nn.Module):
    """conv(w) -> pool -> conv(2w) -> pool -> dense(4w) -> dense(classes)."""

    def __init__(self, side: int = 32, num_classes: int = 10, width: int = 32):
        super().__init__()
        self.side = side
        self.Conv_0 = Conv3x3(1, width)
        self.Conv_1 = Conv3x3(width, 2 * width)
        flat = (side // 4) * (side // 4) * 2 * width
        self.Dense_0 = Dense(flat, 4 * width)
        self.Dense_1 = Dense(4 * width, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch = x.shape[0]
        img = x.reshape(batch, 1, self.side, self.side)
        img = F.max_pool2d(F.relu(self.Conv_0(img)), 2, 2)
        img = F.max_pool2d(F.relu(self.Conv_1(img)), 2, 2)
        img = img.permute(0, 2, 3, 1).reshape(batch, -1)  # NHWC flatten
        img = F.relu(self.Dense_0(img))
        return F.log_softmax(self.Dense_1(img), dim=-1)


def make_model(name: str, side: int, num_classes: int = 10) -> nn.Module:
    """``linear | mlp | cnn`` at input side ``side``."""
    if name == "cnn":
        return MnistCNN(side=side, num_classes=num_classes)
    if name == "linear":
        return MnistLinear(side * side, num_classes)
    if name == "mlp":
        return MnistMLP(side * side, num_classes=num_classes)
    raise ValueError(f"model must be linear|mlp|cnn, got {name!r}")
