"""MNIST models and the flat-parameter view."""

from mpit_tpu_torch.models.flat import FlatModel, flatten_module
from mpit_tpu_torch.models.mnist import MnistCNN, MnistLinear, MnistMLP

__all__ = ["FlatModel", "MnistCNN", "MnistLinear", "MnistMLP", "flatten_module"]
