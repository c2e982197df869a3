"""Datasets (numpy)."""

from mpit_tpu_torch.data.mnist import load_mnist

__all__ = ["load_mnist"]
