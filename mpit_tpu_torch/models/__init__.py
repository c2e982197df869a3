"""The MNIST models, BiCNN, the long-context LM and the flat-parameter view."""

from mpit_tpu_torch.models.bicnn import BiCNN, BiCNNTower, gesd, margin_ranking_loss
from mpit_tpu_torch.models.flat import FlatModel, flatten_module
from mpit_tpu_torch.models.mnist import MnistCNN, MnistLinear, MnistMLP
from mpit_tpu_torch.models.transformer import DecoderBlock, TinyDecoder, default_attn

__all__ = ["BiCNN", "BiCNNTower", "DecoderBlock", "FlatModel", "MnistCNN",
           "MnistLinear", "MnistMLP", "TinyDecoder", "default_attn", "flatten_module",
           "gesd", "margin_ranking_loss"]
