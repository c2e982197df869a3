"""Optimizers."""

from mpit_tpu_torch.optim.msgd import MSGD, MSGDConfig

__all__ = ["MSGD", "MSGDConfig"]
