"""Kernels written for Hopper, each beside its plain PyTorch twin."""

from mpit_tpu_torch.ops.fused_update import (
    fused_nesterov_commit,
    fused_nesterov_commit_reference,
)

__all__ = ["fused_nesterov_commit", "fused_nesterov_commit_reference"]
