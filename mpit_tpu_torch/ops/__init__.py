"""Kernels written for Hopper, each beside its plain PyTorch twin."""

from mpit_tpu_torch.ops.flash_attention import (
    attention_bwd_reference,
    attention_reference,
    block_attention_partial,
    finalize_partials,
    flash_attention,
    flash_attention_bwd_pair,
    flash_attention_partial,
    flash_bwd_fused,
    flash_bwd_two_kernel,
    flash_fwd,
    merge_partials,
)
from mpit_tpu_torch.ops.fused_update import (
    fused_adam,
    fused_adam_reference,
    fused_elastic,
    fused_elastic_reference,
    fused_nesterov_commit,
    fused_nesterov_commit_reference,
)

__all__ = [
    "attention_bwd_reference",
    "attention_reference",
    "block_attention_partial",
    "finalize_partials",
    "flash_attention",
    "flash_attention_bwd_pair",
    "flash_attention_partial",
    "flash_bwd_fused",
    "flash_bwd_two_kernel",
    "flash_fwd",
    "fused_adam",
    "fused_adam_reference",
    "fused_elastic",
    "fused_elastic_reference",
    "fused_nesterov_commit",
    "fused_nesterov_commit_reference",
    "merge_partials",
]
