"""A one-device stand-in for the reference's ``(dp, shard)`` device mesh.

The port of ``mpit_tpu/parallel/mesh.py`` for this slice.  The JAX package
lays ``dp`` worker rows (and ``shard`` column cuts) over a device mesh; on
one H100 all ``dp`` worker rows live on the single card as one
``(dp, plong)`` tensor, which is how the reference itself runs them on one
chip.  Cutting parameters over a ``shard`` axis, or spreading rows over
several devices, needs collectives and comes with the multi-card slice:
both are refused here rather than silently run on one device.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


class Mesh:
    """``dp`` worker rows on one device, ``shard == 1``."""

    def __init__(self, device: torch.device, dp: int):
        if dp < 1:
            raise ValueError(f"dp must be >= 1, got {dp}")
        self.device = torch.device(device)
        self.shape: Dict[str, int] = {"dp": int(dp), "shard": 1}

    def __repr__(self) -> str:
        return f"Mesh(dp={self.shape['dp']}, shard=1, device={self.device})"


def make_mesh(
    devices: Optional[Sequence[torch.device]] = None,
    *,
    dp: Optional[int] = None,
    shard: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> Mesh:
    """Build the stand-in mesh: ``dp`` rows (default 1) on ``device``, or on
    the one device of ``devices``."""
    if devices is not None:
        devices = list(devices)
        if len(devices) != 1:
            raise NotImplementedError(
                f"a mesh over {len(devices)} devices needs collectives "
                "(multi-card port slice); this stand-in holds one device"
            )
        device = devices[0]
    if shard not in (None, 1):
        raise NotImplementedError(
            f"shard={shard}: cutting parameters over a shard axis needs "
            "more than one device (multi-card port slice)"
        )
    return Mesh(torch.device(device), dp or 1)
