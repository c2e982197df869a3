"""A one-device stand-in for the JAX package's device meshes.

The port of ``mpit_tpu/parallel/mesh.py`` for one card.  The JAX package
lays the ranks of each named mesh axis (``dp`` worker rows, ``shard``
column cuts, ``sp`` sequence chunks, ``tp`` head and hidden cuts, ``pp``
stages, ``ep`` experts) over devices.  Here every axis holds **virtual
ranks on one device**: a tensor that a collective acts on carries the
axis's ranks first, ``(n, ...)``, row ``i`` being rank ``i``'s block.
That is how the ``dp`` rows of the trainers already live, as one ``(dp,
plong)`` tensor, and how the reference itself runs its ranks on one chip.
The collectives of :mod:`mpit_tpu_torch.parallel.collective` are tensor
ops over that leading axis.

:func:`make_mesh` builds the trainers' ``(dp, shard)`` mesh, both axes
virtual.  The JAX package factors a device count into ``dp x shard``
(``mpit_tpu/parallel/mesh.py:25-58``); one card has no count to factor,
so an axis left unset holds one rank.  A mesh over more than one real
device stays refused: it needs collectives over a process group (NCCL or
P2P across cards), which the port does not have yet.  :func:`sp_mesh`
builds ring attention's sequence axis.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


class Mesh:
    """Named axes of virtual ranks on one device, in the order given."""

    def __init__(self, device: torch.device | str, **axes: int):
        if not axes:
            raise ValueError("a mesh needs at least one named axis")
        for name, size in axes.items():
            if int(size) < 1:
                raise ValueError(f"axis {name!r} must hold >= 1 ranks, got {size}")
        self.device = torch.device(device)
        self.shape: Dict[str, int] = {name: int(size) for name, size in axes.items()}

    def size(self, axis: str) -> int:
        """The number of ranks on ``axis``; an axis the mesh lacks raises."""
        if axis not in self.shape:
            raise ValueError(f"the mesh has axes {tuple(self.shape)}, not {axis!r}")
        return self.shape[axis]

    def check_device(self, t: torch.Tensor, what: str) -> None:
        """``t`` must lie on the mesh's device (a device without an index
        stands for any index of its type)."""
        want = self.device
        if t.device.type != want.type or (want.index is not None
                                          and t.device.index != want.index):
            raise ValueError(f"{what} is on {t.device}, the mesh on {want}")

    def __repr__(self) -> str:
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({axes}, device={self.device})"


def make_mesh(
    devices: Optional[Sequence[torch.device]] = None,
    *,
    dp: Optional[int] = None,
    shard: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> Mesh:
    """Build the trainers' mesh: ``dp`` worker rows and ``shard`` column
    cuts (each 1 when unset), virtual ranks on ``device``, or on the one
    device of ``devices``."""
    if devices is not None:
        devices = list(devices)
        if len(devices) != 1:
            raise NotImplementedError(
                f"a mesh over {len(devices)} devices needs collectives over a process "
                "group (multi-card parallelism: NCCL or P2P across cards), which the "
                "port does not have yet; this stand-in holds one device")
        device = devices[0]
    return Mesh(device, dp=dp or 1, shard=shard or 1)


def sp_mesh(n: int, device: torch.device | str = "cuda", axis: str = "sp") -> Mesh:
    """A 1-D sequence-parallel mesh of ``n`` virtual ranks on ``device``."""
    return Mesh(device, **{axis: n})
