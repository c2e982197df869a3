"""The port's device meshes: named axes of virtual ranks, over one process
or a group of processes.

The port of ``mpit_tpu/parallel/mesh.py``.  The JAX package lays the ranks
of each named mesh axis (``dp`` worker rows, ``shard`` column cuts, ``sp``
sequence chunks, ``tp`` head and hidden cuts, ``pp`` stages, ``ep``
experts) over devices.  Here every axis holds **virtual ranks on one
device**: a tensor that a collective acts on carries the axis's ranks
first, ``(n, ...)``, row ``i`` being rank ``i``'s block.  That is how the
``dp`` rows of the trainers already live, as one ``(dp, plong)`` tensor,
and how the reference itself runs its ranks on one chip.  The collectives
of :mod:`mpit_tpu_torch.parallel.collective` are tensor ops over that
leading axis.

A mesh over a ``torch.distributed`` group of ``P`` processes
(``group=``, :mod:`mpit_tpu_torch.parallel.distributed`) lays its ranks as
the JAX package's ``make_mesh`` lays devices, row-major ``(dp, ...)``:
the **dp axis is cut across the processes** in contiguous blocks, process
``p`` holding ranks ``[p * dp / P, (p + 1) * dp / P)`` (its
:meth:`Mesh.local_slice`), and every other axis stays inside each
process.  A process's tensors stack its own block of ``dp``
(:meth:`Mesh.local_size` ranks); the collectives gather the others'.  A
``dp`` that ``P`` does not divide raises; a layout that would cut another
axis across processes raises ``NotImplementedError`` (ROADMAP §A item 3).

:func:`make_mesh` builds the trainers' ``(dp, shard)`` mesh.  The JAX
package factors a device count into ``dp x shard``
(``mpit_tpu/parallel/mesh.py:25-58``); here ``dp`` left unset holds one
rank a process and ``shard`` one rank.  :func:`process_local_rows`,
:func:`put_local` and :func:`put_global` are the JAX module's feeding
helpers, on tensors.  :func:`sp_mesh` builds ring attention's sequence
axis.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch


def check_split(axes: Mapping[str, int], processes: int) -> None:
    """Raise unless a mesh of ``axes`` lays over ``processes`` processes:
    ``dp`` cut into equal contiguous blocks, every other axis inside one
    process.  The launchers call it before any rendezvous."""
    if processes <= 1:
        return
    dp = int(axes.get("dp", 1))
    if dp % processes == 0:
        return
    total = 1
    for size in axes.values():
        total *= int(size)
    others = [name for name in axes if name != "dp"]
    if total % processes == 0 and others:
        raise NotImplementedError(
            f"a mesh {dict(axes)} over {processes} processes would cut "
            f"{'/'.join(others)} across processes: only dp spans processes in the "
            "port (ROADMAP §A item 3)")
    raise ValueError(
        f"dp={dp} does not split over {processes} processes: the dp axis is cut "
        "across processes in contiguous blocks, process p holding ranks "
        "[p*dp/P, (p+1)*dp/P)")


class Mesh:
    """Named axes of virtual ranks on one device, in the order given;
    ``group`` (a :class:`~mpit_tpu_torch.parallel.distributed.ProcessGroup`)
    cuts ``dp`` across its processes."""

    def __init__(self, device: torch.device | str, group: Optional[Any] = None,
                 **axes: int):
        if not axes:
            raise ValueError("a mesh needs at least one named axis")
        for name, size in axes.items():
            if int(size) < 1:
                raise ValueError(f"axis {name!r} must hold >= 1 ranks, got {size}")
        self.device = torch.device(device)
        self.shape: Dict[str, int] = {name: int(size) for name, size in axes.items()}
        self.processes = group.num_processes if group is not None else 1
        self.process_id = group.process_id if group is not None else 0
        check_split(self.shape, self.processes)

    def size(self, axis: str) -> int:
        """The number of ranks on ``axis``; an axis the mesh lacks raises."""
        if axis not in self.shape:
            raise ValueError(f"the mesh has axes {tuple(self.shape)}, not {axis!r}")
        return self.shape[axis]

    def spans(self, axis: str) -> bool:
        """Whether ``axis``'s ranks lie in more than one process."""
        self.size(axis)  # raises for an axis the mesh lacks
        return self.processes > 1 and axis == "dp"

    def local_size(self, axis: str) -> int:
        """The ranks of ``axis`` in this process."""
        n = self.size(axis)
        return n // self.processes if self.spans(axis) else n

    def local_slice(self, axis: str) -> slice:
        """This process's block of ``axis``'s ranks."""
        n = self.local_size(axis)
        lo = self.process_id * n if self.spans(axis) else 0
        return slice(lo, lo + n)

    def check_device(self, t: torch.Tensor, what: str) -> None:
        """``t`` must lie on the mesh's device (a device without an index
        stands for any index of its type)."""
        want = self.device
        if t.device.type != want.type or (want.index is not None
                                          and t.device.index != want.index):
            raise ValueError(f"{what} is on {t.device}, the mesh on {want}")

    def __repr__(self) -> str:
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        procs = f", process {self.process_id}/{self.processes}" if self.processes > 1 else ""
        return f"Mesh({axes}, device={self.device}{procs})"


def make_mesh(
    devices: Optional[Sequence[torch.device]] = None,
    *,
    dp: Optional[int] = None,
    shard: Optional[int] = None,
    device: torch.device | str = "cuda",
    group: Optional[Any] = None,
) -> Mesh:
    """Build the trainers' mesh: ``dp`` worker rows (one a process when
    unset) and ``shard`` column cuts (1 when unset), virtual ranks on
    ``device``, or on the one device of ``devices``; ``group`` cuts ``dp``
    across its processes."""
    if devices is not None:
        devices = list(devices)
        if len(devices) != 1:
            raise NotImplementedError(
                f"a mesh over {len(devices)} devices (multi-card parallelism): a "
                "process drives one device here; span more with a process group, "
                "one process a device, and make_mesh(group=) "
                "(parallel.distributed.bootstrap)")
        device = devices[0]
    processes = group.num_processes if group is not None else 1
    return Mesh(device, group, dp=dp or processes, shard=shard or 1)


def process_local_rows(mesh: Mesh, n_rows: int, axis: str = "dp") -> slice:
    """The contiguous block of a global leading axis of ``n_rows`` rows,
    cut over ``axis``'s ranks, that this process feeds: every process
    builds the same global batch (same seed, same shuffle) and keeps these
    rows.  All of them where ``axis`` lies in this process."""
    n = mesh.size(axis)
    if n_rows % n:
        raise ValueError(f"{n_rows} rows do not split over {axis}={n}")
    if not mesh.spans(axis):
        return slice(0, n_rows)
    per = n_rows // mesh.processes
    return slice(mesh.process_id * per, (mesh.process_id + 1) * per)


def put_local(arr: Any, mesh: Mesh) -> torch.Tensor:
    """Per-process data (this process's rows, as
    :func:`process_local_rows` cuts them) on the mesh's device."""
    return torch.as_tensor(arr).to(mesh.device)


def put_global(arr: Any, mesh: Mesh) -> torch.Tensor:
    """A host-global array (every process holds the same whole array, as
    an init or a resume does) on the mesh's device, replicated."""
    return torch.as_tensor(arr).to(mesh.device)


def sp_mesh(n: int, device: torch.device | str = "cuda", axis: str = "sp") -> Mesh:
    """A 1-D sequence-parallel mesh of ``n`` virtual ranks on ``device``."""
    return Mesh(device, **{axis: n})
