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
the JAX package's ``make_mesh`` lays devices: the ranks of the whole grid,
flattened row-major in the order the axes are given, are cut into ``P``
contiguous blocks of ``R / P``, process ``p`` holding flat ranks
``[p * R / P, (p + 1) * R / P)``, as a ``reshape`` over ``jax.devices()``
(which come in process order) gives them.  A cut is accepted where every
block is a **box**, a contiguous range of ranks on every axis
(:meth:`Mesh.local_slice`); a process's tensors stack its own range of
each axis (:meth:`Mesh.local_size` ranks), and an axis **spans**
processes where that range is not the whole axis.  For each axis that
spans, the processes that share every other range form a **line**, and
the mesh forms one ``torch.distributed`` sub-group a line
(:meth:`Mesh.line`), in every process and in one order, when it is built:
the collectives of :mod:`mpit_tpu_torch.parallel.collective` over that
axis go over it.  Every axis may span processes, as every axis of a JAX
mesh may span devices: ``dp 1 x sp 2`` over two processes gives each one
rank of ``sp``; ``tp 4`` over two gives each two ranks of ``tp``; ``dp 2 x
sp 2`` (or ``dp 2 x tp 2``) over four one rank of each axis, its ``dp``
line two processes and its ``sp`` (``tp``) line two others.  A grid of
ranks that ``P`` does not divide, or a block that is not a box (``dp 3 x
sp 2`` over two gives process 0 the ranks (0, 0), (0, 1) and (1, 0)),
raises ``ValueError``.

:func:`make_mesh` builds the trainers' ``(dp, shard)`` mesh.  The JAX
package factors a device count into ``dp x shard``
(``mpit_tpu/parallel/mesh.py:25-58``); here ``dp`` left unset holds one
rank a process and ``shard`` one rank.  :func:`process_local_rows`,
:func:`put_local` and :func:`put_global` are the JAX module's feeding
helpers, on tensors.  :func:`sp_mesh` builds ring attention's sequence
axis.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from mpit_tpu_torch.parallel.distributed import group_formed, sub_group

Box = Dict[str, Tuple[int, int]]


def _unravel(flat: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    coords = []
    for size in reversed(sizes):
        flat, c = divmod(flat, size)
        coords.append(c)
    return tuple(reversed(coords))


def process_boxes(axes: Mapping[str, int], processes: int) -> List[Box]:
    """Each process's block of the row-major grid of ``axes`` as a
    ``[lo, hi)`` range on every axis; raises ``ValueError`` where the grid
    does not split over ``processes`` or a block is not a box.  The
    launchers call it (through :func:`check_split`) before any
    rendezvous."""
    names, sizes = list(axes), [int(v) for v in axes.values()]
    total = 1
    for size in sizes:
        total *= size
    shown = " x ".join(f"{k}={v}" for k, v in zip(names, sizes) if v > 1 or k == "dp")
    if total % processes:
        raise ValueError(
            f"{shown or 'a mesh of one rank'} does not split over {processes} processes: "
            f"the mesh's {total} ranks, flattened row-major, are cut across processes "
            "in contiguous blocks, process p holding flat ranks [p*R/P, (p+1)*R/P)")
    per = total // processes
    boxes = []
    for p in range(processes):
        coords = [_unravel(r, sizes) for r in range(p * per, (p + 1) * per)]
        box = {name: (min(c[i] for c in coords), max(c[i] for c in coords) + 1)
               for i, name in enumerate(names)}
        volume = 1
        for lo, hi in box.values():
            volume *= hi - lo
        if volume != per:
            raise ValueError(
                f"{shown} over {processes} processes: process {p}'s block, flat ranks "
                f"[{p * per}, {(p + 1) * per}), holds the ranks {coords} of "
                f"({', '.join(names)}), which is not a box (a contiguous range of "
                "ranks on every axis)")
        boxes.append(box)
    return boxes


def check_split(axes: Mapping[str, int], processes: int) -> None:
    """Raise unless a mesh of ``axes`` lays over ``processes`` processes
    (:func:`process_boxes`).  The launchers call it before any
    rendezvous."""
    if processes > 1:
        process_boxes(axes, processes)


def _line_groups(boxes: List[Box], spanning: Sequence[str]) -> Dict[str, List[List[int]]]:
    """For each axis of ``spanning``, its lines: the processes that share
    every other axis's range, in process order (which, row-major, is the
    order of their ranges on the axis); the lines in order of their first
    process."""
    lines = {}
    for axis in spanning:
        by_rest: Dict[tuple, List[int]] = {}
        for p, box in enumerate(boxes):
            rest = tuple(r for name, r in box.items() if name != axis)
            by_rest.setdefault(rest, []).append(p)
        lines[axis] = sorted(by_rest.values())
    return lines


class Line:
    """The processes of one axis's line that holds this process: their ids
    in rank order, this process's index among them, and the
    ``torch.distributed`` group over them (None for the default group,
    where the line is every process)."""

    def __init__(self, processes: List[int], index: int, group: Any):
        self.processes, self.index, self.group = processes, index, group

    @property
    def size(self) -> int:
        return len(self.processes)

    @property
    def next(self) -> int:
        """The next process on the line, the ring closing."""
        return self.processes[(self.index + 1) % self.size]

    @property
    def prev(self) -> int:
        return self.processes[(self.index - 1) % self.size]


class Mesh:
    """Named axes of virtual ranks on one device, in the order given;
    ``group`` (a :class:`~mpit_tpu_torch.parallel.distributed.ProcessGroup`)
    cuts the row-major grid across its processes.  Where that group is
    formed, the mesh forms a sub-group for each line of each axis that
    spans processes (``torch.distributed.new_group``, collective: every
    process builds the same meshes in the same order)."""

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
        self.backend = getattr(group, "backend", None)
        boxes = process_boxes(self.shape, self.processes)
        self.box: Box = boxes[self.process_id]
        self._lines: Dict[str, Line] = {}
        spanning = [a for a in self.shape if self.spans(a)]
        if spanning and group_formed():
            for axis, lines in _line_groups(boxes, spanning).items():
                for ps in lines:
                    # every process creates every group, members or not
                    sub = sub_group(ps, self.processes)
                    if self.process_id in ps:
                        self._lines[axis] = Line(ps, ps.index(self.process_id), sub)

    def size(self, axis: str) -> int:
        """The number of ranks on ``axis``; an axis the mesh lacks raises."""
        if axis not in self.shape:
            raise ValueError(f"the mesh has axes {tuple(self.shape)}, not {axis!r}")
        return self.shape[axis]

    def spans(self, axis: str) -> bool:
        """Whether ``axis``'s ranks lie in more than one process."""
        return self.local_size(axis) < self.size(axis)

    def local_size(self, axis: str) -> int:
        """The ranks of ``axis`` in this process."""
        self.size(axis)  # raises for an axis the mesh lacks
        lo, hi = self.box[axis]
        return hi - lo

    def local_slice(self, axis: str) -> slice:
        """This process's range of ``axis``'s ranks."""
        self.size(axis)
        return slice(*self.box[axis])

    def line(self, axis: str) -> Line:
        """This process's line of ``axis``, which spans processes."""
        if not self.spans(axis):
            raise ValueError(f"axis {axis!r} lies in this process: it has no line")
        if axis not in self._lines:
            raise RuntimeError(
                f"axis {axis!r} spans processes, and the mesh was built before the "
                "process group formed: build it after bootstrap")
        return self._lines[axis]

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
    ``device``, or on the one device of ``devices``; ``group`` cuts the
    ``(dp, shard)`` grid across its processes."""
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
    cut over ``axis``'s ranks, that this process feeds: the rows of its
    range of ``axis``, as the JAX package feeds a batch sharded
    ``P("dp", None)``.  Every process builds the same global batch (same
    seed, same shuffle) and keeps these rows: all of them where ``axis``
    lies in this process (at ``dp 1 x sp 2`` both processes feed the whole
    batch)."""
    n = mesh.size(axis)
    if n_rows % n:
        raise ValueError(f"{n_rows} rows do not split over {axis}={n}")
    per = n_rows // n
    lo, hi = mesh.box[axis]
    return slice(lo * per, hi * per)


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
