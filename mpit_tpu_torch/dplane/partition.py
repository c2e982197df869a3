"""Regex -> PartitionSpec rule engine over parameter trees.

The port of ``mpit_tpu/dplane/partition.py``.  A rule table is an ordered
sequence of ``(pattern, PartitionSpec)`` pairs; each leaf's ``/``-joined
tree path is matched with ``re.search`` and the **first** matching rule
wins, so every leaf resolves to exactly one spec.  Two invariants, held by
tests/test_torch_dplane.py against the JAX package:

- scalar leaves (0-d, or single-element) are never partitioned — they
  resolve to ``PartitionSpec()`` without consuming a rule;
- a non-scalar leaf no rule matches is a loud ``ValueError`` naming the
  leaf (or, opt-in, replicates).

Trees are nested dicts, lists, tuples and named tuples of tensors or
arrays.  Leaves are visited in the order of JAX's ``tree_flatten_with_path``
(dict keys **sorted**, sequences by index, named tuples by field), and
path names are rendered the same way, so a segment table here means the
same offsets as ``ravel_pytree`` there: the flat layout the PS vector uses
is one and the same in both packages.

On top of the per-leaf specs sits the **flat-vector layer**:
:func:`flat_segments` renders the tree as an ordered segment table,
:func:`aligned_cut` cuts the vector at segment boundaries as close to
balanced as the boundaries allow, and :func:`plan_shard_map` lifts that
cut into a versioned :class:`~mpit_tpu_torch.shardctl.shardmap.ShardMap`.

``PartitionSpec`` is the port's own small type, and :class:`Placement` its
``NamedSharding``: a mesh, a spec and one device a rank of the mesh.
:func:`tree_shardings` lifts specs into placements, and :func:`shard_tree`
lays each leaf out as its ranks' blocks (:class:`Sharded`, the port's
sharded ``jax.Array``): rank ``i``'s block is a tensor of its own on rank
``i``'s device, holding the part of the leaf the spec gives that rank, as
``addressable_shards`` give a device's part in the JAX package.  The ranks
of the port's :class:`~mpit_tpu_torch.parallel.mesh.Mesh` are virtual ranks
of its one device (the device plane names one card a rank instead:
``PlaneConfig.devices``).  A mesh cut across a process group is refused:
the plane's ranks are one process's.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

PROCESS_GROUP = ("a mesh cut across a process group: the plane's ranks are the "
                 "devices of one process, as the JAX plane's are one server "
                 "process's local devices")


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (a name, a tuple of names, or None),
    as ``jax.sharding.PartitionSpec`` spells them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one leaf lives — the port's ``NamedSharding``: the mesh, the
    spec, and one device a rank of the mesh (ranks row-major over the
    mesh's axes, the order of a JAX mesh's ``devices.flat``).  Without a
    mesh it is one rank holding the whole leaf.  A tree walk treats it as
    a leaf."""

    mesh: Any
    spec: PartitionSpec
    devices: Tuple[torch.device, ...]

    @property
    def device(self) -> torch.device:
        """Rank 0's device."""
        return self.devices[0]

    def rank_index(self, shape: Tuple[int, ...]) -> List[Tuple[slice, ...]]:
        """Each rank's block of a leaf of ``shape``, one slice a dim: the
        block that the rank's coordinates on the dim's axes pick (row-major
        in the spec's order of them) where the spec names axes for the dim,
        else the whole dim.  Ranks whose coordinates differ only on axes the
        spec does not name hold the same block (replication)."""
        if self.mesh is None:
            return [tuple(slice(0, extent) for extent in shape)]
        names, sizes = list(self.mesh.shape), [int(v) for v in self.mesh.shape.values()]
        axes = _spec_axes(self.spec)
        out = []
        for rank in range(math.prod(sizes)):
            coord = dict(zip(names, _unravel(rank, sizes)))
            idx = []
            for dim, extent in enumerate(shape):
                dim_axes = axes[dim] if dim < len(axes) else ()
                count, pick = 1, 0
                for ax in dim_axes:
                    count *= self.mesh.shape[ax]
                    pick = pick * self.mesh.shape[ax] + coord[ax]
                step = extent // count
                idx.append(slice(pick * step, (pick + 1) * step))
            out.append(tuple(idx))
        return out


def _unravel(flat: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    coords = []
    for size in reversed(sizes):
        flat, c = divmod(flat, size)
        coords.append(c)
    return tuple(reversed(coords))


class Sharded:
    """A value laid out over a mesh's ranks — the port's sharded
    ``jax.Array``: ``blocks[i]`` is rank ``i``'s block, a tensor of its own
    on ``placement.devices[i]`` holding the part ``placement.rank_index``
    gives the rank.  A tree walk treats it as a leaf."""

    __slots__ = ("placement", "shape", "blocks")

    def __init__(self, placement: Placement, shape: Tuple[int, ...],
                 blocks: List[torch.Tensor]):
        self.placement, self.shape, self.blocks = placement, tuple(shape), list(blocks)

    def gather(self, device: Any = None) -> torch.Tensor:
        """The whole value as one fresh tensor on ``device`` (rank 0's
        device by default; the host for a snapshot): each distinct block
        copied into its place, so a replicated value costs one block's
        copy."""
        dev = torch.device(device) if device is not None else self.placement.device
        out = torch.empty(self.shape, dtype=self.blocks[0].dtype, device=dev)
        done = set()
        for idx, block in zip(self.placement.rank_index(self.shape), self.blocks):
            key = tuple((s.start, s.stop) for s in idx)
            if key not in done:
                done.add(key)
                out[idx].copy_(block)
        return out

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Sharded":
        """The same layout with ``fn`` of every block (``torch.clone``:
        fresh storage of the same values)."""
        return Sharded(self.placement, self.shape, [fn(b) for b in self.blocks])

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, spec={self.placement.spec!r}, "
                f"ranks={len(self.blocks)})")


def shard_leaf(leaf: Any, placement: Placement) -> Sharded:
    """Lay ``leaf`` (a tensor or an array) out over ``placement``'s ranks:
    each rank's block copied into storage of its own on its device."""
    src = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
    blocks = []
    for idx, dev in zip(placement.rank_index(tuple(src.shape)), placement.devices):
        part = src[idx]
        blocks.append(torch.empty(part.shape, dtype=part.dtype, device=dev).copy_(part))
    return Sharded(placement, tuple(src.shape), blocks)


# ---------------------------------------------------------------------------
# tree walking in JAX's flatten order


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """``(key, child)`` pairs of an inner node in JAX's order, or None for
    a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    if node is None:
        return []
    return None


def _rebuild(node: Any, values: List[Any]) -> Any:
    if isinstance(node, dict):
        return {k: values[i] for i, k in enumerate(sorted(node))}
    if _is_namedtuple(node):
        return type(node)(*values)
    if isinstance(node, tuple):
        return tuple(values)
    if isinstance(node, list):
        return list(values)
    return None


def _flatten(tree: Any, sep: str) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []

    def walk(prefix: List[str], node: Any) -> None:
        kids = _children(node)
        if kids is None:
            out.append((sep.join(prefix), node))
            return
        for key, child in kids:
            walk(prefix + [key], child)

    walk([], tree)
    return out


def tree_path_names(tree: Any, sep: str = "/") -> List[str]:
    """The ``sep``-joined path name of every leaf, in flatten order (= the
    ``ravel_pytree`` order the flat PS vector uses)."""
    return [name for name, _ in _flatten(tree, sep)]


def named_tree_map(fn: Callable[[str, Any], Any], tree: Any, sep: str = "/") -> Any:
    """A tree map whose function also receives the leaf's path name."""

    def walk(prefix: List[str], node: Any) -> Any:
        kids = _children(node)
        if kids is None:
            return fn(sep.join(prefix), node)
        return _rebuild(node, [walk(prefix + [k], c) for k, c in kids])

    return walk([], tree)


def _shape(leaf: Any) -> Tuple[int, ...]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return tuple(np.shape(leaf))


def _is_scalar(leaf: Any) -> bool:
    shape = _shape(leaf)
    return len(shape) == 0 or math.prod(shape) == 1


def match_partition_rules(rules: Sequence[Tuple[str, PartitionSpec]], tree: Any, *,
                          sep: str = "/", on_unmatched: str = "raise") -> Any:
    """A tree of ``PartitionSpec``, one per leaf of ``tree``: the first
    pattern ``re.search``-matching the leaf's path name wins; scalars
    always resolve to ``P()``.  ``on_unmatched``: ``"raise"`` (default) or
    ``"replicate"``."""
    if on_unmatched not in ("raise", "replicate"):
        raise ValueError(
            f"on_unmatched must be 'raise' or 'replicate', got {on_unmatched!r}")

    def pick(name: str, leaf: Any) -> PartitionSpec:
        if _is_scalar(leaf):
            return PartitionSpec()
        for pattern, spec in rules:
            if re.search(pattern, name) is not None:
                return spec
        if on_unmatched == "replicate":
            return PartitionSpec()
        raise ValueError(
            f"no partition rule matches leaf {name!r} (shape {_shape(leaf)}); "
            "add a rule or a catch-all ('.*', P()) tail")

    return named_tree_map(pick, tree, sep=sep)


def match_report(rules: Sequence[Tuple[str, PartitionSpec]], tree: Any, *,
                 sep: str = "/") -> Dict[str, int]:
    """Which rule index claimed each leaf: ``{leaf name: rule index}``, with
    ``-1`` for scalar leaves (never partitioned) and ``-2`` for unmatched
    ones."""
    report: Dict[str, int] = {}
    for name, leaf in _flatten(tree, sep):
        idx = -1 if _is_scalar(leaf) else -2
        if idx == -2:
            for i, (pattern, _spec) in enumerate(rules):
                if re.search(pattern, name) is not None:
                    idx = i
                    break
        report[name] = idx
    return report


def _spec_axes(spec: PartitionSpec) -> List[Tuple[str, ...]]:
    out = []
    for entry in spec:
        if entry is None:
            out.append(())
        elif isinstance(entry, (tuple, list)):
            out.append(tuple(entry))
        else:
            out.append((entry,))
    return out


def validate_spec(mesh: Any, spec: PartitionSpec, shape: Tuple[int, ...],
                  name: str = "<leaf>") -> None:
    """Loudly reject a spec ``mesh`` (anything with a ``shape`` dict of axis
    sizes) cannot realize for ``shape``: an unknown axis name, more
    partitioned dims than the leaf has, or a dim not divisible by its
    axis-size product."""
    axes = _spec_axes(spec)
    if len(axes) > len(shape):
        raise ValueError(
            f"spec {spec} for {name!r} names {len(axes)} dims but the leaf has "
            f"shape {shape}")
    seen: set = set()
    for dim, dim_axes in enumerate(axes):
        factor = 1
        for ax in dim_axes:
            if ax not in mesh.shape:
                raise ValueError(
                    f"spec {spec} for {name!r} uses axis {ax!r} not in mesh axes "
                    f"{tuple(mesh.shape)}")
            if ax in seen:
                raise ValueError(f"spec {spec} for {name!r} repeats mesh axis {ax!r}")
            seen.add(ax)
            factor *= mesh.shape[ax]
        if factor > 1 and shape[dim] % factor:
            raise ValueError(
                f"dim {dim} of {name!r} (shape {shape}) is not divisible by mesh "
                f"factor {factor} for spec {spec}")


def _naive(mesh: Any, spec: PartitionSpec, shape: Tuple[int, ...],
           name: str) -> PartitionSpec:
    """Degrade each indivisible dim of ``spec`` to unpartitioned (axis-name
    errors still raise)."""
    entries = []
    for dim, dim_axes in enumerate(_spec_axes(spec)):
        factor = 1
        for ax in dim_axes:
            if ax not in mesh.shape:
                raise ValueError(
                    f"spec {spec} for {name!r} uses axis {ax!r} not in mesh axes "
                    f"{tuple(mesh.shape)}")
            factor *= mesh.shape[ax]
        ok = factor == 1 or (dim < len(shape) and shape[dim] % factor == 0)
        entries.append(spec[dim] if ok else None)
    return PartitionSpec(*entries)


def mesh_devices(mesh: Any, devices: Optional[Sequence[Any]] = None
                 ) -> Tuple[torch.device, ...]:
    """One device a rank of ``mesh``: ``devices`` where given (one a rank,
    row-major), else the mesh's own device for every rank (the port's
    meshes hold virtual ranks of one device)."""
    if getattr(mesh, "processes", 1) > 1:
        raise NotImplementedError(f"a plane over {mesh!r}: {PROCESS_GROUP}")
    ranks = math.prod(int(v) for v in mesh.shape.values())
    if devices is None:
        if not hasattr(mesh, "device"):
            raise ValueError(f"{mesh!r} has no device: name one device a rank (devices=)")
        return (torch.device(mesh.device),) * ranks
    out = tuple(torch.device(d) for d in devices)
    if len(out) != ranks:
        raise ValueError(f"{len(out)} devices for a mesh of {ranks} ranks ({mesh!r})")
    return out


def tree_shardings(mesh: Any, specs: Any, tree: Optional[Any] = None, *,
                   sep: str = "/", naive_fallback: bool = False) -> Any:
    """Lift a spec tree into :class:`Placement`s on ``mesh``, one device a
    rank (:func:`mesh_devices`).  With ``tree`` given, every spec is
    validated against its leaf's shape; ``naive_fallback=True`` degrades an
    indivisible dim to unpartitioned instead of raising (axis-name errors
    always raise).  The validation runs before the placement, so a bad
    spec is named on any mesh."""
    if tree is None:
        rank_devices = mesh_devices(mesh)
        return named_tree_map(lambda _n, box: Placement(mesh, box.value, rank_devices),
                              _specs_as_leaves(specs), sep=sep)
    spec_list = [box.value for _, box in _flatten(_specs_as_leaves(specs), sep)]
    leaves = _flatten(tree, sep)
    if len(spec_list) != len(leaves):
        raise ValueError(
            f"{len(spec_list)} specs for a tree of {len(leaves)} leaves")
    checked = []
    for spec, (name, leaf) in zip(spec_list, leaves):
        shape = _shape(leaf)
        if naive_fallback:
            spec = _naive(mesh, spec, shape, name)
        validate_spec(mesh, spec, shape, name)
        checked.append(spec)
    rank_devices = mesh_devices(mesh)
    it = iter(checked)
    return named_tree_map(lambda _n, _leaf: Placement(mesh, next(it), rank_devices),
                          tree, sep=sep)


def _specs_as_leaves(specs: Any) -> Any:
    """A spec tree with each spec wrapped so the walker sees it as a leaf
    (a PartitionSpec is a tuple, which the walker would descend into)."""
    if isinstance(specs, PartitionSpec):
        return _Leaf(specs)
    if isinstance(specs, dict):
        return {k: _specs_as_leaves(v) for k, v in specs.items()}
    if _is_namedtuple(specs):
        return type(specs)(*[_specs_as_leaves(v) for v in specs])
    if isinstance(specs, (list, tuple)):
        return type(specs)(_specs_as_leaves(v) for v in specs)
    return specs


class _Leaf:
    """An opaque box the walker treats as a leaf."""

    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Lay every leaf out over its :class:`Placement`'s ranks (host ->
    card): a :class:`Sharded` of owned blocks, rank ``i``'s on its
    device."""
    places = iter([p for _, p in _flatten(shardings, "/")])
    return named_tree_map(lambda _name, leaf: shard_leaf(leaf, next(places)), tree)


# ---------------------------------------------------------------------------
# flat-vector layer: segment tables + boundary-aligned cuts


class Segment(NamedTuple):
    """One leaf's extent inside the raveled flat vector."""

    name: str
    offset: int
    size: int

    @property
    def end(self) -> int:
        return self.offset + self.size


def flat_segments(tree: Any, sep: str = "/") -> List[Segment]:
    """The ordered segment table of the raveled tree: one entry per leaf,
    contiguous, in flatten order (the order ``ravel_pytree`` uses)."""
    segments: List[Segment] = []
    offset = 0
    for name, leaf in _flatten(tree, sep):
        shape = _shape(leaf)
        size = math.prod(shape) if shape else 1
        segments.append(Segment(name, offset, size))
        offset += size
    return segments


def aligned_cut(plong: int, segments: Sequence[Segment], n: int,
                weights: Optional[Sequence[float]] = None) -> list:
    """Cut ``[0, plong)`` into ``n`` contiguous shards whose interior
    boundaries fall on segment boundaries, each as close to the equal cut
    ``i*plong/n`` (or, with ``weights``, the cumulative-fraction target) as
    the boundaries allow.  Shards tile ``[0, plong)``, every shard is
    nonempty, every interior cut is some segment's offset, and the result
    is a pure function of its arguments.  Raises when fewer segments than
    shards exist — an aligned cut never splits a parameter."""
    from mpit_tpu_torch.ps.sharding import Shard

    if n < 1:
        raise ValueError("need at least one shard")
    if weights is not None:
        w = [float(x) for x in weights]
        if len(w) != n:
            raise ValueError(f"weights has {len(w)} entries for {n} shards")
        if any(x <= 0 for x in w):
            raise ValueError("weights must be positive")
        total = sum(w)
        targets, acc = [], 0.0
        for x in w[:-1]:
            acc += x
            targets.append(acc / total * plong)
    else:
        targets = [i * plong / n for i in range(1, n)]
    segs = sorted(segments, key=lambda s: s.offset)
    pos = 0
    for s in segs:
        if s.offset != pos or s.size <= 0:
            raise ValueError(
                f"segments must tile [0, plong) contiguously; {s.name!r} covers "
                f"[{s.offset}, {s.end}) but {pos} elements are assigned so far")
        pos = s.end
    if pos != plong:
        raise ValueError(f"segments cover {pos} of {plong} elements")
    if len(segs) < n:
        raise ValueError(
            f"cannot align {n} shards on {len(segs)} segments — an aligned cut "
            "never splits a parameter (use shard_layout for element-level cuts)")
    boundaries = [s.offset for s in segs[1:]]  # interior candidates
    cuts: List[int] = []
    lo = 0
    for i in range(1, n):
        target = targets[i - 1]
        # Leave enough boundaries for the remaining n-1-i cuts.
        window = boundaries[lo:len(boundaries) - (n - 1 - i)]
        best = min(range(len(window)),
                   key=lambda j: (abs(window[j] - target), window[j]))
        cuts.append(window[best])
        lo += best + 1
    edges = [0] + cuts + [plong]
    return [Shard(edges[i], edges[i + 1] - edges[i]) for i in range(n)]


def plan_shard_map(tree: Any, server_ranks: Sequence[int], *, sep: str = "/",
                   shards_per_server: int = 1,
                   weights: Optional[Sequence[float]] = None):
    """A version-0 :class:`~mpit_tpu_torch.shardctl.shardmap.ShardMap`
    whose cut is segment-aligned — the partition engine as shard control's
    layout source.  ``shards_per_server`` over-partitions while keeping
    every cut on a parameter boundary; ``weights`` (one per server) skews
    the cut targets, a server's weight spread evenly over its shards.
    Pass the result to ``ParamClient(shard_map=...)``."""
    from mpit_tpu_torch.shardctl.shardmap import ShardMap

    ranks = list(server_ranks)
    if not ranks:
        raise ValueError("need at least one server rank")
    k = max(int(shards_per_server), 1)
    segments = flat_segments(tree, sep=sep)
    cut_weights = None
    if weights is not None:
        if len(weights) != len(ranks):
            raise ValueError(
                f"weights has {len(list(weights))} entries for {len(ranks)} servers")
        cut_weights = [float(w) / k for w in weights for _ in range(k)]
    shards = aligned_cut(segments[-1].end, segments, len(ranks) * k,
                         weights=cut_weights)
    owners = [r for r in ranks for _ in range(k)]
    return ShardMap.from_shards(shards, owners)
