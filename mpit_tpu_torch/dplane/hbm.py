"""Device-resident shard slots — params and optimizer state stay on the card.

The port of ``mpit_tpu/dplane/hbm.py``.  An :class:`HbmSlot` is the device
side of one PS shard: the parameter slice and its rule (optimizer) state
live as tensors on the card, and every update runs ``rule.apply`` there —
Adam's sweep is kernel K3 — without a host hop.

A plane over a mesh whose ``shard`` axis holds n ranks lays the shard out
as the JAX plane lays a sharded ``jax.Array`` (:func:`flat_sharding`): the
flat vector cut into n equal blocks when n divides its length, rank ``i``
holding ``[i*size/n, (i+1)*size/n)``, else every rank holding the whole of
it; param-shaped state leaves follow the param, every other leaf (Adam's
``t``) is one copy a rank.  Each rank's block is a tensor of its own on its
rank's device (``PlaneConfig.devices``, else the slot's device: the ranks
of the port's meshes are virtual ranks of one device), and every apply runs
``rule.apply`` once a rank on that rank's block — K3 once a rank under Adam,
as XLA runs the JAX apply once a device.  A gradient is decoded once, then
cut into the ranks' windows, so every rank's arithmetic is the one-rank
slot's on its elements.

Donation, the JAX package's way of letting an update write into its
inputs' buffers, becomes an in-place update here:

- ``donate=True`` (the default): the rule writes the slot's own blocks;
  a block's ``data_ptr()`` is the same before and after an apply, and a
  holder of the old block sees the new values (K3 updates in place).
- ``donate=False``: the apply runs on fresh copies of the blocks and
  their state, so a holder of the old tensors keeps the old values.

Reads are cached per committed version, on both sides of the host
boundary:

- :meth:`HbmSlot.snapshot_host` — ONE gathered device->host copy per
  version (the wire path's snapshot, shared by every wire read and by
  checkpoints);
- :meth:`HbmSlot.pull_device` — ONE gather into a fresh device buffer per
  version, never a view of a block: an in-place apply must never change a
  tensor a puller still holds.  Every puller of one version shares it, so
  callers only read it (or ``copy_`` out of it).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from mpit_tpu_torch.dplane.partition import (PartitionSpec, Placement, Sharded,
                                             mesh_devices, shard_leaf)
from mpit_tpu_torch.obs.metrics import registry_or_local
from mpit_tpu_torch.optim.rules import ShardRule
from mpit_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class PlaneConfig:
    """How a server places and serves its device-resident shards.

    ``mesh=None`` places on one device.  A mesh whose ``axis`` holds n
    ranks, every other axis of size 1 (the JAX package's ``make_mesh(
    devices, dp=1)``), lays each flat vector over the n ranks
    (:func:`flat_sharding`).  ``devices`` names one device a rank of the
    mesh, in rank order; without it every rank lies on ``device``, which
    names the card (None: the server's own device, ``cuda`` unless the
    caller asks for the CPU).  ``publish=False`` keeps the slots
    device-resident without offering the in-process exchange
    (``namespace`` isolates concurrent gangs in one process)."""

    mesh: Optional[Any] = None
    axis: str = "shard"
    donate: bool = True
    publish: bool = True
    namespace: str = ""
    device: Optional[str] = None
    devices: Optional[Tuple[str, ...]] = None

    @classmethod
    def auto(cls, **kw) -> "PlaneConfig":
        """A ``shard`` axis over every card the process sees when it sees
        more than one, rank ``i`` on ``cuda:i`` (the JAX package spans every
        default device); else single-device placement.  A plane the caller
        puts on the CPU is single-device."""
        cards = torch.cuda.device_count()
        if cards > 1 and kw.get("device") in (None, "cuda") and kw.get("mesh") is None:
            from mpit_tpu_torch.parallel.mesh import make_mesh

            kw = dict(kw, mesh=make_mesh(dp=1, shard=cards, device="cuda:0"),
                      devices=tuple(f"cuda:{i}" for i in range(cards)))
        return cls(**kw)


def plane_ranks(cfg: Optional[PlaneConfig]) -> int:
    """The ranks of ``cfg``'s shard axis (1 without a mesh).  A mesh with
    another axis of more than one rank, or without the axis, raises."""
    if cfg is None or cfg.mesh is None:
        return 1
    shape = dict(cfg.mesh.shape)
    if cfg.axis not in shape:
        raise ValueError(f"PlaneConfig(axis={cfg.axis!r}): the mesh has axes {tuple(shape)}")
    others = {k: v for k, v in shape.items() if k != cfg.axis and int(v) != 1}
    if others:
        raise NotImplementedError(
            f"PlaneConfig(mesh={cfg.mesh!r}): the plane lays shards over the "
            f"{cfg.axis!r} axis alone, every other axis of size 1 (the JAX "
            f"package's make_mesh(devices, dp=1)); {others} has more")
    return int(shape[cfg.axis])


def flat_sharding(cfg: Optional[PlaneConfig], size: int,
                  device: Any = None) -> Optional[Placement]:
    """The placement a flat ``(size,)`` vector gets under ``cfg``: None
    without a mesh; ``P(axis)`` when the axis's n ranks divide ``size``,
    else ``P()``, every rank the whole vector (the naive fallback, never an
    error).  ``device`` is the ranks' device where ``cfg`` names none."""
    if cfg is None or cfg.mesh is None:
        return None
    n = plane_ranks(cfg)
    spec = PartitionSpec(cfg.axis) if size % n == 0 else PartitionSpec()
    return Placement(cfg.mesh, spec, rank_devices(cfg, device))


def rank_devices(cfg: Optional[PlaneConfig], device: Any = None
                 ) -> Tuple[torch.device, ...]:
    """One device a rank of the plane: ``cfg.devices`` where given, else
    every rank on the config's device, else on ``device``, else on the
    card."""
    if cfg is not None and cfg.devices is not None:
        if cfg.mesh is None:
            raise ValueError("PlaneConfig(devices=...) names one device a rank of a "
                             "mesh: give mesh=")
        plane_ranks(cfg)
        return mesh_devices(cfg.mesh, cfg.devices)
    return (_plane_device(cfg, device),) * plane_ranks(cfg)


def _as_tensor(x: Any) -> torch.Tensor:
    """A tensor view of ``x`` (a numpy array is aliased, not copied)."""
    if isinstance(x, torch.Tensor):
        return x
    return _from_host(x)


def _from_host(x: Any) -> torch.Tensor:
    """A CPU tensor aliasing host array ``x`` (a read-only one is copied:
    ``torch.from_numpy`` wants a writeable buffer)."""
    arr = np.asarray(x)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def _shape(x: Any) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _plane_device(cfg: Optional[PlaneConfig], device: Any) -> torch.device:
    """The plane's own device: the config's, else ``device`` (the server's),
    else the card."""
    name = cfg.device if cfg is not None else None
    if name is None and device is not None:
        return torch.device(device)
    return resolve_device(name)


def _lay(value: Any, cfg: Optional[PlaneConfig], device: Any = None) -> Sharded:
    """The plane's one layout rule, as the JAX plane's: a flat vector by
    :func:`flat_sharding` (a param-shaped leaf follows the param), every
    other leaf (Adam's ``t``) one copy a rank; without a mesh, one rank on
    the plane's device holding the whole.  Every block is owned storage of
    its own, so a restored or migrated leaf never aliases its source and
    no two leaves share storage."""
    shape = _shape(value)
    placement = flat_sharding(cfg, shape[0], device) if len(shape) == 1 else None
    if placement is None:
        placement = Placement(cfg.mesh if cfg is not None else None, PartitionSpec(),
                              rank_devices(cfg, device))
    return shard_leaf(value, placement)


def _placed(value: Sharded, cfg: Optional[PlaneConfig]) -> Any:
    """What the public placers hand out: over a mesh the :class:`Sharded`
    itself, without one its single block."""
    return value if cfg is not None and cfg.mesh is not None else value.blocks[0]


def place_flat(arr: Any, cfg: Optional[PlaneConfig], device: Any = None) -> Any:
    """A flat vector placed per ``cfg``, in owned storage: without a mesh, a
    tensor on the plane's device (the card unless the config names the
    CPU); over a mesh, a :class:`Sharded` laid out by
    :func:`flat_sharding`."""
    return _placed(_lay(arr, cfg, device), cfg)


def device_copy(x: Any) -> torch.Tensor:
    """A bit-exact fresh buffer for ``x`` that owns its storage, on ``x``'s
    device (a numpy array lands on the CPU).  ``torch.from_numpy`` aliases
    host memory, so everything that enters an in-place apply chain from a
    host buffer passes through here first."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    return torch.from_numpy(np.array(x))


def dedupe_state(state: Optional[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Break storage sharing inside a rule-state dict: an in-place apply
    that wrote two leaves over one storage would update it twice.  Leaves
    that share storage with an earlier leaf (the same tensor, or two views
    of one buffer) get a fresh copy; distinct leaves pass through."""
    seen: set = set()
    out = {}
    for k, v in (state or {}).items():
        key = v.untyped_storage().data_ptr()
        if key in seen and v.numel():
            v = v.clone()
            key = v.untyped_storage().data_ptr()
        seen.add(key)
        out[k] = v
    return out


def place_state(state: Optional[Dict[str, Any]], cfg: Optional[PlaneConfig],
                device: Any = None) -> Dict[str, Any]:
    """Place a rule-state dict next to its param, as the JAX plane does:
    every leaf in owned storage of its own (restored or migrated state
    feeds in-place applies, which must never write host arrays), a flat
    leaf laid out as :func:`place_flat` lays it and every other leaf one
    copy a rank."""
    return {k: _placed(_lay(v, cfg, device), cfg) for k, v in (state or {}).items()}


def _on_card(device: torch.device):
    """Make ``device`` the current card for the kernels' launches (they
    run on the current card's stream); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class HbmSlot:
    """One device-resident shard: the param and every state leaf laid out
    by the plane's rule (:func:`_lay`) as :class:`Sharded` values, one
    block a rank, and versioned caches."""

    def __init__(self, size: int, rule: ShardRule, dtype: Any = np.float32, *,
                 config: Optional[PlaneConfig] = None, rank: int = -1,
                 device: Any = None):
        if np.dtype(dtype) != np.float32:
            raise NotImplementedError(
                f"HbmSlot(dtype={np.dtype(dtype).name}): the port's shards are "
                "float32")
        self.size = int(size)
        self.rule = rule
        self.dtype = np.dtype(np.float32)
        self.config = config or PlaneConfig()
        self.rank = rank
        #: the slot's own device, where gradients land and pulls are
        #: gathered: the config's, else the caller's (the server passes its
        #: own), else ``cuda``
        self.device = _plane_device(self.config, device)
        zeros = torch.zeros(self.size, dtype=torch.float32, device=self.device)
        #: the param and the rule state, laid out over the plane's ranks
        self.sharded_param: Sharded = _lay(zeros, self.config, self.device)
        self.sharded_state: Dict[str, Sharded] = self._lay_state(rule.init(zeros))
        #: each rank's ``[lo, hi)`` window of the flat vector
        self.windows = [(idx[0].start, idx[0].stop)
                        for idx in self.sharded_param.placement.rank_index((self.size,))]
        #: committed version: bumps on every apply/seed (the snapshot cache
        #: key, the server's _snap_version)
        self.version = 0
        self._snap_host: Optional[tuple] = None
        self._pull_cache: Optional[tuple] = None
        _m = registry_or_local()
        self._m_applies = _m.counter("mpit_dplane_device_applies_total", rank=rank)
        self._m_copies = _m.counter("mpit_dplane_snapshot_copies_total", rank=rank)
        self._m_gathers = _m.counter("mpit_dplane_pull_gathers_total", rank=rank)
        self._m_bytes = _m.gauge("mpit_dplane_hbm_bytes", rank=rank)
        self._m_bytes.set(self.size * self.dtype.itemsize)

    def _lay_state(self, state: Dict[str, Any]) -> Dict[str, Sharded]:
        return {k: _lay(v, self.config, self.device) for k, v in state.items()}

    @property
    def ranks(self) -> int:
        return len(self.windows)

    @property
    def blocks(self) -> List[torch.Tensor]:
        """Rank ``i``'s block of the param, on its rank's device."""
        return self.sharded_param.blocks

    @property
    def states(self) -> List[Dict[str, torch.Tensor]]:
        """Rank ``i``'s rule state: its block of every param-shaped leaf,
        its own copy of every other leaf."""
        return [{k: v.blocks[i] for k, v in self.sharded_state.items()}
                for i in range(self.ranks)]

    def _one_tensor(self, what: str) -> None:
        if self.ranks != 1:
            raise RuntimeError(
                f"HbmSlot.{what}: this slot holds one block a rank over "
                f"{self.ranks} ranks, not one tensor; read the whole with "
                "pull_device() or snapshot_host(), write it with seed() and the "
                "applies")

    @property
    def param(self) -> torch.Tensor:
        """The param as one tensor: a one-rank slot's block itself, which
        every apply writes in place.  A slot over more ranks holds no such
        tensor, and reading it raises."""
        self._one_tensor("param")
        return self.blocks[0]

    @property
    def rule_state(self) -> Dict[str, torch.Tensor]:
        """A one-rank slot's rule state (raises over more ranks, as
        :attr:`param`)."""
        self._one_tensor("rule_state")
        return self.states[0]

    # -- write path: the rule on the card, in place, once a rank -------------

    def _on_device(self, x: Any, device: Optional[torch.device] = None) -> torch.Tensor:
        return _as_tensor(x).to(device if device is not None else self.device)

    def _write(self, lo: int, n: int, grad: torch.Tensor) -> None:
        """``rule.apply`` on each rank's part of ``[lo, lo+n)`` — its block
        (or the window of it the range covers) and the matching state
        windows — with that part of ``grad`` on the rank's device: in the
        slot's own storage when donating, else in fresh copies that replace
        it.  A rank the range misses runs nothing."""
        if not self.config.donate:
            self.sharded_param = self.sharded_param.map(torch.clone)
            self.sharded_state = {k: v.map(torch.clone) for k, v in self.sharded_state.items()}
        for block, state, (wlo, whi) in zip(self.blocks, self.states, self.windows):
            a, b = max(lo, wlo), min(lo + n, whi)
            if a >= b:
                continue
            g = grad[a - lo:b - lo].to(block.device)
            if (a, b) != (wlo, whi):
                block = block[a - wlo:b - wlo]
                state = {k: v[a - wlo:b - wlo] for k, v in state.items()}
            with _on_card(block.device):
                self.rule.apply(block, g, state)  # the port's rules update in place

    def apply_grad(self, grad: Any) -> None:
        """Apply one device-native gradient (identity wire format)."""
        self._write(0, self.size, self._on_device(grad))
        self._m_applies.inc()
        self._invalidate()

    def apply_wire(self, codec, grad_in: Any) -> None:
        """Apply one wire-format gradient: ``grad_in`` is the decoded frame
        (identity codecs) or the codec's split wire parts, as the server's
        host path builds them; the parts are decoded on the card with
        ``codec.decode_parts``, then the rule runs on each rank's window."""
        if codec is None or codec.identity:
            self.apply_grad(grad_in)
            return
        parts = [self._on_device(v) for v in grad_in]
        self._write(0, self.size, codec.decode_parts(parts, self.size))
        self._m_applies.inc()
        self._invalidate()

    def apply_wire_chunk(self, codec, grad_in: Any, lo: int, csize: int,
                         commit: bool = True) -> None:
        """Apply one wire-format *chunk* at element offset ``lo``: the rule on
        ``[lo, lo+csize)`` of the param and the matching state windows,
        rank window by rank window where the chunk crosses ranks (every
        splittable rule is element-wise over param, grad and state).
        ``commit`` bumps the version once per op — on its final chunk — so
        snapshot caches and the diff stream keep op-granular versions."""
        if codec is None or codec.identity:
            g = self._on_device(grad_in)
        else:
            g = codec.decode_parts([self._on_device(v) for v in grad_in], csize)
        self._write(int(lo), int(csize), g)
        if commit:
            self._m_applies.inc()
            self._invalidate()

    def _invalidate(self) -> None:
        self.version += 1
        self._pull_cache = None

    def seed(self, value: Any) -> None:
        """Whole-shard write (seeding / PARAM_PUSH): each rank's window of
        ``value`` into its block, a new version.  Rule state is kept — the
        reference's seed overwrites params only.  Into the slot's storage
        when donating, else into fresh storage."""
        if not self.config.donate:
            self.sharded_param = self.sharded_param.map(torch.empty_like)
        src = _as_tensor(value).reshape(-1)
        for block, (lo, hi) in zip(self.blocks, self.windows):
            block.copy_(self._on_device(src[lo:hi], block.device))
        self._invalidate()

    def load_state(self, state: Optional[Dict[str, Any]]) -> None:
        """Lay a whole rule state (a checkpoint's or a migrated shard's
        arrays) over the ranks by the plane's rule, in owned storage; an
        empty one leaves the rule's init in place."""
        if state:
            self.sharded_state = self._lay_state(state)

    # -- read path: per-version caches on both sides of the boundary ---------

    def snapshot_host(self) -> np.ndarray:
        """This version's param gathered to the host, cached: N wire reads
        of one committed version cost one copy however many clients ask.
        Always an owned host array, never a view of a block (which the
        next apply rewrites)."""
        if self._snap_host is None or self._snap_host[0] != self.version:
            self._snap_host = (self.version, self.sharded_param.gather("cpu").numpy())
            self._m_copies.inc()
        return self._snap_host[1]

    def pull_device(self) -> torch.Tensor:
        """This version's param gathered into one fresh tensor on the slot's
        device, cached and shared by every puller of the version.  Never a
        view of a block, so a later in-place apply cannot change it under a
        holder; holders only read it."""
        cached = self._pull_cache
        if cached is not None and cached[0] == self.version:
            return cached[1]
        pulled = self.sharded_param.gather(self.device)
        self._m_gathers.inc()
        self._pull_cache = (self.version, pulled)
        return pulled

    def state_host(self) -> Dict[str, np.ndarray]:
        """The rule state gathered whole to the host, in fresh arrays (what
        checkpoints and SHARD_STATE carry)."""
        return {k: v.gather("cpu").numpy() for k, v in self.sharded_state.items()}

    def state_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Each state leaf's whole shape."""
        return {k: v.shape for k, v in self.sharded_state.items()}

    # -- introspection --------------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        placement = self.sharded_param.placement
        return {
            "size": self.size,
            "dtype": self.dtype.name,
            "version": self.version,
            # as the JAX slot counts them: the ranks of the mesh
            "devices": self.ranks,
            "spec": list(placement.spec) if placement.mesh is not None else None,
            "device_set": sorted({str(d) for d in placement.devices}),
            "device": str(self.device),
            "donate": self.config.donate,
        }
