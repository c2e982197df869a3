"""Device-resident shard slots — params and optimizer state stay on the card.

The port of ``mpit_tpu/dplane/hbm.py``.  An :class:`HbmSlot` is the device
side of one PS shard: the parameter slice and its rule (optimizer) state
live as tensors on the card, and every update runs ``rule.apply`` there —
Adam's sweep is kernel K3 — without a host hop.

Donation, the JAX package's way of letting an update write into its
inputs' buffers, becomes an in-place update here:

- ``donate=True`` (the default): the rule writes the slot's own storage;
  ``param.data_ptr()`` is the same before and after an apply, and a
  holder of the old tensor sees the new values (K3 updates in place).
- ``donate=False``: the apply runs on fresh copies of param and state,
  so a holder of the old tensors keeps the old values.

Reads are cached per committed version, on both sides of the host
boundary:

- :meth:`HbmSlot.snapshot_host` — ONE device->host copy per version (the
  wire path's snapshot, shared by every wire read and by checkpoints);
- :meth:`HbmSlot.pull_device` — ONE fresh device clone per version, never
  a view of ``param``: an in-place apply must never change a tensor a
  puller still holds.  Every puller of one version shares that clone, so
  callers only read it (or ``copy_`` out of it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from mpit_tpu_torch.dplane.partition import MULTI_DEVICE
from mpit_tpu_torch.obs.metrics import registry_or_local
from mpit_tpu_torch.optim.rules import ShardRule
from mpit_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class PlaneConfig:
    """How a server places and serves its device-resident shards.

    ``mesh=None`` places on one device; a mesh over more than one device
    raises (multi-card parallelism).  ``device`` names the card (None: the
    server's own device, ``cuda`` unless the caller asks for the CPU).
    ``publish=False`` keeps the slots device-resident without offering the
    in-process exchange (``namespace`` isolates concurrent gangs in one
    process)."""

    mesh: Optional[Any] = None
    axis: str = "shard"
    donate: bool = True
    publish: bool = True
    namespace: str = ""
    device: Optional[str] = None

    @classmethod
    def auto(cls, **kw) -> "PlaneConfig":
        """One-card placement: the port's plane holds a shard on one
        device (the JAX package spreads it over every default device)."""
        return cls(mesh=None, **kw)


def _check_mesh(cfg: Optional[PlaneConfig]) -> None:
    if cfg is not None and cfg.mesh is not None \
            and math.prod(cfg.mesh.shape.values()) > 1:
        raise NotImplementedError(f"PlaneConfig(mesh={cfg.mesh!r}): {MULTI_DEVICE}")


def _as_tensor(x: Any) -> torch.Tensor:
    """A tensor view of ``x`` (a numpy array is aliased, not copied)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def place_flat(arr: Any, cfg: Optional[PlaneConfig]) -> torch.Tensor:
    """A flat vector on the plane's device (the card unless the config names
    the CPU).  Not necessarily owned: a CPU tensor made from numpy aliases it
    (see :func:`device_copy`)."""
    _check_mesh(cfg)
    return _as_tensor(arr).to(resolve_device(cfg.device if cfg is not None else None))


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
                device: Any = None) -> Dict[str, torch.Tensor]:
    """Place a rule-state dict next to its param: every leaf an owned tensor
    on the plane's device (restored or migrated state feeds in-place
    applies, which must never write host arrays), de-aliased."""
    _check_mesh(cfg)
    dev = torch.device(device) if device is not None else resolve_device(
        cfg.device if cfg is not None else None)

    def own(v: Any) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        src = torch.from_numpy(np.array(v))  # keeps 0-d as 0-d
        return torch.empty(src.shape, dtype=src.dtype, device=dev).copy_(src)

    return dedupe_state({k: own(v) for k, v in (state or {}).items()})


class HbmSlot:
    """One device-resident shard: param + rule state + versioned caches."""

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
        _check_mesh(self.config)
        self.rank = rank
        #: the card this slot lives on: the config's, else the caller's
        #: (the server passes its own), else ``cuda``
        self.device = resolve_device(self.config.device) \
            if self.config.device is not None or device is None \
            else torch.device(device)
        self.param = torch.zeros(self.size, dtype=torch.float32, device=self.device)
        self.rule_state = dedupe_state(rule.init(self.param))
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

    # -- write path: the rule on the card, in place --------------------------

    def _on_device(self, x: Any) -> torch.Tensor:
        return _as_tensor(x).to(self.device)

    def _write(self, lo: int, n: int, grad: torch.Tensor) -> None:
        """``rule.apply`` on ``param[lo:lo+n]`` and the matching state
        windows — in the slot's own storage when donating, else in fresh
        copies that replace it."""
        if not self.config.donate:
            self.param = self.param.clone()
            self.rule_state = {k: v.clone() for k, v in self.rule_state.items()}
        if lo == 0 and n == self.size:
            p, state = self.param, self.rule_state
        else:
            p = self.param[lo:lo + n]
            state = {k: v[lo:lo + n] for k, v in self.rule_state.items()}
        self.rule.apply(p, grad, state)  # the port's rules update in place

    def apply_grad(self, grad: Any) -> None:
        """Apply one device-native gradient (identity wire format)."""
        self._write(0, self.size, self._on_device(grad))
        self._m_applies.inc()
        self._invalidate()

    def apply_wire(self, codec, grad_in: Any) -> None:
        """Apply one wire-format gradient: ``grad_in`` is the decoded frame
        (identity codecs) or the codec's split wire parts, as the server's
        host path builds them; the parts are decoded on the card with
        ``codec.decode_parts``, then the rule runs — the same ops in the
        same order as the server without a plane, so both stay bitwise
        equal."""
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
        ``param[lo:lo+csize]`` and the matching state windows (every
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
        """Whole-shard write (seeding / PARAM_PUSH): a new version.  Rule
        state is kept — the reference's seed overwrites params only.  Into
        the slot's storage when donating, else into fresh storage."""
        src = self._on_device(value).reshape(-1)
        if self.config.donate:
            self.param.copy_(src)
        else:
            self.param = torch.empty_like(self.param).copy_(src)
        self._invalidate()

    # -- read path: per-version caches on both sides of the boundary ---------

    def snapshot_host(self) -> np.ndarray:
        """This version's device->host copy, cached: N wire reads of one
        committed version cost one copy however many clients ask.  Always
        an owned host array, never a view of ``param`` (which the next
        apply rewrites)."""
        if self._snap_host is None or self._snap_host[0] != self.version:
            self._snap_host = (self.version, self.param.to("cpu", copy=True).numpy())
            self._m_copies.inc()
        return self._snap_host[1]

    def pull_device(self) -> torch.Tensor:
        """This version's param as a fresh device clone, cached and shared
        by every puller of the version.  Never a view of ``param``, so a
        later in-place apply cannot change it under a holder; holders only
        read it."""
        cached = self._pull_cache
        if cached is not None and cached[0] == self.version:
            return cached[1]
        pulled = self.param.clone()
        self._m_gathers.inc()
        self._pull_cache = (self.version, pulled)
        return pulled

    # -- introspection --------------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        return {
            "size": self.size,
            "dtype": self.dtype.name,
            "version": self.version,
            "devices": 1,
            "device": str(self.device),
            "donate": self.config.donate,
        }
