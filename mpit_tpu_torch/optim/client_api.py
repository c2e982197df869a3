"""The parameter-client protocol the comm-aware optimizers drive.

A copy of ``ParamClientAPI`` and its ``DeviceSyncAPI`` extension from
``mpit_tpu/optim/client_api.py``.  The port imports nothing of the JAX
package.

Mirrors the reference pClient surface (reference asyncsgd/pclient.lua:84-179):
``start/reset`` register host-visible flat buffers, the ``async_*`` calls
enqueue per-server transfer tasks, ``ping`` single-steps I/O to overlap with
compute, ``wait`` drains, ``stop`` runs the shutdown protocol.

The real implementation is :class:`mpit_tpu_torch.ps.client.ParamClient`.
Buffers are 1-D float32 numpy arrays the client slices per server shard;
the optimizers keep their tensors on the device and copy to and from
these host mirrors on sync rounds.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class ParamClientAPI(Protocol):
    def start(self, param: np.ndarray, grad: np.ndarray) -> None:
        """Register buffers, announce shard offsets to servers, and (first
        client only) seed the servers' shards from ``param``."""

    def reset(self, param: np.ndarray, grad: np.ndarray) -> None:
        """Retarget the transfer buffers (reference pclient.lua:138-151) —
        e.g. EASGD points them at its center/elastic-delta copies."""

    def async_send_grad(self) -> None: ...

    def async_recv_param(self) -> None: ...

    def async_send_param(self) -> None: ...

    def ping(self) -> None:
        """Make one unit of I/O progress without blocking."""

    def wait(self) -> None:
        """Block until all enqueued transfers complete."""

    def stop(self) -> None: ...


@runtime_checkable
class DeviceSyncAPI(ParamClientAPI, Protocol):
    """Optional extension (:class:`mpit_tpu_torch.dplane.ExchangeClient`): a
    PS round that stays in device memory.  ``sync_device(update)`` ships a
    flat device tensor update and returns the refreshed parameter vector as
    a device tensor — no host mirrors touched for device-eligible servers
    (wire-fallback servers are staged through the mirrors).  Trainers should
    feature-test with ``isinstance(pc, DeviceSyncAPI)`` and keep the mirror
    path as the universal fallback."""

    def sync_device(self, update, *, pull: bool = True): ...
