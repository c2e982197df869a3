"""The device exchange: client<->server param traffic that stays on the card.

The port of ``mpit_tpu/dplane/exchange.py``.  The topology decision is made
once per (client, server) pair at ``start`` (``docs/DEVICE.md`` §3):

- the server published a :class:`DevicePlane` in this process's plane
  registry, its backend fingerprint matches the client's, the codec is
  identity, and the gang is on the static shard cut  ==>  **device path**:
  ops go straight to the server's plane queue and run on the server's own
  thread against its :class:`~mpit_tpu_torch.dplane.hbm.HbmSlot` — grads
  ride as device tensors, pulls return the slot's per-version device
  clone, and delivery is exactly-once by construction (an in-process queue
  cannot drop, duplicate or reorder);
- anything else  ==>  **wire fallback**: the op runs through the inner
  :class:`~mpit_tpu_torch.ps.client.ParamClient` unchanged — codecs,
  framing, retry/dedup intact.  The fallback is the specified behaviour,
  counted per client (``mpit_dplane_wire_fallback_ranks``);
  ``require_device=True`` makes it an error.

The protocol wire is always live: INIT, seeding, heartbeats and STOP ride
it, so leases and the stop protocol are the same in every mode.

The registry is the port's own: a JAX client never finds a port plane and
a port client never finds a JAX plane, so every mixed pair rides the wire.

Tensors cross threads here.  A grad or push ticket carries an owned device
copy made on the client's thread at submit, with a CUDA event recorded on
the client's current stream; the server's stream waits on that event
before the apply reads it and records it as a user of the tensor.  A
``pull_dev`` result goes the other way.  Neither side assumes the other
runs on the same stream.  A slot laid over ranks on other cards copies each
rank's window of the grad to its card after that wait (PyTorch orders a
copy between cards after the current streams of both), and gathers a pull
back onto the server's card; the client moves the pulled tensor onto its
own device where that differs.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mpit_tpu_torch.obs.metrics import registry_or_local
from mpit_tpu_torch.utils.logging import get_logger
from mpit_tpu_torch.utils.platform import resolve_device


class ExchangeError(RuntimeError):
    """A device-path op failed terminally (server stopped / timed out)."""


def backend_fingerprint(device: Any = None) -> Tuple[int, str]:
    """``(pid, "cuda" | "cpu")`` — two ranks share a backend when both
    match: the process makes the in-process queue sound, the device type
    makes one side's tensors usable by the other without a host hop.
    ``device`` None means the card."""
    dev = device if isinstance(device, torch.device) else resolve_device(device)
    return (os.getpid(), dev.type)


# ---------------------------------------------------------------------------
# the process-local plane registry (the rendezvous for the device path)


_registry: Dict[Tuple[str, int], "DevicePlane"] = {}
_registry_lock = threading.Lock()


def publish(rank: int, plane: "DevicePlane", namespace: str = "") -> None:
    with _registry_lock:
        _registry[(namespace, rank)] = plane


def withdraw(rank: int, namespace: str = "") -> None:
    with _registry_lock:
        _registry.pop((namespace, rank), None)


def lookup(rank: int, namespace: str = "") -> "Optional[DevicePlane]":
    with _registry_lock:
        return _registry.get((namespace, rank))


# ---------------------------------------------------------------------------
# stream hand-off between the client's and the server's threads


def mark_ready(t: Optional[torch.Tensor]) -> Optional[torch.cuda.Event]:
    """An event on the current stream after the work that produced ``t``
    (None for a CPU tensor: CPU ops complete in order)."""
    if t is None or not t.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def take(t: Optional[torch.Tensor], ready: Optional[torch.cuda.Event]) -> None:
    """Make the current stream wait for ``t``'s producer, and register the
    stream as a user of ``t`` so its memory is not reused under it."""
    if t is None or not t.is_cuda:
        return
    stream = torch.cuda.current_stream(t.device)
    if ready is not None:
        stream.wait_event(ready)
    t.record_stream(stream)


class DeviceTicket:
    """One submitted device op; the client blocks on ``event``."""

    __slots__ = ("kind", "crank", "srank", "payload", "ready", "event", "result",
                 "error", "t_submit", "queued_s")

    def __init__(self, kind: str, crank: int, srank: int, payload=None,
                 ready: Optional[torch.cuda.Event] = None):
        self.kind = kind  # 'grad' | 'push' | 'pull' | 'pull_dev'
        self.crank = crank
        self.srank = srank
        self.payload = payload
        #: an event after the payload's producer (client -> server), then
        #: after the result's producer (server -> client)
        self.ready = ready
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        #: submit time, and the seconds the ticket waited in the plane's
        #: queue before the server's service took it (set by the service)
        self.t_submit = time.perf_counter()
        self.queued_s = 0.0


class DevicePlane:
    """A server's published device-exchange endpoint: a FIFO ticket queue
    drained by the server's own scheduler task, so device ops serialize
    with wire ops under the server's single-writer discipline."""

    def __init__(self, rank: int, fingerprint: Tuple[int, str],
                 device: Any = "cpu"):
        self.rank = rank
        self.fingerprint = fingerprint
        #: the device the server's slot lives on (where tickets land)
        self.device = torch.device(device)
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._closed: Optional[str] = None

    def submit(self, ticket: DeviceTicket) -> DeviceTicket:
        with self._lock:
            if self._closed is not None:
                raise ExchangeError(
                    f"device plane of server {self.rank} is closed ({self._closed})")
            self._q.append(ticket)
        return ticket

    def pop(self) -> Optional[DeviceTicket]:
        with self._lock:
            ticket = self._q.popleft() if self._q else None
        if ticket is not None:
            ticket.queued_s = time.perf_counter() - ticket.t_submit
        return ticket

    def close(self, reason: str) -> None:
        """Terminal: fail every queued ticket loudly — a client blocked on
        a stopped server's plane must raise, never hang."""
        with self._lock:
            self._closed = reason
            pending = list(self._q)
            self._q.clear()
        for t in pending:
            t.error = ExchangeError(
                f"server {self.rank} stopped before serving the {t.kind} op "
                f"({reason})")
            t.event.set()

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q)


# ---------------------------------------------------------------------------
# client side


class ExchangeClient:
    """ParamClientAPI front for a :class:`ParamClient` that routes each
    server's data ops over the device path when eligible and the wire
    otherwise.  Drop-in for the comm-aware optimizers, which keep writing
    the host mirrors; :meth:`sync_device` is the extra round that stays on
    the card for trainers holding device tensors.  ``device`` is the
    client's device (the card unless the caller asks for the CPU)."""

    def __init__(self, inner, *, device_ranks: Optional[Sequence[int]] = None,
                 namespace: str = "", require_device: bool = False,
                 device: Any = None):
        self.pc = inner
        self.namespace = namespace
        self.device = resolve_device(device) if not isinstance(
            device, torch.device) else device
        self._forced = list(device_ranks) if device_ranks is not None else None
        self._require = require_device
        self._planes: Dict[int, DevicePlane] = {}
        self._pending: List[DeviceTicket] = []
        #: the device tickets the last ``wait`` / ``sync_device`` collected
        self.last_tickets: List[DeviceTicket] = []
        self.log = get_logger("dplane", inner.rank)
        _m = registry_or_local()
        self._m_dev_ranks = _m.gauge("mpit_dplane_device_ranks", rank=inner.rank)
        self._m_wire_ranks = _m.gauge("mpit_dplane_wire_fallback_ranks",
                                      rank=inner.rank)
        self._m_ops = {
            "device": _m.counter("mpit_dplane_exchange_ops_total",
                                 rank=inner.rank, path="device"),
            "wire": _m.counter("mpit_dplane_exchange_ops_total",
                               rank=inner.rank, path="wire"),
        }

    # -- mirrors (honor inner.reset retargets) -------------------------------

    @property
    def param(self) -> np.ndarray:
        return self.pc.param

    @property
    def grad(self) -> np.ndarray:
        return self.pc.grad

    @property
    def device_ranks(self) -> List[int]:
        return sorted(self._planes)

    # -- lifecycle -----------------------------------------------------------

    def start(self, param: np.ndarray, grad: np.ndarray) -> None:
        """Full wire handshake first (INIT + seeding are protocol, not
        data), then resolve which servers are device-eligible."""
        self.pc.start(param, grad)
        self._resolve()

    def _resolve(self) -> None:
        self._planes.clear()
        fp = backend_fingerprint(self.device)
        eligible = self.pc.codec.identity and not getattr(self.pc, "_sc", False)
        for srank in self.pc.sranks:
            if self._forced is not None and srank not in self._forced:
                continue
            plane = lookup(srank, self.namespace)
            if plane is not None and eligible and plane.fingerprint == fp:
                self._planes[srank] = plane
        if self._forced is not None:
            missing = set(self._forced) - set(self._planes)
            if missing:
                raise ExchangeError(
                    f"device_ranks {sorted(missing)} are not device-eligible (no "
                    "published plane, fingerprint mismatch, non-identity codec, "
                    "or shardctl mode)")
        if self._require and len(self._planes) < len(self.pc.sranks):
            wire = sorted(set(self.pc.sranks) - set(self._planes))
            raise ExchangeError(f"require_device: servers {wire} fell back to the wire")
        self._m_dev_ranks.set(len(self._planes))
        self._m_wire_ranks.set(len(self.pc.sranks) - len(self._planes))
        if self._planes:
            self.log.info("device exchange to servers %s (wire fallback: %s)",
                          self.device_ranks,
                          sorted(set(self.pc.sranks) - set(self._planes)))

    def reset(self, param: np.ndarray, grad: np.ndarray) -> None:
        self.pc.reset(param, grad)

    def _deadline_s(self) -> float:
        ft = self.pc.ft
        if ft.op_deadline_s > 0:
            return ft.op_deadline_s * (ft.max_retries + 1) + 5.0
        return 60.0

    def _submit(self, srank: int, kind: str, payload: Optional[torch.Tensor] = None
                ) -> None:
        ticket = DeviceTicket(kind, self.pc.rank, srank, payload, mark_ready(payload))
        self._planes[srank].submit(ticket)
        self._pending.append(ticket)
        self._m_ops["device"].inc()

    def _owned(self, srank: int, src: Any) -> torch.Tensor:
        """The submit-time copy onto the server's device: the optimizer may
        rewrite the mirror (or the caller its tensor) the moment ``wait``
        returns, as after the wire path's encode-at-ship staging.  Owned
        even on the CPU, where ``torch.from_numpy`` would alias."""
        dev = self._planes[srank].device
        if isinstance(src, torch.Tensor):
            return src.to(dev, copy=True)
        return torch.from_numpy(src).to(dev, copy=True)

    # -- ParamClientAPI ------------------------------------------------------

    def async_send_grad(self) -> None:
        if not self._planes:  # every server on the wire: the client's own op
            self._m_ops["wire"].inc()
            self.pc.async_send_grad()
            return
        for srank, shard in zip(self.pc.sranks, self.pc.shards):
            if srank in self._planes:
                self._submit(srank, "grad",
                             self._owned(srank, self.grad[shard.offset:shard.end]))
            else:
                self._m_ops["wire"].inc()
                self.pc.enqueue_wire_op(srank, self.pc._send_grad(srank, shard),
                                        "send_grad")

    def async_recv_param(self) -> None:
        if not self._planes:
            self._m_ops["wire"].inc()
            self.pc.async_recv_param()
            return
        for srank, shard in zip(self.pc.sranks, self.pc.shards):
            if srank in self._planes:
                self._submit(srank, "pull")
            else:
                self._m_ops["wire"].inc()
                self.pc.enqueue_wire_op(srank, self.pc._recv_param(srank, shard),
                                        "recv_param")

    def async_send_param(self) -> None:
        if not self._planes:
            self._m_ops["wire"].inc()
            self.pc.async_send_param()
            return
        for srank, shard in zip(self.pc.sranks, self.pc.shards):
            if srank in self._planes:
                self._submit(srank, "push",
                             self._owned(srank, self.param[shard.offset:shard.end]))
            else:
                self._m_ops["wire"].inc()
                self.pc.enqueue_wire_op(srank, self.pc._send_param(srank, shard),
                                        "send_param")

    def ping(self, n: int = 1) -> None:
        self.pc.ping(n)

    def _collect(self) -> List[DeviceTicket]:
        """Drain the wire, then await every pending device ticket."""
        self.pc.wait()
        pending, self._pending = self._pending, []
        deadline = self._deadline_s()
        for ticket in pending:
            if not ticket.event.wait(deadline):
                raise ExchangeError(
                    f"device {ticket.kind} op timed out after {deadline:.1f}s "
                    "(server service stalled?)")
            if ticket.error is not None:
                raise ticket.error
        self.last_tickets = pending
        return pending

    def wait(self) -> None:
        """Drain the wire, then the device tickets.  A pull ticket's result
        is the slot's per-version host snapshot — written into the
        registered param mirror exactly where the wire path would decode
        it."""
        shard_of = dict(zip(self.pc.sranks, self.pc.shards))
        for ticket in self._collect():
            if ticket.kind == "pull":
                shard = shard_of[ticket.srank]
                self.param[shard.offset:shard.end] = ticket.result

    def stop(self) -> None:
        self.pc.stop()

    def residual_norm(self) -> float:
        return self.pc.residual_norm()

    @property
    def retries(self) -> int:
        return self.pc.retries

    # -- the fully device-resident round ------------------------------------

    def sync_device(self, update, *, pull: bool = True, concat: bool = True):
        """One PS round that never touches the host for device-eligible
        servers.  ``update`` is one flat device tensor (sliced per shard)
        or a per-shard list.  Refreshed params come back as one vector
        (``concat=True``, always a tensor of the caller's own) or the
        per-shard list (``concat=False``: the shared per-version pull
        tensors, zero extra copies — read them, do not write them).
        Wire-fallback servers are staged through the host mirrors by
        :meth:`_stage_wire_host`."""
        parts_in = isinstance(update, (list, tuple))
        if parts_in and len(update) != len(self.pc.shards):
            raise ValueError(
                f"{len(update)} update parts for {len(self.pc.shards)} shards")
        wire_ranks = [s for s in self.pc.sranks if s not in self._planes]
        if wire_ranks:
            self._stage_wire_host(update, wire_ranks, parts_in)
        for idx, (srank, shard) in enumerate(zip(self.pc.sranks, self.pc.shards)):
            if srank in self._planes:
                g = update[idx] if parts_in else update[shard.offset:shard.end]
                self._submit(srank, "grad", self._owned(srank, g))
                if pull:
                    self._submit(srank, "pull_dev")
        if not pull:
            self.wait()
            return None
        pulls: Dict[int, torch.Tensor] = {}
        for ticket in self._collect():
            if ticket.kind == "pull_dev":
                take(ticket.result, ticket.ready)
                pulled = ticket.result  # the slot's gather, on the server's device
                pulls[ticket.srank] = (pulled if pulled.device == self.device
                                       else pulled.to(self.device))
        parts = []
        for srank, shard in zip(self.pc.sranks, self.pc.shards):
            if srank in pulls:
                parts.append(pulls[srank])
            else:
                parts.append(torch.from_numpy(
                    self.param[shard.offset:shard.end]).to(self.device, copy=True))
        if not concat:
            return parts
        if len(parts) > 1:
            return torch.cat(parts)
        if self.pc.sranks[0] in pulls:
            # One shard: never hand out the shared per-version tensor as a
            # vector the caller owns (a later in-place update would change
            # every other holder's copy).
            return parts[0].clone()
        return parts[0]

    def _stage_wire_host(self, update, wire_ranks: List[int],
                         parts_in: bool = False) -> None:
        """Stage the wire-fallback ranks' updates through the host mirrors
        once and run their framed send+recv ops — inside the existing
        retry/dedup machinery."""
        host = None if parts_in else _host(update)
        for idx, (srank, shard) in enumerate(zip(self.pc.sranks, self.pc.shards)):
            if srank in wire_ranks:
                self.grad[shard.offset:shard.end] = (
                    _host(update[idx]) if parts_in else host[shard.offset:shard.end])
                self._m_ops["wire"].inc()
                self.pc.enqueue_wire_op(srank, self.pc._send_grad(srank, shard),
                                        "send_grad")
                self.pc.enqueue_wire_op(srank, self.pc._recv_param(srank, shard),
                                        "recv_param")


def _host(x: Any) -> np.ndarray:
    return x.detach().to("cpu").numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
