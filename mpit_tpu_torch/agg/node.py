"""The group plane: colocated pre-reduction rendezvous (PROTOCOL.md §13.2).

The port of ``mpit_tpu/agg/node.py``.  Clients that share a backend (the
dplane :func:`~mpit_tpu_torch.dplane.exchange.backend_fingerprint` check:
same process, same device type) never put their gradients on the wire.
The group's representative publishes an :class:`AggPlane` — a
single-writer FIFO ticket queue, the shape of the device exchange's
:class:`~mpit_tpu_torch.dplane.exchange.DevicePlane` — and each member
submits one :class:`AggTicket` per round carrying its gradient (a card
tensor on a card backend, with the event its copy was recorded behind; a
host copy on the CPU).  The representative's reduction task drains the
queue, folds on-time members in ascending rank order, and resolves each
ticket:

- ``ok``   — the member's gradient is inside the partial the
  representative carries upstream; the member's round is done.
- ``late`` — the straggler deadline fired and the round folded without
  this member; the member must fall back to a direct wire push (loud,
  counted, never lost).

A closed plane (representative stopped) fails every queued ticket with
:class:`AggPlaneClosed` — a member blocked on a dead representative
raises, never hangs.  The registry is the port's own: a port member never
finds a JAX representative's plane, and a CPU rank and a card rank never
share a fingerprint, so neither forms a group across the two.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional, Tuple

from mpit_tpu_torch.dplane.exchange import backend_fingerprint


class AggPlaneClosed(RuntimeError):
    """The representative stopped before serving the ticket — the
    never-hang analog of RetryExhausted for the in-process group hop."""


#: ticket outcomes
TICKET_OK = "ok"
TICKET_LATE = "late"


class AggTicket:
    """One member's per-round contribution; the member blocks on
    ``event`` and reads ``status`` (TICKET_OK / TICKET_LATE) or
    ``error``.  ``ready`` is the CUDA event recorded after the payload's
    copy on the member's stream (None for a host payload)."""

    __slots__ = ("rank", "round", "payload", "ready", "event", "status", "error")

    def __init__(self, rank: int, round_: int, payload: Any, ready: Any = None):
        self.rank = rank
        self.round = round_
        self.payload = payload
        self.ready = ready
        self.event = threading.Event()
        self.status: Optional[str] = None
        self.error: Optional[BaseException] = None

    def resolve(self, status: str) -> None:
        self.status = status
        self.event.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.event.set()


class AggPlane:
    """A representative's published group endpoint: FIFO ticket queue
    drained by the representative's own reduction task (single-writer —
    members enqueue, exactly one task folds)."""

    def __init__(self, rank: int, fingerprint: Tuple[int, str]):
        self.rank = rank
        self.fingerprint = fingerprint
        #: highest round the representative has folded — published so a
        #: straggling member can conclude LATE *itself* when the rep is
        #: idle between rounds (a member must never need the rep to be
        #: actively draining in order to learn it missed the fold).
        self.folded_round = 0
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._closed: Optional[str] = None

    def submit(self, ticket: AggTicket) -> AggTicket:
        with self._lock:
            if self._closed is not None:
                raise AggPlaneClosed(
                    f"group plane of representative {self.rank} is "
                    f"closed ({self._closed})")
            self._q.append(ticket)
        return ticket

    def pop(self) -> Optional[AggTicket]:
        with self._lock:
            return self._q.popleft() if self._q else None

    def close(self, reason: str) -> None:
        with self._lock:
            self._closed = reason
            pending = list(self._q)
            self._q.clear()
        for t in pending:
            t.fail(AggPlaneClosed(
                f"representative {self.rank} stopped before folding "
                f"rank {t.rank}'s round {t.round} ({reason})"))

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q)


# ---------------------------------------------------------------------------
# the process-local plane registry (one per namespace+rep, the dplane shape)


_registry: Dict[Tuple[str, int], AggPlane] = {}
_registry_lock = threading.Lock()


def publish(rank: int, namespace: str = "", device: Any = None) -> AggPlane:
    """Publish ``rank``'s plane under the fingerprint of ``device`` (None:
    the card)."""
    plane = AggPlane(rank, backend_fingerprint(device))
    with _registry_lock:
        _registry[(namespace, rank)] = plane
    return plane


def withdraw(rank: int, namespace: str = "") -> None:
    with _registry_lock:
        plane = _registry.pop((namespace, rank), None)
    if plane is not None:
        plane.close("withdrawn")


def lookup(rank: int, namespace: str = "") -> Optional[AggPlane]:
    with _registry_lock:
        return _registry.get((namespace, rank))
