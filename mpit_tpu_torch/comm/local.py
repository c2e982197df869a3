"""In-process transport: instant mailboxes between role endpoints.

A copy of ``mpit_tpu/comm/local.py``: the port imports nothing of the JAX
package.

The test/fake backend (SURVEY.md section 4: the reference uses MPI's
shared-memory transport as its de-facto fake; here single-process tests get
an even lighter one).  Also the backend for single-process multi-role runs
where server and client live on different threads of one Python process.

Semantics match the Transport contract: sends complete after delivery into
the destination mailbox; receives match by (src, tag) FIFO; probes see only
fully-delivered messages.  A configurable ``delay`` (number of polls before
progress) lets tests exercise the pending paths deterministically.
"""

from __future__ import annotations

import threading
from collections import defaultdict, deque
from typing import Any, Deque, Dict, Tuple

import numpy as np

from mpit_tpu_torch.comm.transport import Handle, Transport, as_bytes_view, as_writable_view


class LocalRouter:
    """Shared mailbox fabric for a set of LocalTransport endpoints."""

    def __init__(self, nranks: int, delay: int = 0):
        self.nranks = nranks
        self.delay = delay
        self.lock = threading.Lock()
        # mail[dst][(src, tag)] = deque of byte payloads
        self.mail: Dict[int, Dict[Tuple[int, int], Deque[bytes]]] = {
            r: defaultdict(deque) for r in range(nranks)
        }

    def endpoint(self, rank: int) -> "LocalTransport":
        return LocalTransport(self, rank)

    def endpoints(self) -> list["LocalTransport"]:
        return [self.endpoint(r) for r in range(self.nranks)]


class LocalTransport(Transport):
    def __init__(self, router: LocalRouter, rank: int):
        self.router = router
        self.rank = rank
        self.nranks = router.nranks

    def isend(self, data: Any, dst: int, tag: int) -> Handle:
        handle = Handle(kind="send", peer=dst, tag=tag, buf=data)
        handle.meta["polls"] = 0
        return handle

    def irecv(self, src: int, tag: int, out: Any | None = None) -> Handle:
        return Handle(kind="recv", peer=src, tag=tag, out=out)

    def iprobe(self, src: int, tag: int) -> bool:
        with self.router.lock:
            return bool(self.router.mail[self.rank][(src, tag)])

    def test(self, handle: Handle) -> bool:
        if handle.done or handle.cancelled:
            return handle.done
        if handle.kind == "send":
            handle.meta["polls"] += 1
            if handle.meta["polls"] <= self.router.delay:
                return False
            payload = bytes(as_bytes_view(handle.buf))
            with self.router.lock:
                self.router.mail[handle.peer][(self.rank, handle.tag)].append(payload)
            handle.done = True
            handle.buf = None  # release ownership back to the caller
            return True
        # recv
        with self.router.lock:
            box = self.router.mail[self.rank][(handle.peer, handle.tag)]
            if not box:
                return False
            payload = box.popleft()
        if handle.out is not None:
            view = as_writable_view(handle.out)
            if len(view) != len(payload):
                raise ValueError(
                    f"recv size mismatch: message {len(payload)}B, "
                    f"buffer {len(view)}B (src={handle.peer}, tag={handle.tag})"
                )
            view[:] = payload
        else:
            handle.payload = payload
        handle.done = True
        return True

    def cancel(self, handle: Handle) -> None:
        handle.cancelled = True
        handle.buf = None
