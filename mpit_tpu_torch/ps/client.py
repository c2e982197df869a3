"""ParamClient — shards the flat parameter vector across servers and
drives asynchronous shard transfers.

The port of the core of ``ParamClient`` of ``mpit_tpu/ps/client.py`` (a rebuild
of reference asyncsgd/pclient.lua).  The client registers two host
buffers (``param``, ``grad``: numpy arrays) whose per-server contiguous
slices are the transfer units (numpy views = the reference's zero-copy
storage-offset views, pclient.lua:50-52).  Public surface mirrors
pclient.lua:84-179: ``start``, ``async_send_grad``, ``async_recv_param``,
``async_send_param``, ``ping``, ``wait``, ``reset``, ``stop``.

The comm-aware optimizers (:mod:`mpit_tpu_torch.optim`) drive this class
through the ParamClientAPI protocol; tensors on the card stay in the
optimizer layer — the client only touches the registered host mirrors, so
it is the JAX package's client byte for byte.

Wire codecs: the client announces a codec in its INIT v2 (``MPIT_PS_CODEC``
or the ``codec`` argument) and every GRAD/PARAM/PARAM_PUSH frame to/from
that server travels in that format.  For the lossy ``int8`` codec the
client holds one error-feedback residual per shard: the gradient
quantization error is added back into the next shipped gradient instead of
being lost.  ``codec='none'`` sends the registered slices themselves.

The shard cut is :func:`mpit_tpu_torch.ps.sharding.shard_layout`'s equal
split, the cut the JAX client's version-0 shard map makes.  Fault
tolerance (framing, deadlines, retry, heartbeats), shard control, the
weighted layout and chunked streaming come with later slices: their
constructor arguments raise ``NotImplementedError`` naming the slice.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, Generator, List, Optional, Tuple

import numpy as np

from mpit_tpu_torch.aio import LiveFlag, Scheduler, Task, aio_recv, aio_send
from mpit_tpu_torch.comm import codec as codec_mod
from mpit_tpu_torch.comm.transport import Transport
from mpit_tpu_torch.ps import tags
from mpit_tpu_torch.ps.server import refuse_later
from mpit_tpu_torch.ps.sharding import Shard, shard_layout

#: What each refused constructor argument of the JAX client belongs to.
LATER_CLIENT_ARGS = {
    "ft": "fault tolerance (slice 5, ft)",
    "shard_map": "shard control (slice 5, shardctl)",
    "shardctl": "shard control (slice 5, shardctl)",
    "controller_rank": "shard control (slice 5, shardctl)",
    "sc_shards_per_server": "shard control (slice 5, shardctl)",
    "layout": "the weighted shard layout (slice 7, lm)",
}


class ParamClient:
    def __init__(
        self,
        rank: int,
        server_ranks: List[int],
        transport: Transport,
        seed_servers: bool = False,
        codec: Optional[str] = None,
        **later: Any,
    ):
        refuse_later("ParamClient", later, LATER_CLIENT_ARGS)
        self.rank = rank
        self.sranks = list(server_ranks)
        self.transport = transport
        self.sched = Scheduler()
        self.seed_servers = seed_servers  # this is the first client
        self.codec = codec_mod.get(codec)  # None/'' -> $MPIT_PS_CODEC
        self.live = LiveFlag()
        self.param: Optional[np.ndarray] = None
        self.grad: Optional[np.ndarray] = None
        self.shards: List[Shard] = []
        # Per-server codec state: encode/decode staging sized to the wire
        # format, plus the int8 error-feedback residual (grad path only).
        self._grad_wire: Dict[int, np.ndarray] = {}
        self._param_wire: Dict[int, np.ndarray] = {}
        self._residual: Dict[int, np.ndarray] = {}
        # Per-server FIFO op chains: ops addressed to the same server run in
        # issue order (a send_grad's ack completes before a later param
        # request is sent), while different servers stay fully concurrent.
        # Strictly stronger than the reference (which relies on coroutine
        # spawn order for freshness, pclient.lua:84-109).
        self._opq: Dict[int, Deque[Tuple[Generator, str]]] = {}
        self._pump_live: Dict[int, bool] = {}
        self._pump_task: Dict[int, Optional[Task]] = {}

    # -- lifecycle ----------------------------------------------------------

    def start(self, param: np.ndarray, grad: np.ndarray) -> None:
        """Announce shard layout + codec to every server (INIT v2: int64
        [offset, size, codec_id]); the first client seeds the servers'
        shards from ``param`` (reference pclient.lua:111-129)."""
        self._register(param, grad)
        self.shards = shard_layout(len(param), len(self.sranks))
        for srank, shard in zip(self.sranks, self.shards):
            if not self.codec.identity:
                nbytes = self.codec.wire_nbytes(shard.size)
                self._grad_wire[srank] = np.zeros(nbytes, np.uint8)
                self._param_wire[srank] = np.zeros(nbytes, np.uint8)
                if self.codec.uses_residual:
                    self._residual[srank] = np.zeros(shard.size, np.float32)
            cinfo = np.asarray([shard.offset, shard.size, self.codec.wire_id],
                               dtype=np.int64)
            self.sched.spawn(aio_send(self.transport, cinfo, srank, tags.INIT,
                                      live=self.live),
                             name=f"send_init:{srank}")
        self.wait()
        if self.seed_servers:
            self.async_send_param()
            self.wait()

    def _register(self, param: np.ndarray, grad: np.ndarray) -> None:
        if not isinstance(param, np.ndarray) or not isinstance(grad, np.ndarray):
            raise TypeError("param and grad must be numpy arrays (host mirrors)")
        if param.ndim != 1 or grad.shape != param.shape:
            raise ValueError("param and grad must be 1-D with equal shape")
        if param.dtype != np.float32 or grad.dtype != np.float32:
            raise ValueError("param and grad must be float32")
        if not param.flags["C_CONTIGUOUS"] or not grad.flags["C_CONTIGUOUS"]:
            raise ValueError("param and grad must be contiguous (zero-copy rule)")
        self.param, self.grad = param, grad

    def reset(self, param: np.ndarray, grad: np.ndarray) -> None:
        """Retarget transfer buffers without re-announcing shards
        (reference pclient.lua:138-151).  Error-feedback residuals are
        keyed by shard, not by buffer — they survive the retarget."""
        if self.shards and len(param) != self.shards[-1].end:
            raise ValueError("reset buffers must keep the registered length")
        self._register(param, grad)

    # -- per-server ops ------------------------------------------------------

    def _encode(self, view: np.ndarray, wire: Optional[np.ndarray],
                residual: Optional[np.ndarray] = None) -> np.ndarray:
        """The slice itself for the identity codec (zero-copy send);
        otherwise the encoded frame in the per-server staging buffer."""
        if wire is None:
            return view
        self.codec.encode_into(view, wire, residual=residual)
        return wire

    def _send_grad(self, srank: int, shard: Shard):
        """Ship the grad slice, await the applied ack
        (reference pclient.lua:48-58).  Non-identity codecs encode into
        the per-server staging frame at ship time; the int8 residual is
        folded in and refreshed by the same pass."""
        payload = self._encode(self.grad[shard.offset:shard.end],
                               self._grad_wire.get(srank),
                               residual=self._residual.get(srank))
        yield from aio_send(self.transport, payload, srank, tags.GRAD,
                            live=self.live)
        yield from aio_recv(self.transport, srank, tags.GRAD_ACK, live=self.live)

    def _recv_param(self, srank: int, shard: Shard):
        """Request-to-read header, then receive into the param slice
        (reference pclient.lua:72-82) — via the wire staging frame when
        the codec is not identity."""
        out = self.param[shard.offset:shard.end]
        wire = self._param_wire.get(srank)
        yield from aio_send(self.transport, tags.EMPTY, srank, tags.PARAM_REQ,
                            live=self.live)
        got = yield from aio_recv(self.transport, srank, tags.PARAM,
                                  live=self.live,
                                  out=out if wire is None else wire)
        if got is not None and wire is not None:
            self.codec.decode_into(wire, out)

    def _send_param(self, srank: int, shard: Shard):
        """Whole-shard write, await ack (reference pclient.lua:60-70).
        No residual: parameter pushes (seeding / single-worker mirror)
        are one-shot state transfers, not an accumulating signal."""
        payload = self._encode(self.param[shard.offset:shard.end],
                               self._param_wire.get(srank))
        yield from aio_send(self.transport, payload, srank, tags.PARAM_PUSH,
                            live=self.live)
        yield from aio_recv(self.transport, srank, tags.PARAM_PUSH_ACK,
                            live=self.live)

    # -- public async API (reference pclient.lua:84-109) --------------------

    def _enqueue(self, srank: int, gen: Generator, name: str) -> None:
        queue = self._opq.setdefault(srank, deque())
        queue.append((gen, name))
        if not self._pump_live.get(srank, False):
            self._pump_live[srank] = True
            self._pump_task[srank] = None
            self._pump_task[srank] = self.sched.spawn(
                self._pump(srank), name=f"pump:{srank}:{name}")

    def _pump(self, srank: int):
        """Run this server's queued ops strictly in order, renaming the
        task per dequeued op (so errors name the op that raised)."""
        queue = self._opq[srank]
        try:
            while queue:
                op, opname = queue.popleft()
                task = self._pump_task.get(srank)
                if task is not None:
                    task.name = f"pump:{srank}:{opname}"
                yield from op
        finally:
            self._pump_live[srank] = False

    def async_send_grad(self) -> None:
        for srank, shard in zip(self.sranks, self.shards):
            self._enqueue(srank, self._send_grad(srank, shard), "send_grad")

    def async_recv_param(self) -> None:
        for srank, shard in zip(self.sranks, self.shards):
            self._enqueue(srank, self._recv_param(srank, shard), "recv_param")

    def async_send_param(self) -> None:
        for srank, shard in zip(self.sranks, self.shards):
            self._enqueue(srank, self._send_param(srank, shard), "send_param")

    def ping(self, n: int = 1) -> None:
        """Single-step I/O progress to overlap with compute
        (reference pclient.lua:131-136)."""
        for _ in range(n):
            self.sched.ping()

    def wait(self) -> None:
        self.sched.wait()

    # -- shutdown (reference pclient.lua:153-164) ---------------------------

    def stop(self) -> None:
        # Chained per server, so the stop cannot overtake in-flight ops
        # (the reference's drain-then-stop care, init.lua:50-58, README:71).
        for srank in self.sranks:
            self._enqueue(srank, aio_send(self.transport, tags.EMPTY, srank,
                                          tags.STOP, live=self.live),
                          "send_stop")
        self.wait()
        self.live.stop()
