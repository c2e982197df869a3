"""ShmTransport — the native C++ shared-memory transport, Python side.

The port of the JAX package's ``mpit_tpu/comm/shm.py``, over the port's
own copy of the native library (``mpit_tpu_torch/comm/native``).  It
implements the :class:`mpit_tpu_torch.comm.transport.Transport` contract
via the generated ctypes bindings.  The segment names (``/mt_<ns>_r<rank>``)
and the ring layout are the JAX library's bytes, so a port rank and a JAX
rank can share one namespace.  This is the host transport for same-host multi-process
role topologies — the deployment shape the reference exercises with
``mpirun -np N`` on one machine (reference README.md:28-31,57-61), with
the asynchronous one-sided PS semantics XLA collectives can't express
(SURVEY.md section 7 "hard parts").

Zero-copy discipline: sends pass the numpy buffer's raw pointer to C and
the Handle holds the array reference until completion; receives land
directly in the caller's buffer.  Completed native handles are freed
test-once style (like MPI requests); the Python Handle caches completion
so repeated ``test`` stays idempotent.
"""

from __future__ import annotations

import atexit
from typing import Any

import numpy as np

from mpit_tpu_torch.comm.native.build import load as _load_lib
from mpit_tpu_torch.comm.transport import Handle, Transport
from mpit_tpu_torch.obs import metrics as _obs


class ShmTransport(Transport):
    def __init__(
        self,
        namespace: str,
        rank: int,
        nranks: int,
        ring_bytes: int = 64 << 20,
    ):
        self.lib = _load_lib()
        self.rank = rank
        self.nranks = nranks
        self.namespace = namespace
        self._ctx = self.lib.mt_init(namespace, rank, nranks, ring_bytes)
        if not self._ctx:
            raise RuntimeError(
                f"mt_init failed for namespace={namespace!r} rank={rank}"
            )
        self._closed = False
        # Per-peer traffic counters (obs/metrics): rank-indexed lists,
        # null singletons when obs is disabled (no-op on the hot path).
        _reg = _obs.get_registry()
        self._m_tx_msgs = [_reg.counter("mpit_shm_tx_messages_total",
                                        rank=rank, peer=r)
                           for r in range(nranks)]
        self._m_tx_bytes = [_reg.counter("mpit_shm_tx_bytes_total",
                                         rank=rank, peer=r)
                            for r in range(nranks)]
        self._m_rx_msgs = [_reg.counter("mpit_shm_rx_messages_total",
                                        rank=rank, peer=r)
                           for r in range(nranks)]
        self._m_rx_bytes = [_reg.counter("mpit_shm_rx_bytes_total",
                                         rank=rank, peer=r)
                            for r in range(nranks)]
        atexit.register(self.close)

    # -- Transport ----------------------------------------------------------

    def isend(self, data: Any, dst: int, tag: int) -> Handle:
        buf = self._sendable(data)
        nbytes = buf.nbytes if isinstance(buf, np.ndarray) else len(buf)
        native = self.lib.mt_isend(self._ctx, dst, tag, buf, nbytes)
        if native < 0:
            raise ValueError(f"isend to invalid rank {dst}")
        self._m_tx_msgs[dst].inc()
        self._m_tx_bytes[dst].inc(nbytes)
        return Handle(kind="send", peer=dst, tag=tag, buf=buf, native_id=native)

    def irecv(self, src: int, tag: int, out: Any | None = None) -> Handle:
        if out is None:
            size = self.lib.mt_probe_size(self._ctx, src, tag)
            if size < 0:
                raise RuntimeError(
                    "irecv without a buffer requires a probed message "
                    "(call iprobe first — the reference does the same, "
                    "init.lua:67-102)"
                )
            out_arr = np.empty(int(size), dtype=np.uint8)
            handle = self._post_recv(src, tag, out_arr)
            handle.meta["as_bytes"] = True
            return handle
        return self._post_recv(src, tag, out)

    def _post_recv(self, src: int, tag: int, out: Any) -> Handle:
        if isinstance(out, np.ndarray):
            if not out.flags["WRITEABLE"]:
                raise ValueError("recv buffer must be writable")
            nbytes = out.nbytes
        else:
            view = memoryview(out)
            if view.readonly:
                raise ValueError("recv buffer must be writable")
            nbytes = view.nbytes
        native = self.lib.mt_irecv(self._ctx, src, tag, out, nbytes)
        if native < 0:
            raise ValueError(f"irecv from invalid rank {src}")
        return Handle(kind="recv", peer=src, tag=tag, out=out, native_id=native)

    def iprobe(self, src: int, tag: int) -> bool:
        return bool(self.lib.mt_iprobe(self._ctx, src, tag))

    def test(self, handle: Handle) -> bool:
        if handle.done or handle.cancelled:
            return handle.done
        code = self.lib.mt_test(self._ctx, handle.native_id)
        if code == 0:
            return False
        if code == 1:
            handle.done = True
            if handle.kind == "recv" and handle.meta.get("as_bytes"):
                handle.payload = handle.out.tobytes()
                handle.out = None
            if handle.kind == "recv":
                out = handle.out if handle.out is not None else handle.payload
                self._m_rx_msgs[handle.peer].inc()
                # memoryview(out) also takes a 0-byte array, whose truth
                # value newer numpy refuses (the collectives' barrier
                # receives into one).
                self._m_rx_bytes[handle.peer].inc(memoryview(out).nbytes)
            if handle.kind == "send":
                handle.buf = None  # release ownership back to the caller
            self.lib.mt_release(self._ctx, handle.native_id)
            return True
        if code == -2:
            size = self.lib.mt_recv_size(self._ctx, handle.native_id)
            # Terminal: release the native op and poison the handle so the
            # error raises exactly once and nothing leaks.
            self.lib.mt_cancel(self._ctx, handle.native_id)
            handle.cancelled = True
            raise ValueError(
                f"recv size mismatch: message {size}B does not fit buffer "
                f"(src={handle.peer}, tag={handle.tag})"
            )
        handle.cancelled = True
        raise RuntimeError(f"native test error {code} on {handle}")

    def cancel(self, handle: Handle) -> None:
        if not handle.done:
            self.lib.mt_cancel(self._ctx, handle.native_id)
        handle.cancelled = True
        handle.buf = None

    def close(self) -> None:
        if not self._closed and self._ctx:
            self.lib.mt_finalize(self._ctx)
            self._closed = True

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _sendable(data: Any):
        """Keepalive-friendly buffer form: ndarray stays as-is (raw pointer
        + held reference), everything else becomes bytes.  Non-contiguous
        arrays are rejected rather than silently copied — same fail-loud
        zero-copy rule as :func:`mpit_tpu_torch.comm.transport.as_bytes_view`."""
        if data is None:
            return b""
        if isinstance(data, np.ndarray):
            if not data.flags["C_CONTIGUOUS"]:
                raise ValueError(
                    "send buffer must be C-contiguous (zero-copy rule: a "
                    "hidden copy would break buffer-liveness semantics)"
                )
            return data
        if isinstance(data, (bytes, bytearray)):
            return bytes(data)
        if isinstance(data, memoryview):
            return data.tobytes()
        return np.ascontiguousarray(np.asarray(data))

    @staticmethod
    def wtime() -> float:
        return _load_lib().mt_time()
