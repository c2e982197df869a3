"""The port's native shm transport (``mpit_tpu_torch.comm.shm``) under the
contract cases of ``tests/test_native_transport.py``: in-process endpoint
pairs, the chunking path, cancel and probe, and a real cross-process echo.
Beside them: a port endpoint and a JAX endpoint in one namespace (the
segment names and ring layout are the same bytes), both libraries at API
stamp 17001, the port's library built from a source identical to the JAX
package's, and the codec's native frames equal to its numpy frames.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from mpit_tpu.comm import codec as jax_codec
from mpit_tpu.comm.shm import ShmTransport as JaxShmTransport
from mpit_tpu_torch.comm import codec as port_codec
from mpit_tpu_torch.comm.native import build
from mpit_tpu_torch.comm.shm import ShmTransport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pair(ns, ring_bytes=1 << 20):
    return (
        ShmTransport(ns, 0, 2, ring_bytes=ring_bytes),
        ShmTransport(ns, 1, 2, ring_bytes=ring_bytes),
    )


class TestShmTransport:
    def test_roundtrip_array(self):
        a, b = pair(f"tt_rt_{os.getpid()}")
        try:
            data = np.arange(32, dtype=np.float32)
            a.send(data, 1, 3)
            out = np.zeros_like(data)
            b.recv(0, 3, out=out)
            np.testing.assert_array_equal(out, data)
        finally:
            a.close()
            b.close()

    def test_payload_without_buffer(self):
        a, b = pair(f"tt_nb_{os.getpid()}")
        try:
            a.send(b"hello-wire", 1, 9)
            while not b.iprobe(0, 9):
                pass
            assert b.recv(0, 9) == b"hello-wire"
        finally:
            a.close()
            b.close()

    def test_chunked_larger_than_ring(self):
        """5 MB message through a 1 MB ring: chunks stream as the receiver
        drains — the path 640 MB reference payloads rely on (ptest.lua:3)."""
        a, b = pair(f"tt_ch_{os.getpid()}")
        try:
            big = np.random.default_rng(0).standard_normal(5 * 1024 * 128)
            hs = a.isend(big, 1, 4)
            out = np.zeros_like(big)
            hr = b.irecv(0, 4, out=out)
            spins = 0
            # Poll BOTH sides each round: the sender can only finish as the
            # receiver drains the ring (message is 5x the ring size).
            while True:
                send_done = a.test(hs)
                recv_done = b.test(hr)
                if send_done and recv_done:
                    break
                spins += 1
                assert spins < 10**6
            np.testing.assert_array_equal(out, big)
        finally:
            a.close()
            b.close()

    def test_zero_byte_header_ack(self):
        a, b = pair(f"tt_zb_{os.getpid()}")
        try:
            a.send(b"", 1, 5)
            assert b.iprobe(0, 5)
            assert b.recv(0, 5) == b""
        finally:
            a.close()
            b.close()

    def test_size_mismatch_raises(self):
        a, b = pair(f"tt_sm_{os.getpid()}")
        try:
            a.send(np.ones(4, np.float32), 1, 6)
            while not b.iprobe(0, 6):
                pass
            handle = b.irecv(0, 6, out=np.zeros(3, np.float32))
            with pytest.raises(ValueError, match="size mismatch"):
                while not b.test(handle):
                    pass
        finally:
            a.close()
            b.close()

    def test_tag_isolation(self):
        a, b = pair(f"tt_ti_{os.getpid()}")
        try:
            a.send(np.full(2, 1.0, np.float32), 1, 11)
            a.send(np.full(2, 2.0, np.float32), 1, 12)
            out12 = np.zeros(2, np.float32)
            b.recv(0, 12, out=out12)  # later tag first: no head-of-line block
            out11 = np.zeros(2, np.float32)
            b.recv(0, 11, out=out11)
            assert out12[0] == 2.0 and out11[0] == 1.0
        finally:
            a.close()
            b.close()

    def test_fifo_per_channel(self):
        a, b = pair(f"tt_ff_{os.getpid()}")
        try:
            for i in range(5):
                a.send(np.full(1, float(i), np.float32), 1, 7)
            got = []
            for _ in range(5):
                out = np.zeros(1, np.float32)
                b.recv(0, 7, out=out)
                got.append(float(out[0]))
            assert got == [0.0, 1.0, 2.0, 3.0, 4.0]
        finally:
            a.close()
            b.close()

    def test_cancel_releases(self):
        a, b = pair(f"tt_cx_{os.getpid()}")
        try:
            handle = b.irecv(0, 99, out=np.zeros(1, np.float32))
            b.cancel(handle)
            assert handle.cancelled and not b.test(handle)
        finally:
            a.close()
            b.close()

    def test_wtime_monotonic(self):
        t0 = ShmTransport.wtime()
        t1 = ShmTransport.wtime()
        assert t1 >= t0


class TestShmCancelAndProbe:
    """Focused coverage for ShmTransport.cancel/iprobe (comm/shm.py) —
    the shutdown path (reference init.lua:50-58) and the probe-then-recv
    rendezvous the aio schedulers rely on."""

    def test_iprobe_lifecycle(self):
        """False before arrival, true once assembled, false after the
        matching recv drains it."""
        a, b = pair(f"tt_ip_{os.getpid()}")
        try:
            assert not b.iprobe(0, 31)
            a.send(np.ones(4, np.float32), 1, 31)
            while not b.iprobe(0, 31):
                pass
            assert b.iprobe(0, 31)  # idempotent: probing consumes nothing
            out = np.zeros(4, np.float32)
            b.recv(0, 31, out=out)
            assert not b.iprobe(0, 31)
        finally:
            a.close()
            b.close()

    def test_iprobe_is_src_and_tag_selective(self):
        a, b = pair(f"tt_is_{os.getpid()}")
        try:
            a.send(b"x", 1, 41)
            while not b.iprobe(0, 41):
                pass
            assert not b.iprobe(0, 42)  # different tag
            assert not a.iprobe(1, 41)  # different endpoint/direction
        finally:
            a.close()
            b.close()

    def test_cancelled_recv_leaves_message_for_next_recv(self):
        """cancel releases the native op; the queued message must still
        serve a later correctly-posted receive."""
        a, b = pair(f"tt_cl_{os.getpid()}")
        try:
            pending = b.irecv(0, 51, out=np.zeros(2, np.float32))
            b.cancel(pending)
            a.send(np.asarray([3.0, 4.0], np.float32), 1, 51)
            out = np.zeros(2, np.float32)
            b.recv(0, 51, out=out)
            np.testing.assert_array_equal(out, [3.0, 4.0])
            assert pending.cancelled and not b.test(pending)
        finally:
            a.close()
            b.close()

    def test_cancel_after_completion_keeps_done(self):
        """cancel on a tested-done handle is a no-op for correctness:
        test stays True (idempotent completion caching) and nothing
        double-releases natively."""
        a, b = pair(f"tt_cd_{os.getpid()}")
        try:
            data = np.ones(2, np.float32)
            hs = a.isend(data, 1, 61)
            out = np.zeros(2, np.float32)
            hr = b.irecv(0, 61, out=out)
            while not (a.test(hs) and b.test(hr)):
                pass
            a.cancel(hs)
            b.cancel(hr)
            assert a.test(hs) and b.test(hr)
            np.testing.assert_array_equal(out, data)
        finally:
            a.close()
            b.close()

    def test_cancelled_send_ownership_released(self):
        """cancel drops the transport's buffer reference (the liveness
        contract's release half) and test reports not-done."""
        a, b = pair(f"tt_co_{os.getpid()}")
        try:
            # Clog the 64 KiB ring so the second send stays in flight.
            big = np.ones(1 << 16, np.uint8)
            h1 = a.isend(big, 1, 71)
            h2 = a.isend(np.ones(8, np.float32), 1, 72)
            a.cancel(h2)
            assert h2.cancelled and h2.buf is None
            assert not a.test(h2)
            # The clogged first message still completes once drained.
            out = np.zeros(1 << 16, np.uint8)
            b.recv(0, 71, out=out)
            while not a.test(h1):
                pass
        finally:
            a.close()
            b.close()

    def test_non_contiguous_send_rejected(self):
        """Satellite regression (zero-copy rule): the shm transport must
        refuse a non-contiguous send buffer like as_bytes_view does, not
        silently detach from the caller's memory."""
        a, b = pair(f"tt_nc_{os.getpid()}")
        try:
            with pytest.raises(ValueError, match="C-contiguous"):
                a.isend(np.arange(16, dtype=np.float32)[::2], 1, 81)
        finally:
            a.close()
            b.close()


ECHO_PEER = textwrap.dedent(
    """
    import sys, numpy as np
    sys.path.insert(0, {repo!r})
    from {module} import ShmTransport
    t = ShmTransport({ns!r}, 1, 2)
    out = np.zeros({n}, np.float32)
    t.recv(0, 21, out=out)
    t.send(out * 2.0, 0, 22)
    t.close()
    """
)


def test_zero_byte_recv_into_an_empty_array_is_counted():
    """The collectives' barrier receives 0 bytes into an empty array; the
    received-bytes counter must not ask that array for a truth value,
    which newer numpy refuses (an error here, a warning on older numpy,
    turned into an error)."""
    import warnings

    from mpit_tpu_torch.obs import metrics

    metrics.configure(True, reset=True)
    try:
        a, b = pair(f"tt_z0_{os.getpid()}")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                a.send(np.empty(0, np.uint8), 1, 8)
                b.recv(0, 8, out=np.empty(0, np.uint8))
                b.send(np.ones(3, np.float32), 0, 9)
                a.recv(1, 9, out=np.zeros(3, np.float32))
            snap = metrics.get_registry().snapshot()
        finally:
            a.close()
            b.close()
    finally:
        metrics.configure(None, reset=True)
    text = json.dumps(snap)
    assert "mpit_shm_rx_messages_total" in text and "mpit_shm_rx_bytes_total" in text


class TestMultiProcess:
    @pytest.mark.parametrize("peer_module", ["mpit_tpu_torch.comm.shm",
                                             "mpit_tpu.comm.shm"])
    def test_cross_process_echo(self, peer_module):
        """A port endpoint here, the peer in another process: the port's
        own (JAX-free) peer, then the JAX package's."""
        ns = f"tt_mp_{os.getpid()}_{peer_module.split('.')[0]}"
        n = 4096
        main = ShmTransport(ns, 0, 2)
        try:
            peer = subprocess.Popen(
                [sys.executable, "-c", ECHO_PEER.format(
                    repo=REPO, ns=ns, n=n, module=peer_module)],
                env={**os.environ, "JAX_PLATFORMS": "cpu"},
            )
            data = np.linspace(0, 1, n, dtype=np.float32)
            main.send(data, 1, 21)
            out = np.zeros(n, np.float32)
            main.recv(1, 22, out=out)
            np.testing.assert_array_equal(out, data * 2.0)
            assert peer.wait(60) == 0
        finally:
            main.close()


class TestMixedWithJax:
    def test_port_and_jax_endpoints_share_a_namespace(self):
        """Rank 0 the port's, rank 1 the JAX package's: arrays both ways,
        a message five times the ring, and a bufferless receive."""
        ns = f"tt_mx_{os.getpid()}"
        a = ShmTransport(ns, 0, 2, ring_bytes=1 << 20)
        b = JaxShmTransport(ns, 1, 2, ring_bytes=1 << 20)
        try:
            data = np.arange(64, dtype=np.float32)
            a.send(data, 1, 3)
            out = np.zeros_like(data)
            b.recv(0, 3, out=out)
            np.testing.assert_array_equal(out, data)
            b.send(out + 1.0, 0, 4)
            back = np.zeros_like(data)
            a.recv(1, 4, out=back)
            np.testing.assert_array_equal(back, data + 1.0)
            big = np.random.default_rng(1).standard_normal(5 * 1024 * 128)
            hs = b.isend(big, 0, 5)
            got = np.zeros_like(big)
            hr = a.irecv(1, 5, out=got)
            while not (b.test(hs) & a.test(hr)):
                pass
            np.testing.assert_array_equal(got, big)
            a.send(b"port", 1, 6)
            while not b.iprobe(0, 6):
                pass
            assert b.recv(0, 6) == b"port"
        finally:
            a.close()
            b.close()

    def test_both_libraries_report_api_17001(self):
        from mpit_tpu.comm import shm as jax_shm

        assert build.load().mt_api_version() == 17001
        assert jax_shm._load_lib().mt_api_version() == 17001

    def test_port_library_is_built_from_the_jax_source(self):
        jax_src = pathlib.Path(REPO, "mpit_tpu", "comm", "native", "transport.cpp")
        assert build.SRC.read_bytes() == jax_src.read_bytes()
        jax_specs = pathlib.Path(REPO, "mpit_tpu", "comm", "native", "specs")
        port = {p.name: p.read_bytes() for p in (build.HERE / "specs").glob("*.json")}
        assert port == {p.name: p.read_bytes() for p in jax_specs.glob("*.json")}
        assert "-ffp-contract=off" in build.CXXFLAGS
        assert build.library_path().parent == build.BUILD_DIR


@pytest.mark.parametrize("name", ["bf16", "int8"])
@pytest.mark.parametrize("n", [1, 1023, 5000, 300_001])
def test_native_codec_frames_equal_the_numpy_frames(monkeypatch, name, n):
    """The port's native codec path against its numpy path (the oracle)
    and the JAX package's numpy path, with int8's residual: equal bytes."""
    assert port_codec.native_path() == "native"
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    res0 = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    port = port_codec.get(name)
    nbytes = port.wire_nbytes(n)
    native, r_native = np.zeros(nbytes, np.uint8), res0.copy()
    port.encode_into(x, native, residual=r_native)
    decoded = np.zeros(n, np.float32)
    port.decode_into(native, decoded)
    monkeypatch.setattr(port_codec, "_native_lib", False)
    monkeypatch.setattr(jax_codec, "_native_lib", False)
    assert port_codec.native_path() == "numpy"
    plain, r_plain = np.zeros(nbytes, np.uint8), res0.copy()
    port.encode_into(x, plain, residual=r_plain)
    ref, r_ref = np.zeros(nbytes, np.uint8), res0.copy()
    jax_codec.get(name).encode_into(x, ref, residual=r_ref)
    assert native.tobytes() == plain.tobytes() == ref.tobytes()
    if name == "int8":
        assert r_native.tobytes() == r_plain.tobytes() == r_ref.tobytes()
    want = np.zeros(n, np.float32)
    port.decode_into(native, want)
    assert decoded.tobytes() == want.tobytes()
