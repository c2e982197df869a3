"""The port's host collectives (``mpit_tpu_torch.comm.collectives``) under
the cases of ``tests/test_collectives.py``: each rank on its own thread
over in-process endpoints (np=5 covers non-power-of-two tree/ring shapes),
one leg over real TCP sockets; then one allreduce whose ranks alternate
between the port's and the JAX package's collectives over one shm
namespace, bitwise equal to the all-JAX allreduce of the same inputs.
"""

import os
import threading

import numpy as np
import pytest

from mpit_tpu_torch.comm.collectives import HostCollectives
from mpit_tpu_torch.comm.local import LocalRouter

N = 5  # odd, >4: exercises uneven ring chunks and ragged binomial trees


def run_ranks(n, fn):
    """fn(collectives, rank) on one thread per rank; returns results."""
    router = LocalRouter(n)
    out = [None] * n
    errs = [None] * n

    def body(r):
        try:
            out[r] = fn(HostCollectives(router.endpoint(r)), r)
        except BaseException as e:  # surfaced below
            errs[r] = e

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive(), "collective hung"
    for e in errs:
        if e is not None:
            raise e
    return out


class TestHostCollectives:
    @pytest.mark.parametrize("size", [7, 4096])  # small: tree; large: ring
    def test_allreduce_sum(self, rng, size):
        inputs = [rng.normal(size=size).astype(np.float32) for _ in range(N)]
        want = np.sum(np.stack(inputs), axis=0)

        def body(coll, r):
            arr = inputs[r].copy()
            coll.allreduce(arr)
            return arr

        for arr in run_ranks(N, body):
            np.testing.assert_allclose(arr, want, rtol=1e-4, atol=1e-5)

    def test_allreduce_max(self, rng):
        inputs = [rng.normal(size=300).astype(np.float32) for _ in range(N)]
        want = np.max(np.stack(inputs), axis=0)
        out = run_ranks(N, lambda c, r: c.allreduce(inputs[r].copy(), op="max"))
        for arr in out:
            np.testing.assert_array_equal(arr, want)

    @pytest.mark.parametrize("root", [0, 3])
    def test_bcast(self, rng, root):
        seed = rng.normal(size=513).astype(np.float32)

        def body(coll, r):
            arr = seed.copy() if r == root else np.zeros(513, np.float32)
            return coll.bcast(arr, root=root)

        for arr in run_ranks(N, body):
            np.testing.assert_array_equal(arr, seed)

    def test_reduce_to_root(self, rng):
        inputs = [rng.normal(size=64).astype(np.float32) for _ in range(N)]
        want = np.sum(np.stack(inputs), axis=0)
        out = run_ranks(N, lambda c, r: (c.reduce(inputs[r].copy()), r)[0])
        np.testing.assert_allclose(out[0], want, rtol=1e-4, atol=1e-5)

    def test_barrier_synchronizes(self):
        """Every rank's pre-barrier write is visible to every rank after
        the barrier, across repeated rounds."""
        arrived = [np.zeros(N, bool) for _ in range(3)]

        def body(coll, r):
            for k in range(3):
                arrived[k][r] = True
                coll.barrier()
                assert arrived[k].all(), f"round {k}: barrier exited early"
            return True

        run_ranks(N, body)

    def test_iallreduce_test_wait(self, rng):
        """Iallreduce analog: test() may poll False mid-flight, wait()
        completes, results match (testireduceall.lua:32-39 shape)."""
        inputs = [rng.normal(size=2048).astype(np.float32) for _ in range(N)]
        want = np.sum(np.stack(inputs), axis=0)

        def body(coll, r):
            arr = inputs[r].copy()
            h = coll.allreduce_async(arr)
            h.test()  # legal mid-flight
            h.wait(60)
            assert h.test() is True
            return arr

        for arr in run_ranks(N, body):
            np.testing.assert_allclose(arr, want, rtol=1e-4, atol=1e-5)

    def test_back_to_back_no_crosstalk(self, rng):
        """Consecutive collectives use fresh tag rounds: a sum right
        after a max must not mix messages."""

        def body(coll, r):
            a = np.full(100, float(r), np.float32)
            b = np.full(100, float(r), np.float32)
            coll.allreduce(a, op="max")
            coll.allreduce(b, op="sum")
            return a[0], b[0]

        for mx, sm in run_ranks(N, body):
            assert mx == N - 1 and sm == sum(range(N))

    @pytest.mark.parametrize("block", [3, 512])
    def test_allgather(self, rng, block):
        inputs = [rng.normal(size=block).astype(np.float32) for _ in range(N)]
        want = np.concatenate(inputs)

        def body(coll, r):
            recv = np.empty(N * block, np.float32)
            coll.allgather(inputs[r].copy(), recv)
            return recv

        for recv in run_ranks(N, body):
            np.testing.assert_allclose(recv, want)

    @pytest.mark.parametrize("block", [3, 512])
    def test_reduce_scatter(self, rng, block):
        inputs = [rng.normal(size=N * block).astype(np.float32)
                  for _ in range(N)]
        want = np.sum(np.stack(inputs), axis=0)

        def body(coll, r):
            out = np.empty(block, np.float32)
            coll.reduce_scatter(inputs[r].copy(), out)
            return out

        for r, out in enumerate(run_ranks(N, body)):
            np.testing.assert_allclose(
                out, want[r * block:(r + 1) * block], rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("root", [0, 2])
    def test_scatter_gather_roundtrip(self, rng, root):
        src = rng.normal(size=N * 16).astype(np.float32)

        def body(coll, r):
            out = np.empty(16, np.float32)
            coll.scatter(src.copy() if r == root else None, out, root=root)
            back = (np.empty(N * 16, np.float32) if r == root else None)
            coll.gather(out * 2.0, back, root=root)
            return out, back

        results = run_ranks(N, body)
        for r, (out, _) in enumerate(results):
            np.testing.assert_allclose(out, src[r * 16:(r + 1) * 16])
        np.testing.assert_allclose(results[root][1], src * 2.0)

    def test_scan_inclusive_prefix(self, rng):
        inputs = [rng.normal(size=64).astype(np.float32) for _ in range(N)]

        def body(coll, r):
            arr = inputs[r].copy()
            coll.scan(arr)
            return arr

        for r, arr in enumerate(run_ranks(N, body)):
            want = np.sum(np.stack(inputs[: r + 1]), axis=0)
            np.testing.assert_allclose(arr, want, rtol=1e-4, atol=1e-5)

    def test_block_size_validation(self):
        router = LocalRouter(1)
        coll = HostCollectives(router.endpoint(0))
        with pytest.raises(ValueError, match="n\\*send"):
            coll.allgather(np.zeros(4, np.float32), np.zeros(5, np.float32))
        with pytest.raises(ValueError, match="n\\*out"):
            coll.reduce_scatter(np.zeros(5, np.float32), np.zeros(4, np.float32))

    def test_rejects_noncontiguous(self):
        router = LocalRouter(1)
        coll = HostCollectives(router.endpoint(0))
        with pytest.raises(ValueError, match="contiguous"):
            coll.allreduce(np.zeros((4, 4), np.float32)[:, ::2])

    def test_allreduce_over_tcp(self, rng):
        """Cross-transport parity: the same ring over real sockets."""
        from mpit_tpu_torch.comm.tcp import TcpTransport, allocate_local_addresses

        n = 4
        addrs, socks = allocate_local_addresses(n)
        transports = [None] * n

        def build(r):
            transports[r] = TcpTransport(r, n, addrs, listener=socks[r])

        starts = [threading.Thread(target=build, args=(r,)) for r in range(n)]
        for t in starts:
            t.start()
        for t in starts:
            t.join(30)
        assert all(t is not None for t in transports), "mesh construction hung"
        inputs = [rng.normal(size=1024).astype(np.float32) for _ in range(n)]
        want = np.sum(np.stack(inputs), axis=0)
        out = [None] * n

        def body(r):
            arr = inputs[r].copy()
            HostCollectives(transports[r]).allreduce(arr)
            out[r] = arr

        threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
                assert not t.is_alive()
        finally:
            for tr in transports:
                tr.close()
        for arr in out:
            np.testing.assert_allclose(arr, want, rtol=1e-4, atol=1e-5)


def _threads(n, body):
    errs = []

    def guarded(r):
        try:
            body(r)
        except BaseException as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=guarded, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive(), "collective hung"
    if errs:
        raise errs[0]


@pytest.mark.parametrize("size", [7, 4096])  # small: tree; large: ring
def test_allreduce_across_port_and_jax_ranks(rng, size):
    """Ranks 0 and 2 run the port's collectives over the port's shm
    transport, ranks 1 and 3 the JAX package's over its own, in one
    namespace; every rank ends with the bits of the all-JAX allreduce."""
    from mpit_tpu.comm import HostCollectives as JaxCollectives
    from mpit_tpu.comm.local import LocalRouter as JaxRouter
    from mpit_tpu.comm.shm import ShmTransport as JaxShm
    from mpit_tpu_torch.comm.shm import ShmTransport

    n = 4
    inputs = [rng.normal(size=size).astype(np.float32) for _ in range(n)]
    router = JaxRouter(n)
    want = [x.copy() for x in inputs]
    _threads(n, lambda r: JaxCollectives(router.endpoint(r)).allreduce(want[r]))

    ns = f"tt_coll_{os.getpid()}_{size}"
    transports = [(ShmTransport if r % 2 == 0 else JaxShm)(ns, r, n, ring_bytes=1 << 20)
                  for r in range(n)]
    got = [x.copy() for x in inputs]
    try:
        _threads(n, lambda r: (HostCollectives if r % 2 == 0 else JaxCollectives)(
            transports[r]).allreduce(got[r]))
    finally:
        for t in transports:
            t.close()
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
