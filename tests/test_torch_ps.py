"""The port's parameter server and client over the in-process transport,
mirroring tests/test_ps.py, and mixed gangs with the JAX package's.

Servers run their blocking event loops on threads (the per-rank process
analog) with their shards on the CPU (``device="cpu"``; the default is the
card); clients drive from the test thread.

Wire parity: the port's server and client only call ``Transport``
methods, so they can be handed endpoints of the JAX package's
``LocalRouter``.  A torch client against JAX servers and a JAX client
against torch servers must end with final shards **bitwise equal** to the
all-JAX gang's: the add rule, codec ``none`` and integer-valued float32
grads make every sum exact in any order.  (Only codec ``none`` meets a JAX
server here: a JAX server encoding a quantized snapshot starts the JAX
package's process-global worker pool, which other test files of the
reference do not expect.)
"""

import contextlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.comm.local import LocalRouter as JaxRouter
from mpit_tpu.optim import rules as jax_rules
from mpit_tpu.ps import ParamClient as JaxClient
from mpit_tpu.ps import ParamServer as JaxServer
from mpit_tpu_torch.aio import TaskError
from mpit_tpu_torch.comm.local import LocalRouter
from mpit_tpu_torch.optim import rules
from mpit_tpu_torch.optim.downpour import Downpour
from mpit_tpu_torch.optim.shells import SingleWorker
from mpit_tpu_torch.ps import ParamClient, ParamServer, Shard, shard_layout, tags

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_shard_layout():
    assert shard_layout(12, 3) == [Shard(0, 4), Shard(4, 4), Shard(8, 4)]
    # floor(10/3)=3: [0,3) [3,6) [6,10) (reference pclient.lua:111-129)
    assert shard_layout(10, 3) == [Shard(0, 3), Shard(3, 3), Shard(6, 4)]
    assert shard_layout(7, 1) == [Shard(0, 7)]
    for bad in ((2, 3), (10, 0)):
        with pytest.raises(ValueError):
            shard_layout(*bad)


@contextlib.contextmanager
def launch(nservers, nclients, rule="add", single_mode=False, codec=None,
           server_codec=None):
    """PS topology: servers on ranks [0, nservers) in threads, clients on
    the following ranks, driven by the caller.  Teardown force-stops any
    still-running server."""
    n = nservers + nclients
    router = LocalRouter(n)
    sranks = list(range(nservers))
    cranks = list(range(nservers, n))
    servers = [ParamServer(r, cranks, router.endpoint(r), rule=rule,
                           single_mode=single_mode, device="cpu",
                           codec=server_codec)
               for r in sranks]
    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in threads:
        t.start()
    clients = [ParamClient(r, sranks, router.endpoint(r),
                           seed_servers=(r == cranks[0]), codec=codec)
               for r in cranks]
    try:
        yield servers, clients, threads
    finally:
        for s in servers:
            s.live.stop()
        for t in threads:
            t.join(5)


def join_all(threads, timeout=30):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "server did not stop (stop-protocol hang)"


def _shard(server):
    return server.param.numpy()


class TestPSBasic:
    def test_seed_push_pull_single_shard(self, rng):
        w0 = rng.normal(size=16).astype(np.float32)
        with launch(1, 1) as (servers, (client,), threads):
            param, grad = w0.copy(), np.zeros_like(w0)
            client.start(param, grad)
            grad[:] = 1.0
            client.async_send_grad()
            client.async_recv_param()
            client.wait()
            np.testing.assert_array_equal(param, w0 + np.float32(1.0))
            client.stop()
            join_all(threads)
            assert servers[0].grads_applied == 1
            assert servers[0].params_served == 1
            assert servers[0].param.device.type == "cpu"

    def test_two_servers_shard_correctly(self, rng):
        w0 = rng.normal(size=10).astype(np.float32)  # shards: [0,5) [5,10)
        with launch(2, 1) as (servers, (client,), threads):
            param, grad = w0.copy(), np.zeros_like(w0)
            client.start(param, grad)
            delta = rng.normal(size=10).astype(np.float32)
            grad[:] = delta
            client.async_send_grad()
            client.async_recv_param()
            client.wait()
            np.testing.assert_array_equal(param, w0 + delta)
            np.testing.assert_array_equal(_shard(servers[0]), (w0 + delta)[:5])
            np.testing.assert_array_equal(_shard(servers[1]), (w0 + delta)[5:])
            client.stop()
            join_all(threads)

    def test_two_clients_share_center(self, rng):
        w0 = rng.normal(size=8).astype(np.float32)
        with launch(1, 2) as (servers, (c1, c2), threads):
            p1, g1 = w0.copy(), np.zeros_like(w0)
            p2, g2 = np.zeros_like(w0), np.zeros_like(w0)
            # Clients start concurrently: the server's init phase waits on
            # both, and the seeder's start() blocks on the seed ack.
            t1 = threading.Thread(target=c1.start, args=(p1, g1), daemon=True)
            t2 = threading.Thread(target=c2.start, args=(p2, g2), daemon=True)
            t1.start()
            t2.start()
            t1.join(30)
            t2.join(30)
            assert not t1.is_alive() and not t2.is_alive(), "client start hung"
            c2.async_recv_param()
            c2.wait()
            np.testing.assert_array_equal(p2, w0)
            g1[:] = 1.0
            c1.async_send_grad()
            c1.wait()
            g2[:] = 2.0
            c2.async_send_grad()
            c2.wait()
            c1.async_recv_param()
            c1.wait()
            np.testing.assert_allclose(p1, w0 + 3.0, rtol=1e-6)
            c1.stop()
            c2.stop()
            join_all(threads)

    def test_server_side_adam(self, rng):
        """Clients ship raw grads; servers apply Adam — the result must
        match a local rollout of the port's rule (bit for bit: same ops)
        and of the JAX package's (rtol 1e-5, its own tolerance)."""
        w0 = rng.normal(size=12).astype(np.float32)
        grads = [rng.normal(size=12).astype(np.float32) for _ in range(3)]
        hp = dict(lr=1e-2, beta1=0.9, beta2=0.999, epsilon=1e-8)
        with launch(2, 1, rule=rules.make("adam", **hp)) as (servers, (client,), threads):
            param, grad = w0.copy(), np.zeros_like(w0)
            client.start(param, grad)
            for g in grads:
                grad[:] = g
                client.async_send_grad()
                client.wait()
            client.async_recv_param()
            client.wait()
            client.stop()
            join_all(threads)
        for lo, hi in ((0, 6), (6, 12)):  # each server's own rule state
            rule = rules.make("adam", **hp)
            p = torch.from_numpy(w0[lo:hi].copy())
            st = rule.init(p)
            for g in grads:
                rule.apply(p, torch.from_numpy(g[lo:hi]), st)
            np.testing.assert_array_equal(param[lo:hi], p.numpy())
        jrule = jax_rules.make("adam", **hp)
        jp = jnp.asarray(w0)
        jst = jrule.init(jp)
        for g in grads:
            jp, jst = jrule.apply(jp, jnp.asarray(g), jst)
        np.testing.assert_allclose(param, np.asarray(jp), rtol=1e-5)

    def test_reset_retargets_buffers(self, rng):
        w0 = rng.normal(size=6).astype(np.float32)
        with launch(1, 1) as (servers, (client,), threads):
            param, grad = w0.copy(), np.zeros_like(w0)
            client.start(param, grad)
            alt_param = np.zeros_like(w0)
            alt_grad = np.full_like(w0, 0.5)
            client.reset(alt_param, alt_grad)
            client.async_send_grad()
            client.async_recv_param()
            client.wait()
            np.testing.assert_array_equal(alt_param, w0 + np.float32(0.5))
            np.testing.assert_array_equal(param, w0)  # original untouched
            with pytest.raises(ValueError):
                client.reset(np.zeros(7, np.float32), np.zeros(7, np.float32))
            client.stop()
            join_all(threads)

    def test_snapshot_is_an_owned_copy_cached_per_version(self, rng):
        """N pulls of one committed version = one device->host copy + one
        encode; an in-place apply makes a new version and never rewrites
        the frame already served."""
        w0 = rng.normal(size=256).astype(np.float32)
        with launch(1, 1, codec="int8") as (servers, (client,), threads):
            param, grad = w0.copy(), np.zeros_like(w0)
            client.start(param, grad)
            for _ in range(3):
                client.async_recv_param()
                client.wait()
            s = servers[0]
            assert (s.snapshot_copies, s.snapshot_hits) == (1, 2)
            served_host = s._snap_host[1]
            served_wire = s._snap_wire["int8"][1]
            host_before, wire_before = served_host.copy(), served_wire.copy()
            grad[:] = 1.0
            client.async_send_grad()
            client.async_recv_param()
            client.wait()
            assert s.snapshot_copies == 2
            np.testing.assert_array_equal(served_host, host_before)
            np.testing.assert_array_equal(served_wire, wire_before)
            client.stop()
            join_all(threads)


class TestPSWithOptimizers:
    def test_downpour_su1_end_to_end(self, rng):
        """Full stack: Downpour -> ParamClient -> LocalTransport ->
        ParamServer(plain add) matches serial SGD."""
        w0 = rng.normal(size=8).astype(np.float32)
        lr, steps = 0.1, 5

        def vgf(w, target):
            return 0.5 * torch.sum((w - target) ** 2), w - target

        with launch(2, 1) as (servers, (client,), threads):
            opt = Downpour(vgf, client, lr=lr, su=1)
            w = opt.start(torch.from_numpy(w0.copy()))
            held = w
            for _ in range(steps):
                w, _ = opt.step(w, torch.zeros(8))
            opt.stop()
            join_all(threads)
        # The fetched mirror was copied into the worker's own tensor.
        assert w is held and not np.shares_memory(w.numpy(), opt.w_host)
        ref = w0.astype(np.float64)
        for _ in range(steps):
            ref = ref - lr * ref
        np.testing.assert_allclose(w.numpy(), ref, rtol=1e-4)

    @pytest.mark.parametrize("codec", ["none", "bf16"])
    def test_single_worker_mirror(self, rng, codec):
        """SingleWorker pushes whole params; a single_mode server mirrors
        them (exactly under none, to bf16's truncation under bf16)."""
        w0 = rng.normal(size=6).astype(np.float32)

        def vgf(w, target):
            return 0.5 * torch.sum((w - target) ** 2), w - target

        with launch(1, 1, single_mode=True, codec=codec) as (servers, (client,), threads):
            opt = SingleWorker(vgf, client, rule="adagrad", lr=0.1)
            w = opt.start(torch.from_numpy(w0.copy()))
            for _ in range(3):
                w, _ = opt.step(w, torch.zeros(6))
            opt.stop()
            join_all(threads)
            if codec == "none":
                np.testing.assert_array_equal(_shard(servers[0]), w.numpy())
            else:
                np.testing.assert_allclose(_shard(servers[0]), w.numpy(), rtol=2.0**-7)


class TestWireCodecs:
    @pytest.mark.parametrize("codec,tol", [("bf16", 2.0**-7), ("int8", 1 / 64)])
    def test_seed_push_pull_quantized(self, rng, codec, tol):
        w0 = rng.normal(size=3000).astype(np.float32)
        with launch(2, 1, codec=codec) as (servers, (client,), threads):
            param, grad = w0.copy(), np.zeros_like(w0)
            client.start(param, grad)
            grad[:] = 1.0
            client.async_send_grad()
            client.async_recv_param()
            client.wait()
            scale = np.abs(w0).max() + 1.0
            # seed + grad + snapshot each quantize once
            np.testing.assert_allclose(param, w0 + 1.0, atol=4 * tol * scale)
            client.stop()
            join_all(threads)
            assert all(s._codecs[2].name == codec for s in servers)

    def test_legacy_16_byte_init_interops_as_none(self, rng):
        """A v1 peer announcing [offset, size] must be served with the
        identity codec — the mixed-version deployment case."""
        w0 = rng.normal(size=16).astype(np.float32)
        router = LocalRouter(2)
        server = ParamServer(0, [1], router.endpoint(0), device="cpu")
        t = threading.Thread(target=server.start, daemon=True)
        t.start()
        try:
            wire = router.endpoint(1)
            wire.send(np.asarray([0, 16], dtype=np.int64), 0, tags.INIT)
            wire.send(w0, 0, tags.PARAM_PUSH)
            wire.recv(0, tags.PARAM_PUSH_ACK)
            wire.send(np.full(16, 2.0, np.float32), 0, tags.GRAD)
            wire.recv(0, tags.GRAD_ACK)
            wire.send(tags.EMPTY, 0, tags.PARAM_REQ)
            out = np.zeros(16, np.float32)
            while not wire.iprobe(0, tags.PARAM):
                pass
            wire.recv(0, tags.PARAM, out=out)
            np.testing.assert_array_equal(out, w0 + np.float32(2.0))
            assert server._codecs[1].name == "none"
            wire.send(tags.EMPTY, 0, tags.STOP)
            join_all([t])
        finally:
            server.live.stop()

    def _failing_server(self, announce, **kw):
        """A server whose INIT phase receives ``announce``; returns the
        TaskError its start() raised."""
        router = LocalRouter(2)
        server = ParamServer(0, [1], router.endpoint(0), device="cpu", **kw)
        failure = []

        def run_server():
            try:
                server.start()
            except TaskError as exc:
                failure.append(exc)

        t = threading.Thread(target=run_server, daemon=True)
        t.start()
        announce(router.endpoint(1))
        t.join(10)
        assert not t.is_alive(), "server neither failed nor stopped"
        assert failure, "server accepted the announcement"
        return failure[0].cause

    def test_codec_mismatch_fails_loudly(self, rng):
        w0 = rng.normal(size=8).astype(np.float32)

        def announce(endpoint):
            client = ParamClient(1, [0], endpoint, codec="int8")
            client.start(w0.copy(), np.zeros_like(w0))  # INIT only (no seeding)

        cause = self._failing_server(announce, codec="bf16")
        assert "codec negotiation mismatch" in str(cause)

    @pytest.mark.parametrize("words,message", [
        ([0, 8, 99], "unknown codec wire id"),
        ([0, 8, 0, 0], "INIT announcement"),
    ])
    def test_bad_announcement_fails_loudly(self, words, message):
        cause = self._failing_server(lambda ep: ep.send(
            np.asarray(words, dtype=np.int64), 0, tags.INIT))
        assert isinstance(cause, ValueError) and message in str(cause)

    @pytest.mark.parametrize("version,words,exc,message", [
        # v3 with FLAG_CHUNKED (streaming)
        pytest.param(3, [0, 8, 0, 1, 1 | 8 | 64], NotImplementedError, "INIT v3",
                     id="3-words0"),
        # shard control landed: a whole map, but unframed, is refused
        pytest.param(4, [-1, 0, 0, 4, 0x534D4150, 0, 8, 1, 0, 0, 8, 0],
                     ValueError, "FLAG_FRAMED", id="4-words1"),
        # v3 + [chunk_elems]
        pytest.param(5, [0, 8, 0, 1, 1 | 32, 1024], NotImplementedError, "INIT v5",
                     id="5-words2"),
    ])
    def test_later_init_versions_are_refused(self, version, words, exc, message):
        cause = self._failing_server(lambda ep: ep.send(
            np.asarray(words, dtype=np.int64), 0, tags.INIT))
        assert isinstance(cause, exc) and message in str(cause)
        if exc is NotImplementedError:
            assert "slice 5" in str(cause)


@pytest.mark.parametrize("cls,kw,refused", [
    # shard control and elastic membership landed: accepted now
    pytest.param(ParamServer, {"preempt": object()}, False, id="ParamServer-kw0"),
    pytest.param(ParamServer, {"admit_ranks": [3]}, False, id="ParamServer-kw1"),
    # the serving tier and cells landed: accepted now
    pytest.param(ParamServer, {"reader_ranks": [3]}, False, id="ParamServer-kw2"),
    pytest.param(ParamServer, {"cell_ranks": [3]}, False, id="ParamServer-kw3"),
    pytest.param(ParamServer, {"dplane": object()}, True, id="ParamServer-kw4"),
    pytest.param(ParamServer, {"shardctl": True}, False, id="ParamServer-kw5"),
    pytest.param(ParamClient, {"controller_rank": 0}, False, id="ParamClient-kw6"),
    pytest.param(ParamClient, {"shardctl": True, "ft_deadline": 1.0}, False,
                 id="ParamClient-kw7"),
    pytest.param(ParamClient, {"layout": []}, True, id="ParamClient-kw8"),
])
def test_later_slice_arguments_are_refused(cls, kw, refused):
    """Arguments of slices still to come raise NotImplementedError naming
    the slice; shard control's, elastic membership's, the serving tier's and
    the cells' are accepted (a shardctl client with op deadlines); an
    argument neither package has is a TypeError."""
    from mpit_tpu_torch.ft import FTConfig

    router = LocalRouter(2)
    args = (0, [1], router.endpoint(0)) if cls is ParamServer else (1, [0], router.endpoint(1))
    kw = dict(kw, device="cpu") if cls is ParamServer else dict(kw)
    if "ft_deadline" in kw:
        kw["ft"] = FTConfig(op_deadline_s=kw.pop("ft_deadline"))
    if refused:
        with pytest.raises(NotImplementedError, match="slice"):
            cls(*args, **kw)
    else:
        cls(*args, **kw)
    with pytest.raises(TypeError):
        cls(*args, no_such_argument=1)


# -- mixed gangs on one JAX router ----------------------------------------------


def _gang(server_kind, client_kind, w0, rounds):
    """2 servers (ranks 0, 1) and 2 clients (ranks 2, 3) on one JAX
    LocalRouter; each client pushes integer-valued grads and pulls.
    Returns the final shards."""
    router = JaxRouter(4)
    sranks, cranks = [0, 1], [2, 3]
    if server_kind == "jax":
        servers = [JaxServer(r, cranks, router.endpoint(r)) for r in sranks]
    else:
        servers = [ParamServer(r, cranks, router.endpoint(r), device="cpu")
                   for r in sranks]
    client_cls = JaxClient if client_kind == "jax" else ParamClient
    clients = [client_cls(r, sranks, router.endpoint(r), seed_servers=(r == 2),
                          codec="none") for r in cranks]
    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    errors = []

    def drive(i, client):
        try:
            param, grad = (w0.copy() if i == 0 else np.zeros_like(w0)), np.zeros_like(w0)
            client.start(param, grad)
            for g in rounds[i]:
                grad[:] = g
                client.async_send_grad()
                client.async_recv_param()
                client.wait()
            client.stop()
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads += [threading.Thread(target=drive, args=(i, c), daemon=True)
                for i, c in enumerate(clients)]
    try:
        for t in threads:
            t.start()
        join_all(threads)
    finally:
        for s in servers:
            s.live.stop()
    assert not errors, errors
    return [np.asarray(s.param).copy() if server_kind == "jax" else s.param.numpy()
            for s in servers]


def test_mixed_gangs_end_bitwise_equal_to_the_jax_gang(rng):
    n = 1031
    w0 = rng.integers(-50, 50, size=n).astype(np.float32)
    rounds = [[rng.integers(-8, 8, size=n).astype(np.float32) for _ in range(4)]
              for _ in range(2)]
    want = _gang("jax", "jax", w0, rounds)
    np.testing.assert_array_equal(np.concatenate(want), w0 + sum(sum(r) for r in rounds))
    for server_kind, client_kind in (("jax", "torch"), ("torch", "jax"),
                                     ("torch", "torch")):
        got = _gang(server_kind, client_kind, w0, rounds)
        for a, b in zip(got, want):
            assert a.tobytes() == b.tobytes(), (server_kind, client_kind)


def test_server_holds_its_shard_on_the_card_by_default():
    endpoint = LocalRouter(2).endpoint(0)
    if torch.cuda.is_available():
        assert ParamServer(0, [1], endpoint).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ParamServer(0, [1], endpoint)
