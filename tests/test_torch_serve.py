"""The port's serving tier (``mpit_tpu_torch.ps.serve`` and the server's
reader side) against the JAX package's, a twin of ``tests/test_serve.py``.

- The wire: the 32-byte ``[epoch, seq, status, word]`` reply header, the
  cells' 5-word form, and ``ServeConfig`` (its ``MPIT_SERVE_*`` names and
  ``hint_us``) equal the JAX functions' on the same inputs.
- READ-ONLY readers over the port's TCP event loop: N readers of one
  committed version cost the server one snapshot copy; a burst over a
  1-read budget draws BUSY, which every reader honours, and ends bitwise
  equal to an unthrottled run; the posture and the roles are validated as
  the reference validates them.
- Mixed gangs on one JAX router, codec none (a JAX server encoding a
  quantized snapshot starts the JAX package's process-global pool): port
  readers against a JAX server and JAX readers against a port server, in
  lockstep with the writer, read the all-JAX gang's bytes at the same
  versions with the same ``snapshot_copies`` and ``params_served``, and so
  do Adam shards under the port's rule (K3's twin on the CPU) against the
  all-port gang.
- ``launch --serve_readers`` end to end on the CPU, readers holding
  nothing on a device.
- The event loop holds 17 peers on one I/O thread a rank.  The reference's
  test counts every ``_io_loop`` thread of the process, and under xdist a
  test that leaves a transport open in the same worker adds to the count
  (ROADMAP §C); the twin counts its own mesh's threads.  The sever/redial
  torture stays slow, as in the reference.

The tolerance is bitwise throughout: these are host paths.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest

import mpit_tpu.ft as jft
import mpit_tpu.ps as jps
import mpit_tpu.ps.serve as jserve
from mpit_tpu.comm.local import LocalRouter as JaxRouter
from mpit_tpu_torch.comm.tcp import TcpTransport, allocate_local_addresses
from mpit_tpu_torch.ft import FLAG_FRAMED, FLAG_READONLY, FTConfig, init_v3
from mpit_tpu_torch.ps import ParamClient, ParamServer, ReaderClient, ServeConfig, tags
from mpit_tpu_torch.ps import serve as tserve


def _fd_count() -> int:
    return len(os.listdir("/proc/self/fd"))


# ---------------------------------------------------------------------------
# the wire and the config, against the JAX functions


@pytest.mark.parametrize("words", [(0, 1, 0, 7), (3, 9, 2, 2_000), (1, 5, 3, 4),
                                   (-1, 0, 0, 0), (2**40, 2**50, 0, -5)])
def test_serve_header_equals_the_jax_bytes(words):
    got = tserve.serve_reply(*words)
    assert got.tobytes() == jserve.serve_reply(*words).tobytes()
    assert len(got.tobytes()) == tserve.SERVE_HDR_BYTES == jserve.SERVE_HDR_BYTES
    assert tserve.parse_serve_header(got) == jserve.parse_serve_header(got) == words
    assert tserve.serve_head(got) is None and jserve.serve_head(got) is None
    five = np.asarray(list(words) + [words[3] + 2], np.int64)
    assert tserve.parse_serve_header(five) == jserve.parse_serve_header(five)
    assert tserve.serve_head(five) == jserve.serve_head(five) == words[3] + 2
    with pytest.raises(ValueError, match="4 or 5"):
        tserve.parse_serve_header(np.zeros(3, np.int64))


def test_serve_config_equals_the_jax_config(monkeypatch):
    assert ServeConfig() == tserve.ServeConfig.from_env()
    fields = ServeConfig.__dataclass_fields__
    assert {k: getattr(ServeConfig(), k) for k in fields} == \
        {k: getattr(jserve.ServeConfig(), k) for k in fields}
    monkeypatch.setenv("MPIT_SERVE_BUDGET_MB", "4.5")
    monkeypatch.setenv("MPIT_SERVE_BUDGET_READS", "3")
    monkeypatch.setenv("MPIT_SERVE_HINT_FLOOR_US", "1500")
    monkeypatch.setenv("MPIT_SERVE_DRAIN_MBPS", "96.5")
    for overrides in ({}, {"budget_reads": 7}, {"drain_bytes_per_s": 0}):
        got = tserve.ServeConfig.from_env(**overrides)
        want = jserve.ServeConfig.from_env(**overrides)
        assert {k: getattr(got, k) for k in fields} == {k: getattr(want, k) for k in fields}
        for inflight in (0, 1, 4 << 20, 123_456_789):
            assert got.hint_us(inflight) == want.hint_us(inflight)


# ---------------------------------------------------------------------------
# the reader tier over the port's TCP event loop (the reference's tests)


def _serve_gang(nservers, nreaders, *, serve_cfg, server_wrap=None):
    """A servers+writer TCP core (full mesh among them, lazy accepts for the
    rest); returns (addrs, nranks, sranks, wrank, readers, transports,
    servers, server threads)."""
    core = nservers + 1
    nranks = core + nreaders
    addrs, socks = allocate_local_addresses(core)
    addrs = addrs + ["127.0.0.1:0"] * nreaders  # readers never listen
    sranks = list(range(nservers))
    wrank = nservers
    readers = list(range(core, nranks))
    tr = {}

    def build(r):
        tr[r] = TcpTransport(r, nranks, addrs, listener=socks[r], reconnect=30.0,
                             dial_peers=list(range(r)))

    ths = [threading.Thread(target=build, args=(r,)) for r in range(core)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(30)
    assert all(r in tr for r in range(core)), "core mesh construction hung"
    servers = []
    for r in sranks:
        ep = tr[r] if server_wrap is None else server_wrap(r, tr[r])
        servers.append(ParamServer(r, [wrank], ep, rule="add", device="cpu",
                                   reader_ranks=readers, serve=serve_cfg))
    sth = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in sth:
        t.start()
    return addrs, nranks, sranks, wrank, readers, tr, servers, sth


def _run_reader(rank, nranks, addrs, sranks, size, rounds, results, ft=None):
    t = TcpTransport(rank, nranks, addrs, reconnect=30.0, dial_peers=sranks, listen=False)
    try:
        rc = ReaderClient(rank, sranks, t, ft=ft or FTConfig(op_deadline_s=30.0))
        mirror = np.zeros(size, np.float32)
        rc.start(mirror)
        for _ in range(rounds):
            rc.read_params()
        results[rank] = {"mirror": mirror.copy(), "versions": dict(rc.versions),
                         "monotone": rc.monotone, "busy_honored": rc.busy_honored}
        rc.stop()
    finally:
        t.close()


def _readers(readers, *args):
    threads = [threading.Thread(target=_run_reader, args=(r, *args), daemon=True)
               for r in readers]
    for t in threads:
        t.start()
    return threads


class TestReaderTier:
    def test_readers_share_one_snapshot_copy_per_version(self):
        """N readers x R reads of one committed version cost the server
        exactly one device->host copy + one encode, observe a monotone
        version, and decode the exact seeded bytes."""
        size = 4096
        addrs, nranks, sranks, wrank, readers, tr, servers, sth = \
            _serve_gang(2, 4, serve_cfg=ServeConfig(budget_bytes=1 << 30))
        try:
            client = ParamClient(wrank, sranks, tr[wrank], seed_servers=True,
                                 ft=FTConfig(op_deadline_s=30.0))
            param = np.arange(size, dtype=np.float32)
            client.start(param, np.zeros(size, np.float32))
            results = {}
            rth = _readers(readers, nranks, addrs, sranks, size, 3, results)
            for t in rth:
                t.join(60)
                assert not t.is_alive(), "reader hung"
            client.stop()
            for t in sth:
                t.join(30)
                assert not t.is_alive(), "server never stopped"
            for r in readers:
                assert results[r]["monotone"]
                np.testing.assert_array_equal(results[r]["mirror"], param)
            for s in servers:
                assert s.snapshot_copies == 1, s.snapshot_copies
                assert s.params_served >= 12
        finally:
            for s in servers:
                s.live.stop()
            for t in tr.values():
                t.close()

    def test_admission_burst_gets_busy_and_converges(self):
        """A reader burst over a 1-read budget through a delayed-reply
        server: BUSY-with-hint is issued at least once, every reader honours
        it through the backoff loop, and the final mirrors are bitwise the
        unthrottled run's."""
        from mpit_tpu_torch.ft import FaultPlan, FaultyTransport

        size = 2048
        param = np.arange(size, dtype=np.float32) * 0.5

        def run(cfg, wrap):
            addrs, nranks, sranks, wrank, readers, tr, servers, sth = \
                _serve_gang(1, 3, serve_cfg=cfg, server_wrap=wrap)
            try:
                client = ParamClient(wrank, sranks, tr[wrank], seed_servers=True,
                                     ft=FTConfig(op_deadline_s=30.0))
                client.start(param.copy(), np.zeros(size, np.float32))
                results = {}
                rth = _readers(readers, nranks, addrs, sranks, size, 4, results)
                for t in rth:
                    t.join(120)
                    assert not t.is_alive(), "throttled reader hung"
                client.stop()
                for t in sth:
                    t.join(60)
                    assert not t.is_alive(), "server never stopped"
                return results, servers[0].busy_replies
            finally:
                for s in servers:
                    s.live.stop()
                for t in tr.values():
                    t.close()

        def slow(rank, ep):
            return FaultyTransport(ep, FaultPlan(delay_every=1, delay_polls=400,
                                                 tags=frozenset({tags.PARAM})))

        throttled, busy = run(ServeConfig(budget_reads=1, budget_bytes=1 << 30,
                                          hint_floor_us=2000), slow)
        assert busy >= 1, "burst over a 1-read budget never drew a BUSY"
        assert sum(rec["busy_honored"] for rec in throttled.values()) >= 1
        control, busy0 = run(ServeConfig(budget_reads=0, budget_bytes=1 << 30), None)
        assert busy0 == 0
        for rec in throttled.values():
            assert rec["monotone"]
            np.testing.assert_array_equal(rec["mirror"], param)
        for t_rec, c_rec in zip(throttled.values(), control.values()):
            np.testing.assert_array_equal(t_rec["mirror"], c_rec["mirror"])

    def test_reader_posture_is_validated(self):
        server = ParamServer(0, [1], transport=None, device="cpu", reader_ranks=[2])
        with pytest.raises(ValueError, match="FLAG_READONLY"):
            server._negotiate(2, init_v3(0, 16, 0, 0, FLAG_FRAMED).tobytes())
        with pytest.raises(ValueError, match="reader_ranks"):
            server._negotiate(1, init_v3(0, 16, 0, 0, FLAG_FRAMED | FLAG_READONLY).tobytes())
        with pytest.raises(ValueError, match="FLAG_FRAMED"):
            server._negotiate(2, init_v3(0, 16, 0, 0, FLAG_READONLY).tobytes())
        # the real thing: no staging beyond the request header
        codec = server._negotiate(2, init_v3(0, 16, 0, 0,
                                             FLAG_FRAMED | FLAG_READONLY).tobytes())
        server._alloc_client(2, codec)
        assert server._readonly[2] and not server._stale_track[2]
        assert 2 not in server.grad_bufs and server._req_buf[2].shape == (2,)

    def test_reader_requires_deadlines_and_roles_disjoint(self):
        with pytest.raises(ValueError, match="op_deadline_s"):
            ReaderClient(3, [0], transport=None, ft=FTConfig())
        with pytest.raises(ValueError, match="overlap"):
            ParamServer(0, [1, 2], transport=None, device="cpu", reader_ranks=[2])
        with pytest.raises(ValueError, match="layout has 0 shards for 1 servers"):
            ReaderClient(3, [0], transport=None, ft=FTConfig(op_deadline_s=1.0),
                         layout=[])


def test_launch_serve_mode_end_to_end():
    """``launch --serve_readers N`` on the CPU through the process-gang
    launcher: the last N ranks run READ-ONLY readers against the training
    gang (Adam servers) and report monotone versions; a reader is a host
    role."""
    from mpit_tpu_torch.train.launch import LAUNCH_DEFAULTS, launch_processes

    cfg = LAUNCH_DEFAULTS.merged(
        np=5, serve_readers=2, opt="adam", epochs=1, model="linear", side=8,
        batch=64, device="cpu", ft_op_deadline_s=60.0, serve_rounds=4,
        serve_interval_s=0.02, ring_mb=8)
    results = launch_processes(cfg, timeout=300)
    for r in (3, 4):
        assert results[r]["role"] == "reader" and results[r]["platform"] == "cpu"
        assert results[r]["monotone"] is True and results[r]["reads"] == 4
        assert results[r]["lags"] == {"0": 0, "2": 0}
    assert results[1]["role"] == "worker"
    for r in (0, 2):
        assert results[r]["role"] == "server"
        assert results[r]["params_served"] >= 8 and results[r]["grads_applied"] > 0


def test_launch_refuses_reader_splits_the_reference_refuses():
    from mpit_tpu_torch.train.launch import LAUNCH_DEFAULTS, launch_processes

    base = LAUNCH_DEFAULTS.merged(np=5, device="cpu", side=8, ft_op_deadline_s=5.0)
    for flags, match in ((dict(serve_readers=2, ft_op_deadline_s=0.0), "ft_op_deadline_s"),
                         (dict(cells=2), "without --serve_readers"),
                         (dict(serve_readers=1, cells=1), "ft_heartbeat_s"),
                         (dict(serve_readers=4), "role ranks"),
                         (dict(serve_readers=1, tester="last"), "tester"),
                         (dict(serve_readers=1, shardctl=True), "mutually exclusive"),
                         (dict(np=6, serve_readers=1, cells=1, ft_heartbeat_s=0.2),
                          "replica cell")):
        with pytest.raises(ValueError, match=match):
            launch_processes(base.merged(flags))


# ---------------------------------------------------------------------------
# mixed gangs on one JAX router (codec none)


PKG = {
    "torch": dict(server=ParamServer, client=ParamClient, reader=ReaderClient, ft=FTConfig,
                  kw={"device": "cpu"}),
    "jax": dict(server=jps.ParamServer, client=jps.ParamClient, reader=jps.ReaderClient,
                ft=jft.FTConfig, kw={}),
}


def mixed_serve(server_pkg, reader_pkg, rule="add", rounds=4, nreaders=3):
    """2 servers + 1 writer + readers on one JAX router; the writer commits
    a seeded GRAD, then every reader reads, ``rounds`` times, all from this
    thread.  Returns (digests of every read, in order; the versions read;
    the servers' snapshot_copies, params_served and busy replies)."""
    import hashlib

    size = 3000
    router = JaxRouter(3 + nreaders)
    readers = list(range(3, 3 + nreaders))
    S = PKG[server_pkg]
    servers = [S["server"](r, [2], router.endpoint(r), rule=rule, reader_ranks=readers,
                           ft=S["ft"](), **S["kw"]) for r in (0, 1)]
    sth = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in sth:
        t.start()
    rng = np.random.default_rng(17)
    grad = np.zeros(size, np.float32)
    client = S["client"](2, [0, 1], router.endpoint(2), seed_servers=True,
                         ft=S["ft"](op_deadline_s=30.0))
    client.start(rng.standard_normal(size).astype(np.float32), grad)
    R = PKG[reader_pkg]
    rcs = [R["reader"](r, [0, 1], router.endpoint(r), ft=R["ft"](op_deadline_s=30.0))
           for r in readers]
    mirrors = [np.zeros(size, np.float32) for _ in rcs]
    for rc, m in zip(rcs, mirrors):
        rc.start(m)
    digests, versions = [], []
    try:
        for _ in range(rounds):
            grad[:] = rng.standard_normal(size).astype(np.float32) * 0.1
            client.async_send_grad()
            client.wait()
            for rc, m in zip(rcs, mirrors):
                rc.read_params()
                digests.append(hashlib.sha256(m.tobytes()).hexdigest())
                versions.append(dict(rc.read_versions))
            assert all(rc.monotone for rc in rcs)
        for rc in rcs:
            rc.stop()
        client.stop()
        for t in sth:
            t.join(30)
            assert not t.is_alive(), "server did not stop"
    finally:
        for s in servers:
            s.live.stop()
    return digests, versions, [(s.snapshot_copies, s.params_served, s.busy_replies)
                               for s in servers]


@pytest.mark.parametrize("server_pkg,reader_pkg", [("jax", "torch"), ("torch", "jax"),
                                                   ("torch", "torch")])
def test_mixed_reader_gangs_equal_the_jax_gang(server_pkg, reader_pkg):
    want = mixed_serve("jax", "jax")
    got = mixed_serve(server_pkg, reader_pkg)
    assert got == want
    assert [c for c, _s, _b in want[2]] == [4, 4]  # one copy per version read: 4


@pytest.mark.parametrize("reader_pkg", ["jax", "torch"])
def test_readers_of_either_package_read_the_ports_adam_shards(reader_pkg):
    """The port's Adam servers (K3's twin on the CPU) read by JAX readers
    and by port readers: the same bytes at the same versions, one copy per
    version read."""
    assert mixed_serve("torch", reader_pkg, rule="adam") == \
        mixed_serve("torch", "torch", rule="adam")


# ---------------------------------------------------------------------------
# the event-loop transport at many peers


class TestEventLoopScaleOut:
    def _mesh(self, n, reconnect=20.0):
        addrs, socks = allocate_local_addresses(n)
        out = [None] * n

        def build(r):
            out[r] = TcpTransport(r, n, addrs, listener=socks[r], reconnect=reconnect)

        threads = [threading.Thread(target=build, args=(r,)) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert all(o is not None for o in out), "mesh construction hung"
        return out

    def test_thread_count_is_o1_in_peer_count(self):
        """One I/O thread per rank regardless of peer count — the event
        loop replaced per-peer reader/writer pairs (32 threads per rank at
        this mesh size).  Counted over this mesh's own transports: another
        test's transport left open in this process is not this mesh's."""
        mesh = self._mesh(17)
        try:
            ours = set()
            for tr in mesh:
                alive = [t for t in tr._threads if t.is_alive()]
                assert len(alive) == 1, [t.name for t in alive]
                assert alive[0].name.startswith("_io_loop")
                ours.add(alive[0].ident)
            loops = [t for t in threading.enumerate()
                     if t.name.startswith("_io_loop") and t.ident in ours]
            assert len(loops) == len(ours) == 17
        finally:
            for tr in mesh:
                tr.close()

    @pytest.mark.slow
    def test_torture_sever_redial_16_peers_no_fd_leak(self):
        """Interleaved sever/redial across 16 peers: the hub's event loop
        redials every torn link, traffic resumes both ways with no loss, and
        /proc/self/fd stays flat."""
        mesh = self._mesh(17)
        hub = mesh[16]
        payload = np.arange(512, dtype=np.float32)
        try:
            def roundtrip(tag):
                handles = [hub.isend(payload, p, tag) for p in range(16)]
                for p in range(16):
                    out = np.zeros_like(payload)
                    deadline = time.monotonic() + 30
                    h = mesh[p].irecv(16, tag, out=out)
                    while not mesh[p].test(h):
                        assert time.monotonic() < deadline, "delivery hung"
                        time.sleep(0.001)
                    np.testing.assert_array_equal(out, payload)
                    mesh[p].send(np.full(4, p, np.float32), 16, tag)
                for p in range(16):
                    back = np.zeros(4, np.float32)
                    hub.recv(p, tag, out=back)
                    assert back[0] == p
                deadline = time.monotonic() + 30
                for h in handles:
                    while not hub.test(h):
                        assert time.monotonic() < deadline, "ack hung"
                        time.sleep(0.001)

            roundtrip(5)
            time.sleep(0.2)
            fd0 = _fd_count()
            for round_ in range(3):
                for p in range(16):
                    try:
                        hub._peers[p].shutdown(socket.SHUT_RDWR)
                    except (OSError, KeyError, AttributeError):
                        pass
                roundtrip(10 + round_)
            time.sleep(0.5)
            assert abs(_fd_count() - fd0) <= 8
            assert len([t for t in hub._threads if t.is_alive()]) == 1
        finally:
            for tr in mesh:
                tr.close()

    def test_fd_hygiene_across_transport_lifecycle(self):
        """Open/close cycles leak nothing: sockets, selector and wakeup pipe
        all die with the transport."""
        base = _fd_count()
        for _ in range(3):
            for tr in self._mesh(4, reconnect=0.0):
                tr.close()
        time.sleep(0.2)
        assert abs(_fd_count() - base) <= 4, (base, _fd_count())
