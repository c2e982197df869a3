"""The port's fault tolerance against the JAX package's, mirroring
tests/test_ft.py.

- Byte and unit parity: ``ft/wire`` headers and announcements, the
  ``FaultPlan`` decisions, the ``RetryPolicy`` backoffs, the
  ``DedupTable`` and ``LeaseRegistry`` lifecycles and ``FTConfig.from_env``
  equal the JAX package's for the same inputs.
- The scheduler timers, the fault plan and the faulty transport as units.
- End to end over the port's ``LocalRouter`` (servers on threads, shards
  on the CPU): twins of the reference's retry/dedup matrix, heartbeat and
  lease eviction, server checkpoint and restart, and the five-seed
  property test, each bitwise against its fault-free run or loud.
- Checkpoints across the packages, both directions, with the dedup table:
  the restored server admits the retried op as DUP.
- The guards of later slices.

Client-side faults wrap the client's transport (GRAD, PARAM_REQ,
PARAM_PUSH are client sends); ack and snapshot faults wrap the server's
(GRAD_ACK, PARAM, PARAM_PUSH_ACK).  Bitwise assertions rely on lockstep
turns — each client awaits its acks before the next one ships — which pins
the cross-client apply order.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import mpit_tpu.ft as jft
from mpit_tpu.comm.local import LocalRouter as JaxRouter
from mpit_tpu.ps import ParamClient as JaxClient
from mpit_tpu.ps import ParamServer as JaxServer
from mpit_tpu.ps import tags as jtags
from mpit_tpu_torch import ft
from mpit_tpu_torch.aio import (
    DeadlineExceeded,
    LiveFlag,
    Scheduler,
    TaskError,
    aio_recv,
    aio_sleep,
    deadline_at,
)
from mpit_tpu_torch.comm.local import LocalRouter
from mpit_tpu_torch.ft import (
    EVICTED,
    DedupTable,
    FaultPlan,
    FaultyTransport,
    FTConfig,
    LeaseRegistry,
    RetryExhausted,
    RetryPolicy,
)
from mpit_tpu_torch.ps import ParamClient, ParamServer, tags
from mpit_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

#: the retried data channels — INIT (the membership rendezvous) and
#: STOP/HEARTBEAT (covered by leases, not retry) stay clean.
DATA_TAGS = frozenset({tags.GRAD, tags.PARAM_REQ, tags.PARAM_PUSH})
REPLY_TAGS = frozenset({tags.GRAD_ACK, tags.PARAM, tags.PARAM_PUSH_ACK})

#: a fast retry posture for LocalRouter-speed tests
FAST_FT = FTConfig(op_deadline_s=0.25, max_retries=8,
                   backoff_base_s=0.005, backoff_cap_s=0.02)
HB_FT = FTConfig(heartbeat_s=0.02, op_deadline_s=0.5, max_retries=4,
                 backoff_base_s=0.005, backoff_cap_s=0.02)


def join_all(threads, timeout=30):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "role thread did not stop (hang)"


# ---------------------------------------------------------------------------
# byte and unit parity with the JAX package


I64 = st.integers(min_value=-(1 << 62), max_value=(1 << 62))


@settings(max_examples=60, deadline=None)
@given(epoch=I64, seq=I64, version=I64, flags=st.integers(0, 127),
       offset=st.integers(0, 1 << 40), size=st.integers(1, 1 << 40),
       codec_id=st.integers(0, 2), stamp=I64)
def test_wire_bytes_equal_the_jax_package(epoch, seq, version, flags, offset,
                                          size, codec_id, stamp):
    assert ft.header_frame(epoch, seq).tobytes() == \
        jft.header_frame(epoch, seq).tobytes()
    assert ft.init_v3(offset, size, codec_id, epoch, flags).tobytes() == \
        jft.init_v3(offset, size, codec_id, epoch, flags).tobytes()
    assert ft.init_v5(offset, size, codec_id, epoch, flags, 2048).tobytes() == \
        jft.init_v5(offset, size, codec_id, epoch, flags, 2048).tobytes()
    assert ft.timed_frame(epoch, seq, stamp).tobytes() == \
        jft.timed_frame(epoch, seq, stamp).tobytes()
    for stale in (False, True):
        for timing in (False, True):
            assert ft.hdr_bytes(stale, timing) == jft.hdr_bytes(stale, timing)
            assert ft.reply_hdr_bytes(stale, timing) == \
                jft.reply_hdr_bytes(stale, timing)
    ours, theirs = np.zeros(64, np.uint8), np.zeros(64, np.uint8)
    for mod, buf in ((ft, ours), (jft, theirs)):
        mod.pack_header(buf, epoch, seq)
        mod.pack_version(buf, version)
        mod.pack_reply_stamps(buf, 24, stamp, seq, epoch)
    assert ours.tobytes() == theirs.tobytes()
    assert ft.unpack_header(ours) == (epoch, seq)
    assert ft.unpack_version(ours) == version
    assert ft.unpack_reply_stamps(ours, 24) == (stamp, seq, epoch)
    chunk = np.zeros(48, np.uint8), np.zeros(48, np.uint8)
    for mod, buf in zip((ft, jft), chunk):
        mod.pack_chunk_header(buf, epoch, seq, 3, 7)
    assert chunk[0].tobytes() == chunk[1].tobytes()
    assert ft.chunk_spans(size % 100000, 4096) == jft.chunk_spans(size % 100000, 4096)
    assert ft.chunk_elems_for(size % (1 << 24), 4) == \
        jft.chunk_elems_for(size % (1 << 24), 4)


def test_flags_and_sizes_equal_the_jax_package():
    for name in ("FLAG_FRAMED", "FLAG_HEARTBEAT", "FLAG_STALENESS", "FLAG_TIMING",
                 "FLAG_READONLY", "FLAG_SUBSCRIBE", "FLAG_CHUNKED", "HDR_BYTES",
                 "HDR_STALE_BYTES", "CHUNK_HDR_BYTES", "TIMING_TAIL_BYTES"):
        assert getattr(ft, name) == getattr(jft, name), name
    for name in ("INIT", "GRAD", "GRAD_ACK", "PARAM_REQ", "PARAM", "PARAM_PUSH",
                 "PARAM_PUSH_ACK", "STOP", "HEARTBEAT"):
        assert getattr(tags, name) == getattr(jtags, name), name


@pytest.mark.parametrize("spec", [
    "seed=7,drop_every=3,dup_every=5,delay_every=2,delay_polls=4",
    "seed=3,drop_rate=0.3,dup_rate=0.3",
    "seed=11,drop_rate=0.08,dup_rate=0.08,delay_rate=0.15,tags=2+4+6",
    "seed=1,drop_every=1,tags=2",
])
def test_fault_plan_decisions_equal_the_jax_package(spec):
    ours, theirs = FaultPlan.parse(spec), jft.FaultPlan.parse(spec)
    got = [ours.decide(src, dst, tag, n) for src in (0, 3) for dst in (1, 2)
           for tag in (-5, 2, 3, 4, 5, 6, 9) for n in range(1, 60)]
    want = [theirs.decide(src, dst, tag, n) for src in (0, 3) for dst in (1, 2)
            for tag in (-5, 2, 3, 4, 5, 6, 9) for n in range(1, 60)]
    assert got == want


@pytest.mark.parametrize("key", [0, 1, 3, 17, 1023])
def test_retry_backoffs_equal_the_jax_package(key):
    kw = dict(op_deadline_s=1.0, max_retries=12, backoff_base_s=0.01,
              backoff_cap_s=0.05)
    ours = RetryPolicy(FTConfig(**kw), key=key)
    theirs = jft.RetryPolicy(jft.FTConfig(**kw), key=key)
    assert ours.attempts == theirs.attempts
    got = [ours.backoff_s(a) for a in range(1, 13)]
    want = [theirs.backoff_s(a) for a in range(1, 13)]
    assert [x.hex() for x in got] == [x.hex() for x in want]  # float for float
    assert ft.retry._splitmix64(key) == jft.retry._splitmix64(key)


def test_dedup_lifecycle_equals_the_jax_package():
    rng = np.random.default_rng(5)
    ours, theirs = DedupTable(), jft.DedupTable()
    for _ in range(400):
        c, tag = int(rng.integers(1, 4)), int(rng.choice([2, 6]))
        epoch, seq = int(rng.integers(0, 3)), int(rng.integers(1, 12))
        assert ours.admit(c, tag, epoch, seq) == theirs.admit(c, tag, epoch, seq)
        idx, count = int(rng.integers(0, 4)), 4
        assert ours.admit_chunk(c, tag, epoch, seq + 20, idx, count) == \
            theirs.admit_chunk(c, tag, epoch, seq + 20, idx, count)
    assert ours.state() == theirs.state()
    assert ours.partial_state() == theirs.partial_state()
    back = DedupTable()
    back.restore(theirs.state())
    assert back.state() == theirs.state()


def test_lease_lifecycle_equals_the_jax_package():
    now = [0.0]
    regs = [cls([1, 2, 3], ttl_s=1.0, clock=lambda: now[0])
            for cls in (LeaseRegistry, jft.LeaseRegistry)]
    script = [("arm", 1, 0, True), ("arm", 2, 0, False), ("arm", 3, 4, True),
              ("tick", 2.0), ("renew", 1, 0), ("renew", 2, 0), ("renew", 3, 3),
              ("tick", 2.5), ("renew", 3, 4), ("tick", 3.2), ("evict", 1),
              ("tick", 4.0), ("rejoin", 1, 1), ("renew", 1, 0), ("renew", 1, 1),
              ("stop", 2), ("tick", 5.5), ("evict", 3), ("retire", 1),
              ("admit", 4, 0)]
    for step in script:
        snaps = []
        for reg in regs:
            if step[0] == "tick":
                now[0] = step[1]
            elif step[0] == "arm":
                reg.arm(step[1], step[2], heartbeats=step[3])
            else:
                getattr(reg, step[0])(*step[1:])
            snaps.append((reg.expired(), [reg.state(c) for c in (1, 2, 3, 4)],
                          [reg.epoch(c) for c in (1, 2, 3, 4)], reg.all_done(),
                          reg.evictions))
        assert snaps[0] == snaps[1], step


def test_ft_config_from_env_equals_the_jax_package(monkeypatch):
    for k, v in dict(MPIT_FT_HEARTBEAT_S="0.3", MPIT_FT_LEASE_TTL_S="4",
                     MPIT_FT_OP_DEADLINE_S="2.5", MPIT_FT_MAX_RETRIES="5",
                     MPIT_FT_BACKOFF_BASE_S="0.01", MPIT_FT_BACKOFF_CAP_S="0.5",
                     MPIT_FT_EPOCH="2", MPIT_FT_REJOIN="1",
                     MPIT_FT_STALENESS="1").items():
        monkeypatch.setenv(k, v)
    ours, theirs = FTConfig.from_env(), jft.FTConfig.from_env()
    assert ours == FTConfig(**{f: getattr(theirs, f)
                               for f in ours.__dataclass_fields__})
    for prop in ("active", "framed", "stale_track", "server_rejoin", "deadline_s"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop


# ---------------------------------------------------------------------------
# scheduler timers


class TestSchedulerTimers:
    def test_aio_sleep_elapses(self):
        sched = Scheduler()
        t0 = time.monotonic()
        task = sched.spawn(aio_sleep(0.05), name="sleep")
        sched.wait()
        assert task.result is True
        assert time.monotonic() - t0 >= 0.05

    def test_aio_sleep_aborts_on_live_drop(self):
        live = LiveFlag()
        sched = Scheduler()
        task = sched.spawn(aio_sleep(60.0, live=live), name="sleep")
        live.stop()
        sched.wait()
        assert task.result is False

    def test_recv_deadline_raises(self):
        sched = Scheduler()
        sched.spawn(aio_recv(LocalRouter(2).endpoint(0), 1, tags.GRAD,
                             deadline=deadline_at(0.03)), name="recv")
        with pytest.raises(TaskError) as err:
            sched.wait()
        assert isinstance(err.value.cause, DeadlineExceeded)
        assert err.value.cause.tag == tags.GRAD

    def test_recv_abort_returns_none(self):
        sched = Scheduler()
        flag = []
        task = sched.spawn(aio_recv(LocalRouter(2).endpoint(0), 1, tags.GRAD,
                                    abort=lambda: bool(flag)), name="recv")
        sched.ping()
        flag.append(1)
        sched.wait()
        assert task.result is None

    def test_wait_deadline_and_deadline_at(self):
        sched = Scheduler()
        sched.spawn(aio_sleep(5.0), name="long")
        with pytest.raises(TimeoutError, match="long"):
            sched.wait(deadline=0.05)
        assert deadline_at(None) is None
        assert deadline_at(1.0) > time.monotonic()


# ---------------------------------------------------------------------------
# fault plan + transport


class TestFaultPlan:
    def test_parse_roundtrip(self):
        plan = FaultPlan.parse(
            "seed=7,drop_every=3,dup_every=5,delay_every=2,delay_polls=4")
        assert (plan.seed, plan.drop_every, plan.dup_every) == (7, 3, 5)
        assert plan.delay_polls == 4

    def test_parse_unknown_field_fails_loudly(self):
        with pytest.raises(ValueError, match="unknown fault-plan field"):
            FaultPlan.parse("seed=1,frobnicate=2")

    def test_every_k_counts_per_channel(self):
        plan = FaultPlan(drop_every=3)
        verdicts = [plan.decide(0, 1, tags.GRAD, n) for n in range(1, 7)]
        assert verdicts == ["pass", "pass", "drop", "pass", "pass", "drop"]
        assert plan.decide(0, 1, tags.PARAM_REQ, 1) == "pass"

    def test_from_env(self, monkeypatch):
        monkeypatch.setenv("MPIT_FT_FAULT_PLAN", "seed=3,drop_every=3,tags=2+4")
        assert FaultPlan.from_env() == FaultPlan(
            seed=3, drop_every=3, tags=frozenset({2, 4}))
        monkeypatch.delenv("MPIT_FT_FAULT_PLAN")
        assert FaultPlan.from_env() is None


class TestFaultyTransport:
    def _pair(self, plan):
        router = LocalRouter(2)
        return FaultyTransport(router.endpoint(0), plan), router.endpoint(1)

    def test_drop_never_delivers(self):
        src, dst = self._pair(FaultPlan(drop_every=1))
        src.send(b"x", 1, tags.GRAD)
        assert src.dropped == 1
        assert not dst.iprobe(0, tags.GRAD)

    def test_dup_delivers_twice(self):
        src, dst = self._pair(FaultPlan(dup_every=1))
        src.send(b"x", 1, tags.GRAD)
        assert dst.recv(0, tags.GRAD) == b"x"
        assert dst.recv(0, tags.GRAD) == b"x"
        assert src.duplicated == 1

    def test_delay_defers_post(self):
        src, dst = self._pair(FaultPlan(delay_every=1, delay_polls=5))
        handle = src.isend(b"x", 1, tags.GRAD)
        polls = 0
        while not src.test(handle):
            polls += 1
        assert polls >= 4 and src.delayed == 1
        assert dst.recv(0, tags.GRAD) == b"x"

    def test_sever_cuts_the_link(self):
        src, dst = self._pair(FaultPlan())
        src.send(b"a", 1, tags.GRAD)
        src.sever(1)
        src.send(b"b", 1, tags.GRAD)
        assert dst.recv(0, tags.GRAD) == b"a"
        assert not dst.iprobe(0, tags.GRAD)
        assert src.dropped == 1

    def test_faults_count_in_the_obs_registry(self):
        from mpit_tpu_torch.obs import metrics

        metrics.configure(enabled=True, reset=True)
        try:
            src, _dst = self._pair(FaultPlan(drop_every=2, dup_every=3))
            for _ in range(6):
                src.send(b"x", 1, tags.GRAD)
            snap = metrics.get_registry().snapshot()
        finally:
            metrics.configure(enabled=None, reset=True)
        counts = {k: v for k, v in snap.items() if k.startswith("mpit_ft_faults_total")}
        assert sorted(counts.values()) == [0, 1, 3]  # no delay, dup #3, drops #2 #4 #6

    def test_inject_preemption_terms_then_kills(self):
        import subprocess
        import sys

        obeys = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)"])
        reaper = threading.Thread(target=obeys.wait, daemon=True)  # no zombie
        reaper.start()
        assert ft.inject_preemption(obeys.pid, grace_s=5.0) == "term"
        reaper.join(10)
        ignores = subprocess.Popen([sys.executable, "-c",
                                    "import signal, time; signal.signal(signal.SIGTERM, "
                                    "signal.SIG_IGN); print('ready', flush=True); "
                                    "time.sleep(30)"], stdout=subprocess.PIPE)
        assert ignores.stdout.readline().strip() == b"ready"
        assert ft.inject_preemption(ignores.pid, grace_s=0.2) == "kill"
        assert ignores.wait(10) == -9

    def test_paced_transport_posts_after_the_link_time(self):
        router = LocalRouter(2)
        src = ft.PacedTransport(router.endpoint(0), rate_mbs=1.0, min_bytes=1)
        payload = np.zeros(20000, np.uint8)  # ~19 ms on a 1 MB/s link
        t0 = time.monotonic()
        handle = src.isend(payload, 1, tags.GRAD)
        while not src.test(handle):
            time.sleep(0.001)
        assert time.monotonic() - t0 >= 0.015
        assert len(router.endpoint(1).recv(0, tags.GRAD)) == 20000


class TestDedupLeasesRetry:
    def test_fresh_dup_stale(self):
        t = DedupTable()
        assert t.admit(1, tags.GRAD, 0, 1) == "fresh"
        assert t.admit(1, tags.GRAD, 0, 1) == "dup"
        assert t.admit(1, tags.GRAD, 0, 2) == "fresh"
        assert t.admit(1, tags.GRAD, 1, 1) == "fresh"
        assert t.admit(1, tags.GRAD, 0, 3) == "stale"

    def test_expiry_only_after_first_beat(self):
        now = [0.0]
        reg = LeaseRegistry([1, 2], ttl_s=1.0, clock=lambda: now[0])
        reg.arm(1, 0, heartbeats=True)
        reg.arm(2, 0, heartbeats=False)
        now[0] = 5.0
        assert reg.expired() == []
        reg.renew(1, 0)
        reg.renew(2, 0)
        now[0] = 6.5
        assert reg.expired() == [1]
        reg.evict(1)
        assert reg.state(1) == EVICTED and reg.gone(1)

    def test_backoff_caps_and_jitter_is_deterministic(self):
        cfg = FTConfig(op_deadline_s=1.0, max_retries=10,
                       backoff_base_s=0.01, backoff_cap_s=0.05)
        seq = [RetryPolicy(cfg, key=3).backoff_s(a) for a in range(1, 11)]
        assert max(seq) <= 0.05 * 1.5 + 1e-9 and seq[0] >= 0.01
        assert seq != [RetryPolicy(cfg, key=4).backoff_s(a) for a in range(1, 11)]


# ---------------------------------------------------------------------------
# end to end: retry + dedup against an injected-fault PS topology


def launch_ft(nservers, nclients, client_plans=None, server_plan=None,
              client_ft=FAST_FT, server_ft=None, rule="add", codec=None):
    """FT PS topology over the port's LocalRouter with FaultyTransport
    seams.  Returns (servers, clients, threads, client_transports)."""
    n = nservers + nclients
    router = LocalRouter(n)
    sranks = list(range(nservers))
    cranks = list(range(nservers, n))
    server_ft = server_ft or FTConfig(rejoin=True)
    servers, threads = [], []
    for r in sranks:
        ep = router.endpoint(r)
        if server_plan is not None:
            ep = FaultyTransport(ep, server_plan)
        servers.append(ParamServer(r, cranks, ep, rule=rule, ft=server_ft,
                                   device="cpu"))
        threads.append(threading.Thread(target=servers[-1].start, daemon=True))
    for t in threads:
        t.start()
    transports, clients = [], []
    for i, r in enumerate(cranks):
        ep = router.endpoint(r)
        plan = (client_plans or {}).get(i)
        if plan is not None:
            ep = FaultyTransport(ep, plan)
        transports.append(ep)
        clients.append(ParamClient(r, sranks, ep, seed_servers=(r == cranks[0]),
                                   codec=codec, ft=client_ft))
    return servers, clients, threads, transports


def run_lockstep(clients, grads_per_round, rounds):
    """Each client ships its grad and awaits the acks before the next
    client moves — pins the cross-client apply order."""
    for r in range(rounds):
        for i, c in enumerate(clients):
            c.grad[:] = grads_per_round(i, r)
            c.async_send_grad()
            c.wait()


def start_all(clients, params):
    starters = [threading.Thread(target=c.start, args=(p, np.zeros_like(p)),
                                 daemon=True) for c, p in zip(clients, params)]
    for t in starters:
        t.start()
    join_all(starters)


class TestRetryDedupEndToEnd:
    def _final_params(self, client_plans, server_plan, rounds=4, nservers=2,
                      nclients=2, codec=None, size=64, rule="add",
                      client_ft=FAST_FT):
        rng = np.random.default_rng(42)
        w0 = rng.normal(size=size).astype(np.float32)
        gtab = rng.normal(size=(nclients, rounds, size)).astype(np.float32)
        servers, clients, threads, _ = launch_ft(
            nservers, nclients, client_plans=client_plans,
            server_plan=server_plan, codec=codec, rule=rule, client_ft=client_ft)
        params = [w0.copy()] + [np.zeros_like(w0) for _ in range(nclients - 1)]
        start_all(clients, params)
        run_lockstep(clients, lambda i, r: gtab[i, r], rounds)
        clients[0].async_recv_param()
        clients[0].wait()
        for c in clients:
            c.stop()
        join_all(threads)
        stats = {
            "applied": sum(s.grads_applied for s in servers),
            "dups": sum(s.dup_ops for s in servers),
            "retries": sum(c.retries for c in clients),
            "admitted": [dict(s.admitted) for s in servers],
            "staleness_observed": sum(h.count for s in servers
                                      for h in s._stale_hists.values()),
        }
        return params[0].copy(), stats

    @pytest.mark.parametrize("rule", ["add", "adam"])
    def test_drop_and_dup_run_matches_fault_free_bitwise(self, rule):
        """The acceptance matrix: every 3rd client data message dropped,
        every 4th duplicated; every 3rd server reply dropped.  Final params
        equal the fault-free run's bitwise, and every admitted GRAD seq is
        applied exactly once."""
        clean, clean_stats = self._final_params(None, None, rule=rule)
        client_plans = {i: FaultPlan(seed=i, drop_every=3, dup_every=4,
                                     tags=DATA_TAGS) for i in range(2)}
        server_plan = FaultPlan(seed=9, drop_every=3, tags=REPLY_TAGS)
        faulty, stats = self._final_params(client_plans, server_plan, rule=rule)
        np.testing.assert_array_equal(clean, faulty)
        assert stats["retries"] > 0, "the plan never actually bit"
        assert stats["dups"] > 0, "no duplicate was ever admitted"
        assert stats["applied"] == clean_stats["applied"] == 16
        for admitted in stats["admitted"]:
            assert admitted == {(2, 0): [1, 4, 4], (3, 0): [1, 4, 4]}

    def test_int8_error_feedback_survives_retries(self):
        """Dropped replies force resends of quantized grads; encode-once
        staging + server dedup keep the error-feedback telescope exact."""
        clean, _ = self._final_params(None, None, codec="int8", size=2048)
        server_plan = FaultPlan(seed=5, drop_every=2, tags=REPLY_TAGS)
        faulty, stats = self._final_params(None, server_plan, codec="int8",
                                           size=2048)
        np.testing.assert_array_equal(clean, faulty)
        assert stats["retries"] > 0 and stats["dups"] > 0

    def test_staleness_header_runs_bitwise(self):
        """FLAG_STALENESS widens the header to 24 bytes; the math is
        untouched and one staleness observation lands per applied GRAD."""
        clean, _ = self._final_params(None, None)
        stale_ft = FTConfig(op_deadline_s=0.25, max_retries=8, staleness=True,
                            backoff_base_s=0.005, backoff_cap_s=0.02)
        got, stats = self._final_params(
            None, FaultPlan(seed=9, drop_every=3, tags=REPLY_TAGS),
            client_ft=stale_ft)
        np.testing.assert_array_equal(clean, got)
        assert stats["dups"] > 0
        assert stats["staleness_observed"] == stats["applied"] == 16

    def test_exhausted_retries_fail_loudly_never_hang(self):
        servers, clients, threads, transports = launch_ft(
            1, 1, client_plans={0: FaultPlan(tags=DATA_TAGS)},
            client_ft=FTConfig(op_deadline_s=0.05, max_retries=2,
                               backoff_base_s=0.005, backoff_cap_s=0.01))
        (client,), (ct,) = clients, transports
        param, grad = np.ones(8, np.float32), np.zeros(8, np.float32)
        client.start(param, grad)
        ct.sever(0)
        grad[:] = 1.0
        client.async_send_grad()
        t0 = time.monotonic()
        with pytest.raises(TaskError) as err:
            client.wait()
        assert isinstance(err.value.cause, RetryExhausted)
        assert time.monotonic() - t0 < 10.0
        for s in servers:
            s.live.stop()
        join_all(threads)

    def test_param_read_retries_and_discards_stale_snapshots(self):
        server_plan = FaultPlan(seed=2, drop_every=2, tags=frozenset({tags.PARAM}))
        servers, clients, threads, _ = launch_ft(1, 1, server_plan=server_plan)
        (client,) = clients
        w0 = np.arange(16, dtype=np.float32)
        param, grad = w0.copy(), np.zeros_like(w0)
        client.start(param, grad)
        for i in range(4):
            grad[:] = 1.0
            client.async_send_grad()
            client.async_recv_param()
            client.wait()
            np.testing.assert_array_equal(param, w0 + (i + 1))
        assert client.retries > 0
        client.stop()
        join_all(threads)


# ---------------------------------------------------------------------------
# heartbeats, leases, eviction, rejoin


def _two_clients_one_server(ttl=0.15):
    servers, clients, threads, transports = launch_ft(
        1, 2, client_plans={1: FaultPlan()}, client_ft=HB_FT,
        server_ft=FTConfig(lease_ttl_s=ttl, rejoin=True))
    w0 = np.ones(8, np.float32)
    bufs = [(w0.copy(), np.zeros_like(w0)), (np.zeros_like(w0), np.zeros_like(w0))]
    starters = [threading.Thread(target=c.start, args=bufs[i], daemon=True)
                for i, c in enumerate(clients)]
    for t in starters:
        t.start()
    join_all(starters)
    return servers, clients, threads, transports, w0, bufs


def _beat_until_seen(server, client, n=2):
    """The lease arms on the first delivered beat: beat until ``n`` are in."""
    deadline = time.monotonic() + 10
    while server.heartbeats_seen < n and time.monotonic() < deadline:
        client.ping()
        client.wait()
        time.sleep(0.005)
    assert server.heartbeats_seen >= n


def _silence_until_evicted(server, silent, survivor):
    """Sever ``silent``'s link and keep the survivor beating until the
    server evicts it; returns the seconds from silence to eviction."""
    t0 = time.monotonic()
    deadline = t0 + 10
    while server.leases.state(silent) != EVICTED and time.monotonic() < deadline:
        survivor.ping()
        time.sleep(0.005)
    assert server.leases.state(silent) == EVICTED
    return time.monotonic() - t0


class TestHeartbeatLeaseEviction:
    def test_heartbeats_flow_and_renew(self):
        servers, clients, threads, _ = launch_ft(
            1, 1, client_ft=HB_FT, server_ft=FTConfig(lease_ttl_s=0.5, rejoin=True))
        (client,) = clients
        w0 = np.ones(8, np.float32)
        client.start(w0.copy(), np.zeros_like(w0))
        deadline = time.monotonic() + 5
        while servers[0].heartbeats_seen < 3 and time.monotonic() < deadline:
            client.ping()
            time.sleep(0.005)
        assert servers[0].heartbeats_seen >= 3 and client.heartbeats_sent >= 3
        client.stop()
        join_all(threads)

    def test_lease_expiry_evicts_without_stalling_survivors(self):
        """One client goes silent; its lease expires; the server evicts it
        within about 1.5x the TTL, keeps serving the survivor, and the
        stop protocol completes without the dead client's STOP."""
        servers, (c1, c2), threads, transports, w0, bufs = _two_clients_one_server()
        _beat_until_seen(servers[0], c2)
        transports[1].sever(0)  # c2 "crashes": nothing reaches the server
        took = _silence_until_evicted(servers[0], c2.rank, c1)
        assert took < 1.5 * 0.15 + 0.5  # the TTL plus reaper and poll slack
        assert c2.rank not in servers[0].grad_bufs  # staging released
        p1, g1 = bufs[0]
        g1[:] = 2.0
        c1.async_send_grad()
        c1.async_recv_param()
        c1.wait()
        np.testing.assert_array_equal(p1, w0 + 2.0)
        c1.stop()
        join_all(threads)  # completes with only the survivor's STOP
        assert servers[0].leases.evictions == servers[0].evictions == 1

    def test_evicted_client_rejoins_with_bumped_epoch(self):
        servers, (c1, c2), threads, transports, w0, bufs = _two_clients_one_server()
        bufs[1][1][:] = 1.0
        c2.async_send_grad()
        c2.wait()
        _beat_until_seen(servers[0], c2)
        transports[1].sever(0)  # crash
        _silence_until_evicted(servers[0], c2.rank, c1)
        # the restarted incarnation: same rank, epoch + 1, no seeding
        c2b = ParamClient(c2.rank, [0], transports[1].inner,
                          ft=FTConfig(heartbeat_s=0.02, op_deadline_s=0.5,
                                      max_retries=4, backoff_base_s=0.005,
                                      epoch=1))
        p2b, g2b = np.zeros_like(w0), np.zeros_like(w0)
        starter = threading.Thread(target=c2b.start, args=(p2b, g2b), daemon=True)
        starter.start()
        join_all([starter], timeout=10)
        # The rejoin is a server-side step: the listener accepts the INIT
        # after the client's send completes, so wait for it rather than
        # read the count at once.
        deadline = time.monotonic() + 10
        while servers[0].rejoins < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert servers[0].rejoins == 1
        c2b.async_recv_param()
        c2b.wait()
        np.testing.assert_array_equal(p2b, w0 + 1.0)  # pre-crash state kept
        g2b[:] = 3.0
        c2b.async_send_grad()
        c2b.wait()
        assert servers[0].admitted[(c2.rank, 1)] == [1, 1, 1]  # epoch 1 admitted
        p1, _g1 = bufs[0]
        c1.async_recv_param()
        c1.wait()
        np.testing.assert_array_equal(p1, w0 + 4.0)
        c1.stop()
        c2b.stop()
        join_all(threads)


# ---------------------------------------------------------------------------
# server checkpoint / restart


RESTART_FT = FTConfig(op_deadline_s=0.2, max_retries=30, backoff_base_s=0.01,
                      backoff_cap_s=0.05)


def _restart_through_void(tmp_path, first, second, client_cls=ParamClient,
                          router_cls=LocalRouter, ft_mod=ft, drop_first_ack=False):
    """A server of one package applies GRAD 1 (its ack dropped when
    ``drop_first_ack``), stops and checkpoints; the client sends into the
    void; a server of the other package restores and serves the retries.
    Returns (restored server, saved path, client's param)."""
    router = router_cls(2)
    ep0 = router.endpoint(0)
    if drop_first_ack:
        ep0 = ft_mod.FaultyTransport(ep0, ft_mod.FaultPlan(
            drop_every=1, sever_after=-1, tags=frozenset({tags.GRAD_ACK})))
    s1 = first(ep0)
    t = threading.Thread(target=s1.start, daemon=True)
    t.start()
    cft = ft_mod.FTConfig(op_deadline_s=0.2, max_retries=30,
                          backoff_base_s=0.01, backoff_cap_s=0.05)
    client = client_cls(1, [0], router.endpoint(1), seed_servers=True, ft=cft)
    w0 = np.ones(12, np.float32)
    param, grad = w0.copy(), np.zeros_like(w0)
    client.start(param, grad)
    grad[:] = 1.0
    client.async_send_grad()
    if drop_first_ack:
        deadline = time.monotonic() + 10
        while s1.grads_applied < 1 and time.monotonic() < deadline:
            client.ping()
    else:
        client.wait()
    s1.live.stop()
    join_all([t], timeout=5)
    path = s1.save_state(tmp_path)
    if not drop_first_ack:
        client.async_send_grad()  # into the void, retried
    client.async_recv_param()
    if drop_first_ack:
        client.async_send_grad()  # after the DUP re-ack: FRESH
    s2 = second(router.endpoint(0))
    s2.restore_state(tmp_path / "server0_latest.npz")
    t2 = threading.Thread(target=s2.start, daemon=True)
    t2.start()
    client.wait()
    client.stop()
    join_all([t2])
    return s2, path, param


class TestServerRestart:
    def test_restart_resumes_retried_ops_without_double_apply(self, tmp_path):
        """Kill the server after a checkpoint; the client's in-flight retry
        lands on the restarted process: the op issued into the void
        applies exactly once, and the restored p, m, v are the saved bytes
        in storage of their own."""
        captured = {}
        real_load = ckpt.load_server_state

        def load(path):
            out = real_load(path)
            captured["arrays"] = [out[2], *out[3].values()]
            captured["state"] = {"param": out[2].copy(),
                                 **{k: v.copy() for k, v in out[3].items()}}
            return out

        def first(ep):
            return ParamServer(0, [1], ep, rule="adam", device="cpu")

        restored = {}

        def second(ep):
            s = ParamServer(0, [1], ep, rule="adam", device="cpu",
                            ft=FTConfig(rejoin=True))
            real_restore = s.restore_state

            def restore(path):
                real_restore(path)
                restored["param"] = s.param.clone()
                restored.update({k: v.clone() for k, v in s.rule_state.items()})
                restored["tensors"] = [s.param, *s.rule_state.values()]
            s.restore_state = restore
            return s

        import mpit_tpu_torch.utils.checkpoint as ck_mod

        orig = ck_mod.load_server_state
        ck_mod.load_server_state = load
        try:
            s2, path, _param = _restart_through_void(tmp_path, first, second)
        finally:
            ck_mod.load_server_state = orig
        assert "server0_" in str(path)  # stamped version
        assert s2.grads_applied == 2  # restored count + exactly one more
        assert s2.restored_applied == 1
        for key, want in captured["state"].items():
            assert restored[key].numpy().tobytes() == want.tobytes(), key
            assert tuple(restored[key].shape) == want.shape, key  # t stays 0-d
        spans = [(a.ctypes.data, a.ctypes.data + a.nbytes) for a in captured["arrays"]]
        for t in restored["tensors"]:
            ptr = t.untyped_storage().data_ptr()
            assert all(not (lo <= ptr < hi) for lo, hi in spans), "aliases the npz"

    def test_stamped_history_is_pruned(self, tmp_path):
        for _ in range(6):
            ckpt.save_server_state(tmp_path, 0, 0, 4, np.zeros(4, np.float32),
                                   {}, keep=3)
            time.sleep(0.002)  # distinct millisecond stamps
        stamped = [p for p in tmp_path.glob("server0_*.npz")
                   if p.name[len("server0_"):-len(".npz")].isdigit()]
        assert len(stamped) == 3
        assert (tmp_path / "server0_latest.npz").exists()

    def test_checkpoint_meta_carries_ft_state(self, tmp_path):
        servers, clients, threads, _ = launch_ft(1, 1, client_ft=FAST_FT)
        (client,) = clients
        w0 = np.ones(8, np.float32)
        param, grad = w0.copy(), np.zeros_like(w0)
        client.start(param, grad)
        grad[:] = 1.0
        client.async_send_grad()
        client.wait()
        client.stop()
        join_all(threads)
        path = servers[0].save_state(tmp_path)
        *_rest, meta = ckpt.load_server_state(path)
        assert meta["clients"]["1"]["framed"] is True
        assert meta["dedup"]
        s2 = ParamServer(0, [1], LocalRouter(2).endpoint(0), device="cpu")
        s2.restore_state(path)
        assert s2.dedup.admit(1, tags.GRAD, 0, 1) == "dup"

    def test_server_checkpoints_on_an_interval_and_at_stop(self, tmp_path):
        router = LocalRouter(2)
        server = ParamServer(0, [1], router.endpoint(0), rule="adam",
                             device="cpu", ckpt_dir=str(tmp_path),
                             ckpt_interval=0.01)
        t = threading.Thread(target=server.start, daemon=True)
        t.start()
        client = ParamClient(1, [0], router.endpoint(1), seed_servers=True,
                             ft=FAST_FT)
        param, grad = np.ones(8, np.float32), np.full(8, 0.5, np.float32)
        client.start(param, grad)
        for _ in range(3):
            client.async_send_grad()
            client.wait()
            time.sleep(0.02)
        client.stop()
        join_all([t])
        assert server.ckpts_written >= 2
        *_rest, meta = ckpt.load_server_state(tmp_path / "server0_latest.npz")
        assert meta["grads_applied"] == 3


class TestCheckpointsAcrossPackages:
    """A port checkpoint restores in a JAX server and a JAX checkpoint in a
    port server; in each case the restored dedup table admits the retried
    op (GRAD 1, whose ack was lost) as DUP and the next one as FRESH, and
    the client reads the checkpointed shard in between."""

    def test_jax_checkpoint_restores_in_a_port_server(self, tmp_path):
        def first(ep):
            return JaxServer(0, [1], ep, rule="adam")

        def second(ep):
            return ParamServer(0, [1], ep, rule="adam", device="cpu",
                               ft=FTConfig(rejoin=True))

        s2, _path, param = _restart_through_void(
            tmp_path, first, second, client_cls=JaxClient, router_cls=JaxRouter,
            ft_mod=jft, drop_first_ack=True)
        assert s2.grads_applied == 2 and s2.dup_ops == 1
        _o, _s, jparam, jstate, _meta = ckpt.load_server_state(
            sorted(tmp_path.glob("server0_1*.npz"))[0])
        np.testing.assert_array_equal(param, jparam)

    def test_port_checkpoint_restores_in_a_jax_server(self, tmp_path):
        def first(ep):
            return ParamServer(0, [1], ep, rule="adam", device="cpu")

        def second(ep):
            return JaxServer(0, [1], ep, rule="adam", ft=jft.FTConfig(rejoin=True))

        s2, _path, param = _restart_through_void(
            tmp_path, first, second, drop_first_ack=True)
        assert s2.grads_applied == 2 and s2.dup_ops == 1
        meta_state = ckpt.load_server_state(tmp_path / "server0_latest.npz")[2]
        np.testing.assert_array_equal(param, meta_state)

    def test_states_round_trip_bitwise(self, tmp_path):
        rng = np.random.default_rng(3)
        p = rng.normal(size=40).astype(np.float32)
        state = {"t": np.asarray(7, np.int32), "m": rng.normal(size=40).astype(np.float32),
                 "v": rng.random(40).astype(np.float32)}
        meta = {"dedup": {"1:2": [0, 5]}, "grads_applied": 5, "snap_version": 6,
                "clients": {"1": {"codec": "int8", "framed": True, "hb": True,
                                  "stale": False, "timing": False, "chunk": 0,
                                  "epoch": 0}}}
        from mpit_tpu.utils import checkpoint as jckpt

        jpath = jckpt.save_server_state(tmp_path / "j", 0, 8, 40, p, state, meta=meta)
        tpath = ckpt.save_server_state(tmp_path / "t", 0, 8, 40,
                                       torch.from_numpy(p), {k: torch.from_numpy(v)
                                                             for k, v in state.items()},
                                       meta=meta)
        for reader in (ckpt.load_server_state, jckpt.load_server_state):
            for path in (jpath, tpath):
                off, size, got_p, got_s, got_meta = reader(path)
                assert (off, size) == (8, 40)
                assert got_p.tobytes() == p.tobytes()
                assert {k: v.tobytes() for k, v in got_s.items()} == \
                    {k: v.tobytes() for k, v in state.items()}
                assert got_meta["dedup"] == meta["dedup"]
        server = ParamServer(0, [1], LocalRouter(2).endpoint(0), rule="adam",
                             device="cpu")
        server.restore_state(jpath)
        assert server.param.numpy().tobytes() == p.tobytes()
        assert int(server.rule_state["t"]) == 7 and server.rule_state["t"].dim() == 0
        assert server.dedup.admit(1, tags.GRAD, 0, 5) == "dup"
        assert server.grad_bufs[1].nbytes == 16 + server._codecs[1].wire_nbytes(40)


# ---------------------------------------------------------------------------
# the property test: any {drop, delay, dup} plan completes bitwise or fails
# loudly — never hangs


@pytest.mark.parametrize("seed", range(5))
def test_property_fault_plans_never_hang(seed):
    """Seed-deterministic random plans over {drop, delay, dup} on <= 3
    clients: the run either completes with bitwise-correct final params or
    raises (RetryExhausted / TaskError) — and always finishes inside the
    hard timeout."""
    rng = np.random.default_rng(seed)
    nclients = int(rng.integers(1, 4))
    rounds, size = 3, 32
    w0 = rng.normal(size=size).astype(np.float32)
    gtab = rng.normal(size=(nclients, rounds, size)).astype(np.float32)

    def run(client_plans, server_plan, box):
        servers, clients = [], []
        try:
            servers, clients, threads, _ = launch_ft(
                2, nclients, client_plans=client_plans, server_plan=server_plan,
                client_ft=FTConfig(heartbeat_s=0.02, op_deadline_s=0.15,
                                   max_retries=6, backoff_base_s=0.005,
                                   backoff_cap_s=0.02),
                server_ft=FTConfig(lease_ttl_s=1.0, rejoin=True))
            params = [w0.copy()] + [np.zeros(size, np.float32)
                                    for _ in range(nclients - 1)]
            start_all(clients, params)
            run_lockstep(clients, lambda i, r: gtab[i, r], rounds)
            clients[0].async_recv_param()
            clients[0].wait()
            for c in clients:
                c.stop()
            join_all(threads, timeout=20)
            box["params"] = params[0].copy()
        except (TaskError, RetryExhausted, AssertionError) as exc:
            box["error"] = exc  # loud is an acceptable outcome
            for c in clients:
                c.live.stop()
            for s in servers:
                s.live.stop()

    clean: dict = {}
    run(None, None, clean)
    assert "params" in clean, f"fault-free run failed: {clean.get('error')}"
    client_plans = {
        i: FaultPlan(seed=seed * 17 + i, drop_rate=0.08, dup_rate=0.08,
                     delay_rate=0.15, delay_polls=4, tags=DATA_TAGS)
        for i in range(nclients)
    }
    server_plan = FaultPlan(seed=seed * 31 + 7, drop_rate=0.08, dup_rate=0.08,
                            delay_rate=0.15, delay_polls=4, tags=REPLY_TAGS)
    box: dict = {}
    worker = threading.Thread(target=run, args=(client_plans, server_plan, box),
                              daemon=True)
    worker.start()
    worker.join(90)  # the hard timeout: a hang is the one forbidden outcome
    assert not worker.is_alive(), "faulty run HUNG (never-hang contract broken)"
    if "params" in box:
        np.testing.assert_array_equal(clean["params"], box["params"])
    else:
        assert "error" in box  # failed loudly


# ---------------------------------------------------------------------------
# the guards of later slices


@pytest.mark.parametrize("make,exc,match", [
    # Shard control landed: a shardctl client still needs op deadlines.
    pytest.param(lambda: ParamClient(1, [0], LocalRouter(2).endpoint(1),
                                     shardctl=True, ft=FTConfig()),
                 ValueError, "op_deadline_s", id="<lambda>-slice 5, shardctl"),
    # Chunked streaming landed: a chunk size without op deadlines is
    # accepted and stays inactive (no framing to ride), as in the reference.
    pytest.param(lambda: FTConfig(chunk_bytes=65536), None, None,
                 id="<lambda>-comm/pool"),
    # Elastic membership landed: a joiner (with its preemption notice)
    # needs a controller, and late-join candidates are not launch members.
    pytest.param(lambda: ParamServer(0, [1], LocalRouter(2).endpoint(0), device="cpu",
                                     preempt=object(), shardctl=True).start(),
                 ValueError, "controller_rank", id="<lambda>-elastic0"),
    pytest.param(lambda: ParamServer(0, [1], LocalRouter(2).endpoint(0), device="cpu",
                                     admit_ranks=[1]),
                 ValueError, "overlap", id="<lambda>-elastic1"),
])
def test_later_slices_refuse_loudly(make, exc, match):
    """Chunked streaming, shard control and elastic membership have landed:
    their own guards fail loudly, and a chunk size without framing is the
    reference's inactive posture."""
    if exc is None:
        cfg = make()
        jcfg = jft.FTConfig(chunk_bytes=cfg.chunk_bytes)
        assert (cfg.chunk_bytes, cfg.chunked) == (jcfg.chunk_bytes, jcfg.chunked)
        assert not cfg.chunked
        return
    with pytest.raises(exc, match=match):
        make()


def test_traffic_exports_refuse_naming_their_slice():
    """``ft/traffic.py`` came with shard control: the port's ft exports are
    the JAX package's, and a name neither package has is an
    AttributeError."""
    from mpit_tpu_torch.ft import Scenario, traffic

    assert Scenario is traffic.Scenario
    assert set(ft.__all__) == set(jft.__all__)
    with pytest.raises(AttributeError):
        ft.NoSuchExport  # noqa: B018


def _v4_unframed():
    """An INIT v4 announcement without FLAG_FRAMED (shard control only)."""
    from mpit_tpu_torch.shardctl import FLAG_SHARDCTL, ShardMap
    from mpit_tpu_torch.shardctl.wire import init_v4

    return list(init_v4(0, 0, FLAG_SHARDCTL, ShardMap.initial(8, [0])))


@pytest.mark.parametrize("words,exc,match", [
    # INIT v4 is shard control's, landed: unframed, it is refused loudly.
    pytest.param(_v4_unframed(), ValueError, "FLAG_FRAMED",
                 id="words0-INIT v4.*shardctl"),
    # INIT v5 landed: a framed chunked writer is accepted with its cut, and
    # FLAG_CHUNKED outside the 48-byte v5 form is malformed, as in the
    # reference.
    pytest.param([0, 8, 0, 1, 1 | 64, 1024], None, None,
                 id="words1-INIT v5.*comm/pool"),
    pytest.param([0, 8, 0, 1, 1 | 8 | 64], ValueError,
                 "FLAG_CHUNKED and the 48-byte v5", id="words2-FLAG_CHUNKED.*slice 5"),
    pytest.param([0, 8, 0, 1, 1 | 64], ValueError,
                 "FLAG_CHUNKED and the 48-byte v5", id="words3-FLAG_CHUNKED.*slice 5"),
    # The serving tier and cells landed: a READ-ONLY or SUBSCRIBE announcement
    # from a rank that is neither a reader nor a cell is refused loudly.
    pytest.param([0, 8, 0, 1, 1 | 16], ValueError,
                 "FLAG_READONLY.*reader_ranks", id="words4-FLAG_READONLY.*slice 5"),
    pytest.param([0, 8, 0, 1, 1 | 16 | 32], ValueError, "cell_ranks",
                 id="words5-slice 5"),
])
def test_server_refuses_announcements_of_later_slices(words, exc, match):
    """Each announcement gets the JAX server's answer."""
    server = ParamServer(0, [1], LocalRouter(2).endpoint(0), device="cpu")
    jserver = JaxServer(0, [1], JaxRouter(2).endpoint(0))
    payload = np.asarray(words, np.int64).tobytes()
    if exc is None:
        assert server._negotiate(1, payload).name == jserver._negotiate(1, payload).name
        assert server._chunk[1] == jserver._chunk[1] == words[5]
        return
    with pytest.raises(exc, match=match):
        server._negotiate(1, payload)
    with pytest.raises(exc, match=match):
        jserver._negotiate(1, payload)


@pytest.fixture
def jax_pool_restored():
    """The JAX package's worker pool is process-global: a JAX chunked client
    makes it.  Put the process back as it was, so no later test of this
    worker sees a pool it did not make."""
    import mpit_tpu.comm.pool as jpool

    saved = jpool._GLOBAL
    yield
    made = jpool._GLOBAL
    if made is not saved:
        jpool._GLOBAL = saved
        if made is not None:
            made.close()


def test_jax_client_with_timing_is_refused_by_a_port_server(jax_pool_restored):
    """A JAX client announcing FLAG_TIMING together with chunked streaming
    (INIT v5) is served by a port server as a JAX server serves it: timed
    chunk acks and replies, the pushed gradient applied once."""
    router = JaxRouter(2)
    server = ParamServer(0, [1], router.endpoint(0), device="cpu")
    client = JaxClient(1, [0], router.endpoint(1), seed_servers=True,
                       ft=jft.FTConfig(op_deadline_s=5.0, timing=True,
                                       chunk_bytes=4096))
    t = threading.Thread(target=server.start, daemon=True)
    t.start()
    param = np.ones(3000, np.float32)
    grad = np.full(3000, 0.5, np.float32)
    client.start(param, grad)
    client.async_send_grad()
    client.wait()
    param[:] = 0
    client.async_recv_param()
    client.wait()
    client.stop()
    t.join(30)
    assert not t.is_alive()
    assert server._timing[1] and server._chunk[1] == 1024
    assert server.grads_applied == 1
    np.testing.assert_array_equal(param, np.full(3000, 1.5, np.float32))


@pytest.mark.parametrize("flag,value,exc,match", [
    # Shard control and elastic membership landed: without op deadlines
    # (their re-routing rides the retry machinery) they refuse loudly.
    pytest.param("shardctl", True, ValueError, "ft_op_deadline_s", id="shardctl-True"),
    # Chunked streaming landed: without op deadlines the chunk size stays
    # inactive and the gang runs, as in the reference.
    pytest.param("ft_chunk_bytes", 4096, None, None, id="ft_chunk_bytes-4096"),
    pytest.param("elastic", True, ValueError, "ft_op_deadline_s", id="elastic-True"),
])
def test_launch_refuses_ft_flags_of_later_slices(flag, value, exc, match):
    from mpit_tpu_torch.train import launch

    cfg = launch.LAUNCH_DEFAULTS.merged({"np": 3, "device": "cpu", "side": 8,
                                         flag: value})
    if exc is None:
        results = launch.run_gang(3, cfg.merged(epochs=1, opt="downpour"))
        assert sorted(r["role"] for r in results.values()) == ["server", "server",
                                                               "worker"]
        return
    with pytest.raises(exc, match=match):
        launch.run_gang(3, cfg)


def test_resume_needs_servers_and_a_checkpoint(tmp_path):
    from mpit_tpu_torch.train import launch

    cfg = launch.LAUNCH_DEFAULTS.merged(device="cpu", side=8, resume=True,
                                        server_ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="--np > 1"):
        launch.run_rank(0, 1, cfg, None)
    with pytest.raises(FileNotFoundError, match="server0_latest"):
        launch.run_rank(0, 2, cfg, LocalRouter(2).endpoint(0))


def test_ft_from_cfg_layers_flags_over_the_env(monkeypatch):
    from mpit_tpu_torch.train import launch

    monkeypatch.setenv("MPIT_FT_EPOCH", "2")
    monkeypatch.setenv("MPIT_FT_REJOIN", "1")
    cfg = launch.LAUNCH_DEFAULTS.merged(ft_heartbeat_s=0.25, ft_lease_ttl_s=20.0,
                                        ft_op_deadline_s=5.0, ft_max_retries=3,
                                        ft_staleness=True)
    got = launch.ft_from_cfg(cfg)
    assert got == FTConfig(heartbeat_s=0.25, lease_ttl_s=20.0, op_deadline_s=5.0,
                           max_retries=3, epoch=2, rejoin=True, staleness=True)
    assert launch.rejoining()
    monkeypatch.delenv("MPIT_FT_EPOCH")
    monkeypatch.delenv("MPIT_FT_REJOIN")
    assert launch.ft_from_cfg(launch.LAUNCH_DEFAULTS) == FTConfig()
    assert launch.ft_from_cfg(launch.LAUNCH_DEFAULTS.merged(supervise=1)).rejoin
    assert os.environ.get("MPIT_FT_REJOIN") is None and not launch.rejoining()
