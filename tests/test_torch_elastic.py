"""Elastic gangs of the port, a twin of ``tests/test_elastic.py``:
controller-driven scale-up and drain-shrink, graceful preemption, late
admission and the operator ``/scale`` route, over port servers, clients and
controller on the CPU.

Every gang that changes membership ends bit for bit equal to the port's
static run and to the JAX package's static run of the same lockstep
rounds (codec ``none`` and ``int8`` under ``add``); the chaos soak (grow,
drain-shrink, preempt) also runs with ``rule="adam"``, bit for bit equal to
the port's static Adam run and within the reference's fused-update
tolerance of the JAX package's (its CPU Adam rounds through XLA), with K3's
plain twin called once per admitted GRAD across every owner.
``TestReaderRetirement``: a retiring server's GOODBYE re-routes a port
reader to the successor, and a JAX reader off a port server, with the retry
budget untouched.  The slow launch soak has a slow-marked twin.
"""

import os
import signal
import threading
import time
import urllib.request

import numpy as np
import pytest

import torch

import mpit_tpu.ft as jft
import mpit_tpu.ps as jps
import mpit_tpu.shardctl as jsc
from mpit_tpu.optim import rules as jrules
from mpit_tpu_torch.comm.local import LocalRouter
from mpit_tpu_torch.ops import fused_update as fu
from mpit_tpu_torch.optim import rules as trules
from mpit_tpu_torch.ft import (
    RETIRED,
    FaultPlan,
    FTConfig,
    FaultyTransport,
    LeaseRegistry,
    PreemptionNotice,
)
from mpit_tpu_torch.ps import ParamClient, ParamServer, tags
import mpit_tpu_torch.shardctl as tsc
from mpit_tpu_torch.shardctl import ShardController
from mpit_tpu_torch.shardctl import migrate as scmigrate

torch.set_num_threads(1)

DATA_TAGS = frozenset({tags.GRAD, tags.PARAM_REQ, tags.PARAM_PUSH})

FAST_FT = FTConfig(op_deadline_s=0.5, max_retries=12,
                   backoff_base_s=0.005, backoff_cap_s=0.02)
JAX_FT = jft.FTConfig(op_deadline_s=0.5, max_retries=12,
                      backoff_base_s=0.005, backoff_cap_s=0.02)
ADAM_LR = 0.01
RTOL, ATOL = 1e-5, 1e-6  # the reference's fused-update tolerance

#: each package's roles (the JAX package's for the static reference runs)
PKGS = {
    "torch": dict(server=ParamServer, client=ParamClient, ctl=ShardController,
                  notice=PreemptionNotice, ft=FAST_FT, router=LocalRouter,
                  rules=trules, kw={"device": "cpu"}),
    "jax": dict(server=jps.ParamServer, client=jps.ParamClient,
                ctl=jsc.ShardController, notice=jft.PreemptionNotice, ft=JAX_FT,
                router=None, rules=jrules, kw={}),
}


def join_all(threads, timeout=60):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "role thread did not stop (hang)"


# ---------------------------------------------------------------------------
# lease semantics: retire vs crash


class TestLeaseRetire:
    def test_retired_is_terminal_and_never_expires(self):
        now = [0.0]
        reg = LeaseRegistry([0, 1], ttl_s=1.0, clock=lambda: now[0])
        for r in (0, 1):
            reg.arm(r, 0, heartbeats=True)
            reg.renew(r, 0)
        reg.retire(1)
        assert reg.state(1) == RETIRED and reg.gone(1)
        now[0] += 100.0
        # only the crash (rank 0) reads expired; the goodbye never does
        assert reg.expired() == [0]

    def test_admit_registers_for_stop_protocol(self):
        reg = LeaseRegistry([0])
        reg.stop(0)
        assert reg.all_done()
        reg.admit(5)
        assert not reg.all_done()
        reg.stop(5)
        assert reg.all_done()

    def test_retired_counts_as_done(self):
        reg = LeaseRegistry([0, 1])
        reg.stop(0)
        reg.retire(1)
        assert reg.all_done()


# ---------------------------------------------------------------------------
# gang harness: servers + controller threads, spawner for joiners


def launch_elastic(nservers, nclients, nspares=1, ckpt_dir=None, codec=None,
                   client_plans=None, client_ft=None, server_ft=None,
                   shards_per_server=2, grace_s=5.0, late_clients=0,
                   ctl_kwargs=None, pkg="torch", rule="add"):
    """Elastic shardctl topology over the in-process router: rank space
    is provisioned for spares and late clients up front (membership has
    a rank-space ceiling), but spares spawn only via the controller's
    spawner hook and late clients only when the test starts them."""
    P = PKGS[pkg]
    client_ft = client_ft or P["ft"]
    server_ft = server_ft or P["ft"]
    if pkg == "jax":
        from mpit_tpu.comm.local import LocalRouter as JaxRouter

        router = JaxRouter(nservers + nclients + nspares + late_clients + 1)
    else:
        router = LocalRouter(nservers + nclients + nspares + late_clients + 1)
    n = nservers + nclients + nspares + late_clients + 1
    sranks = list(range(nservers))
    cranks = list(range(nservers, nservers + nclients))
    late_ranks = list(range(nservers + nclients,
                            nservers + nclients + late_clients))
    ctl_rank = n - 1
    spares = list(range(nservers + nclients + late_clients, ctl_rank))
    servers, threads, notices = {}, {}, {}

    def make_server(r, joiner):
        notices[r] = P["notice"](grace_s=grace_s)
        # Launch members know only the launch clients (late ranks are
        # admission candidates); a joiner spawns after any admissions,
        # so it treats the whole provisioned client space as members.
        srule = P["rules"].make("adam", lr=ADAM_LR) if rule == "adam" else rule
        servers[r] = P["server"](
            r, cranks + late_ranks if joiner else list(cranks),
            router.endpoint(r), rule=srule, **P["kw"],
            ft=server_ft, controller_rank=ctl_rank, ckpt_dir=ckpt_dir,
            ckpt_interval=1e9, shardctl=joiner, preempt=notices[r],
            admit_ranks=late_ranks if not joiner else None)
        threads[r] = threading.Thread(target=servers[r].start, daemon=True)
        threads[r].start()

    for r in sranks:
        make_server(r, joiner=False)
    # The rebalance policy stays off (the scale verbs migrate by
    # themselves): a load window past its threshold could otherwise
    # propose a move at the last pump, after the servers stopped.
    policy = (jsc if pkg == "jax" else tsc).RebalancePolicy(enabled=False)
    ctl = P["ctl"](
        ctl_rank, router.endpoint(ctl_rank), sranks, cranks + late_ranks,
        spawner=lambda r: make_server(r, joiner=True), spare_ranks=spares,
        **{"policy": policy, **(ctl_kwargs or {})})
    clients = []
    for i, r in enumerate(cranks):
        ep = router.endpoint(r)
        plan = (client_plans or {}).get(i)
        if plan is not None:
            ep = FaultyTransport(ep, plan)
        clients.append(P["client"](
            r, sranks, ep, seed_servers=(r == cranks[0]), codec=codec,
            ft=client_ft, shardctl=True, controller_rank=ctl_rank,
            sc_shards_per_server=shards_per_server))
    return dict(router=router, servers=servers, threads=threads,
                notices=notices, ctl=ctl, clients=clients, sranks=sranks,
                cranks=cranks, late_ranks=late_ranks, spares=spares)


def start_clients(clients, w0):
    starters = []
    for i, c in enumerate(clients):
        p = w0.copy() if i == 0 else np.zeros_like(w0)
        starters.append(threading.Thread(
            target=c.start, args=(p, np.zeros_like(w0)), daemon=True))
        starters[-1].start()
    join_all(starters)


def finish(gang):
    clients, ctl = gang["clients"], gang["ctl"]
    clients[0].async_recv_param()
    clients[0].wait()
    out = clients[0].param.copy()
    for c in clients:
        c.stop()
    join_all(list(gang["threads"].values()))
    ctl.pump()
    assert ctl.done, "controller missed client STOPs"
    return out


_STATIC = {}


def static_run(w0, gtab, rounds, pkg="torch", **kw):
    """The membership-static run of one package, memoized per inputs."""
    key = (pkg, w0.tobytes(), gtab.tobytes(), rounds,
           tuple(sorted((k, str(v)) for k, v in kw.items())))
    if key not in _STATIC:
        _STATIC[key] = run_gang(w0, gtab, rounds, pkg=pkg, **kw)[0]
    return _STATIC[key]


def assert_static(out, w0, gtab, rounds, rule="add", **kw):
    """Bit for bit against the port's static run; against the JAX
    package's bit for bit (add) or within the fused-update tolerance
    (Adam, whose CPU rounding in XLA differs by an ulp here and there)."""
    np.testing.assert_array_equal(
        static_run(w0, gtab, rounds, rule=rule, **kw), out)
    jax_out = static_run(w0, gtab, rounds, pkg="jax", rule=rule, **kw)
    if rule == "adam":
        np.testing.assert_allclose(out, jax_out, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(jax_out, out)


def run_gang(w0, gtab, rounds, hook=None, **kw):
    gang = launch_elastic(2, 2, **kw)
    start_clients(gang["clients"], w0)
    gang["ctl"].pump()
    assert gang["ctl"].smap is not None
    for r in range(rounds):
        if hook is not None:
            hook(r, gang)
        for i, c in enumerate(gang["clients"]):
            c.grad[:] = gtab[i, r]
            c.async_send_grad()
            c.wait()
    out = finish(gang)
    return out, gang


def tables(size=64, rounds=8, nclients=2, seed=11):
    rng = np.random.default_rng(seed)
    w0 = rng.normal(size=size).astype(np.float32)
    gtab = rng.normal(size=(nclients, rounds, size)).astype(np.float32)
    return w0, gtab


def wait_for(cond, what, timeout=20.0, tick=None):
    t0 = time.monotonic()
    while not cond():
        if tick is not None:
            tick()
        assert time.monotonic() - t0 < timeout, what
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# scale events: bitwise transparency


class TestScaleEvents:
    def test_scale_down_drain_is_bitwise(self):
        """Drain-and-retire a server mid-run: final params bitwise equal
        to the static run; the retired rank exits cleanly as a goodbye,
        not a crash, and clients drop it from their stop fan-out."""
        w0, gtab = tables()

        def hook(r, gang):
            if r == 4:
                assert gang["ctl"].scale_down(0)
                gang["threads"][0].join(10)
                assert not gang["threads"][0].is_alive(), \
                    "retired server did not exit"
                assert gang["servers"][0].retired

        drained, gang = run_gang(w0, gtab, 8, hook=hook)
        assert_static(drained, w0, gtab, 8)
        assert gang["ctl"].retired == {0}
        assert gang["ctl"].leases.state(0) == RETIRED
        assert all(0 in c._sc_retired for c in gang["clients"]), \
            "clients never learned the retirement broadcast"
        assert gang["servers"][1].owned_shards == [0, 1, 2, 3]

    def test_scale_down_under_faults_and_int8_stays_bitwise(self):
        """The acceptance matrix: drop/dup plans on client data tags plus
        the int8 error-feedback codec, a drain mid-run — still bitwise
        (the residual telescope and per-shard dedup survive the owner
        changes)."""
        w0, gtab = tables(size=4096)
        static = static_run(w0, gtab, 8, codec="int8")

        def hook(r, gang):
            if r == 3:
                assert gang["ctl"].scale_down(1)

        plans = {i: FaultPlan(seed=i, drop_every=3, dup_every=4,
                              tags=DATA_TAGS) for i in range(2)}
        faulty, gang = run_gang(w0, gtab, 8, codec="int8", hook=hook,
                                client_plans=plans)
        # int8 only against the port's own static run: a JAX server
        # encoding a quantized snapshot would start the JAX package's
        # process-global pool in this test process.
        np.testing.assert_array_equal(static, faulty)
        assert sum(int(s.dup_ops) for s in gang["servers"].values()) > 0, \
            "no duplicate was ever admitted — the plan never bit"
        assert any(c.residual_norm() > 0 for c in gang["clients"])

    def test_scale_up_widens_and_scale_down_shrinks(self):
        """Grow onto a spawned joiner (shards migrate to it, clients
        greet it lazily), then drain it again — bitwise, with membership
        epoch and gauges tracking every change."""
        w0, gtab = tables()
        seen = {}

        def hook(r, gang):
            ctl = gang["ctl"]
            if r == 2:
                new = ctl.scale_up()
                seen["joiner"] = new
                assert len(ctl.smap.shards_of(new)) >= 1, \
                    "scale-up left the joiner shardless"
            if r == 6:
                assert ctl.scale_down(seen["joiner"])
                gang["threads"][seen["joiner"]].join(10)
                assert not gang["threads"][seen["joiner"]].is_alive()

        grown, gang = run_gang(w0, gtab, 8, hook=hook)
        assert_static(grown, w0, gtab, 8)
        ctl = gang["ctl"]
        assert ctl.membership_epoch == 2
        assert int(ctl._m_up.value) == 1 and int(ctl._m_down.value) == 1
        # the joiner was greeted by at least one client mid-run
        assert any(seen["joiner"] in c._sc_greeted
                   for c in gang["clients"])
        assert int(ctl._m_gang_srv.value) == 2  # back to two live servers

    def test_retired_rank_never_fails_over(self, tmp_path):
        """Retire-vs-crash: after a drain-and-retire, the retired rank's
        lease silence must NOT look like a death — no failover, no map
        churn (the goodbye already moved everything)."""
        now = [0.0]
        w0, gtab = tables()

        def hook(r, gang):
            ctl = gang["ctl"]
            now[0] += 1.0
            if r == 3:
                # Arm the lease with a real beat first, then retire.
                wait_for(lambda: ctl.leases.armed(0), "no beat arrived",
                         tick=ctl.pump)
                assert ctl.scale_down(0)
                version = ctl.smap.version
                failovers = int(ctl._m_fail.value)
                now[0] += 1000.0  # far past any TTL
                ctl.check_leases()
                assert int(ctl._m_fail.value) == failovers, \
                    "a retired rank was failed over"
                assert ctl.smap.version == version

        out, gang = run_gang(
            w0, gtab, 8, hook=hook, ckpt_dir=str(tmp_path),
            ctl_kwargs=dict(lease_ttl_s=5.0, clock=lambda: now[0]))
        assert_static(out, w0, gtab, 8)


# ---------------------------------------------------------------------------
# graceful preemption


class TestPreemption:
    def test_sigterm_handler_sets_flag_only(self):
        """The real signal: SIGTERM to self sets the notice flag (the
        handler's only act — MT-P204); grace accounting happens on the
        observing thread."""
        notice = PreemptionNotice(grace_s=2.0).install()
        try:
            os.kill(os.getpid(), signal.SIGTERM)
            wait_for(lambda: notice.notified, "handler never fired",
                     timeout=5)
            assert notice.poll()
            assert 0.0 <= notice.grace_remaining_s() <= 2.0
        finally:
            notice.restore()

    def test_preemption_notice_checkpoints_then_drains(self, tmp_path):
        """Notice -> checkpoint-on-notice (fresh: covers every applied
        grad) -> PREEMPT report -> controller drains gracefully ->
        retire.  Bitwise vs static, and the checkpoint on disk is
        stamped with the exact pre-notice apply count."""
        w0, gtab = tables()
        state = {}

        def hook(r, gang):
            ctl = gang["ctl"]
            if r == 4:
                victim = gang["servers"][1]
                applied_before = victim.grads_applied
                gang["notices"][1]._notified = True  # the handler's act
                wait_for(lambda: 1 in ctl.retired, "drain never happened",
                         tick=ctl.pump)
                gang["threads"][1].join(10)
                assert not gang["threads"][1].is_alive()
                state["applied"] = applied_before
                assert victim.ckpts_written >= 1, \
                    "checkpoint-on-notice never wrote"

        out, gang = run_gang(w0, gtab, 8, hook=hook,
                             ckpt_dir=str(tmp_path))
        assert_static(out, w0, gtab, 8)
        ctl = gang["ctl"]
        assert int(ctl._m_pre.value) == 1 and int(ctl._m_down.value) == 1
        assert gang["servers"][1].retired
        # Checkpoint freshness: the per-shard snapshots on disk carry
        # every apply the victim had done when the notice landed.
        ckpt_applied = sum(
            scmigrate.load_shard_state(str(tmp_path), sid).grads_applied
            for sid in (2, 3))  # server 1's boot-cut shards
        assert ckpt_applied >= state["applied"]

    def test_stingy_grace_skips_drain(self, tmp_path):
        """A notice under the drain threshold is recorded (events) but
        NOT drained — covering it is failover's job (replay from the
        checkpoint the notice just wrote)."""
        w0, gtab = tables()

        def hook(r, gang):
            ctl = gang["ctl"]
            if r == 4:
                gang["notices"][1]._notified = True
                wait_for(lambda: int(ctl._m_pre.value) == 1,
                         "notice never reached the controller",
                         tick=ctl.pump)
                assert 1 not in ctl.retired

        out, gang = run_gang(
            w0, gtab, 8, hook=hook, ckpt_dir=str(tmp_path), grace_s=0.05,
            ctl_kwargs=dict(preempt_drain_min_s=0.5))
        # grace too small for a drain: the victim kept serving (this
        # in-process harness never actually kills it), so the run is
        # still bitwise and the victim is still live at the end.
        assert_static(out, w0, gtab, 8)
        assert int(gang["ctl"]._m_down.value) == 0
        assert gang["servers"][1].ckpts_written >= 1


# ---------------------------------------------------------------------------
# late-client admission


class TestLateAdmission:
    def test_late_client_joins_mid_run(self):
        """A client outside the launch-time set announces mid-run
        (INIT v4 through the admission listener), trains alongside the
        original clients, and participates in the stop protocol — no
        gang restart."""
        w0, gtab = tables(rounds=6)
        gang = launch_elastic(2, 2, late_clients=1)
        start_clients(gang["clients"], w0)
        gang["ctl"].pump()
        late_rank = gang["late_ranks"][0]
        extra = np.ones((3, len(w0)), np.float32) * 0.5
        late = None
        for r in range(6):
            if r == 2:
                late = ParamClient(
                    late_rank, gang["sranks"],
                    gang["router"].endpoint(late_rank), ft=FAST_FT,
                    shardctl=True,
                    controller_rank=gang["ctl"].rank,
                    sc_shards_per_server=2)
                t = threading.Thread(
                    target=late.start,
                    args=(np.zeros_like(w0), np.zeros_like(w0)),
                    daemon=True)
                t.start()
                join_all([t])
                gang["clients"].append(late)
            for i, c in enumerate(gang["clients"]):
                if c is late:
                    grad = extra[min(r - 2, 2)] if r - 2 < 3 else None
                    if r - 2 >= 3:
                        continue
                    c.grad[:] = grad
                else:
                    c.grad[:] = gtab[i, r]
                c.async_send_grad()
                c.wait()
        out = finish(gang)
        want = w0 + gtab[:, :6].sum(axis=(0, 1)) + extra.sum(axis=0)
        np.testing.assert_allclose(out, want, rtol=1e-4)
        admits = sum(int(s._m_admits.value)
                     for s in gang["servers"].values())
        assert admits == len(gang["servers"]), \
            "every server should admit the late client exactly once"


class TestReaderRetirement:
    @pytest.mark.parametrize("reader_pkg", ["torch", "jax"])
    def test_goodbye_reroutes_reader_to_successor(self, reader_pkg):
        """Read-replica pair: both port servers hold the full vector; the
        reader attaches to server 0.  Retirement answers reads with
        GOODBYE(successor=1); the reader (of either package) re-attaches
        and keeps reading — no RetryExhausted, retry budget untouched."""
        from mpit_tpu.comm.local import LocalRouter as JaxRouter
        from mpit_tpu_torch.ps import ReaderClient

        n = 16
        router = JaxRouter(5)  # 0,1 servers; 2,3 writers; 4 reader
        servers = [ParamServer(r, [w], router.endpoint(r), rule="add", ft=FAST_FT,
                               device="cpu", reader_ranks=[4])
                   for r, w in ((0, 2), (1, 3))]
        threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
        for t in threads:
            t.start()
        w = np.arange(n, dtype=np.float32)
        writers = [ParamClient(r, [s], router.endpoint(r), seed_servers=True, ft=FAST_FT)
                   for r, s in ((2, 0), (3, 1))]
        starters = [threading.Thread(target=wr.start, args=(w.copy(), np.zeros_like(w)),
                                     daemon=True) for wr in writers]
        for t in starters:
            t.start()
        join_all(starters)
        reader_cls, ft = ((ReaderClient, FAST_FT) if reader_pkg == "torch"
                          else (jps.ReaderClient, JAX_FT))
        reader = reader_cls(4, [0], router.endpoint(4), ft=ft)
        mirror = np.zeros(n, np.float32)
        reader.start(mirror)
        reader.read_params()
        np.testing.assert_array_equal(mirror, w)
        servers[0].retire_serving(successor=1)
        mirror[:] = 0
        reader.read_params()  # GOODBYE -> re-attach at 1 -> served
        np.testing.assert_array_equal(mirror, w)
        assert int(reader._m_reroutes.value) == 1
        assert reader._route == {0: 1} and reader.retries == 0
        mirror[:] = 0
        reader.read_params()  # later reads go straight to 1
        np.testing.assert_array_equal(mirror, w)
        assert int(reader._m_reroutes.value) == 1
        reader.stop()
        for wr in writers:
            wr.stop()
        join_all(threads)
        assert servers[0].params_served == 1 and servers[1].params_served == 2


# ---------------------------------------------------------------------------
# operator-driven scaling: the statusd /scale route


class TestScaleRoute:
    def test_scale_route_queues_and_pump_executes(self):
        """GET /scale?op=down&rank=0 on the controller's endpoint queues
        the request (HTTP thread) and pump() executes it (control
        thread) — the wiring an operator uses mid-run."""
        from mpit_tpu_torch.obs import statusd

        w0, gtab = tables()
        gang = launch_elastic(2, 2)
        start_clients(gang["clients"], w0)
        ctl = gang["ctl"]
        ctl.pump()
        server = statusd.StatusServer(0)  # ephemeral port
        statusd.register_action("scale", ctl._scale_action)
        try:
            base = f"http://127.0.0.1:{server.port}"
            with urllib.request.urlopen(f"{base}/scale?op=down&rank=0",
                                        timeout=5) as resp:
                import json

                body = json.loads(resp.read())
            assert body["queued"] == {"op": "down", "rank": "0"}
            with urllib.request.urlopen(f"{base}/scale?op=sideways",
                                        timeout=5) as resp:
                assert b"error" in resp.read()
            for r in range(4):
                for i, c in enumerate(gang["clients"]):
                    c.grad[:] = gtab[i, r]
                    c.async_send_grad()
                    c.wait()
                ctl.pump()
            wait_for(lambda: 0 in ctl.retired, "queued scale-down never ran",
                     tick=ctl.pump)
            finish(gang)
        finally:
            statusd.clear_providers()
            server.close()


# ---------------------------------------------------------------------------
# the fast chaos soak: >= 3 membership changes, bitwise, bounded


class TestChaosSoak:
    @pytest.mark.parametrize("rule", ["add", "adam"])
    def test_soak_grow_shrink_preempt_is_bitwise(self, tmp_path, rule, monkeypatch):
        """The §9 proof in miniature: mid-DOWNPOUR-shaped lockstep the
        gang (a) grows onto a spawned joiner, (b) drain-shrinks an
        original server, (c) absorbs a graceful preemption of another —
        three membership changes, ending on a gang whose only server is
        the mid-run joiner.  Final params bitwise-equal the static run
        (exactly-once held across every owner change) and every stage
        completed inside its bound (no hang)."""
        w0, gtab = tables(rounds=10, seed=23)
        static_run(w0, gtab, 10, rule=rule)
        calls = [0]
        real = fu.fused_adam_reference

        def counted(*a, **kw):
            calls[0] += 1
            return real(*a, **kw)

        monkeypatch.setattr(fu, "fused_adam_reference", counted)
        joiner = {}

        def hook(r, gang):
            ctl = gang["ctl"]
            if r == 2:
                joiner["rank"] = ctl.scale_up()
            if r == 5:
                assert ctl.scale_down(0)
                gang["threads"][0].join(10)
                assert not gang["threads"][0].is_alive()
            if r == 8:
                gang["notices"][1]._notified = True
                wait_for(lambda: 1 in ctl.retired, "preempt drain hung",
                         tick=ctl.pump)
                gang["threads"][1].join(10)
                assert not gang["threads"][1].is_alive()

        out, gang = run_gang(w0, gtab, 10, hook=hook,
                             ckpt_dir=str(tmp_path), rule=rule)
        applied = sum(s.grads_applied for s in gang["servers"].values())
        assert applied == 2 * 10 * 4  # 2 clients x 10 rounds x 4 shards
        if rule == "adam":
            # K3 (its plain twin here) ran once per admitted GRAD, summed
            # over the original servers and the joiner.
            assert calls[0] == applied, (calls[0], applied)
        assert_static(out, w0, gtab, 10, rule=rule)
        ctl = gang["ctl"]
        events = {"up": int(ctl._m_up.value),
                  "down": int(ctl._m_down.value),
                  "preempt": int(ctl._m_pre.value)}
        assert events == {"up": 1, "down": 2, "preempt": 1}
        assert ctl.membership_epoch == 3
        # the whole vector ended up on the joiner
        assert gang["servers"][joiner["rank"]].owned_shards == [0, 1, 2, 3]
        assert int(ctl._m_gang_srv.value) == 1




# ---------------------------------------------------------------------------
# process gangs: launch --shardctl, and the slow soak's twin


def _tcp_addrs(n):
    from mpit_tpu_torch.comm.tcp import allocate_local_addresses

    addrs, socks = allocate_local_addresses(n)
    for s in socks:
        s.close()
    return ",".join(addrs)


def test_launch_shardctl_process_gang():
    """``launch --np 5 --shardctl 1 --opt adam`` as five processes on the
    CPU: the last rank is the controller, the final map tiles the vector
    with each shard owned by one server, and the servers' applies are
    every worker step on every shard, each counted once (the controller's
    rebalance policy may move a shard under load: the counts hold across
    owners)."""
    from mpit_tpu_torch.train.launch import LAUNCH_DEFAULTS, launch_processes

    cfg = LAUNCH_DEFAULTS.merged(np=5, opt="adam", lr=0.01, epochs=1, batch=64,
                                 side=8, device="cpu", shardctl=True,
                                 ft_op_deadline_s=5.0)
    results = launch_processes(cfg, timeout=300)
    roles = {r: v["role"] for r, v in results.items()}
    assert roles == {0: "server", 1: "worker", 2: "server", 3: "worker",
                     4: "controller"}
    smap = results[4]["map"]
    assert [(sid, off, size) for sid, off, size, _o in smap] == [(0, 0, 325),
                                                                (1, 325, 325)]
    owned = {sid: r for r in (0, 2) for sid in results[r]["owned_shards"]}
    assert owned == {sid: owner for sid, _off, _size, owner in smap}
    steps = sum(results[r]["steps"] for r in (1, 3))
    assert sum(results[r]["grads_applied"] for r in (0, 2)) == 2 * steps > 0
    assert all(results[r]["final_test_err"] < 0.9 for r in (1, 3))


@pytest.mark.slow
def test_launch_elastic_preemption_soak(tmp_path, monkeypatch):
    """np=5 (2s/2c/1ctl) + 1 spare DOWNPOUR gang over TCP via
    ``--elastic``: the supervisor SIGTERMs server rank 2 mid-run with a
    grace window; the rank checkpoints on notice, reports PREEMPT, the
    controller drains it through live migration and marks it retired in
    the scale mailbox, and the run converges on the surviving membership.
    Sized for ``import torch`` at each child's start."""
    from mpit_tpu_torch.train.launch import LAUNCH_DEFAULTS, launch_processes

    monkeypatch.setenv("MPIT_TCP_RECONNECT_S", "60")
    cfg = LAUNCH_DEFAULTS.merged(
        np=5, opt="downpour", lr=0.2, su=1, epochs=300, batch=64, side=8,
        master_freq=2, device_policy="cpu", device="cpu", transport="tcp",
        tcp_addrs=_tcp_addrs(6), ft_heartbeat_s=0.25, ft_lease_ttl_s=30.0,
        ft_op_deadline_s=5.0, supervise=2, server_ckpt_dir=str(tmp_path),
        server_ckpt_interval=2.0, elastic=True, elastic_spares=1,
        elastic_grace_s=25.0, elastic_shards_per_server=2,
        shardctl_lease_ttl_s=30.0)
    results = launch_processes(cfg, timeout=600, chaos=dict(
        chaos_kill_rank=2, chaos_kill_after_s=30.0, chaos_signal=signal.SIGTERM,
        chaos_grace_s=25.0))
    roles = {r: v["role"] for r, v in results.items()}
    assert roles[4] == "controller"
    assert roles[1] == roles[3] == "worker"
    ctl = results[4]
    assert ctl["elastic_events"]["preempt"] >= 1, ctl
    assert ctl["elastic_events"]["down"] >= 1, ctl
    workers = [v for v in results.values() if v["role"] == "worker"]
    assert all(w["final_test_err"] < 0.8 for w in workers)
