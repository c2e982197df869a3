"""Shard control of the port (``mpit_tpu_torch.shardctl``) against the JAX
package's, a twin of ``tests/test_shardctl.py``.

- Pure host logic (the weighted cut, the map, the policy, the wire): the
  port's answers equal the JAX package's on the same seeded inputs, byte for
  byte where bytes exist (``ShardMap.to_wire``, INIT v4, the 32-byte header
  and the reply frames, the SHARD_STATE messages with the param leg above
  and below ``MPIT_SC_CHUNK_BYTES``, ``shard<id>_latest.npz`` read by each
  package from the other's).
- Gangs on the CPU: 2 servers, 2 lockstep clients and the controller as
  threads over one in-process router.  The static, live-migration,
  drop/dup, int8 and lease-expiry failover gangs of the reference end bit
  for bit equal to the static map, and to the all-JAX static gang.  Under
  ``rule="adam"`` the migrated and the failed-over gangs end bit for bit
  equal to the port's static Adam gang and to a rollout of the port's rule,
  and K3's plain twin runs exactly once per admitted GRAD, summed over the
  owners.  Against the JAX package's Adam gang they hold the reference's
  fused-update tolerance (rtol 1e-5, atol 1e-6), as
  ``tests/test_torch_rules.py`` does: on the CPU the JAX rule runs through
  XLA, whose Adam rounds a few elements differently by an ulp from the
  step-by-step rounding that K3 and its twin keep.
- Mixed gangs: port clients with a JAX controller and JAX servers, the
  reverse, and a shard migrated from a JAX server to a port server and
  back; each ends bitwise equal to the all-JAX gang.  Only codec ``none``
  meets a JAX server in this process (a JAX server encoding a quantized
  snapshot starts the JAX package's process-global pool).

The twins wait on state with a bound of seconds, never on a sleep, and run
the controller with its rebalance policy off unless the test is the
policy's: the reference's harness leaves it on, and a load window past its
threshold can propose a migration at the last ``pump()``, after the
servers stopped (ROADMAP §C).
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import mpit_tpu.ft as jft
import mpit_tpu.ps as jps
import mpit_tpu.shardctl as jsc
from mpit_tpu.comm.local import LocalRouter as JaxRouter
from mpit_tpu.optim import rules as jrules
from mpit_tpu.ps.sharding import weighted_layout as j_weighted_layout
from mpit_tpu.shardctl import migrate as jmigrate
from mpit_tpu.shardctl import wire as jwire
from mpit_tpu_torch import ft
from mpit_tpu_torch import shardctl as tsc
from mpit_tpu_torch.comm.local import LocalRouter
from mpit_tpu_torch.ops import fused_update as fu
from mpit_tpu_torch.optim import rules as trules
from mpit_tpu_torch.ps import ParamClient, ParamServer, Shard, tags
from mpit_tpu_torch.ps.sharding import weighted_layout
from mpit_tpu_torch.shardctl import (
    RebalancePolicy,
    ShardController,
    ShardLoad,
    ShardMap,
)
from mpit_tpu_torch.shardctl import migrate as tmigrate
from mpit_tpu_torch.shardctl import wire as scwire

torch.set_num_threads(1)

DATA_TAGS = frozenset({tags.GRAD, tags.PARAM_REQ, tags.PARAM_PUSH})
REPLY_TAGS = frozenset({tags.GRAD_ACK, tags.PARAM, tags.PARAM_PUSH_ACK})
ADAM_LR = 0.01
RTOL, ATOL = 1e-5, 1e-6  # the reference's fused-update tolerance


def adam_rollout(w0, gtab, rounds=6, nservers=2):
    """The port's Adam rule applied shard by shard in the lockstep order."""
    out = w0.copy()
    for shard in ShardMap.initial(len(w0), list(range(nservers))).entries:
        lo, hi = shard.shard.offset, shard.shard.end
        rule = trules.make("adam", lr=ADAM_LR)
        p = torch.from_numpy(w0[lo:hi].copy())
        st = rule.init(p)
        for r in range(rounds):
            for i in range(gtab.shape[0]):
                rule.apply(p, torch.from_numpy(gtab[i, r, lo:hi].copy()), st)
        out[lo:hi] = p.numpy()
    return out


def assert_near_jax_adam(out):
    np.testing.assert_allclose(out, static_run("jax", rule="adam"), rtol=RTOL, atol=ATOL)


def fast_ft(pkg_ft, **kw):
    base = dict(op_deadline_s=0.5, max_retries=12, backoff_base_s=0.005,
                backoff_cap_s=0.02)
    base.update(kw)
    return pkg_ft.FTConfig(**base)


PKGS = {
    "torch": dict(ft=ft, server=ParamServer, client=ParamClient,
                  ctl=ShardController, router=LocalRouter),
    "jax": dict(ft=jft, server=jps.ParamServer, client=jps.ParamClient,
                ctl=jsc.ShardController, router=JaxRouter),
}


def rule_for(pkg, rule):
    if rule == "adam":
        return (trules if pkg == "torch" else jrules).make("adam", lr=ADAM_LR)
    return rule


def join_all(threads, timeout=60):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "role thread did not stop (hang)"


def wait_for(cond, what, timeout=20.0, tick=None):
    t0 = time.monotonic()
    while not cond():
        if tick is not None:
            tick()
        assert time.monotonic() - t0 < timeout, what
        time.sleep(0.01)


class K3Count:
    """Counts the calls of K3's plain twin (what the slot apply runs on the
    CPU) by wrapping it in the module ``fused_adam`` reads it from."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = fu.fused_adam_reference

        def counted(*a, **kw):
            self.calls += 1
            return real(*a, **kw)

        monkeypatch.setattr(fu, "fused_adam_reference", counted)


# ---------------------------------------------------------------------------
# weighted_layout


class TestWeightedLayout:
    def _check_invariants(self, plong, shards):
        assert shards and shards[0].offset == 0
        for prev, cur in zip(shards, shards[1:]):
            assert cur.offset == prev.end
        assert shards[-1].end == plong
        assert all(s.size >= 1 for s in shards)

    def test_property_sweep(self):
        rng = np.random.default_rng(1234)
        for _ in range(300):
            n = int(rng.integers(1, 9))
            plong = int(rng.integers(n, 5000))
            weights = rng.uniform(0.01, 10.0, size=n).tolist()
            shards = weighted_layout(plong, weights)
            self._check_invariants(plong, shards)
            assert [tuple(s) for s in shards] == [
                tuple(s) for s in j_weighted_layout(plong, weights)]

    def test_proportionality(self):
        assert weighted_layout(1000, [1.0, 3.0]) == [Shard(0, 250), Shard(250, 750)]

    def test_remainder_goes_to_heaviest(self):
        shards = weighted_layout(1001, [3.0, 1.0, 5.0])
        assert sum(s.size for s in shards) == 1001 and shards[2].size == 557

    def test_tiny_plong_keeps_everyone_nonempty(self):
        self._check_invariants(3, weighted_layout(3, [100.0, 0.01, 0.01]))

    def test_errors(self):
        for args in ((2, [1.0, 1.0, 1.0]), (10, []), (10, [1.0, -1.0])):
            with pytest.raises(ValueError):
                weighted_layout(*args)


# ---------------------------------------------------------------------------
# ShardMap


class TestShardMap:
    def test_initial_matches_shard_layout(self):
        m = ShardMap.initial(10, [0, 1, 2])
        assert [e.shard for e in m.entries] == [Shard(0, 3), Shard(3, 3), Shard(6, 4)]
        assert m.version == 0 and m.owners() == [0, 1, 2]

    def test_weighted_initial(self):
        m = ShardMap.initial(100, [5, 7], weights=[1.0, 3.0])
        assert m.entry(1).shard.size == 75 and m.owner(1) == 7

    def test_moved_bumps_version_only(self):
        m = ShardMap.initial(10, [0, 1])
        m2 = m.moved(1, 0)
        assert (m2.version, m2.owner(1)) == (1, 0)
        assert m.version == 0 and m.owner(1) == 1
        assert [e.shard for e in m2.entries] == [e.shard for e in m.entries]

    def test_reassigned_spreads_over_survivors(self):
        m2 = ShardMap.initial(30, [0, 1, 2]).moved(0, 1)
        m3 = m2.reassigned(1, [0, 2])
        assert m3.version == m2.version + 1
        assert {m3.owner(0), m3.owner(1)} <= {0, 2}
        assert max(len(m3.shards_of(r)) for r in (0, 2)) == 2
        j3 = jsc.ShardMap.initial(30, [0, 1, 2]).moved(0, 1).reassigned(1, [0, 2])
        assert m3.to_wire().tobytes() == j3.to_wire().tobytes()

    def test_wire_roundtrip(self):
        m = ShardMap.initial(1000, [3, 5, 9]).moved(2, 3)
        assert ShardMap.from_wire(m.to_wire()) == m
        with pytest.raises(ValueError):
            ShardMap.from_wire(np.asarray([1, 2, 3, 4], np.int64))

    def test_tiling_validated(self):
        from mpit_tpu_torch.shardctl.shardmap import ShardEntry

        with pytest.raises(ValueError, match="tile"):
            ShardMap(0, 10, [ShardEntry(0, Shard(0, 4), 0), ShardEntry(1, Shard(5, 5), 1)])

    @pytest.mark.parametrize("plong,owners,weights,moves", [
        (10, [0, 1, 2], None, [(1, 0)]),
        (544522, [0, 2], None, [(1, 0), (0, 2)]),
        (1001, [4, 6, 8], [3.0, 1.0, 5.0], [(2, 4)]),
        (4096, [0, 0, 2, 2], None, [(3, 0), (0, 2), (1, 2)]),
    ])
    def test_to_wire_bytes_equal_the_jax_maps(self, plong, owners, weights, moves):
        m = ShardMap.initial(plong, owners, weights=weights)
        j = jsc.ShardMap.initial(plong, owners, weights=weights)
        for sid, dst in moves:
            assert m.to_wire().tobytes() == j.to_wire().tobytes()
            m, j = m.moved(sid, dst), j.moved(sid, dst)
        assert m.to_wire().tobytes() == j.to_wire().tobytes()
        assert ShardMap.from_wire(j.to_wire()) == m


# ---------------------------------------------------------------------------
# policy


class TestRebalancePolicy:
    def _loads(self, cls, busy):
        return {rank: {sid: cls(ops=10, busy_s=b) for sid, b in shards.items()}
                for rank, shards in busy.items()}

    @pytest.mark.parametrize("kw,busy,want", [
        (dict(ratio=3.0, min_busy_s=0.01), {0: {0: 1.0}, 1: {1: 0.1}}, (0, 1)),
        (dict(ratio=3.0, min_busy_s=0.5), {0: {0: 0.4}, 1: {1: 0.01}}, None),
        (dict(ratio=3.0, min_busy_s=0.01), {0: {0: 1.0}, 1: {1: 0.9}}, None),
        (dict(enabled=False), {0: {0: 9.0}, 1: {1: 0.0}}, None),
    ], ids=["hot_to_cold", "quiet_window", "balanced", "disabled"])
    def test_proposals_equal_the_jax_policy(self, kw, busy, want):
        m = ShardMap.initial(100, [0, 1])
        got = RebalancePolicy(**kw).propose(m, self._loads(ShardLoad, busy))
        jgot = jsc.RebalancePolicy(**kw).propose(
            jsc.ShardMap.initial(100, [0, 1]), self._loads(jsc.ShardLoad, busy))
        assert got == jgot == want

    def test_seeded_windows_replay_equal(self):
        rng = np.random.default_rng(5)
        m = ShardMap.initial(400, [0, 1, 2, 3])
        jm = jsc.ShardMap.initial(400, [0, 1, 2, 3])
        pol = RebalancePolicy(ratio=2.0, min_busy_s=0.05, cooldown_s=0.0)
        jpol = jsc.RebalancePolicy(ratio=2.0, min_busy_s=0.05, cooldown_s=0.0)
        for _ in range(200):
            busy = {r: {r: float(rng.exponential(0.5))} for r in range(4)}
            assert pol.propose(m, self._loads(ShardLoad, busy)) == jpol.propose(
                jm, self._loads(jsc.ShardLoad, busy))


# ---------------------------------------------------------------------------
# the wire, byte for byte


class TestWireBytes:
    def test_init_v4_bytes(self):
        m = ShardMap.initial(544522, [0, 2]).moved(1, 0)
        jm = jsc.ShardMap.initial(544522, [0, 2]).moved(1, 0)
        for codec_id, epoch, flags in ((0, 0, 5), (2, 3, 7), (1, 1, 5)):
            got = scwire.init_v4(codec_id, epoch, flags, m)
            assert got.tobytes() == jwire.init_v4(codec_id, epoch, flags, jm).tobytes()
            assert got[0] == -1
            c, e, f, back = jwire.parse_init_v4(got)
            assert (c, e, f) == (codec_id, epoch, flags) and back.version == 1

    def test_header_and_reply_frames(self):
        buf = np.zeros(scwire.SC_HDR_BYTES + 16, np.uint8)
        jbuf = np.zeros_like(buf)
        scwire.pack_sc_header(buf, 2, 17, 3, 1)
        jwire.pack_sc_header(jbuf, 2, 17, 3, 1)
        assert buf.tobytes() == jbuf.tobytes()
        assert scwire.unpack_sc_header(jbuf) == (2, 17, 3, 1)
        assert scwire.sc_header(1, 2, 3, 4).tobytes() == jwire.sc_header(1, 2, 3, 4).tobytes()
        body = np.arange(10, dtype=np.float32)
        m = ShardMap.initial(64, [0, 1])
        jm = jsc.ShardMap.initial(64, [0, 1])
        for status, b, jb in ((scwire.OK, None, None), (scwire.OK, body, body),
                              (scwire.NACK_MAP, m.to_wire(), jm.to_wire()),
                              (scwire.BUSY, m.to_wire(), jm.to_wire())):
            got = scwire.reply_frame(1, 9, status, 0, body=b)
            assert got.tobytes() == jwire.reply_frame(1, 9, status, 0, body=jb).tobytes()
            e, s, st, sid, rb = scwire.parse_reply(got.tobytes())
            assert (e, s, st, sid) == (1, 9, status, 0)
        for kind in (scwire.INSTALL, scwire.RELEASE, scwire.ACQUIRE, scwire.ADOPT,
                     scwire.DONE, scwire.RETIRE, scwire.RETIRED, scwire.PREEMPT):
            got = scwire.map_update(kind, 1, 2, m)
            assert got.tobytes() == jwire.map_update(kind, 1, 2, jm).tobytes()
            assert scwire.parse_map_update(got.tobytes())[:3] == (kind, 1, 2)

    def test_tags_match_the_jax_table(self):
        from mpit_tpu.ps import tags as jtags

        for name in ("MAP_UPDATE", "SHARD_PULL", "SHARD_STATE", "DIFF", "DIFF_REQ"):
            assert getattr(tags, name) == getattr(jtags, name)
            assert tags.TAG_PAIRS[name] == jtags.TAG_PAIRS[name]
        for name in ("REDUCE", "REDUCE_ACK"):
            assert not hasattr(tags, name)  # aggregation: a later slice


def _slot_pair(size, rule, seed=3, applies=3):
    """The same shard state as a port slot (tensors) and a JAX slot."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=size).astype(np.float32)
    tslot = tmigrate.ShardSlot(1, 5, size)
    jslot = jmigrate.ShardSlot(1, 5, size)
    tslot.param = torch.from_numpy(p.copy())
    tr = rule_for("torch", rule)
    tslot.rule_state = tr.init(tslot.param) if rule == "adam" else {}
    for _ in range(applies):
        g = torch.from_numpy(rng.normal(size=size).astype(np.float32))
        if rule == "adam":
            tslot.param, tslot.rule_state = tr.apply(tslot.param, g, tslot.rule_state)
        tslot.committed()
    tslot.grads_applied = applies
    tslot.dedup.admit(7, tags.GRAD, 0, 1)
    jslot.param = tmigrate.host_copy(tslot.param)
    jslot.rule_state = ({k: tmigrate.host_copy(v) for k, v in tslot.rule_state.items()}
                        or None)
    jslot.snap_version, jslot.grads_applied = tslot.snap_version, applies
    jslot.dedup.admit(7, tags.GRAD, 0, 1)
    return tslot, jslot


class TestShardStateBytes:
    @pytest.mark.parametrize("rule", ["add", "adam"])
    @pytest.mark.parametrize("chunk", [0, 1024, 4096, 1 << 20])
    def test_shard_state_messages_equal(self, rule, chunk):
        """Param leg unchunked (0, or above the shard's 8,000 bytes) and
        chunked below it: every message equals the JAX package's."""
        tslot, jslot = _slot_pair(2000, rule)
        got = tmigrate.pack_shard_state(tslot, chunk_bytes=chunk)
        want = jmigrate.pack_shard_state(jslot, chunk_bytes=chunk)
        assert len(got) == len(want)
        assert len(got) == 2 + (len(jslot.rule_state or {})) + (
            (8000 + chunk - 1) // chunk - 1 if 0 < chunk < 8000 else 0)
        for a, b in zip(got, want):
            assert a.tobytes() == b.tobytes()

    @pytest.mark.parametrize("chunk_env", ["1024", "1048576"])
    def test_env_chunk_cut_and_roundtrip_across_packages(self, chunk_env, monkeypatch):
        """MPIT_SC_CHUNK_BYTES below and above the shard: each package's
        recv_shard_state reads the other's sequence into the same state
        (Adam's t a 0-d int32)."""
        monkeypatch.setattr(tmigrate, "SC_CHUNK_BYTES", int(chunk_env))
        monkeypatch.setattr(jmigrate, "SC_CHUNK_BYTES", int(chunk_env))
        tslot, jslot = _slot_pair(2000, "adam")
        import mpit_tpu.aio as jaio
        import mpit_tpu_torch.aio as taio

        for src, recv, aio in (
                (tmigrate.pack_shard_state(tslot), jmigrate.recv_shard_state, jaio),
                (jmigrate.pack_shard_state(jslot), tmigrate.recv_shard_state, taio)):
            router = JaxRouter(2)
            for msg in src:
                router.endpoint(0).send(msg, 1, tags.SHARD_STATE)
            sched, LiveFlag = aio.Scheduler(), aio.LiveFlag
            box = {}

            def run():
                box["slot"] = yield from recv(router.endpoint(1), 0, LiveFlag())

            sched.spawn(run(), name="recv")
            sched.wait()
            slot = box["slot"]
            np.testing.assert_array_equal(np.asarray(slot.param), jslot.param)
            for k, v in jslot.rule_state.items():
                got = np.asarray(slot.rule_state[k])
                assert got.dtype == v.dtype and got.shape == v.shape
                np.testing.assert_array_equal(got, v)
            assert slot.rule_state["t"].shape == () and slot.rule_state["t"].dtype == np.int32
            assert slot.dedup.state() == jslot.dedup.state()
            assert (slot.snap_version, slot.grads_applied) == (3, 3)

    def test_shard_checkpoint_read_by_each_package(self, tmp_path):
        tslot, jslot = _slot_pair(777, "adam")
        tmigrate.save_shard_state(tmp_path / "t", tslot, rank=0)
        jmigrate.save_shard_state(tmp_path / "j", jslot, rank=0)
        for d, load in ((tmp_path / "t", jmigrate.load_shard_state),
                        (tmp_path / "j", tmigrate.load_shard_state)):
            slot = load(str(d), 1)
            np.testing.assert_array_equal(np.asarray(slot.param), jslot.param)
            for k, v in jslot.rule_state.items():
                got = np.asarray(slot.rule_state[k])
                assert (got.dtype, got.shape) == (v.dtype, v.shape)
                np.testing.assert_array_equal(got, v)
            assert slot.dedup.state() == jslot.dedup.state()
            assert (slot.offset, slot.size, slot.grads_applied) == (5, 777, 3)


# ---------------------------------------------------------------------------
# gang harness


def launch_sc(nservers, nclients, size, server_pkgs=None, ctl_pkg="torch",
              client_pkg="torch", ckpt_dir=None, codec=None, client_plans=None,
              server_plan=None, rule="add", client_ft=None, server_ft=None,
              ctl_kwargs=None):
    """Servers + controller threads over one in-process router, clients
    driven by the test in lockstep turns.  ``server_pkgs`` names each
    server's package; a mixed gang rides the JAX router."""
    server_pkgs = list(server_pkgs or ["torch"] * nservers)
    pkgs = set(server_pkgs) | {ctl_pkg, client_pkg}
    n = nservers + nclients + 1
    router = (LocalRouter if pkgs == {"torch"} else JaxRouter)(n)
    sranks = list(range(nservers))
    cranks = list(range(nservers, nservers + nclients))
    ctl_rank = n - 1
    servers, threads = [], []
    for r, pkg in zip(sranks, server_pkgs):
        P = PKGS[pkg]
        ep = router.endpoint(r)
        if server_plan is not None:
            ep = P["ft"].FaultyTransport(ep, server_plan(P["ft"]))
        kw = {"device": "cpu"} if pkg == "torch" else {}
        servers.append(P["server"](
            r, cranks, ep, rule=rule_for(pkg, rule),
            ft=server_ft(P["ft"]) if server_ft else fast_ft(P["ft"]),
            controller_rank=ctl_rank, ckpt_dir=ckpt_dir, ckpt_interval=1e9, **kw))
        threads.append(threading.Thread(target=servers[-1].start, daemon=True))
    for t in threads:
        t.start()
    # The rebalance policy is off unless a test brings its own: a window's
    # busy report could otherwise propose a move at the final pump, after
    # the servers stopped (a 60 s wait for a DONE that never comes).
    policy = (jsc if ctl_pkg == "jax" else tsc).RebalancePolicy(enabled=False)
    ctl = PKGS[ctl_pkg]["ctl"](ctl_rank, router.endpoint(ctl_rank), sranks, cranks,
                               **{"policy": policy, **(ctl_kwargs or {})})
    C = PKGS[client_pkg]
    clients = []
    for i, r in enumerate(cranks):
        ep = router.endpoint(r)
        plan = (client_plans or {}).get(i)
        if plan is not None:
            ep = C["ft"].FaultyTransport(ep, plan(C["ft"]))
        clients.append(C["client"](
            r, sranks, ep, seed_servers=(r == cranks[0]), codec=codec,
            ft=client_ft(C["ft"]) if client_ft else fast_ft(C["ft"]),
            shardctl=True, controller_rank=ctl_rank))
    return servers, clients, threads, ctl


def start_clients(clients, w0):
    starters = []
    for c in clients:
        p = w0.copy() if not starters else np.zeros_like(w0)
        starters.append(threading.Thread(target=c.start, args=(p, np.zeros_like(w0)),
                                         daemon=True))
        starters[-1].start()
    join_all(starters)


def lockstep(clients, gtab, rounds, hook=None):
    for r in range(rounds):
        if hook is not None:
            hook(r)
        for i, c in enumerate(clients):
            c.grad[:] = gtab[i, r]
            c.async_send_grad()
            c.wait()


def finish(clients, threads, ctl):
    clients[0].async_recv_param()
    clients[0].wait()
    out = clients[0].param.copy()
    for c in clients:
        c.stop()
    join_all(threads)
    ctl.pump()
    assert ctl.done, "controller missed client STOPs"
    return out


def tables(size=48, rounds=6, nclients=2, seed=7):
    rng = np.random.default_rng(seed)
    w0 = rng.normal(size=size).astype(np.float32)
    gtab = rng.normal(size=(nclients, rounds, size)).astype(np.float32)
    return w0, gtab


def run_sc(w0, gtab, rounds, hook=None, **kw):
    servers, clients, threads, ctl = launch_sc(2, 2, len(w0), **kw)
    start_clients(clients, w0)
    ctl.pump()  # adopt the seeder's initial map
    assert ctl.smap is not None and ctl.smap.version == 0
    lockstep(clients, gtab, rounds,
             hook=(lambda r: hook(r, ctl, servers, threads)) if hook else None)
    live = [t for i, t in enumerate(threads) if servers[i].live.on or t.is_alive()]
    out = finish(clients, live, ctl)
    return out, servers, clients, ctl


_STATIC = {}


def static_run(pkg, rule="add", codec=None, size=48):
    """The fault-free static-map gang of one package (memoized)."""
    key = (pkg, rule, codec, size)
    if key not in _STATIC:
        w0, gtab = tables(size=size)
        _STATIC[key] = run_sc(w0, gtab, 6, server_pkgs=[pkg, pkg], ctl_pkg=pkg,
                              client_pkg=pkg, rule=rule, codec=codec)[0]
    return _STATIC[key]


def migrate_at(rnd, sid, dst):
    def hook(r, ctl, servers, threads):
        if r == rnd:
            assert ctl.migrate(sid, dst)
    return hook


def failover_hook(tmp_path, now, killed):
    """The dead-server path: a beat arms the controller's lease on server 1,
    then at a quiesced turn boundary it checkpoints and dies, the clock
    jumps past the TTL while server 0 keeps beating, and failover ADOPTs
    its shard on server 0."""
    def hook(r, ctl, servers, threads):
        now[0] += 1.0
        if r != 3:
            return
        wait_for(lambda: ctl.leases._expiry.get(1) is not None, "no beat arrived",
                 tick=ctl.pump)
        servers[1].save_state(str(tmp_path))
        servers[1].live.stop()
        threads[1].join(10)
        assert not threads[1].is_alive()
        killed.append(1)
        ctl._drain_beats()
        now[0] += 100.0
        wait_for(lambda: not (ctl.leases._expiry.get(0) is not None
                              and ctl.leases._expiry[0] < now[0]),
                 "no fresh beat", tick=ctl._drain_beats)
        ctl.check_leases()
        assert ctl.smap.owner(1) == 0, "failover did not move the shard"
    return hook


def data_plans(drop, dup):
    return {i: (lambda f, i=i: f.FaultPlan(seed=i, drop_every=drop, dup_every=dup,
                                           tags=DATA_TAGS)) for i in range(2)}


# ---------------------------------------------------------------------------
# end to end: static, live migration, failover — all bitwise


class TestShardctlGang:
    def test_static_map_gang_trains(self):
        w0, gtab = tables()
        out, servers, clients, ctl = run_sc(w0, gtab, 6)
        np.testing.assert_allclose(out, w0 + gtab.sum(axis=(0, 1)), rtol=1e-5)
        assert [s.owned_shards for s in servers] == [[0], [1]]
        np.testing.assert_array_equal(out, static_run("jax"))

    def test_live_migration_is_bitwise_transparent(self):
        w0, gtab = tables()
        migrated, servers, clients, ctl = run_sc(w0, gtab, 6, hook=migrate_at(3, 1, 0))
        np.testing.assert_array_equal(static_run("torch"), migrated)
        np.testing.assert_array_equal(static_run("jax"), migrated)
        assert servers[0].owned_shards == [0, 1] and servers[1].owned_shards == []
        assert sum(int(c._m_nacks.value) for c in clients) > 0, \
            "nobody drained through NACK_MAP — the migration was free?"

    def test_live_migration_under_drop_dup_plans_stays_bitwise(self):
        w0, gtab = tables()
        faulty, servers, clients, ctl = run_sc(
            w0, gtab, 6, hook=migrate_at(2, 0, 1), client_plans=data_plans(3, 4),
            server_plan=lambda f: f.FaultPlan(seed=9, drop_every=3, tags=REPLY_TAGS))
        np.testing.assert_array_equal(static_run("torch"), faulty)
        np.testing.assert_array_equal(static_run("jax"), faulty)
        assert sum(int(s.dup_ops) for s in servers) > 0, \
            "no duplicate was ever admitted — the plan never bit"

    def test_migration_preserves_int8_error_feedback(self):
        w0, gtab = tables(size=4096)
        static, *_ = run_sc(w0, gtab, 6, codec="int8")
        migrated, _, clients, _ = run_sc(w0, gtab, 6, codec="int8",
                                         hook=migrate_at(3, 1, 0))
        np.testing.assert_array_equal(static, migrated)
        assert any(c.residual_norm() > 0 for c in clients)

    def test_lease_expiry_failover_is_bitwise_transparent(self, tmp_path):
        now, killed = [0.0], []
        w0, gtab = tables()
        failed, servers, clients, ctl = run_sc(
            w0, gtab, 6, hook=failover_hook(tmp_path, now, killed),
            ckpt_dir=str(tmp_path), client_plans=data_plans(4, 5),
            ctl_kwargs=dict(lease_ttl_s=5.0, clock=lambda: now[0]))
        np.testing.assert_array_equal(static_run("torch"), failed)
        np.testing.assert_array_equal(static_run("jax"), failed)
        assert killed == [1] and servers[0].owned_shards == [0, 1]
        assert all(c.smap.version == 1 for c in clients)


class TestAdamAcrossOwners:
    """Server-side Adam on the slots: K3 (its plain twin here) continues on
    the new owner from the moved moments."""

    def test_static_adam_gang_equals_the_rule_rollout(self, monkeypatch):
        k3 = K3Count(monkeypatch)
        w0, gtab = tables()
        out, servers, *_ = run_sc(w0, gtab, 6, rule="adam")
        calls = k3.calls
        np.testing.assert_array_equal(out, adam_rollout(w0, gtab))
        assert_near_jax_adam(out)
        applied = sum(s.grads_applied for s in servers)
        assert applied == 2 * 6 * 2 and calls == applied

    def test_adam_live_migration_is_bitwise(self, monkeypatch):
        w0, gtab = tables()
        want = static_run("torch", rule="adam")
        k3 = K3Count(monkeypatch)
        migrated, servers, clients, _ = run_sc(w0, gtab, 6, rule="adam",
                                               hook=migrate_at(3, 1, 0))
        np.testing.assert_array_equal(want, migrated)
        assert_near_jax_adam(migrated)
        applied = sum(s.grads_applied for s in servers)
        assert applied == 24 and k3.calls == applied, (applied, k3.calls)
        assert servers[1].grads_applied > 0 and servers[0].grads_applied > 12
        t = servers[0]._slots[1].rule_state["t"]
        assert t.shape == () and t.dtype == torch.int32 and int(t) == 12
        assert sum(int(c._m_nacks.value) for c in clients) > 0

    def test_adam_failover_is_bitwise(self, monkeypatch, tmp_path):
        w0, gtab = tables()
        want = static_run("torch", rule="adam")
        k3 = K3Count(monkeypatch)
        now, killed = [0.0], []
        failed, servers, clients, ctl = run_sc(
            w0, gtab, 6, rule="adam", hook=failover_hook(tmp_path, now, killed),
            ckpt_dir=str(tmp_path),
            ctl_kwargs=dict(lease_ttl_s=5.0, clock=lambda: now[0]))
        np.testing.assert_array_equal(want, failed)
        assert_near_jax_adam(failed)
        applied = sum(s.grads_applied for s in servers)
        assert applied == 24 and k3.calls == applied, (applied, k3.calls)
        assert int(servers[0]._m_sc_adopt.value) == 1


class TestMixedGangs:
    """Port and JAX roles on one JAX router, codec none."""

    @pytest.mark.parametrize("server_pkg,ctl_pkg,client_pkg,rule", [
        ("jax", "jax", "torch", "add"),
        ("torch", "torch", "jax", "add"),
        ("jax", "jax", "torch", "adam"),
        ("torch", "torch", "jax", "adam"),
    ])
    def test_migrated_mixed_gang_equals_the_jax_gang(self, server_pkg, ctl_pkg,
                                                     client_pkg, rule):
        w0, gtab = tables()
        out, servers, clients, _ = run_sc(
            w0, gtab, 6, server_pkgs=[server_pkg] * 2, ctl_pkg=ctl_pkg,
            client_pkg=client_pkg, rule=rule, hook=migrate_at(3, 1, 0))
        # Bit for bit against the all-<server package> static gang: the
        # servers' rule decides the bits (and the all-JAX gang's within
        # the fused-update tolerance under Adam).
        np.testing.assert_array_equal(static_run(server_pkg, rule=rule), out)
        if rule == "add":
            np.testing.assert_array_equal(static_run("jax"), out)
        else:
            assert_near_jax_adam(out)
        assert servers[0].owned_shards == [0, 1]

    @pytest.mark.parametrize("rule", ["add", "adam"])
    @pytest.mark.parametrize("ctl_pkg", ["torch", "jax"])
    def test_shard_moves_jax_to_port_and_back(self, rule, ctl_pkg):
        """Server 0 is the JAX package's, server 1 the port's: shard 0 goes
        JAX -> port at round 2 and back at round 4; shard 1 goes port ->
        JAX at round 3."""
        def hook(r, ctl, servers, threads):
            moves = {2: (0, 1), 3: (1, 0), 4: (0, 0)}
            if r in moves:
                assert ctl.migrate(*moves[r])

        w0, gtab = tables()
        out, servers, *_ = run_sc(w0, gtab, 6, server_pkgs=["jax", "torch"],
                                  ctl_pkg=ctl_pkg, client_pkg="torch", rule=rule,
                                  hook=hook)
        if rule == "add":
            np.testing.assert_array_equal(static_run("jax"), out)
        else:  # each owner's rule applied its rounds: the two Adams mixed
            assert_near_jax_adam(out)
        assert servers[0].owned_shards == [0, 1] and servers[1].owned_shards == []


# ---------------------------------------------------------------------------
# controller plumbing


def beating(f):
    return fast_ft(f, heartbeat_s=0.02)


class TestController:
    def test_beats_feed_leases_and_window(self):
        servers, clients, threads, ctl = launch_sc(2, 1, 32, client_ft=beating,
                                                   server_ft=beating)
        w0 = np.arange(32, dtype=np.float32)
        start_clients(clients, w0)
        wait_for(lambda: int(ctl._m_beats.value) > 0, "no beat ever arrived",
                 tick=ctl.pump)
        np.testing.assert_array_equal(finish(clients, threads, ctl), w0)

    def test_policy_driven_rebalance_moves_the_hot_shard(self):
        now = [0.0]
        servers, clients, threads, ctl = launch_sc(
            2, 2, 48, ctl_kwargs=dict(
                policy=RebalancePolicy(ratio=2.0, min_busy_s=0.0, cooldown_s=1.0),
                clock=lambda: now[0]))
        w0 = np.arange(48, dtype=np.float32)
        start_clients(clients, w0)
        ctl.pump()
        ctl._window = {0: {0: ShardLoad(ops=50, busy_s=2.0)},
                       1: {1: ShardLoad(ops=50, busy_s=0.1)}}
        now[0] += 10.0
        assert ctl.maybe_rebalance()
        assert ctl.smap.owner(0) == 1
        lockstep(clients, np.ones((2, 2, 48), np.float32), 2)
        np.testing.assert_allclose(finish(clients, threads, ctl), w0 + 4.0, rtol=1e-6)
        assert servers[1].owned_shards == [0, 1]

    def test_migrate_refuses_noops(self):
        servers, clients, threads, ctl = launch_sc(2, 1, 32)
        w0 = np.arange(32, dtype=np.float32)
        start_clients(clients, w0)
        ctl.pump()
        assert not ctl.migrate(0, 0)
        assert not ctl.migrate(99, 1)
        np.testing.assert_array_equal(finish(clients, threads, ctl), w0)


# ---------------------------------------------------------------------------
# guards


class TestGuards:
    def test_shardctl_without_deadlines_is_rejected(self):
        with pytest.raises(ValueError, match="op_deadline_s"):
            ParamClient(1, [0], LocalRouter(2).endpoint(1), shardctl=True,
                        ft=ft.FTConfig())

    @pytest.mark.parametrize("server_pkg", ["torch", "jax"])
    def test_mixed_legacy_and_shardctl_inits_fail_loudly(self, server_pkg):
        """One v4 and one legacy port client on a server of either package
        must not negotiate."""
        P = PKGS[server_pkg]
        router = JaxRouter(3)
        kw = {"device": "cpu"} if server_pkg == "torch" else {}
        server = P["server"](0, [1, 2], router.endpoint(0), ft=fast_ft(P["ft"]), **kw)
        err = []

        def run_server():
            try:
                server.start()
            except Exception as exc:  # noqa: BLE001 — the loud failure
                err.append(exc)

        th = threading.Thread(target=run_server, daemon=True)
        th.start()
        sc_client = ParamClient(1, [0], router.endpoint(1), ft=fast_ft(ft), shardctl=True)
        legacy = ParamClient(2, [0], router.endpoint(2), ft=fast_ft(ft))
        w = np.ones(8, np.float32)
        starters = [threading.Thread(target=lambda c=c: c.start(w.copy(), np.zeros_like(w)),
                                     daemon=True) for c in (sc_client, legacy)]
        for t in starters:
            t.start()
        th.join(10)
        assert err, "server accepted a mixed v4/legacy gang"
        assert "legacy" in str(err[0]) or "shardctl" in str(err[0])
        server.live.stop()
        sc_client.live.stop()
        legacy.live.stop()
        for t in starters:
            t.join(5)

    def test_v4_without_framing_is_refused(self):
        server = ParamServer(0, [1], LocalRouter(2).endpoint(0), device="cpu")
        m = ShardMap.initial(8, [0])
        with pytest.raises(ValueError, match="FLAG_FRAMED"):
            server._negotiate(1, scwire.init_v4(0, 0, scwire.FLAG_SHARDCTL, m).tobytes())

    def test_joiner_needs_a_controller(self):
        server = ParamServer(0, [1], LocalRouter(2).endpoint(0), device="cpu",
                             shardctl=True)
        with pytest.raises(ValueError, match="controller_rank"):
            server.start()

    def test_status_sections_carry_the_map(self):
        servers, clients, threads, ctl = launch_sc(2, 1, 16)
        start_clients(clients, np.arange(16, dtype=np.float32))
        assert servers[0]._status_section()["map_version"] == 0
        assert servers[0]._status_section()["owned_shards"] == [0]
        assert clients[0]._status_section()["map_version"] == 0
        assert json.dumps(servers[1]._status_section())
        finish(clients, threads, ctl)
