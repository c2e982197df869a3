"""Hierarchical aggregation in the port (``mpit_tpu_torch.agg``) against the
JAX package's (``mpit_tpu.agg``), on the CPU.

The contract (docs/PROTOCOL.md §13): pre-reducing colocated gradients on
the group plane and reducing across the REDUCE tree changes who sends
what where and nothing else — the value the servers apply is bitwise the
fixed-order fold of the gang's gradients, per-hop codec round trips
included, whatever the arrival order, tree shape or chunk-level fault
pattern.  Stragglers re-route loudly (LATE -> direct push), never silently
and never as a hang.

- Plan and wire: ``ReductionPlan`` (trees, groups, ``describe()``) equal
  to the JAX plan's for the same inputs; REDUCE header and ack bytes equal
  to the JAX functions'.
- Bitwise: a port gang's final server params equal a flat port gang
  pushing the numpy oracle's fixed-order fold, exactly (no tolerance), at
  codecs none, bf16 and int8; prereduce, a stateful rule, chunked
  upstream pushes, and off-mode passthrough; drop/dup on the REDUCE hops;
  the seeded property test (bitwise or loud, never a hang).
- The group fold's two branches: ``card_fold`` (the card's fold, run here
  on CPU tensors) equals the host ``+=`` fold bit for bit.
- Ordering: a lone root's push is read back by the pull queued after it
  (the port queues its whole-frame push on the inner client's FIFO; the
  JAX client pushes it beside the FIFO, ROADMAP §C).
- Mixed: 2 port and 2 JAX ``AggClient``s reduce through one tree over one
  JAX ``LocalRouter`` against a JAX server (codec none: a JAX server
  encoding a quantized snapshot would start the JAX package's
  process-global pool in this process); the server params equal the
  all-JAX tree's bit for bit.
- The launcher: ``parse_agg_groups``, the wrap's refusals with the JAX
  package's words, and a ``--agg tree`` process gang on the CPU.
"""

import threading
import time

import numpy as np
import pytest
import torch

import mpit_tpu.agg as jagg
import mpit_tpu.ft as jft
from mpit_tpu.comm.local import LocalRouter as JaxRouter
from mpit_tpu.ps import ParamClient as JaxClient
from mpit_tpu.ps import ParamServer as JaxServer
from mpit_tpu_torch import ft
from mpit_tpu_torch.agg import (
    AggClient,
    AggConfig,
    ReductionPlan,
    pack_reduce_header,
    reduce_ack_frame,
    unpack_reduce_header,
)
from mpit_tpu_torch.agg import client as agg_client
from mpit_tpu_torch.agg import node as agg_node
from mpit_tpu_torch.aio import TaskError
from mpit_tpu_torch.comm import codec as codec_mod
from mpit_tpu_torch.comm.local import LocalRouter
from mpit_tpu_torch.ft import FaultPlan, FaultyTransport, FTConfig, RetryExhausted
from mpit_tpu_torch.ps import ParamClient, ParamServer, tags
from mpit_tpu_torch.train import launch

torch.set_num_threads(1)

REDUCE_TAGS = frozenset({tags.REDUCE})
REDUCE_ACK_TAGS = frozenset({tags.REDUCE_ACK})

_ns_counter = [0]


def agg_ft(deadline=2.0, retries=10, chunk_bytes=0, pkg=ft):
    return pkg.FTConfig(op_deadline_s=deadline, max_retries=retries,
                        backoff_base_s=0.005, backoff_cap_s=0.02,
                        chunk_bytes=chunk_bytes)


def join_all(threads, timeout=90):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "role thread did not stop (hang)"


# ---------------------------------------------------------------------------
# plan and wire units


class TestReductionPlan:
    def test_singleton_groups_and_reps(self):
        plan = ReductionPlan.build([2, 3, 4, 5])
        assert all(plan.is_rep(r) for r in [2, 3, 4, 5])
        for r in [2, 3, 4, 5]:
            hops, node = 0, r
            while plan.parent(node) is not None:
                node = plan.parent(node)
                hops += 1
                assert hops <= 4
            assert node == plan.root

    def test_groups_elect_min_rank(self):
        plan = ReductionPlan.build([2, 3, 4, 5], groups=[(3, 2), (5, 4)])
        assert plan.rep(2) == 2 and plan.rep(3) == 2
        assert plan.rep(4) == 4 and plan.rep(5) == 4
        assert plan.members(2) == [3] and not plan.is_rep(3)
        assert plan.group_size(5) == 2

    @pytest.mark.parametrize("n,groups,fanin,seed", [
        (4, (), 2, 0), (8, (), 2, 1), (8, (), 3, 7), (9, (), 8, 0),
        (6, ((0, 1, 2),), 2, 0), (6, ((1, 3), (4, 5)), 1, 11),
    ])
    def test_plan_equals_the_jax_plan(self, n, groups, fanin, seed):
        ours = ReductionPlan.build(range(n), groups=groups, fanin=fanin, seed=seed)
        theirs = jagg.ReductionPlan.build(range(n), groups=groups, fanin=fanin,
                                          seed=seed)
        assert ours.describe() == theirs.describe()
        for field in ("cranks", "rep_of", "members_of", "parent_of", "children_of",
                      "root"):
            assert getattr(ours, field) == getattr(theirs, field), field
        assert ours.subtree_leaves(ours.root) == n

    def test_deterministic_and_seed_sensitive(self):
        shapes = {tuple(sorted(ReductionPlan.build(range(8), fanin=2, seed=s)
                               .parent_of.items())) for s in range(6)}
        assert len(shapes) > 1

    def test_bad_groups_raise(self):
        with pytest.raises(ValueError, match="two groups"):
            ReductionPlan.build(range(4), groups=[(0, 1), (1, 2)])
        with pytest.raises(ValueError, match="non-client"):
            ReductionPlan.build([0, 1], groups=[(0, 7)])

    def test_config_from_env(self, monkeypatch):
        monkeypatch.setenv("MPIT_AGG_MODE", "tree")
        monkeypatch.setenv("MPIT_AGG_FANIN", "3")
        assert AggConfig.from_env(tree_seed=4) == AggConfig(mode="tree", fanin=3,
                                                            tree_seed=4)
        assert AggConfig.from_env().enabled


class TestReduceWire:
    @pytest.mark.parametrize("words", [(3, 7, 2, 5, 11), (0, 1, 0, 1, 1),
                                       (2**40, 2**33, 7, 9, 64)])
    def test_header_bytes_equal_jax(self, words):
        ours, theirs = np.zeros(64, np.uint8), np.zeros(64, np.uint8)
        pack_reduce_header(ours, *words)
        jagg.pack_reduce_header(theirs, *words)
        assert ours.tobytes() == theirs.tobytes()
        assert unpack_reduce_header(ours) == words == jagg.unpack_reduce_header(ours)

    @pytest.mark.parametrize("status", [0, 1])
    def test_ack_bytes_equal_jax(self, status):
        ours = reduce_ack_frame(1, 2, 3, status)
        assert ours.dtype == np.int64 and list(ours) == [1, 2, 3, status]
        assert ours.tobytes() == jagg.reduce_ack_frame(1, 2, 3, status).tobytes()

    def test_tags_equal_jax(self):
        from mpit_tpu.ps import tags as jtags

        for name in ("REDUCE", "REDUCE_ACK"):
            assert getattr(tags, name) == getattr(jtags, name)
            assert tags.TAG_PAIRS[name] == jtags.TAG_PAIRS[name]


class TestGroupFold:
    """The group fold's two branches agree bit for bit: ``card_fold`` (the
    card's, one ``torch.add`` at a time in rank order, run here on CPU
    tensors) and the host ``+=`` the CPU branch runs."""

    @pytest.mark.parametrize("members", [0, 1, 3])
    def test_card_fold_equals_host_fold(self, members):
        rng = np.random.default_rng(members)
        base = rng.normal(size=4099).astype(np.float32) * 1e3
        payloads = [rng.normal(size=4099).astype(np.float32) * 10.0 ** k
                    for k in range(members)]
        tickets = [agg_node.AggTicket(r, 1, torch.from_numpy(p.copy()))
                   for r, p in enumerate(payloads)]
        out = np.zeros_like(base)
        agg_client.card_fold(out, base, tickets, torch.device("cpu"))
        host = base.copy()
        for p in payloads:
            host += p
        assert out.tobytes() == host.tobytes()


# ---------------------------------------------------------------------------
# the gang harness: a thread per client, lockstep rounds


def launch_agg(nservers, nclients, ftc, cfg, client_plans=None, rule="add",
               codec=None, client_pkgs=None, server_pkg="torch"):
    """``nservers`` servers and ``nclients`` AggClients on one router;
    ``client_pkgs`` names each client's package (default all port), and a
    JAX client or server puts the gang on a JAX router."""
    n = nservers + nclients
    client_pkgs = client_pkgs or ["torch"] * nclients
    jax_router = server_pkg == "jax" or "jax" in client_pkgs
    router = JaxRouter(n) if jax_router else LocalRouter(n)
    sranks = list(range(nservers))
    cranks = list(range(nservers, n))
    _ns_counter[0] += 1
    namespace = f"tagg{_ns_counter[0]}"
    servers, threads = [], []
    for r in sranks:
        if server_pkg == "jax":
            server = JaxServer(r, cranks, router.endpoint(r), rule=rule,
                               ft=jft.FTConfig(rejoin=True))
        else:
            server = ParamServer(r, cranks, router.endpoint(r), rule=rule, device="cpu",
                                 ft=FTConfig(rejoin=True))
        servers.append(server)
        threads.append(threading.Thread(target=server.start, daemon=True))
    for t in threads:
        t.start()
    clients = []
    for i, r in enumerate(cranks):
        ep = router.endpoint(r)
        plan = (client_plans or {}).get(i)
        if client_pkgs[i] == "jax":
            inner = JaxClient(r, sranks, ep, seed_servers=(i == 0), codec=codec,
                              ft=agg_ft(pkg=jft, **ftc))
            clients.append(jagg.AggClient(
                inner, cranks, jagg.AggConfig(**cfg), namespace=namespace))
            continue
        if plan is not None:
            ep = FaultyTransport(ep, plan)
        inner = ParamClient(r, sranks, ep, seed_servers=(i == 0), codec=codec,
                            ft=agg_ft(**ftc))
        clients.append(AggClient(inner, cranks, AggConfig(**cfg), namespace=namespace,
                                 device="cpu"))
    return servers, clients, threads


class PingBarrier:
    """A lockstep barrier whose waiters keep pumping their client's I/O:
    an idle tree parent must still answer a straggler's retries (LATE
    acks), as a training loop's ping cadence does."""

    def __init__(self, n):
        self.n = n
        self._count = 0
        self._gen = 0
        self._aborted = False
        self._lock = threading.Lock()

    def abort(self):
        self._aborted = True

    def wait(self, ping=None, timeout=90.0):
        with self._lock:
            gen = self._gen
            self._count += 1
            if self._count == self.n:
                self._count = 0
                self._gen += 1
                return
        bound = time.monotonic() + timeout
        while True:
            with self._lock:
                if self._gen != gen:
                    return
            if self._aborted:
                raise RuntimeError("agg barrier aborted (sibling failed)")
            if ping is not None:
                ping()
            time.sleep(0.001)
            if time.monotonic() > bound:
                self._aborted = True
                raise RuntimeError("agg barrier timed out")


def run_agg_gang(nservers, nclients, cfg, rounds=3, size=8192, ftc=None, seed=42,
                 gtab=None, delays=None, w0=None, round_timeout=90, **kw):
    """Seed, run lockstep rounds from a thread per client, read back
    client 0's params.  ``delays[(client_idx, round)]`` sleeps that client
    before its send (the straggler).  Returns (params, stats)."""
    rng = np.random.default_rng(seed)
    drawn = rng.normal(size=size).astype(np.float32)
    w0 = drawn if w0 is None else w0
    if gtab is None:
        gtab = rng.normal(size=(nclients, max(rounds, 1), size)).astype(np.float32)
    servers, clients, threads = launch_agg(nservers, nclients, ftc or {}, cfg, **kw)
    barrier = PingBarrier(nclients)
    errors = {}
    params = [((w0.copy() if i == 0 else np.zeros(size, np.float32)),
               np.zeros(size, np.float32)) for i in range(nclients)]

    def drive(i, c):
        try:
            c.start(*params[i])
            barrier.wait(ping=c.ping)
            for r in range(rounds):
                params[i][1][:] = gtab[i, r]
                if delays:
                    time.sleep(delays.get((i, r), 0.0))
                c.async_send_grad()
                c.wait()
                barrier.wait(ping=c.ping)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            errors[i] = exc
            barrier.abort()

    runners = [threading.Thread(target=drive, args=(i, c), daemon=True)
               for i, c in enumerate(clients)]
    for t in runners:
        t.start()
    deadline = time.monotonic() + round_timeout
    for t in runners:
        t.join(max(deadline - time.monotonic(), 1.0))
        assert not t.is_alive(), "an agg client thread hung (never-hang broken)"
    try:
        if errors:
            raise errors[min(errors)]
        clients[0].async_recv_param()
        clients[0].wait()
        stats = {
            "applied": sum(s.grads_applied for s in servers),
            "retries": sum(c.retries for c in clients),
            "late": sum(int(c._m_late.value) for c in clients),
            "fallbacks": sum(int(c._m_fallbacks.value) for c in clients),
            "faults": sum(c.pc.transport.dropped + c.pc.transport.duplicated
                          for c in clients if isinstance(c.pc.transport, FaultyTransport)),
        }
        return params[0][0].copy(), stats
    finally:
        for c in clients:
            try:
                c.stop()
            except Exception:  # noqa: BLE001 — teardown of a failed gang
                pass
        for s in servers:
            s.live.stop()
        join_all(threads)


def oracle_pushes(plan, gtab, codec_name, rounds, size):
    """Per round, the value the root pushes upstream: group folds in
    ascending rank order, child subtrees folded in ascending child order,
    every tree hop round-tripped through the port's codec with the
    sender-held error-feedback residual."""
    codec = codec_mod.get(codec_name)
    idx = {r: i for i, r in enumerate(plan.cranks)}
    residuals = {r: np.zeros(size, np.float32) for r in plan.cranks}

    def fold(rank, r):
        acc = gtab[idx[rank], r].astype(np.float32).copy()
        for m in plan.members(rank):
            acc += gtab[idx[m], r]
        for c in plan.children(rank):
            sub = fold(c, r)
            wire = np.zeros(codec.wire_nbytes(size), np.uint8)
            codec.encode_into(sub, wire,
                              residual=residuals[c] if codec.uses_residual else None)
            dec = np.zeros(size, np.float32)
            codec.decode_into(wire, dec)
            acc += dec
        return acc

    return [fold(plan.root, r) for r in range(rounds)]


def run_flat_control(nservers, pushes, size, rule="add", codec=None, seed=42):
    """A 1-client flat gang pushing the oracle's per-round values."""
    return run_agg_gang(nservers, 1, dict(mode="off"), rounds=len(pushes), size=size,
                        rule=rule, codec=codec, seed=seed, gtab=np.stack([pushes]))


def grads(nclients, rounds, size, integer=False):
    rng = np.random.default_rng(42)
    rng.normal(size=size)  # the w0 draw run_agg_gang makes first
    if integer:
        w0 = rng.integers(-64, 65, size=size).astype(np.float32)
        return w0, rng.integers(-8, 9, size=(nclients, rounds, size)).astype(np.float32)
    return None, rng.normal(size=(nclients, rounds, size)).astype(np.float32)


# ---------------------------------------------------------------------------
# bitwise parity: hierarchical == flat pushes of the fixed-order fold


class TestHierarchicalBitwise:
    @pytest.mark.parametrize("codec_name", ["none", "bf16", "int8"])
    def test_tree_equals_flat_fold(self, codec_name):
        """4 singleton clients over a binary tree: the root's pushes,
        per-hop codec round trips included, land bit for bit where a flat
        client pushing the oracle fold lands."""
        size = 8192
        cfg = dict(mode="tree", fanin=2, tree_seed=3, deadline_s=30.0)
        _, gtab = grads(4, 3, size)
        hier, st = run_agg_gang(2, 4, cfg, rounds=3, size=size, codec=codec_name,
                                gtab=gtab)
        plan = ReductionPlan.build(range(2, 6), fanin=2, seed=3)
        flat, _ = run_flat_control(2, oracle_pushes(plan, gtab, codec_name, 3, size),
                                   size, codec=codec_name)
        assert hier.tobytes() == flat.tobytes()
        assert st["applied"] == 3 * 2  # one GRAD per round per server
        assert st["late"] == 0 and st["fallbacks"] == 0

    def test_prereduce_group_equals_flat_sum(self):
        """One colocated group of 3: the representative pushes the group
        fold; the servers see exactly one GRAD per round."""
        size = 6144
        cfg = dict(mode="prereduce", groups=((2, 3, 4),), deadline_s=30.0)
        _, gtab = grads(3, 2, size)
        hier, st = run_agg_gang(2, 3, cfg, rounds=2, size=size, gtab=gtab)
        plan = ReductionPlan.build(range(2, 5), groups=[(2, 3, 4)])
        flat, _ = run_flat_control(2, oracle_pushes(plan, gtab, "none", 2, size), size)
        assert hier.tobytes() == flat.tobytes()
        assert st["applied"] == 2 * 2

    def test_tree_with_groups_and_stateful_rule(self):
        """2 groups + a tree over their reps, rmsprop on the servers,
        int8 hops: the fold is what reaches the rule, bit for bit."""
        size = 6144
        groups = ((2, 3), (4, 5))
        cfg = dict(mode="tree", groups=groups, fanin=2, tree_seed=1, deadline_s=30.0)
        _, gtab = grads(4, 3, size)
        hier, _ = run_agg_gang(2, 4, cfg, rounds=3, size=size, rule="rmsprop",
                               codec="int8", gtab=gtab)
        plan = ReductionPlan.build(range(2, 6), groups=groups, fanin=2, seed=1)
        flat, _ = run_flat_control(2, oracle_pushes(plan, gtab, "int8", 3, size), size,
                                   rule="rmsprop", codec="int8")
        assert hier.tobytes() == flat.tobytes()

    def test_chunked_upstream_push_composes(self):
        """Chunked client-server streams + the REDUCE tree (the root's
        gated push): chunking changes no byte."""
        size = 8192
        cfg = dict(mode="tree", fanin=2, tree_seed=0, deadline_s=30.0,
                   chunk_bytes=8192)
        _, gtab = grads(3, 2, size)
        hier, _ = run_agg_gang(1, 3, cfg, rounds=2, size=size, gtab=gtab,
                               ftc=dict(chunk_bytes=8192))
        plan = ReductionPlan.build(range(1, 4), fanin=2, seed=0)
        flat, _ = run_flat_control(1, oracle_pushes(plan, gtab, "none", 2, size), size)
        assert hier.tobytes() == flat.tobytes()

    def test_off_mode_is_flat_passthrough(self):
        """Mode off: every client pushes its own GRAD (2 applies a round),
        and the servers hold w0 plus the sum of every push."""
        size = 4096
        w0, gtab = grads(2, 2, size, integer=True)
        final, st = run_agg_gang(1, 2, dict(mode="off"), rounds=2, size=size,
                                 gtab=gtab, w0=w0)
        assert st["applied"] == 2 * 2
        assert final.tobytes() == (w0 + gtab.sum(axis=(0, 1))).tobytes()


# ---------------------------------------------------------------------------
# stragglers: loud, counted, re-routed, never lost, never a hang


class TestStragglers:
    def test_late_member_falls_back_to_direct_push(self):
        """A colocated member sleeping past the deadline: the rep folds
        without it and the member pushes directly.  Integer grads make the
        adds exact, so every contribution lands whatever the apply order."""
        size = 4096
        w0, gtab = grads(2, 2, size, integer=True)
        final, st = run_agg_gang(1, 2, dict(mode="prereduce", groups=((1, 2),),
                                            deadline_s=0.4),
                                 rounds=2, size=size, gtab=gtab, w0=w0,
                                 delays={(1, 0): 1.2})
        assert final.tobytes() == (w0 + gtab.sum(axis=(0, 1))).tobytes()
        assert st["late"] >= 1 and st["fallbacks"] >= 1

    def test_late_tree_child_falls_back(self):
        """A tree leaf sleeping past the deadline: its parent folds without
        it (LATE acks) and the leaf pushes its partial directly."""
        size = 4096
        plan = ReductionPlan.build(range(1, 4), fanin=2, seed=0)
        leaf = next(r for r in plan.cranks
                    if plan.parent(r) is not None and not plan.children(r))
        w0, gtab = grads(3, 2, size, integer=True)
        final, st = run_agg_gang(1, 3, dict(mode="tree", fanin=2, tree_seed=0,
                                            deadline_s=0.4),
                                 rounds=2, size=size, gtab=gtab, w0=w0,
                                 delays={(plan.cranks.index(leaf), 0): 1.5})
        assert final.tobytes() == (w0 + gtab.sum(axis=(0, 1))).tobytes()
        assert st["late"] >= 1 and st["fallbacks"] >= 1


# ---------------------------------------------------------------------------
# faults on the REDUCE hops: retries recover, bitwise holds


class TestReduceFaults:
    @pytest.mark.parametrize("codec_name", ["none", "int8"])
    def test_drop_dup_on_reduce_hops_bitwise(self, codec_name):
        """Every 3rd REDUCE frame or ack dropped and every 4th duplicated on
        every client: resend and dedup recover, and the fold stays bit for
        bit (the int8 hop residual folds once, at the single encode).  Four
        chunks a hop, so every hop's frames and acks meet the plan."""
        size = 8192
        cfg = dict(mode="tree", fanin=2, tree_seed=2, deadline_s=30.0,
                   chunk_bytes=8192)
        _, gtab = grads(4, 2, size)
        plans = {i: FaultPlan(seed=5 + i, drop_every=3, dup_every=4,
                              tags=REDUCE_TAGS | REDUCE_ACK_TAGS) for i in range(4)}
        hier, st = run_agg_gang(2, 4, cfg, rounds=2, size=size, gtab=gtab,
                                client_plans=plans, codec=codec_name,
                                ftc=dict(deadline=0.3))
        plan = ReductionPlan.build(range(2, 6), fanin=2, seed=2)
        flat, _ = run_flat_control(2, oracle_pushes(plan, gtab, codec_name, 2, size),
                                   size, codec=codec_name)
        assert hier.tobytes() == flat.tobytes()
        assert st["late"] == 0 and st["fallbacks"] == 0 and st["faults"] > 0


@pytest.mark.parametrize("seed", range(5))
def test_property_reduce_faults_bitwise_or_loud(seed):
    """Seeds x random tree shapes x random {drop, dup, delay} plans on the
    REDUCE hops: the gang ends bitwise equal to the flat fixed-order-fold
    control (int8 hops included) or fails loudly; never a hang."""
    rng = np.random.default_rng(seed)
    nclients = int(rng.integers(3, 6))
    fanin = int(rng.choice([1, 2, 3]))
    tree_seed = int(rng.integers(0, 100))
    codec_name = str(rng.choice(["none", "int8"]))
    size = int(rng.choice([6144, 8192]))
    cfg = dict(mode="tree", fanin=fanin, tree_seed=tree_seed, deadline_s=30.0)
    _, gtab = grads(nclients, 2, size)
    plans = {i: FaultPlan(seed=seed * 17 + i, drop_rate=0.10, dup_rate=0.08,
                          delay_rate=0.15, delay_polls=4,
                          tags=REDUCE_TAGS | REDUCE_ACK_TAGS)
             for i in range(nclients)}
    try:
        hier, st = run_agg_gang(2, nclients, cfg, rounds=2, size=size, gtab=gtab,
                                client_plans=plans, codec=codec_name,
                                ftc=dict(deadline=0.3, retries=8), round_timeout=120)
    except (TaskError, RetryExhausted, AssertionError):
        return  # loud is an acceptable outcome; a hang is not
    plan = ReductionPlan.build(range(2, 2 + nclients), fanin=fanin, seed=tree_seed)
    flat, _ = run_flat_control(2, oracle_pushes(plan, gtab, codec_name, 2, size), size,
                               codec=codec_name)
    if st["fallbacks"] == 0 and st["late"] == 0:
        assert hier.tobytes() == flat.tobytes()


# ---------------------------------------------------------------------------
# the root's whole-frame push is ordered before a read queued after it


@pytest.mark.parametrize("chunk_bytes", [0, 8192])
def test_root_push_is_read_back_by_the_next_pull(chunk_bytes):
    """A lone tree root pushes a GRAD and pulls at once, every round: the
    pull reads the server after the push's apply (``add``: w0 + every
    push so far), whole frames (the push queued on the inner client's
    per-server FIFO, gated on the fold) and chunked (the gated streams)
    alike."""
    size = 8192
    w0, gtab = grads(1, 3, size, integer=True)
    servers, clients, threads = launch_agg(
        2, 1, dict(chunk_bytes=chunk_bytes),
        dict(mode="tree", deadline_s=30.0, chunk_bytes=chunk_bytes))
    client = clients[0]
    param, grad = w0.copy(), np.zeros(size, np.float32)
    try:
        client.start(param, grad)
        for r in range(3):
            grad[:] = gtab[0, r]
            client.async_send_grad()
            client.async_recv_param()
            client.wait()
            assert param.tobytes() == (w0 + gtab[0, :r + 1].sum(axis=0)).tobytes()
    finally:
        client.stop()
        for s in servers:
            s.live.stop()
        join_all(threads)


# ---------------------------------------------------------------------------
# one tree, both packages


def test_mixed_tree_equals_the_all_jax_tree():
    """2 port and 2 JAX AggClients reduce through one seed-3 tree over one
    JAX router into a JAX server (codec none): the server's params equal
    the all-JAX tree's bit for bit, and each server applied one GRAD a
    round."""
    size = 8192
    cfg = dict(mode="tree", fanin=2, tree_seed=3, deadline_s=30.0)
    _, gtab = grads(4, 3, size)
    kw = dict(rounds=3, size=size, gtab=gtab, codec="none", server_pkg="jax")
    mixed, st = run_agg_gang(1, 4, cfg, client_pkgs=["torch", "jax", "jax", "torch"],
                             **kw)
    alljax, st_j = run_agg_gang(1, 4, cfg, client_pkgs=["jax"] * 4, **kw)
    assert mixed.tobytes() == alljax.tobytes()
    assert st["applied"] == st_j["applied"] == 3


# ---------------------------------------------------------------------------
# launcher wiring (--agg)


class TestLaunchWiring:
    def test_parse_agg_groups_equals_jax(self):
        from mpit_tpu.train.launch import parse_agg_groups as jparse

        for spec in ("", "4,5;6,7", " 2 , 3 ; 9 "):
            assert launch.parse_agg_groups(spec) == jparse(spec)
        assert launch.parse_agg_groups("4,5;6,7") == ((4, 5), (6, 7))

    def test_knobs_equal_jax(self):
        """The --agg and --lm knobs and their defaults are the JAX
        launcher's."""
        from mpit_tpu.train.launch import LAUNCH_DEFAULTS as JAX_DEFAULTS

        ours, theirs = launch.LAUNCH_DEFAULTS.to_dict(), JAX_DEFAULTS.to_dict()
        keys = {k for k in theirs if k.startswith(("agg", "lm"))}
        assert keys == {k for k in ours if k.startswith(("agg", "lm"))}
        assert {k: ours[k] for k in keys} == {k: theirs[k] for k in keys}

    def test_agg_requires_framed_wire(self):
        inner = ParamClient(1, [0], LocalRouter(2).endpoint(1))
        with pytest.raises(ValueError, match="op_deadline_s"):
            AggClient(inner, [1], AggConfig(mode="tree"), device="cpu")

    def test_agg_rejects_shardctl(self):
        inner = ParamClient(1, [0], LocalRouter(2).endpoint(1), shardctl=True,
                            ft=FTConfig(op_deadline_s=1.0))
        with pytest.raises(ValueError, match="shard map"):
            AggClient(inner, [1], AggConfig(mode="prereduce"), device="cpu")

    def test_off_mode_needs_no_ft(self):
        inner = ParamClient(1, [0], LocalRouter(2).endpoint(1))
        assert AggClient(inner, [1], AggConfig(mode="off")).plan is None

    @pytest.mark.parametrize("flags,match", [
        (dict(shardctl=True, ft_op_deadline_s=5.0), "static shard map"),
        (dict(dplane=1, ft_op_deadline_s=5.0), "pick one"),
        (dict(), "needs --ft_op_deadline_s"),
    ])
    def test_launch_refusals_carry_the_jax_words(self, flags, match):
        """``run_rank``'s worker wrap refuses as the JAX launcher does."""
        cfg = launch.LAUNCH_DEFAULTS.merged(dict(flags, agg="tree", device="cpu",
                                                 side=8, epochs=1))
        size = 4 if flags.get("shardctl") else 2
        with pytest.raises(ValueError, match=match):
            launch.run_rank(1, size, cfg, LocalRouter(size).endpoint(1))

    def test_process_gang_tree_on_the_cpu(self):
        """``launch --np 6 --agg tree`` with the three workers (1, 3, 5) in
        one tree: every round reaches each server as one GRAD, so each
        server applies the workers' steps over 3."""
        res = launch.main(["--np", "6", "--opt", "downpour", "--device", "cpu",
                           "--side", "8", "--epochs", "1", "--lr", "0.2",
                           "--ft_op_deadline_s", "30", "--agg", "tree",
                           "--agg_deadline_s", "60"])
        workers = [r for r in res.values() if r["role"] == "worker"]
        servers = [r for r in res.values() if r["role"] == "server"]
        steps = workers[0]["steps"]
        assert all(w["steps"] == steps for w in workers)
        assert all(s["grads_applied"] == steps for s in servers)
        assert all(w["final_test_err"] < 0.9 for w in workers)
