"""The port's device data plane (``mpit_tpu_torch/dplane``): twins of
``tests/test_dplane.py``, held against the JAX package.

Three layers:

- the partition-rule engine (every leaf matched exactly once, scalars
  unpartitioned, specs validated against a mesh, aligned cuts at segment
  boundaries) — the same reports, cuts and shard maps as the JAX package's
  on the same trees, in the same flatten order (dict keys sorted);
- ``HbmSlot`` mechanics in torch terms: donation is an in-place update (the
  storage stays, an old handle sees the new values), ``donate=False``
  writes fresh storage, the per-version snapshot and pull caches cache, a
  pull survives a later apply, ``dedupe_state`` breaks shared storage;
- bitwise parity: msgd, DOWNPOUR and EAMSGD over the device exchange end
  with the host path's bytes (and the JAX package's), a mixed gang with one
  device server beside a faulty wire server, a JAX/port mix that rides the
  wire (each package's plane registry is its own), and a shard-control
  gang on device slots with one live migration.

One card placement: ``PlaneConfig.auto()`` is single-device in the port;
the JAX twins shard over 12 CPU devices.  The values are the same, so the
twins compare values, not placements.  The card's own test (streams
across the client's and the server's threads) is in
``tests/test_torch_cuda.py``, marked ``cuda``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import mpit_tpu.dplane as jdp
from mpit_tpu.comm.local import LocalRouter as JaxRouter
from mpit_tpu.optim.downpour import Downpour as JaxDownpour
from mpit_tpu.optim.easgd import EAMSGD as JaxEAMSGD
from mpit_tpu.optim.shells import SingleWorker as JaxSingleWorker
from mpit_tpu.ps import ParamClient as JaxClient
from mpit_tpu.ps import ParamServer as JaxServer
from mpit_tpu_torch.comm.local import LocalRouter
from mpit_tpu_torch.dplane import (
    ExchangeClient,
    ExchangeError,
    HbmSlot,
    PlaneConfig,
    aligned_cut,
    dedupe_state,
    flat_segments,
    match_partition_rules,
    match_report,
    plan_shard_map,
    tree_shardings,
)
from mpit_tpu_torch.dplane import exchange as dpexchange
from mpit_tpu_torch.dplane.exchange import DevicePlane, DeviceTicket
from mpit_tpu_torch.dplane.partition import PartitionSpec as P
from mpit_tpu_torch.dplane.partition import Segment, shard_tree, validate_spec
from mpit_tpu_torch.ft import FaultPlan, FaultyTransport, FTConfig
from mpit_tpu_torch.optim import DeviceSyncAPI
from mpit_tpu_torch.optim.downpour import Downpour
from mpit_tpu_torch.optim.easgd import EAMSGD
from mpit_tpu_torch.optim.rules import make as make_rule
from mpit_tpu_torch.optim.shells import SingleWorker
from mpit_tpu_torch.parallel.mesh import make_mesh
from mpit_tpu_torch.ps import ParamClient, ParamServer, tags

DATA_TAGS = frozenset({tags.GRAD, tags.PARAM_REQ, tags.PARAM_PUSH})
FAST_FT = FTConfig(op_deadline_s=0.25, max_retries=8, backoff_base_s=0.005,
                   backoff_cap_s=0.02)
CPU_PLANE = PlaneConfig(device="cpu")


def join_all(threads, timeout=30):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "role thread did not stop (hang)"


class FakeMesh:
    """A mesh shape the JAX twins shard over (``shard`` x 8); the port's
    placement on it is refused, its spec validation is not."""

    shape = {"dp": 1, "shard": 8}


def _tree(seed: int):
    """A transformer-shaped random tree (nested dicts, mixed ranks, a couple
    of scalars) — the JAX test's."""
    rng = np.random.default_rng(seed)
    return {
        "embed": {"table": rng.normal(size=(16, 8)).astype(np.float32)},
        "layer_0": {
            "attn": {"q": rng.normal(size=(8, 8)).astype(np.float32),
                     "bias": rng.normal(size=8).astype(np.float32)},
            "mlp": {"w1": rng.normal(size=(8, 16)).astype(np.float32),
                    "w2": rng.normal(size=(16, 8)).astype(np.float32)},
        },
        "norm": {"scale": np.float32(rng.normal())},
        "step": np.zeros((), np.int32),
    }


def _port_spec(spec):
    return P(*tuple(spec))


RULES_J = [
    (r"embed/table", JP("shard", None)),
    (r"attn/.*bias", JP(None)),
    (r"attn", JP(None, "shard")),
    (r"mlp/w1", JP(None, "shard")),
    (r"mlp/w2", JP("shard", None)),
    (r".*", JP()),
]
RULES = [(pat, _port_spec(spec)) for pat, spec in RULES_J]


class TestPartitionRules:
    def test_first_match_wins_and_scalars_unpartitioned(self):
        specs = match_partition_rules(RULES, _tree(0))
        assert specs["embed"]["table"] == P("shard", None)
        assert specs["layer_0"]["attn"]["bias"] == P(None)
        assert specs["layer_0"]["attn"]["q"] == P(None, "shard")
        assert specs["norm"]["scale"] == P()
        assert specs["step"] == P()
        jspecs = jdp.match_partition_rules(RULES_J, _tree(0))
        flat = jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(x, JP))
        assert [tuple(s) for s in flat] == [
            tuple(specs["embed"]["table"]), tuple(specs["layer_0"]["attn"]["bias"]),
            tuple(specs["layer_0"]["attn"]["q"]), tuple(specs["layer_0"]["mlp"]["w1"]),
            tuple(specs["layer_0"]["mlp"]["w2"]), tuple(specs["norm"]["scale"]),
            tuple(specs["step"])]

    def test_unmatched_leaf_raises_or_replicates(self):
        rules = [(r"embed", P("shard", None))]
        with pytest.raises(ValueError, match="no partition rule"):
            match_partition_rules(rules, _tree(0))
        specs = match_partition_rules(rules, _tree(0), on_unmatched="replicate")
        assert specs["layer_0"]["mlp"]["w1"] == P()
        with pytest.raises(ValueError, match="on_unmatched"):
            match_partition_rules(rules, _tree(0), on_unmatched="bogus")

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_every_leaf_matched_exactly_once(self, seed):
        tree = _tree(seed)
        report = match_report(RULES, tree)
        assert report == jdp.match_report(RULES_J, tree)
        assert len(report) == len(jax.tree_util.tree_leaves(tree))
        for name, idx in report.items():
            if name in ("norm/scale", "step"):
                assert idx == -1, name
            else:
                assert 0 <= idx < len(RULES), name

    def test_specs_valid_for_mesh(self):
        mesh = make_mesh(device="cpu")
        tree = _tree(0)
        specs = match_partition_rules(RULES, tree)
        shardings = tree_shardings(mesh, specs, tree)
        assert shardings["embed"]["table"].device == torch.device("cpu")
        assert shardings["embed"]["table"].spec == P("shard", None)
        placed = shard_tree(tree, shardings)
        for name, leaf in (("embed", tree["embed"]["table"]), ("step", tree["step"])):
            got = placed["embed"]["table"] if name == "embed" else placed["step"]
            assert isinstance(got, torch.Tensor)
            np.testing.assert_array_equal(got.numpy(), leaf)
        # placed leaves own their storage: writing one leaves the tree alone
        placed["embed"]["table"].zero_()
        assert np.abs(tree["embed"]["table"]).sum() > 0

    def test_invalid_axis_and_indivisible_dims_fail_loudly(self):
        mesh = FakeMesh()
        with pytest.raises(ValueError, match="not in mesh axes"):
            validate_spec(mesh, P("bogus"), (8,), "x")
        with pytest.raises(ValueError, match="not divisible"):
            validate_spec(mesh, P("shard"), (9,), "x")
        with pytest.raises(ValueError, match="names 2 dims"):
            validate_spec(mesh, P("shard", None), (8,), "x")
        with pytest.raises(ValueError, match="repeats"):
            validate_spec(mesh, P("shard", "shard"), (8, 8), "x")
        for spec, shape in ((JP("bogus"), (8,)), (JP("shard"), (9,))):
            with pytest.raises(ValueError):
                jdp.partition.validate_spec(jdp.partition.Mesh(
                    np.asarray(jax.devices()[:8]), ("shard",)), spec, shape, "x")

    def test_naive_fallback_degrades_indivisible_dims(self):
        tree = {"w": np.zeros((9, 8), np.float32)}
        specs = {"w": P("shard", None)}
        with pytest.raises(ValueError, match="not divisible"):
            tree_shardings(FakeMesh(), specs, tree)
        # the spec degrades, then the multi-device placement is refused
        with pytest.raises(NotImplementedError, match="multi-card"):
            tree_shardings(FakeMesh(), specs, tree, naive_fallback=True)
        one = tree_shardings(make_mesh(device="cpu"), specs, tree, naive_fallback=True)
        assert one["w"].spec == P("shard", None)  # factor 1 divides anything
        with pytest.raises(NotImplementedError, match="multi-card"):
            make_mesh([torch.device("cpu")] * 2)


class TestAlignedCut:
    @pytest.mark.parametrize("seed", [3, 4, 5])
    def test_cut_properties(self, seed):
        rng = np.random.default_rng(seed)
        sizes = rng.integers(1, 50, size=12)
        segments, jsegments, off = [], [], 0
        for i, s in enumerate(sizes):
            segments.append(Segment(f"leaf{i}", off, int(s)))
            jsegments.append(jdp.Segment(f"leaf{i}", off, int(s)))
            off += int(s)
        n = int(rng.integers(2, 6))
        shards = aligned_cut(off, segments, n)
        assert [(s.offset, s.size) for s in shards] == [
            (s.offset, s.size) for s in jdp.aligned_cut(off, jsegments, n)]
        assert shards[0].offset == 0 and shards[-1].end == off
        boundaries = {s.offset for s in segments}
        pos = 0
        for sh in shards:
            assert sh.offset == pos and sh.size > 0
            assert sh.offset in boundaries
            pos = sh.end
        assert aligned_cut(off, segments, n) == shards
        w = [float(x) for x in rng.uniform(0.5, 2.0, size=n)]
        assert [(s.offset, s.size) for s in aligned_cut(off, segments, n, weights=w)] \
            == [(s.offset, s.size) for s in jdp.aligned_cut(off, jsegments, n, weights=w)]

    def test_fewer_segments_than_shards_raises(self):
        segments = [Segment("a", 0, 10), Segment("b", 10, 10)]
        with pytest.raises(ValueError, match="never splits a parameter"):
            aligned_cut(20, segments, 3)

    def test_plan_shard_map_is_a_valid_layout_source(self):
        tree = _tree(1)
        smap = plan_shard_map(tree, [0, 1], shards_per_server=2)
        jsmap = jdp.plan_shard_map(tree, [0, 1], shards_per_server=2)
        segments = flat_segments(tree)
        assert segments == [tuple(s) for s in jdp.flat_segments(tree)]
        assert smap.plong == segments[-1].end
        assert smap.version == 0 and len(smap.entries) == 4
        assert [e.owner for e in smap.entries] == [0, 0, 1, 1]
        assert smap.to_wire().tobytes() == jsmap.to_wire().tobytes()
        boundaries = {s.offset for s in segments}
        for e in smap.entries[1:]:
            assert e.shard.offset in boundaries
        wmap = plan_shard_map(tree, [0, 1], weights=[1.0, 3.0])
        assert wmap.to_wire().tobytes() == jdp.plan_shard_map(
            tree, [0, 1], weights=[1.0, 3.0]).to_wire().tobytes()


# ---------------------------------------------------------------------------
# HbmSlot mechanics


class TestHbmSlot:
    def test_donated_apply_consumes_old_buffers_bitwise(self):
        """Donation in torch terms: with donate=True the apply writes the
        slot's own storage (an old handle sees the new values); with
        donate=False the storage is fresh (an old handle keeps the old
        values); the bits equal the host path (the JAX slot's) either way."""
        g = np.random.default_rng(7).normal(size=16).astype(np.float32)
        jslot = jdp.HbmSlot(16, __import__("mpit_tpu.optim.rules", fromlist=["make"])
                            .make("adam"), config=jdp.PlaneConfig())
        jslot.apply_grad(g)
        ref = jslot.snapshot_host()
        slot = HbmSlot(16, make_rule("adam"), config=CPU_PLANE)
        p0, m0 = slot.param, slot.rule_state["m"]
        ptr = p0.data_ptr()
        slot.apply_grad(g)
        assert slot.param.data_ptr() == ptr and slot.param is p0
        np.testing.assert_array_equal(p0.numpy(), ref)  # the old handle sees it
        assert torch.equal(m0, slot.rule_state["m"])
        np.testing.assert_array_equal(slot.snapshot_host(), ref)
        assert slot.version == 1
        fresh = HbmSlot(16, make_rule("adam"), config=PlaneConfig(device="cpu",
                                                                  donate=False))
        q0 = fresh.param
        fresh.apply_grad(g)
        assert fresh.param.data_ptr() != q0.data_ptr()
        assert not q0.any()  # the old handle keeps the old (zero) values
        np.testing.assert_array_equal(fresh.snapshot_host(), ref)

    def test_snapshot_and_pull_caches_are_per_version(self):
        slot = HbmSlot(16, make_rule("add"), config=CPU_PLANE)
        a, b = slot.snapshot_host(), slot.snapshot_host()
        assert a is b and int(slot._m_copies.value) == 1
        p1, p2 = slot.pull_device(), slot.pull_device()
        assert p1 is p2 and int(slot._m_gathers.value) == 1
        slot.apply_grad(np.ones(16, np.float32))
        assert slot.snapshot_host() is not a
        assert int(slot._m_copies.value) == 2
        assert not a.any()  # the host copy is owned, not a view of param

    def test_pull_survives_a_later_donated_apply(self):
        slot = HbmSlot(16, make_rule("add"), config=CPU_PLANE)
        pulled = slot.pull_device()
        assert pulled.data_ptr() != slot.param.data_ptr()
        slot.apply_grad(np.ones(16, np.float32))
        np.testing.assert_array_equal(pulled.numpy(), np.zeros(16, np.float32))
        slot.seed(np.full(16, 3.0, np.float32))
        np.testing.assert_array_equal(pulled.numpy(), np.zeros(16, np.float32))

    def test_dedupe_state_breaks_rule_init_aliasing(self):
        z = torch.zeros(8)
        state = {"m": z, "v": z, "t": torch.zeros((), dtype=torch.int32)}
        fresh = dedupe_state(state)
        assert fresh["m"] is z and fresh["v"] is not z
        assert fresh["v"].data_ptr() != z.data_ptr() and torch.equal(fresh["v"], z)
        buf = torch.zeros(16)
        views = dedupe_state({"m": buf[:8], "v": buf[8:]})  # one storage, two leaves
        assert views["m"].untyped_storage().data_ptr() \
            != views["v"].untyped_storage().data_ptr()
        jstate = jdp.dedupe_state({"m": jnp.zeros(8), "v": jnp.zeros(8)})
        assert set(jstate) == {"m", "v"}

    def test_multi_device_mesh_is_refused(self):
        with pytest.raises(NotImplementedError, match="multi-card"):
            HbmSlot(16, make_rule("add"), config=PlaneConfig(mesh=FakeMesh(),
                                                             device="cpu"))


# ---------------------------------------------------------------------------
# the partition engine over the JAX LM's train state (params + optimizer slots)


def _lm_train_state(rule="adam"):
    from mpit_tpu.lm import build, train_state_tree

    model = build(d_model=16, n_heads=2, n_layers=1, seq_len=16, use_flash=False)
    params = model.flat.unravel(model.flat.w0)
    return params, train_state_tree(params, rule)


def _host_tree(tree):
    """The JAX tree as nested dicts of numpy arrays (what the port walks)."""
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_rules(rules):
    return [(pat, _port_spec(spec)) for pat, spec in rules]


class TestTrainStatePartition:
    @pytest.mark.parametrize("rule", ["adam", "rmsprop", "adagrad"])
    def test_every_trainstate_leaf_matched_exactly_once(self, rule):
        from mpit_tpu.lm import PARTITION_RULES, audit_rules

        _params, ts = _lm_train_state(rule)
        report = match_report(_port_rules(PARTITION_RULES), _host_tree(ts))
        assert report == audit_rules(ts)
        assert not any(idx == -2 for idx in report.values())
        assert any(n.startswith("params/") and report[n] >= 0 for n in report)
        assert any(n.startswith("opt_state/") and report[n] >= 0 for n in report)
        assert all(report[n] == -1 for n in report if n.endswith("/t"))

    def test_unmatched_opt_leaf_is_loud(self):
        _params, ts = _lm_train_state("adam")
        rules = [(r"Embed_\d+/embedding", P("mdl", None)), (r"Dense_\d+/bias", P()),
                 (r"LayerNorm_\d+/(scale|bias)", P())]
        jrules = [(pat, JP(*spec)) for pat, spec in rules]
        report = match_report(rules, _host_tree(ts))
        assert report == jdp.match_report(jrules, ts)
        assert any(i == -2 for i in report.values())
        with pytest.raises(ValueError, match="no partition rule"):
            match_partition_rules(rules, _host_tree(ts))

    def test_optax_style_nested_opt_state(self):
        optax = pytest.importorskip("optax")
        from mpit_tpu.lm import PARTITION_RULES

        params, _ = _lm_train_state()
        tree = {"params": params, "opt_state": optax.adam(1e-3).init(params)}
        report = match_report(_port_rules(PARTITION_RULES), _host_tree(tree))
        assert report == jdp.match_report(PARTITION_RULES, tree)
        assert report["opt_state/0/count"] == -1

    def test_shared_zero_slots_compose_with_dedupe_state(self):
        """Rule inits may hand one zeros buffer to several state leaves;
        dedupe_state breaks the sharing leaf by leaf without changing bytes —
        the seam an in-place apply depends on."""
        _params, ts = _lm_train_state("adam")
        host = _host_tree(ts)
        subs = [sub for sub in jax.tree_util.tree_leaves(
            host["opt_state"], is_leaf=lambda x: isinstance(x, dict) and "m" in x)
            if isinstance(sub, dict)]
        assert subs
        for sub in subs:
            z = torch.from_numpy(np.array(sub["m"]))
            shared = {"m": z, "v": z}
            fresh = dedupe_state(shared)
            assert fresh["m"].data_ptr() != fresh["v"].data_ptr()
            np.testing.assert_array_equal(fresh["v"].numpy(), np.asarray(sub["v"]))


# ---------------------------------------------------------------------------
# optimizer parity: device exchange vs host path (and the JAX package), bitwise


def _quadratic(target):
    def vgf(w):
        delta = w - target
        return 0.5 * torch.sum(delta * delta), delta
    return vgf


def _jquadratic(target):
    def vgf(w):
        delta = w - target
        return 0.5 * jnp.sum(delta * delta), delta
    return vgf


def _single_client_gang(dplane, *, rule="add", single_mode=False, seed_servers=True,
                        pkg="torch"):
    if pkg == "jax":
        router = JaxRouter(3)
        servers = [JaxServer(r, [2], router.endpoint(r), rule=rule,
                             single_mode=single_mode) for r in (0, 1)]
        client = JaxClient(2, [0, 1], router.endpoint(2), seed_servers=seed_servers)
    else:
        router = LocalRouter(3)
        servers = [ParamServer(r, [2], router.endpoint(r), rule=rule, device="cpu",
                               single_mode=single_mode,
                               dplane=CPU_PLANE if dplane else None) for r in (0, 1)]
        pc = ParamClient(2, [0, 1], router.endpoint(2), seed_servers=seed_servers)
        client = ExchangeClient(pc, device="cpu") if dplane else pc
    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in threads:
        t.start()
    return servers, client, threads


def _run_optimizer(make_opt, dplane, pkg="torch", steps=6, size=32):
    servers, client, threads = _single_client_gang(dplane, pkg=pkg)
    rng = np.random.default_rng(21)
    w0 = rng.normal(size=size).astype(np.float32)
    target = rng.normal(size=size).astype(np.float32)
    if pkg == "jax":
        w, vgf = jnp.asarray(w0), _jquadratic(jnp.asarray(target))
    else:
        w, vgf = torch.from_numpy(w0), _quadratic(torch.from_numpy(target))
    opt = make_opt(vgf, client)
    w = opt.start(w)
    for _ in range(steps):
        w, _loss = opt.step(w)
    opt.stop()
    join_all(threads)
    if dplane:
        assert client.device_ranks == [0, 1]
        assert sum(int(c.value) for s in servers for c in s._m_dp_ops.values()) > 0
    return np.asarray(w), np.concatenate([np.asarray(s.param) for s in servers])


@pytest.mark.parametrize("name,make_opt,make_jopt", [
    ("downpour", lambda vgf, pc: Downpour(vgf, pc, lr=0.05, su=2),
     lambda vgf, pc: JaxDownpour(vgf, pc, lr=0.05, su=2)),
    ("eamsgd", lambda vgf, pc: EAMSGD(vgf, pc, lr=0.05, mom=0.5, mva=0.3, su=2),
     lambda vgf, pc: JaxEAMSGD(vgf, pc, lr=0.05, mom=0.5, mva=0.3, su=2)),
])
def test_optimizer_parity_device_vs_host(name, make_opt, make_jopt):
    """DOWNPOUR / EAMSGD: the device-exchange run ends bitwise equal to the
    host-path run — local params and the servers' center — and within one
    float32 rounding an update of the JAX package's host path (XLA contracts
    the optimizers' multiply-adds; torch rounds each op)."""
    w_host, center_host = _run_optimizer(make_opt, dplane=False)
    w_dev, center_dev = _run_optimizer(make_opt, dplane=True)
    w_jax, center_jax = _run_optimizer(make_jopt, dplane=False, pkg="jax")
    np.testing.assert_array_equal(w_host, w_dev)
    np.testing.assert_array_equal(center_host, center_dev)
    np.testing.assert_allclose(w_host, w_jax, rtol=0, atol=1e-6)
    np.testing.assert_allclose(center_host, center_jax, rtol=0, atol=1e-6)


def _run_msgd(dplane, pkg="torch", steps=5, size=32):
    servers, client, threads = _single_client_gang(dplane, single_mode=True, pkg=pkg)
    rng = np.random.default_rng(33)
    w0 = rng.normal(size=size).astype(np.float32)
    target = rng.normal(size=size).astype(np.float32)
    if pkg == "jax":
        opt = JaxSingleWorker(_jquadratic(jnp.asarray(target)), client, rule="msgd",
                              lr=0.05, mom=0.9)
        w = jnp.asarray(w0)
    else:
        opt = SingleWorker(_quadratic(torch.from_numpy(target)), client, rule="msgd",
                           lr=0.05, mom=0.9)
        w = torch.from_numpy(w0)
    w = opt.start(w)
    for _ in range(steps):
        w, _loss = opt.step(w)
    opt.stop()
    join_all(threads)
    return np.asarray(w), np.concatenate([np.asarray(s.param) for s in servers])


def test_msgd_parity_device_vs_host():
    """msgd (SingleWorker): whole-param pushes ride the device 'push' op; the
    mirrored server state matches the host run bitwise, and the JAX run within
    one float32 rounding a step (XLA contracts msgd's multiply-adds)."""
    w_host, mirror_host = _run_msgd(dplane=False)
    w_dev, mirror_dev = _run_msgd(dplane=True)
    w_jax, mirror_jax = _run_msgd(dplane=False, pkg="jax")
    np.testing.assert_array_equal(w_host, w_dev)
    np.testing.assert_array_equal(mirror_host, mirror_dev)
    np.testing.assert_array_equal(w_dev, mirror_dev)
    np.testing.assert_allclose(w_host, w_jax, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mirror_host, mirror_jax, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# mixed gangs: device path beside the faulty wire fallback; the packages mixed


def _mixed_gang_final(device_ranks, client_plans, rounds=4, size=64, pkgs=None):
    """2 servers / 2 clients lockstep; servers in ``device_ranks`` serve over
    the device path, the rest over the (possibly faulty) framed wire.
    ``pkgs`` = (server package, client package) mixes the packages on a JAX
    router, each server with its own package's plane."""
    spkg, cpkg = pkgs or ("torch", "torch")
    router = (LocalRouter if (spkg, cpkg) == ("torch", "torch") else JaxRouter)(4)
    sranks, cranks = [0, 1], [2, 3]
    if spkg == "jax":
        import mpit_tpu.ft as jft
        sft = jft.FTConfig(op_deadline_s=0.25, max_retries=8, backoff_base_s=0.005,
                           backoff_cap_s=0.02)
        servers = [JaxServer(r, cranks, router.endpoint(r), rule="add", ft=sft,
                             dplane=jdp.PlaneConfig()) for r in sranks]
    else:
        servers = [ParamServer(r, cranks, router.endpoint(r), rule="add", device="cpu",
                               ft=FAST_FT, dplane=CPU_PLANE if (device_ranks or pkgs)
                               else None) for r in sranks]
    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in threads:
        t.start()
    rng = np.random.default_rng(42)
    w0 = rng.normal(size=size).astype(np.float32)
    gtab = rng.normal(size=(2, rounds, size)).astype(np.float32)
    clients = []
    for r in cranks:
        ep = router.endpoint(r)
        if client_plans and r - 2 in client_plans:
            ep = FaultyTransport(ep, client_plans[r - 2])
        if cpkg == "jax":
            import mpit_tpu.ft as jft
            pc = JaxClient(r, sranks, ep, seed_servers=(r == cranks[0]),
                           ft=jft.FTConfig(op_deadline_s=0.25, max_retries=8,
                                           backoff_base_s=0.005, backoff_cap_s=0.02))
            clients.append(jdp.ExchangeClient(pc))
        else:
            pc = ParamClient(r, sranks, ep, seed_servers=(r == cranks[0]), ft=FAST_FT)
            clients.append(ExchangeClient(pc, device_ranks=device_ranks, device="cpu")
                           if device_ranks or pkgs else pc)
    params = [w0.copy(), np.zeros(size, np.float32)]
    starters = [threading.Thread(target=c.start, args=(p, np.zeros(size, np.float32)),
                                 daemon=True) for c, p in zip(clients, params)]
    for t in starters:
        t.start()
    join_all(starters)
    for r in range(rounds):
        for i, c in enumerate(clients):
            c.grad[:] = gtab[i, r]
            c.async_send_grad()
            c.wait()
    clients[0].async_recv_param()
    clients[0].wait()
    final = clients[0].param.copy()
    retries = sum(c.retries for c in clients)
    dev_ranks = [list(getattr(c, "device_ranks", [])) for c in clients]
    for c in clients:
        c.stop()
    join_all(threads)
    return final, retries, servers, dev_ranks


def test_faultplan_leg_mixed_device_and_faulty_wire_bitwise():
    """Server 0 serves on the device path, server 1 on the wire under a
    drop/dup FaultPlan: final params equal the fault-free all-wire run
    bitwise — retry/dedup cover the wire half while the device half
    bypasses it."""
    clean, _, _, _ = _mixed_gang_final(None, None)
    plans = {i: FaultPlan(seed=i, drop_every=3, dup_every=4, tags=DATA_TAGS)
             for i in range(2)}
    faulty, retries, servers, _ = _mixed_gang_final([0], plans)
    np.testing.assert_array_equal(clean, faulty)
    assert retries > 0, "the plan never actually bit"
    assert sum(int(c.value) for c in servers[0]._m_dp_ops.values()) > 0, \
        "the device path was never exercised"
    assert not servers[1]._m_dp_ops, "the faulty server must have served over the wire"


@pytest.mark.parametrize("pkgs", [("jax", "torch"), ("torch", "jax")])
def test_mixed_packages_ride_the_wire_bitwise(pkgs):
    """Each package's plane registry is its own: a port ExchangeClient never
    finds a JAX plane and a JAX ExchangeClient never finds a port plane, so
    every mixed pair rides the wire (counted as a fallback) — byte for byte
    the all-port device run's result."""
    ref, _, _, dev = _mixed_gang_final([0, 1], None)
    assert dev == [[0, 1], [0, 1]]
    mixed, _, servers, dev = _mixed_gang_final(None, None, pkgs=pkgs)
    assert dev == [[], []]
    np.testing.assert_array_equal(ref, mixed)
    if pkgs[0] == "torch":
        assert not any(s._m_dp_ops for s in servers)


def test_dplane_shardctl_gang_with_a_live_migration_is_bitwise():
    """The twin of ``tools/device_smoke.py``: a 2-server / 2-client shard
    control gang under Adam on device slots with one live migration mid-run
    ends bitwise the host-path static-map gang; the exchange is ineligible
    under shard control (every pair on the wire)."""
    from mpit_tpu_torch.shardctl import RebalancePolicy, ShardController

    size, rounds, migrate_at = 2048, 6, 3
    rng = np.random.default_rng(11)
    w0 = rng.normal(size=size).astype(np.float32)
    gtab = rng.normal(size=(2, rounds, size)).astype(np.float32)

    def run(dplane, migrate):
        router = LocalRouter(5)
        sranks, cranks, ctl_rank = [0, 1], [2, 3], 4
        ft = FTConfig(op_deadline_s=1.0, max_retries=8, backoff_base_s=0.01,
                      backoff_cap_s=0.05)
        servers = [ParamServer(r, cranks, router.endpoint(r), rule="adam", device="cpu",
                               ft=ft, controller_rank=ctl_rank,
                               dplane=CPU_PLANE if dplane else None) for r in sranks]
        threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
        for t in threads:
            t.start()
        ctl = ShardController(ctl_rank, router.endpoint(ctl_rank), sranks, cranks,
                              policy=RebalancePolicy(enabled=False))
        clients = []
        for r in cranks:
            pc = ParamClient(r, sranks, router.endpoint(r), seed_servers=(r == 2),
                             ft=ft, shardctl=True, controller_rank=ctl_rank)
            clients.append(ExchangeClient(pc, device="cpu") if dplane else pc)
        starters = [threading.Thread(target=c.start, args=(
            w0.copy() if i == 0 else np.zeros(size, np.float32),
            np.zeros(size, np.float32)), daemon=True) for i, c in enumerate(clients)]
        for t in starters:
            t.start()
        join_all(starters)
        ctl.pump()
        for rnd in range(rounds):
            if migrate and rnd == migrate_at:
                assert ctl.migrate(1, 0)
            for i, c in enumerate(clients):
                c.grad[:] = gtab[i, rnd]
                c.async_send_grad()
                c.wait()
        clients[0].async_recv_param()
        clients[0].wait()
        out = clients[0].param.copy()
        for c in clients:
            c.stop()
        join_all(threads)
        ctl.pump()
        if dplane:
            assert all(c.device_ranks == [] for c in clients)
        return out, servers

    host, _ = run(False, False)
    dev, servers = run(True, True)
    np.testing.assert_array_equal(host, dev)
    assert servers[0].owned_shards == [0, 1] and servers[1].owned_shards == []


# ---------------------------------------------------------------------------
# exchange lifecycle: loud failures, honest fallbacks


class TestExchangeLifecycle:
    def test_closed_plane_fails_tickets_loudly(self):
        plane = DevicePlane(0, (0, "cpu"))
        ticket = plane.submit(DeviceTicket("grad", 1, 0, None))
        plane.close("test teardown")
        assert ticket.event.is_set()
        assert isinstance(ticket.error, ExchangeError)
        with pytest.raises(ExchangeError, match="closed"):
            plane.submit(DeviceTicket("grad", 1, 0, None))

    def test_non_identity_codec_falls_back_to_wire(self):
        router = LocalRouter(2)
        server = ParamServer(0, [1], router.endpoint(0), rule="add", device="cpu",
                             dplane=PlaneConfig.auto(device="cpu"))
        t = threading.Thread(target=server.start, daemon=True)
        t.start()
        pc = ParamClient(1, [0], router.endpoint(1), seed_servers=True, codec="int8")
        client = ExchangeClient(pc, device="cpu")
        w = np.zeros(2048, np.float32)
        client.start(w, np.zeros_like(w))
        assert client.device_ranks == []  # quantized exchange: wire only
        assert int(client._m_wire_ranks.value) == 1
        client.grad[:] = 1.0
        client.async_send_grad()
        client.wait()
        client.stop()
        join_all([t])
        assert server.grads_applied == 1 and server._hbm.version == 2

    def test_require_device_raises_without_a_plane(self):
        router = LocalRouter(2)
        server = ParamServer(0, [1], router.endpoint(0), rule="add", device="cpu")
        t = threading.Thread(target=server.start, daemon=True)
        t.start()
        pc = ParamClient(1, [0], router.endpoint(1), seed_servers=True)
        client = ExchangeClient(pc, require_device=True, device="cpu")
        w = np.zeros(16, np.float32)
        with pytest.raises(ExchangeError, match="fell back to the wire"):
            client.start(w, np.zeros_like(w))
        client.stop()
        join_all([t])

    def test_sync_device_round_stays_on_device(self):
        servers, client, threads = _single_client_gang(True)
        assert isinstance(client, DeviceSyncAPI)
        w0 = np.ones(32, np.float32)
        client.start(w0.copy(), np.zeros(32, np.float32))
        out = client.sync_device(torch.full((32,), 0.5))
        assert isinstance(out, torch.Tensor)
        np.testing.assert_array_equal(out.numpy(), np.full(32, 1.5, np.float32))
        parts = client.sync_device([torch.full((16,), 0.5)] * 2, concat=False)
        assert [p.shape[0] for p in parts] == [16, 16]
        np.testing.assert_array_equal(torch.cat(parts).numpy(), np.full(32, 2.0))
        # the mirror path reads the same version
        client.async_recv_param()
        client.wait()
        np.testing.assert_array_equal(client.param, np.full(32, 2.0, np.float32))
        client.stop()
        join_all(threads)

    def test_one_shard_sync_device_hands_out_a_copy(self):
        """With one shard the pulled vector is the slot's shared per-version
        clone: sync_device(concat=True) returns a copy of it on every call,
        so a caller updating its vector in place cannot change another
        holder's."""
        router = LocalRouter(2)
        server = ParamServer(0, [1], router.endpoint(0), rule="add", device="cpu",
                             dplane=CPU_PLANE)
        t = threading.Thread(target=server.start, daemon=True)
        t.start()
        client = ExchangeClient(ParamClient(1, [0], router.endpoint(1),
                                            seed_servers=True), device="cpu")
        client.start(np.zeros(16, np.float32), np.zeros(16, np.float32))
        out = client.sync_device(torch.ones(16))
        cached = server._hbm.pull_device()
        assert out.data_ptr() != cached.data_ptr()
        out.add_(5.0)
        np.testing.assert_array_equal(cached.numpy(), np.ones(16, np.float32))
        again = client.sync_device(torch.zeros(16))
        assert again.data_ptr() not in (out.data_ptr(),
                                        server._hbm.pull_device().data_ptr())
        client.stop()
        join_all([t])

    def test_registry_is_the_ports_own(self):
        plane = DevicePlane(7, dpexchange.backend_fingerprint("cpu"))
        dpexchange.publish(7, plane, "twin")
        try:
            assert dpexchange.lookup(7, "twin") is plane
            assert jdp.lookup(7, "twin") is None
        finally:
            dpexchange.withdraw(7, "twin")
        assert dpexchange.lookup(7, "twin") is None


def test_checkpoint_of_a_dplane_server_across_packages(tmp_path):
    """A dplane server's save_state / restore_state (into a slot) use the
    JAX npz layout: each package restores the other's."""
    g = np.random.default_rng(5).normal(size=64).astype(np.float32)
    port = ParamServer(0, [1], LocalRouter(2).endpoint(0), rule="adam", device="cpu",
                       dplane=CPU_PLANE)
    port._alloc_client(1, port._negotiate(1, np.asarray([0, 64, 0], np.int64).tobytes()))
    port._hbm.apply_grad(g)
    port._committed()
    path = port.save_state(str(tmp_path / "port"))
    jserver = JaxServer(0, [1], JaxRouter(2).endpoint(0), rule="adam",
                        dplane=jdp.PlaneConfig())
    jserver.restore_state(path)
    np.testing.assert_array_equal(np.asarray(jserver.param), port._hbm.snapshot_host())
    jpath = jserver.save_state(str(tmp_path / "jax"))
    back = ParamServer(0, [1], LocalRouter(2).endpoint(0), rule="adam", device="cpu",
                       dplane=CPU_PLANE)
    back.restore_state(jpath)
    assert back._hbm is not None and back.param is back._hbm.param
    np.testing.assert_array_equal(back._hbm.snapshot_host(), port._hbm.snapshot_host())
    for k in ("m", "v"):
        np.testing.assert_array_equal(back._hbm.rule_state[k].numpy(),
                                      port._hbm.rule_state[k].numpy())
    assert int(back._hbm.rule_state["t"]) == 1
    assert back._hbm.version == back._snap_version

