"""The port's device plane over a ``shard`` axis of n ranks, held against the
JAX package on the conftest's 8 CPU devices (``mesh8()``, the JAX test's).

- Placement: each rank's block of a flat vector (sharded at 16 floats,
  replicated at 9), of a rule state, and of every leaf of ``_tree`` under
  ``RULES`` (the column spec ``P(None, "shard")`` included) equals the JAX
  array's ``addressable_shards`` on device ``i`` of ``mesh8()``; the specs
  are JAX's.  ``PlaneConfig.auto()`` over four cards is checked with
  ``torch.cuda.device_count`` patched: placement only, since no test host
  here has four cards.
- ``HbmSlot`` over 8 ranks on the CPU: bit for bit the port's one-rank
  slot and the JAX slot over ``mesh8()``, with one block a rank and the
  rule once a rank an apply.  Where the arithmetic is XLA's and not the
  port's, the existing twins' tolerances hold instead: Adam within the
  fused-update tolerance (rtol 1e-5, atol 1e-6, ``tests/test_torch_rules.py``:
  XLA rounds a few Adam elements differently by an ulp), and the int8 codec
  within one float32 ulp an apply (the JAX package fuses the int8 decode
  into the apply, ROADMAP §C); against the port's one-rank slot both stay
  bit for bit.
- Gangs: DOWNPOUR, EAMSGD and msgd over planes of 8 ranks, the mixed device
  and faulty-wire gang, and ``sync_device`` rounds end bit for bit the
  port's host path and the JAX servers' gang on their 8-device
  ``PlaneConfig.auto()`` planes driven by the same port clients over the
  wire (the servers' ``add`` rule decides the bits); the all-JAX gang,
  whose clients' optimizers XLA contracts, within one float32 rounding an
  update, as ``tests/test_torch_dplane.py`` holds it.
- Checkpoints: a server over 4 ranks saves the gathered whole under the
  one-rank npz keys and bytes, and restores in a one-rank port server and
  in a JAX server, and the other way round.
- A live migration (the twin of ``tools/device_smoke.py``, small): the
  gang over planes of 8 ranks ends bit for bit the port's static host run,
  and the JAX package's 8-device migration gang (``add`` bit for bit, Adam
  within the fused-update tolerance); the migrated slot lies over 8 ranks on
  its new owner.
"""

import threading
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import mpit_tpu.dplane as jdp
import mpit_tpu.ft as jft
from mpit_tpu.comm import codec as jcodec
from mpit_tpu.comm.local import LocalRouter as JaxRouter
from mpit_tpu.optim.downpour import Downpour as JaxDownpour
from mpit_tpu.optim.easgd import EAMSGD as JaxEAMSGD
from mpit_tpu.optim.rules import make as jax_rule
from mpit_tpu.optim.shells import SingleWorker as JaxSingleWorker
from mpit_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpit_tpu.ps import ParamClient as JaxClient
from mpit_tpu.ps import ParamServer as JaxServer
from mpit_tpu.utils.platform import default_devices
from mpit_tpu_torch.comm import codec as codec_mod
from mpit_tpu_torch.comm.local import LocalRouter
from mpit_tpu_torch.dplane import ExchangeClient, HbmSlot, PlaneConfig
from mpit_tpu_torch.dplane import hbm as dphbm
from mpit_tpu_torch.dplane.partition import PartitionSpec as P
from mpit_tpu_torch.dplane.partition import (match_partition_rules, shard_tree,
                                             tree_shardings)
from mpit_tpu_torch.ft import FaultPlan, FaultyTransport, FTConfig
from mpit_tpu_torch.optim import rules as port_rules
from mpit_tpu_torch.optim.downpour import Downpour
from mpit_tpu_torch.optim.easgd import EAMSGD
from mpit_tpu_torch.optim.shells import SingleWorker
from mpit_tpu_torch.parallel.mesh import make_mesh
from mpit_tpu_torch.ps import ParamClient, ParamServer, tags
from mpit_tpu_torch.utils.platform import resolve_device

DATA_TAGS = frozenset({tags.GRAD, tags.PARAM_REQ, tags.PARAM_PUSH})
ADAM_RTOL, ADAM_ATOL = 1e-5, 1e-6
FAST = dict(op_deadline_s=0.25, max_retries=8, backoff_base_s=0.005, backoff_cap_s=0.02)


def mesh8():
    return jax_make_mesh(default_devices(), dp=1)


def plane(n=8, **kw):
    """The port's plane over ``shard=n`` virtual ranks of the CPU."""
    return PlaneConfig(mesh=make_mesh(device="cpu", dp=1, shard=n), device="cpu", **kw)


def jax_blocks(arr):
    """A JAX array's shard on each device of ``mesh8()``, in mesh order."""
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [by_device[d] for d in mesh8().devices.flat]


def port_blocks(sharded):
    return [b.numpy() for b in sharded.blocks]


def assert_blocks_equal(port, jax_arr):
    want = jax_blocks(jax_arr)
    got = port_blocks(port)
    assert [b.shape for b in got] == [b.shape for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def assert_layout(slot, n=8):
    """An n-rank slot really holds n blocks, each its own storage."""
    assert slot.ranks == n and len(slot.states) == n
    assert len({b.data_ptr() for b in slot.blocks}) == n


def join_all(threads, timeout=30):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "role thread did not stop (hang)"


@pytest.fixture
def k3_calls(monkeypatch):
    """Counts K3's calls (its plain twin runs them on the CPU)."""
    calls = [0]
    real = port_rules.fused_adam

    def counting(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(port_rules, "fused_adam", counting)
    return calls


def _tree(seed: int):
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


RULES_J = [
    (r"embed/table", JP("shard", None)),
    (r"attn/.*bias", JP(None)),
    (r"attn", JP(None, "shard")),
    (r"mlp/w1", JP(None, "shard")),
    (r"mlp/w2", JP("shard", None)),
    (r".*", JP()),
]
RULES = [(pat, P(*tuple(spec))) for pat, spec in RULES_J]


# ---------------------------------------------------------------------------
# placement


class TestPlacement:
    @pytest.mark.parametrize("size", [16, 9])
    def test_flat_vector_blocks_equal_jax_shards(self, size):
        arr = np.random.default_rng(size).normal(size=size).astype(np.float32)
        placed = dphbm.place_flat(arr, plane())
        jplaced = jdp.place_flat(arr, jdp.PlaneConfig(mesh=mesh8()))
        assert_blocks_equal(placed, jplaced)
        spec = dphbm.flat_sharding(plane(), size).spec
        assert tuple(spec) == tuple(jdp.hbm.flat_sharding(
            jdp.PlaneConfig(mesh=mesh8()), size).spec)
        assert tuple(spec) == (("shard",) if size % 8 == 0 else ())
        np.testing.assert_array_equal(placed.gather().numpy(), arr)

    @pytest.mark.parametrize("size", [16, 9])
    def test_state_leaves_follow_the_param_and_scalars_replicate(self, size):
        rng = np.random.default_rng(size + 1)
        state = {"m": rng.normal(size=size).astype(np.float32),
                 "v": rng.normal(size=size).astype(np.float32),
                 "t": np.asarray(3, np.int32)}
        placed = dphbm.place_state(state, plane())
        jplaced = jdp.place_state(state, jdp.PlaneConfig(mesh=mesh8()))
        for k in state:
            assert_blocks_equal(placed[k], jplaced[k])
        assert [int(b) for b in placed["t"].blocks] == [3] * 8

    @pytest.mark.parametrize("seed", [0, 1])
    def test_tree_leaves_blocks_equal_jax_shards(self, seed):
        tree = _tree(seed)
        specs = match_partition_rules(RULES, tree)
        assert specs["layer_0"]["attn"]["q"] == P(None, "shard")
        placed = shard_tree(tree, tree_shardings(make_mesh(device="cpu", dp=1, shard=8),
                                                 specs, tree))
        jspecs = jdp.match_partition_rules(RULES_J, tree)
        jplaced = jdp.partition.shard_tree(tree, jdp.tree_shardings(mesh8(), jspecs, tree))
        for path in (("embed", "table"), ("layer_0", "attn", "q"),
                     ("layer_0", "attn", "bias"), ("layer_0", "mlp", "w1"),
                     ("layer_0", "mlp", "w2"), ("norm", "scale"), ("step",)):
            got, want, leaf = placed, jplaced, tree
            for key in path:
                got, want, leaf = got[key], want[key], leaf[key]
            assert tuple(got.placement.spec) == tuple(want.sharding.spec), path
            assert_blocks_equal(got, want)
            np.testing.assert_array_equal(got.gather().numpy(), leaf)
        # the column spec: rank i holds columns [i, i+1) of every row
        q = placed["layer_0"]["attn"]["q"]
        assert [tuple(b.shape) for b in q.blocks] == [(8, 1)] * 8
        assert all(b.is_contiguous() for b in q.blocks)

    def test_auto_lays_the_shard_axis_over_every_card(self):
        """``auto()`` over four visible cards: rank i on ``cuda:i``,
        placement only (no allocation)."""
        from mpit_tpu_torch.train.launch import dplane_cfg
        from mpit_tpu_torch.utils.config import Config

        with mock.patch.object(torch.cuda, "device_count", return_value=4):
            cfg = PlaneConfig.auto(namespace="x")
            assert PlaneConfig.auto(device="cpu").mesh is None
            # the --dplane server's config is auto()'s; a CPU run stays on the CPU
            assert dplane_cfg(Config(device="cuda")).devices == cfg.devices
            assert dplane_cfg(Config(device="cpu")).mesh is None
        assert cfg.namespace == "x" and cfg.mesh.shape == {"dp": 1, "shard": 4}
        assert cfg.devices == ("cuda:0", "cuda:1", "cuda:2", "cuda:3")
        assert dphbm.plane_ranks(cfg) == 4
        place = dphbm.flat_sharding(cfg, 16)
        assert place.spec == P("shard")
        assert place.devices == tuple(torch.device("cuda", i) for i in range(4))
        assert [idx[0] for idx in place.rank_index((16,))] == [
            slice(4 * i, 4 * i + 4) for i in range(4)]
        assert dphbm.flat_sharding(cfg, 18).spec == P()
        with mock.patch.object(torch.cuda, "device_count", return_value=1):
            assert PlaneConfig.auto().mesh is None
        assert PlaneConfig.auto().mesh is None  # this host: no card
        # a card is named by index; without a card it raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda:1")
        with pytest.raises(ValueError, match="cuda, cuda:i or cpu"):
            resolve_device("cuda:x")


# ---------------------------------------------------------------------------
# HbmSlot over 8 ranks


def _slots(size, rule, **kw):
    port = HbmSlot(size, port_rules.make(rule), config=plane(**kw))
    one = HbmSlot(size, port_rules.make(rule), config=PlaneConfig(device="cpu", **kw))
    jslot = jdp.HbmSlot(size, jax_rule(rule), config=jdp.PlaneConfig(mesh=mesh8(), **kw))
    return port, one, jslot


class TestMeshSlot:
    @pytest.mark.parametrize("size", [64, 9])
    def test_adam_applies_once_a_rank(self, size, k3_calls):
        port, one, jslot = _slots(size, "adam")
        assert_layout(port)
        rng = np.random.default_rng(size)
        for _ in range(4):
            g = rng.normal(size=size).astype(np.float32)
            for s in (port, one, jslot):
                s.apply_grad(g)
        # one K3 a rank an apply on the mesh slot, one an apply on the other
        assert k3_calls[0] == 4 * 8 + 4
        np.testing.assert_array_equal(port.snapshot_host(), one.snapshot_host())
        for k in ("m", "v"):
            np.testing.assert_array_equal(port.state_host()[k], one.state_host()[k])
        assert [int(st["t"]) for st in port.states] == [4] * 8
        assert port.state_host()["t"].shape == () and int(port.state_host()["t"]) == 4
        np.testing.assert_allclose(port.snapshot_host(), np.asarray(jslot.snapshot_host()),
                                   rtol=ADAM_RTOL, atol=ADAM_ATOL)
        want = [(8,)] * 8 if size == 64 else [(9,)] * 8
        assert [tuple(b.shape) for b in port.blocks] == want
        assert [b.shape for b in jax_blocks(jslot.param)] == want

    @pytest.mark.parametrize("codec_name", ["bf16", "int8"])
    def test_apply_wire_decodes_once_then_splits(self, codec_name):
        size = 64
        port, one, jslot = _slots(size, "add")
        codec, jc = codec_mod.get(codec_name), jcodec.get(codec_name)
        rng = np.random.default_rng(2)
        applies, ulp_sum = 4, np.zeros(size)
        for _ in range(applies):
            wire = np.zeros(codec.wire_nbytes(size), np.uint8)
            codec.encode_into(rng.normal(size=size).astype(np.float32), wire)
            for s in (port, one):
                s.apply_wire(codec, codec.split_wire(wire, size))
            jslot.apply_wire(jc, jc.split_wire(wire, size))
            # one float32 ulp of each apply's result
            ulp_sum += np.spacing(np.abs(np.asarray(jslot.snapshot_host())))
        got, ref = port.snapshot_host(), np.asarray(jslot.snapshot_host())
        np.testing.assert_array_equal(got, one.snapshot_host())
        if codec_name == "int8":
            gap = np.abs(got.astype(np.float64) - ref)
            assert (gap <= ulp_sum).all(), (gap / ulp_sum).max()
        else:
            np.testing.assert_array_equal(got, ref)
        assert port.version == applies

    @pytest.mark.parametrize("rule", ["add", "rmsprop"])
    def test_chunks_cross_rank_boundaries(self, rule):
        """10,000 floats (1,250 a rank) in 3,000-float chunks: every chunk
        but the last crosses a rank boundary and applies window by window."""
        size, csize = 10000, 3000
        whole, one, jslot = _slots(size, rule)
        chunked = HbmSlot(size, port_rules.make(rule), config=plane())
        codec, jc = codec_mod.get("none"), jcodec.get("none")
        rng = np.random.default_rng(5)
        for _ in range(2):
            g = rng.normal(size=size).astype(np.float32)
            whole.apply_grad(g)
            one.apply_grad(g)
            jslot.apply_grad(g)
            spans = [(lo, min(lo + csize, size)) for lo in range(0, size, csize)]
            for k, (lo, hi) in enumerate(spans):
                chunked.apply_wire_chunk(codec, g[lo:hi], lo, hi - lo,
                                         commit=(k == len(spans) - 1))
        assert chunked.version == whole.version == 2
        np.testing.assert_array_equal(chunked.snapshot_host(), whole.snapshot_host())
        np.testing.assert_array_equal(chunked.snapshot_host(), one.snapshot_host())
        for k, v in one.state_host().items():
            np.testing.assert_array_equal(chunked.state_host()[k], v)
        if rule == "add":
            np.testing.assert_array_equal(chunked.snapshot_host(),
                                          np.asarray(jslot.snapshot_host()))
            jchunk = jdp.HbmSlot(size, jax_rule(rule), config=jdp.PlaneConfig(mesh=mesh8()))
            rng = np.random.default_rng(5)
            for _ in range(2):
                g = rng.normal(size=size).astype(np.float32)
                for k, (lo, hi) in enumerate(spans):
                    jchunk.apply_wire_chunk(jc, g[lo:hi], lo, hi - lo,
                                            commit=(k == len(spans) - 1))
            np.testing.assert_array_equal(chunked.snapshot_host(),
                                          np.asarray(jchunk.snapshot_host()))

    @pytest.mark.parametrize("size", [64, 9])
    def test_seed_scatters_and_donate_false_writes_fresh_blocks(self, size):
        port, one, jslot = _slots(size, "add", donate=False)
        rng = np.random.default_rng(9)
        value = rng.normal(size=size).astype(np.float32)
        old = list(port.blocks)
        for s in (port, one, jslot):
            s.seed(value)
        assert all(a.data_ptr() != b.data_ptr() for a, b in zip(old, port.blocks))
        assert not any(b.any() for b in old)  # the old blocks keep their values
        for block, (lo, hi) in zip(port.blocks, port.windows):
            np.testing.assert_array_equal(block.numpy(), value[lo:hi])
        assert_blocks_equal(port, jslot.param)
        seeded = list(port.blocks)
        g = rng.normal(size=size).astype(np.float32)
        for s in (port, one, jslot):
            s.apply_grad(g)
        for a, b in zip(seeded, port.blocks):
            assert a.data_ptr() != b.data_ptr()
        for block, (lo, hi) in zip(seeded, port.windows):
            np.testing.assert_array_equal(block.numpy(), value[lo:hi])
        np.testing.assert_array_equal(port.snapshot_host(), one.snapshot_host())
        np.testing.assert_array_equal(port.snapshot_host(), np.asarray(jslot.snapshot_host()))
        assert_blocks_equal(port, jslot.param)
        # donating: the blocks are written in place
        donating = HbmSlot(size, port_rules.make("add"), config=plane())
        ptrs = [b.data_ptr() for b in donating.blocks]
        donating.seed(value)
        donating.apply_grad(g)
        assert [b.data_ptr() for b in donating.blocks] == ptrs
        np.testing.assert_array_equal(donating.snapshot_host(), port.snapshot_host())

    def test_caches_count_once_a_version_and_a_pull_survives(self):
        slot = HbmSlot(64, port_rules.make("add"), config=plane())
        a, b = slot.snapshot_host(), slot.snapshot_host()
        assert a is b and int(slot._m_copies.value) == 1
        p1, p2 = slot.pull_device(), slot.pull_device()
        assert p1 is p2 and int(slot._m_gathers.value) == 1
        assert p1.shape == (64,)
        assert p1.data_ptr() not in {blk.data_ptr() for blk in slot.blocks}
        slot.apply_grad(np.ones(64, np.float32))
        np.testing.assert_array_equal(p1.numpy(), np.zeros(64, np.float32))
        assert not a.any()
        p3 = slot.pull_device()
        assert p3 is not p1 and int(slot._m_gathers.value) == 2
        np.testing.assert_array_equal(p3.numpy(), np.ones(64, np.float32))
        assert slot.snapshot_host() is not a and int(slot._m_copies.value) == 2
        slot.seed(np.full(64, 3.0, np.float32))
        np.testing.assert_array_equal(p3.numpy(), np.ones(64, np.float32))

    @pytest.mark.parametrize("size", [64, 9])
    def test_describe_counts_the_ranks_as_jax_does(self, size):
        port, one, jslot = _slots(size, "add")
        d = port.describe()
        assert d["devices"] == jslot.describe()["devices"] == 8
        assert d["spec"] == (["shard"] if size % 8 == 0 else [])
        assert d["device_set"] == ["cpu"]
        assert one.describe()["devices"] == 1 and one.describe()["spec"] is None
        with pytest.raises(RuntimeError, match="one block a rank"):
            port.param
        assert one.param is one.blocks[0]


# ---------------------------------------------------------------------------
# gangs over planes of 8 ranks


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


def _shard_values(server):
    if isinstance(server, JaxServer):
        return np.asarray(server.param)
    if server._hbm is not None:
        return server._hbm.snapshot_host()
    return server.param.numpy().copy()


def _single_client_gang(kind, *, single_mode=False):
    """2 servers, one client.  ``kind``: "host" (port, no plane), "mesh"
    (port servers on planes of 8 ranks, the device exchange), "jax8" (JAX
    servers on their 8-device auto planes, the port client over the wire),
    "jax" (the all-JAX gang on 8-device planes)."""
    if kind in ("jax8", "jax"):
        router = JaxRouter(3)
        servers = [JaxServer(r, [2], router.endpoint(r), rule="add",
                             single_mode=single_mode, dplane=jdp.PlaneConfig.auto())
                   for r in (0, 1)]
        cls = JaxClient if kind == "jax" else ParamClient
        client = cls(2, [0, 1], router.endpoint(2), seed_servers=True)
    else:
        router = LocalRouter(3)
        servers = [ParamServer(r, [2], router.endpoint(r), rule="add", device="cpu",
                               single_mode=single_mode,
                               dplane=plane() if kind == "mesh" else None)
                   for r in (0, 1)]
        client = ParamClient(2, [0, 1], router.endpoint(2), seed_servers=True)
        if kind == "mesh":
            client = ExchangeClient(client, device="cpu")
    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in threads:
        t.start()
    return servers, client, threads


def _check_mesh_servers(servers, client):
    assert client.device_ranks == [0, 1]
    for s in servers:
        assert_layout(s._hbm)
        assert sum(int(c.value) for c in s._m_dp_ops.values()) > 0
        with pytest.raises(RuntimeError, match="one block a rank"):
            s.param


def _run_optimizer(make_opt, kind, size, steps=6):
    servers, client, threads = _single_client_gang(kind)
    rng = np.random.default_rng(21)
    w0 = rng.normal(size=size).astype(np.float32)
    target = rng.normal(size=size).astype(np.float32)
    if kind == "jax":
        w, vgf = jnp.asarray(w0), _jquadratic(jnp.asarray(target))
    else:
        w, vgf = torch.from_numpy(w0), _quadratic(torch.from_numpy(target))
    opt = make_opt[kind == "jax"](vgf, client)
    w = opt.start(w)
    for _ in range(steps):
        w, _loss = opt.step(w)
    opt.stop()
    join_all(threads)
    if kind == "mesh":
        _check_mesh_servers(servers, client)
    return np.asarray(w), np.concatenate([_shard_values(s) for s in servers])


@pytest.mark.parametrize("size", [64, 36])
@pytest.mark.parametrize("name,make_opt", [
    ("downpour", (lambda vgf, pc: Downpour(vgf, pc, lr=0.05, su=2),
                  lambda vgf, pc: JaxDownpour(vgf, pc, lr=0.05, su=2))),
    ("eamsgd", (lambda vgf, pc: EAMSGD(vgf, pc, lr=0.05, mom=0.5, mva=0.3, su=2),
                lambda vgf, pc: JaxEAMSGD(vgf, pc, lr=0.05, mom=0.5, mva=0.3, su=2))),
])
def test_optimizer_parity_device_vs_host(name, make_opt, size):
    """DOWNPOUR / EAMSGD over planes of 8 ranks (a shard of 32 floats cut 4
    a rank; of 18, replicated): bit for bit the host path and the JAX
    servers' 8-device gang; the all-JAX gang within one rounding."""
    w_host, center_host = _run_optimizer(make_opt, "host", size)
    w_dev, center_dev = _run_optimizer(make_opt, "mesh", size)
    w_j8, center_j8 = _run_optimizer(make_opt, "jax8", size)
    w_jax, center_jax = _run_optimizer(make_opt, "jax", size)
    np.testing.assert_array_equal(w_host, w_dev)
    np.testing.assert_array_equal(center_host, center_dev)
    np.testing.assert_array_equal(w_dev, w_j8)
    np.testing.assert_array_equal(center_dev, center_j8)
    np.testing.assert_allclose(w_dev, w_jax, rtol=0, atol=1e-6)
    np.testing.assert_allclose(center_dev, center_jax, rtol=0, atol=1e-6)


def _run_msgd(kind, steps=5, size=64):
    servers, client, threads = _single_client_gang(kind, single_mode=True)
    rng = np.random.default_rng(33)
    w0 = rng.normal(size=size).astype(np.float32)
    target = rng.normal(size=size).astype(np.float32)
    if kind == "jax":
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
    if kind == "mesh":
        _check_mesh_servers(servers, client)
    return np.asarray(w), np.concatenate([_shard_values(s) for s in servers])


def test_msgd_parity_device_vs_host():
    """msgd's whole-param pushes ride the device 'push' op and scatter into
    the 8 ranks' blocks: the mirror equals the host run, the JAX servers'
    8-device gang and the worker's own params bit for bit."""
    w_host, mirror_host = _run_msgd("host")
    w_dev, mirror_dev = _run_msgd("mesh")
    w_j8, mirror_j8 = _run_msgd("jax8")
    w_jax, mirror_jax = _run_msgd("jax")
    np.testing.assert_array_equal(w_host, w_dev)
    np.testing.assert_array_equal(mirror_host, mirror_dev)
    np.testing.assert_array_equal(w_dev, mirror_dev)
    np.testing.assert_array_equal(w_dev, w_j8)
    np.testing.assert_array_equal(mirror_dev, mirror_j8)
    np.testing.assert_allclose(w_dev, w_jax, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mirror_dev, mirror_jax, rtol=0, atol=1e-6)


def _mixed_gang_final(kind, device_ranks=None, client_plans=None, rounds=4, size=64):
    """2 servers / 2 lockstep clients.  ``kind`` "port": port servers, on
    planes of 8 ranks where ``device_ranks`` is given (those ranks on the
    device path, the rest on the possibly faulty wire); "jax8": JAX servers
    on their 8-device auto planes, port clients over the wire."""
    router = LocalRouter(4) if kind == "port" else JaxRouter(4)
    sranks, cranks = [0, 1], [2, 3]
    if kind == "jax8":
        servers = [JaxServer(r, cranks, router.endpoint(r), rule="add",
                             ft=jft.FTConfig(**FAST), dplane=jdp.PlaneConfig.auto())
                   for r in sranks]
    else:
        servers = [ParamServer(r, cranks, router.endpoint(r), rule="add", device="cpu",
                               ft=FTConfig(**FAST),
                               dplane=plane() if device_ranks else None)
                   for r in sranks]
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
        pc = ParamClient(r, sranks, ep, seed_servers=(r == cranks[0]), ft=FTConfig(**FAST))
        clients.append(ExchangeClient(pc, device_ranks=device_ranks, device="cpu")
                       if device_ranks else pc)
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
    for c in clients:
        c.stop()
    join_all(threads)
    return final, retries, servers


def test_faultplan_leg_mixed_device_and_faulty_wire_bitwise():
    """Server 0 on the device path over 8 ranks, server 1 (its slot over 8
    ranks too) on the wire under a drop/dup plan: the fault-free all-wire
    run's bits, and the JAX servers' 8-device gang's."""
    clean, _, _ = _mixed_gang_final("port")
    jax8, _, _ = _mixed_gang_final("jax8")
    plans = {i: FaultPlan(seed=i, drop_every=3, dup_every=4, tags=DATA_TAGS)
             for i in range(2)}
    faulty, retries, servers = _mixed_gang_final("port", [0], plans)
    np.testing.assert_array_equal(clean, faulty)
    np.testing.assert_array_equal(jax8, faulty)
    assert retries > 0, "the plan never actually bit"
    assert sum(int(c.value) for c in servers[0]._m_dp_ops.values()) > 0
    assert not servers[1]._m_dp_ops, "the faulty server must have served over the wire"
    for s in servers:
        assert_layout(s._hbm)
        assert int(s._hbm._m_applies.value) == 8  # 4 rounds x 2 clients


def test_sync_device_rounds_over_8_ranks():
    """``sync_device`` rounds from seeded updates: the per-shard grads apply
    to the 8 ranks' blocks, the pulls gather them onto the client's device;
    bit for bit the wire path's rounds and the JAX exchange's over its
    8-device auto planes."""
    size, rounds = 64, 4
    rng = np.random.default_rng(17)
    w0 = rng.normal(size=size).astype(np.float32)
    ups = rng.normal(size=(rounds, size)).astype(np.float32)

    def run(kind):
        if kind == "jax":
            servers, client, threads = _single_client_gang("jax")
            client = jdp.ExchangeClient(client)
        else:
            servers, client, threads = _single_client_gang(
                "mesh" if kind == "mesh" else "host")
            if kind == "host":
                client = ExchangeClient(client, device="cpu")  # every shard on the wire
        client.start(w0.copy(), np.zeros(size, np.float32))
        outs = []
        for r in range(rounds):
            up = jnp.asarray(ups[r]) if kind == "jax" else torch.from_numpy(ups[r].copy())
            outs.append(np.asarray(client.sync_device(up)))
        if kind != "jax":
            parts = client.sync_device([torch.zeros(size // 2)] * 2, concat=False)
            assert [p.device.type for p in parts] == ["cpu", "cpu"]
            outs.append(torch.cat(parts).numpy())
        client.stop()
        join_all(threads)
        if kind == "mesh":
            _check_mesh_servers(servers, client)
        return np.stack(outs)

    dev, host, jax_ = run("mesh"), run("host"), run("jax")
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(dev[:rounds], jax_)
    acc = w0.copy()
    for up in ups:
        acc = acc + up
    np.testing.assert_array_equal(dev[-1], acc)


@pytest.mark.parametrize("n", [4, 5], ids=["replicated", "sharded"])
def test_launch_gang_over_a_plane_of_n_ranks(n):
    """``run_gang`` with ``--dplane 1`` whose ``dplane_cfg`` gives a plane of
    n ranks (what ``auto()`` gives a process that sees n cards): the gang
    trains to its end, each server's result holds its whole shard (325
    floats: replicated over 4 ranks, cut in 5 blocks over 5), and every
    result is bit for bit the one-rank plane's and the wire gang's."""
    from mpit_tpu_torch.train import launch

    cfg = launch.LAUNCH_DEFAULTS.merged({"np": 3, "device": "cpu", "side": 8,
                                         "epochs": 1, "opt": "downpour"})
    wire, one = launch.run_gang(3, cfg), launch.run_gang(3, cfg.merged(dplane=1))
    ranks = []
    start = ParamServer.start

    def counted(server):
        start(server)
        ranks.append(server._hbm.ranks)

    with mock.patch.object(launch, "dplane_cfg", lambda c: plane(n)), \
            mock.patch.object(ParamServer, "start", counted):
        mesh = launch.run_gang(3, cfg.merged(dplane=1))
    assert ranks == [n, n]
    for rank, res in mesh.items():
        key = "param" if res["role"] == "server" else "w"
        if key == "param":
            assert res["param"].shape == (325,)
        assert torch.equal(res[key], one[rank][key]), rank
        assert torch.equal(res[key], wire[rank][key]), rank


# ---------------------------------------------------------------------------
# checkpoints across rank counts and packages


def _port_server(n):
    cfg = plane(n) if n > 1 else PlaneConfig(device="cpu")
    return ParamServer(0, [1], LocalRouter(2).endpoint(0), rule="adam", device="cpu",
                       dplane=cfg)


def _trained_port_server(n, size=64, applies=3):
    server = _port_server(n)
    server._alloc_client(1, server._negotiate(
        1, np.asarray([0, size, 0], np.int64).tobytes()))
    rng = np.random.default_rng(5)
    for _ in range(applies):
        server._hbm.apply_grad(rng.normal(size=size).astype(np.float32))
        server._committed()
    return server


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "meta"}


@pytest.mark.parametrize("src,dst", [(4, "one"), (4, "jax"), ("one", 4), ("jax", 4)])
def test_checkpoint_round_trips_across_rank_counts(tmp_path, src, dst):
    """A server over 4 ranks writes the gathered whole under the one-rank
    npz keys and bytes; a one-rank port server and a JAX server restore it,
    and a 4-rank server restores theirs, each bit for bit."""
    ref = _trained_port_server(1)
    want_param = ref._hbm.snapshot_host()
    want_state = ref._hbm.state_host()
    ref_path = ref.save_state(str(tmp_path / "ref"))
    if src == 4:
        server = _trained_port_server(4)
        assert_layout(server._hbm, 4)
        path = server.save_state(str(tmp_path / "src"))
        got = _npz(path)
        assert sorted(got) == sorted(_npz(ref_path))
        for k, v in _npz(ref_path).items():
            assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k
    elif src == "one":
        path = ref_path
    else:
        jserver = JaxServer(0, [1], JaxRouter(2).endpoint(0), rule="adam",
                            dplane=jdp.PlaneConfig.auto())
        jserver.restore_state(ref_path)
        path = jserver.save_state(str(tmp_path / "jax"))
    if dst == "jax":
        back = JaxServer(0, [1], JaxRouter(2).endpoint(0), rule="adam",
                         dplane=jdp.PlaneConfig.auto())
        back.restore_state(path)
        np.testing.assert_array_equal(np.asarray(back.param), want_param)
        for k in ("m", "v", "t"):
            np.testing.assert_array_equal(np.asarray(back.rule_state[k]), want_state[k])
        assert len(back.param.sharding.device_set) == 8
        return
    back = _port_server(4 if dst == 4 else 1)
    back.restore_state(path)
    if dst == 4:
        assert_layout(back._hbm, 4)
        assert [int(st["t"]) for st in back._hbm.states] == [3] * 4
    np.testing.assert_array_equal(back._hbm.snapshot_host(), want_param)
    for k, v in want_state.items():
        np.testing.assert_array_equal(back._hbm.state_host()[k], v)
    assert back._hbm.version == back._snap_version


# ---------------------------------------------------------------------------
# a live migration between servers whose slots lie over 8 ranks


def _sc_gang(pkg, dplane, migrate, rule, size=4096, rounds=8, migrate_at=4):
    """The ``tools/device_smoke.py`` gang at small size: 2 servers, 2
    clients and a controller; one live migration of shard 1 to server 0 at
    round ``migrate_at`` of ``rounds``."""
    if pkg == "jax":
        from mpit_tpu.shardctl import ShardController as Ctl
        router, Server, Client, ft = JaxRouter(5), JaxServer, JaxClient, jft.FTConfig
        cfg = jdp.PlaneConfig(mesh=mesh8()) if dplane else None
        skw = {}
    else:
        from mpit_tpu_torch.shardctl import ShardController as Ctl
        router, Server, Client, ft = LocalRouter(5), ParamServer, ParamClient, FTConfig
        cfg = plane() if dplane else None
        skw = {"device": "cpu"}
    fkw = dict(op_deadline_s=1.0, max_retries=8, backoff_base_s=0.01, backoff_cap_s=0.05)
    sranks, cranks, ctl_rank = [0, 1], [2, 3], 4
    servers = [Server(r, cranks, router.endpoint(r), rule=rule, ft=ft(**fkw),
                      controller_rank=ctl_rank, dplane=cfg, **skw) for r in sranks]
    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in threads:
        t.start()
    from mpit_tpu_torch.shardctl import RebalancePolicy
    from mpit_tpu.shardctl import RebalancePolicy as JaxPolicy
    policy = (JaxPolicy if pkg == "jax" else RebalancePolicy)(enabled=False)
    ctl = Ctl(ctl_rank, router.endpoint(ctl_rank), sranks, cranks, policy=policy)
    clients = [Client(r, sranks, router.endpoint(r), seed_servers=(r == cranks[0]),
                      ft=ft(**fkw), shardctl=True, controller_rank=ctl_rank)
               for r in cranks]
    rng = np.random.default_rng(11)
    w0 = rng.normal(size=size).astype(np.float32)
    gtab = rng.normal(size=(2, rounds, size)).astype(np.float32)
    starters = [threading.Thread(target=c.start, args=(
        w0.copy() if i == 0 else np.zeros(size, np.float32),
        np.zeros(size, np.float32)), daemon=True) for i, c in enumerate(clients)]
    for t in starters:
        t.start()
    join_all(starters)
    ctl.pump()
    for r in range(rounds):
        if migrate and r == migrate_at:
            assert ctl.migrate(1, 0)
        for i, c in enumerate(clients):
            c.grad[:] = gtab[i, r]
            c.async_send_grad()
            c.wait()
    clients[0].async_recv_param()
    clients[0].wait()
    final = clients[0].param.copy()
    for c in clients:
        c.stop()
    join_all(threads)
    ctl.pump()
    return final, servers


@pytest.mark.parametrize("rule", ["add", "adam"])
def test_live_migration_over_8_ranks(rule, k3_calls):
    static, _ = _sc_gang("torch", False, False, rule)
    k3_calls[0] = 0
    migrated, servers = _sc_gang("torch", True, True, rule)
    jax_migrated, jservers = _sc_gang("jax", True, True, rule)
    np.testing.assert_array_equal(static, migrated)
    if rule == "add":
        np.testing.assert_array_equal(jax_migrated, migrated)
    else:
        np.testing.assert_allclose(migrated, jax_migrated, rtol=ADAM_RTOL, atol=ADAM_ATOL)
        # 2 clients x 8 rounds x 2 shards, K3 once a rank an apply
        assert sum(s.grads_applied for s in servers) == 32
        assert k3_calls[0] == 32 * 8
    assert servers[0].owned_shards == [0, 1] and servers[1].owned_shards == []
    assert jservers[0].owned_shards == [0, 1]
    for sid in (0, 1):
        slot = servers[0]._slots[sid]
        assert slot.param is None and slot.rule_state is None
        assert_layout(slot.hbm)
        if rule == "add":
            np.testing.assert_array_equal(slot.snapshot_host(),
                                          np.asarray(jservers[0].shard_param(sid)))
        else:
            assert [int(st["t"]) for st in slot.hbm.states] == [16] * 8
    # the migrated slot lies over the mesh's 8 ranks on its new owner, as the
    # JAX slot lies over its 8 devices
    assert servers[0]._slots[1].hbm.describe()["devices"] == len(
        jservers[0].shard_param(1).sharding.device_set) == 8
