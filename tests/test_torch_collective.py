"""The port's collectives (``mpit_tpu_torch/parallel/collective.py``) against
the JAX package's on its CPU mesh, bit for bit.

The twins of ``tests/test_parallel.py``'s collective tests at the same
rank counts: the JAX side runs on the virtual CPU mesh (``dp`` 4 x
``shard`` 2 of the 8 devices the conftest provides), the port on a
one-device mesh with the same named axes, its tensors stacked rank first.
A JAX array sharded over an axis is the port's stack seen flat.  Also
``measure_ps_pushpull``'s keys and formula (its timer patched: a CPU run is
no device measurement) and the port's refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpit_tpu_torch.parallel.collective as tcol
import mpit_tpu_torch.utils.timing as ttiming
from mpit_tpu.parallel import allreduce_mean as jax_allreduce_mean
from mpit_tpu.parallel import make_mesh as jax_make_mesh
from mpit_tpu.parallel import ps_pull as jax_ps_pull
from mpit_tpu.parallel import ps_push as jax_ps_push
from mpit_tpu.parallel import ps_pushpull as jax_ps_pushpull
from mpit_tpu.parallel import ring_shift as jax_ring_shift
from mpit_tpu_torch.parallel import (
    Mesh, allreduce_mean, make_mesh, ps_pull, ps_push, ps_pushpull, psum, ring_shift)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(dp=4, shard=2)


@pytest.fixture(scope="module")
def mesh():
    return Mesh("cpu", dp=4, shard=2)


def _vec(n=16, seed=0):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("data", ["arange", "normal"])
def test_ps_pull_is_the_stack_seen_flat(jax_mesh, mesh, data):
    x = np.arange(16.0, dtype=np.float32) if data == "arange" else _vec()
    want = jax_ps_pull(jax_mesh)(jnp.asarray(x))
    _same(ps_pull(mesh)(torch.from_numpy(x).view(2, 8)), want)


def test_ps_push_delivers_each_owner_its_slice(jax_mesh, mesh):
    g = _vec(seed=1)
    want = jax_ps_push(jax_mesh)(jnp.asarray(g))
    got = ps_push(mesh)(torch.from_numpy(g))
    assert tuple(got.shape) == (2, 8)
    _same(got.reshape(-1), want)


@pytest.mark.parametrize("data", ["arange", "normal"])
def test_ps_push_sums_the_worker_stack(jax_mesh, mesh, data):
    g = (np.broadcast_to(np.arange(16.0, dtype=np.float32), (4, 16)).copy()
         if data == "arange" else np.stack([_vec(seed=s) for s in range(4)]))
    want = jax_ps_push(jax_mesh, reduce_axis="dp")(jnp.asarray(g))
    got = ps_push(mesh, reduce_axis="dp")(torch.from_numpy(g))
    _same(got.reshape(-1), want)
    if data == "arange":
        np.testing.assert_array_equal(got.reshape(-1).numpy(), 4 * np.arange(16.0))


def test_ps_pushpull_round_plain_add(jax_mesh, mesh):
    p, g = _vec(seed=2), _vec(seed=3)
    want_full, want_shard = jax_ps_pushpull(jax_mesh, lambda ps, gs: ps + gs)(
        jnp.asarray(p), jnp.asarray(g))
    full, shards = ps_pushpull(mesh, lambda ps, gs: ps + gs)(
        torch.from_numpy(p).view(2, 8), torch.from_numpy(g))
    _same(full, want_full)
    _same(shards.reshape(-1), want_shard)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis, n", [("shard", 2), ("dp", 4)])
def test_ring_shift_rotates_blocks(jax_mesh, mesh, axis, n, reverse):
    x = np.arange(8 * n, dtype=np.float32)
    want = jax_ring_shift(jax_mesh, axis, reverse=reverse)(jnp.asarray(x))
    got = ring_shift(mesh, axis, reverse=reverse)(torch.from_numpy(x).view(n, 8))
    _same(got.reshape(-1), want)
    if not reverse:  # rank i's block lands at rank i + 1
        assert torch.equal(got[1], torch.from_numpy(x).view(n, 8)[0])


@pytest.mark.parametrize("data", ["arange", "normal"])
def test_allreduce_mean(jax_mesh, mesh, data):
    x = np.arange(8.0, dtype=np.float32) if data == "arange" else _vec(8, seed=4)
    want = jax_allreduce_mean(jax_mesh)(jnp.asarray(x))
    _same(allreduce_mean(mesh)(torch.from_numpy(x).view(4, 2)).reshape(-1), want)


@pytest.mark.parametrize("data", ["arange", "normal"])
@pytest.mark.parametrize("axis, n", [("shard", 2), ("dp", 4)])
def test_psum_adds_the_ranks_in_rank_order(jax_mesh, mesh, axis, n, data):
    """The twin of ``jax.lax.psum`` over an axis: the JAX side replicated,
    the port's stack summed; both bit for bit the rank-order sum."""
    import jax
    from jax.sharding import PartitionSpec as P

    from mpit_tpu.parallel.collective import shard_map

    x = np.arange(8.0 * n, dtype=np.float32) if data == "arange" else _vec(8 * n, seed=5)
    want = shard_map(lambda b: jax.lax.psum(b, axis), mesh=jax_mesh, in_specs=P(axis),
                     out_specs=P(), check_vma=False)(jnp.asarray(x))
    stack = torch.from_numpy(x).view(n, 8)
    got = psum(mesh, axis)(stack)
    _same(got, np.asarray(want))
    order = stack[0]
    for r in range(1, n):
        order = order + stack[r]
    assert torch.equal(got, order)


def test_pad_shards_pads_the_last_shard():
    x = torch.arange(10.0).view(2, 5)
    padded, pad = tcol.pad_shards(x, 3)
    assert pad == 1 and torch.equal(padded, torch.cat([x, torch.zeros(2, 1)], 1))
    same, pad = tcol.pad_shards(x, 5)
    assert pad == 0 and same is x


def test_measure_ps_pushpull_keys_and_formula(monkeypatch):
    """The reference's keys and formula, its payload sized to the shard
    axis (1 on one card), the round a plain add of the gradient; the timer
    patched to a known 2.5 ms a round."""
    seen = {}

    def timer(fn, p, g, **kw):
        seen.update(kw, shapes=(tuple(p.shape), tuple(g.shape)))
        full, shards = fn(p, g)
        seen["full"] = full
        return 2.5e-3

    monkeypatch.setattr(ttiming, "timed_per_call", timer)
    res = tcol.measure_ps_pushpull(4, rounds=7, device="cpu")
    size = 4 * (1 << 20) // 4
    assert set(res) == {"mbs", "per_chip", "devices", "payload_mb", "ms_per_round"}
    assert res["devices"] == 1 and res["payload_mb"] == 4.0
    assert res["mbs"] == 2 * size * 4 / 2.5e-3 / 2**20 == res["per_chip"]
    assert res["ms_per_round"] == 2.5
    assert seen["shapes"] == ((1, size), (size,))
    assert seen["iters"] == 7 and seen["auto_scale"] and seen["min_ratio"] == 8.0
    assert bool((seen["full"] == 1.0).all())


def test_measure_ps_pushpull_times_only_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        tcol.measure_ps_pushpull(1, rounds=2, device="cpu")


@pytest.mark.parametrize("call, exc, match", [
    (lambda m: ps_pull(m)(torch.zeros(3, 4)), ValueError, "stack the 2 ranks"),
    (lambda m: ring_shift(m, "sp")(torch.zeros(2, 4)), ValueError, "not 'sp'"),
    (lambda m: allreduce_mean(m)(torch.zeros(2, 4)), ValueError, "stack the 4 ranks"),
    (lambda m: ps_push(m, reduce_axis="dp")(torch.zeros(3, 8)), ValueError, "4 ranks"),
    (lambda m: ps_pull(Mesh("cuda", shard=2))(torch.zeros(2, 4)), ValueError,
     "the mesh on cuda"),
    (lambda m: Mesh("cpu", sp=0), ValueError, ">= 1 ranks"),
    (lambda m: make_mesh([torch.device("cpu")] * 2, shard=2), NotImplementedError,
     r"make_mesh\(group=\)"),
    (lambda m: psum(m, "dp")(torch.zeros(2, 4)), ValueError, "stack the 4 ranks"),
])
def test_refusals(mesh, call, exc, match):
    with pytest.raises(exc, match=match):
        call(mesh)
