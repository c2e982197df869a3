"""The port's ring attention (``mpit_tpu_torch/parallel/ring_attention.py``)
against the JAX package's on its virtual CPU mesh.

B 2, L 64, H 2, D 16 at n = 2 and 4 ranks, the inputs drawn from a seed
with numpy.  Both of the port's impls run on the CPU: ``"plain"``
differentiated by autograd, and ``"flash"``, whose wrappers run the
kernels' plain twins there.  They are held against JAX's ``jnp`` ring in
the forward (causal and not, contiguous and zigzag) and the gradients, and
the flash ring against JAX's ``pallas`` ring in interpret mode at n = 2 for
each layout, within the reference's own tolerances
(``tests/test_ring_attention.py``): atol 3e-5 forward, 5e-5 gradients.
Also: the zigzag permutation and its round trip against JAX's, the
reference's refusals, the merge identity that lets a dead pair go
unlaunched, and the pairs each layout computes (``n**2`` contiguous,
``n(2n+1)`` zigzag), read from a log of the calls the flash ring makes.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.parallel import ring_attention as jax_ring_attention
from mpit_tpu.parallel import sp_mesh as jax_sp_mesh
from mpit_tpu.parallel import zigzag_permute as jax_zigzag_permute
from mpit_tpu.parallel import zigzag_unpermute as jax_zigzag_unpermute
from mpit_tpu.utils.platform import default_devices
from mpit_tpu_torch.ops.flash_attention import (
    attention_reference, block_attention_partial, merge_partials)
from mpit_tpu_torch.parallel import (
    Mesh, ring_attention, sp_mesh, zigzag_permute, zigzag_unpermute)

# The module (the package exports its function under the same name).
tring = importlib.import_module("mpit_tpu_torch.parallel.ring_attention")

torch.set_num_threads(1)

B, L, H, D = 2, 64, 2, 16
FWD_ATOL, GRAD_ATOL = 3e-5, 5e-5
CASES = [("contiguous", False), ("contiguous", True), ("zigzag", True)]


def _qkv(seed=0, shape=(B, L, H, D)):
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=shape) * 0.5).astype(np.float32) for _ in range(3))


@functools.lru_cache(maxsize=None)
def _jax_ring(n, layout, causal, impl="jnp"):
    """JAX's forward and the gradients of sum(out**2), as numpy."""
    q, k, v = _qkv()
    fn = jax_ring_attention(jax_sp_mesh(default_devices()[:n]), causal=causal,
                            impl=impl, layout=layout)
    out = np.asarray(jax.jit(fn)(q, k, v))
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2)))(q, k, v)
    return out, tuple(np.asarray(g) for g in grads)


def _port_ring(n, layout, causal, impl):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv())
    fn = ring_attention(sp_mesh(n, "cpu"), causal=causal, impl=impl, layout=layout)
    out = fn(q, k, v)
    (out ** 2).sum().backward()
    return out.detach().numpy(), tuple(t.grad.numpy() for t in (q, k, v))


@pytest.mark.parametrize("impl", ["plain", "flash"])
@pytest.mark.parametrize("layout, causal", CASES)
@pytest.mark.parametrize("n", [2, 4])
def test_forward_and_grads_match_jax(n, layout, causal, impl):
    want_out, want_grads = _jax_ring(n, layout, causal)
    out, grads = _port_ring(n, layout, causal, impl)
    np.testing.assert_allclose(out, want_out, atol=FWD_ATOL)
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL)
    # and exactly full attention
    q, k, v = (torch.from_numpy(x).transpose(1, 2) for x in _qkv())
    full = attention_reference(q, k, v, causal=causal).transpose(1, 2)
    np.testing.assert_allclose(out, full.numpy(), atol=FWD_ATOL)


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_flash_ring_matches_jax_pallas_ring(layout):
    """The flash ring (twins on the CPU) against JAX's pallas ring, its
    kernels in interpret mode, forward and gradients."""
    want_out, want_grads = _jax_ring(2, layout, True, "pallas")
    out, grads = _port_ring(2, layout, True, "flash")
    np.testing.assert_allclose(out, want_out, atol=FWD_ATOL)
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_zigzag_permute_round_trip(n):
    x = np.arange(2 * L * 3, dtype=np.float32).reshape(2, L, 3)
    got = zigzag_permute(torch.from_numpy(x), n)
    assert got.numpy().tobytes() == np.asarray(jax_zigzag_permute(jnp.asarray(x), n)).tobytes()
    back = zigzag_unpermute(got, n)
    assert torch.equal(back, torch.from_numpy(x))
    assert np.array_equal(back.numpy(), np.asarray(jax_zigzag_unpermute(
        jax_zigzag_permute(jnp.asarray(x), n), n)))
    assert tring.zigzag_order(n) == [c for d in range(n) for c in (d, 2 * n - 1 - d)]


def test_zigzag_without_permute_takes_the_zigzag_order():
    """``permute_inputs=False`` takes and returns the zigzag order: the same
    attention as the permuting fn, seen through ``zigzag_permute``."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1))
    mesh = sp_mesh(4, "cpu")
    natural = ring_attention(mesh, layout="zigzag", impl="flash")(q, k, v)
    raw = ring_attention(mesh, layout="zigzag", impl="flash", permute_inputs=False)(
        *(zigzag_permute(t, 4) for t in (q, k, v)))
    assert torch.equal(zigzag_unpermute(raw, 4), natural)


@pytest.mark.parametrize("build, call, exc, match", [
    (dict(layout="zigzag", causal=False), None, ValueError, "requires causal=True"),
    (dict(impl="pallas"), None, ValueError, "impl must be"),
    (dict(layout="striped"), None, ValueError, "layout must be"),
    (dict(batch_axis="dp", mesh=Mesh("cpu", dp=2, sp=4)), (3, 64, 2, 16), ValueError,
     "batch 3 not divisible by the 2 ranks"),
    (dict(batch_axis="dp"), None, ValueError, "not 'dp'"),
    (dict(batch_axis="sp"), None, ValueError, "the ring's own axis"),
    (dict(axis="seq"), None, ValueError, "not 'seq'"),
    (dict(layout="zigzag"), (2, 36, 2, 16), ValueError, "even per-rank chunk"),
    (dict(), (2, 66, 2, 16), ValueError, "not divisible"),
    (dict(mesh=sp_mesh(4)), (2, 64, 2, 16), ValueError, "the mesh on cuda"),
])
def test_refusals(build, call, exc, match):
    mesh = build.pop("mesh", sp_mesh(4, "cpu"))
    with pytest.raises(exc, match=match):
        fn = ring_attention(mesh, build.pop("axis", "sp"), **build)
        q = torch.zeros(call)
        fn(q, q, q)


def test_batch_axis_dp_of_one_rank_runs():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2))
    got = ring_attention(Mesh("cpu", dp=1, sp=2), batch_axis="dp", impl="plain")(q, k, v)
    assert torch.equal(got, ring_attention(sp_mesh(2, "cpu"), impl="plain")(q, k, v))


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_batch_axis_dp_groups_ride_one_ring(monkeypatch, impl):
    """``batch_axis="dp"`` over 2 data parallel groups of a 2 x 2 mesh: the
    groups' rings ride the batch axis of one ring, so the output and the
    gradients are those of the ring without ``batch_axis`` bit for bit,
    the flash ring makes ``ring_pairs`` calls a pass, not twice that, and
    both hold against JAX's ring with ``batch_axis="dp"`` on a (2, 2) mesh
    of CPU devices."""
    from jax.sharding import Mesh as JaxMesh

    q, k, v = _qkv()
    calls = []
    real = tring.flash_attention_partial

    def counted(*a, **kw):
        calls.append(kw["q_offset"])
        return real(*a, **kw)

    monkeypatch.setattr(tring, "flash_attention_partial", counted)
    runs = []
    for mesh, batch_axis in ((Mesh("cpu", dp=2, sp=2), "dp"), (sp_mesh(2, "cpu"), None)):
        ts = tuple(torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        out = ring_attention(mesh, impl=impl, layout="zigzag", batch_axis=batch_axis)(*ts)
        (out ** 2).sum().backward()
        runs.append((out.detach(),) + tuple(t.grad for t in ts))
    for got, want in zip(*runs):
        assert torch.equal(got, want)
    assert len(calls) == (2 * tring.ring_pairs(2, "zigzag") if impl == "flash" else 0)
    jmesh = JaxMesh(np.array(default_devices()[:4]).reshape(2, 2), ("dp", "sp"))
    fn = jax_ring_attention(jmesh, impl="jnp", layout="zigzag", batch_axis="dp")
    want = np.asarray(jax.jit(fn)(q, k, v))
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2)))(q, k, v)
    np.testing.assert_allclose(runs[0][0].numpy(), want, atol=FWD_ATOL)
    for got, g in zip(runs[0][1:], grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(g), atol=GRAD_ATOL)


def test_dead_partial_leaves_the_live_side_bit_for_bit():
    """A wholly masked pair (every key after every query) gives acc 0, m
    -inf, l 0; merged either way round into a live partial it leaves the
    live side's bits, and so does starting a merge from a zero partial."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
               for _ in range(3))
    live = block_attention_partial(q, k, v, causal=True, q_offset=16, kv_offset=0)
    dead = block_attention_partial(q, k, v, causal=True, q_offset=0, kv_offset=16)
    assert torch.equal(dead[0], torch.zeros_like(dead[0]))
    assert bool(torch.isneginf(dead[1]).all()) and torch.equal(dead[2], torch.zeros_like(dead[2]))
    zero = (torch.zeros_like(live[0]), torch.full_like(live[1], float("-inf")),
            torch.zeros_like(live[2]))
    for merged in (merge_partials(live, dead), merge_partials(dead, live),
                   merge_partials(zero, live)):
        for got, want in zip(merged, live):
            assert got.numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
@pytest.mark.parametrize("n", [2, 4])
def test_pairs_launched_per_pass(monkeypatch, n, layout):
    """The flash ring computes n**2 pairs a pass contiguous (the wholly
    masked ones included) and n(2n+1) zigzag, forward and backward: the
    (q offset, kv offset) pairs it calls with, against the reference's
    liveness.  ``"auto"`` on the CPU calls neither."""
    calls = {"fwd": [], "bwd": []}
    real_fwd, real_bwd = tring.flash_attention_partial, tring.flash_attention_bwd_pair

    def fwd(*a, **kw):
        calls["fwd"].append((kw["q_offset"], kw["kv_offset"]))
        return real_fwd(*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"].append((kw["q_offset"], kw["kv_offset"]))
        return real_bwd(*a, **kw)

    monkeypatch.setattr(tring, "flash_attention_partial", fwd)
    monkeypatch.setattr(tring, "flash_attention_bwd_pair", bwd)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv())
    ring_attention(sp_mesh(n, "cpu"), impl="auto", layout=layout)(q, k, v).sum().backward()
    assert calls == {"fwd": [], "bwd": []}
    ring_attention(sp_mesh(n, "cpu"), impl="flash", layout=layout)(q, k, v).sum().backward()
    assert len(calls["fwd"]) == len(calls["bwd"]) == tring.ring_pairs(n, layout)
    assert tring.ring_pairs(n, layout) == (n * n if layout == "contiguous" else n * (2 * n + 1))
    if layout == "contiguous":
        c = L // n
        want = {(my * c, ((my - s) % n) * c) for s in range(n) for my in range(n)}
        assert set(calls["fwd"]) == want and len(want) == n * n
    else:
        c = L // (2 * n)
        offs = lambda r: (r * c, (2 * n - 1 - r) * c)  # noqa: E731
        want = []
        for s in range(n):
            for my in range(n):
                owner = (my - s) % n
                want.append((offs(my)[1], offs(owner)[0]))
                if my >= owner:
                    want.append((offs(my)[0], offs(owner)[0]))
                if owner >= my:
                    want.append((offs(my)[1], offs(owner)[1]))
        assert calls["fwd"] == want and calls["bwd"] == want
        # (early q, late kv) is never launched
        assert not any(qo < n * c <= ko for qo, ko in calls["fwd"])
