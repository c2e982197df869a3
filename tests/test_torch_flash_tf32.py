"""3xTF32, the arithmetic of float32 K4, K5 and K6 on the tensor cores
(``mpit_tpu_torch/ops/csrc/flash_attention_tf32.cu``), emulated on the
CPU and held to the JAX package's float32 flash attention.

Each float32 operand x is split as the kernels split it: hi = tf32(x),
lo = tf32(x - hi), where tf32 rounds to the nearest value with 10 explicit
mantissa bits, ties away from zero (``cvt.rna.tf32.f32``: add half of the
13 dropped bits' unit to the magnitude's bits and clear them); a product
is lo.hi + hi.lo + hi.hi, each term summed in float32, lo.lo dropped.  The
emulation follows the kernels' algorithms: K4's online softmax over
64-key tiles in both output modes (the -1e30 sentinel inside, -inf in the
public m and lse of dead rows), K5's backward formulas with its dQ
summed from one partial a 128-key tile in ascending order, and K6's: its
dK/dV kernel is K5's sweep, and its dQ kernel adds each of its key tiles'
dS.K (64 keys, 32 at D 128) in ascending order.  The JAX side runs its
Pallas kernels in interpret mode, as tests/test_torch_flash.py runs them
(K6's against the JAX package's two-kernel schedule,
``MPIT_FA_FUSED_BWD=0``), and the limits are the reference's
(tests/test_ops.py): atol
2e-5 forward, 3e-5 for grads, 3e-4 for an offset pair's grads.  One TF32
pass, which a tensor core takes for a float32 product by default, misses
the forward's limit.  The kernels themselves run only on a card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.ops import flash_attention as jax_fa
from mpit_tpu.ops import flash_attention_bwd_pair as jax_bwd_pair
from mpit_tpu.ops import flash_attention_partial as jax_partial
from mpit_tpu.ops.flash_attention import _lse_of as jax_lse_of
from mpit_tpu_torch.ops.flash_attention import attention_bwd_reference

torch.set_num_threads(1)

FWD_ATOL, GRAD_ATOL, PAIR_ATOL = 2e-5, 3e-5, 3e-4
PARTIAL_RTOL = 1e-5  # l, a sum of up to L exponentials (chip_smoke's FA_PARTIAL_RTOL)
BIG_NEG = -1e30
F_BK, B_BK = 64, 128  # K4's key tile, K5's (its dQ partials' slots)


def k6_dq_keys(d):
    """The key tile of K6's dQ kernel at head width d (padded to 32, 64 or
    128): 64, or 32 at D 128 (``DqSmem``)."""
    return 64 if d <= 64 else 32

# (name, leading axes, Lq, Lk, D, q_offset, kv_offset, causal): D 32, 64
# and 128, causal and not, a ragged offset pair whose first 20 q rows
# have no key (dead rows), and a ragged pair unmasked.
CASES = [
    ("causal_d32", (2, 2), 256, 256, 32, 0, 0, True),
    ("full_d64", (2,), 256, 256, 64, 0, 0, False),
    ("causal_d128", (1, 2), 256, 256, 128, 0, 0, True),
    ("ragged_dead_rows_d64", (2, 3), 203, 131, 64, 20, 40, True),
    ("ragged_full_d32", (2,), 203, 131, 32, 100, 40, False),
]
IDS = [c[0] for c in CASES]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it."""
    bits = x.detach().contiguous().numpy().view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return torch.from_numpy(bits.view(np.float32).reshape(x.shape))


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b):
    """a @ b in 3xTF32: the cross terms, then hi.hi, each summed in float32."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    """a @ b in one TF32 pass."""
    return tf32(a) @ tf32(b)


def valid_mask(lq, lk, q_off, kv_off, causal):
    qi = q_off + torch.arange(lq)[:, None]
    kj = kv_off + torch.arange(lk)[None, :]
    return qi >= kj if causal else torch.ones(lq, lk, dtype=torch.bool)


def fwd_emulated(q, k, v, q_off, kv_off, causal, mm=mm3):
    """K4: the online softmax over F_BK-key tiles, products by ``mm``.
    Returns (o, lse) and the partials (acc, m, l)."""
    lq, lk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    scale = np.float32(1.0 / np.sqrt(d))
    ok = valid_mask(lq, lk, q_off, kv_off, causal)
    m = torch.full(q.shape[:-1], BIG_NEG)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for j0 in range(0, lk, F_BK):
        kt, vt = k[..., j0:j0 + F_BK, :], v[..., j0:j0 + F_BK, :]
        s = mm(q, kt.transpose(-1, -2)) * scale
        s = s.masked_fill(~ok[:, j0:j0 + F_BK], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(-1)
        acc = alpha[..., None] * acc + mm(p, vt)
        m = m_new
    m_pub = torch.where(m == BIG_NEG, float("-inf"), m)
    den = torch.where(l == 0, 1.0, l)
    return (acc / den[..., None], m_pub + torch.log(den)), (acc, m_pub, l)


def bwd_emulated(q, k, v, do, lse, delta, q_off, kv_off, causal, dq_keys=B_BK):
    """K5: P^T and dS^T from 3xTF32 scores, dV = P^T.dO, dK = scale dS^T.Q,
    and dQ = scale x the sum, in ascending key tiles of ``dq_keys`` (K5's
    B_BK), of each tile's dS.K partial."""
    lq, lk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    scale = np.float32(1.0 / np.sqrt(d))
    ok = valid_mask(lq, lk, q_off, kv_off, causal)
    s = mm3(q, k.transpose(-1, -2))
    p = torch.where(ok, torch.exp(s * scale - lse[..., None]), 0.0)
    ds = p * (mm3(do, v.transpose(-1, -2)) - delta[..., None])
    dv = mm3(p.transpose(-1, -2), do)
    dk = scale * mm3(ds.transpose(-1, -2), q)
    dq = torch.zeros(q.shape)
    for j0 in range(0, lk, dq_keys):
        dq = dq + mm3(ds[..., j0:j0 + dq_keys], k[..., j0:j0 + dq_keys, :])
    return scale * dq, dk, dv


def bwd_two_kernel_emulated(q, k, v, do, lse, delta, q_off, kv_off, causal):
    """K6: its dK/dV kernel is K5's sweep without the dQ work, so dK and dV
    are K5's; its dQ kernel, q tiles outer, takes S, dP, P and dS as K5
    does and adds each of its key tiles' dS.K (a fresh product a tile) to
    dQ in float32, in ascending tiles of ``k6_dq_keys``; then dQ is
    scaled."""
    return bwd_emulated(q, k, v, do, lse, delta, q_off, kv_off, causal,
                        dq_keys=k6_dq_keys(q.shape[-1]))


def inputs(case):
    name, lead, lq, lk, d, q_off, kv_off, causal = case
    rng = np.random.default_rng(sum(map(ord, name)))
    q = (0.5 * rng.normal(size=(*lead, lq, d))).astype(np.float32)
    k, v = ((0.5 * rng.normal(size=(*lead, lk, d))).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(*lead, lq, d)).astype(np.float32)
    return q, k, v, do, dict(causal=causal, q_offset=q_off, kv_offset=kv_off)


@functools.cache
def jax_forward(name):
    """The JAX package's float32 outputs: o, the partials and their lse."""
    q, k, v, _, kw = inputs(next(c for c in CASES if c[0] == name))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o = np.asarray(jax_fa(jq, jk, jv, block_q=128, block_k=128, **kw))
    acc, m, l = jax_partial(jq, jk, jv, block_q=128, block_k=128, **kw)
    lse = np.asarray(jax_lse_of(m, l))
    return o, (np.asarray(acc), np.asarray(m), np.asarray(l)), lse


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_3xtf32_matches_jax(case):
    """K4's arithmetic in both output modes against the JAX package's
    flash_attention and flash_attention_partial: o, lse, acc and m within
    2e-5, l within 1e-5 of itself, -inf exactly at the JAX package's dead
    rows."""
    q, k, v, _, kw = inputs(case)
    o_j, (acc_j, m_j, l_j), lse_j = jax_forward(case[0])
    (o, lse), (acc, m, l) = fwd_emulated(*_t(q, k, v), kw["q_offset"], kw["kv_offset"],
                                         kw["causal"])
    np.testing.assert_allclose(o.numpy(), o_j, atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(acc.numpy(), acc_j, atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(l.numpy(), l_j, atol=0, rtol=PARTIAL_RTOL)
    for got, want in ((m.numpy(), m_j), (lse.numpy(), lse_j)):
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], atol=FWD_ATOL, rtol=0)
    assert np.isneginf(m_j).any() == (case[0] == "ragged_dead_rows_d64")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_3xtf32_matches_jax(case):
    """K5's arithmetic, from the emulated forward's o and lse as the
    autograd Function feeds it, against the JAX package's
    flash_attention_bwd_pair from its own lse and o: dq, dk and dv within
    3e-5, 3e-4 on the offset pairs."""
    q, k, v, do, kw = inputs(case)
    o_j, _, lse_j = jax_forward(case[0])
    want = jax_bwd_pair(*map(jnp.asarray, (q, k, v, do, lse_j)), o=jnp.asarray(o_j),
                        block_q=128, block_k=128, **kw)
    tq, tk, tv, tdo = _t(q, k, v, do)
    (o, lse), _ = fwd_emulated(tq, tk, tv, kw["q_offset"], kw["kv_offset"], kw["causal"])
    delta = (tdo * o).sum(-1)
    got = bwd_emulated(tq, tk, tv, tdo, lse, delta, kw["q_offset"], kw["kv_offset"],
                       kw["causal"])
    atol = PAIR_ATOL if (kw["q_offset"] or kw["kv_offset"]) else GRAD_ATOL
    for a, b in zip(got, want):
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=0)


@pytest.fixture
def two_kernel_schedule(monkeypatch):
    """The JAX package's two-kernel backward (``_fa_2d_bwd(fused=False)``)
    for one test; JAX reads the gate at trace time, so its caches are
    cleared around the leg."""
    monkeypatch.setenv("MPIT_FA_FUSED_BWD", "0")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_two_kernel_3xtf32_matches_jax(case, two_kernel_schedule):
    """K6's arithmetic, from the emulated forward's o and lse, against the
    JAX package's two-kernel backward (its dQ and dK/dV Pallas kernels)
    from its own lse and o: dq, dk and dv within 3e-5, 3e-4 on the offset
    pairs; dK and dV are K5's emulation exactly."""
    q, k, v, do, kw = inputs(case)
    o_j, _, lse_j = jax_forward(case[0])
    want = jax_bwd_pair(*map(jnp.asarray, (q, k, v, do, lse_j)), o=jnp.asarray(o_j),
                        block_q=128, block_k=128, **kw)
    tq, tk, tv, tdo = _t(q, k, v, do)
    offs = (kw["q_offset"], kw["kv_offset"], kw["causal"])
    (o, lse), _ = fwd_emulated(tq, tk, tv, *offs)
    delta = (tdo * o).sum(-1)
    got = bwd_two_kernel_emulated(tq, tk, tv, tdo, lse, delta, *offs)
    k5 = bwd_emulated(tq, tk, tv, tdo, lse, delta, *offs)
    atol = PAIR_ATOL if (kw["q_offset"] or kw["kv_offset"]) else GRAD_ATOL
    for a, b in zip(got, want):
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=0)
    assert torch.equal(got[1], k5[1]) and torch.equal(got[2], k5[2])


def test_two_kernel_dq_over_many_key_tiles_matches_float64():
    """K6 at N 1, L 2,048, D 32, causal: the last q rows' dQ sums 32 of the
    dQ kernel's 64-key tiles.  Against the port's twin in float64 from the
    same lse and delta (the JAX package at this length would take minutes
    in interpret mode): every grad within 3e-5."""
    rng = np.random.default_rng(2048)
    q, k, v = ((0.5 * rng.normal(size=(1, 2048, 32))).astype(np.float32) for _ in range(3))
    do = rng.normal(size=(1, 2048, 32)).astype(np.float32)
    tq, tk, tv, tdo = _t(q, k, v, do)
    (o, lse), _ = fwd_emulated(tq, tk, tv, 0, 0, True)
    delta = (tdo * o).sum(-1)
    got = bwd_two_kernel_emulated(tq, tk, tv, tdo, lse, delta, 0, 0, True)
    want = attention_bwd_reference(*(t.double() for t in (tq, tk, tv, tdo)), lse, delta,
                                   causal=True)
    assert 2048 // k6_dq_keys(32) == 32
    for a, b in zip(got, want):
        assert b.dtype == torch.float64
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), atol=GRAD_ATOL, rtol=0)


def test_tf32_rounds_to_nearest_ties_away():
    """tf32 keeps 10 explicit mantissa bits, rounding the 13 dropped ones to
    the nearest, ties away from zero, in either sign; the split is exact
    to about 2**-22 of x."""
    one = 1.0
    ulp = 2.0**-10
    x = torch.tensor([one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4, -(one + ulp / 2),
                      one + ulp + ulp / 2], dtype=torch.float32)
    want = torch.tensor([one + ulp, one, one + ulp, -(one + ulp), one + 2 * ulp])
    assert torch.equal(tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32))
    hi, lo = split(r)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0**-21


def test_one_tf32_pass_misses_the_forward_limit():
    """At L 256, D 128 (4 heads, causal) one TF32 pass puts o some 4e-4
    from the JAX package's float32 output, past 2e-5; 3xTF32 keeps it
    within the limit."""
    rng = np.random.default_rng(256)
    q, k, v = ((0.5 * rng.normal(size=(4, 256, 128))).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_fa(*map(jnp.asarray, (q, k, v)), causal=True, block_q=128,
                             block_k=128))
    (one, _), _ = fwd_emulated(*_t(q, k, v), 0, 0, True, mm=mm1)
    (three, _), _ = fwd_emulated(*_t(q, k, v), 0, 0, True)
    gap_one = float(np.abs(one.numpy() - want).max())
    gap_three = float(np.abs(three.numpy() - want).max())
    assert gap_one > FWD_ATOL, gap_one
    assert gap_three <= FWD_ATOL, gap_three
    assert gap_three < gap_one / 100
