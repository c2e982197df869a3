"""Flash attention (K4 forward, K5 / K6 backward) of the PyTorch port
against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX op (its
Pallas kernels in interpret mode, small tiles, as tests/test_ops.py runs
them, with the backward schedule pinned by ``MPIT_FA_FUSED_BWD`` and
JAX's caches cleared around each leg) and through the port's op, which on
CPU tensors runs its plain twins.  Tolerances are the reference's own
(tests/test_ops.py): atol 2e-5 for outputs and partials, 3e-5 for grads,
3e-4 for the ragged, offset backward pair.  The kernels themselves run
only on a card: tests/test_torch_cuda.py.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.ops import flash_attention as jax_fa
from mpit_tpu.ops import flash_attention_bwd_pair as jax_bwd_pair
from mpit_tpu.ops import flash_attention_partial as jax_partial
from mpit_tpu.ops.flash_attention import _lse_of as jax_lse_of
from mpit_tpu_torch.ops.flash_attention import (
    _use_fused_bwd,
    attention_bwd_reference,
    attention_reference,
    block_attention_partial,
    finalize_partials,
    flash_attention,
    flash_attention_bwd_pair,
    flash_attention_partial,
    flash_bwd_fused,
    flash_bwd_two_kernel,
    flash_fwd,
    merge_partials,
)

# One intra-op thread: the suite runs several test processes side by side
# on the CPU, and these tensors are small.
torch.set_num_threads(1)

FWD_ATOL, GRAD_ATOL, PAIR_ATOL = 2e-5, 3e-5, 3e-4


def _qkv(seed, shape, k_len=None):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=shape) * 0.5).astype(np.float32)
    kv_shape = shape if k_len is None else (*shape[:-2], k_len, shape[-1])
    k, v = ((rng.normal(size=kv_shape) * 0.5).astype(np.float32) for _ in range(2))
    return q, k, v


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.fixture
def schedule(request, monkeypatch):
    """Pin the backward schedule of both packages for one test; JAX reads
    the gate at trace time, so its caches are cleared around the leg."""
    monkeypatch.setenv("MPIT_FA_FUSED_BWD", request.param)
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(64, 16), (2, 3, 40, 24)])
def test_forward_matches_jax(causal, shape):
    q, k, v = _qkv(len(shape), shape)
    want = jax_fa(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=16, block_k=128)
    got = flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)
    ref = attention_reference(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=FWD_ATOL)


def test_forward_bf16_matches_jax_kernel():
    """bf16 inputs: both compute f32 scores from the bf16 values and round
    P to bf16 before P @ V (the Pallas kernel's cast), then round the
    output to bf16.  Sums in another order may move an element across one
    rounding step, at most 2**-7 of itself (one key tile here, so both
    round the same P)."""
    q, k, v = _qkv(5, (2, 48, 32))
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_fa(qb, kb, vb, causal=True, block_q=16, block_k=128)
                      .astype(jnp.float32))
    got = flash_attention(*(t.to(torch.bfloat16) for t in _t(q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=FWD_ATOL, rtol=2.0**-7)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("offsets", [(0, 0), (26, 13), (5, 13)])
def test_partials_match_jax(causal, offsets):
    """K4's partial mode: (acc, m, l), with q rows 5..12 of offset (5, 13)
    dead under the causal mask (no key at or before them): m = -inf
    there, exactly as in the reference."""
    q_off, kv_off = offsets
    q, k, v = _qkv(7, (2, 19, 16), k_len=13)
    want = jax_partial(*map(jnp.asarray, (q, k, v)), causal=causal, q_offset=q_off,
                       kv_offset=kv_off, block_q=8, block_k=128)
    got = flash_attention_partial(*_t(q, k, v), causal=causal, q_offset=q_off,
                                  kv_offset=kv_off)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_ATOL)
    m_got, m_want = got[1].numpy(), np.asarray(want[1])
    np.testing.assert_array_equal(np.isneginf(m_got), np.isneginf(m_want))
    assert np.isneginf(m_got).any() == (causal and q_off < kv_off)


def test_merged_partials_match_global_attention():
    """Offset-masked chunk partials, merged and finalized, equal the
    matching slice of global causal attention (the ring contract), in the
    port and against the JAX reference."""
    from mpit_tpu.ops import attention_reference as jax_reference

    L, D, C = 32, 16, 8
    q, k, v = _t(*_qkv(11, (L, D)))
    full = attention_reference(q, k, v, causal=True)
    want = np.asarray(jax_reference(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())),
                                    causal=True))
    np.testing.assert_allclose(full.numpy(), want, atol=FWD_ATOL)
    for qi in range(L // C):
        parts = [flash_attention_partial(q[qi * C:(qi + 1) * C], k[kj * C:(kj + 1) * C],
                                         v[kj * C:(kj + 1) * C], causal=True,
                                         q_offset=qi * C, kv_offset=kj * C)
                 for kj in range(L // C)]
        acc, m, l = functools.reduce(merge_partials, parts)
        np.testing.assert_allclose(finalize_partials(acc, l).numpy(),
                                   full[qi * C:(qi + 1) * C].numpy(), atol=FWD_ATOL)


@pytest.mark.parametrize("schedule", ["1", "0"], indirect=True,
                         ids=["fused-bwd", "two-kernel-bwd"])
@pytest.mark.parametrize("shape", [(24, 16), (2, 3, 40, 24)])
def test_grads_match_jax(schedule, shape):
    """Grads of sum(o**2) through the port's autograd.Function against
    jax.grad of the JAX op under each of its backward schedules."""
    q, k, v = _qkv(13, shape)
    fa = functools.partial(jax_fa, causal=True, block_q=8, block_k=128)
    want = jax.grad(lambda *a: jnp.sum(fa(*a) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
    (flash_attention(qt, kt, vt, causal=True) ** 2).sum().backward()
    for got, exp in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=GRAD_ATOL)


@pytest.mark.parametrize("schedule", ["1", "0"], indirect=True,
                         ids=["fused-bwd", "two-kernel-bwd"])
@pytest.mark.parametrize("offsets", [(26, 13), (5, 13)])
def test_backward_pair_matches_jax(schedule, offsets):
    """The backward twin on the ring's per-step shape (ragged Lq != Lk,
    global offsets, a batch axis; dead rows under offset (5, 13)) against
    the JAX package's flash_attention_bwd_pair, from the same lse."""
    q_off, kv_off = offsets
    q, k, v = _qkv(17, (2, 19, 16), k_len=13)
    do = np.random.default_rng(19).normal(size=q.shape).astype(np.float32)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    _, m, l = jax_partial(jq, jk, jv, causal=True, q_offset=q_off, kv_offset=kv_off,
                          block_q=8, block_k=128)
    lse = np.asarray(jax_lse_of(m, l))
    o = np.asarray(jax_fa(jq, jk, jv, causal=True, q_offset=q_off, kv_offset=kv_off,
                          block_q=8, block_k=128))
    want = jax_bwd_pair(jq, jk, jv, jdo, jnp.asarray(lse), causal=True, q_offset=q_off,
                        kv_offset=kv_off, o=jnp.asarray(o), block_q=8, block_k=128)
    got = flash_attention_bwd_pair(*_t(q, k, v, do, lse), causal=True, q_offset=q_off,
                                   kv_offset=kv_off, o=torch.from_numpy(np.array(o)))
    for a, b in zip(got, want):
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PAIR_ATOL)


def test_fwd_lse_and_autograd_backward_agree_with_the_reference():
    """The forward's lse is m + log l of the partials, and the backward twin
    fed it gives autograd's grads of the plain reference."""
    q, k, v = _t(*_qkv(23, (3, 33, 8)))
    do = torch.from_numpy(np.random.default_rng(29).normal(size=(3, 33, 8))
                          .astype(np.float32))
    o, lse = flash_fwd(q, k, v, causal=True, q_offset=4, kv_offset=0)
    acc, m, l = block_attention_partial(q, k, v, causal=True, q_offset=4)
    torch.testing.assert_close(lse, m + torch.log(l), rtol=0, atol=1e-6)
    delta = (do * o).sum(-1)
    got = attention_bwd_reference(q, k, v, do, lse, delta, causal=True, q_offset=4)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    attention_reference(qr, kr, vr, causal=True, q_offset=4).backward(do)
    for a, b in zip(got, (qr.grad, kr.grad, vr.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL)


def test_gate_forces_each_schedule_and_refuses_bad_values(monkeypatch):
    shape = (8, 8192, 128)
    monkeypatch.setenv("MPIT_FA_FUSED_BWD", "1")
    assert _use_fused_bwd(shape, shape, 128) is True
    monkeypatch.setenv("MPIT_FA_FUSED_BWD", "0")
    assert _use_fused_bwd((4, 16), (4, 16), 16) is False
    for bad in ("true", "2", "fused"):
        monkeypatch.setenv("MPIT_FA_FUSED_BWD", bad)
        with pytest.raises(ValueError, match="MPIT_FA_FUSED_BWD"):
            _use_fused_bwd((4, 16), (4, 16), 16)


def test_gate_flips_where_the_transient_says(monkeypatch):
    """auto on the CPU: fused while the JAX package's count, N x (Lk_p /
    bk) x Lq_p x D_p x 4 bytes over its own tiles, fits the budget.  float32
    takes 512 x 512 tiles, 2-byte types 1,024 x 1,024 (2,048 keys at Lk >=
    32,768), and D pads to 128.  The LM's default attention (N = 8 x 8
    heads, L 1,024, D 32) holds 64 x 2 x 1,024 x 128 x 4 B = 64 MiB; the
    long-context shape (N 8, L 8,192, D 128) 8 x 16 x 8,192 x 128 x 4 B =
    512 MiB in float32 and 256 MiB in bfloat16."""
    monkeypatch.delenv("MPIT_FA_FUSED_BWD", raising=False)
    monkeypatch.delenv("MPIT_FA_FUSED_BWD_MAX_MB", raising=False)
    assert _use_fused_bwd((8, 8, 1024, 32), (8, 8, 1024, 32), 32) is True
    long = (1, 8, 8192, 128)
    assert _use_fused_bwd(long, long, 128) is True
    monkeypatch.setenv("MPIT_FA_FUSED_BWD_MAX_MB", "512")
    assert _use_fused_bwd(long, long, 128) is True
    monkeypatch.setenv("MPIT_FA_FUSED_BWD_MAX_MB", "511.9")
    assert _use_fused_bwd(long, long, 128) is False
    assert _use_fused_bwd(long, long, 128, "cpu", torch.bfloat16) is True
    monkeypatch.setenv("MPIT_FA_FUSED_BWD_MAX_MB", "255.9")
    assert _use_fused_bwd(long, long, 128, "cpu", torch.bfloat16) is False
    # At 32,768 keys a 2-byte type takes 2,048-key tiles: 2,048 MiB, the
    # default budget exactly; float32 keeps 512 keys, 8,192 MiB.
    monkeypatch.delenv("MPIT_FA_FUSED_BWD_MAX_MB")
    long = (1, 8, 32768, 128)
    assert _use_fused_bwd(long, long, 128, "cpu", torch.bfloat16) is True
    assert _use_fused_bwd(long, long, 128, "cpu", torch.float32) is False
    # A ragged key length counts its partial key tile (513 keys are two
    # tiles of 512), Lq pads to 8 (100 rows count 104) and D to 128.
    monkeypatch.setenv("MPIT_FA_FUSED_BWD_MAX_MB", str(104 * 128 * 4 / 2**20))
    assert _use_fused_bwd((100, 8), (512, 8), 8) is True
    assert _use_fused_bwd((100, 8), (513, 8), 8) is False


# (q shape, k shape, D): the LM's default attention, the long-context
# shapes at 8k, 16k and 32k, and a ragged pair.
JAX_GATE_SHAPES = [
    ((8, 8, 1024, 32), (8, 8, 1024, 32), 32),
    ((1, 8, 8192, 128), (1, 8, 8192, 128), 128),
    ((1, 8, 16384, 128), (1, 8, 16384, 128), 128),
    ((1, 8, 32768, 128), (1, 8, 32768, 128), 128),
    ((3, 100, 8), (3, 65, 8), 8),
]


@pytest.mark.parametrize("budget", [None, "4096", "256"], ids=["unset", "4096", "256"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shapes", JAX_GATE_SHAPES,
                         ids=["lm_default", "8k", "16k", "32k", "ragged"])
def test_cpu_gate_gives_the_jax_gates_answer(monkeypatch, shapes, dtype, budget):
    """The port's CPU gate and the JAX package's ``_use_fused_bwd``, under
    its default settings, choose the same backward schedule."""
    from mpit_tpu.ops.flash_attention import _use_fused_bwd as jax_use_fused_bwd

    for name in ("MPIT_FA_FUSED_BWD", "MPIT_FA_FUSED_BWD_MAX_MB", "MPIT_FA_VMEM_MB",
                 "MPIT_FA_LONG_BK_BWD"):
        monkeypatch.delenv(name, raising=False)
    if budget is not None:
        monkeypatch.setenv("MPIT_FA_FUSED_BWD_MAX_MB", budget)
    q_shape, k_shape, d = shapes
    want = jax_use_fused_bwd(q_shape, k_shape, d, getattr(jnp, dtype), None, None, None)
    assert _use_fused_bwd(q_shape, k_shape, d, "cpu", getattr(torch, dtype)) is want


def test_gate_budget_on_the_card_is_a_quarter_of_it(monkeypatch):
    """auto on a CUDA device with no MPIT_FA_FUSED_BWD_MAX_MB: K5 while its
    transient fits a quarter of the card's memory; the variable, where
    set, still decides.  The card's size is replaced here (no card).  K5
    takes 128-key tiles on the card in either type, so the long-context
    shape's partials are 8 x 64 x 8,192 x 128 x 4 B = 2,048 MiB."""
    monkeypatch.delenv("MPIT_FA_FUSED_BWD", raising=False)
    monkeypatch.delenv("MPIT_FA_FUSED_BWD_MAX_MB", raising=False)
    fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
    long, cuda = (1, 8, 8192, 128), torch.device("cuda")
    monkeypatch.setattr(fa, "_card_mb", lambda device: 8192.0)
    assert _use_fused_bwd(long, long, 128, cuda) is True  # 2,048 MiB fits
    # The CPU counts the JAX package's 512-key tiles: 512 MiB, within its
    # 2,048 MiB default.
    assert _use_fused_bwd(long, long, 128, "cpu") is True
    monkeypatch.setattr(fa, "_card_mb", lambda device: 8191.0)
    assert _use_fused_bwd(long, long, 128, cuda) is False
    monkeypatch.setenv("MPIT_FA_FUSED_BWD_MAX_MB", "2048")
    assert _use_fused_bwd(long, long, 128, cuda) is True


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gate_on_the_card_counts_the_key_tile_that_runs(monkeypatch, dtype):
    """On the card K5 runs on the tensor cores with 128-key tiles in
    either type (bfloat16 in flash_attention_tc.cu, float32 by 3xTF32 in
    flash_attention_tf32.cu), so its transient at the long-context shape is
    64 x 8 x 8,192 x 128 x 4 B = 2,048 MiB in both; the CPU counts the JAX
    package's 1,024-key (bfloat16) or 512-key (float32) tiles, 256 or 512
    MiB."""
    monkeypatch.delenv("MPIT_FA_FUSED_BWD", raising=False)
    monkeypatch.delenv("MPIT_FA_FUSED_BWD_MAX_MB", raising=False)
    fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
    long, cuda = (1, 8, 8192, 128), torch.device("cuda")
    assert fa.BLOCK_K_TC == 128
    monkeypatch.setattr(fa, "_card_mb", lambda device: 8192.0)  # a quarter: 2,048
    assert _use_fused_bwd(long, long, 128, cuda, dtype) is True
    assert _use_fused_bwd(long, long, 128, "cpu", dtype) is True
    monkeypatch.setenv("MPIT_FA_FUSED_BWD_MAX_MB", "2047.9")
    assert _use_fused_bwd(long, long, 128, cuda, dtype) is False
    # A ragged key length counts its partial tile: 129 keys are two.
    monkeypatch.setenv("MPIT_FA_FUSED_BWD_MAX_MB", str(100 * 8 * 4 / 2**20))
    assert _use_fused_bwd((100, 8), (128, 8), 8, cuda, dtype) is True
    assert _use_fused_bwd((100, 8), (129, 8), 8, cuda, dtype) is False


def test_cpu_tensors_never_count_launches():
    q, k, v = _t(*_qkv(31, (2, 20, 8)))
    kernels = (flash_fwd, flash_bwd_fused, flash_bwd_two_kernel)
    before = [f.launches for f in kernels]
    for fused in ("1", "0"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MPIT_FA_FUSED_BWD", fused)
            qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
            flash_attention(qr, kr, vr, causal=True).sum().backward()
    flash_attention_partial(q, k, v)
    assert [f.launches for f in kernels] == before


@pytest.mark.parametrize("bad", ["d12", "d136", "dtype", "mixed", "strided",
                                 "device", "lse"])
def test_refuses_what_the_kernels_do_not_take(bad):
    q, k, v = _t(*_qkv(37, (2, 16, 16)))
    if bad == "d12":
        q, k, v = (t[..., :12].contiguous() for t in (q, k, v))
    elif bad == "d136":
        q, k, v = (torch.zeros(2, 16, 136) for _ in range(3))
    elif bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "strided":
        q = torch.zeros(16, 2, 16).transpose(0, 1)
    elif bad == "device":
        k = torch.empty(2, 16, 16, device="meta")
    if bad == "lse":
        with pytest.raises(ValueError):
            flash_bwd_fused(q, k, v, q, torch.zeros(2, 15), torch.zeros(2, 16))
        return
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, k, v)



# The card's memory as torch reports it for an NVIDIA H100 80GB HBM3
# (total_memory 85,520,809,984 bytes), in MiB.
H100_MB = 81559.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("seq_len,fused", [(8192, True), (16384, True), (32768, False)])
def test_gate_sends_the_32k_lm_to_k6_on_an_h100(monkeypatch, seq_len, fused, dtype):
    """The long-context LM's attention (batch 1 x 8 heads of 128, bf16 or
    float32) on an 80 GB card: K5's dQ partials, float32 over 128-key tiles
    in either type, 8 x L/128 x L x 128 x 4 B = 32 L^2 bytes, take 2 GiB at
    8k and 8 GiB at 16k, within a quarter of the card (19.9 GiB), and 32
    GiB at 32k, past it: the gate alone sends the 32k LM
    (lm_launch.LONGCONTEXT_32K_KWARGS, with either ``attn_dtype``) to K6."""
    from mpit_tpu_torch.train.lm_launch import LONGCONTEXT_32K_KWARGS, LONGCONTEXT_KWARGS

    monkeypatch.delenv("MPIT_FA_FUSED_BWD", raising=False)
    monkeypatch.delenv("MPIT_FA_FUSED_BWD_MAX_MB", raising=False)
    fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
    monkeypatch.setattr(fa, "_card_mb", lambda device: H100_MB)
    widths = (LONGCONTEXT_32K_KWARGS if seq_len == 32768
              else dict(LONGCONTEXT_KWARGS, seq_len=seq_len))
    assert widths["seq_len"] == seq_len
    head = widths["d_model"] // widths["n_heads"]
    shape = (widths["batch"], widths["n_heads"], seq_len, head)
    assert _use_fused_bwd(shape, shape, head, torch.device("cuda"), dtype) is fused


def _exact_bf16(a):
    """A float32 array rounded to a multiple of 1/16 in [-2, 2]: bf16 values
    whose products and their sums are exact in float32 in any order."""
    return np.clip(np.round(a * 16) / 16, -2, 2).astype(np.float32)


@pytest.mark.parametrize("schedule", ["0"], indirect=True, ids=["two-kernel-bwd"])
@pytest.mark.parametrize("offsets", [(26, 13), (5, 13)])
def test_backward_pair_bf16_matches_jax_two_kernel(schedule, offsets):
    """bf16 inputs through K6's plain twin (flash_bwd_two_kernel on CPU
    tensors) against the JAX package's two-kernel schedule
    (``_fa_2d_bwd(fused=False)``, its Pallas kernels in interpret mode) on
    the ring's ragged, offset pair, dead rows under offset (5, 13), from
    the same lse and delta.  Inputs are multiples of 1/16, so scores and dP
    are exact in float32 on both sides and both round the same P and dS to
    bf16 before their products: each grad lies within one bf16 step of the
    JAX kernel's, 2**-7 of itself, plus the pair's atol for the float32
    sums' order."""
    q_off, kv_off = offsets
    q, k, v = (_exact_bf16(a) for a in _qkv(41, (2, 19, 16), k_len=13))
    do = _exact_bf16(np.random.default_rng(43).normal(size=q.shape))
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, do))
    kw = dict(causal=True, q_offset=q_off, kv_offset=kv_off)
    _, m, l = jax_partial(jq, jk, jv, block_q=8, block_k=128, **kw)
    lse = np.asarray(jax_lse_of(m, l))
    o = np.asarray(jax_fa(jq, jk, jv, block_q=8, block_k=128, **kw).astype(jnp.float32))
    delta = (do * o).sum(-1).astype(np.float32)
    want = jax_bwd_pair(jq, jk, jv, jdo, jnp.asarray(lse), delta=jnp.asarray(delta),
                        block_q=8, block_k=128, **kw)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    got = flash_bwd_two_kernel(tq, tk, tv, tdo, *_t(lse, delta), **kw)
    assert np.isneginf(lse).any() == (q_off < kv_off)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        exp = np.asarray(b.astype(jnp.float32))
        np.testing.assert_allclose(a.float().numpy(), exp, atol=PAIR_ATOL, rtol=2.0**-7)
