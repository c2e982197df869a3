"""Blockwise (flash) attention: the forward K4 and the backward K5 / K6.

The port of ``mpit_tpu/ops/flash_attention.py``.  Over ``(..., L, D)``
tensors (leading axes batched), with global-offset causal masking
(``q_offset``, ``kv_offset``: a Q chunk attends to a KV chunk of a longer
sequence, as ring attention needs):

- :func:`flash_attention`, the user op: an ``autograd.Function`` whose
  forward is K4 (normalized output and the row log-sum-exp in one launch)
  and whose backward is K5 or K6, as :func:`_use_fused_bwd` decides;
- :func:`flash_attention_partial`: K4's partial mode, the unnormalized
  ``(acc, m, l)`` for cross-chunk merging (:func:`merge_partials`,
  :func:`finalize_partials`);
- :func:`flash_attention_bwd_pair`: the backward of one (Q chunk, KV
  chunk) pair, given the forward's ``lse``.

The kernels are CUDA C++ for Hopper, built by
:mod:`mpit_tpu_torch.ops.build` on first use; each source's comments say
what bounds its kernels and how they are tiled.  bfloat16 K4, K5 and K6
run on the tensor cores (``csrc/flash_attention_tc.cu``); float32 K4, K5
and K6 on the tensor cores too, at float32 accuracy by 3xTF32
(``csrc/flash_attention_tf32.cu``: each operand split into two TF32
values, three TF32 products for each float32 one).
Where the tensors lie fixes the route: CUDA tensors always go through a
kernel, CPU tensors always through the plain twins
(:func:`block_attention_partial` for K4, :func:`attention_bwd_reference`
for K5 and K6).  There is no fallback: a kernel that fails to build or
launch raises.  :func:`flash_fwd` and :func:`flash_bwd_fused` add one to
their ``launches`` count per call that launches their kernels, and
:func:`flash_bwd_two_kernel` one per each of its two kernels, and nowhere
else.

The kernels take ``D`` a multiple of 8 up to 128, float32 or bfloat16,
contiguous, and starting at a 16-byte aligned address.  K5, bfloat16 and
float32 alike, takes 128 keys a block (:data:`BLOCK_K_TC`), which sets the
size of its dQ partials.
The Mosaic levers of the JAX module (``MPIT_FA_VMEM_MB``, ``_DIMSEM``,
``_LONG_BQ``, ``_LONG_BK_BWD``) have no counterpart; the schedule choice
(``MPIT_FA_FUSED_BWD``, ``MPIT_FA_FUSED_BWD_MAX_MB``) is kept, with the
budget on the card taken from its size (:func:`_use_fused_bwd`).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Optional, Tuple

import torch

from mpit_tpu_torch.ops.fused_update import _cuda_stream

NEG_INF = float("-inf")

# K5's key tile, bfloat16 and float32 alike (csrc/flash_attention_tc.cu
# and flash_attention_tf32.cu: B_BK; checked when each library loads): its
# dQ partials hold one slot a tile.
BLOCK_K_TC = 128
D_MAX = 128


# ---------------------------------------------------------------------------
# Plain twins + partial/merge algebra
# ---------------------------------------------------------------------------


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)


def _mask(lq: int, lk: int, q_offset: int, kv_offset: int, causal: bool,
          device) -> torch.Tensor:
    """Boolean (Lq, Lk) validity mask in *global* coordinates."""
    qi = q_offset + torch.arange(lq, device=device)[:, None]
    kj = kv_offset + torch.arange(lk, device=device)[None, :]
    if causal:
        return qi >= kj
    return torch.ones(lq, lk, dtype=torch.bool, device=device)


def attention_reference(q, k, v, *, causal: bool = False,
                        sm_scale: Optional[float] = None, q_offset: int = 0,
                        kv_offset: int = 0) -> torch.Tensor:
    """Plain softmax attention over the last two axes; leading axes batch.
    Rows with no valid key return zeros.  Differentiable by autograd (the
    model's ``use_flash=False``)."""
    scale = _scale(q.shape[-1], sm_scale)
    s = torch.einsum("...qd,...kd->...qk", q, k).float() * scale
    valid = _mask(q.shape[-2], k.shape[-2], q_offset, kv_offset, causal, q.device)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.where(valid, torch.exp(s - m_safe), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("...qk,...kd->...qd", p, v.float())
    return (out / torch.where(l == 0.0, 1.0, l)).to(q.dtype)


def block_attention_partial(q, k, v, *, causal: bool = False,
                            sm_scale: Optional[float] = None, q_offset: int = 0,
                            kv_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalized attention partials for one (Q chunk, KV chunk) pair:
    ``acc = exp(s - m) @ v``, rowwise max ``m`` (``-inf`` on rows with no
    valid key) and normalizer ``l``, all f32.  K4's plain twin: scores and
    products in f32 from the inputs' values, and ``P`` rounded to the
    inputs' dtype before ``P @ V``, as the kernel (and the Pallas kernel)
    does; for f32 inputs this is the JAX package's function."""
    scale = _scale(q.shape[-1], sm_scale)
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    valid = _mask(q.shape[-2], k.shape[-2], q_offset, kv_offset, causal, q.device)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(-1)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.where(valid, torch.exp(s - m_safe[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("...qk,...kd->...qd", p.to(v.dtype).float(), v.float())
    return acc, m, l


def merge_partials(a, b):
    """Log-sum-exp combine of two ``(acc, m, l)`` partials (associative and
    commutative)."""
    acc1, m1, l1 = a
    acc2, m2, l2 = b
    m = torch.maximum(m1, m2)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    c1 = torch.where(torch.isneginf(m1), 0.0, torch.exp(m1 - m_safe))
    c2 = torch.where(torch.isneginf(m2), 0.0, torch.exp(m2 - m_safe))
    acc = acc1 * c1[..., None] + acc2 * c2[..., None]
    l = l1 * c1 + l2 * c2
    return acc, m, l


def finalize_partials(acc, l, dtype=torch.float32):
    """Normalize merged partials; all-masked rows yield zeros."""
    return (acc / torch.where(l == 0.0, 1.0, l)[..., None]).to(dtype)


def _lse_of(m, l):
    """Row log-sum-exp from (m, l) partials; -inf on all-masked (dead) rows,
    the convention the backward's ``exp(s - lse)`` relies on."""
    return m + torch.log(torch.where(l == 0.0, 1.0, l))


def attention_bwd_reference(q, k, v, do, lse, delta, *, causal: bool = False,
                            sm_scale: Optional[float] = None, q_offset: int = 0,
                            kv_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of one (Q chunk, KV chunk) pair from the forward's
    row ``lse`` and ``delta = rowsum(dO * O)``, by the flash backward's
    formulas: ``P = exp(s - lse)``, ``dS = P * (dO V^T - delta)``,
    ``dV = P^T dO``, ``dK = scale dS^T Q``, ``dQ = scale dS K``.  K5's and
    K6's plain twin: f32 products (float64 for float64 inputs, a reference
    for the kernels where float32's own sums drift), ``P`` and ``dS``
    rounded to the inputs' dtype before their products, outputs in the
    inputs' dtype."""
    dt = q.dtype
    wide = torch.promote_types(dt, torch.float32)
    scale = _scale(q.shape[-1], sm_scale)
    qf, kf, vf, dof = (t.to(wide) for t in (q, k, v, do))
    s = torch.einsum("...qd,...kd->...qk", qf, kf) * scale
    valid = _mask(q.shape[-2], k.shape[-2], q_offset, kv_offset, causal, q.device)
    # A dead row has lse = -inf and no valid key: where() drops its exp.
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("...qd,...kd->...qk", dof, vf)
    ds = p * (dp - delta[..., None])
    p_c, ds_c = p.to(dt).to(wide), ds.to(dt).to(wide)
    dv = torch.einsum("...qk,...qd->...kd", p_c, dof)
    dk = scale * torch.einsum("...qk,...qd->...kd", ds_c, qf)
    dq = scale * torch.einsum("...qk,...kd->...qd", ds_c, kf)
    return dq.to(dt), dk.to(dt), dv.to(dt)


# ---------------------------------------------------------------------------
# Operand checks and the schedule gate
# ---------------------------------------------------------------------------


def _check_qkv(q, k, v) -> Tuple[Tuple[int, ...], int, int, int]:
    """Validate q ``(..., Lq, D)`` and k, v ``(..., Lk, D)``; returns the
    leading shape, Lq, Lk and D."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() < 2:
            raise ValueError(f"{name} must be (..., L, D), got {tuple(t.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.shape[:-2] != k.shape[:-2] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    lq, d = q.shape[-2:]
    lk = k.shape[-2]
    if d % 8 or not 8 <= d <= D_MAX:
        raise ValueError(f"head dim {d}: the kernels take a multiple of 8 up to {D_MAX}")
    if lq == 0 or lk == 0 or q.numel() == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    return tuple(q.shape[:-2]), lq, lk, d


def _check_rows(lead, lq, device, **stats) -> None:
    """Row statistics (lse, delta): contiguous f32 ``(*lead, Lq)``."""
    for name, t in stats.items():
        if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                and t.device == device and t.is_contiguous()
                and tuple(t.shape) == (*lead, lq)):
            raise ValueError(f"{name} must be a contiguous float32 tensor of "
                             f"shape {(*lead, lq)} on {device}")


def _check_offsets(lq, lk, q_offset, kv_offset) -> Tuple[int, int]:
    """Offsets are ints, and every global position fits the kernels' int32
    arithmetic with room to spare."""
    q_offset, kv_offset = int(q_offset), int(kv_offset)
    for off, length in ((q_offset, lq), (kv_offset, lk)):
        if abs(off) + length >= 2**30:
            raise ValueError(f"offset {off} + length {length} out of range")
    return q_offset, kv_offset


def _card_mb(device) -> float:
    """The CUDA device's memory in MiB (a cached property: no driver call)."""
    return torch.cuda.get_device_properties(device).total_memory / 2**20


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _jax_transient_mb(n: int, lq: int, lk: int, d: int, dtype) -> float:
    """The dQ-partials transient that the JAX package's gate counts for its
    fused backward, in MiB: ``N * (Lk_p / bk) * Lq_p * D_p * 4`` bytes over
    its Pallas tiles (``_tile_dims`` of ``mpit_tpu/ops/flash_attention.py`` with
    ``bwd_long_bk``), under its default settings.

    ``bk`` is 1,024 keys for 2-byte types and 512 otherwise, 2,048 for a
    2-byte type at ``Lk >= 32,768``, clamped to ``Lk`` rounded up to 128;
    ``bq`` is 1,024 or 512, clamped to ``Lq`` rounded up to 8; ``Lq`` pads
    to ``bq``, ``Lk`` to ``bk`` and ``D`` to 128.  The JAX module's Mosaic
    levers (``MPIT_FA_VMEM_MB``, ``MPIT_FA_LONG_BK_BWD``) have no
    counterpart here: this count assumes their defaults, under which the
    2,048-key tile is taken.  ``dtype`` None counts as float32."""
    short = dtype is not None and dtype.itemsize <= 2
    block = 1024 if short else 512
    block_k = 2048 if short and lk >= 32768 else block
    bq = min(block, _round_up(lq, 8))
    bk = min(block_k, _round_up(lk, 128))
    tiles = _round_up(lk, bk) // bk
    return n * tiles * _round_up(lq, bq) * _round_up(d, 128) * 4 / 2**20


def _use_fused_bwd(q_shape, k_shape, d: int, device=None, dtype=None) -> bool:
    """Backward-schedule choice, the one decision point.

    ``MPIT_FA_FUSED_BWD``: ``1`` forces the fused single sweep (K5), ``0``
    the two-kernel schedule (K6); the default ``auto`` takes K5 while its
    dQ-partials transient (every one of the N heads live at once) fits the
    budget.  Any other value raises.

    On a CUDA ``device`` the transient is that of the K5 that runs,
    ``N * ceil(Lk / tile) * Lq * D * 4`` bytes with one f32 partial per key
    tile (:data:`BLOCK_K_TC`: 128 keys in either type), and the
    budget is ``MPIT_FA_FUSED_BWD_MAX_MB`` where set, else a quarter of the
    card's memory, leaving three quarters to the weights, activations and
    grads beside the transient: K5 is the faster schedule on the H100
    wherever its partials fit.  The card's size, not its free memory at
    the call, so that one configuration always runs one schedule (K5 and
    K6 sum dQ in another order).

    On the CPU both schedules run the same twin, and the choice is the JAX
    package's: its count over its own tiles (:func:`_jax_transient_mb`)
    against ``MPIT_FA_FUSED_BWD_MAX_MB``, or its default 2,048 MiB."""
    mode = os.environ.get("MPIT_FA_FUSED_BWD", "auto") or "auto"
    if mode == "0":
        return False
    if mode == "1":
        return True
    if mode != "auto":
        raise ValueError(f"MPIT_FA_FUSED_BWD={mode!r}: expected '0', '1', or 'auto'")
    lq, lk = q_shape[-2], k_shape[-2]
    n = math.prod(int(s) for s in q_shape[:-2])
    budget = os.environ.get("MPIT_FA_FUSED_BWD_MAX_MB")
    if device is not None and torch.device(device).type == "cuda":
        tiles = math.ceil(lk / BLOCK_K_TC)
        transient_mb = n * tiles * lq * d * 4 / 2**20
        return transient_mb <= (_card_mb(device) / 4 if budget is None else float(budget))
    transient_mb = _jax_transient_mb(n, lq, lk, d, dtype)
    return transient_mb <= (2048 if budget is None else float(budget))


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------


def _bind_tf32(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of csrc/flash_attention_tf32.cu, with its entry
    points' argument types set and its K5 key tile checked."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geo = [i32] * 6 + [f32, i32]  # n, lq, lk, d, offsets; scale; causal
    for fn, argtypes in (
        (lib.mpit_fa_fwd_tf32, [ptr] * 8 + geo + [i32, ptr]),
        (lib.mpit_fa_bwd_fused_tf32, [ptr] * 10 + geo + [ptr]),
        (lib.mpit_fa_bwd_dq_tf32, [ptr] * 7 + geo + [ptr]),
        (lib.mpit_fa_bwd_dkdv_tf32, [ptr] * 8 + geo + [ptr]),
        (lib.mpit_fa_bwd_tf32_block_k, []),
    ):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    if lib.mpit_fa_bwd_tf32_block_k() != BLOCK_K_TC:
        raise RuntimeError("flash_attention_tf32.cu's key tile differs from BLOCK_K_TC")
    return lib


@functools.cache
def _lib_tf32() -> ctypes.CDLL:
    """The float32 tensor-core kernels (3xTF32): K4, K5 and K6 in float32."""
    from mpit_tpu_torch.ops import build  # nvcc runs on first use only

    return _bind_tf32(build.load("flash_attention_tf32"))


@functools.cache
def _lib_tc() -> ctypes.CDLL:
    """The tensor-core kernels: K4, K5 and K6 in bfloat16."""
    from mpit_tpu_torch.ops import build

    lib = build.load("flash_attention_tc")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geo = [i32] * 6 + [f32, i32]
    for fn, argtypes in (
        (lib.mpit_fa_fwd_tc, [ptr] * 8 + geo + [i32, ptr]),
        (lib.mpit_fa_bwd_fused_tc, [ptr] * 10 + geo + [ptr]),
        (lib.mpit_fa_bwd_dq_tc, [ptr] * 7 + geo + [ptr]),
        (lib.mpit_fa_bwd_dkdv_tc, [ptr] * 8 + geo + [ptr]),
        (lib.mpit_fa_bwd_tc_block_k, []),
    ):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    if lib.mpit_fa_bwd_tc_block_k() != BLOCK_K_TC:
        raise RuntimeError("flash_attention_tc.cu's key tile differs from BLOCK_K_TC")
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _check_aligned(**tensors) -> None:
    """The kernels' copies (TMA in bfloat16, 16 bytes a thread in float32)
    need every operand to start at a multiple of 16 bytes (its rows do, D
    being a multiple of 8)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a 16-byte aligned address for "
                             "the kernels (a view into another tensor?)")


def flash_fwd(q, k, v, *, causal: bool = False, sm_scale: Optional[float] = None,
              q_offset: int = 0, kv_offset: int = 0, partial: bool = False):
    """K4 over ``(..., L, D)``.  Returns the normalized output (in q's
    dtype) and the row ``lse`` (f32, ``(..., Lq)``), or with ``partial``
    the f32 partials ``(acc, m, l)``.  Outputs are new tensors; each
    launch adds one to ``flash_fwd.launches``."""
    lead, lq, lk, d = _check_qkv(q, k, v)
    q_offset, kv_offset = _check_offsets(lq, lk, q_offset, kv_offset)
    scale = _scale(d, sm_scale)
    if q.device.type == "cpu":
        acc, m, l = block_attention_partial(q, k, v, causal=causal, sm_scale=scale,
                                            q_offset=q_offset, kv_offset=kv_offset)
        if partial:
            return acc, m, l
        return finalize_partials(acc, l, q.dtype), _lse_of(m, l)
    stream = _cuda_stream(q)
    _check_aligned(q=q, k=k, v=v)
    if q.dtype == torch.bfloat16:
        fwd = _lib_tc().mpit_fa_fwd_tc
    else:
        fwd = _lib_tf32().mpit_fa_fwd_tf32
    rows = dict(dtype=torch.float32, device=q.device)
    if partial:
        acc = torch.empty(*lead, lq, d, **rows)
        m, l = torch.empty(*lead, lq, **rows), torch.empty(*lead, lq, **rows)
        outs = (None, None, acc.data_ptr(), m.data_ptr(), l.data_ptr())
    else:
        o, lse = torch.empty_like(q), torch.empty(*lead, lq, **rows)
        outs = (o.data_ptr(), lse.data_ptr(), None, None, None)
    err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), *outs, math.prod(lead), lq, lk,
              d, q_offset, kv_offset, scale, int(bool(causal)), int(bool(partial)), stream)
    _raise_on(err, "flash_fwd")
    flash_fwd.launches += 1
    return (acc, m, l) if partial else (o, lse)


flash_fwd.launches = 0


def _bwd_operands(q, k, v, do, lse, delta, q_offset, kv_offset):
    lead, lq, lk, d = _check_qkv(q, k, v)
    if not (isinstance(do, torch.Tensor) and do.shape == q.shape
            and do.dtype == q.dtype and do.device == q.device and do.is_contiguous()):
        raise ValueError("do must be a contiguous tensor like q")
    _check_rows(lead, lq, q.device, lse=lse, delta=delta)
    return (lead, lq, lk, d) + _check_offsets(lq, lk, q_offset, kv_offset)


def flash_bwd_fused(q, k, v, do, lse, delta, *, causal: bool = False,
                    sm_scale: Optional[float] = None, q_offset: int = 0,
                    kv_offset: int = 0):
    """K5: ``(dq, dk, dv)`` in one sweep, key tiles outer, on the tensor
    cores (float32 by 3xTF32).  The sweep writes one
    f32 dQ partial per live (q tile, key tile) pair into a scratch of one
    ``(..., Lq, D)`` slot per key tile, and a second launch, K5's
    deterministic reduction, sums each q tile's live slots in ascending
    order into dq.  Each call (sweep and reduction) adds one to
    ``flash_bwd_fused.launches``."""
    lead, lq, lk, d, q_offset, kv_offset = _bwd_operands(
        q, k, v, do, lse, delta, q_offset, kv_offset)
    scale = _scale(d, sm_scale)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, do, lse, delta, causal=causal,
                                       sm_scale=scale, q_offset=q_offset,
                                       kv_offset=kv_offset)
    stream = _cuda_stream(q)
    _check_aligned(q=q, k=k, v=v, do=do)
    if q.dtype == torch.bfloat16:
        bwd = _lib_tc().mpit_fa_bwd_fused_tc
    else:
        bwd = _lib_tf32().mpit_fa_bwd_fused_tf32
    tiles = math.ceil(lk / BLOCK_K_TC)
    dqp = torch.empty(tiles, *lead, lq, d, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dqp.data_ptr(),
              math.prod(lead), lq, lk, d, q_offset, kv_offset, scale, int(bool(causal)),
              stream)
    _raise_on(err, "flash_bwd_fused")
    flash_bwd_fused.launches += 1
    return dq, dk, dv


flash_bwd_fused.launches = 0


def flash_bwd_two_kernel(q, k, v, do, lse, delta, *, causal: bool = False,
                         sm_scale: Optional[float] = None, q_offset: int = 0,
                         kv_offset: int = 0):
    """K6: dQ with q tiles outer, then dK and dV with key tiles outer (K5's
    sweep without its dQ), on the tensor cores (float32 by 3xTF32); no
    transient beyond the outputs.  Each of its two launches adds one to
    ``flash_bwd_two_kernel.launches``."""
    lead, lq, lk, d, q_offset, kv_offset = _bwd_operands(
        q, k, v, do, lse, delta, q_offset, kv_offset)
    scale = _scale(d, sm_scale)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, do, lse, delta, causal=causal,
                                       sm_scale=scale, q_offset=q_offset,
                                       kv_offset=kv_offset)
    stream = _cuda_stream(q)
    _check_aligned(q=q, k=k, v=v, do=do)
    if q.dtype == torch.bfloat16:
        lib = _lib_tc()
        bwd_dq, bwd_dkdv = lib.mpit_fa_bwd_dq_tc, lib.mpit_fa_bwd_dkdv_tc
    else:
        lib = _lib_tf32()
        bwd_dq, bwd_dkdv = lib.mpit_fa_bwd_dq_tf32, lib.mpit_fa_bwd_dkdv_tf32
    geo = (math.prod(lead), lq, lk, d, q_offset, kv_offset, scale, int(bool(causal)),
           stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr())
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _raise_on(bwd_dq(*ins, dq.data_ptr(), *geo), "flash_bwd_two_kernel (dq)")
    flash_bwd_two_kernel.launches += 1
    _raise_on(bwd_dkdv(*ins, dk.data_ptr(), dv.data_ptr(), *geo),
              "flash_bwd_two_kernel (dkdv)")
    flash_bwd_two_kernel.launches += 1
    return dq, dk, dv


flash_bwd_two_kernel.launches = 0


# ---------------------------------------------------------------------------
# Public ops
# ---------------------------------------------------------------------------


def flash_attention_partial(q, k, v, *, causal: bool = False,
                            sm_scale: Optional[float] = None, q_offset: int = 0,
                            kv_offset: int = 0):
    """Unnormalized ``(acc, m, l)`` over ``(..., L, D)`` by K4's partial
    mode; forward only (ring attention pairs it with
    :func:`flash_attention_bwd_pair`)."""
    return flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset,
                     kv_offset=kv_offset, partial=True)


def flash_attention_bwd_pair(q, k, v, do, lse, *, causal: bool = False,
                             sm_scale: Optional[float] = None, q_offset: int = 0,
                             kv_offset: int = 0, delta=None, o=None):
    """Flash backward for one (Q chunk, KV chunk) pair over ``(..., L, D)``:
    returns ``(dq, dk, dv)`` given the forward's row ``lse`` (``(...,
    Lq)``) and either ``delta = rowsum(dO*O)`` or ``o`` to compute it from
    (in f32).  K5 or K6, as :func:`_use_fused_bwd` decides."""
    if delta is None:
        if o is None:
            raise ValueError("flash_attention_bwd_pair needs delta or o")
        delta = (do.float() * o.float()).sum(-1)
    fused = _use_fused_bwd(q.shape, k.shape, q.shape[-1], q.device, q.dtype)
    bwd = flash_bwd_fused if fused else flash_bwd_two_kernel
    return bwd(q, k, v, do, lse, delta, causal=causal, sm_scale=sm_scale,
               q_offset=q_offset, kv_offset=kv_offset)


class _FlashAttention(torch.autograd.Function):
    """K4 forward (saving ``o`` and ``lse``), K5 or K6 backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_offset, kv_offset):
        o, lse = flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                           q_offset=q_offset, kv_offset=kv_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset,
                        kv_offset=kv_offset)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_pair(q, k, v, g.contiguous(), lse, o=o,
                                              **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None, q_offset: int = 0,
                    kv_offset: int = 0) -> torch.Tensor:
    """Flash attention over ``(..., L, D)`` with global-offset causal
    masking; leading axes are batched.  Differentiable: the backward
    recomputes ``P`` tile by tile from the saved ``lse``, so neither pass
    holds an ``(Lq, Lk)`` matrix on the card."""
    return _FlashAttention.apply(q, k, v, bool(causal), sm_scale, int(q_offset),
                                 int(kv_offset))
