"""Fused parameter-update kernels on flat f32 vectors.

The port of ``mpit_tpu/ops/fused_update.py``, all three of its kernels:

- K1 :func:`fused_nesterov_commit`, the msgd commit with the EASGD retract
  riding along;
- K2 :func:`fused_elastic`, the EASGD exchange's elementwise half (force
  and retract in one sweep), on EAMSGD's comm-only path;
- K3 :func:`fused_adam`, the Adam rule's moments and step in one sweep,
  on the server's ``adam`` shard rule and ``adam-single``'s local step.

Each is a CUDA kernel written for Hopper (``csrc/fused_update.cu``, whose
comments say what bounds each and how it is designed), built by
:mod:`mpit_tpu_torch.ops.build` on first use and launched through
``ctypes`` on PyTorch's current stream.  The routing is fixed by where the
tensors lie: CUDA tensors always go through the kernel, CPU tensors always
through the plain twin (``*_reference``).  There is no switch and no
fallback; a kernel that fails to build or launch raises.  Each wrapper
adds one to its ``launches`` count per launch of its kernel, and nowhere
else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch


def fused_nesterov_commit_reference(w, vt, g, clr, *, l2wd: float = 0.0,
                                    sug=None):
    """Plain PyTorch twin: returns new ``(w, vt)``.  Rows of a 2-D ``w``
    take their own entry of ``clr``.  Each operation rounds on its own, as
    the kernel does."""
    if l2wd != 0.0:
        g = g + l2wd * w
    if w.dim() == 2:
        clr = clr.reshape(-1, 1)
    step = clr * g
    w_new = w - step
    if sug is not None:
        w_new = w_new - sug
    return w_new, vt - step


_F32 = torch.float32


def _check_operands(names, tensors, n_same: int) -> None:
    """Each operand a contiguous float32 tensor on the first one's device,
    and the first ``n_same`` all of one shape.  One pass with no isinstance
    and no message built while every operand passes; where one does not,
    :func:`_explain` finds it and raises."""
    first = tensors[0]
    try:
        device, shape = first.device, first.shape
        for t in tensors:
            if t.dtype is not _F32 or t.device != device or not t.is_contiguous():
                break
        else:
            for t in tensors[1:n_same]:
                if t.shape != shape:
                    break
            else:
                return
    except AttributeError:  # not a tensor
        pass
    _explain(names, tensors, n_same)


def _explain(names, tensors, n_same: int) -> None:
    """Raises for the first operand that :func:`_check_operands` refuses."""
    first = tensors[0]
    if not isinstance(first, torch.Tensor):
        raise TypeError(f"{names[0]} must be a tensor, got {type(first).__name__}")
    device, shape = first.device, first.shape
    for i, t in enumerate(tensors):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{names[i]} must be a tensor, got {type(t).__name__}")
        if t.dtype is not _F32:
            raise TypeError(f"{names[i]} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{names[i]} is on {t.device}, {names[0]} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{names[i]} must be contiguous")
        if 0 < i < n_same and t.shape != shape:
            raise ValueError(f"{names[i]} has shape {tuple(t.shape)}, "
                             f"{names[0]} {tuple(shape)}")
    raise AssertionError("_explain found no fault")


_K1_NAMES = ("w", "vt", "g", "clr")
_K1_NAMES_SUG = ("w", "vt", "g", "sug", "clr")


def _check(w, vt, g, clr, sug) -> int:
    """Validate the operands; returns the number of rows."""
    if sug is None:
        _check_operands(_K1_NAMES, (w, vt, g, clr), 3)
    else:
        _check_operands(_K1_NAMES_SUG, (w, vt, g, sug, clr), 4)
    shape = w.shape
    if len(shape) == 1:
        n_rows = 1
        if clr.numel() != 1:
            raise ValueError(f"1-D w takes one clr, got shape {tuple(clr.shape)}")
    elif len(shape) == 2:
        n_rows = shape[0]
        if clr.shape != (n_rows,):
            raise ValueError(f"clr must have shape ({n_rows},), got "
                             f"{tuple(clr.shape)}")
    else:
        raise ValueError(f"w must be (n,) or (rows, n), got {tuple(shape)}")
    if 0 in shape:
        raise ValueError("w is empty")
    return n_rows


@functools.cache
def _lib() -> ctypes.CDLL:
    from mpit_tpu_torch.ops import build  # nvcc runs on first use only

    lib = build.load("fused_update")
    f32, i64, ptr = ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p
    for fn, argtypes in (
        (lib.mpit_nesterov_commit, [ptr] * 5 + [i64, i64, f32, ptr]),
        (lib.mpit_elastic, [ptr] * 3 + [i64, f32, ptr]),
        (lib.mpit_adam, [ptr] * 5 + [i64] + [f32] * 5 + [ptr]),
    ):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _cuda_stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream of ``t``'s card, as the kernels
    take it, without building a ``torch.cuda.Stream``; raises for any
    device without a kernel and for a card that is not the current one."""
    if not t.is_cuda:
        raise ValueError(f"no kernel for device {t.device}")
    index, current = t.get_device(), torch._C._cuda_getDevice()
    if index != current:
        raise ValueError(f"{t.device} is not the current CUDA device {current}")
    return torch._C._cuda_getCurrentRawStream(index)


def fused_nesterov_commit(
    w: torch.Tensor,
    vt: torch.Tensor,
    g: torch.Tensor,
    clr: torch.Tensor,
    *,
    l2wd: float = 0.0,
    sug: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-sweep msgd commit, in place on ``w`` and ``vt``, which it
    returns: ``w -= clr*g_eff (+ sug)``, ``vt -= clr*g_eff`` with
    ``g_eff = g + l2wd*w``.

    ``w``, ``vt``, ``g`` (and ``sug``) are ``(n,)`` with a one-element
    ``clr``, or ``(rows, n)`` with ``clr`` of shape ``(rows,)``: one launch
    commits every worker row.  ``clr`` is a tensor on the same device, so
    a decayed lr computed there never syncs the host.  The wrapper
    allocates nothing on the card.  Each launch adds one to
    ``fused_nesterov_commit.launches``."""
    n_rows = _check(w, vt, g, clr, sug)
    w_ptr, vt_ptr = w.data_ptr(), vt.data_ptr()
    if w_ptr == vt_ptr:
        raise ValueError("w and vt must be distinct buffers")
    if w.is_cpu:
        w_new, vt_new = fused_nesterov_commit_reference(
            w, vt, g, clr, l2wd=l2wd, sug=sug)
        w.copy_(w_new)
        vt.copy_(vt_new)
        return w, vt
    err = _lib().mpit_nesterov_commit(
        w_ptr, vt_ptr, g.data_ptr(), clr.data_ptr(), None if sug is None else sug.data_ptr(),
        n_rows, w.shape[-1], float(l2wd), _cuda_stream(w))
    if err != 0:
        raise RuntimeError(f"fused_nesterov_commit launch failed: CUDA error {err}")
    fused_nesterov_commit.launches += 1
    return w, vt


fused_nesterov_commit.launches = 0


# ---------------------------------------------------------------------------
# K2: elastic force + retract (EASGD exchange, elementwise half)
# ---------------------------------------------------------------------------


def fused_elastic_reference(w, center, mva):
    """Plain PyTorch twin: returns new ``(w - sug, sug)`` with
    ``sug = mva*(w - center)``; ``mva`` rounds to f32 once."""
    sug = mva * (w - center)
    return w - sug, sug


_K2_NAMES = ("w", "center")


def fused_elastic(w: torch.Tensor, center: torch.Tensor,
                  mva: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elastic exchange, worker side, in one sweep: ``sug = mva*(w -
    center)`` into a new tensor, ``w -= sug`` in place; returns ``(w,
    sug)``.  The center's ``+= sum(sug)`` is a cross-worker reduce and
    stays outside (reference optim-eamsgd.lua:58-66 / pserver.lua:83).
    Each launch adds one to ``fused_elastic.launches``."""
    _check_operands(_K2_NAMES, (w, center), 2)
    shape = w.shape
    if len(shape) != 1 or shape[0] == 0:
        raise ValueError(f"w must be a non-empty (n,) vector, got {tuple(shape)}")
    if w.data_ptr() == center.data_ptr():
        raise ValueError("w and center must be distinct buffers")
    if w.is_cpu:
        w_new, sug = fused_elastic_reference(w, center, float(mva))
        w.copy_(w_new)
        return w, sug
    stream = _cuda_stream(w)
    # sug at w's offset within 16 bytes: the sweep streams chunks only where
    # every operand shares it, so a view off the grid keeps its chunks.
    off = w.data_ptr() % 16 // 4
    sug = torch.empty(off + shape[0], device=w.device)[off:] if off else torch.empty_like(w)
    err = _lib().mpit_elastic(w.data_ptr(), center.data_ptr(), sug.data_ptr(), shape[0],
                              float(mva), stream)
    if err != 0:
        raise RuntimeError(f"fused_elastic launch failed: CUDA error {err}")
    fused_elastic.launches += 1
    return w, sug


fused_elastic.launches = 0


# ---------------------------------------------------------------------------
# K3: Adam moments + step
# ---------------------------------------------------------------------------


def fused_adam_reference(p, g, m, v, lr_t, *, beta1=0.9, beta2=0.999,
                         epsilon=1e-8):
    """Plain PyTorch twin: returns new ``(p, m, v)``.  Each operation
    rounds on its own, in the reference's order: ``((1-beta2)*g)*g`` and
    ``(lr_t*m)/(sqrt(v) + eps)``; ``1 - beta`` is taken in double and
    rounds to f32 once, as the reference's weak-typed scalars do."""
    m = beta1 * m + (1.0 - beta1) * g
    v = beta2 * v + (1.0 - beta2) * g * g
    p = p - lr_t * m / (torch.sqrt(v) + epsilon)
    return p, m, v


_K3_NAMES = ("p", "g", "m", "v", "lr_t")


def _check_adam(p, g, m, v, lr_t) -> None:
    _check_operands(_K3_NAMES, (p, g, m, v, lr_t), 4)
    shape = p.shape
    if len(shape) != 1 or shape[0] == 0:
        raise ValueError(f"p must be a non-empty (n,) vector, got {tuple(shape)}")
    if lr_t.numel() != 1:
        raise ValueError(f"lr_t must hold one element, got shape {tuple(lr_t.shape)}")


def fused_adam(
    p: torch.Tensor,
    g: torch.Tensor,
    m: torch.Tensor,
    v: torch.Tensor,
    lr_t: torch.Tensor,
    *,
    beta1: float = 0.9,
    beta2: float = 0.999,
    epsilon: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-sweep Adam, in place on ``p``, ``m`` and ``v``, which it
    returns.  ``lr_t`` is the bias-corrected learning rate, a one-element
    f32 tensor on the same device: the kernel reads it there, so the
    step counter and the correction never cross to the host.  The
    correction's exponent math stays with the caller
    (:func:`mpit_tpu_torch.optim.rules.adam_apply`).  Each launch adds
    one to ``fused_adam.launches``."""
    _check_adam(p, g, m, v, lr_t)
    p_ptr, m_ptr, v_ptr = p.data_ptr(), m.data_ptr(), v.data_ptr()
    if p_ptr == m_ptr or p_ptr == v_ptr or m_ptr == v_ptr:
        raise ValueError("p, m and v must be distinct buffers")
    if p.is_cpu:
        for dst, src in zip((p, m, v), fused_adam_reference(
                p, g, m, v, lr_t, beta1=beta1, beta2=beta2, epsilon=epsilon)):
            dst.copy_(src)
        return p, m, v
    err = _lib().mpit_adam(
        p_ptr, g.data_ptr(), m_ptr, v_ptr, lr_t.data_ptr(), p.shape[0], float(beta1),
        float(1.0 - beta1), float(beta2), float(1.0 - beta2), float(epsilon), _cuda_stream(p))
    if err != 0:
        raise RuntimeError(f"fused_adam launch failed: CUDA error {err}")
    fused_adam.launches += 1
    return p, m, v


fused_adam.launches = 0
