"""Fused parameter-update kernels on flat f32 vectors.

The port of :mod:`mpit_tpu.ops.fused_update`.  This slice carries K1,
:func:`fused_nesterov_commit`, the msgd commit with the EASGD retract
riding along; the reference's ``fused_elastic`` and ``fused_adam`` belong
to later slices.

K1 is a CUDA kernel written for Hopper (``csrc/fused_update.cu``, whose
header says what bounds it and how it is designed), built by
:mod:`mpit_tpu_torch.ops.build` on first use and launched through
``ctypes`` on PyTorch's current stream.  The routing is fixed by where the
tensors lie: CUDA tensors always go through the kernel, CPU tensors always
through the plain twin :func:`fused_nesterov_commit_reference`.  There is
no switch and no fallback; a kernel that fails to build or launch raises.
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


def _check(w, vt, g, clr, sug) -> int:
    """Validate the operands; returns the number of rows."""
    tensors = {"w": w, "vt": vt, "g": g, "clr": clr}
    if sug is not None:
        tensors["sug"] = sug
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("vt", "g", "sug"):
        if name in tensors and tensors[name].shape != w.shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, "
                             f"w {tuple(w.shape)}")
    if w.dim() == 1:
        n_rows = 1
        if clr.numel() != 1:
            raise ValueError(f"1-D w takes one clr, got shape {tuple(clr.shape)}")
    elif w.dim() == 2:
        n_rows = w.shape[0]
        if tuple(clr.shape) != (n_rows,):
            raise ValueError(f"clr must have shape ({n_rows},), got "
                             f"{tuple(clr.shape)}")
    else:
        raise ValueError(f"w must be (n,) or (rows, n), got {tuple(w.shape)}")
    if w.numel() == 0:
        raise ValueError("w is empty")
    if w.data_ptr() == vt.data_ptr():
        raise ValueError("w and vt must be distinct buffers")
    return n_rows


@functools.cache
def _lib() -> ctypes.CDLL:
    from mpit_tpu_torch.ops import build  # nvcc runs on first use only

    lib = build.load("fused_update")
    fn = lib.mpit_nesterov_commit
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


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
    if w.device.type == "cpu":
        w_new, vt_new = fused_nesterov_commit_reference(
            w, vt, g, clr, l2wd=l2wd, sug=sug)
        w.copy_(w_new)
        vt.copy_(vt_new)
        return w, vt
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    if w.device.index != torch.cuda.current_device():
        raise ValueError(f"w is on {w.device}, the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    stream = torch.cuda.current_stream(w.device).cuda_stream
    err = _lib().mpit_nesterov_commit(
        w.data_ptr(), vt.data_ptr(), g.data_ptr(), clr.data_ptr(),
        None if sug is None else sug.data_ptr(),
        n_rows, w.shape[-1], float(l2wd), stream)
    if err != 0:
        raise RuntimeError(f"fused_nesterov_commit launch failed: CUDA error {err}")
    fused_nesterov_commit.launches += 1
    return w, vt


fused_nesterov_commit.launches = 0
