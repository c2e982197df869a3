"""Nesterov momentum SGD ("msgd") — the reference's local update rule.

The port of :mod:`mpit_tpu.optim.msgd`, same semantics
(reference asyncsgd/optim-msgd.lua):

1. optional momentum ramp ``mom_k = min(mommax, 1 - 0.5/(1 + k/momdecay))``;
2. lookahead ``vt *= mom_k; w += vt`` before the gradient is taken;
3. L2 term added to the gradient at the displaced point;
4. lr decay ``clr = lr/(1 + k*lrd)^lrp`` (when ``lrd > 0`` and ``lrp > 0``);
5. ``w -= clr*g; vt -= clr*g``, then ``k += 1``.

Unlike the pure JAX functions these update ``w`` and the state tensors in
place and return them, so a step allocates no parameter-sized buffer
beyond the gradient.  The step counter ``k`` is an int32 tensor on the
parameters' device and the decayed lr is computed there, so a step never
waits on the host.  With momentum, the commit of a flat vector is kernel
K1 (:func:`mpit_tpu_torch.ops.fused_update.fused_nesterov_commit`).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from mpit_tpu_torch.ops.fused_update import fused_nesterov_commit


class MSGDConfig(NamedTuple):
    lr: float = 0.0
    lrd: float = 0.0  # lr decay
    lrp: float = 0.0  # lr decay power
    mom: float = 0.0
    mommax: float = 1.0
    momdecay: float = 0.0
    l2wd: float = 0.0


def msgd_init(w: torch.Tensor) -> dict:
    return {
        "k": torch.zeros((), dtype=torch.int32, device=w.device),
        "vt": torch.zeros_like(w),
    }


def effective_momentum(cfg: MSGDConfig, k: torch.Tensor):
    """The (possibly ramped) momentum for step ``k``: a float, or an f32
    tensor shaped like ``k`` when it ramps."""
    if cfg.mom > 0 and cfg.momdecay > 0:
        ramp = 1.0 - 0.5 / (1.0 + k.float() / cfg.momdecay)
        return torch.clamp(ramp, max=cfg.mommax)
    return cfg.mom


def effective_lr(cfg: MSGDConfig, k: torch.Tensor) -> torch.Tensor:
    """The decayed learning rate for step ``k``, an f32 tensor shaped like
    ``k`` on ``k``'s device."""
    if cfg.lrd > 0 and cfg.lrp > 0:
        return cfg.lr / torch.pow(1.0 + k.float() * cfg.lrd, cfg.lrp)
    return torch.full(k.shape, cfg.lr, dtype=torch.float32, device=k.device)


def msgd_lookahead(w: torch.Tensor, state: dict, cfg: MSGDConfig) -> Tuple[torch.Tensor, dict]:
    """Phase 1, in place: ``vt *= mom_k; w += vt``."""
    if cfg.mom <= 0:
        return w, state
    mom = effective_momentum(cfg, state["k"])
    if isinstance(mom, torch.Tensor) and w.dim() == 2:
        mom = mom.reshape(-1, 1)  # one momentum per worker row
    state["vt"].mul_(mom)
    w.add_(state["vt"])
    return w, state


def msgd_commit(w: torch.Tensor, grad: torch.Tensor, state: dict,
                cfg: MSGDConfig, *, sug: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, dict]:
    """Phase 2, in place: weight decay, decayed-lr descent, velocity update,
    then the EASGD retract ``w -= sug`` when ``sug`` is given.  With
    momentum this is one launch of K1, the retract riding along."""
    clr = effective_lr(cfg, state["k"])
    if cfg.mom > 0:
        fused_nesterov_commit(w, state["vt"], grad, clr, l2wd=float(cfg.l2wd), sug=sug)
    else:
        if cfg.l2wd != 0:
            grad = grad + cfg.l2wd * w
        if w.dim() == 2:
            clr = clr.reshape(-1, 1)  # one lr per worker row
        w.sub_(clr * grad)
        if sug is not None:
            w.sub_(sug)
    state["k"].add_(1)
    return w, state


def msgd_step(
    value_and_grad_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
    w: torch.Tensor,
    state: dict,
    cfg: MSGDConfig,
    *fn_args: Any,
) -> Tuple[torch.Tensor, dict, torch.Tensor]:
    """One full msgd step: lookahead -> grad at displaced w -> commit.

    ``value_and_grad_fn(w, *fn_args) -> (loss, grad)``."""
    w, state = msgd_lookahead(w, state, cfg)
    loss, grad = value_and_grad_fn(w, *fn_args)
    w, state = msgd_commit(w, grad, state, cfg)
    return w, state, loss


class MSGD:
    """Object wrapper with the lifecycle the trainers dispatch on."""

    def __init__(self, cfg: MSGDConfig,
                 value_and_grad_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]]):
        self.cfg = cfg
        self._vgf = value_and_grad_fn
        self.state: dict | None = None

    def step(self, w: torch.Tensor, *fn_args: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        """Updates ``w`` in place; returns it and the loss (on the device)."""
        if self.state is None:
            self.state = msgd_init(w)
        w, self.state, loss = msgd_step(self._vgf, w, self.state, self.cfg, *fn_args)
        return w, loss
