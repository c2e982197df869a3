"""Shard-update rules (server-side optimizer math).

The port of ``mpit_tpu/optim/rules.py``, same math and the same quirks
(Adam's ``floor(t/step_div)+1`` bias-correction exponent, Adamax's
``|g|+eps`` inside the max, centered RMSProp with momentum).  In the
reference, the parameter server applies an optimizer rule to its shard
every time a gradient arrives, with per-rule state tensors allocated next
to the shard (reference BiCNN/pserver.lua:50-83 for state allocation,
:123-197 for the updates).  Here each rule is a pair

    init(p)              -> state            (a dict of tensors on p's device)
    apply(p, g, state)   -> (p, state)

where ``apply`` updates ``p`` and the state tensors **in place** and
returns them (the JAX package donates the same buffers), so an apply
allocates no shard-sized state.  Step counters are int32 tensors on the
shard's device and every scalar (Adam's ``lr_t``, Adagrad's decayed lr) is
computed there, so no apply waits on the host.  Adam's elementwise sweep
over a flat shard is kernel K3 (:func:`mpit_tpu_torch.ops.fused_update.
fused_adam`) on the card, its plain twin on the CPU.

The sign convention matches the reference wire protocol: clients ship either
pre-scaled updates (``-lr*grad`` for DOWNPOUR, elastic deltas for EASGD) to
be *plain-added*, or raw gradients for the server-side rules to consume.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from mpit_tpu_torch.ops.fused_update import fused_adam

State = Dict[str, torch.Tensor]


def _settle_cpu_kernels() -> None:
    """Run the CPU's elementwise math kernels once, in the importing thread.

    PyTorch's CPU kernels race on their first concurrent use: when several
    threads call ``torch.sqrt`` for the first time in a process at once, one
    of them can get a result 1,400 ulps off (``sqrt(1 - 0.999)`` read
    ``0x1.031194p-5`` for ``0x1.030d58p-5`` in 2 of 64 fresh processes of
    four threads; in 0 of 96 once the main thread had called it first).  A
    gang's servers are threads, so their first Adam applies met exactly
    that race: Adam's ``lr_t`` at ``t = 1`` came out wrong in one run of a
    pair that should agree bit for bit.  Settling every kernel the rules
    use here, at import, takes the first use out of the threads."""
    x = torch.full((64,), 0.5, dtype=torch.float32)
    e = torch.ones((), dtype=torch.float32)
    for v in (x, x[0]):
        torch.sqrt(v), torch.rsqrt(v), torch.exp(v), torch.log(v), torch.abs(v)
        torch.pow(0.9, v), torch.pow(v, 2.0), torch.maximum(v, v)
        1.0 - v, 0.5 * v / (v + 1e-8)
    torch.pow(0.999, e)


_settle_cpu_kernels()


class ShardRule(NamedTuple):
    """An (init, apply) pair with hyperparameters already bound."""

    init: Callable[[torch.Tensor], State]
    apply: Callable[[torch.Tensor, torch.Tensor, State], Tuple[torch.Tensor, State]]


def _step_counter(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=p.device)


# ---------------------------------------------------------------------------
# plain add — the default rule (reference asyncsgd/pserver.lua:83,
# BiCNN/pserver.lua:197): clients pre-scale, server just accumulates.
# ---------------------------------------------------------------------------


def add_init(p: torch.Tensor) -> State:
    del p
    return {}


def add_apply(p: torch.Tensor, g: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
    return p.add_(g), state


# ---------------------------------------------------------------------------
# centered RMSProp with momentum (reference BiCNN/pserver.lua:123-139)
# ---------------------------------------------------------------------------


def rmsprop_init(p: torch.Tensor) -> State:
    return {"grad_accum": torch.zeros_like(p), "grad_sq_accum": torch.zeros_like(p),
            "update": torch.zeros_like(p)}


def rmsprop_apply(
    p: torch.Tensor,
    g: torch.Tensor,
    state: State,
    *,
    lr: float = 1e-2,
    decay: float = 0.95,
    momentum: float = 0.9,
    epsilon: float = 1e-4,
) -> Tuple[torch.Tensor, State]:
    ga, gsq, update = state["grad_accum"], state["grad_sq_accum"], state["update"]
    ga.mul_(decay).add_((1.0 - decay) * g)
    gsq.mul_(decay).add_((1.0 - decay) * g * g)
    # Centered second moment: Var ≈ E[g²] - E[g]² (reference :133-136).
    grad_rms = torch.sqrt(gsq - ga * ga + epsilon)
    update.mul_(momentum).sub_(lr * g / grad_rms)
    return p.add_(update), state


# ---------------------------------------------------------------------------
# Adam (reference BiCNN/pserver.lua:140-155; single-worker variant
# BiCNN/optim-adam-single.lua:23-32)
# ---------------------------------------------------------------------------


def adam_init(p: torch.Tensor) -> State:
    return {"t": _step_counter(p), "m": torch.zeros_like(p), "v": torch.zeros_like(p)}


def adam_apply(
    p: torch.Tensor,
    g: torch.Tensor,
    state: State,
    *,
    lr: float = 1e-3,
    beta1: float = 0.9,
    beta2: float = 0.999,
    epsilon: float = 1e-8,
    step_div: int | None = None,
) -> Tuple[torch.Tensor, State]:
    """``step_div`` set -> server-mode bias correction with exponent
    ``floor(t/step_div)+1`` (reference :151-153 — dampens the correction when
    many async clients drive ``t``); None -> plain exponent ``t``
    (single-worker mode, reference optim-adam-single.lua:28-30).

    The elementwise sweep is K3 (:func:`fused_adam`: the kernel on the
    card, its plain twin on the CPU) over ``p`` seen flat, so ``p`` must be
    contiguous; the scalar bias correction stays here."""
    t = state["t"].add_(1)
    exponent = (t if step_div is None else t // step_div + 1).to(p.dtype)
    # A Python base rounds to f32 inside the kernel, so the correction
    # makes no tensor on the host (whose copy to the card would sync).
    beta1_t = 1.0 - torch.pow(beta1, exponent)
    beta2_t = 1.0 - torch.pow(beta2, exponent)
    lr_t = lr * torch.sqrt(beta2_t) / beta1_t
    fused_adam(p.view(-1), g.reshape(-1), state["m"].view(-1),
               state["v"].view(-1), lr_t, beta1=beta1, beta2=beta2,
               epsilon=epsilon)
    return p, state


# ---------------------------------------------------------------------------
# Adamax (reference BiCNN/pserver.lua:156-171)
# ---------------------------------------------------------------------------


def adamax_init(p: torch.Tensor) -> State:
    return {"t": _step_counter(p), "m": torch.zeros_like(p), "u": torch.zeros_like(p)}


def adamax_apply(
    p: torch.Tensor,
    g: torch.Tensor,
    state: State,
    *,
    lr: float = 2e-3,
    beta1: float = 0.9,
    beta2: float = 0.999,
    epsilon: float = 1e-8,
) -> Tuple[torch.Tensor, State]:
    t = state["t"].add_(1)
    m, u = state["m"], state["u"]
    m.mul_(beta1).add_((1.0 - beta1) * g)
    # Note: epsilon inside the max, on |g| (reference :164-166).
    torch.maximum(beta2 * u, torch.abs(g) + epsilon, out=u)
    beta1_t = 1.0 - torch.pow(beta1, t.to(p.dtype))
    lr_t = lr / beta1_t
    return p.sub_(lr_t * m / u), state


# ---------------------------------------------------------------------------
# Adagrad (reference BiCNN/pserver.lua:172-183)
# ---------------------------------------------------------------------------


def adagrad_init(p: torch.Tensor) -> State:
    return {"t": _step_counter(p), "variance": torch.zeros_like(p)}


def adagrad_apply(
    p: torch.Tensor,
    g: torch.Tensor,
    state: State,
    *,
    lr: float = 1e-2,
    lrd: float = 0.0,
    epsilon: float = 1e-10,
) -> Tuple[torch.Tensor, State]:
    clr = lr / (1.0 + state["t"].to(p.dtype) * lrd)
    variance = state["variance"].add_(g * g)
    std = torch.sqrt(variance) + epsilon  # epsilon added post-sqrt (reference :180-181)
    p.sub_(clr * g / std)
    state["t"].add_(1)
    return p, state


# ---------------------------------------------------------------------------
# Adadelta (reference BiCNN/pserver.lua:184-195)
# ---------------------------------------------------------------------------


def adadelta_init(p: torch.Tensor) -> State:
    return {"variance": torch.zeros_like(p), "acc_delta": torch.zeros_like(p)}


def adadelta_apply(
    p: torch.Tensor,
    g: torch.Tensor,
    state: State,
    *,
    lr: float = 1.0,
    rho: float = 0.9,
    epsilon: float = 1e-6,
) -> Tuple[torch.Tensor, State]:
    variance, acc_delta = state["variance"], state["acc_delta"]
    variance.mul_(rho).add_((1.0 - rho) * g * g)
    std = torch.sqrt(variance + epsilon)
    delta = torch.sqrt(acc_delta + epsilon) / std * g
    acc_delta.mul_(rho).add_((1.0 - rho) * delta * delta)
    return p.sub_(lr * delta), state


# ---------------------------------------------------------------------------
# Registry — the analog of the reference's optimization-name dispatch
# (BiCNN/pserver.lua:123,140,156,172,184 if/elseif chain).
# ---------------------------------------------------------------------------

_RULES: Dict[str, Tuple[Callable[..., State], Callable[..., Tuple[torch.Tensor, State]]]] = {
    "add": (add_init, add_apply),
    "rmsprop": (rmsprop_init, rmsprop_apply),
    "adam": (adam_init, adam_apply),
    "adamax": (adamax_init, adamax_apply),
    "adagrad": (adagrad_init, adagrad_apply),
    "adadelta": (adadelta_init, adadelta_apply),
}

#: Per-element optimizer-slot multiplicity of each rule: how many extra
#: vector-shaped state tensors the server allocates beside a shard (scalar
#: step counters are free).  A shard of S f32 elements under rule R costs
#: ``(1 + STATE_SLOTS[R]) * 4 * S`` bytes of device memory.
STATE_SLOTS: Dict[str, int] = {
    "add": 0,
    "rmsprop": 3,   # grad_accum, grad_sq_accum, update
    "adam": 2,      # m, v (t is scalar)
    "adamax": 2,    # m, u (t is scalar)
    "adagrad": 1,   # variance (t is scalar)
    "adadelta": 2,  # variance, acc_delta
}


def names() -> Tuple[str, ...]:
    return tuple(_RULES)


def make(name: str, **hyperparams: Any) -> ShardRule:
    """Bind hyperparameters, returning an (init, apply) pair.

    Hyperparameter names are validated eagerly so a typo fails here, at the
    config site, rather than at the first apply."""
    try:
        init, apply = _RULES[name]
    except KeyError:
        raise ValueError(f"unknown rule {name!r}; have {sorted(_RULES)}") from None
    if hyperparams:
        valid = {
            p.name
            for p in inspect.signature(apply).parameters.values()
            if p.kind is inspect.Parameter.KEYWORD_ONLY
        }
        unknown = set(hyperparams) - valid
        if unknown:
            raise ValueError(
                f"rule {name!r} has no hyperparameter(s) {sorted(unknown)}; "
                f"valid: {sorted(valid)}"
            )
        apply = functools.partial(apply, **hyperparams)
    return ShardRule(init=init, apply=apply)
