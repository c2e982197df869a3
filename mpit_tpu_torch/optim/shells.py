"""Client-side shells for server-stateful rules, and single-worker mode.

The port of ``mpit_tpu/optim/shells.py``.

**RuleShell** (reference BiCNN/optim-{rmsprop,adam,adamax,adagrad,
adadelta}.lua): in 'global' mode the client ships *raw* gradients — every
step when su==1, else accumulated and shipped on every su-th step — and the
server applies the actual optimizer rule to its shard
(:mod:`mpit_tpu_torch.optim.rules`, server-side Adam being kernel K3).
Between syncs the local params do not move (reference optim-adam.lua:41
"do nothing here").  RMSProp additionally has a 'local' mode where the
client applies centered-RMSProp itself and ships the *update* for the
server to plain-add (reference optim-rmsprop.lua:48-65,76-92).

**SingleWorker** (reference BiCNN/optim-*-single.lua, BiCNN/optim-msgd.lua):
one worker runs the full optimizer locally — the same rules math with plain
bias correction, so ``adam-single`` runs K3 on the worker — then pushes the
whole parameter vector so the server acts as a parameter mirror (reference
optim-adam-single.lua:35-36).

Both shells keep ``w`` on the worker's device and write float32 into the
client's host mirrors on sync rounds; a fetched mirror is copied into
``w``, never aliased (the client overwrites it on the next pull).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Tuple

import numpy as np
import torch

from mpit_tpu_torch.obs.metrics import get_registry
from mpit_tpu_torch.optim import rules as rules_mod
from mpit_tpu_torch.optim.client_api import ParamClientAPI
from mpit_tpu_torch.optim.downpour import host_copy_behind
from mpit_tpu_torch.optim.msgd import MSGDConfig, msgd_init, msgd_step


class RuleShell:
    """Accumulate-and-ship client for server-side optimizer rules."""

    def __init__(
        self,
        value_and_grad_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
        pclient: ParamClientAPI,
        *,
        su: int = 1,
        mode: str = "global",
        # 'local'-mode RMSProp hyperparameters (reference optim-rmsprop.lua):
        lr: float = 1e-2,
        decay: float = 0.95,
        momentum: float = 0.9,
        epsilon: float = 1e-4,
    ):
        if su < 1:
            raise ValueError("su must be >= 1")
        if mode not in ("global", "local"):
            raise ValueError(f"mode must be 'global' or 'local', got {mode!r}")
        self._vgf = value_and_grad_fn
        self.pc = pclient
        self.su = su
        self.mode = mode
        self.k = 0
        self.dusync = 0.0
        self._started = False
        # Training telemetry: the loss and the shipped update's norm, on
        # sync rounds only and only when obs is enabled; the loss rides
        # the payload's copy (see :func:`host_copy_behind`).
        _reg = get_registry()
        self._obs = _reg.enabled
        self._m_loss = _reg.gauge("mpit_train_loss", opt=f"rule-{mode}")
        self._m_unorm = _reg.gauge("mpit_train_update_norm", opt=f"rule-{mode}")
        if mode == "local":
            # Client-side centered RMSProp producing an additive update.
            self._rule = rules_mod.make(
                "rmsprop", lr=lr, decay=decay, momentum=momentum, epsilon=epsilon
            )

    def start(self, w: torch.Tensor) -> torch.Tensor:
        self.w_host = w.detach().to("cpu", copy=True).numpy()
        self.grad_host = np.zeros_like(self.w_host)
        self.accum = torch.zeros_like(w)
        if self.mode == "local":
            self.rstate = self._rule.init(w)
        self.pc.start(self.w_host, self.grad_host)
        self._started = True
        return w

    def _sync(self, w: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
        np.copyto(self.grad_host, payload.detach().cpu().numpy())
        if self._obs:
            self._m_unorm.set(float(np.linalg.norm(self.grad_host)))
        self.pc.async_send_grad()
        self.pc.async_recv_param()
        t0 = time.monotonic()
        self.pc.wait()
        self.dusync += time.monotonic() - t0
        return w.copy_(torch.from_numpy(self.w_host))

    def step(self, w: torch.Tensor, *fn_args: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        assert self._started, "call start(w) first"
        loss, g = self._vgf(w, *fn_args)
        if self.mode == "local":
            # The shipped quantity is the rule's update (reference :59-60).
            g = self._rule.apply(w.clone(), g, self.rstate)[0] - w
        synced = self.su == 1 or self.k % self.su == 0
        loss_host = host_copy_behind(loss) if self._obs and synced else None
        if self.su == 1:
            w = self._sync(w, g)
        else:
            self.accum.add_(g)
            if self.k % self.su == 0:
                w = self._sync(w, self.accum)
                self.accum.zero_()
            elif self.mode == "local":
                w.add_(g)  # move locally (reference optim-rmsprop.lua:63)
            # global mode: params do not move between syncs (reference :41)
        if loss_host is not None:  # complete: the payload's copy waited
            self._m_loss.set(float(loss_host))
        self.k += 1
        return w, loss

    def stop(self) -> None:
        if self._started:
            self.pc.stop()


class SingleWorker:
    """Full local optimizer + whole-param push (server as mirror)."""

    def __init__(
        self,
        value_and_grad_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
        pclient: ParamClientAPI,
        *,
        rule: str = "adam",
        **hyperparams: Any,
    ):
        self._vgf = value_and_grad_fn
        self.pc = pclient
        self._started = False
        if rule == "msgd":
            self._msgd = MSGDConfig(**hyperparams)
        else:
            # Single-worker bias correction uses the plain exponent t
            # (reference optim-adam-single.lua:28-30), hence no step_div.
            self._msgd = None
            self._rule = rules_mod.make(rule, **hyperparams)

    def start(self, w: torch.Tensor) -> torch.Tensor:
        self.state = msgd_init(w) if self._msgd else self._rule.init(w)
        self.w_host = w.detach().to("cpu", copy=True).numpy()
        self.grad_host = np.zeros_like(self.w_host)
        self.pc.start(self.w_host, self.grad_host)
        self._started = True
        return w

    def step(self, w: torch.Tensor, *fn_args: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        assert self._started, "call start(w) first"
        if self._msgd:
            w, self.state, loss = msgd_step(self._vgf, w, self.state, self._msgd,
                                            *fn_args)
        else:
            loss, g = self._vgf(w, *fn_args)
            w, self.state = self._rule.apply(w, g, self.state)
        # Push the whole parameter vector (reference optim-adam-single.lua:35-36).
        np.copyto(self.w_host, w.detach().cpu().numpy())
        self.pc.async_send_param()
        self.pc.wait()
        return w, loss

    def stop(self) -> None:
        if self._started:
            self.pc.stop()
