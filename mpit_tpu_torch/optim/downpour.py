"""DOWNPOUR distributed SGD (reference asyncsgd/optim-downpour.lua).

The port of ``mpit_tpu/optim/downpour.py``, same semantics:

- Every step computes ``dfdx = -(clr) * (grad + l2wd*w)`` with
  ``clr = lr/(1 + k*lrd)`` (reference :22-28,48 — linear decay, no power).
- ``su == 1`` (Hogwild-style): ship ``dfdx`` to the servers (which
  plain-add it) and fetch fresh params every step (reference :46-54).
- ``su > 1``: accumulate ``dfdx``; on every su-th step (k % su == 0,
  checked *before* increment, so the first step syncs) ship the accumulated
  delta and fetch params; between syncs apply ``dfdx`` locally
  (reference :26-45).

The parameters, gradient and accumulator stay on the worker's device and
are updated in place; host<->device copies happen only on sync steps,
into and out of the client's registered host mirrors.  A sync copies the
fetched mirror *into* ``w``: the mirror is the client's receive buffer and
is overwritten by the next pull, so ``w`` never aliases it.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Tuple

import numpy as np
import torch

from mpit_tpu_torch.obs.metrics import get_registry
from mpit_tpu_torch.optim.client_api import ParamClientAPI


def host_copy_behind(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` enqueued on the current stream without waiting
    (pinned memory on the card, ``t`` itself on the CPU).  It is complete
    once a later blocking copy on the stream returns: the optimizers take
    the loss this way behind the payload's copy of a sync round, so the
    loss gauge costs no device synchronize of its own."""
    return t.detach().to("cpu", non_blocking=True)

class Downpour:
    """A local step around a parameter client, synced every su steps."""

    def __init__(
        self,
        value_and_grad_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
        pclient: ParamClientAPI,
        *,
        lr: float,
        lrd: float = 0.0,
        l2wd: float = 0.0,
        su: int = 1,
    ):
        if su < 1:
            raise ValueError("su must be >= 1 (reference asserts pc and su>=1)")
        self._vgf = value_and_grad_fn
        self.pc = pclient
        self.lr, self.lrd, self.l2wd = lr, lrd, l2wd
        self.su = su
        self.k = 0
        self.dusync = 0.0  # blocking-sync seconds (reference state.dusync)
        self._started = False

        # Training telemetry (mpit_tpu_torch.obs): the loss and the shipped
        # update's norm, written on sync rounds only and only when obs is
        # enabled.  The loss reaches the host behind the payload's copy,
        # which waits for the step anyway: no device synchronize of its own.
        _reg = get_registry()
        self._obs = _reg.enabled
        self._m_loss = _reg.gauge("mpit_train_loss", opt="downpour")
        self._m_unorm = _reg.gauge("mpit_train_update_norm", opt="downpour")

    def start(self, w: torch.Tensor) -> torch.Tensor:
        """Register buffers with the client; first client seeds servers."""
        self.w_host = w.detach().to("cpu", copy=True).numpy()
        self.grad_host = np.zeros_like(self.w_host)
        self.accum = torch.zeros_like(w)
        self.pc.start(self.w_host, self.grad_host)
        self._started = True
        return w

    def _sync(self, w: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
        """Ship ``payload`` as the grad, fetch fresh params into ``w``,
        time the wait."""
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
        if self.l2wd != 0:
            g = g + self.l2wd * w
        if self.lrd != 0:
            k = torch.tensor(self.k, dtype=torch.float32, device=w.device)
            dfdx = -(self.lr / (1.0 + k * self.lrd)) * g
        else:
            dfdx = -self.lr * g
        synced = self.su == 1 or self.k % self.su == 0
        loss_host = host_copy_behind(loss) if self._obs and synced else None
        if self.su == 1:
            w = self._sync(w, dfdx)
        else:
            self.accum.add_(dfdx)
            if self.k % self.su == 0:
                w = self._sync(w, self.accum)
                self.accum.zero_()
            else:
                w.add_(dfdx)  # move locally between syncs (reference :44)
        if loss_host is not None:  # complete: the payload's copy waited
            self._m_loss.set(float(loss_host))
        self.k += 1
        return w, loss

    def stop(self) -> None:
        if self._started:
            self.pc.stop()
