"""EASGD / EAMSGD — elastic-averaging distributed SGD
(reference asyncsgd/optim-eamsgd.lua; mom == 0 gives EASGD, reference :3).

The port of ``mpit_tpu/optim/easgd.py``.  Per sync round (every su-th
step, first step included):

1. fetch the center variable w* from the servers (reference :54-57);
2. elastic delta ``sug = mva * (w - w*)`` computed against the *pre-update*
   local w (reference :58-60);
3. push sug as a "gradient" — servers plain-add, i.e. ``w* += mva*(w-w*)``
   (reference :61); the push is *not* waited on: a single ``ping`` overlaps
   it with the local compute (reference :62-64) and it completes during the
   next round's ``wait`` at the latest;
4. the local Nesterov update runs (msgd minus the momentum ramp, reference
   :24-45): :func:`msgd_lookahead` and :func:`msgd_commit`, whose commit
   is kernel K1;
5. ``w -= sug`` pulls the worker toward the center (reference :66).  It
   rides K1's commit, which subtracts ``sug`` after the descent step in
   the same sweep — the reference's separate retract, rounded the same.

Between rounds only the local update runs.  ``w``, ``vt`` and the elastic
algebra stay on the worker's device; only w* (in) and sug (out) cross to
the host, once per round.

Comm-only mode (``lr == 0``, reference :25): no local update runs, so the
force and the retract are adjacent and run as one sweep, kernel K2
(:func:`mpit_tpu_torch.ops.fused_update.fused_elastic`).  The step count
never advances there, so every step is a sync round.

Wire codecs: the elastic push rides the client's GRAD channel, so with
``int8`` the shipped ``sug`` is block-quantized and the client's
error-feedback residual re-ships each round's quantization error next
round.  The local retract deliberately uses the *exact* sug.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Tuple

import numpy as np
import torch

from mpit_tpu_torch.obs.metrics import get_registry
from mpit_tpu_torch.ops.fused_update import fused_elastic
from mpit_tpu_torch.optim.client_api import ParamClientAPI
from mpit_tpu_torch.optim.msgd import MSGDConfig, msgd_commit, msgd_init, msgd_lookahead


class EAMSGD:
    def __init__(
        self,
        value_and_grad_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
        pclient: ParamClientAPI,
        *,
        lr: float,
        lrd: float = 0.0,
        lrp: float = 0.0,
        mom: float = 0.0,
        l2wd: float = 0.0,
        mva: float = 0.0,  # moving rate alpha (mlaunch uses beta/p = 0.9/6)
        su: int = 1,  # communication period tau
    ):
        if not (su > 0 and mva > 0):
            raise ValueError("eamsgd requires su>0 and mva>0 (reference :86)")
        self._vgf = value_and_grad_fn
        self.pc = pclient
        self.su = su
        self.mva = mva
        self.dusync = 0.0
        self._started = False
        # Local rule = msgd without the momentum ramp (reference :24-45).
        self.cfg = MSGDConfig(lr=lr, lrd=lrd, lrp=lrp, mom=mom, momdecay=0.0,
                              l2wd=l2wd)
        self._skip_local = lr == 0.0  # reference :25 guards localupdate on lr~=0
        # Training telemetry (mpit_tpu_torch.obs): the elastic distance
        # ||w - w*||, EASGD's own convergence signal, and the shipped
        # update's norm, from the sug host mirror on sync rounds only and
        # only when obs is enabled (host reductions: no device sync).
        _reg = get_registry()
        self._obs = _reg.enabled
        self._m_dist = _reg.gauge("mpit_train_elastic_distance", opt="eamsgd")
        self._m_unorm = _reg.gauge("mpit_train_update_norm", opt="eamsgd")

    def start(self, w: torch.Tensor) -> torch.Tensor:
        self.state = msgd_init(w)
        self._steps = 0  # mirrors state["k"] host-side for the su modulus
        # Dedicated comm copies: recv target for w*, send source for sug
        # (reference :49-53 allocates suw/sug and retargets the client).
        self.center_host = np.zeros(w.shape[0], np.float32)
        self.sug_host = np.zeros_like(self.center_host)
        self.pc.start(w.detach().to("cpu", copy=True).numpy(), self.sug_host)
        self.pc.reset(self.center_host, self.sug_host)
        self._started = True
        return w

    def step(self, w: torch.Tensor, *fn_args: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        assert self._started, "call start(w) first"
        sug = None
        if self._steps % self.su == 0:
            self.pc.async_recv_param()  # center_host <- w*
            t0 = time.monotonic()
            self.pc.wait()  # completes this recv and any prior send
            self.dusync += time.monotonic() - t0
            center = torch.from_numpy(self.center_host).to(w.device, copy=True)
            if self._skip_local:
                # One sweep computes sug and the retracted w together (K2).
                w, sug = fused_elastic(w, center, self.mva)
            else:
                sug = self.mva * (w - center)
            np.copyto(self.sug_host, sug.cpu().numpy())
            if self._obs:
                # sug = mva * (w - w*): one norm serves both gauges.
                unorm = float(np.linalg.norm(self.sug_host))
                self._m_unorm.set(unorm)
                self._m_dist.set(unorm / self.mva)
            self.pc.async_send_grad()  # server: w* += sug
            t0 = time.monotonic()
            self.pc.ping()  # overlap I/O with local compute (reference :63)
            self.dusync += time.monotonic() - t0

        if self._skip_local:
            return w, torch.zeros((), device=w.device)
        w, self.state = msgd_lookahead(w, self.state, self.cfg)
        loss, grad = self._vgf(w, *fn_args)
        # The retract w -= sug (reference :66) rides the commit.
        w, self.state = msgd_commit(w, grad, self.state, self.cfg, sug=sug)
        self._steps += 1
        return w, loss

    def stop(self) -> None:
        if self._started:
            self.pc.wait()  # drain the in-flight elastic push
            self.pc.stop()
