"""Synchronous EASGD/EAMSGD with every worker on one device.

The port of :class:`mpit_tpu.parallel.easgd.MeshEASGD`.  Every worker's
parameters are one row of a ``(n_dp, plong)`` tensor, the center w* is a
``(plong,)`` tensor, and both live on the mesh's one device.  A step is:

- the local Nesterov update of :mod:`mpit_tpu_torch.optim.msgd` for every
  row at once, with per-worker gradients from ``torch.func.vmap``;
- on every ``su``-th step (the first included) the elastic exchange
  ``sug = mva * (w_i - w*)``, ``w* += sum_i sug_i``, ``w_i -= sug_i``
  (reference optim-eamsgd.lua:58-66 / pserver.lua:83).

The order inside a sync step is the reference's: ``sug`` is taken from the
pre-lookahead ``w`` and the center moves before the lookahead; the
retract is applied after the local update, riding the same K1 launch as
the commit.  The state tensors are updated in place, so ``sug`` is
computed before the lookahead touches ``w``.

The sync schedule reads the host counter ``_steps % su`` in both
:meth:`MeshEASGD.step` and :meth:`MeshEASGD.run_epoch`, which is the
reference's schedule for runs that start at step 0.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from mpit_tpu_torch.optim.msgd import MSGDConfig, msgd_commit, msgd_lookahead
from mpit_tpu_torch.parallel.mesh import Mesh

State = Dict[str, torch.Tensor]


class MeshEASGD:
    """Synchronous elastic-averaging trainer over the one-device mesh.

    ``value_and_grad_fn(w, xb, yb) -> (loss, grad)`` acts on one worker's
    flat parameter vector and must be ``torch.func``-transformable.
    Batches are stacked per worker: ``(n_dp, batch, ...)``.
    """

    def __init__(
        self,
        mesh: Mesh,
        value_and_grad_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
        cfg: MSGDConfig,
        *,
        mva: float,
        su: int = 1,
    ):
        if not (su > 0 and mva > 0):
            raise ValueError("easgd requires su>0 and mva>0 (reference :86)")
        self.mesh = mesh
        self.cfg = cfg
        self.mva = float(mva)
        self.su = int(su)
        self.n_dp = mesh.shape["dp"]
        self.device = mesh.device
        self._steps = 0
        self._grads = torch.func.vmap(value_and_grad_fn)

    # -- state ---------------------------------------------------------------

    def init(self, w0: torch.Tensor) -> State:
        """Every worker row and the center start as copies of ``w0``."""
        w0 = w0.to(self.device, torch.float32)
        self._steps = 0
        return {
            "w": w0.expand(self.n_dp, -1).clone(),
            "vt": torch.zeros(self.n_dp, w0.shape[0], device=self.device),
            "k": torch.zeros(self.n_dp, dtype=torch.int32, device=self.device),
            "center": w0.clone(),
        }

    def shard_batch(self, *arrays: Any) -> Tuple[torch.Tensor, ...]:
        """Place ``(n_dp, batch, ...)`` host arrays on the mesh's device."""
        return tuple(torch.as_tensor(a).to(self.device) for a in arrays)

    # -- stepping ------------------------------------------------------------

    def _local(self, state: State, xb, yb) -> torch.Tensor:
        msgd_lookahead(state["w"], state, self.cfg)
        loss, grad = self._grads(state["w"], xb, yb)
        msgd_commit(state["w"], grad, state, self.cfg)
        return loss

    def _sync(self, state: State, xb, yb) -> torch.Tensor:
        # Every worker's push from its pre-update w (optim-eamsgd.lua:54-61),
        # the center moved before the local update.
        sug = self.mva * (state["w"] - state["center"])
        state["center"].add_(sug.sum(dim=0))
        msgd_lookahead(state["w"], state, self.cfg)
        loss, grad = self._grads(state["w"], xb, yb)
        # The elastic retract after the local update (ref :66).
        msgd_commit(state["w"], grad, state, self.cfg, sug=sug)
        return loss

    def step(self, state: State, xb: torch.Tensor, yb: torch.Tensor):
        """One training step for every worker, in place on ``state``;
        elastic exchange on every su-th call (the first included, as in
        the reference's ``k % su == 0``, optim-eamsgd.lua:47).  Returns the
        state and the ``(n_dp,)`` per-worker losses on the device."""
        if self._steps % self.su == 0:
            loss = self._sync(state, xb, yb)
        else:
            loss = self._local(state, xb, yb)
        self._steps += 1
        return state, loss

    def center_params(self, state: State) -> torch.Tensor:
        return state["center"]

    @property
    def steps(self) -> int:
        """Steps taken since :meth:`init` (the sync-schedule counter)."""
        return self._steps

    def set_steps(self, n: int) -> None:
        """Resynchronize the host-side sync-schedule counter."""
        self._steps = int(n)

    def run_epoch(self, state: State, x_ep: torch.Tensor, y_ep: torch.Tensor):
        """Train a staged epoch, ``(nsteps, n_dp, batch, ...)`` tensors on
        the device, as ``nsteps`` :meth:`step` calls.  Returns the state and
        the ``(nsteps, n_dp)`` per-step losses."""
        losses = []
        for s in range(x_ep.shape[0]):
            state, loss = self.step(state, x_ep[s], y_ep[s])
            losses.append(loss)
        return state, torch.stack(losses)

    def precompile(self, state: State, xb: torch.Tensor, yb: torch.Tensor) -> None:
        """Warm both step kinds (sync and local) on copies of ``state``:
        the kernels' first launches, cuDNN's algorithm choice and the
        allocator's pools happen here, not in the timed region.  Neither the
        caller's tensors nor the sync schedule (``_steps``) are touched."""
        for run in (self._sync, self._local):
            run({k: v.clone() for k, v in state.items()}, xb, yb)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
