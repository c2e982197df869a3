"""Synchronous data-parallel trainer — the allreduce path, trained in.

The port of ``SyncDataParallel`` of ``mpit_tpu/parallel/sync_dp.py`` on the
one-device stand-in mesh (:mod:`mpit_tpu_torch.parallel.mesh`,
``shard == 1``).  The reference shards the global batch over ``dp``
devices and lets XLA all-reduce the per-device gradients; on one card the
``dp`` rows share the device, and the all-reduced mean of equal row
shards is the whole batch's mean, so a step takes one gradient of the
global batch.  The parameters, the velocity and the step counter ``k``
are one ``(plong,)`` vector each and a 0-d int32 tensor on the card.

A step is the reference's Nesterov msgd (:mod:`mpit_tpu_torch.optim.msgd`):
the lookahead, the gradient at the displaced point, and the commit, all in
place.  With momentum the commit is one launch of K1 on the 1-D vector with
a scalar decayed lr (the reference's "replicated scalar" case of
``parallel/fused.py``); at ``mom == 0`` the plain commit runs, as the
reference's ``use_fused = cfg.mom > 0`` says.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from mpit_tpu_torch.optim.msgd import MSGDConfig, msgd_step
from mpit_tpu_torch.parallel.mesh import Mesh

State = Dict[str, torch.Tensor]


class SyncDataParallel:
    """Nesterov-SGD on the global batch over the one-device mesh.

    ``value_and_grad_fn(w, xb, yb) -> (loss, grad)`` sees the whole
    ``(batch, ...)`` global batch and returns its mean loss.  The batch
    must split evenly over ``dp`` rows, as the reference's sharding needs.
    """

    #: One step kind: the schedule has one phase (the device loop captures
    #: one graph an epoch).
    su = 1

    def __init__(
        self,
        mesh: Mesh,
        value_and_grad_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]],
        cfg: MSGDConfig,
    ):
        self.mesh = mesh
        self.cfg = cfg
        self.n_dp = mesh.shape["dp"]
        self.device = mesh.device
        self._vgf = value_and_grad_fn
        self._steps = 0

    def init(self, w0: torch.Tensor) -> State:
        """``w`` a copy of ``w0``, zero velocity, ``k`` 0."""
        w = w0.to(self.device, torch.float32).clone()
        self._steps = 0
        return {
            "w": w,
            "vt": torch.zeros_like(w),
            "k": torch.zeros((), dtype=torch.int32, device=self.device),
        }

    def check_batch(self, rows: int) -> None:
        """Raise unless a global batch of ``rows`` splits over ``dp``."""
        if rows % self.n_dp:
            raise ValueError(f"a batch of {rows} rows does not split over dp={self.n_dp}")

    def shard_batch(self, *arrays: Any) -> Tuple[torch.Tensor, ...]:
        """Place ``(batch, ...)`` host arrays on the mesh's device."""
        for a in arrays:
            self.check_batch(a.shape[0])
        return tuple(torch.as_tensor(a).to(self.device) for a in arrays)

    def step(self, state: State, xb: torch.Tensor, yb: torch.Tensor):
        """One step on the global batch, in place on ``state``; returns the
        state and the loss on the device."""
        _, _, loss = msgd_step(self._vgf, state["w"], state, self.cfg, xb, yb)
        self._steps += 1
        return state, loss

    def eval_params(self, state: State) -> torch.Tensor:
        return state["w"]

    @property
    def steps(self) -> int:
        """Steps taken since :meth:`init` (host-side, for reporting)."""
        return self._steps

    def set_steps(self, n: int) -> None:
        """Set the host step count.  The decayed lr reads the device
        counter ``k``, so this moves no schedule."""
        self._steps = int(n)

    def run_epoch(self, state: State, x_ep: torch.Tensor, y_ep: torch.Tensor):
        """Train a staged epoch, ``(nsteps, batch, ...)`` tensors on the
        device, as ``nsteps`` :meth:`step` calls.  Returns the state and the
        ``(nsteps,)`` per-step losses."""
        losses = []
        for s in range(x_ep.shape[0]):
            state, loss = self.step(state, x_ep[s], y_ep[s])
            losses.append(loss)
        return state, torch.stack(losses)

    def precompile(self, state: State, xb: torch.Tensor, yb: torch.Tensor) -> int:
        """Warm the step on copies of ``state`` (K1's first launch, cuDNN's
        algorithm choice, the allocator's pools); returns the steps run."""
        msgd_step(self._vgf, state["w"].clone(),
                  {k: v.clone() for k, v in state.items()}, self.cfg, xb, yb)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return 1
