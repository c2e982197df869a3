"""Synchronous data-parallel trainer — the allreduce path, trained in.

The port of ``SyncDataParallel`` of ``mpit_tpu/parallel/sync_dp.py`` on the
one-device stand-in mesh (:mod:`mpit_tpu_torch.parallel.mesh`).  The
reference shards the global batch over ``dp`` devices and lets XLA
all-reduce the per-device gradients; on one card the ``dp`` rows share the
device, and the all-reduced mean of equal row shards is the whole batch's
mean, so a step takes one gradient of the global batch.  The parameters,
the velocity and the step counter ``k`` are one ``(plong,)`` vector each
and a 0-d int32 tensor on the card.  The reference cuts the parameters and
the velocity over ``shard`` (its optimizer state distributed); here the
gradient reaches each shard owner by ``ps_push``, the commit runs on the
``(shard, plong / shard)`` stack (the last shard padded where ``shard``
does not divide ``plong``) and the parameters come back by ``ps_pull``.

Over a mesh whose ``dp`` spans a group of processes, each process takes
the gradient of its rows of the global batch (its block of the ``dp``
rows, :func:`~mpit_tpu_torch.parallel.mesh.process_local_rows`), and the
processes' gradients and losses are gathered and averaged in process
order (:func:`~mpit_tpu_torch.parallel.collective.process_mean`) into the
global batch's: every process then commits the same bits to its replica
of the state.  The mean of the processes' means is the global batch's
mean up to float32 rounding, not bit for bit the one-process gradient of
the whole batch.

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

from mpit_tpu_torch.optim.msgd import MSGDConfig, msgd_commit, msgd_lookahead
from mpit_tpu_torch.parallel.collective import pad_shards, process_mean, ps_pull, ps_push
from mpit_tpu_torch.parallel.mesh import Mesh, put_local

State = Dict[str, torch.Tensor]


class SyncDataParallel:
    """Nesterov-SGD on the global batch over the one-device mesh.

    ``value_and_grad_fn(w, xb, yb) -> (loss, grad)`` sees the whole
    ``(batch, ...)`` global batch (this process's rows of it, where ``dp``
    spans processes) and returns its mean loss.  The batch must split
    evenly over ``dp`` rows, as the reference's sharding needs.
    """

    #: The state's keys stacked over ``dp``: none, the state is replicated.
    row_keys = ()

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
        self.n_shard = mesh.shape["shard"]
        self.device = mesh.device
        self._vgf = value_and_grad_fn
        self._steps = 0
        self._push = ps_push(mesh, "shard")
        self._pull = ps_pull(mesh, "shard")
        self._mean = process_mean(mesh)

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
        """Place ``(batch, ...)`` host arrays (this process's rows of the
        global batch) on the mesh's device."""
        for a in arrays:
            self.check_batch(a.shape[0] * self.mesh.processes)
        return tuple(put_local(a, self.mesh) for a in arrays)

    def _step(self, state: State, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        """The lookahead, the gradient of the global batch at the displaced
        point, and the commit on the shard stack: the gradient pushed to its
        owners, one commit (K1 with momentum) over every shard, the shards
        pulled back.  Views of ``state`` where ``shard`` divides ``plong``;
        padded copies, trimmed on the way back, where not."""
        w = state["w"]
        msgd_lookahead(w, state, self.cfg)
        loss, grad = self._vgf(w, xb, yb)
        if self.mesh.processes > 1:  # the global batch's, from every process's rows
            both = self._mean(torch.cat([grad, loss.reshape(1)]))
            grad, loss = both[:-1], both[-1]
        grad, pad = pad_shards(grad, self.n_shard)
        w_sh, _ = pad_shards(w, self.n_shard)
        vt_sh, _ = pad_shards(state["vt"], self.n_shard)
        g_sh = self._push(grad)  # (shard, plong / shard): each owner's slice
        msgd_commit(w_sh, g_sh.reshape(-1), {"k": state["k"], "vt": vt_sh}, self.cfg)
        full = self._pull(w_sh.view(self.n_shard, -1))  # a view of w where nothing was padded
        if pad:
            w.copy_(full[:w.shape[0]])
            state["vt"].copy_(vt_sh[:w.shape[0]])
        return loss

    def step(self, state: State, xb: torch.Tensor, yb: torch.Tensor):
        """One step on the global batch, in place on ``state``; returns the
        state and the loss on the device."""
        loss = self._step(state, xb, yb)
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
        self._step({k: v.clone() for k, v in state.items()}, xb, yb)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return 1
