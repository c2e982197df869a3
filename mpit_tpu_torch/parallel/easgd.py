"""Synchronous EASGD/EAMSGD with the workers as rows on each process's device.

The port of ``MeshEASGD`` of ``mpit_tpu/parallel/easgd.py``.  Every worker's
parameters are one row of a ``(n_dp, plong)`` tensor, the center w* is a
``(plong,)`` tensor, and both live on the mesh's device.  Over a mesh whose
``dp`` spans a group of processes, each process holds its block of the
rows of ``w``, ``vt`` and ``k`` and the whole center, replicated; the
exchange all-gathers the workers' pushes (:mod:`~mpit_tpu_torch.parallel.
collective`) and sums them as a one-process run at the same ``dp`` does,
so every process moves its replica of the center by the same bits.  The mesh's
``shard`` axis cuts both by columns, as the JAX package cuts them over its
devices (the last shard padded where ``shard`` does not divide ``plong``):
the center's exchange is the shard owners' (:meth:`MeshEASGD._exchange`),
and where ``shard`` spans processes each process adds to the center's
shards it owns and pulls the others' (every process of a ``shard`` line
holds the same worker rows and takes the gradients of its line's first
process, so that its rows stay the same bits on the card too),
and K1 commits the whole ``(n_dp, plong)`` stack, every ``(dp, shard)``
tile, in one launch, where the JAX package launches one a device tile.
A step is:

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
from mpit_tpu_torch.parallel.collective import pad_shards, ps_pull, ps_push, replicate
from mpit_tpu_torch.parallel.mesh import Mesh, put_local

State = Dict[str, torch.Tensor]


class MeshEASGD:
    """Synchronous elastic-averaging trainer over the one-device mesh.

    ``value_and_grad_fn(w, xb, yb) -> (loss, grad)`` acts on one worker's
    flat parameter vector and must be ``torch.func``-transformable.
    Batches are stacked per worker: ``(n_dp, batch, ...)``, this
    process's rows of them where ``dp`` spans processes.
    """

    #: The state's keys stacked over ``dp`` (this process's rows of them).
    row_keys = ("w", "vt", "k")

    #: The state's keys cut over ``shard`` across processes: none (the
    #: center is pulled whole after every exchange).
    shard_keys = ()

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
        self.n_dp = mesh.local_size("dp")
        self.n_shard = mesh.shape["shard"]
        self.device = mesh.device
        self._steps = 0
        self._grads = torch.func.vmap(value_and_grad_fn)
        self._push = ps_push(mesh, "shard", reduce_axis="dp")
        self._pull = ps_pull(mesh, "shard")
        self._one_copy = replicate(mesh, "shard")

    # -- state ---------------------------------------------------------------

    def init(self, w0: torch.Tensor) -> State:
        """Every worker row (this process's) and the center start as copies
        of ``w0``."""
        w0 = w0.to(self.device, torch.float32)
        self._steps = 0
        return {
            "w": w0.expand(self.n_dp, -1).clone(),
            "vt": torch.zeros(self.n_dp, w0.shape[0], device=self.device),
            "k": torch.zeros(self.n_dp, dtype=torch.int32, device=self.device),
            "center": w0.clone(),
        }

    def shard_batch(self, *arrays: Any) -> Tuple[torch.Tensor, ...]:
        """Place ``(n_dp, batch, ...)`` host arrays (this process's worker
        rows) on the mesh's device."""
        return tuple(put_local(a, self.mesh) for a in arrays)

    # -- stepping ------------------------------------------------------------

    def _value_and_grads(self, w, xb, yb):
        """Every row's loss and gradient; where ``shard`` spans processes,
        those of the ``shard`` line's first process, which every owner of
        the line takes (each computes the same rows)."""
        loss, grad = self._grads(w, xb, yb)
        if not self.mesh.spans("shard"):
            return loss, grad
        both = self._one_copy(torch.cat([grad, loss[:, None]], 1))
        return both[:, -1], both[:, :-1]

    def _local(self, state: State, xb, yb) -> torch.Tensor:
        msgd_lookahead(state["w"], state, self.cfg)
        loss, grad = self._value_and_grads(state["w"], xb, yb)
        msgd_commit(state["w"], grad, state, self.cfg)
        return loss

    def _exchange(self, center: torch.Tensor, sug: torch.Tensor) -> None:
        """``w* += sum_i sug_i``, in place, by the shard owners: the workers'
        pushes (every process's, gathered over the ``dp`` line) summed over
        ``dp`` and cut over ``shard`` (``ps_push``: the owner rows this
        process holds), each owner's add on its slice of the center, and
        the pull of the updated shards (``ps_pull``: all-gathered over the
        ``shard`` line where ``shard`` spans processes).  Views of
        ``center`` where ``shard`` divides ``plong`` and lies in this
        process; padded or gathered copies, trimmed on the way back, where
        not."""
        sug, pad = pad_shards(sug, self.n_shard)
        shards, _ = pad_shards(center, self.n_shard)
        mine = shards.view(self.n_shard, -1)[self.mesh.local_slice("shard")]
        mine.add_(self._push(sug))
        full = self._pull(mine)  # a view of center where nothing was padded or gathered
        if pad or self.mesh.spans("shard"):
            center.copy_(full[:center.shape[0]])

    def _sync(self, state: State, xb, yb) -> torch.Tensor:
        # Every worker's push from its pre-update w (optim-eamsgd.lua:54-61),
        # the center moved before the local update.
        sug = self.mva * (state["w"] - state["center"])
        self._exchange(state["center"], sug)
        msgd_lookahead(state["w"], state, self.cfg)
        loss, grad = self._value_and_grads(state["w"], xb, yb)
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

    eval_params = center_params  # what mesh_launch evaluates

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

    def precompile(self, state: State, xb: torch.Tensor, yb: torch.Tensor) -> int:
        """Warm both step kinds (sync and local) on copies of ``state``:
        the kernels' first launches, cuDNN's algorithm choice and the
        allocator's pools happen here, not in the timed region.  Neither the
        caller's tensors nor the sync schedule (``_steps``) are touched.
        Returns the steps run (two)."""
        for run in (self._sync, self._local):
            run({k: v.clone() for k, v in state.items()}, xb, yb)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return 2
