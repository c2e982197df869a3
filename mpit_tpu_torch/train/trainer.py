"""MNIST trainer — the port of :class:`mpit_tpu.train.trainer.MnistTrainer`
(the goot.lua analog) for single-process runs.

Model + flat parameters, the data on the device, msgd dispatch, the epoch
x minibatch loop over sequential unshuffled batches (goot.lua:129-146),
test error every epoch and per-phase timers.  This slice carries the
``sgd``/``msgd`` optimizers (one ``MSGD`` step each, whose commit is kernel
K1 with momentum); the parameter-server optimizers come with the
parameter-server slice and raise here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from mpit_tpu_torch.data.mnist import load_mnist
from mpit_tpu_torch.models.flat import error_rate, flatten_module, value_and_grad_nll
from mpit_tpu_torch.models.mnist import make_model
from mpit_tpu_torch.obs.timers import PhaseTimers, profiler_trace
from mpit_tpu_torch.optim.msgd import MSGD, MSGDConfig
from mpit_tpu_torch.utils.config import Config
from mpit_tpu_torch.utils.logging import get_logger
from mpit_tpu_torch.utils.platform import resolve_device

TRAINER_DEFAULTS = Config(
    model="linear",  # linear | mlp | cnn
    opt="msgd",  # msgd | sgd (the parameter-server optimizers: a later slice)
    lr=1e-2,
    lrd=0.0,
    lrp=0.0,
    mom=0.99,
    mommax=1.0,
    momdecay=0.0,
    l2wd=0.0,
    epochs=10,
    batch=128,
    seed=1,
    side=32,
    shuffle=False,  # reference uses sequential batches (goot.lua:133)
    target_test_err=0.01,
    profile_dir="",  # torch.profiler trace of the epoch loop when set
    device="cuda",  # cuda | cpu
)

# The reference's optimizer names beyond sgd/msgd, all served by the
# parameter-server slice of the port.
PS_OPTS = (
    "downpour", "eamsgd", "easgd",
    "rmsprop", "adam", "adamax", "adagrad", "adadelta", "rmsprop-local",
    "msgd-single", "rmsprop-single", "adam-single", "adamax-single",
    "adagrad-single", "adadelta-single",
)


class MnistTrainer:
    def __init__(self, cfg: Optional[Config] = None, data: Any = None,
                 rank: int = 0):
        self.cfg = TRAINER_DEFAULTS.merged(cfg.to_dict() if cfg else None)
        self.rank = rank
        self.log = get_logger("train", rank)
        self.tm = PhaseTimers()
        self.device = resolve_device(self.cfg.device)

        if data is None:
            data, source = load_mnist(side=self.cfg.side)
            self.log.info("data source: %s", source)
        x_train, y_train, x_test, y_test = data
        as_x = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)
        as_y = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=self.device)
        self.x_train, self.y_train = as_x(x_train), as_y(y_train)
        self.x_test, self.y_test = as_x(x_test), as_y(y_test)

        module = make_model(self.cfg.model, self.cfg.side)
        self.flat = flatten_module(module, self.cfg.seed + rank, self.device)
        self.w = self.flat.w0.clone()
        self._vgf = value_and_grad_nll(self.flat)
        self._optimizer = None

    @property
    def optimizer(self) -> MSGD:
        if self._optimizer is None:
            self._optimizer = self._make_optimizer()
        return self._optimizer

    def _make_optimizer(self) -> MSGD:
        cfg = self.cfg
        if cfg.opt in ("sgd", "msgd"):
            mcfg = MSGDConfig(
                lr=cfg.lr, lrd=cfg.lrd, lrp=cfg.lrp, mom=cfg.mom,
                mommax=cfg.mommax, momdecay=cfg.momdecay, l2wd=cfg.l2wd,
            )
            return MSGD(mcfg, self._vgf)
        if cfg.opt in PS_OPTS:
            raise NotImplementedError(
                f"optimizer {cfg.opt!r} needs a parameter server: the "
                "parameter-server slice of the port (single-process runs "
                "use msgd, reference claunch.lua:6-12)"
            )
        raise ValueError(f"unknown optimizer {cfg.opt!r}")

    # -- evaluation ----------------------------------------------------------

    def test_error(self, w: Optional[torch.Tensor] = None) -> float:
        return float(error_rate(self.flat, self.w if w is None else w,
                                self.x_test, self.y_test))

    # -- the epoch loop (reference goot.lua:129-146) -------------------------

    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        n = self.x_train.shape[0]
        steps_per_epoch = max(n // cfg.batch, 1)
        opt = self.optimizer
        history = []
        rng = np.random.default_rng(cfg.seed + self.rank)
        with profiler_trace(cfg.profile_dir):
            for epoch in range(cfg.epochs):
                if cfg.shuffle:
                    order = torch.from_numpy(rng.permutation(n)).to(self.device)
                losses = []
                for step in range(steps_per_epoch):
                    lo = step * cfg.batch
                    idx = order[lo:lo + cfg.batch] if cfg.shuffle else slice(lo, lo + cfg.batch)
                    xb, yb = self.x_train[idx], self.y_train[idx]
                    with self.tm.phase("feval"):
                        self.w, loss = opt.step(self.w, xb, yb)
                    losses.append(loss)
                avg_loss = float(torch.stack(losses).mean())
                with self.tm.phase("eval"):
                    test_err = self.test_error()
                history.append({"epoch": epoch, "avg_loss": avg_loss,
                                "test_err": test_err, "at": self.tm.elapsed()})
                self.log.info("epoch %d avg_loss %.5f test_err %.4f",
                              epoch, avg_loss, test_err)
        # first epoch that reached the target, by cumulative wall clock
        time_to_target = next((h["at"] for h in history
                               if h["test_err"] <= cfg.target_test_err), None)
        return {
            "history": history,
            "final_test_err": history[-1]["test_err"] if history else None,
            "time_to_target": time_to_target,
            "elapsed": self.tm.elapsed(),
            "timers": dict(self.tm.total),
            "steps": steps_per_epoch * len(history),
        }
