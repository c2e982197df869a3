"""MNIST trainer — the port of ``MnistTrainer`` of ``mpit_tpu/train/trainer.py``
(the goot.lua analog).

Model + flat parameters, the data on the device, the optimizer dispatch
over the reference family's 17 names (goot.lua:66-89 plus the BiCNN
shells, bicnn.lua:127-252), the epoch x minibatch loop over sequential
unshuffled batches (goot.lua:129-146), test error every epoch and
per-phase timers.  ``sgd``/``msgd`` train alone (one ``MSGD`` step each,
whose commit is kernel K1 with momentum); every other optimizer drives a
parameter client (``pclient``, :mod:`mpit_tpu_torch.ps`) and raises
``ValueError`` without one.  Comm-aware optimizers are started before the
loop and stopped after it; their blocking-sync seconds are reported as the
``sync`` phase, net of ``feval``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from mpit_tpu_torch.data.mnist import load_mnist
from mpit_tpu_torch.models.flat import error_rate, flatten_module, value_and_grad_nll_eager
from mpit_tpu_torch.models.mnist import make_model
from mpit_tpu_torch.obs.timers import PhaseTimers, profiler_trace
from mpit_tpu_torch.optim import EAMSGD, MSGD, Downpour, MSGDConfig, RuleShell, SingleWorker
from mpit_tpu_torch.utils.config import Config
from mpit_tpu_torch.utils.logging import get_logger
from mpit_tpu_torch.utils.platform import resolve_device

TRAINER_DEFAULTS = Config(
    model="linear",  # linear | mlp | cnn
    opt="msgd",  # msgd|sgd|downpour|eamsgd|easgd|rmsprop|adam|adamax|adagrad|
    #              adadelta|rmsprop-local|<rule>-single
    lr=1e-2,
    lrd=0.0,
    lrp=0.0,
    mom=0.99,
    mommax=1.0,
    momdecay=0.0,
    l2wd=0.0,
    mva=0.0,  # easgd moving rate; mlaunch uses beta/p = 0.9/nclients
    su=1,  # communication period
    epochs=10,
    batch=128,
    seed=1,
    side=32,
    shuffle=False,  # reference uses sequential batches (goot.lua:133)
    target_test_err=0.01,
    profile_dir="",  # torch.profiler trace of the epoch loop when set
    device="cuda",  # cuda | cpu
)

# The optimizer names of the reference family (goot.lua:66-89, bicnn.lua:
# 127-252): sgd/msgd train alone, the rest through a parameter client.
KNOWN_OPTS = (
    "sgd", "msgd", "downpour", "eamsgd", "easgd",
    "rmsprop", "adam", "adamax", "adagrad", "adadelta", "rmsprop-local",
    "msgd-single", "rmsprop-single", "adam-single", "adamax-single",
    "adagrad-single", "adadelta-single",
)
# The rules a server applies to raw gradients shipped by a RuleShell.
SERVER_RULE_OPTS = ("rmsprop", "adam", "adamax", "adagrad", "adadelta")


class MnistTrainer:
    def __init__(self, cfg: Optional[Config] = None, pclient: Any = None,
                 data: Any = None, rank: int = 0):
        self.cfg = TRAINER_DEFAULTS.merged(cfg.to_dict() if cfg else None)
        self.pc = pclient
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
        self._vgf = value_and_grad_nll_eager(self.flat)
        self._optimizer = None

    @property
    def optimizer(self):
        if self._optimizer is None:
            self._optimizer = self._make_optimizer()
        return self._optimizer

    # -- optimizer dispatch (reference goot.lua:66-89, bicnn.lua:127-252) ----

    def _make_optimizer(self):
        cfg = self.cfg
        name = cfg.opt
        if name not in KNOWN_OPTS:
            raise ValueError(f"unknown optimizer {name!r}; have {KNOWN_OPTS}")
        if name in ("sgd", "msgd"):
            mcfg = MSGDConfig(
                lr=cfg.lr, lrd=cfg.lrd, lrp=cfg.lrp, mom=cfg.mom,
                mommax=cfg.mommax, momdecay=cfg.momdecay, l2wd=cfg.l2wd,
            )
            return MSGD(mcfg, self._vgf)
        if self.pc is None:
            raise ValueError(
                f"optimizer {name!r} needs a parameter client "
                "(single-process runs use msgd — reference claunch.lua:6-12)"
            )
        if name == "downpour":
            return Downpour(self._vgf, self.pc, lr=cfg.lr, lrd=cfg.lrd,
                            l2wd=cfg.l2wd, su=cfg.su)
        if name in ("eamsgd", "easgd"):
            mom = 0.0 if name == "easgd" else cfg.mom
            return EAMSGD(self._vgf, self.pc, lr=cfg.lr, lrd=cfg.lrd,
                          lrp=cfg.lrp, mom=mom, l2wd=cfg.l2wd,
                          mva=cfg.mva, su=cfg.su)
        if name == "rmsprop-local":
            return RuleShell(self._vgf, self.pc, su=cfg.su, mode="local",
                             lr=cfg.lr)
        if name.endswith("-single"):
            rule = name[: -len("-single")]
            hp = {"lr": cfg.lr} if rule != "msgd" else {"lr": cfg.lr, "mom": cfg.mom}
            return SingleWorker(self._vgf, self.pc, rule=rule, **hp)
        # Server-stateful (SERVER_RULE_OPTS): the launcher configures the
        # matching server rule (reference plaunch wires pserver the same way).
        return RuleShell(self._vgf, self.pc, su=cfg.su, mode="global")

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
        if hasattr(opt, "start"):  # comm-aware optimizers; MSGD has none
            with self.tm.phase("start"):
                self.w = opt.start(self.w)
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
        # The blocking-sync seconds accrued inside opt.step were measured
        # under the 'feval' phase too; report feval net of sync so the
        # comm/compute split is honest.
        sync_time = getattr(opt, "dusync", 0.0)
        self.tm.add("sync", sync_time)
        self.tm.total["feval"] = max(self.tm.total["feval"] - sync_time, 0.0)
        if hasattr(opt, "stop"):
            with self.tm.phase("stop"):
                opt.stop()
        return {
            "history": history,
            "final_test_err": history[-1]["test_err"] if history else None,
            "time_to_target": time_to_target,
            "elapsed": self.tm.elapsed(),
            "timers": dict(self.tm.total),
            "steps": steps_per_epoch * len(history),
        }
