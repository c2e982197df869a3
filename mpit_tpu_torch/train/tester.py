"""Dedicated tester role — pull params, evaluate, checkpoint the best.

The port of the JAX package's ``mpit_tpu/train/tester.py``.  The
reference's BiCNN tester rank loops forever: pull current params from the
servers, evaluate, save a checkpoint, sleep (reference bicnn.lua:580-596).
Here, as in the JAX package, the tester has a bounded lifecycle:
``tester_rounds`` pulls ``tester_interval`` seconds apart, then a clean
stop — the servers count the tester among their clients, so the stop
protocol stays exact.  Each pulled vector is evaluated on the tester's
device with the trainer's ``test_error``; the best is saved with
:func:`mpit_tpu_torch.utils.checkpoint.save_flat` when ``ckpt_dir`` is set.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from mpit_tpu_torch.ps import ParamClient
from mpit_tpu_torch.train.trainer import MnistTrainer
from mpit_tpu_torch.utils.checkpoint import save_flat
from mpit_tpu_torch.utils.config import Config
from mpit_tpu_torch.utils.logging import get_logger


def run_tester(
    rank: int,
    server_ranks: List[int],
    cfg: Config,
    transport: Any,
    data: Any = None,
) -> Dict[str, Any]:
    log = get_logger("tester", rank)
    trainer = MnistTrainer(cfg, pclient=None, data=data, rank=rank)
    param = np.zeros(trainer.flat.w0.numel(), np.float32)
    grad = np.zeros_like(param)
    pclient = ParamClient(rank, server_ranks, transport, seed_servers=False,
                          codec=str(cfg.get("codec", "") or "") or None)
    pclient.start(param, grad)

    rounds = int(cfg.get("tester_rounds", 10))
    interval = float(cfg.get("tester_interval", 1.0))
    ckpt_dir = cfg.get("ckpt_dir")
    best_err = float("inf")
    history = []
    for round_idx in range(rounds):
        pclient.async_recv_param()
        pclient.wait()
        test_err = trainer.test_error(torch.from_numpy(param).to(trainer.device))
        history.append({"round": round_idx, "test_err": test_err})
        if test_err < best_err:
            best_err = test_err
            if ckpt_dir:
                save_flat(ckpt_dir, param, {"test_err": test_err, "round": round_idx})
        log.info("round %d test_err %.4f (best %.4f)", round_idx, test_err, best_err)
        if round_idx != rounds - 1:
            time.sleep(interval)
    pclient.stop()
    return {"history": history, "best_test_err": best_err}
