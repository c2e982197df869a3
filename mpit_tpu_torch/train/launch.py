"""Launcher — the port of :mod:`mpit_tpu.train.launch` (the claunch/mlaunch
analogs).

Role assignment follows the reference's conventions: with
``master_freq=2``, even ranks become parameter servers and odd ranks become
workers (reference mlaunch.lua:25-31).

Two entry modes of the reference's three:

- ``--np 1``: single-process local training, no comm (claunch.lua analog);
- library use: :func:`run_rank` with injected transports, so a whole gang
  runs as threads of one process over the in-process router
  (:class:`mpit_tpu_torch.comm.local.LocalRouter`), each role on the card
  unless ``device="cpu"``.

The third, ``--np N`` forking N role processes over the native shm
transport, comes with slice 2b of the port and raises here, as do the
tester role and the layers of later slices (readers, cells, shard control,
elastic membership, checkpoints, the LM, aggregation, the device data
plane).

Usage:
    python -m mpit_tpu_torch.train.launch --np 1 --opt msgd
    # an in-process gang of 2 servers + 2 workers, on the CPU:
    python -m mpit_tpu_torch.train.launch --gang 4 --opt downpour \\
        --device cpu --side 8 --epochs 1
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from mpit_tpu_torch.comm.local import LocalRouter
from mpit_tpu_torch.optim import rules as rules_mod
from mpit_tpu_torch.ps import ParamClient, ParamServer
from mpit_tpu_torch.train.trainer import SERVER_RULE_OPTS, TRAINER_DEFAULTS, MnistTrainer
from mpit_tpu_torch.utils.config import Config
from mpit_tpu_torch.utils.logging import get_logger

LAUNCH_DEFAULTS = TRAINER_DEFAULTS.merged(
    np=1,
    gang=0,  # > 1: run that many ranks as threads over the in-process router
    # Wire codec for every client<->server shard transfer (comm/codec.py:
    # none | bf16 | int8).  "" defers to $MPIT_PS_CODEC (default none).
    # When set explicitly the servers are PINNED to it.
    codec="",
    # The reference's flags of later slices; each raises when set.
    tester="none",
    serve_readers=0,
    cells=0,
    shardctl=False,
    elastic=False,
    lm=0,
    agg="off",
    dplane=0,
    server_ckpt_dir="",
    resume=False,
)

# flag -> (value meaning "off", the slice of the port it belongs to)
LATER_FLAGS = {
    "tester": ("none", "the tester role (slice 2b)"),
    "serve_readers": (0, "the serving tier (slice 5, ps/serve)"),
    "cells": (0, "serving cells (slice 5, cells)"),
    "shardctl": (False, "shard control (slice 5, shardctl)"),
    "elastic": (False, "elastic membership (slice 5, ft)"),
    "lm": (0, "the LM workload through the PS gang (slice 7b, lm)"),
    "agg": ("off", "hierarchical aggregation (slice 5, agg)"),
    "dplane": (0, "the device data plane (slice 6, dplane)"),
    "server_ckpt_dir": ("", "server checkpoints (slice 5, ft)"),
    "resume": (False, "server resume (slice 5, ft)"),
}


def refuse_later_flags(cfg: Config) -> None:
    for flag, (off, owner) in LATER_FLAGS.items():
        if cfg.get(flag, off) != off:
            raise NotImplementedError(
                f"--{flag} {cfg.get(flag)!r} belongs to {owner} of the port")


def assign_roles(size: int, master_freq: int = 2) -> Tuple[List[int], List[int]]:
    """Returns (server_ranks, client_ranks): every ``master_freq``-th rank
    serves.  (The reference's tester split comes with the tester role.)"""
    ranks = list(range(size))
    sranks = [r for r in ranks if r % master_freq == 0]
    cranks = [r for r in ranks if r % master_freq != 0]
    if not sranks or not cranks:
        raise ValueError(
            f"role split produced {len(sranks)} servers / {len(cranks)} "
            f"clients from size={size}, master_freq={master_freq}"
        )
    return sranks, cranks


def server_rule_for(cfg: Config) -> rules_mod.ShardRule:
    """The server-side shard rule matching the client optimizer
    (reference BiCNN/pserver.lua:123-197 dispatch)."""
    if cfg.opt in SERVER_RULE_OPTS:
        return rules_mod.make(cfg.opt, lr=cfg.lr)
    return rules_mod.make("add")  # downpour/easgd/eamsgd ship pre-scaled deltas


def run_rank(rank: int, size: int, cfg: Config, transport: Any,
             data: Any = None) -> Dict[str, Any]:
    """Run one rank's role to completion; returns its result dict.  With
    ``size > 1`` the roles reach each other through ``transport``, this
    rank's endpoint of one router (a thread each); a server's result holds
    its final shard (``param``) and a worker's its final ``w``, as tensors
    on the role's device."""
    cfg = LAUNCH_DEFAULTS.merged(cfg.to_dict())
    refuse_later_flags(cfg)
    if size == 1:
        trainer = MnistTrainer(cfg, data=data, rank=rank)
        return {"role": "local", **trainer.run()}
    if transport is None:
        raise NotImplementedError(
            f"--np {size}: process gangs over the shm transport are slice 2b "
            "of the port; run a gang in one process with run_rank and a "
            "LocalRouter endpoint per rank (--gang N)")
    log = get_logger("launch", rank)
    sranks, cranks = assign_roles(size)
    codec = str(cfg.codec or "") or None
    if rank in sranks:
        server = ParamServer(
            rank, cranks, transport, rule=server_rule_for(cfg),
            single_mode=str(cfg.opt).endswith("-single"),
            device=cfg.device, codec=codec)
        log.info("server for clients %s", cranks)
        server.start()
        return {
            "role": "server",
            "grads_applied": server.grads_applied,
            "params_served": server.params_served,
            "snapshot_copies": server.snapshot_copies,
            "snapshot_hits": server.snapshot_hits,
            "param": server.param,
        }
    pclient = ParamClient(rank, sranks, transport,
                          seed_servers=(rank == cranks[0]), codec=codec)
    trainer = MnistTrainer(cfg, pclient=pclient, data=data, rank=rank)
    log.info("worker with servers %s", sranks)
    return {"role": "worker", **trainer.run(), "w": trainer.w}


def run_gang(size: int, cfg: Config, data: Any = None,
             timeout: float = 3600.0) -> Dict[int, Dict[str, Any]]:
    """Every rank of a ``size``-rank gang as a thread of this process over
    one :class:`LocalRouter`; returns each rank's result.  A rank that
    raises fails the gang: the lowest failed rank's error is raised here
    at once, and the ranks it leaves waiting stay behind as daemon
    threads."""
    refuse_later_flags(LAUNCH_DEFAULTS.merged(cfg.to_dict()))
    router = LocalRouter(size)
    results: Dict[int, Dict[str, Any]] = {}
    errors: Dict[int, BaseException] = {}

    def target(rank: int) -> None:
        try:
            results[rank] = run_rank(rank, size, cfg, router.endpoint(rank),
                                     data=data)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            errors[rank] = exc

    threads = [threading.Thread(target=target, args=(r,), daemon=True,
                                name=f"rank{r}") for r in range(size)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        # A crashed rank starves its peers: stop waiting at the first error.
        while t.is_alive() and not errors and time.monotonic() < deadline:
            t.join(0.1)
    if errors:
        raise errors[min(errors)]
    hung = [t.name for t in threads if t.is_alive()]
    if hung:
        raise TimeoutError(f"gang ranks {hung} did not end in {timeout}s")
    return results


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    cfg = LAUNCH_DEFAULTS.parse_args(list(sys.argv[1:] if argv is None else argv))
    t0 = time.monotonic()
    if int(cfg.gang) > 1:
        results = run_gang(int(cfg.gang), cfg)
        print(json.dumps({f"rank{r}": _summarize(res)
                          for r, res in sorted(results.items())}, indent=2))
        print(f"total wall time: {time.monotonic() - t0:.1f}s")
        return results
    result = run_rank(0, int(cfg.np), cfg, None)
    print(json.dumps({"rank0": _summarize(result)}, indent=2))
    print(f"total wall time: {time.monotonic() - t0:.1f}s")
    return result


def _summarize(result: Dict[str, Any]) -> Dict[str, Any]:
    keep = {"role", "final_test_err", "time_to_target", "elapsed",
            "grads_applied", "params_served"}
    return {k: v for k, v in result.items() if k in keep}


if __name__ == "__main__":
    main()
