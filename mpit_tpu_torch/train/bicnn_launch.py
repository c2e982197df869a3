"""BiCNN launcher — the port of ``mpit_tpu/train/bicnn_launch.py`` (the
plaunch.lua analog).

The reference's start-point semantics (BiCNN/plaunch.lua): the ~50-flag
config (:7-69, :data:`BICNN_LAUNCH_DEFAULTS`), ``maxrank`` parking of
excess ranks (:90-96), per-rank seeding (:113-115) and the role table
(:123-177):

- ``testerfirst``: rank 0 is the dedicated tester; among ranks 1..size-1
  every ``master_freq``-th is a server, the rest train;
- ``testerlast``: among ranks 0..size-2 every rank with
  ``(i+1) % master_freq == 0`` serves; rank size-1 is the tester;
- ``valid_mode='lastClient'`` makes the last training client also run
  test3 in training; ``'additionalTester'`` needs a tester.

Parked ranks return at once with role ``parked``.  ``--np 1`` trains in
this process (``sgd`` only); ``--np N`` starts N role processes, fresh
interpreters over the port's shm transport (:mod:`mpit_tpu_torch.train.gang`),
each on ``--device`` (the card unless ``cpu``).  Every child returns its
result as JSON with its ``platform`` and its own K1-K3 ``launches``
(:func:`mpit_tpu_torch.train.launch.child_result`).  With ``MPIT_OBS_HTTP``
set, every child serves its live introspection endpoint (``obs/statusd``:
``/metrics``, ``/status``, ``/trace``) on base port + rank.

Usage:
    python -m mpit_tpu_torch.train.bicnn_launch --np 4 --device cpu --docqa 1 \\
        --optimization downpour --valid_mode none --num_filters 100 --epoch 1
    python -m mpit_tpu_torch.train.bicnn_launch --np 6 --docqa 1 \\
        --optimization eamsgd --testerfirst true --valid_mode additionalTester
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from mpit_tpu_torch.ps import ParamClient, ParamServer
from mpit_tpu_torch.train.bicnn import (
    BICNN_DEFAULTS, BiCNNTrainer, explicit_qa_files, server_rule_for)
from mpit_tpu_torch.utils.config import Config
from mpit_tpu_torch.utils.logging import get_logger
from mpit_tpu_torch.utils.platform import resolve_device

BICNN_LAUNCH_DEFAULTS = BICNN_DEFAULTS.merged(
    np=1,
    ring_mb=64,
    namespace="",
    # The tester surface shared with train.launch: none|first|last; the
    # plaunch booleans (testerfirst/testerlast) are aliases, and setting
    # the two surfaces inconsistently is an error.
    tester="",
    gang_barrier=True,  # startup rendezvous before any role traffic
)

#: The environment variable that starts each child's live introspection
#: endpoint (its base port).
STATUSD_ENV = "MPIT_OBS_HTTP"


def resolve_tester_flags(cfg: Config) -> tuple[bool, bool]:
    """Unify the two tester dialects into (testerfirst, testerlast);
    ``tester`` wins when set, and a conflict raises."""
    t = str(cfg.get("tester", "") or "").strip().lower()
    tf, tl = bool(cfg.get("testerfirst", False)), bool(cfg.get("testerlast", False))
    if not t:
        return tf, tl
    if t not in ("none", "first", "last"):
        raise ValueError(f"tester must be none|first|last, got {t!r}")
    want = (t == "first", t == "last")
    if (tf or tl) and (tf, tl) != want:
        raise ValueError(
            f"conflicting tester config: tester={t!r} vs "
            f"testerfirst={tf} testerlast={tl}")
    return want


def assign_roles(
    size: int,
    master_freq: int = 2,
    testerfirst: bool = False,
    testerlast: bool = False,
    valid_mode: str = "additionalTester",
) -> Tuple[List[int], List[int], Optional[int], Set[int]]:
    """(server_ranks, client_ranks, tester_rank, tranks) per
    plaunch.lua:123-177.  ``client_ranks`` includes the tester, a pull-only
    client; ``tranks`` are the ranks that run test3."""
    if testerfirst and testerlast:
        raise ValueError("testerfirst and testerlast are mutually exclusive")
    sranks: List[int] = []
    cranks: List[int] = []
    tester_rank: Optional[int] = None
    if testerfirst:
        tester_rank = 0
        cranks.append(0)
        for i in range(1, size):
            (cranks if i % master_freq != 0 else sranks).append(i)
    elif testerlast:
        for i in range(size - 1):
            (cranks if (i + 1) % master_freq != 0 else sranks).append(i)
        tester_rank = size - 1
        cranks.append(tester_rank)
    else:
        # No dedicated tester: the asyncsgd split (mlaunch.lua:25-31).
        for i in range(size):
            (sranks if i % master_freq == 0 else cranks).append(i)
    training_clients = [c for c in cranks if c != tester_rank]
    if not sranks or not training_clients:
        raise ValueError(
            f"role split produced {len(sranks)} servers and no training "
            f"clients from size={size}, master_freq={master_freq}")
    tranks: Set[int] = set()
    if valid_mode == "lastClient":
        # The highest-ranked training client (plaunch.lua:166-167).
        tranks.add(training_clients[-1])
    elif valid_mode == "additionalTester":
        if tester_rank is None:
            raise ValueError(
                "valid_mode='additionalTester' requires testerfirst or testerlast")
        tranks.add(tester_rank)
    elif valid_mode != "none":
        raise ValueError(f"unknown valid_mode {valid_mode!r}")
    return sranks, cranks, tester_rank, tranks


def run_rank(
    rank: int,
    size: int,
    cfg: Config,
    transport: Any,
    data: Any = None,
) -> Dict[str, Any]:
    """One rank's role to completion; returns its result dict."""
    cfg = BICNN_LAUNCH_DEFAULTS.merged(cfg.to_dict())
    log = get_logger("plaunch", rank)
    # maxrank parking (plaunch.lua:90-96).
    effective = min(size, int(cfg.maxrank) + 1)
    if rank >= effective:
        log.info("rank %d > maxrank %d: parked", rank, cfg.maxrank)
        return {"role": "parked"}
    if effective == 1:
        # Single-process = the claunch analog: only the local optimizer.
        if cfg.optimization != "sgd":
            raise ValueError(
                f"single-process runs support optimization='sgd' only (got "
                f"{cfg.optimization!r}); distributed optimizers need --np > 1")
        trainer = BiCNNTrainer(cfg, None, data, rank)
        return {"role": "local", **trainer.run()}
    testerfirst, testerlast = resolve_tester_flags(cfg)
    sranks, cranks, tester_rank, tranks = assign_roles(
        effective, int(cfg.master_freq), testerfirst, testerlast, str(cfg.valid_mode))
    if rank in sranks:
        server = ParamServer(
            rank, cranks, transport,
            rule=server_rule_for(cfg),
            single_mode=bool(cfg.singlemode) or cfg.optimization.endswith("single"),
            device=cfg.device,
            dtype=cfg.get("dtype", "float32"),
        )
        log.info("server for clients %s", cranks)
        server.start()
        return {
            "role": "server",
            "grads_applied": server.grads_applied,
            "params_served": server.params_served,
        }
    # The first entry of cranks seeds the servers (pclient.lua:125-128):
    # with testerfirst, the tester itself (bicnn.lua:268-271).
    pclient = ParamClient(rank, sranks, transport, seed_servers=(rank == cranks[0]))
    trainer = BiCNNTrainer(cfg, pclient=pclient, data=data, rank=rank)
    if rank == tester_rank:
        log.info("tester with servers %s", sranks)
        return {"role": "tester", **trainer.run_tester()}
    log.info("worker with servers %s", sranks)
    return {"role": "worker", **trainer.run(is_last_client=rank in tranks)}


def _child_main() -> None:
    from mpit_tpu_torch.train.gang import child_env, child_transport, write_result
    from mpit_tpu_torch.train.launch import child_result

    rank, size, cfg = child_env()
    # Live introspection endpoint (no-op unless MPIT_OBS_HTTP is set): the
    # same hook as the train/launch.py children.
    from mpit_tpu_torch.obs import maybe_start_statusd

    maybe_start_statusd(rank)
    device = resolve_device(cfg.device)
    transport = child_transport(cfg, rank, size)
    result = run_rank(rank, size, cfg, transport)
    transport.close()
    write_result(child_result(result, device))


def validate(cfg: Config) -> None:
    """The parent's checks, before any process starts: a bad optimizer
    name, corpus or role split found in a child would strand its peers in
    the stop protocol, and a missing card must not cost a gang's start."""
    if cfg.optimization not in BiCNNTrainer.KNOWN_OPTS:
        raise ValueError(f"unknown optimization {cfg.optimization!r}; "
                         f"have {BiCNNTrainer.KNOWN_OPTS}")
    if cfg.dtype != "float32":
        from mpit_tpu_torch.train.bicnn import DTYPE_SLICE

        raise NotImplementedError(f"dtype={cfg.dtype!r}: {DTYPE_SLICE}")
    if cfg.get("docqa", False) and not explicit_qa_files(cfg):
        from mpit_tpu_torch.data.qa import docqa_paths

        if docqa_paths() is None:
            raise FileNotFoundError(
                "--docqa 1 but data/fixtures/docqa is absent — pass explicit "
                "--*_file flags")
    resolve_device(cfg.device)
    effective = min(int(cfg.np), int(cfg.maxrank) + 1)
    tester_flags = resolve_tester_flags(cfg)  # validated even at np=1
    if effective > 1:
        assign_roles(effective, int(cfg.master_freq), *tester_flags, str(cfg.valid_mode))


def launch_processes(cfg: Config, timeout: float = 3600.0) -> Dict[int, Dict[str, Any]]:
    """Run the gang as ``cfg.np`` processes over shm; returns each rank's
    JSON result by rank."""
    from mpit_tpu_torch.train.gang import launch_gang

    cfg = BICNN_LAUNCH_DEFAULTS.merged(cfg.to_dict())
    validate(cfg)
    return launch_gang("mpit_tpu_torch.train.bicnn_launch", cfg, timeout)


def main(argv: Optional[List[str]] = None) -> Dict[Any, Any]:
    """The CLI: ``--np 1`` returns the local result under rank 0, ``--np N``
    each rank's result by rank."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--child" in argv:
        _child_main()
        return {}
    cfg = BICNN_LAUNCH_DEFAULTS.parse_args(argv)
    validate(cfg)
    t0 = time.monotonic()
    if int(cfg.np) == 1:
        results = {0: run_rank(0, 1, cfg, transport=None)}
    else:
        results = launch_processes(cfg)
    names = {0: "rank0"} if int(cfg.np) == 1 else {}
    print(json.dumps({names.get(r, str(r)): _summarize(res)
                      for r, res in sorted(results.items())}, indent=2))
    print(f"total {time.monotonic() - t0:.1f}s")
    return results


def _summarize(result: Dict[str, Any]) -> Dict[str, Any]:
    out = {k: v for k, v in result.items() if k != "history"}
    history = result.get("history")
    if history:
        out["last"] = history[-1]
    return out


if __name__ == "__main__":
    main()
