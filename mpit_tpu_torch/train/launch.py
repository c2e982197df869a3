"""Launcher — the port of ``mpit_tpu/train/launch.py`` (the claunch/mlaunch
analogs).

Role assignment follows the reference's conventions: with
``master_freq=2``, even ranks become parameter servers and odd ranks become
workers (reference mlaunch.lua:25-31).

Three entry modes, as in the JAX package's launcher:

- ``--np 1``: single-process local training, no comm (claunch.lua analog);
- ``--np N``: this process starts N role processes (fresh interpreters,
  ``python -m mpit_tpu_torch.train.launch --child``) wired over the native
  shm transport, or TCP with ``--transport tcp`` — the built-in ``mpirun
  -np N`` analog (:func:`launch_processes`, :mod:`mpit_tpu_torch.train.gang`).
  Each role runs on the card unless ``--device cpu`` or ``--device_policy``
  says otherwise; with ``--tester first|last`` one rank pulls, evaluates
  and checkpoints the servers' params (:mod:`mpit_tpu_torch.train.tester`);
- library use: :func:`run_rank` with injected transports, so a whole gang
  runs as threads of one process over the in-process router
  (:func:`run_gang`, :class:`mpit_tpu_torch.comm.local.LocalRouter`).

Fault tolerance (:mod:`mpit_tpu_torch.ft`): ``--ft_heartbeat_s``,
``--ft_lease_ttl_s``, ``--ft_op_deadline_s`` (INIT v3, framing, retry and
dedup), ``--ft_max_retries`` and ``--ft_staleness`` set each rank's
:class:`~mpit_tpu_torch.ft.FTConfig` (:func:`ft_from_cfg`);
``--server_ckpt_dir`` makes every server checkpoint its shard every
``--server_ckpt_interval`` seconds, and ``--resume`` restores them;
``--supervise N`` runs the gang under :func:`mpit_tpu_torch.ft.supervisor.
supervise_gang`, which restarts a dead rank up to N times (a worker as the
next epoch, rejoining the live servers; a server from its checkpoint).

Observability (:mod:`mpit_tpu_torch.obs`): ``--ft_timing 1`` (with
``--ft_op_deadline_s``) puts the gang on the ``FLAG_TIMING`` wire;
``MPIT_OBS_TRACE=path`` has every rank write its Chrome-trace part and the
parent merge them after a clean gang (``python -m mpit_tpu_torch.obs
analyze|profile|validate path``); ``MPIT_OBS_PROFILE=1`` adds the CPU
profile; ``MPIT_OBS_HTTP=<base port>`` serves each rank's ``/metrics``,
``/status`` and ``/trace`` on base + rank.

The layers of later slices (readers, cells, shard control, elastic
membership, chunked streaming, the LM, aggregation, the device data plane)
raise ``NotImplementedError`` naming their slice.

Usage:
    python -m mpit_tpu_torch.train.launch --np 1 --opt msgd
    # 2 servers + 2 workers, four processes over shm, on the CPU:
    python -m mpit_tpu_torch.train.launch --np 4 --opt downpour \\
        --device cpu --side 8 --epochs 1 --lr 0.2
    # a traced gang on the timing wire, then its causal decomposition:
    MPIT_OBS_TRACE=/tmp/t.json python -m mpit_tpu_torch.train.launch --np 4 \
        --opt adam --device cpu --side 8 --ft_op_deadline_s 5 --ft_timing 1
    python -m mpit_tpu_torch.obs analyze /tmp/t.json
    # the same under the supervisor, with heartbeats, retry and checkpoints:
    python -m mpit_tpu_torch.train.launch --np 4 --opt adam --device cpu \\
        --side 8 --epochs 2 --transport tcp --ft_heartbeat_s 0.25 \\
        --ft_lease_ttl_s 20 --ft_op_deadline_s 5 --supervise 2 \\
        --server_ckpt_dir /tmp/ckpt --server_ckpt_interval 2
    # the reference's config 3 on the card:
    python -m mpit_tpu_torch.train.launch --np 12 --opt eamsgd --su 10 \\
        --mom 0.99 --mva 0.15 --epochs 2 --model cnn
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from mpit_tpu_torch.comm.local import LocalRouter
from mpit_tpu_torch.ft import FTConfig
from mpit_tpu_torch.optim import rules as rules_mod
from mpit_tpu_torch.ps import ParamClient, ParamServer
from mpit_tpu_torch.train.gang import DEVICE_ENV
from mpit_tpu_torch.train.trainer import (
    KNOWN_OPTS, SERVER_RULE_OPTS, TRAINER_DEFAULTS, MnistTrainer)
from mpit_tpu_torch.utils.config import Config
from mpit_tpu_torch.utils.logging import get_logger
from mpit_tpu_torch.utils.platform import resolve_device

LAUNCH_DEFAULTS = TRAINER_DEFAULTS.merged(
    np=1,
    master_freq=2,  # every master_freq-th rank is a server (mlaunch parity)
    tester="none",  # none | first | last  (plaunch testerfirst/testerlast)
    tester_rounds=10,
    tester_interval=1.0,
    ckpt_dir="",  # the tester's best checkpoint (utils/checkpoint.save_flat)
    ring_mb=64,  # shm inbox ring per rank
    namespace="",  # shm segment namespace; "" = pid + sequence
    # Per-rank device (the reference's AGPU map, mlaunch.lua:56-62):
    # inherit (every rank on --device) | cpu | workers_accel (the tester,
    # else the first client, on --device; every other rank on the CPU).
    device_policy="inherit",
    # Gang wire: shm (one host) | tcp (tcp_addrs = one host:port per
    # rank, comma-separated — the hostfile analog).
    transport="shm",
    tcp_addrs="",
    gang_barrier=True,  # startup rendezvous before any role traffic
    # Wire codec for every client<->server shard transfer (comm/codec.py:
    # none | bf16 | int8).  "" defers to $MPIT_PS_CODEC (default none).
    # When set explicitly the servers are PINNED to it.
    codec="",
    # Server shard checkpointing + resume: server_ckpt_dir activates
    # periodic per-server shard + rule-state snapshots (with the FT dedup
    # table); --resume restores them and skips client seeding, so Adam's
    # moments survive a restart.
    server_ckpt_dir="",
    server_ckpt_interval=30.0,
    resume=False,
    # Fault tolerance (mpit_tpu_torch.ft; 0 = off, the legacy wire):
    # heartbeat interval for workers, lease TTL for servers (expired =>
    # eviction), per-op deadline for workers (enables retry + FT frame
    # headers), and supervise = restarts allowed per rank (the supervisor
    # respawns dead ranks with a bumped epoch; workers rejoin via INIT v3,
    # servers resume from their stamped shard snapshot — needs
    # server_ckpt_dir).  ft_staleness: frames carry the 24-byte
    # [epoch, seq, version] header (needs ft_op_deadline_s > 0).
    ft_heartbeat_s=0.0,
    ft_lease_ttl_s=0.0,
    ft_op_deadline_s=0.0,
    ft_max_retries=8,
    ft_staleness=False,
    # Causal timing (FLAG_TIMING): data frames carry a send stamp and acks
    # a [t_tx, t_recv, t_ack] tail, feeding each client's clock-offset
    # estimator (needs ft_op_deadline_s > 0).
    ft_timing=False,
    supervise=0,
    # The reference's flags of later slices; each raises when set.
    ft_chunk_bytes=0,
    serve_readers=0,
    cells=0,
    shardctl=False,
    elastic=False,
    lm=0,
    agg="off",
    dplane=0,
)

# flag -> (value meaning "off", the slice of the port it belongs to)
LATER_FLAGS = {
    "ft_chunk_bytes": (0, "chunked streaming (FLAG_CHUNKED, INIT v5; slice 5, "
                          "streaming with comm/pool)"),
    "serve_readers": (0, "the serving tier (slice 5, ps/serve)"),
    "cells": (0, "serving cells (slice 5, cells)"),
    "shardctl": (False, "shard control (slice 5, shardctl)"),
    "elastic": (False, "elastic membership (slice 5, shardctl with elastic)"),
    "lm": (0, "the LM workload through the PS gang (slice 7b, lm)"),
    "agg": ("off", "hierarchical aggregation (slice 5, agg)"),
    "dplane": (0, "the device data plane (slice 6, dplane)"),
}


def refuse_later_flags(cfg: Config) -> None:
    for flag, (off, owner) in LATER_FLAGS.items():
        if cfg.get(flag, off) != off:
            raise NotImplementedError(
                f"--{flag} {cfg.get(flag)!r} belongs to {owner} of the port")


def ft_from_cfg(cfg: Config) -> FTConfig:
    """FTConfig for one rank: env base (the supervisor's restart env —
    MPIT_FT_EPOCH/MPIT_FT_REJOIN — rides there) with the launch config's
    non-zero knobs layered on top."""
    overrides: Dict[str, Any] = {}
    for ck, fk in (("ft_heartbeat_s", "heartbeat_s"),
                   ("ft_lease_ttl_s", "lease_ttl_s"),
                   ("ft_op_deadline_s", "op_deadline_s")):
        value = float(cfg.get(ck, 0) or 0)
        if value:
            overrides[fk] = value
    if overrides.get("op_deadline_s"):
        overrides["max_retries"] = int(cfg.get("ft_max_retries", 8))
    if overrides.get("lease_ttl_s") or int(cfg.get("supervise", 0)):
        overrides["rejoin"] = True
    if bool(cfg.get("ft_staleness", False)):
        overrides["staleness"] = True
    if bool(cfg.get("ft_timing", False)):
        overrides["timing"] = True
    return FTConfig.from_env(**overrides)


def rejoining() -> bool:
    """This process is a supervisor's replacement of a dead rank."""
    return os.environ.get("MPIT_FT_REJOIN", "0") not in ("0", "")


def assign_roles(
    size: int, master_freq: int = 2, tester: str = "none"
) -> Tuple[List[int], List[int], Optional[int]]:
    """Returns (server_ranks, client_ranks, tester_rank): the tester takes
    the first or the last rank, then every ``master_freq``-th rank of the
    rest serves."""
    ranks = list(range(size))
    tester_rank: Optional[int] = None
    if tester == "first":
        tester_rank = 0
        ranks = ranks[1:]
    elif tester == "last":
        tester_rank = size - 1
        ranks = ranks[:-1]
    sranks = [r for r in ranks if r % master_freq == 0]
    cranks = [r for r in ranks if r % master_freq != 0]
    if not sranks or not cranks:
        raise ValueError(
            f"role split produced {len(sranks)} servers / {len(cranks)} "
            f"clients from size={size}, master_freq={master_freq}"
        )
    return sranks, cranks, tester_rank


def server_rule_for(cfg: Config) -> rules_mod.ShardRule:
    """The server-side shard rule matching the client optimizer
    (reference BiCNN/pserver.lua:123-197 dispatch)."""
    if cfg.opt in SERVER_RULE_OPTS:
        return rules_mod.make(cfg.opt, lr=cfg.lr)
    return rules_mod.make("add")  # downpour/easgd/eamsgd ship pre-scaled deltas


def run_rank(rank: int, size: int, cfg: Config, transport: Any,
             data: Any = None) -> Dict[str, Any]:
    """Run one rank's role to completion; returns its result dict.  With
    ``size > 1`` the roles reach each other through ``transport``: this
    rank's endpoint of one router (a thread each), or of the shm or TCP
    wire (a process each).  A server's result holds its final shard
    (``param``) and a worker's its final ``w``, as tensors on the role's
    device."""
    cfg = LAUNCH_DEFAULTS.merged(cfg.to_dict())
    refuse_later_flags(cfg)
    if size == 1:
        if bool(cfg.resume):
            # Server-shard resume needs servers; silently restarting from
            # scratch would look like a successful resume.
            raise ValueError("--resume restores parameter-server shards and "
                             "needs --np > 1 (single-process runs have no "
                             "servers)")
        trainer = MnistTrainer(cfg, data=data, rank=rank)
        return {"role": "local", **trainer.run()}
    if transport is None:
        raise ValueError(f"run_rank at size {size} needs this rank's transport "
                         "(launch_processes, or run_gang in one process)")
    log = get_logger("launch", rank)
    sranks, cranks, tester_rank = assign_roles(
        size, int(cfg.master_freq), str(cfg.tester))
    codec = str(cfg.codec or "") or None
    ft = ft_from_cfg(cfg)
    if rank == tester_rank:
        from mpit_tpu_torch.train.tester import run_tester

        return {"role": "tester", **run_tester(rank, sranks, cfg, transport, data)}
    if rank in sranks:
        # The tester counts as a (pull-only) client: it announces shards
        # and takes part in the stop protocol like any worker.
        all_clients = cranks + ([tester_rank] if tester_rank is not None else [])
        ckpt_dir = str(cfg.server_ckpt_dir or "")
        server = ParamServer(
            rank, all_clients, transport, rule=server_rule_for(cfg),
            single_mode=str(cfg.opt).endswith("-single"),
            device=cfg.device, codec=codec, ft=ft, ckpt_dir=ckpt_dir or None,
            ckpt_interval=float(cfg.server_ckpt_interval))
        if bool(cfg.resume):
            path = pathlib.Path(ckpt_dir) / f"server{rank}_latest.npz"
            if not ckpt_dir or not path.exists():
                raise FileNotFoundError(
                    f"--resume needs --server_ckpt_dir with a "
                    f"server{rank}_latest.npz (looked at {path})")
            server.restore_state(path)
            log.info("restored shard from %s", path)
        log.info("server for clients %s", cranks)
        server.start()
        return {
            "role": "server",
            "grads_applied": server.grads_applied,
            "params_served": server.params_served,
            "snapshot_copies": server.snapshot_copies,
            "snapshot_hits": server.snapshot_hits,
            "dup_ops": server.dup_ops,
            "stale_drops": server.stale_drops,
            "heartbeats_seen": server.heartbeats_seen,
            "rejoins": server.rejoins,
            "evictions": server.evictions,
            "ckpts_written": server.ckpts_written,
            "restored": bool(cfg.resume),
            "restored_applied": server.restored_applied,
            "restored_dedup": server.restored_dedup,
            "admitted": {f"{c}:{e}": v for (c, e), v in server.admitted.items()},
            "serving_since": server.serving_since,
            "rejoined_at": server.rejoined_at,
            "param": server.param,
        }
    # On resume the restored servers are authoritative for params — no
    # client re-seeds.  Same for a supervisor-restarted worker rejoining
    # mid-run: the live servers hold the current center, and a re-seed
    # would rewind it.
    pclient = ParamClient(
        rank, sranks, transport, codec=codec, ft=ft,
        seed_servers=(rank == cranks[0]) and not bool(cfg.resume)
        and not rejoining())
    trainer = MnistTrainer(cfg, pclient=pclient, data=data, rank=rank)
    log.info("worker with servers %s (epoch %d)", sranks, ft.epoch)
    return {"role": "worker", **trainer.run(), "w": trainer.w,
            "epoch": ft.epoch, "retries": pclient.retries,
            "heartbeats_sent": pclient.heartbeats_sent,
            "grads_acked": pclient.grads_acked()}


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


# -- process-mode launcher (the mpirun analog) -------------------------------


def expected_role(rank: int, size: int, cfg: Config) -> str:
    """The role this rank will run, derived as run_rank does; '' when the
    split is invalid (run_rank raises the real error)."""
    if size == 1:
        return "local"
    try:
        sranks, _cranks, tester_rank = assign_roles(
            size, int(cfg.get("master_freq", 2)), str(cfg.get("tester", "none")))
    except ValueError:
        return ""
    if rank == tester_rank:
        return "tester"
    return "server" if rank in sranks else "worker"


def device_env_overrides(cfg: Config, size: int) -> Dict[int, Dict[str, str]]:
    """Per-rank device assignment from ``cfg.device_policy``, as the env
    the launcher hands each child (``MPIT_DEVICE``), the counterpart of the
    JAX launcher's per-rank ``JAX_PLATFORMS``.  ``inherit``: every rank on
    ``cfg.device`` (the card admits several processes, unlike libtpu);
    ``cpu``: every rank on the CPU; ``workers_accel``: the tester, else the
    first client, on ``cfg.device`` and every other rank on the CPU."""
    policy = cfg.get("device_policy", "inherit")
    if policy == "inherit":
        return {}
    if policy == "cpu":
        return {r: {DEVICE_ENV: "cpu"} for r in range(size)}
    if policy == "workers_accel":
        _sranks, cranks, tester = assign_roles(
            size, int(cfg.get("master_freq", 2)), str(cfg.get("tester", "none")))
        accel_rank = tester if tester is not None else cranks[0]
        return {r: {DEVICE_ENV: "cpu"} for r in range(size) if r != accel_rank}
    raise ValueError(
        f"device_policy must be inherit|cpu|workers_accel, got {policy!r}")


def launch_processes(cfg: Config, timeout: float = 3600.0,
                     chaos: Optional[Dict[str, Any]] = None
                     ) -> Dict[int, Dict[str, Any]]:
    """Run the gang as ``cfg.np`` processes; returns each rank's result
    (JSON: tensors are replaced by the sha256 of their float32 bytes, and
    each result names its ``platform`` and its K1-K3 ``launches``).
    With ``cfg.supervise`` the gang runs under the supervisor, and
    ``chaos`` (``chaos_kill_rank``, ``chaos_kill_after_s``, ...) has it
    kill one rank mid-run, as the reference's chaos soak does.

    Fails fast in the parent, before any process starts: a bad optimizer
    name or role split found only inside a child would strand the servers
    in their stop protocol, and a flag of a later slice or a missing card
    must not cost a gang's start-up."""
    cfg = LAUNCH_DEFAULTS.merged(cfg.to_dict())
    if cfg.opt not in KNOWN_OPTS:
        raise ValueError(f"unknown optimizer {cfg.opt!r}; have {KNOWN_OPTS}")
    refuse_later_flags(cfg)
    size = int(cfg.np)
    assign_roles(size, int(cfg.master_freq), str(cfg.tester))
    overrides = device_env_overrides(cfg, size)
    if len(overrides) < size:  # some rank runs on cfg.device
        resolve_device(cfg.device)
    if cfg.transport == "tcp":
        addrs = [a for a in str(cfg.tcp_addrs).split(",") if a]
        if len(addrs) != size:
            raise ValueError(f"transport=tcp needs {size} comma-separated "
                             f"tcp_addrs, got {len(addrs)}")
    elif cfg.transport != "shm":
        raise ValueError(f"transport must be shm or tcp, got {cfg.transport!r}")
    restarts = int(cfg.supervise)
    if restarts > 0:
        from mpit_tpu_torch.ft.supervisor import RestartPolicy, supervise_gang

        sranks, _cranks, _tester = assign_roles(
            size, int(cfg.master_freq), str(cfg.tester))
        return supervise_gang(
            "mpit_tpu_torch.train.launch", cfg, timeout,
            policy=RestartPolicy(max_restarts=restarts),
            env_overrides=supervised_env(cfg, overrides), server_ranks=sranks,
            **(chaos or {}))
    if chaos:
        raise ValueError("a chaos kill needs --supervise >= 1")
    from mpit_tpu_torch.train.gang import launch_gang

    return launch_gang("mpit_tpu_torch.train.launch", cfg, timeout,
                       env_overrides=overrides)


def supervised_env(cfg: Config, overrides: Dict[int, Dict[str, str]]
                   ) -> Dict[int, Dict[str, str]]:
    """Each child's env under the supervisor.  Over TCP every rank runs
    with ``MPIT_TCP_RECONNECT_S`` (the caller's, else 60 s): a restarted
    rank re-binds its address and redials, and its peers re-handshake
    instead of failing loudly.  All ranks must agree on it (it is part of
    the mesh handshake's digest)."""
    env = {r: dict(overrides.get(r, {})) for r in range(int(cfg.np))}
    if cfg.transport == "tcp":
        window = os.environ.get("MPIT_TCP_RECONNECT_S", "60")
        for rank_env in env.values():
            rank_env.setdefault("MPIT_TCP_RECONNECT_S", window)
    return env


def _sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def child_result(result: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """A rank's result as JSON: each tensor becomes ``<key>_sha256`` (its
    bytes' digest, enough to hold two runs bit for bit), and the result
    gains ``platform`` (the device its role ran on) and the rank's
    ``launches`` of K1-K3, which the parent cannot read in the child."""
    from mpit_tpu_torch.ops import fused_update as fu

    out = {k: v for k, v in result.items() if not isinstance(v, torch.Tensor)}
    for k, v in result.items():
        if isinstance(v, torch.Tensor):
            out[f"{k}_sha256"] = _sha256(v)
    out["platform"] = device.type
    out["launches"] = {"k1": fu.fused_nesterov_commit.launches,
                       "k2": fu.fused_elastic.launches,
                       "k3": fu.fused_adam.launches}
    return out


def _child_main() -> None:
    from mpit_tpu_torch.obs import get_flight, maybe_start_statusd, maybe_write_rank_trace
    from mpit_tpu_torch.train.gang import child_env, child_transport, write_result

    rank, size, cfg = child_env()
    # Live introspection (no-op unless MPIT_OBS_HTTP is set): /metrics,
    # /status and /trace on base_port + rank for the whole life of this
    # rank.  Flight dumps inherit the identity.
    role = expected_role(rank, size, cfg)
    maybe_start_statusd(rank, role=role)
    get_flight().set_identity(rank=rank, role=role)
    device = resolve_device(cfg.device)
    transport = child_transport(cfg, rank, size)
    result = run_rank(rank, size, cfg, transport)
    transport.close()
    # This rank's Chrome-trace part (MPIT_OBS_TRACE; no-op when unset): the
    # gang parent merges the parts into one timeline at exit.
    maybe_write_rank_trace(rank, role=str(result.get("role", "")))
    write_result(child_result(result, device))


def main(argv: Optional[List[str]] = None) -> Dict[Any, Any]:
    """The CLI: ``--np 1`` returns the local result, ``--np N`` each rank's
    result by rank."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--child" in argv:
        _child_main()
        return {}
    cfg = LAUNCH_DEFAULTS.parse_args(argv)
    t0 = time.monotonic()
    if int(cfg.np) == 1:
        from mpit_tpu_torch.obs import (
            maybe_merge_rank_traces, maybe_start_statusd, maybe_write_rank_trace)

        maybe_start_statusd(0, role="local")
        result = run_rank(0, 1, cfg, None)
        maybe_write_rank_trace(0, role=str(result.get("role", "")))
        maybe_merge_rank_traces()
        print(json.dumps({"rank0": _summarize(result)}, indent=2))
    else:
        result = launch_processes(cfg)
        print(json.dumps({f"rank{r}": _summarize(res)
                          for r, res in sorted(result.items())}, indent=2))
    print(f"total wall time: {time.monotonic() - t0:.1f}s")
    return result


def _summarize(result: Dict[str, Any]) -> Dict[str, Any]:
    keep = {"role", "final_test_err", "time_to_target", "elapsed",
            "grads_applied", "params_served", "best_test_err", "platform",
            "launches", "epoch", "retries", "dup_ops", "rejoins",
            "evictions", "ckpts_written", "restored", "restarts"}
    return {k: v for k, v in result.items() if k in keep}


if __name__ == "__main__":
    main()
