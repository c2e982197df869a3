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

Shard control (:mod:`mpit_tpu_torch.shardctl`): ``--shardctl 1`` makes the
last rank the shard-map controller (the rest split into servers and
workers as usual); clients address shards of a versioned map, and the
controller rebalances hot shards (``--shardctl_ratio``) and fails a dead
server's shards over from their checkpoints (``--shardctl_lease_ttl_s``).
``--elastic 1`` composes shard control with the supervisor: the rank space
is ``--np`` plus ``--elastic_spares`` joiner-server slots that spawn only
when the controller asks (a scale-up through its ``/scale`` route or the
autoscaler), servers checkpoint on a SIGTERM notice and report it, and the
first cut makes ``--elastic_shards_per_server`` shards per server.
``--autoscale 1`` adds the SLO-driven loop on the controller
(``--autoscale_p99_ms`` and the other targets; needs ``MPIT_OBS_HTTP``).

The read path (:mod:`mpit_tpu_torch.ps.serve`, :mod:`mpit_tpu_torch.cells`):
``--serve_readers R`` makes the last R ranks READ-ONLY readers that pull the
current params ``--serve_rounds`` times, ``--serve_interval_s`` apart,
against the servers' admission budget (``--serve_budget_mb``,
``--serve_budget_reads``); ``--cells C`` puts C replica cells between the
training roles and the readers: each subscribes to one server's committed
version stream (``--cell_codec``, int8 unless told otherwise), serves the
readers under the ``--cell_max_lag`` staleness bound, and readers route
across a shard's cells by consistent hashing, failing over on a dead cell.
Both need ``--ft_op_deadline_s``; cells also ``--ft_heartbeat_s``.
Reader and cell ranks are host roles: they hold nothing on a device.

``--ft_chunk_bytes B`` (with ``--ft_op_deadline_s``) ships every shard
transfer as a pipelined stream of ~B-byte chunk frames (INIT v5), encoded
and decoded on the worker pool (``MPIT_POOL_THREADS``, default
``min(4, cores-1)``, 0 = serial).  ``--dplane 1`` makes each server's shard
a device-resident slot that publishes the in-process device exchange, and
wraps each worker's client in an ``ExchangeClient``: same-process pairs
(``run_gang``) ride the device path, and every pair of a process gang
falls back to the wire (counted, ``mpit_dplane_wire_fallback_ranks``).

Hierarchical aggregation (:mod:`mpit_tpu_torch.agg`): ``--agg
prereduce|tree`` wraps each worker's client in an ``AggClient``:
colocated groups (``--agg_groups "1,3;5,7"``, ranks of one process and
device) fold on their device behind a representative, and with ``tree``
the representatives reduce through a seeded REDUCE tree (``--agg_fanin``,
``--agg_tree_seed``) so the servers see one GRAD a round.  It needs
``--ft_op_deadline_s`` and refuses shard control and ``--dplane``;
``--agg_deadline_s`` is the straggler deadline, ``--agg_chunk_bytes`` the
REDUCE hop's chunk.

The LM through the gang (:mod:`mpit_tpu_torch.lm`): ``--lm 1`` swaps the
MNIST trainer for the transformer-LM loop (``--lm_d_model``, ``--lm_heads``,
``--lm_layers``, ``--lm_seq``, ``--lm_steps``, ``--lm_eval_every``,
``--lm_use_flash``); unless shard control owns placement, every worker and
reader announces the plan's weighted aligned cut (``--lm_weights "3,1"``)
instead of the equal split.  It refuses a tester rank and ``--cells``.

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
    # 2 servers, 1 writer, 2 cells and 4 fabric-routed readers over TCP:
    python -m mpit_tpu_torch.train.launch --np 9 --opt adam --device cpu \
        --side 8 --epochs 1 --serve_readers 4 --cells 2 --transport tcp \
        --tcp_addrs h:p,... --ft_op_deadline_s 30 --ft_heartbeat_s 0.2
    # shard control, then an elastic gang with a spare server slot (TCP):
    python -m mpit_tpu_torch.train.launch --np 5 --opt adam --device cpu \
        --side 8 --epochs 1 --shardctl 1 --ft_op_deadline_s 5
    python -m mpit_tpu_torch.train.launch --np 5 --opt adam --device cpu \
        --side 8 --epochs 50 --elastic 1 --elastic_spares 1 --supervise 1 \
        --transport tcp --tcp_addrs h:p,h:p,h:p,h:p,h:p,h:p \
        --ft_op_deadline_s 5 --ft_heartbeat_s 0.25 --server_ckpt_dir /tmp/e
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
    # Shard control: the LAST rank becomes the shard-map controller,
    # clients address shards through a versioned map, and the controller
    # rebalances hot shards and fails a dead server's shards over from
    # their checkpoints.  Needs ft_op_deadline_s > 0 (re-routing rides the
    # retry machinery).  shardctl_ratio tunes the rebalance trigger;
    # shardctl_lease_ttl_s > 0 arms server leases at the controller
    # (expiry => failover; pair with server_ckpt_dir).
    shardctl=False,
    shardctl_ratio=3.0,
    shardctl_lease_ttl_s=0.0,
    # Elastic gangs: shard control + the supervisor + the scale mailbox.
    # elastic_spares joiner-server slots beyond --np spawn only on the
    # controller's request; servers checkpoint on a SIGTERM notice
    # (elastic_grace_s is the window they announce); the first cut makes
    # elastic_shards_per_server shards per launch server.  Needs
    # supervise >= 1, ft_op_deadline_s > 0 and server_ckpt_dir.
    elastic=False,
    elastic_spares=1,
    elastic_grace_s=5.0,
    elastic_shards_per_server=2,
    # Closed-loop autoscaling: implies --elastic; the controller samples
    # the gang through every rank's statusd endpoint (MPIT_OBS_HTTP) and
    # drives the scale verbs against these SLO targets (0 = off).
    autoscale=False,
    autoscale_p99_ms=0.0,
    autoscale_busy_ratio=0.0,
    autoscale_staleness=0.0,
    autoscale_sendq=0.0,
    autoscale_window_s=2.0,
    autoscale_cooldown_s=20.0,
    autoscale_flap_budget=3,
    autoscale_min_servers=1,
    autoscale_max_servers=0,  # 0 = every provisioned server slot
    # The serving tier: the LAST serve_readers ranks become READ-ONLY
    # readers that attach to the servers, pull the current params
    # serve_rounds times (serve_interval_s apart), check the snapshot
    # versions are monotone, and stop.  Servers answer over-budget reads
    # BUSY with a retry hint (serve_budget_mb in-flight reply bytes;
    # serve_budget_reads optionally bounds the reply count).  Needs
    # ft_op_deadline_s > 0 (BUSY recovery rides the retry machinery).
    serve_readers=0,
    serve_rounds=10,
    serve_interval_s=0.05,
    serve_budget_mb=64.0,
    serve_budget_reads=0,
    # Serving cells: cells N inserts N replica cells between the training
    # roles and the readers.  Each subscribes to one server's committed
    # version stream (one diff stream each), serves the readers under the
    # cell_max_lag staleness bound, and readers route across a shard's
    # cells by consistent hashing, failing over to ring siblings on cell
    # death.  Needs serve_readers > 0, ft_op_deadline_s > 0,
    # ft_heartbeat_s > 0 (cell leases and head echoes ride the beat
    # channel) and N >= the server count.  cell_codec: the subscription
    # codec, "" = int8 (the XOR deltas ride the encoded domain, bit-exact
    # by construction); fabric readers negotiate the same codec.
    cells=0,
    cell_max_lag=4,
    cell_codec="",
    # Pipelined streaming: ~bytes per chunk frame of every shard transfer
    # (0 = whole frames).  Needs ft_op_deadline_s > 0 (chunk resends ride
    # the retry machinery).
    ft_chunk_bytes=0,
    # The device data plane: servers hold shard + optimizer state in a
    # device-resident slot and publish the in-process device exchange;
    # workers route through an ExchangeClient (device path to same-process
    # servers, the wire everywhere else).
    dplane=0,
    # Hierarchical aggregation (docs/PROTOCOL.md §13): --agg
    # off|prereduce|tree.  prereduce folds colocated client groups on their
    # device behind a representative; tree also reduces the
    # representatives through a seeded REDUCE tree, so the servers see ONE
    # gradient per round for the whole gang.  agg_groups declares
    # colocation ("4,5;6,7" — ranks sharing a process and device; empty =
    # every client its own representative), checked against the dplane
    # fingerprint at start.  Needs ft_op_deadline_s > 0; off under shard
    # control and --dplane.  agg_deadline_s is the straggler wall
    # deadline; agg_chunk_bytes cuts the REDUCE hops (0 = ft_chunk_bytes,
    # then 1 MiB).
    agg="off",
    agg_groups="",
    agg_fanin=2,
    agg_tree_seed=0,
    agg_deadline_s=5.0,
    agg_chunk_bytes=0,
    # The LM workload: --lm 1 swaps the MNIST trainer for the transformer-
    # LM loop.  The shared optimizer knobs (--opt/--lr/--mom/--mva/--su/
    # --batch/--seed/--dtype) carry over; the lm_* knobs size the model and
    # the step loop.  Unless shard control owns placement, every client
    # AND reader announces the same weighted aligned-cut layout (lm.plan)
    # instead of the equal split — lm_weights skews it ("3,1" = server 0
    # aims at 3/4 of the vector), empty = balanced cut on parameter
    # boundaries.
    lm=0,
    lm_d_model=64,
    lm_heads=4,
    lm_layers=2,
    lm_seq=128,
    lm_steps=200,
    lm_eval_every=50,
    lm_use_flash=-1,  # -1 auto (flash on the card) | 0 plain reference | 1 flash
    lm_weights="",
)


def parse_agg_groups(spec: str) -> Tuple[Tuple[int, ...], ...]:
    """--agg_groups "4,5;6,7" -> ((4, 5), (6, 7)): semicolon-separated
    colocation groups of comma-separated client ranks.  Empty spec = no
    declared colocation (every client its own representative)."""
    return tuple(
        tuple(int(x) for x in part.split(",") if x.strip() != "")
        for part in spec.split(";") if part.strip())


def agg_refusals(cfg: Config) -> None:
    """The compositions the JAX launcher refuses for --agg, with its words."""
    if str(cfg.get("agg", "off") or "off") == "off":
        return
    if bool(cfg.get("shardctl", False)) or bool(cfg.get("elastic", False)):
        raise ValueError("--agg composes with the static shard map "
                         "only (run without --shardctl/--elastic)")
    if int(cfg.get("dplane", 0) or 0):
        raise ValueError("--agg and --dplane both wrap the client "
                         "data path; pick one")
    if float(cfg.get("ft_op_deadline_s", 0) or 0) <= 0:
        raise ValueError("--agg needs --ft_op_deadline_s > 0: REDUCE "
                         "hops ride the framed retry machinery")


def lm_refusals(cfg: Config) -> None:
    """The compositions the JAX launcher refuses for --lm, with its words."""
    if not int(cfg.get("lm", 0) or 0):
        return
    if str(cfg.get("tester", "none")) != "none":
        raise ValueError("--lm and a tester rank are mutually "
                         "exclusive (the tester is MNIST-only)")
    if int(cfg.get("cells", 0) or 0):
        raise ValueError("--lm and --cells are not composed yet: the "
                         "cell fabric derives the equal split, not "
                         "the LM plan's weighted cut")


def lm_trainer_cfg(cfg: Config) -> Config:
    """The :data:`mpit_tpu_torch.lm.trainer.LM_DEFAULTS`-shaped config for
    one launch config: shared optimizer/loop knobs carried over verbatim,
    lm_* knobs mapped onto the trainer's names."""
    return Config(
        d_model=int(cfg.get("lm_d_model", 64)),
        n_heads=int(cfg.get("lm_heads", 4)),
        n_layers=int(cfg.get("lm_layers", 2)),
        seq_len=int(cfg.get("lm_seq", 128)),
        steps=int(cfg.get("lm_steps", 200)),
        eval_every=int(cfg.get("lm_eval_every", 50)),
        use_flash=int(cfg.get("lm_use_flash", -1)),
        opt=cfg.opt, lr=cfg.lr, lrd=cfg.lrd, lrp=cfg.lrp, mom=cfg.mom,
        mommax=cfg.mommax, momdecay=cfg.momdecay, l2wd=cfg.l2wd,
        mva=cfg.mva, su=cfg.su, batch=cfg.batch, seed=cfg.seed,
        dtype=cfg.get("dtype", "float32"), profile_dir=cfg.get("profile_dir", ""),
        device=cfg.device,
    )


def lm_spec_tree(cfg: Config) -> Dict[str, Any]:
    """The LM's flax-named parameter tree at the launch widths, as zero
    arrays of the parameter shapes (a cut depends on shapes alone: no
    initialization, nothing on a device)."""
    import numpy as np

    from mpit_tpu_torch.models.flat import param_spec
    from mpit_tpu_torch.models.transformer import TinyDecoder

    tcfg = lm_trainer_cfg(cfg)
    with torch.device("meta"):
        module = TinyDecoder(vocab=256, d_model=tcfg.d_model, n_heads=tcfg.n_heads,
                             n_layers=tcfg.n_layers, max_len=tcfg.seq_len)
    tree: Dict[str, Any] = {}
    for name, shape in param_spec(module):
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.broadcast_to(np.float32(0), shape)
    return tree


def lm_layout(cfg: Config, n_servers: int) -> List[Any]:
    """The gang's static weighted aligned-cut layout (one Shard per
    server) under --lm: the deterministic cut every client and reader must
    announce identically.  ``lm_weights`` ("3,1") skews the targets; empty
    keeps balanced targets (still boundary-aligned, so it differs from the
    raw equal split)."""
    from mpit_tpu_torch.lm import plan

    spec = str(cfg.get("lm_weights", "") or "")
    weights = ([float(x) for x in spec.split(",") if x.strip() != ""]
               if spec else None)
    if weights is not None and len(weights) != n_servers:
        raise ValueError(
            f"--lm_weights names {len(weights)} servers but the role "
            f"split made {n_servers}")
    rule = cfg.opt if cfg.opt in rules_mod.names() else "add"
    return plan(lm_spec_tree(cfg), n_servers, rule=rule, server_weights=weights).layout


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
    chunk = int(cfg.get("ft_chunk_bytes", 0) or 0)
    if chunk:
        overrides["chunk_bytes"] = chunk
    return FTConfig.from_env(**overrides)


def dplane_cfg(cfg: Config) -> Any:
    """The PlaneConfig of a ``--dplane`` server, the JAX launcher's
    ``PlaneConfig.auto()``: a ``shard`` axis over every card the process
    sees when it sees more than one, else one-card placement on the rank's
    device; a run on the CPU places on the CPU."""
    from mpit_tpu_torch.dplane import PlaneConfig

    device = str(cfg.get("device", "cuda") or "cuda")
    return PlaneConfig.auto(namespace=str(cfg.get("namespace", "") or ""),
                            device=None if device == "cuda" else device)


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


def read_path_ranks(size: int, cfg: Config) -> Tuple[int, List[int], List[int]]:
    """(role_size, cell_ranks, reader_ranks): the last ``serve_readers``
    ranks read, the ``cells`` ranks before them serve as replica cells,
    and the roles split over the rest.  Raises on a split the reference
    refuses."""
    n_readers = int(cfg.get("serve_readers", 0) or 0)
    n_cells = int(cfg.get("cells", 0) or 0)
    if n_cells and not n_readers:
        raise ValueError("--cells without --serve_readers: a cell fabric "
                         "exists to serve readers")
    if not n_readers:
        return size, [], []
    if bool(cfg.get("shardctl", False)) or bool(cfg.get("elastic", False)):
        raise ValueError("serve_readers and shardctl are mutually exclusive "
                         "for now")
    if str(cfg.get("tester", "none")) != "none":
        raise ValueError("serve_readers and a tester rank are mutually "
                         "exclusive for now (both claim edge ranks)")
    if float(cfg.get("ft_op_deadline_s", 0) or 0) <= 0:
        raise ValueError("serve_readers needs --ft_op_deadline_s > 0: BUSY "
                         "recovery rides the FT retry machinery")
    if n_cells and float(cfg.get("ft_heartbeat_s", 0) or 0) <= 0:
        raise ValueError("--cells needs --ft_heartbeat_s > 0: cell leases "
                         "and the head echoes ride the beat channel")
    if size - n_readers - n_cells < 2:
        raise ValueError(
            f"serve_readers={n_readers} + cells={n_cells} leave "
            f"{size - n_readers - n_cells} role ranks; need >= 1 server + "
            ">= 1 worker")
    role_size = size - n_readers - n_cells
    return (role_size, list(range(role_size, role_size + n_cells)),
            list(range(role_size + n_cells, size)))


def serve_cfg_for(cfg: Config) -> Any:
    """The serving tier's admission budget from the launch config."""
    from mpit_tpu_torch.ps.serve import ServeConfig

    return ServeConfig.from_env(
        budget_bytes=int(float(cfg.get("serve_budget_mb", 64.0)) * (1 << 20)),
        budget_reads=int(cfg.get("serve_budget_reads", 0) or 0))


def serve_vec_len(cfg: Config) -> int:
    """The flat parameter-vector length a reader or cell mirrors: the
    trainer's model (the LM under --lm, else the MNIST model at its side),
    counted from its parameter shapes (no initialization, nothing on a
    device)."""
    import math

    from mpit_tpu_torch.lm.plan import flat_segments
    from mpit_tpu_torch.models.flat import param_spec
    from mpit_tpu_torch.models.mnist import make_model

    if int(cfg.get("lm", 0) or 0):
        return flat_segments(lm_spec_tree(cfg))[-1].end
    return sum(math.prod(shape) for _name, shape in
               param_spec(make_model(str(cfg.model), int(cfg.side))))


def cell_codec_for(cfg: Config) -> str:
    """The cell fleet's subscription codec: ``--cell_codec`` when set, else
    int8 — the XOR diff stream is ~4x cheaper in the int8 domain and
    bit-exact by construction, so compressed subscriptions are the
    default and ``--cell_codec none`` opts out."""
    from mpit_tpu_torch.comm import codec as codec_mod

    name = str(cfg.get("cell_codec", "") or "") or "int8"
    codec_mod.get(name)  # unknown names fail at launch, not mid-gang
    return name


def cell_map_for(sranks: List[int], cell_ranks: List[int]) -> Dict[int, List[int]]:
    """Round-robin assignment of replica cells to server slots: cell i
    mirrors sranks[i % S], so every shard gets ceil(N/S) replicas and
    siblings exist whenever N >= 2S."""
    out: Dict[int, List[int]] = {s: [] for s in sranks}
    for i, c in enumerate(cell_ranks):
        out[sranks[i % len(sranks)]].append(c)
    return out


def run_cell(rank: int, sranks: List[int], cell_ranks: List[int],
             reader_ranks: List[int], cfg: Config, transport: Any) -> Dict[str, Any]:
    """One replica serving cell: subscribe to the assigned upstream server's
    version stream, serve the fabric's readers under the staleness bound,
    stop when every reader is terminal."""
    from mpit_tpu_torch.cells.cell import ServingCell
    from mpit_tpu_torch.shardctl import shardmap as _shardmap

    log = get_logger("cell", rank)
    upstream = next(s for s, cs in cell_map_for(sranks, cell_ranks).items()
                    if rank in cs)
    smap = _shardmap.ShardMap.initial(serve_vec_len(cfg), sranks)
    shard = dict(zip(sranks, (e.shard for e in smap.entries)))[upstream]
    cell = ServingCell(
        rank, upstream, transport, reader_ranks, offset=shard.offset,
        size=shard.size, codec=cell_codec_for(cfg),
        max_lag=int(cfg.get("cell_max_lag", 4)), ft=ft_from_cfg(cfg),
        serve=serve_cfg_for(cfg))
    log.info("cell for upstream %d, shard (%d,%d), readers %s",
             upstream, shard.offset, shard.size, reader_ranks)
    cell.start()
    return {"role": "cell", "upstream": upstream, "version": cell.version,
            "head": cell.head, "params_served": cell.params_served,
            "busy_replies": cell.busy_replies,
            "diffs_installed": cell.diffs_installed, "resyncs": cell.resyncs,
            "lag_sheds": cell.lag_sheds}


def run_reader(rank: int, sranks: List[int], cfg: Config, transport: Any,
               cell_ranks: Optional[List[int]] = None) -> Dict[str, Any]:
    """One READ-ONLY reader rank: attach, pull the current params
    ``serve_rounds`` times at ``serve_interval_s`` pacing, check version
    monotonicity, stop.  With a cell fabric the reads route across the
    replica cells instead of the training servers."""
    import numpy as np

    from mpit_tpu_torch.ps.serve import ReaderClient

    log = get_logger("serve", rank)
    rc = ReaderClient(
        rank, sranks, transport,
        # Fabric readers negotiate the cells' subscription codec (a cell
        # serves its subscription codec only); direct readers the gang's.
        codec=(cell_codec_for(cfg) if cell_ranks else str(cfg.codec or "") or None),
        ft=ft_from_cfg(cfg),
        cells=(cell_map_for(sranks, cell_ranks) if cell_ranks else None),
        # --lm readers must announce the identical weighted cut the writers
        # announced (servers reject a disagreeing attach).
        layout=(lm_layout(cfg, len(sranks)) if int(cfg.get("lm", 0) or 0) else None))
    mirror = np.zeros(serve_vec_len(cfg), np.float32)
    rc.start(mirror)
    interval = float(cfg.get("serve_interval_s", 0.05))
    for _ in range(int(cfg.get("serve_rounds", 10))):
        rc.read_params()
        if interval > 0:
            time.sleep(interval)
    rc.stop()
    log.info("reader done: %d reads, monotone=%s, busy honored %d",
             rc.reads_done, rc.monotone, rc.busy_honored)
    return {"role": "reader", "reads": rc.reads_done, "monotone": bool(rc.monotone),
            "busy_honored": rc.busy_honored, "retries": rc.retries,
            "versions": {str(k): v for k, v in rc.versions.items()},
            "read_versions": {str(k): v for k, v in rc.read_versions.items()},
            "lags": {str(k): v for k, v in rc.lags.items()},
            "failovers": rc.failovers}


def _autoscaler_for(cfg: Config, ctl: Any, size: int) -> Any:
    """The controller rank's Autoscaler under --autoscale: SLO targets from
    the launch knobs, telemetry pooled over every rank's statusd endpoint
    (launch_processes checked MPIT_OBS_HTTP)."""
    from mpit_tpu_torch.obs.statusd import base_port
    from mpit_tpu_torch.shardctl.autoscale import (
        AutoscaleConfig, Autoscaler, HttpSampler, SLOConfig)

    slo = SLOConfig(
        p99_ms=float(cfg.get("autoscale_p99_ms", 0) or 0),
        busy_ratio=float(cfg.get("autoscale_busy_ratio", 0) or 0),
        staleness=float(cfg.get("autoscale_staleness", 0) or 0),
        send_queue=float(cfg.get("autoscale_sendq", 0) or 0))
    max_servers = int(cfg.get("autoscale_max_servers", 0) or 0)
    if max_servers <= 0:
        max_servers = len(ctl.sranks) + len(ctl.spares)
    acfg = AutoscaleConfig(
        slo=slo, window_s=float(cfg.get("autoscale_window_s", 2.0)),
        cooldown_s=float(cfg.get("autoscale_cooldown_s", 20.0)),
        flap_budget=int(cfg.get("autoscale_flap_budget", 3)),
        min_servers=int(cfg.get("autoscale_min_servers", 1)),
        max_servers=max_servers)
    return Autoscaler(ctl, acfg, sampler=HttpSampler(base_port(), nranks=size))


def _maybe_preemption(cfg: Config) -> Any:
    """A server's SIGTERM preemption notice under --elastic (installed in
    the child's main thread, where run_rank runs); None otherwise.  The handler only sets a flag; the checkpoint and the
    PREEMPT report run from the serving loop."""
    if not bool(cfg.get("elastic", False)):
        return None
    from mpit_tpu_torch.ft.elastic import PreemptionNotice

    return PreemptionNotice.from_env(
        default_grace_s=float(cfg.get("elastic_grace_s", 5.0))).install()


def _server_result(server: ParamServer, **extra: Any) -> Dict[str, Any]:
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
        "restored_applied": server.restored_applied,
        "restored_dedup": server.restored_dedup,
        "admitted": {f"{c}:{e}": v for (c, e), v in server.admitted.items()},
        "serving_since": server.serving_since,
        "rejoined_at": server.rejoined_at,
        "retired": server.retired,
        "owned_shards": server.owned_shards,
        **extra,
    }


def run_joiner_server(rank: int, cranks: List[int], cfg: Config,
                      transport: Any, ctl_rank: Optional[int]) -> Dict[str, Any]:
    """One controller-spawned joiner server (an --elastic spare slot, or a
    restarted elastic server): no INIT rendezvous, shards by ACQUIRE."""
    log = get_logger("launch", rank)
    ckpt_dir = str(cfg.get("server_ckpt_dir", "") or "")
    server = ParamServer(
        rank, cranks, transport, rule=server_rule_for(cfg), device=cfg.device,
        codec=str(cfg.codec or "") or None, ft=ft_from_cfg(cfg),
        ckpt_dir=ckpt_dir or None,
        ckpt_interval=float(cfg.get("server_ckpt_interval", 30.0)),
        controller_rank=ctl_rank, shardctl=True, preempt=_maybe_preemption(cfg))
    log.info("joiner server for clients %s (controller %s)", cranks, ctl_rank)
    server.start()
    return _server_result(server, joiner=True)


def run_controller(rank: int, size: int, np0: int, sranks: List[int],
                   cranks: List[int], cfg: Config, transport: Any) -> Dict[str, Any]:
    """The shard-map controller (the last rank of the initial membership):
    under --elastic it spawns spare slots through the supervisor's mailbox
    and marks retirements there before they exit."""
    from mpit_tpu_torch.shardctl import RebalancePolicy, ShardController

    elastic_on = bool(cfg.get("elastic", False))
    spawner = None
    retire_mark = None
    spares: List[int] = list(range(np0, size)) if elastic_on else []
    if elastic_on:
        from mpit_tpu_torch.ft.elastic import ElasticDirectory

        mailbox = ElasticDirectory.from_env()
        if mailbox is not None:
            def spawner(r: int) -> None:
                # Stamp the request with the live set, so the joiner's TCP
                # rendezvous dials only reachable peers.
                live = sorted(set(ctl._live_servers())
                              | {c for c in ctl.cranks if c not in ctl._stopped}
                              | {ctl.rank})
                mailbox.request_spawn(r, {
                    "MPIT_ELASTIC_DIAL": ",".join(str(x) for x in live if x < r)})

            retire_mark = mailbox.mark_retired
    ctl = ShardController(
        rank, transport, sranks, cranks,
        policy=RebalancePolicy(ratio=float(cfg.get("shardctl_ratio", 3.0))),
        lease_ttl_s=float(cfg.get("shardctl_lease_ttl_s", 0) or 0),
        spawner=spawner, spare_ranks=spares)
    if retire_mark is not None:
        # The supervisor must learn of a retirement before the rank's exit
        # reaches its restart budget: mark the mailbox first.
        scale_down = ctl.scale_down

        def scale_down_marked(r: int) -> bool:
            retire_mark(r)
            return scale_down(r)

        ctl.scale_down = scale_down_marked
    if bool(cfg.get("autoscale", False)):
        ctl.attach_autoscaler(_autoscaler_for(cfg, ctl, size))
    ctl.serve()
    out: Dict[str, Any] = {
        "role": "controller",
        "map_version": getattr(ctl.smap, "version", None),
        # the final map: (shard_id, offset, size, owner) per shard
        "map": ([[e.shard_id, e.shard.offset, e.shard.size, e.owner]
                 for e in ctl.smap.entries] if ctl.smap is not None else None),
        "rebalances": int(ctl._m_rebal.value),
        "failovers": int(ctl._m_fail.value),
        "membership_epoch": ctl.membership_epoch,
        "elastic_events": {"up": int(ctl._m_up.value),
                           "down": int(ctl._m_down.value),
                           "preempt": int(ctl._m_pre.value)},
    }
    if ctl.autoscaler is not None:
        out["autoscale"] = ctl.autoscaler.status_section()
    return out


def run_rank(rank: int, size: int, cfg: Config, transport: Any,
             data: Any = None) -> Dict[str, Any]:
    """Run one rank's role to completion; returns its result dict.  With
    ``size > 1`` the roles reach each other through ``transport``: this
    rank's endpoint of one router (a thread each), or of the shm or TCP
    wire (a process each).  A server's result holds its final shard
    (``param``) and a worker's its final ``w``, as tensors on the role's
    device."""
    cfg = LAUNCH_DEFAULTS.merged(cfg.to_dict())
    lm_on = bool(int(cfg.get("lm", 0) or 0))
    if size == 1:
        if bool(cfg.resume):
            # Server-shard resume needs servers; silently restarting from
            # scratch would look like a successful resume.
            raise ValueError("--resume restores parameter-server shards and "
                             "needs --np > 1 (single-process runs have no "
                             "servers)")
        if lm_on:
            from mpit_tpu_torch.lm import LmTrainer

            trainer = LmTrainer(lm_trainer_cfg(cfg), rank=rank)
            return {"role": "local", **trainer.run(), "w": trainer.w}
        trainer = MnistTrainer(cfg, data=data, rank=rank)
        return {"role": "local", **trainer.run()}
    lm_refusals(cfg)
    if transport is None:
        raise ValueError(f"run_rank at size {size} needs this rank's transport "
                         "(launch_processes, or run_gang in one process)")
    log = get_logger("launch", rank)
    elastic_on = bool(cfg.get("elastic", False))
    sc_on = bool(cfg.get("shardctl", False)) or elastic_on
    # Under --elastic the transport spans the provisioned ceiling
    # (np0 + spares); roles split over the initial membership np0, and the
    # ranks past it are joiner-server slots the controller may spawn.
    np0 = (int(cfg.get("elastic_np0", 0) or 0) or size) if elastic_on else size
    ctl_rank: Optional[int] = None
    role_size, cell_ranks, reader_ranks = read_path_ranks(size, cfg)
    if sc_on:
        if str(cfg.tester) != "none":
            raise ValueError("shardctl and a tester rank are mutually exclusive "
                             "for now (both claim an edge rank)")
        if np0 < 3:
            raise ValueError("shardctl needs np >= 3 (>= 1 server + >= 1 worker "
                             "+ the controller)")
        if float(cfg.get("ft_op_deadline_s", 0) or 0) <= 0:
            raise ValueError("shardctl needs --ft_op_deadline_s > 0: map "
                             "re-routing rides the FT retry machinery")
        ctl_rank = np0 - 1
        role_size = np0 - 1
    sranks, cranks, tester_rank = assign_roles(
        role_size, int(cfg.master_freq), str(cfg.tester))
    if cell_ranks and len(cell_ranks) < len(sranks):
        raise ValueError(f"cells={len(cell_ranks)} < {len(sranks)} servers: every "
                         "shard needs at least one replica cell")
    codec = str(cfg.codec or "") or None
    ft = ft_from_cfg(cfg)
    if rank in reader_ranks:
        return run_reader(rank, sranks, cfg, transport, cell_ranks=cell_ranks or None)
    if rank in cell_ranks:
        return run_cell(rank, sranks, cell_ranks, reader_ranks, cfg, transport)
    if elastic_on and rank >= np0:
        return run_joiner_server(rank, cranks, cfg, transport, ctl_rank)
    if sc_on and rank == ctl_rank:
        return run_controller(rank, size, np0, sranks, cranks, cfg, transport)
    if elastic_on and rank in sranks and rejoining():
        # A restarted server of an elastic gang rejoins as a joiner: its
        # shards failed over to survivors (shard checkpoints have no
        # server<rank> alias to resume from); the controller rebalances
        # onto it once its beats arm.
        return run_joiner_server(rank, cranks, cfg, transport, ctl_rank)
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
            ckpt_interval=float(cfg.server_ckpt_interval),
            controller_rank=ctl_rank, preempt=_maybe_preemption(cfg),
            # With a cell fabric the readers attach to the cells, not here:
            # the server's serving surface is one diff stream per cell.
            reader_ranks=None if cell_ranks else (reader_ranks or None),
            cell_ranks=cell_map_for(sranks, cell_ranks)[rank] if cell_ranks else None,
            serve=serve_cfg_for(cfg) if (reader_ranks and not cell_ranks) else None,
            dplane=dplane_cfg(cfg) if int(cfg.get("dplane", 0) or 0) else None)
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
        return _server_result(server, restored=bool(cfg.resume),
                              param=server.shard_value(),
                              busy_replies=server.busy_replies,
                              diffs_sent=server.diffs_sent,
                              snap_version=server._snap_version)
    # On resume the restored servers are authoritative for params — no
    # client re-seeds.  Same for a supervisor-restarted worker rejoining
    # mid-run: the live servers hold the current center, and a re-seed
    # would rewind it.
    pclient = ParamClient(
        rank, sranks, transport, codec=codec, ft=ft,
        seed_servers=(rank == cranks[0]) and not bool(cfg.resume)
        and not rejoining(),
        shardctl=sc_on, controller_rank=ctl_rank,
        sc_shards_per_server=(int(cfg.get("elastic_shards_per_server", 2) or 1)
                              if elastic_on else 1),
        # --lm: the weighted aligned-cut layout replaces the equal split on
        # the static path (shard control owns placement otherwise).
        layout=lm_layout(cfg, len(sranks)) if lm_on and not sc_on else None)
    client: Any = pclient
    if int(cfg.get("dplane", 0) or 0):
        from mpit_tpu_torch.dplane import ExchangeClient

        client = ExchangeClient(pclient, device=cfg.device,
                                namespace=str(cfg.get("namespace", "") or ""))
    agg_mode = str(cfg.get("agg", "off") or "off")
    if agg_mode != "off":
        from mpit_tpu_torch.agg import AggClient, AggConfig

        agg_refusals(cfg)
        client = AggClient(
            pclient, cranks,
            AggConfig(mode=agg_mode,
                      groups=parse_agg_groups(str(cfg.get("agg_groups", "") or "")),
                      fanin=int(cfg.get("agg_fanin", 2)),
                      tree_seed=int(cfg.get("agg_tree_seed", 0)),
                      deadline_s=float(cfg.get("agg_deadline_s", 5.0)),
                      chunk_bytes=int(cfg.get("agg_chunk_bytes", 0))),
            namespace=str(cfg.get("namespace", "") or ""), device=cfg.device)
    if lm_on:
        from mpit_tpu_torch.lm import LmTrainer

        trainer = LmTrainer(lm_trainer_cfg(cfg), pclient=client, rank=rank)
    else:
        trainer = MnistTrainer(cfg, pclient=client, data=data, rank=rank)
    log.info("worker with servers %s (epoch %d)", sranks, ft.epoch)
    out = trainer.run()
    if int(cfg.get("dplane", 0) or 0):
        out["device_ranks"] = client.device_ranks
    return {"role": "worker", **out, "w": trainer.w,
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
    elastic_on = bool(cfg.get("elastic", False))
    sc_on = bool(cfg.get("shardctl", False)) or elastic_on
    np0 = (int(cfg.get("elastic_np0", 0) or 0) or size) if elastic_on else size
    if elastic_on and rank >= np0:
        return "server"  # a spare joiner slot
    if sc_on and rank == np0 - 1:
        return "controller"
    n_readers = int(cfg.get("serve_readers", 0) or 0)
    n_cells = int(cfg.get("cells", 0) or 0)
    if n_readers and rank >= size - n_readers:
        return "reader"
    if n_cells and rank >= size - n_readers - n_cells:
        return "cell"
    try:
        sranks, _cranks, tester_rank = assign_roles(
            np0 - 1 if sc_on else size - n_readers - n_cells,
            int(cfg.get("master_freq", 2)), str(cfg.get("tester", "none")))
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
        # Under shard control the last rank of the initial membership is
        # the controller (a host role); spare joiner slots are servers.
        role_size = int(cfg.get("elastic_np0", 0) or 0) or size
        if bool(cfg.get("shardctl", False)) or bool(cfg.get("elastic", False)):
            role_size -= 1
        role_size -= (int(cfg.get("serve_readers", 0) or 0)
                      + int(cfg.get("cells", 0) or 0))
        _sranks, cranks, tester = assign_roles(
            role_size, int(cfg.get("master_freq", 2)), str(cfg.get("tester", "none")))
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
    in their stop protocol, and a composition the launcher refuses (--lm
    with a tester, --agg without op deadlines) or a missing card must not
    cost a gang's start-up."""
    cfg = LAUNCH_DEFAULTS.merged(cfg.to_dict())
    if int(cfg.get("lm", 0) or 0):
        from mpit_tpu_torch.lm import LmTrainer

        if cfg.opt not in LmTrainer.KNOWN_OPTS:
            raise ValueError(f"unknown LM optimizer {cfg.opt!r}; have "
                             f"{LmTrainer.KNOWN_OPTS}")
        lm_refusals(cfg)
    elif cfg.opt not in KNOWN_OPTS:
        raise ValueError(f"unknown optimizer {cfg.opt!r}; have {KNOWN_OPTS}")
    agg_refusals(cfg)
    if bool(cfg.autoscale):
        # --autoscale = --elastic + the closed loop on the controller, whose
        # telemetry rides the statusd endpoints: a controller sampling
        # nothing would never scale.
        from mpit_tpu_torch.obs.statusd import base_port

        if base_port() is None:
            raise ValueError(
                "--autoscale needs MPIT_OBS_HTTP=<base_port>: the autoscaler "
                "samples the gang through the statusd endpoints")
        if not any(float(cfg.get(k, 0) or 0) > 0 for k in (
                "autoscale_p99_ms", "autoscale_busy_ratio",
                "autoscale_staleness", "autoscale_sendq")):
            raise ValueError("--autoscale needs at least one SLO target "
                             "(--autoscale_p99_ms / _busy_ratio / _staleness "
                             "/ _sendq)")
        cfg = cfg.merged(elastic=True)
    size = int(cfg.np)
    role_size, cell_ranks, _reader_ranks = read_path_ranks(size, cfg)
    if bool(cfg.elastic):
        return _launch_elastic(cfg, timeout, chaos)
    sranks, _cranks, _tester = assign_roles(
        role_size - 1 if bool(cfg.shardctl) else role_size, int(cfg.master_freq),
        str(cfg.tester))
    if cell_ranks and len(cell_ranks) < len(sranks):
        raise ValueError(f"cells={len(cell_ranks)} < {len(sranks)} servers: every "
                         "shard needs at least one replica cell")
    if cell_ranks:
        cell_codec_for(cfg)
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


def _launch_elastic(cfg: Config, timeout: float,
                    chaos: Optional[Dict[str, Any]]) -> Dict[int, Dict[str, Any]]:
    """--elastic: shard control + the supervisor + the scale mailbox, over
    a provisioned rank space of np + elastic_spares.  Spare slots spawn
    only on the controller's request; membership changes never restart
    the gang."""
    import tempfile

    from mpit_tpu_torch.ft.elastic import ENV_DIR, ENV_GRACE_S, ElasticDirectory
    from mpit_tpu_torch.ft.supervisor import RestartPolicy, supervise_gang

    restarts = int(cfg.supervise)
    if restarts <= 0:
        raise ValueError("--elastic needs --supervise >= 1: the supervisor is "
                         "what spawns and retires ranks")
    if not str(cfg.server_ckpt_dir or ""):
        raise ValueError("--elastic needs --server_ckpt_dir: checkpoint-on-"
                         "notice and shard failover write there")
    if float(cfg.ft_op_deadline_s or 0) <= 0:
        raise ValueError("--elastic needs --ft_op_deadline_s > 0: membership "
                         "changes ride the retry machinery")
    np0 = int(cfg.np)
    spares = max(int(cfg.elastic_spares or 0), 0)
    total = np0 + spares
    cfg = cfg.merged(np=total, elastic_np0=np0, shardctl=True)
    if spares > 0:
        cfg = cfg.merged(gang_barrier=False)  # spare slots are not running yet
    if cfg.transport == "tcp":
        addrs = [a for a in str(cfg.tcp_addrs).split(",") if a]
        if len(addrs) != total:
            raise ValueError(f"--elastic over tcp needs {total} tcp_addrs "
                             f"(np + elastic_spares), got {len(addrs)}")
    sranks, _cranks, _tester = assign_roles(np0 - 1, int(cfg.master_freq), "none")
    overrides = device_env_overrides(cfg, total)
    if len(overrides) < total:
        resolve_device(cfg.device)
    mailbox = ElasticDirectory(tempfile.mkdtemp(prefix="mpit_elastic_"))
    env = supervised_env(cfg, overrides)
    for r in range(total):
        env[r][ENV_DIR] = str(mailbox.root)
        env[r][ENV_GRACE_S] = str(float(cfg.elastic_grace_s))
        if cfg.transport == "tcp":
            # Spares and rejoiners come in through the transport's accept
            # service: every rank agrees on reconnect mode.
            env[r].setdefault("MPIT_TCP_RECONNECT_S",
                              os.environ.get("MPIT_TCP_RECONNECT_S", "60"))
    return supervise_gang(
        "mpit_tpu_torch.train.launch", cfg, timeout,
        policy=RestartPolicy(max_restarts=restarts), env_overrides=env,
        server_ranks=sranks + list(range(np0, total)), initial_ranks=range(np0),
        elastic_dir=mailbox, **(chaos or {}))


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


def child_result(result: Dict[str, Any], device: torch.device,
                 lm: bool = False) -> Dict[str, Any]:
    """A rank's result as JSON: each tensor becomes ``<key>_sha256`` (its
    bytes' digest, enough to hold two runs bit for bit), and the result
    gains ``platform`` (the device its role ran on) and the rank's
    ``launches`` of K1-K3, which the parent cannot read in the child — and
    of the flash kernels K4-K6 in an LM gang (``lm``)."""
    from mpit_tpu_torch.ops import fused_update as fu

    out = {k: v for k, v in result.items() if not isinstance(v, torch.Tensor)}
    for k, v in result.items():
        if isinstance(v, torch.Tensor):
            out[f"{k}_sha256"] = _sha256(v)
    out["platform"] = device.type
    out["launches"] = {"k1": fu.fused_nesterov_commit.launches,
                       "k2": fu.fused_elastic.launches,
                       "k3": fu.fused_adam.launches}
    if lm:
        import importlib

        fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
        out["launches"].update(k4=fa.flash_fwd.launches, k5=fa.flash_bwd_fused.launches,
                               k6=fa.flash_bwd_two_kernel.launches)
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
    # Readers and cells are host roles: they hold nothing on a device and
    # never make a CUDA context.
    device = (torch.device("cpu") if role in ("reader", "cell")
              else resolve_device(cfg.device))
    transport = child_transport(cfg, rank, size)
    result = run_rank(rank, size, cfg, transport)
    transport.close()
    # This rank's Chrome-trace part (MPIT_OBS_TRACE; no-op when unset): the
    # gang parent merges the parts into one timeline at exit.
    maybe_write_rank_trace(rank, role=str(result.get("role", "")))
    write_result(child_result(result, device, lm=bool(int(cfg.get("lm", 0) or 0))))


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
            "evictions", "ckpts_written", "restored", "restarts",
            "map_version", "membership_epoch", "elastic_events", "retired",
            "owned_shards", "joiner", "reads", "monotone", "busy_honored",
            "lags", "failovers", "diffs_installed", "busy_replies",
            "final_loss", "final_eval_loss", "tokens_per_s", "tokens_total"}
    return {k: v for k, v in result.items() if k in keep}


if __name__ == "__main__":
    main()
