"""On-device MNIST training CLI — the port of
``mpit_tpu/train/mesh_launch.py``.

Two trainers on one CUDA card: EASGD, every worker row and the center on
the card (:class:`mpit_tpu_torch.parallel.MeshEASGD`), and synchronous
data parallel, one gradient of the global batch a step
(``--opt syncdp``, :class:`mpit_tpu_torch.parallel.SyncDataParallel`).
Each is trained to a target test error with wall-clock-to-target and
samples/s reported under the reference's result keys.  The data order is
the reference's (``np.random.default_rng(seed)`` permutations), so a run
with the same ``w0`` follows the same batches in both packages.

``--device_loop 1`` trains every epoch from captured CUDA graphs, with no
host round trip inside an epoch (:func:`_device_loop_train`).

``--ckpt_dir`` saves the trainer's whole state every ``ckpt_every``
epochs, and ``--resume auto`` (or a path) continues from it: the JAX
package's npz layout and state keys (``w``, ``vt``, ``k``, ``center``), so
a checkpoint of either package resumes in the other.  Resuming burns the
skipped epochs' permutations, so the data order continues, and carries
the earlier runs' seconds into ``time_to_target``.  EASGD's sync schedule
continues under ``--device_stream 1`` and restarts under the per-batch
host loop, as the reference's staged scan and its ``step`` do.  The reference's orbax
``step_*`` checkpoints (a multi-process mesh's) raise ``NotImplementedError``:
restoring one needs orbax, which the card's machine does not have.

``--dp`` and ``--shard`` are virtual ranks of the card
(:mod:`mpit_tpu_torch.parallel.mesh`): worker rows, and the column cuts
whose owners take the pushes.  The multi-host flags go through
:func:`mpit_tpu_torch.parallel.distributed.bootstrap` and form a group of
any size (gloo on the CPU; on the card NCCL where each process has a card
of its own, gloo where processes share one; the result's ``backend``
says which).  Over ``P`` processes ``--dp`` (default ``P``) is cut across
them in contiguous blocks, the JAX package's layout: every process draws
the same seeded global shuffle and feeds only its rows
(:func:`~mpit_tpu_torch.parallel.mesh.process_local_rows`: its block of
the ``dp`` worker rows under EASGD, of the global batch under
``syncdp``), the exchange and the gradient gather the other processes'
blocks, and every process evaluates the replicated center (EASGD) or
weights (``syncdp``).  A checkpoint of a group is the one-process layout
at the same ``dp``, gathered to process 0, which writes it between the
gather and a barrier; every process resumes from it and takes its rows,
and a one-process run at that ``dp``, of either package, resumes it too.
``--device_loop 1`` is one process's, as in the JAX package.

Runs on CUDA unless ``--device cpu``.

Example:

    python -m mpit_tpu_torch.train.mesh_launch --opt easgd --su 10 \
        --epochs 10 --device_stream 1 --precompile 1
    python -m mpit_tpu_torch.train.mesh_launch --opt syncdp --lr 0.2 \
        --mom 0.9 --epochs 2 --ckpt_dir ck
    python -m mpit_tpu_torch.train.mesh_launch --opt syncdp --lr 0.2 \
        --mom 0.9 --epochs 4 --ckpt_dir ck --resume auto
    python -m mpit_tpu_torch.train.mesh_launch --device_loop 1 \
        --stop_at_target 1 --target_test_err 0.02
"""

from __future__ import annotations

import json
import pathlib
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from mpit_tpu_torch.data.mnist import load_mnist
from mpit_tpu_torch.models.flat import (
    error_rate, flatten_module, value_and_grad_nll, value_and_grad_nll_eager)
from mpit_tpu_torch.models.mnist import make_model
from mpit_tpu_torch.obs.timers import profiler_trace, trace_annotation
from mpit_tpu_torch.optim.msgd import MSGDConfig
from mpit_tpu_torch.parallel.collective import gather
from mpit_tpu_torch.parallel.distributed import (
    barrier, bootstrap_launcher, launcher_processes, shutdown)
from mpit_tpu_torch.parallel.easgd import MeshEASGD
from mpit_tpu_torch.parallel.mesh import (
    check_split, make_mesh, process_local_rows, put_global, put_local)
from mpit_tpu_torch.parallel.sync_dp import SyncDataParallel
from mpit_tpu_torch.utils.checkpoint import (
    latest_pytree_step, load_state_dict, save_state_dict_group)
from mpit_tpu_torch.utils.config import Config
from mpit_tpu_torch.utils.logging import get_logger
from mpit_tpu_torch.utils.platform import device_name, resolve_device
from mpit_tpu_torch.utils.timing import timed_chained

MESH_LAUNCH_DEFAULTS = Config(
    model="cnn",  # linear | mlp | cnn
    opt="easgd",  # easgd | syncdp
    lr=1e-2,
    mom=0.99,
    mommax=1.0,
    momdecay=0.0,
    l2wd=0.0,
    mva=0.0,  # 0 -> beta/p with beta=0.9 (mlaunch.lua:42)
    su=10,
    epochs=10,
    batch=128,  # per-worker batch (easgd) / global batch (syncdp)
    seed=1,
    side=32,
    dp=0,  # 0 -> 1: worker rows, virtual ranks of the card
    shard=0,  # 0 -> 1: column cuts of the parameters, virtual ranks of the card
    target_test_err=0.01,
    stop_at_target=0,  # 1 -> stop training once target_test_err is reached
    device_stream=0,  # 1 -> stage each epoch's batches on device up front
    device_loop=0,  # 1 -> every epoch one CUDA-graph replay (_device_loop_train)
    measure_throughput=0,  # 1 -> post-training steady-state samples/s leg
    ckpt_dir="",  # save the trainer's whole state every ckpt_every epochs
    ckpt_every=1,
    resume="",  # path to a mesh_*.npz, or "auto": <ckpt_dir>/mesh_latest.npz
    profile_dir="",  # torch.profiler trace of the epoch loop when set
    precompile=0,  # 1 -> warm the step and eval paths before t0
    device="cuda",  # cuda | cpu
    # multi-host bootstrap: dp is cut across the group's processes
    hostfile="",
    coordinator="",
    num_processes=0,
    process_id=-1,
)

# The flagship benchmark training config (mlaunch.lua:39-47 analog), the
# reference's FLAGSHIP_BENCH_KWARGS.
FLAGSHIP_BENCH_KWARGS = dict(
    opt="easgd", model="cnn", batch=128, side=32,
    su=10, mom=0.99, lr=1e-2, device_stream=1, precompile=1,
)


def _check_opt(cfg: Config) -> None:
    if cfg.opt not in ("easgd", "syncdp"):
        raise ValueError(f"opt must be easgd|syncdp, got {cfg.opt!r}")


def _device_loop_train(*, cfg, trainer, state, flat, rng, x_train, y_train,
                       x_test_d, y_test_d, steps_per_epoch, per_step, lead,
                       device, log):
    """Train-to-target with no host round trip inside an epoch: the port of
    the reference's ``_device_loop_train``, whose one ``lax.while_loop``
    program becomes one CUDA graph an epoch.

    The training set goes to the device once, and every epoch's order
    (the host loop's own ``rng.permutation``, all epochs drawn up front)
    in one ``(epochs, steps * dp * batch)`` index tensor.  An epoch's body
    gathers its batches by index (``lead`` is a step's batch shape:
    ``(dp, batch)`` for EASGD, ``(batch,)`` for sync-DP), runs
    ``steps_per_epoch`` trainer steps (K1 launched on the capturing
    stream), and writes the evaluated parameters' test error (EASGD's
    center, sync-DP's ``w``) and the epoch's mean loss into
    ``errs[ep]`` and ``losses[ep]`` on the device; a device counter ``ep``
    picks the epoch, so one graph serves every epoch that starts at the
    same phase of the sync schedule.  The schedule is host-side
    (``steps % su``), so there is one graph per starting phase (at most
    ``su``; sync-DP has one phase, so one graph), all captured before the
    clock starts, after a warm-up on
    copies (cuDNN's and cuBLAS's first calls), into one memory pool: only
    temporaries live there, and the graphs replay one at a time.
    ``stop_at_target`` reads ``errs[ep]`` (4 bytes) after each replay, the
    counterpart of the ``while_loop``'s condition; otherwise every replay
    is queued and the buffers are read once at the end.  On the CPU the
    same body runs eagerly; on a card it always runs from the graphs, and
    a capture or replay that fails raises.

    Trade-offs, against the reference's: the reference shuffles with
    ``jax.random`` and is not bit-comparable with its host loop; this one
    takes the host loop's order, so it trains bit for bit as
    ``device_stream=1``'s host loop does.  As there, only the last epoch's
    wall time is real, and mid-run checkpoint and profiling hooks cannot
    fire.

    Returns the history, ``time_to_target``, the warm-up and capture
    seconds, the wall, the samples trained, ``t0`` and what ran: the
    graphs, each with its starting phase, its steps and its replays, and
    the steps the warm-up ran on copies.
    """
    n = len(x_train)
    spe, epochs = steps_per_epoch, int(cfg.epochs)
    take = spe * per_step
    orders = np.stack([rng.permutation(n)[:take] for _ in range(epochs)])
    x_all = torch.as_tensor(np.asarray(x_train, np.float32).reshape(n, -1), device=device)
    y_all = torch.as_tensor(np.asarray(y_train).astype(np.int64), device=device)
    orders_d = torch.as_tensor(orders.astype(np.int64), device=device)
    ep_d = torch.zeros(1, dtype=torch.int64, device=device)
    errs = torch.full((epochs,), float("inf"), device=device)
    losses = torch.zeros(epochs, device=device)
    bufs = (ep_d, errs, losses)

    def epoch_body(st, ep, errs, losses):
        idx = orders_d.index_select(0, ep).view(-1)
        x_ep = x_all.index_select(0, idx).view(spe, *lead, -1)
        y_ep = y_all.index_select(0, idx).view(spe, *lead)
        _, ep_losses = trainer.run_epoch(st, x_ep, y_ep)
        losses.index_copy_(0, ep, ep_losses.mean().view(1))
        err = error_rate(flat, trainer.eval_params(st), x_test_d, y_test_d)
        errs.index_copy_(0, ep, err.view(1))
        ep.add_(1)

    graphs = {}
    warmup_steps = 0
    t_c = time.perf_counter()
    if device.type == "cuda":
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            warmup_steps = trainer.precompile(state, x_all[:per_step].view(*lead, -1),
                                              y_all[:per_step].view(*lead))
            epoch_body({k: v.clone() for k, v in state.items()},
                       *(b.clone() for b in bufs))
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
        warmup_steps += spe  # precompile's steps (EASGD: a sync and a local), one epoch
        pool = torch.cuda.graph_pool_handle()
        for phase in sorted({ep * spe % trainer.su for ep in range(epochs)}):
            trainer.set_steps(phase)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                epoch_body(state, *bufs)
            graphs[phase] = {"graph": graph, "phase": phase, "steps": spe, "replays": 0}
        trainer.set_steps(0)
    compile_s = time.perf_counter() - t_c
    log.info("device-loop: %d graph(s) captured in %.2fs", len(graphs), compile_s)

    t0 = time.perf_counter()
    ran = 0
    while ran < epochs:
        if graphs:
            g = graphs[ran * spe % trainer.su]
            g["graph"].replay()
            g["replays"] += 1
        else:
            epoch_body(state, *bufs)
        ran += 1
        if cfg.stop_at_target and float(errs[ran - 1]) <= cfg.target_test_err:
            break
    errs_h, losses_h = errs.cpu().numpy(), losses.cpu().numpy()  # fences the run
    wall = time.perf_counter() - t0
    # The schedule's host counter did not move during the replays.
    trainer.set_steps(ran * spe)

    history = [{"epoch": i, "avg_loss": float(losses_h[i]), "test_err": float(errs_h[i]),
                # Only the last epoch's wall time is real.
                "at": round(wall, 3) if i == ran - 1 else None}
               for i in range(ran)]
    for h in history:
        log.info("epoch %d avg_loss %.5f test_err %.4f",
                 h["epoch"], h["avg_loss"], h["test_err"])
    hits = [h["test_err"] <= cfg.target_test_err for h in history]
    # No per-epoch wall time exists, so a target met mid-run has none to
    # report: time_to_target is the wall only where the run stopped at it.
    time_to_target = wall if cfg.stop_at_target and hits and hits[-1] else None
    if not cfg.stop_at_target and any(hits):
        log.warning(
            "device_loop: target %.4f was reached mid-run but stop_at_target=0; "
            "no per-epoch wall times exist, so time_to_target stays None (use "
            "stop_at_target=1 or the host loop to measure it)", cfg.target_test_err)
    log.info("device-loop: %d epoch(s) in %.3fs wall", ran, wall)
    ran_info = {
        "captured": bool(graphs),
        "warmup_steps": warmup_steps,
        "graphs": [{k: v for k, v in g.items() if k != "graph"} for g in graphs.values()],
    }
    return history, time_to_target, compile_s, wall, ran * take, t0, ran_info


def _resume(cfg: Config, trainer, state, log):
    """Load ``cfg.resume`` into ``state`` in place, with the reference's
    guards (the state's keys and shapes, ``opt``, ``seed``); returns the
    epoch to start at and the earlier runs' training seconds.  The file
    holds the one-process layout: this process takes its block of the
    trainer's ``row_keys``."""
    resume_path = cfg.resume
    if resume_path == "auto":
        ckpt_dir = pathlib.Path(cfg.ckpt_dir)
        npz_latest = ckpt_dir / "mesh_latest.npz"
        step = latest_pytree_step(ckpt_dir)
        # The reference resumes the newest artifact of a mixed directory:
        # an orbax step newer than the npz is a multi-process mesh's.
        if step is not None and not (
                npz_latest.exists()
                and npz_latest.stat().st_mtime > (ckpt_dir / f"step_{step}").stat().st_mtime):
            raise NotImplementedError(
                f"{ckpt_dir}/step_{step} is an orbax checkpoint of a multi-process "
                "mesh: restoring it needs orbax, which the card's machine does not "
                "have (the port resumes the npz checkpoints, mesh_latest.npz)")
        resume_path = str(npz_latest)
    saved, meta = load_state_dict(resume_path)
    if set(saved) != set(state):
        raise ValueError(
            f"checkpoint keys {sorted(saved)} do not match trainer state "
            f"{sorted(state)} — wrong --opt or model?")
    mesh = trainer.mesh
    rows = {key: mesh.local_slice("dp") for key in trainer.row_keys}
    for key, arr in saved.items():
        want = tuple(state[key].shape)
        if key in rows:
            want = (mesh.size("dp"),) + want[1:]
        if tuple(arr.shape) != want:
            raise ValueError(
                f"checkpoint {key} shape {tuple(arr.shape)} != trainer "
                f"{want} (different mesh/model?)")
    if meta.get("opt", cfg.opt) != cfg.opt:
        raise ValueError(f"checkpoint was trained with --opt {meta['opt']}, not {cfg.opt}")
    if "seed" in meta and int(meta["seed"]) != int(cfg.seed):
        raise ValueError(
            f"checkpoint was trained with --seed {meta['seed']}, resuming with "
            f"--seed {cfg.seed} would silently diverge the data order — pass the "
            "original seed")
    for key, arr in saved.items():
        whole = put_global(arr, mesh)
        state[key].copy_(whole[rows[key]] if key in rows else whole)
    start_epoch = int(meta.get("epoch", -1)) + 1
    prev_elapsed = float(meta.get("elapsed", 0.0))
    log.info("resumed from %s at epoch %d (%.1fs of prior training)",
             resume_path, start_epoch, prev_elapsed)
    return start_epoch, prev_elapsed


def run(cfg: Config) -> dict:
    if cfg.device_loop and (cfg.ckpt_dir or cfg.resume or cfg.profile_dir):
        raise ValueError(
            "device_loop=1 runs every epoch from a captured CUDA graph: there are "
            "no host epoch boundaries for checkpointing, resume, or per-epoch "
            "profiling; use the host loop for ckpt_dir/resume/profile_dir")
    _check_opt(cfg)
    if cfg.resume == "auto" and not cfg.ckpt_dir:
        raise ValueError("--resume auto requires --ckpt_dir")
    device = resolve_device(cfg.device)
    processes = launcher_processes(cfg)  # checked before any rendezvous
    if cfg.device_loop and processes > 1:
        raise ValueError(
            "device_loop=1 is single-process: the epoch body gathers epoch batches "
            "from the replicated dataset, which multi-host feeding (process-local "
            "rows) cannot express")
    if cfg.measure_throughput and processes > 1:
        raise ValueError(
            "measure_throughput is single-process: each process would pick its own "
            "count of timed passes, and their collectives would not pair up")
    if cfg.measure_throughput and device.type != "cuda":
        raise ValueError("measure_throughput times the card (CUDA events); "
                         "a CPU run has no device time to report")
    check_split({"dp": cfg.dp or processes, "shard": cfg.shard or 1}, processes)
    pg = bootstrap_launcher(cfg, device.type)
    device = resolve_device(cfg.device)  # the card bootstrap took, on the card
    try:
        return _train(cfg, device, pg)
    finally:
        if pg.coordinator is not None:  # the group this run formed
            shutdown()


def _train(cfg: Config, device: torch.device, pg) -> dict:
    log = get_logger("mesh", pg.process_id)
    log.info("%s", pg.describe())
    mesh = make_mesh(dp=cfg.dp or None, shard=cfg.shard or None, device=device, group=pg)
    n_dp = mesh.shape["dp"]
    log.info("mesh: dp=%d shard=%d on %s (%s)", n_dp, mesh.shape["shard"], device,
             device_name(device))

    (x_train, y_train, x_test, y_test), source = load_mnist(side=cfg.side)
    log.info("data source: %s", source)
    x_test_d = torch.as_tensor(x_test, dtype=torch.float32, device=device)
    y_test_d = torch.as_tensor(y_test, dtype=torch.int64, device=device)

    flat = flatten_module(make_model(cfg.model, cfg.side), cfg.seed, device)
    log.info("flat params: %d", flat.size)
    msgd = MSGDConfig(
        lr=cfg.lr, mom=cfg.mom, mommax=cfg.mommax, momdecay=cfg.momdecay,
        l2wd=cfg.l2wd,
    )
    n = len(x_train)
    if cfg.opt == "easgd":
        mva = cfg.mva or 0.9 / max(n_dp, 1)
        trainer = MeshEASGD(mesh, value_and_grad_nll(flat), msgd, mva=mva, su=cfg.su)
        # Per-worker disjoint streams (goot.lua:129-146).
        lead, per_step = (n_dp, cfg.batch), n_dp * cfg.batch
    else:
        trainer = SyncDataParallel(mesh, value_and_grad_nll_eager(flat), msgd)
        trainer.check_batch(cfg.batch)
        lead, per_step = (cfg.batch,), cfg.batch
    state = trainer.init(flat.w0)

    start_epoch, prev_elapsed = 0, 0.0
    if cfg.resume:
        start_epoch, prev_elapsed = _resume(cfg, trainer, state, log)

    def test_err() -> float:
        return float(error_rate(flat, trainer.eval_params(state), x_test_d, y_test_d))

    if n < per_step:
        raise ValueError(
            f"dataset has {n} samples but one global step needs {per_step} "
            f"({'dp x batch' if cfg.opt == 'easgd' else 'batch'}); lower --batch "
            "or --dp"
        )
    steps_per_epoch = n // per_step
    # The EASGD sync schedule on a resume, as the reference's: its staged
    # epochs (device_stream, a scan) read the schedule from the restored
    # step counter and continue it; its per-batch host loop counts from
    # this process's first step and restarts it.
    if cfg.device_stream:
        trainer.set_steps(start_epoch * steps_per_epoch)
    # Every process draws the global batch and feeds its rows of the
    # leading axis: its worker rows (EASGD), its rows of the batch (sync-DP).
    rows = process_local_rows(mesh, lead[0])

    def to_device(idx, steps=()):
        cut = (slice(None),) * len(steps) + (rows,)
        x = np.ascontiguousarray(x_train[idx].reshape(*steps, *lead, -1)[cut], np.float32)
        y = y_train[idx].reshape(*steps, *lead)[cut].astype(np.int64)
        return put_local(x, mesh), put_local(y, mesh)

    def stage_epoch(idx, nsteps=None):
        """One device placement of a shuffled epoch, ``(nsteps, *lead,
        ...)``."""
        return to_device(idx, (steps_per_epoch if nsteps is None else nsteps,))

    rng = np.random.default_rng(cfg.seed)
    history: List[dict] = []
    time_to_target: Optional[float] = None
    epoch_train_s: List[float] = []
    samples_trained = 0

    compile_s = None
    loop_info = None
    if cfg.device_loop:
        (history, time_to_target, compile_s, wall, samples_trained, t0,
         loop_info) = _device_loop_train(
            cfg=cfg, trainer=trainer, state=state, flat=flat, rng=rng,
            x_train=x_train, y_train=y_train, x_test_d=x_test_d, y_test_d=y_test_d,
            steps_per_epoch=steps_per_epoch, per_step=per_step, lead=lead,
            device=device, log=log)
        epoch_train_s = [wall]
    elif cfg.precompile:
        # Warm both step kinds and the eval on the real shapes, so t0
        # measures training; reported separately as compile_s.
        t_c = time.perf_counter()
        if cfg.device_stream:
            x_w, y_w = stage_epoch(np.arange(per_step), nsteps=1)
            warm = (x_w[0], y_w[0])
        else:
            warm = to_device(np.arange(per_step))
        trainer.precompile(state, *warm)
        test_err()
        compile_s = time.perf_counter() - t_c
        log.info("precompile: %.2fs (step + eval paths warm)", compile_s)

    worker_rows = gather(mesh, "dp")

    def train_epoch(order):
        if cfg.device_stream:
            x_ep, y_ep = stage_epoch(order[: steps_per_epoch * per_step])
            losses = trainer.run_epoch(state, x_ep, y_ep)[1]
        else:
            losses = torch.stack([
                trainer.step(state, *to_device(order[step * per_step:(step + 1) * per_step]))[1]
                for step in range(steps_per_epoch)])
        if trainer.row_keys:  # (steps, worker rows): every process's rows
            losses = worker_rows(losses.t()).t().contiguous()
        return losses

    def whole_state():
        """The state in the one-process layout: every process's rows."""
        return {k: worker_rows(v) if k in trainer.row_keys else v for k, v in state.items()}

    if not cfg.device_loop:
        t0 = time.perf_counter()  # the device loop sets its own
    # Resume: burn the skipped epochs' permutations, so the data order
    # continues where the checkpointed run left it.
    for _ in range(start_epoch):
        rng.permutation(n)
    with profiler_trace(cfg.profile_dir):
        for epoch in range(start_epoch, 0 if cfg.device_loop else cfg.epochs):
            order = rng.permutation(n)
            t_ep = time.perf_counter()
            with trace_annotation(f"epoch {epoch}"):
                avg_loss = float(train_epoch(order).mean())  # fences the epoch
            epoch_train_s.append(time.perf_counter() - t_ep)
            samples_trained += steps_per_epoch * per_step
            err = test_err()
            # Cumulative across resumes (the reference's prevtime
            # convention), so time_to_target counts from the first start.
            at = time.perf_counter() - t0 + prev_elapsed
            if time_to_target is None and err <= cfg.target_test_err:
                time_to_target = at
            history.append({
                "epoch": epoch, "avg_loss": avg_loss,
                "test_err": err, "at": round(at, 3),
            })
            log.info("epoch %d avg_loss %.5f test_err %.4f (%.1fs)",
                     epoch, avg_loss, err, at)
            if cfg.ckpt_dir and (epoch + 1) % max(int(cfg.ckpt_every), 1) == 0:
                path = save_state_dict_group(
                    cfg.ckpt_dir, whole_state(),
                    meta={"epoch": epoch, "opt": cfg.opt, "test_err": err,
                          "seed": cfg.seed, "elapsed": round(at, 3)},
                    process_id=pg.process_id, barrier=barrier)
                log.info("checkpoint: %s", path or "written by process 0")
            if cfg.stop_at_target and time_to_target is not None:
                break
    train_time = sum(epoch_train_s)
    per_epoch = steps_per_epoch * per_step
    if cfg.device_loop:
        # One wall over every epoch, the on-device eval included: not the
        # host loop's definition (train_wall_mode says which).
        sps = samples_trained / train_time if train_time > 0 else None
    else:
        # Wall-clock throughput: drop epoch 0 (first launches, cuDNN's
        # algorithm search) when there is anything else to measure.
        ss = epoch_train_s[1:] if len(epoch_train_s) > 1 else epoch_train_s
        sps = len(ss) * per_epoch / sum(ss) if ss and sum(ss) > 0 else None

    sps_steady = None
    if cfg.measure_throughput:
        # Steady-state rate: whole passes over one freshly shuffled epoch
        # on the device, timed by CUDA events (utils.timing); every step
        # sees a different batch, and the passes train the state on.
        x_ep, y_ep = stage_epoch(rng.permutation(n)[: steps_per_epoch * per_step])

        def one_pass(st):
            st, _losses = trainer.run_epoch(st, x_ep, y_ep)
            return st

        per_pass = timed_chained(
            one_pass, state, iters=4, base_iters=1, repeats=3,
            auto_scale=True, min_ratio=8.0, max_iters=128,
        )
        sps_steady = per_epoch / per_pass
    return {
        "history": history,
        "final_test_err": history[-1]["test_err"] if history else None,
        "time_to_target": time_to_target,
        "elapsed": time.perf_counter() - t0 + prev_elapsed,
        "train_time": round(train_time, 3),
        "samples_trained": samples_trained,
        "samples_per_sec": round(sps, 1) if sps else None,
        "samples_per_sec_steady": round(sps_steady, 1) if sps_steady else None,
        # Which wall fed samples_per_sec: "device_loop" includes the
        # on-device eval; "host_loop" times training only.
        "train_wall_mode": "device_loop" if cfg.device_loop else "host_loop",
        "compile_s": round(compile_s, 3) if compile_s is not None else None,
        "data_source": source,
        "mesh": dict(mesh.shape),
        "processes": pg.num_processes,
        # The group's backend (nccl | gloo), None where no group was formed.
        "backend": pg.backend,
        "device": str(state["w"].device),
        "device_name": device_name(device),
        # Training steps, counted from the first start across resumes, the
        # throughput leg's passes included (precompile's warm-up steps run
        # on copies and are not counted).
        "steps": trainer.steps,
        # device_loop: the captured graphs (phase, steps, replays) and the
        # warm-up's steps on copies; None for the host loop.
        "device_loop": loop_info,
        # The final trainer state, this process's rows of the row keys
        # (main leaves it out of its JSON).
        "state": state,
    }


def main(argv: Optional[List[str]] = None) -> dict:
    cfg = MESH_LAUNCH_DEFAULTS.parse_args(
        list(sys.argv[1:] if argv is None else argv)
    )
    result = run(cfg)
    print(json.dumps({k: v for k, v in result.items() if k != "state"}, indent=2))
    return result


if __name__ == "__main__":
    main()
