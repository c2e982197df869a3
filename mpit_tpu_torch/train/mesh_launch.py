"""On-device EASGD MNIST training CLI — the port of
``mpit_tpu/train/mesh_launch.py``.

All worker rows and the center live on one CUDA card
(:class:`mpit_tpu_torch.parallel.MeshEASGD`), trained to a target test
error with wall-clock-to-target and samples/s reported under the
reference's result keys.  The data order is the reference's
(``np.random.default_rng(seed)`` permutations), so a run with the same
``w0`` follows the same batches in both packages.

``--device_loop 1`` trains every epoch from captured CUDA graphs, with no
host round trip inside an epoch (:func:`_device_loop_train`).

Runs on CUDA unless ``--device cpu``.  What the reference has and this
slice does not (``--opt syncdp``, checkpoints and resume, multi-host
groups) raises ``NotImplementedError``.

Example:

    python -m mpit_tpu_torch.train.mesh_launch --opt easgd --su 10 \
        --epochs 10 --device_stream 1 --precompile 1
    python -m mpit_tpu_torch.train.mesh_launch --device_loop 1 \
        --stop_at_target 1 --target_test_err 0.02
"""

from __future__ import annotations

import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from mpit_tpu_torch.data.mnist import load_mnist
from mpit_tpu_torch.models.flat import error_rate, flatten_module, value_and_grad_nll
from mpit_tpu_torch.models.mnist import make_model
from mpit_tpu_torch.obs.timers import profiler_trace, trace_annotation
from mpit_tpu_torch.optim.msgd import MSGDConfig
from mpit_tpu_torch.parallel.easgd import MeshEASGD
from mpit_tpu_torch.parallel.mesh import make_mesh
from mpit_tpu_torch.utils.config import Config
from mpit_tpu_torch.utils.logging import get_logger
from mpit_tpu_torch.utils.platform import device_name, resolve_device
from mpit_tpu_torch.utils.timing import timed_chained

MESH_LAUNCH_DEFAULTS = Config(
    model="cnn",  # linear | mlp | cnn
    opt="easgd",  # easgd (syncdp: a later slice)
    lr=1e-2,
    mom=0.99,
    mommax=1.0,
    momdecay=0.0,
    l2wd=0.0,
    mva=0.0,  # 0 -> beta/p with beta=0.9 (mlaunch.lua:42)
    su=10,
    epochs=10,
    batch=128,  # per-worker batch
    seed=1,
    side=32,
    dp=0,  # 0 -> 1: one worker row per device, and the mesh has one device
    shard=0,
    target_test_err=0.01,
    stop_at_target=0,  # 1 -> stop training once target_test_err is reached
    device_stream=0,  # 1 -> stage each epoch's batches on device up front
    device_loop=0,  # 1 -> every epoch one CUDA-graph replay (_device_loop_train)
    measure_throughput=0,  # 1 -> post-training steady-state samples/s leg
    ckpt_dir="",  # a later slice; set raises
    resume="",  # a later slice; set raises
    profile_dir="",  # torch.profiler trace of the epoch loop when set
    precompile=0,  # 1 -> warm the step and eval paths before t0
    device="cuda",  # cuda | cpu
    # multi-host bootstrap: a later slice; any set raises
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


def _refuse_later_slices(cfg: Config) -> None:
    later = {
        "opt=syncdp": (cfg.opt == "syncdp", "the sync data-parallel trainer"),
        "ckpt_dir": (bool(cfg.ckpt_dir), "checkpoint/resume"),
        "resume": (bool(cfg.resume), "checkpoint/resume"),
        "multi-host flags": (
            bool(cfg.hostfile or cfg.coordinator or cfg.num_processes > 1
                 or cfg.process_id >= 0),
            "multi-host process groups"),
    }
    for flag, (is_set, slice_name) in later.items():
        if is_set:
            raise NotImplementedError(
                f"{flag}: {slice_name} is a later slice of the port")
    if cfg.opt != "easgd":
        raise ValueError(f"opt must be easgd, got {cfg.opt!r}")


def _device_loop_train(*, cfg, trainer, state, flat, rng, x_train, y_train,
                       x_test_d, y_test_d, steps_per_epoch, per_step, n_dp,
                       device, log):
    """Train-to-target with no host round trip inside an epoch: the port of
    the reference's ``_device_loop_train``, whose one ``lax.while_loop``
    program becomes one CUDA graph an epoch.

    The training set goes to the device once, and every epoch's order
    (the host loop's own ``rng.permutation``, all epochs drawn up front)
    in one ``(epochs, steps * dp * batch)`` index tensor.  An epoch's body
    gathers its batches by index, runs ``steps_per_epoch``
    :meth:`MeshEASGD.step` calls (K1 launched on the capturing stream),
    and writes the center's test error and the epoch's mean loss into
    ``errs[ep]`` and ``losses[ep]`` on the device; a device counter ``ep``
    picks the epoch, so one graph serves every epoch that starts at the
    same phase of the sync schedule.  The schedule is host-side
    (``steps % su``), so there is one graph per starting phase (at most
    ``su``), all captured before the clock starts, after a warm-up on
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
        x_ep = x_all.index_select(0, idx).view(spe, n_dp, cfg.batch, -1)
        y_ep = y_all.index_select(0, idx).view(spe, n_dp, cfg.batch)
        _, ep_losses = trainer.run_epoch(st, x_ep, y_ep)
        losses.index_copy_(0, ep, ep_losses.mean().view(1))
        err = error_rate(flat, trainer.center_params(st), x_test_d, y_test_d)
        errs.index_copy_(0, ep, err.view(1))
        ep.add_(1)

    graphs = {}
    warmup_steps = 0
    t_c = time.perf_counter()
    if device.type == "cuda":
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            trainer.precompile(state, x_all[:per_step].view(n_dp, cfg.batch, -1),
                               y_all[:per_step].view(n_dp, cfg.batch))
            epoch_body({k: v.clone() for k, v in state.items()},
                       *(b.clone() for b in bufs))
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
        warmup_steps = 2 + spe  # precompile's sync and local step, one epoch
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


def run(cfg: Config) -> dict:
    if cfg.device_loop and (cfg.ckpt_dir or cfg.resume or cfg.profile_dir):
        raise ValueError(
            "device_loop=1 runs every epoch from a captured CUDA graph: there are "
            "no host epoch boundaries for checkpointing, resume, or per-epoch "
            "profiling; use the host loop for ckpt_dir/resume/profile_dir")
    _refuse_later_slices(cfg)
    device = resolve_device(cfg.device)
    if cfg.measure_throughput and device.type != "cuda":
        raise ValueError("measure_throughput times the card (CUDA events); "
                         "a CPU run has no device time to report")
    log = get_logger("mesh", 0)
    mesh = make_mesh(dp=cfg.dp or None, shard=cfg.shard or None, device=device)
    n_dp = mesh.shape["dp"]
    log.info("mesh: dp=%d shard=1 on %s (%s)", n_dp, device, device_name(device))

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
    mva = cfg.mva or 0.9 / max(n_dp, 1)
    trainer = MeshEASGD(mesh, value_and_grad_nll(flat), msgd, mva=mva, su=cfg.su)
    state = trainer.init(flat.w0)

    def test_err() -> float:
        return float(error_rate(flat, trainer.center_params(state), x_test_d, y_test_d))

    n = len(x_train)
    per_step = n_dp * cfg.batch  # per-worker disjoint streams (goot.lua:129-146)
    if n < per_step:
        raise ValueError(
            f"dataset has {n} samples but one global step needs {per_step} "
            "(dp x batch); lower --batch or --dp"
        )
    steps_per_epoch = n // per_step

    def to_device(idx, lead):
        x = torch.from_numpy(np.ascontiguousarray(
            x_train[idx].reshape(*lead, cfg.batch, -1), np.float32))
        y = torch.from_numpy(y_train[idx].reshape(*lead, cfg.batch).astype(np.int64))
        return x.to(device), y.to(device)

    def stage_epoch(idx, nsteps=None):
        """One device placement of a shuffled epoch, ``(nsteps, n_dp,
        batch, ...)``."""
        nsteps = steps_per_epoch if nsteps is None else nsteps
        return to_device(idx, (nsteps, n_dp))

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
            steps_per_epoch=steps_per_epoch, per_step=per_step, n_dp=n_dp,
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
            warm = to_device(np.arange(per_step), (n_dp,))
        trainer.precompile(state, *warm)
        test_err()
        compile_s = time.perf_counter() - t_c
        log.info("precompile: %.2fs (step + eval paths warm)", compile_s)

    def train_epoch(order):
        if cfg.device_stream:
            x_ep, y_ep = stage_epoch(order[: steps_per_epoch * per_step])
            return trainer.run_epoch(state, x_ep, y_ep)[1]
        losses = []
        for step in range(steps_per_epoch):
            idx = order[step * per_step:(step + 1) * per_step]
            losses.append(trainer.step(state, *to_device(idx, (n_dp,)))[1])
        return torch.stack(losses)

    if not cfg.device_loop:
        t0 = time.perf_counter()  # the device loop sets its own
    with profiler_trace(cfg.profile_dir):
        for epoch in range(0 if cfg.device_loop else cfg.epochs):
            order = rng.permutation(n)
            t_ep = time.perf_counter()
            with trace_annotation(f"epoch {epoch}"):
                avg_loss = float(train_epoch(order).mean())  # fences the epoch
            epoch_train_s.append(time.perf_counter() - t_ep)
            samples_trained += steps_per_epoch * per_step
            err = test_err()
            at = time.perf_counter() - t0
            if time_to_target is None and err <= cfg.target_test_err:
                time_to_target = at
            history.append({
                "epoch": epoch, "avg_loss": avg_loss,
                "test_err": err, "at": round(at, 3),
            })
            log.info("epoch %d avg_loss %.5f test_err %.4f (%.1fs)",
                     epoch, avg_loss, err, at)
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
        "elapsed": time.perf_counter() - t0,
        "train_time": round(train_time, 3),
        "samples_trained": samples_trained,
        "samples_per_sec": round(sps, 1) if sps else None,
        "samples_per_sec_steady": round(sps_steady, 1) if sps_steady else None,
        # Which wall fed samples_per_sec: "device_loop" includes the
        # on-device eval; "host_loop" times training only.
        "train_wall_mode": "device_loop" if cfg.device_loop else "host_loop",
        "compile_s": round(compile_s, 3) if compile_s is not None else None,
        "data_source": source,
        "mesh": {"dp": n_dp, "shard": 1},
        "processes": 1,
        "device": str(state["center"].device),
        "device_name": device_name(device),
        # Training steps, the throughput leg's passes included (precompile's
        # warm-up steps run on copies and are not counted).
        "steps": trainer.steps,
        # device_loop: the captured graphs (phase, steps, replays) and the
        # warm-up's steps on copies; None for the host loop.
        "device_loop": loop_info,
    }


def main(argv: Optional[List[str]] = None) -> dict:
    cfg = MESH_LAUNCH_DEFAULTS.parse_args(
        list(sys.argv[1:] if argv is None else argv)
    )
    result = run(cfg)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
