"""Long-context causal-LM training CLI on one card — the port of
``mpit_tpu/train/lm_launch.py``.

TinyDecoder over a byte corpus (``--text_file``, trained as raw bytes,
vocab 256, or a deterministic synthetic Markov stream), trained by full
Nesterov msgd: the lookahead, the loss and gradient at the displaced point,
and the commit (K1), all in place on the flat parameter vector.  Its
attention runs on ``attn_dtype`` inputs: at ``sp = 1`` the flash kernels
(K4 forward, K5 or K6 backward); at ``--sp N`` the sequence is cut over
``N`` virtual ranks of one card and attention is the ring
(:func:`mpit_tpu_torch.parallel.ring_attention.ring_attention`, in the
``--layout`` given, zigzag by default): K4's partial mode once for each
live (q chunk, kv chunk) pair, and the pair backward (K5 or K6, as the gate
decides at the pair's shape) once for each live pair.  ``--dp N`` cuts the
batch over ``N`` data parallel ranks, ``dp x sp`` virtual ranks of the card
in all: the loss is the global batch's mean, so the all-reduced gradient of
the ``dp`` rows is the one gradient of the whole batch, and the groups'
rings ride the batch axis of one ring (``batch_axis="dp"``): a step makes
the launches of ``--dp 1`` at the same batch.  The corpus and the batch
draws are the reference's, so a run from the same ``w0`` sees the same
tokens in both packages.

``--ckpt_dir`` saves ``w``, ``vt`` and ``k`` every ``ckpt_every`` steps
in the JAX package's npz layout (``lm_latest.npz``), and ``--resume auto``
(or a path) continues from it, in either package and at any ``--dp`` and
``--sp``, with the reference's guards: the model's widths, the seed, the
batch and the corpus must be the checkpoint's.  A resumed run burns the skipped steps'
draws, so the data stream continues.

Runs on CUDA unless ``--device cpu``.  The multi-host flags go through
:func:`mpit_tpu_torch.parallel.distributed.bootstrap` and form a group of
any size (the result's ``backend`` names it).  Over ``P`` processes the
``(dp, sp)`` grid is cut as the JAX package cuts its devices
(:mod:`mpit_tpu_torch.parallel.mesh`: row-major, ``P`` contiguous blocks,
each a box): ``w``, ``vt`` and ``k`` are replicated, every process draws
the same global batch and takes the rows of its ``dp`` ranks
(:func:`~mpit_tpu_torch.parallel.mesh.process_local_rows`; at ``--dp 1
--sp 2`` both take the whole batch), and where ``sp`` spans processes the
ring's pairs are cut over them by rank, its hop goes between them, and
each attention's output is all-gathered over the ``sp`` line.  Every
process of an ``sp`` line computes the same dense layers on the whole
sequence, and takes the gradient of its line's first process
(:func:`~mpit_tpu_torch.parallel.collective.replicate`: the card's
backward does not repeat its bits from run to run, and the replicas must
not drift apart).  The step's gradient and loss are the global batch's,
the mean over the processes of the ``dp`` line in rank order
(:func:`~mpit_tpu_torch.parallel.collective.process_mean`).  Each process
launches K4, K5 or K6 for its ranks' pairs and rows, and K1.
Process 0 writes the checkpoints, and every process waits at a
barrier until each is published.  The reference's
``compile_cache`` (a persistent XLA cache) has no counterpart and is not a
flag here; ``profile_dir`` records
a ``torch.profiler`` trace of the training loop, each log window a
``window N`` range.

Example:

    python -m mpit_tpu_torch.train.lm_launch --seq_len 8192 --d_model 1024 \
        --n_layers 4 --batch 1 --steps 20 --sp 4 --layout zigzag
"""

from __future__ import annotations

import json
import pathlib
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from mpit_tpu_torch.models.flat import flatten_module
from mpit_tpu_torch.models.transformer import TinyDecoder, default_attn
from mpit_tpu_torch.obs.timers import profiler_trace, trace_annotation
from mpit_tpu_torch.optim.msgd import MSGDConfig, msgd_init, msgd_step
from mpit_tpu_torch.parallel.collective import process_mean, replicate
from mpit_tpu_torch.parallel.distributed import (
    barrier, bootstrap_launcher, launcher_processes, shutdown)
from mpit_tpu_torch.parallel.mesh import Mesh, check_split, process_local_rows
from mpit_tpu_torch.parallel.ring_attention import ring_attention
from mpit_tpu_torch.utils.checkpoint import load_state_dict, save_state_dict_group
from mpit_tpu_torch.utils.config import Config
from mpit_tpu_torch.utils.logging import get_logger
from mpit_tpu_torch.utils.platform import device_name, resolve_device

LM_LAUNCH_DEFAULTS = Config(
    seq_len=1024,
    d_model=256,
    n_heads=8,
    n_layers=2,
    batch=8,
    steps=200,
    lr=1e-3,
    mom=0.9,
    dp=0,  # 0 -> 1; more: the batch cut over dp ranks
    sp=0,  # 0 -> 1; more: ring attention over sp ranks
    layout="zigzag",  # zigzag | contiguous: the ring's layout at sp > 1
    attn_dtype="bfloat16",  # kernel input dtype: bfloat16 | float32
    text_file="",
    seed=1,
    log_every=20,
    ckpt_dir="",
    ckpt_every=100,  # steps
    resume="",  # "auto" -> <ckpt_dir>/lm_latest.npz
    profile_dir="",  # torch.profiler trace of the training loop when set
    device="cuda",  # cuda | cpu
    # multi-host bootstrap: the (dp, sp) grid is cut across the group's processes
    hostfile="",
    coordinator="",
    num_processes=0,
    process_id=-1,
)

# The widths of the JAX package's long-context showcase
# (benchmarks/longcontext.py, its first length), and at its third length,
# where bfloat16 attention's backward runs K6 on the card (K5's dQ
# partials would take 32 GiB).
LONGCONTEXT_KWARGS = dict(seq_len=8192, d_model=1024, n_heads=8, n_layers=4,
                          batch=1)
LONGCONTEXT_32K_KWARGS = dict(LONGCONTEXT_KWARGS, seq_len=32768)


_SYNTH_CACHE: dict = {}


def _corpus_key(text_file: str) -> str:
    """Identity of the training corpus for resume guards: the resolved
    path ("" for the synthetic stream), stored resolved at save time so
    the comparison does not depend on the working directory."""
    return str(pathlib.Path(text_file).resolve()) if text_file else ""


def _corpus(cfg: Config, log) -> np.ndarray:
    if cfg.text_file:
        data = np.frombuffer(
            pathlib.Path(cfg.text_file).read_bytes(), np.uint8
        ).astype(np.int32)
        log.info("corpus: %s (%d bytes)", cfg.text_file, len(data))
    else:
        # Markov-ish synthetic bytes: learnable structure, not uniform
        # noise.  Deterministic in n — memoized, the scalar chain costs
        # ~1.5s/MB and every run() call would otherwise regenerate it.
        n = max(1 << 20, 8 * (cfg.seq_len + 1) * cfg.batch)
        data = _SYNTH_CACHE.get(n)
        if data is None:
            rng = np.random.default_rng(1234)
            trans = rng.integers(0, 256, (256, 4))
            data = np.empty(n, np.int32)
            data[0] = 0
            choices = rng.integers(0, 4, n)
            noise = rng.random(n)
            resets = rng.integers(0, 256, n)
            for i in range(1, n):
                data[i] = (trans[data[i - 1], choices[i]]
                           if noise[i] > 0.1 else resets[i])
            _SYNTH_CACHE[n] = data
        log.info("corpus: synthetic markov bytes (%d)", n)
    if len(data) < cfg.batch * (cfg.seq_len + 1):
        raise ValueError(
            f"corpus of {len(data)} tokens < one global batch "
            f"({cfg.batch} x {cfg.seq_len + 1})"
        )
    return data


def _check_flags(cfg: Config) -> None:
    if cfg.layout not in ("zigzag", "contiguous"):
        raise ValueError(f"layout must be zigzag or contiguous, got {cfg.layout!r}")
    if cfg.attn_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"attn_dtype must be bfloat16 or float32, got {cfg.attn_dtype!r}")


def run(cfg: Config) -> dict:
    """Train; returns the reference's result keys plus the device, the
    step count and ``state``, the final ``w``, ``vt`` and ``k`` (which
    :func:`main` leaves out of its JSON)."""
    _check_flags(cfg)
    device = resolve_device(cfg.device)
    processes = launcher_processes(cfg)  # checked before any rendezvous
    check_split({"dp": int(cfg.dp) or 1, "sp": int(cfg.sp) or 1}, processes)
    pg = bootstrap_launcher(cfg, device.type)
    device = resolve_device(cfg.device)  # the card bootstrap took, on the card
    try:
        return _train(cfg, device, pg)
    finally:
        if pg.coordinator is not None:  # the group this run formed
            shutdown()


def build_step(cfg: Config, device: torch.device, mesh: Optional[Mesh] = None):
    """The model and one training step at ``cfg``'s widths on ``device``:
    the flat model, its weights and a fresh optimizer state, and
    ``train_step(w, state, toks) -> loss``, which updates ``w`` and
    ``state`` in place (K4 forward, K5 or K6 backward, K1 commit).  Over a
    ``mesh`` that spans processes, ``toks`` are the rows of this process's
    ``dp`` ranks of the global batch, the ring runs this process's ``sp``
    ranks, and the gradient and loss are the global batch's."""
    if mesh is None:
        mesh = Mesh(device, dp=int(cfg.dp) or 1, sp=int(cfg.sp) or 1)
    cast = torch.bfloat16 if cfg.attn_dtype == "bfloat16" else None
    # sp 1: K4 over every row of this process's batch, dp groups included.
    inner = (ring_attention(mesh, "sp", causal=True, batch_axis="dp", layout=cfg.layout)
             if mesh.size("sp") > 1 else default_attn(causal=True))

    def attn_fn(q, k, v):
        out_dtype = q.dtype
        if cast is not None:
            q, k, v = (t.to(cast) for t in (q, k, v))
        return inner(q, k, v).to(out_dtype)

    model = TinyDecoder(
        vocab=256, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_layers=cfg.n_layers, max_len=cfg.seq_len, attn_fn=attn_fn,
    )
    flat = flatten_module(model, cfg.seed, device)

    def loss_fn(w, toks):
        logp = flat.apply_flat(w, toks[:, :-1])
        return -torch.take_along_dim(logp, toks[:, 1:, None], dim=-1).mean()

    one_row, combine = replicate(mesh, "sp"), process_mean(mesh)

    def value_and_grad(w, toks):
        w_la = w.detach().requires_grad_(True)
        loss = loss_fn(w_la, toks)
        (grad,) = torch.autograd.grad(loss, w_la)
        if mesh.processes > 1:
            # one gradient a dp row (its sp line's first process's), then the
            # global batch's, from every dp rank's rows
            both = combine(one_row(torch.cat([grad, loss.detach().reshape(1)])))
            return both[-1], both[:-1]
        return loss.detach(), grad

    mcfg = MSGDConfig(lr=cfg.lr, mom=cfg.mom)

    def train_step(w, state, toks):
        w, state, loss = msgd_step(value_and_grad, w, state, mcfg, toks)
        return loss

    w = flat.w0.clone()
    return flat, w, msgd_init(w), train_step


def _train(cfg: Config, device: torch.device, pg) -> dict:
    log = get_logger("lm", pg.process_id)
    log.info("%s", pg.describe())
    dp, sp = int(cfg.dp) or 1, int(cfg.sp) or 1
    log.info("mesh: dp=%d sp=%d on %s (%s)", dp, sp, device, device_name(device))
    if dp < 1 or cfg.batch % dp:
        raise ValueError(f"--batch {cfg.batch} not divisible by dp={dp}")
    if sp < 1 or cfg.seq_len % sp:
        raise ValueError(f"--seq_len {cfg.seq_len} not divisible by sp={sp}")
    mesh = Mesh(device, pg, dp=dp, sp=sp)
    rows = process_local_rows(mesh, cfg.batch)  # of every step's global batch

    flat, w, state, train_step = build_step(cfg, device, mesh)
    log.info("flat params: %d", flat.size)
    model_key = {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
                 "n_layers": cfg.n_layers, "seq_len": cfg.seq_len}
    start_step, prev_elapsed = 0, 0.0
    if cfg.resume:
        start_step, prev_elapsed = _resume(cfg, model_key, w, state, log)

    data = _corpus(cfg, log)
    rng = np.random.default_rng(cfg.seed)
    # Burn the skipped steps' draws so a resumed run continues the stream
    # (one draw of cfg.batch starts per step).
    for _ in range(start_step):
        rng.integers(0, len(data) - cfg.seq_len - 1, cfg.batch)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # Warm the step before t0 on copies of the state (the first launches
    # build the kernels and pick cuBLAS's algorithms): tokens_per_sec
    # measures training, compile_s the warm-up.
    t_c = time.perf_counter()
    warm_toks = torch.zeros((rows.stop - rows.start, cfg.seq_len + 1), dtype=torch.int64,
                            device=device)
    train_step(w.clone(), {k: v.clone() for k, v in state.items()}, warm_toks)
    sync()
    compile_s = time.perf_counter() - t_c
    log.info("precompile: %.2fs", compile_s)

    def save(step):
        save_state_dict_group(
            cfg.ckpt_dir, {"w": w, "vt": state["vt"], "k": state["k"]},
            meta={"step": step, "seed": cfg.seed, "batch": cfg.batch,
                  "text_file": _corpus_key(cfg.text_file), "model": model_key,
                  "elapsed": round(time.perf_counter() - t0 + prev_elapsed, 3)},
            prefix="lm", process_id=pg.process_id, barrier=barrier)

    # Log windows end where (step + 1) % log_every == 0, and at the last
    # step; a resumed run's first window is the rest of its window.
    every = max(int(cfg.log_every), 1)
    history: List[dict] = []
    t0 = time.perf_counter()
    with profiler_trace(cfg.profile_dir):
        first = start_step
        while first < cfg.steps:
            last = min((first // every + 1) * every, cfg.steps) - 1
            with trace_annotation(f"window {first // every}"):
                losses = []
                for step in range(first, last + 1):
                    starts = rng.integers(0, len(data) - cfg.seq_len - 1, cfg.batch)
                    toks = np.stack([data[s:s + cfg.seq_len + 1] for s in starts[rows]])
                    toks = torch.from_numpy(toks).to(device, torch.int64)
                    losses.append(train_step(w, state, toks))
                    if cfg.ckpt_dir and (step + 1) % max(int(cfg.ckpt_every), 1) == 0:
                        save(step)
                avg = float(torch.stack(losses).mean())  # fences the window
            if (last + 1) % every == 0:
                log.info("step %d loss %.4f (%.1fs)", last, avg,
                         time.perf_counter() - t0 + prev_elapsed)
            history.append({"step": last, "avg_loss": avg})
            first = last + 1
    sync()
    elapsed = time.perf_counter() - t0 + prev_elapsed
    trained = (cfg.steps - start_step) * cfg.batch * cfg.seq_len
    return {
        "history": history,
        "final_loss": history[-1]["avg_loss"] if history else None,
        "elapsed": round(elapsed, 3),
        "tokens_trained": trained,
        "tokens_per_sec": round(trained / max(elapsed - prev_elapsed, 1e-9), 1),
        "compile_s": round(compile_s, 3),
        "mesh": {"dp": dp, "sp": sp},
        "params": flat.size,
        "processes": pg.num_processes,
        "backend": pg.backend,
        "steps": int(cfg.steps) - start_step,
        "device": str(w.device),
        "device_name": device_name(device),
        "state": {"w": w, "vt": state["vt"], "k": state["k"]},
    }


def _resume(cfg: Config, model_key: dict, w: torch.Tensor, state: dict, log):
    """Load ``cfg.resume`` into ``w`` and ``state`` in place, with the
    reference's guards; returns the step to start at and the earlier
    runs' seconds."""
    path = cfg.resume
    if path == "auto":
        if not cfg.ckpt_dir:
            raise ValueError("--resume auto requires --ckpt_dir")
        path = str(pathlib.Path(cfg.ckpt_dir) / "lm_latest.npz")
    saved, meta = load_state_dict(path)
    if tuple(saved["w"].shape) != tuple(w.shape):
        raise ValueError(
            f"checkpoint params {tuple(saved['w'].shape)} != model {tuple(w.shape)} "
            "— different --d_model/--n_layers/--seq_len?")
    if "model" in meta and meta["model"] != model_key:
        raise ValueError(
            f"checkpoint model config {meta['model']} != {model_key} — the same "
            "flat size does not make the same model (n_heads changes the "
            "attention head split silently)")
    for key, what in (("seed", "data stream"), ("batch", "data stream")):
        if key in meta and int(meta[key]) != int(cfg[key]):
            raise ValueError(
                f"checkpoint was trained with --{key} {meta[key]}, resuming with "
                f"--{key} {cfg[key]} would silently diverge the {what} — pass "
                f"the original {key}")
    if "text_file" in meta and meta["text_file"] != _corpus_key(cfg.text_file):
        raise ValueError(f"checkpoint was trained on {meta['text_file']!r}, "
                         f"resuming on {cfg.text_file!r} is a different corpus")
    w.copy_(torch.as_tensor(saved["w"]))
    state["vt"].copy_(torch.as_tensor(saved["vt"]))
    state["k"].copy_(torch.as_tensor(saved["k"]))
    start_step = int(meta.get("step", -1)) + 1
    log.info("resumed from %s at step %d", path, start_step)
    return start_step, float(meta.get("elapsed", 0.0))


def main(argv: Optional[List[str]] = None) -> dict:
    cfg = LM_LAUNCH_DEFAULTS.parse_args(
        list(sys.argv[1:] if argv is None else argv)
    )
    result = run(cfg)
    print(json.dumps({k: v for k, v in result.items() if k != "state"}, indent=2))
    return result


if __name__ == "__main__":
    main()
