#!/usr/bin/env python3
"""BiCNN at the reference's scale on the port — the twin of
``benchmarks/bicnn_scale.py`` (the plaunch.lua:38 configuration class).

The reference ran BiCNN with ``num_filters=3000`` over a private QA corpus.
This runs the reference-scale model (3,000 filters, embedding 300, hidden
200, conv width 3: 3,416,600 flat parameters over a 5,178-word
vocabulary) over a synthetic corpus written in the reference's TSV formats
and read by the real parser (:func:`mpit_tpu_torch.data.qa.synthetic_qa`
-> ``load_qa_files``): 2,000 training examples, 400 answer labels, pools
of 50.  ``sgd`` at lr 0.05 with momentum 0.9 (K1 commits every step), batch
32 (63 steps an epoch, the last batch wrapping), margin 0.1, no L2.  It
reports the training rate (examples/s over the epochs after the first,
which pays the first launches and cuDNN's algorithm search), each
epoch's seconds, and the warm ``test3`` (valid, test1, test2 over every
pool, on the device).

Env, with the JAX twin's names and defaults: ``MPIT_SCALE_EPOCHS`` (2),
``MPIT_SCALE_TRAIN`` (2000), ``MPIT_SCALE_LABELS`` (400),
``MPIT_SCALE_POOL`` (50), ``MPIT_SCALE_BATCH`` (32),
``MPIT_SCALE_FILTERS`` (3000), ``MPIT_SCALE_EMB`` (300); and
``MPIT_BENCH_DEVICE`` (``cuda``; ``cpu`` for a dry run at small
``MPIT_SCALE_*`` sizes).  :func:`profile` runs more steps under
``torch.profiler`` (``chip_smoke.py`` calls it after the run).

Prints one JSON line with the JAX twin's keys plus ``device``,
``k1_launches`` (K1's launches in the epochs) and ``steps``.  Run from the
repository root: ``python3 tools/torch_bicnn_scale.py``.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

EPOCHS = int(os.environ.get("MPIT_SCALE_EPOCHS", "2"))  # >=2: epoch 0 pays first calls
N_TRAIN = int(os.environ.get("MPIT_SCALE_TRAIN", "2000"))
N_LABELS = int(os.environ.get("MPIT_SCALE_LABELS", "400"))
POOL = int(os.environ.get("MPIT_SCALE_POOL", "50"))
BATCH = int(os.environ.get("MPIT_SCALE_BATCH", "32"))
FILTERS = int(os.environ.get("MPIT_SCALE_FILTERS", "3000"))
EMB = int(os.environ.get("MPIT_SCALE_EMB", "300"))
DEVICE = os.environ.get("MPIT_BENCH_DEVICE", "cuda")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def build():
    """The corpus and the trainer; returns ``(trainer, data)``."""
    from mpit_tpu_torch.data import qa
    from mpit_tpu_torch.train.bicnn import BICNN_DEFAULTS, BiCNNTrainer

    t0 = time.perf_counter()
    # The loader returns arrays in memory: the corpus files go at once.
    with tempfile.TemporaryDirectory(prefix="bicnn_scale_") as tmp:
        paths = qa.synthetic_qa(
            pathlib.Path(tmp), n_labels=N_LABELS, n_train=N_TRAIN,
            n_eval=max(N_TRAIN // 8, 64), pool_size=POOL, embedding_dim=EMB,
            vocab_words=5000, seed=3,
        )
        data = qa.load_qa_files(embedding_dim=EMB, conv_width=3, **paths)
    log(f"corpus: {len(data.train)} train, {data.answer_space} answers, "
        f"vocab {len(data.vocab)} ({time.perf_counter() - t0:.1f}s to generate+parse)")
    cfg = BICNN_DEFAULTS.merged(
        optimization="sgd", learning_rate=0.05, momentum=0.9,
        num_filters=FILTERS, embedding_dim=EMB, word_hidden_dim=200,
        cont_conv_width=3, batch_size=BATCH, epoch=EPOCHS,
        margin=0.1, l2reg=0.0, eval_chunk=64, loss_report_every=10**9,
        device=DEVICE,
    )
    t0 = time.perf_counter()
    tr = BiCNNTrainer(cfg, data=data)
    log(f"model: {tr.flat.size} flat params on {tr.device} "
        f"({time.perf_counter() - t0:.1f}s to build)")
    return tr, data


def run(tr, data) -> dict:
    """Train ``EPOCHS`` epochs, then the warm test3; returns the JSON line's
    fields.  K1's count is read over the epochs alone."""
    import torch

    from mpit_tpu_torch.ops.fused_update import fused_nesterov_commit

    k1_before = fused_nesterov_commit.launches
    t0 = time.perf_counter()
    result = tr.run()
    t_train = time.perf_counter() - t0
    k1 = fused_nesterov_commit.launches - k1_before
    steps_per_epoch = -(-len(data.train) // BATCH)
    secs = [h["seconds"] for h in result["history"]]
    steady = secs[1:] if len(secs) > 1 else secs
    steady_sps = (len(steady) * steps_per_epoch * BATCH / sum(steady)
                  if steady and sum(steady) > 0 else None)
    t0 = time.perf_counter()
    accs = tr.test3()  # pool tables cached, every call warm
    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)
    t_eval = time.perf_counter() - t0
    return {
        "metric": "bicnn_scale_examples_per_sec",
        "value": steady_sps,
        "unit": "examples/s",
        "num_filters": FILTERS,
        "flat_params": int(tr.flat.size),
        "vocab": len(data.vocab),
        "train_examples": len(data.train),
        "answers": data.answer_space,
        "pool_size": POOL,
        "epochs": EPOCHS,
        "epoch_seconds": secs,
        "train_total_s": t_train,
        "eval3_warm_s": t_eval,
        "accuracy": accs,
        "accuracy_after_training": result["accuracy"],
        "losses": [h["avg_loss"] for h in result["history"]],
        "steps": result["steps"],
        "k1_launches": k1,
        "device": str(tr.device),
        "corpus": "synthetic via the real TSV parser (no public QA corpus on disk)",
    }


def profile(tr, data, steps: int) -> dict:
    """``steps`` more training steps under ``torch.profiler``: the device
    time per step by kernel (top 12), the device's busy share of the
    steps' wall, and the host's share of the step in sampling."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    order = tr.rng.permutation(len(data.train))
    batches = list(tr._batches(order))[:steps]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if tr.device.type == "cuda" else [])

    def sync():
        if tr.device.type == "cuda":
            torch.cuda.synchronize(tr.device)

    sync()
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        for idx in batches:
            tr.step(idx)
        sync()
        wall = time.perf_counter() - t0
    kernels = {}
    busy = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", 0.0) or 0.0
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            kernels[ev.key] = {"count": ev.count, "us": dev_us}
            busy += dev_us
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["us"])[:12]
    n = max(len(batches), 1)
    return {
        "steps": len(batches),
        "step_ms": wall / n * 1e3,
        "device_busy_share": busy / 1e6 / wall if wall > 0 else None,
        "device_us_per_step": busy / n,
        "top": [{"name": k[:120], "count_per_step": v["count"] / n,
                 "us_per_step": v["us"] / n} for k, v in top],
        # The host's negative sampling, over every step of the run.
        "sample_ms_per_step": tr.tm.total["sample"] / max(tr.tm.count["sample"], 1) * 1e3,
    }


def main() -> dict:
    tr, data = build()
    row = run(tr, data)
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
