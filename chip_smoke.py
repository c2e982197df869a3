#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mpit_tpu_torch``) on one NVIDIA card.

The quickest proof that the port still starts on the GPU.  Phases, in
order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every kernel of the path, from the sources in this checkout;
3. kernels: each kernel against its plain PyTorch twin at the shapes each
   path below gives it (K1 must be bit-equal), then timed with CUDA events
   beside the twin and the bytes bound;
4. the headline path: ``mesh_launch.run`` at the flagship configuration
   (CNN side 32, 544,522 parameters, EASGD, dp=1) for two epochs with the
   steady-state throughput leg; then three EASGD steps at dp=4 on the card
   held against the same steps on the CPU;
5. ``launch --np 1 --opt msgd`` for one epoch.

The kernels' launch counters are set to 0 just before each path and read
just after it: a path that did not launch K1 once per step fails.  The
last two lines are one JSON object describing every kernel (``launches``
is the headline run's count, which grows with the passes the throughput
leg needs; ``paths`` holds every path's launches and steps), and
``{"ok": true, "device": {...}}``.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores, NVIDIA data sheet
TIMED_LAUNCHES = 200
L2_BYTES = 50e6  # H100 L2 cache
# The hold of a queued timing: 2e8 clock cycles last at least 0.1 s at
# clocks up to 2 GHz (the H100's boost clock is 1.98 GHz).
HOLD_CYCLES = 200_000_000
HOLD_S_MIN = HOLD_CYCLES / 2.0e9
# Calls queued behind the hold: few enough that the launch queue (about a
# thousand kernels) never fills while the device sleeps.
QUEUED_CALLS = 100
# Limits of the dp=4 card-vs-CPU comparison (see easgd_dp4): the largest
# elementwise gap, and the gap's norm over the norm of the three steps'
# change to the state.
DP4_MAX_ABS_GAP = 2e-6
DP4_GAP_OVER_CHANGE = 1e-3


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, queued=False) -> float:
    """Mean ms per call of ``fn()`` on the current stream, by CUDA events
    after a warm-up.  ``queued``: the stream is held by a sleep kernel while
    the host queues the calls, so the events see the device time of
    back-to-back launches, without the host's per-call overhead; otherwise
    the time is that of calls issued from a host loop, as a training step
    issues them."""
    n = QUEUED_CALLS if queued else TIMED_LAUNCHES
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(HOLD_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    host_s = time.perf_counter() - t0
    end.synchronize()
    ms = start.elapsed_time(end) / n
    if queued and host_s > HOLD_S_MIN:
        raise AssertionError(f"the host queued {n} calls in {host_s:.4f}s, "
                             "longer than the hold: the device time would "
                             "include host gaps")
    return ms


def rotating(fn, sets):
    """``fn`` over buffer sets in turn: together they exceed the 50 MB L2,
    so every call finds its operands in device memory, as a training step
    does after the forward and backward passes."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def check_k1(torch, n_mesh, n_msgd):
    """K1 against its twin at the shapes each driven path gives it; returns
    the kernel's entry for the closing JSON line (times at 1 x n_mesh, no
    retract: the commit of nine steps in ten on the headline path)."""
    from mpit_tpu_torch.ops.fused_update import (
        fused_nesterov_commit, fused_nesterov_commit_reference)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    rows_out = []
    # (rows, form, n, retract variants): MeshEASGD's (dp, n) rows at dp=1
    # and dp=4, plain and with the sync round's retract; and the 1-D form
    # with a 0-d clr that `launch --np 1 --opt msgd` gives it at its own
    # model's size, never with a retract.
    for rows, form, n, retracts in ((1, "rows", n_mesh, (False, True)),
                                    (4, "rows", n_mesh, (False, True)),
                                    (1, "1-D", n_msgd, (False,))):
        w, vt, g, sug = (torch.randn(rows, n, device=dev, generator=gen)
                         for _ in range(4))
        sug.mul_(1e-2)
        clr = torch.tensor([0.01, 0.02, 0.03, 0.04][:rows], device=dev)
        if form == "1-D":
            w, vt, g, sug, clr = w[0], vt[0], g[0], sug[0], clr[0]
        for retract in retracts:
            s = sug if retract else None
            for l2wd in (0.0, 1e-4):
                want_w, want_vt = fused_nesterov_commit_reference(
                    w, vt, g, clr, l2wd=l2wd, sug=s)
                kw, kvt = w.clone(), vt.clone()
                fused_nesterov_commit(kw, kvt, g, clr, l2wd=l2wd, sug=s)
                torch.cuda.synchronize()
                err = max(float((kw - want_w).abs().max()),
                          float((kvt - want_vt).abs().max()))
                max_err = max(max_err, err)
                if not (torch.equal(kw, want_w) and torch.equal(kvt, want_vt)):
                    raise AssertionError(
                        f"K1 differs from its twin: rows={rows} {form} "
                        f"sug={retract} l2wd={l2wd} max_abs_err={err}")
            elems = rows * n
            set_bytes = (4 if retract else 3) * 4 * elems
            sets = [(w.clone(), vt.clone(), g.clone(), None if s is None else s.clone())
                    for _ in range(max(2, math.ceil(2 * L2_BYTES / set_bytes)))]
            kernel = rotating(lambda a, b, c, d: fused_nesterov_commit(
                a, b, c, clr, sug=d), sets)
            plain = rotating(lambda a, b, c, d: fused_nesterov_commit_reference(
                a, b, c, clr, sug=d), sets)
            n_bytes = (6 if retract else 5) * 4 * elems
            bound_ms = max(n_bytes / HBM_BYTES_PER_S,
                           (4 if retract else 3) * elems / F32_FLOPS) * 1e3
            rows_out.append({
                "rows": rows, "form": form, "n": n, "sug": retract,
                "ms": time_ms(torch, kernel, queued=True),
                "call_ms": time_ms(torch, kernel),
                "plain_ms": time_ms(torch, plain, queued=True),
                "plain_call_ms": time_ms(torch, plain),
                "bound_ms": bound_ms})
            del sets
    print("K1 shapes: " + json.dumps(rows_out))
    main_row = rows_out[0]
    return {
        "name": "fused_nesterov_commit",
        "route": "cuda",
        "source": "mpit_tpu_torch/ops/csrc/fused_update.cu",
        "replaces": "mpit_tpu/ops/fused_update.py:81",
        "launches": None,  # set from the headline run
        "paths": {},  # launches and steps of every driven path
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes K1
    }


def headline(torch, commit):
    from mpit_tpu_torch.train.mesh_launch import (
        FLAGSHIP_BENCH_KWARGS, MESH_LAUNCH_DEFAULTS, run)

    cfg = MESH_LAUNCH_DEFAULTS.merged(
        FLAGSHIP_BENCH_KWARGS, dp=1, epochs=2, measure_throughput=1, device="cuda")
    commit.launches = 0
    res = run(cfg)
    launches = commit.launches
    hist = res["history"]
    print("headline: " + json.dumps({
        "samples_per_sec": res["samples_per_sec"],
        "samples_per_sec_steady": res["samples_per_sec_steady"],
        "losses": [h["avg_loss"] for h in hist],
        "test_err": res["final_test_err"], "compile_s": res["compile_s"],
        "train_time": res["train_time"], "device": res["device"],
        "device_name": res["device_name"], "k1_launches": launches,
        "steps": res["steps"]}))
    if len(hist) != 2 or not hist[1]["avg_loss"] < hist[0]["avg_loss"]:
        raise AssertionError(f"the loss did not fall: {hist}")
    if not res["device"].startswith("cuda"):
        raise AssertionError(f"the state is on {res['device']}, not cuda")
    # One launch per step, and one for each of precompile's two warm-up
    # steps (a sync and a local step, on copies of the state).
    warm = 2 if cfg.precompile else 0
    if launches <= 0 or launches != res["steps"] + warm:
        raise AssertionError(f"the headline path launched K1 {launches} times "
                             f"in {res['steps']} steps + {warm} warm-up steps")
    return {"launches": launches, "steps": res["steps"], "warmup_steps": warm}


def easgd_dp4(torch, commit):
    """Three EASGD steps at dp=4 (one K1 launch commits four rows, each with
    its own clr) on the card, held against the same steps on the CPU."""
    import numpy as np

    from mpit_tpu_torch.models.flat import FlatModel, flatten_module, value_and_grad_nll
    from mpit_tpu_torch.models.mnist import make_model
    from mpit_tpu_torch.optim.msgd import MSGDConfig
    from mpit_tpu_torch.parallel import MeshEASGD, make_mesh

    dp, batch, side = 4, 128, 32
    # Uniform random pixels, not the fixture: its digits are 8x8 scans
    # upsampled 4x, so 2x2 pooling windows hold exact ties, and cuDNN and
    # the CPU (which round neighbouring outputs differently) route the
    # gradient of a tie to different elements.  Without ties the two
    # devices differ only by summation order.
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.random((3, dp, batch, side * side), dtype=np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, size=(3, dp, batch)))
    cfg = MSGDConfig(lr=1e-2, mom=0.99, lrd=1e-3, lrp=1.0)
    w0 = flatten_module(make_model("cnn", side), 1).w0
    finals = {}
    for device in ("cuda", "cpu"):
        flat = FlatModel(make_model("cnn", side).to(device), w0.to(device))
        tr = MeshEASGD(make_mesh(dp=dp, device=device), value_and_grad_nll(flat),
                       cfg, mva=0.9 / dp, su=2)
        state = tr.init(flat.w0)
        # Stagger the rows' counters so every row decays its lr differently.
        state["k"].copy_(torch.arange(dp, dtype=torch.int32) * 100)
        initial = {k: v.cpu().clone() for k, v in state.items()}
        commit.launches = 0
        for s in range(3):
            state, loss = tr.step(state, xs[s].to(device), ys[s].to(device))
        if device == "cuda":
            torch.cuda.synchronize()
            launches = commit.launches
            if launches != tr.steps:
                raise AssertionError(f"dp=4: {launches} K1 launches in "
                                     f"{tr.steps} steps")
        if not bool(torch.isfinite(loss).all()):
            raise AssertionError(f"dp=4 loss not finite on {device}: {loss}")
        finals[device] = {k: v.cpu() for k, v in state.items()}
    # The gap between the devices is held against what the three steps
    # changed, not against the state: w and the center stay near w0, and
    # vt sums three updates of about 1e-6..1e-5 on most elements.  cuDNN
    # and the CPU sum the convolutions in different orders, which leaves
    # the gap at f32 rounding of the gradients (max 5e-7 for w, 2.5e-7 for
    # vt, 8.6e-8 for the center, measured on an H100).  A row given another
    # row's lr moves its update by 7% or more (clr 0.01/(1 + k*1e-3) at
    # k = 0, 100, 200, 300), and a dropped retract moves w by 0.225 times
    # its drift since the last sync: far past both limits.
    readings = {}
    for key in ("w", "vt", "center"):
        gap = finals["cuda"][key] - finals["cpu"][key]
        change = finals["cpu"][key] - initial[key]
        readings[key] = {
            "max_abs_gap": float(gap.abs().max()),
            "max_abs_change": float(change.abs().max()),
            "gap_over_change": float(gap.norm() / change.norm()),
        }
    print("dp=4: 3 steps, cuda vs cpu " + json.dumps(readings))
    for key, r in readings.items():
        if not (r["max_abs_gap"] <= DP4_MAX_ABS_GAP
                and r["gap_over_change"] <= DP4_GAP_OVER_CHANGE):
            raise AssertionError(f"dp=4: {key} on the card differs from the CPU "
                                 f"beyond the limits: {r}")
    return {"launches": launches, "steps": 3}


def launch_msgd(torch, commit):
    from mpit_tpu_torch.train import launch

    commit.launches = 0
    res = launch.main(["--np", "1", "--opt", "msgd", "--epochs", "1"])
    launches = commit.launches
    err = res["final_test_err"]
    print(f"launch --np 1 --opt msgd: test_err {err} k1_launches {launches} "
          f"steps {res['steps']}")
    if launches <= 0 or launches != res["steps"]:
        raise AssertionError(f"launch --np 1 --opt msgd launched K1 {launches} "
                             f"times in {res['steps']} steps")
    if not (0.0 <= err < 0.9):
        raise AssertionError(f"msgd did not learn: test_err {err}")
    return {"launches": launches, "steps": res["steps"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from mpit_tpu_torch.models.flat import flatten_module
    from mpit_tpu_torch.models.mnist import make_model
    from mpit_tpu_torch.ops import build
    from mpit_tpu_torch.ops.fused_update import fused_nesterov_commit
    from mpit_tpu_torch.train.mesh_launch import FLAGSHIP_BENCH_KWARGS, MESH_LAUNCH_DEFAULTS
    from mpit_tpu_torch.train.trainer import TRAINER_DEFAULTS
    from mpit_tpu_torch.utils.platform import pin_float32

    pin_float32()
    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(f"device: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    secs = build.build_all()
    for name, s in secs.items():
        print(f"build {name}: {s:.1f}s")
        print(build.library_path(name).with_suffix(".log").read_text().strip())

    mesh_cfg = MESH_LAUNCH_DEFAULTS.merged(FLAGSHIP_BENCH_KWARGS)
    n_mesh = flatten_module(make_model(mesh_cfg.model, mesh_cfg.side), 1).size
    n_msgd = flatten_module(make_model(TRAINER_DEFAULTS.model, TRAINER_DEFAULTS.side), 1).size
    k1 = check_k1(torch, n_mesh, n_msgd)
    paths = k1["paths"]
    paths["headline"] = headline(torch, fused_nesterov_commit)
    paths["easgd_dp4"] = easgd_dp4(torch, fused_nesterov_commit)
    paths["launch_msgd"] = launch_msgd(torch, fused_nesterov_commit)
    k1["launches"] = paths["headline"]["launches"]

    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
