#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on one card.

Two modes, each through its entry point under the entry point's own
``torch.profiler`` trace (``profile_dir``):

- MNIST EASGD (default): ``mesh_launch.run`` at ``FLAGSHIP_BENCH_KWARGS``
  with ``--dp`` worker rows; the trace's ``epoch N`` ranges;
- the LM (``--lm default``, ``--lm longcontext`` or ``--lm
  longcontext_32k``): ``lm_launch.run`` at ``LM_LAUNCH_DEFAULTS`` or at the
  long-context widths at context 8,192 or 32,768, one step per log window;
  the trace's ``window N`` ranges; ``--sp N --layout zigzag|contiguous``
  runs its attention as ring attention over N virtual ranks of the card,
  and ``--attn_dtype float32`` its attention in float32 (the float32 K4,
  K5 and K6 on the tensor cores) instead of bfloat16.

The first range is left out.  Each range ends when its losses reach the
host, so its device work lies inside it.  Over the later ranges it
reports:

- the wall time per step (host clock, profiler on);
- the device's busy share: the summed time of CUDA kernels and memory
  operations inside the ranges over the ranges' wall time (one stream, so
  they do not overlap);
- device operations per step, and the ten heaviest by device time;
- each group's launches, device time per step and share of device time:
  K1 (``nesterov_commit``), K4 (``fa_fwd``), K5 (``fa_bwd_tc`` in
  bfloat16 or ``fa_bwd_tf32`` in float32, with its dQ reduction
  ``dq_reduce``), K6
  (``fa_bwd_dq`` + ``fa_bwd_dkdv``, their ``_tc`` kernels in bfloat16 and
  ``_tf32`` kernels in float32), the matrix
  products (cuBLAS), the copies (layout transposes and casts among them)
  and the rest; for the LM also the peak of allocated device memory.

Writes the Chrome trace to ``--out``/<mode>/trace.json and the summary to
``--out``/step_profile_<mode>.json.  Needs a CUDA card:

    python3 tools/torch_step_profile.py --dp 1 --epochs 6
    python3 tools/torch_step_profile.py --lm longcontext --steps 8
    python3 tools/torch_step_profile.py --lm longcontext_32k --steps 5
    python3 tools/torch_step_profile.py --lm longcontext --steps 8 --sp 4
    python3 tools/torch_step_profile.py --lm longcontext --steps 8 --attn_dtype float32
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from collections import defaultdict

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from mpit_tpu_torch.train import lm_launch  # noqa: E402
from mpit_tpu_torch.train.mesh_launch import (  # noqa: E402
    FLAGSHIP_BENCH_KWARGS,
    MESH_LAUNCH_DEFAULTS,
    run,
)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Kernel groups by name, first match wins.
GROUPS = (
    ("k1", ("nesterov_commit",)),
    ("k4", ("fa_fwd",)),  # fa_fwd_tc_kernel (bf16), fa_fwd_tf32_kernel (f32)
    # the sweeps (bf16 fa_bwd_tc_kernel, f32 fa_bwd_tf32_kernel) and their dQ sum
    ("k5", ("fa_bwd_fused", "fa_bwd_tc", "fa_bwd_tf32", "dq_reduce")),
    ("k6", ("fa_bwd_dq", "fa_bwd_dkdv")),  # _tc (bf16), _tf32 (f32)
    ("matmul", ("gemm", "xmma", "cutlass")),
    ("copy", ("copy", "memcpy")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(key in low for key in keys):
            return group
    return "other"


def summarize(trace: dict, steps_per_epoch: int, prefix: str = "epoch ") -> dict:
    """Per-step numbers from a ``profile_dir`` trace, over every range
    named ``<prefix>N`` but the first; each range holds
    ``steps_per_epoch`` steps."""
    events = trace["traceEvents"]
    ranges = sorted(
        (ev for ev in events if ev.get("cat") == "user_annotation"
         and str(ev.get("name", "")).startswith(prefix)),
        key=lambda ev: ev["ts"])[1:]
    if not ranges:
        raise ValueError(f"the trace holds no {prefix!r} range after the first")
    windows = [(ev["ts"], ev["ts"] + ev["dur"]) for ev in ranges]
    by_name = defaultdict(lambda: [0, 0.0])
    for ev in events:
        if ev.get("cat") in DEVICE_CATS and any(
                lo <= ev["ts"] <= hi for lo, hi in windows):
            entry = by_name[ev["name"]]
            entry[0] += 1
            entry[1] += ev.get("dur", 0.0)
    steps = steps_per_epoch * len(ranges)
    wall_us = sum(hi - lo for lo, hi in windows)
    device_us = sum(us for _, us in by_name.values())
    groups = defaultdict(lambda: [0, 0.0])
    for name, (n, us) in by_name.items():
        g = groups[group_of(name)]
        g[0] += n
        g[1] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "epochs": len(ranges), "steps": steps,
        "step_ms": wall_us / steps / 1e3,
        "device_busy_share": device_us / wall_us,
        "device_ms_per_step": device_us / steps / 1e3,
        "device_ops_per_step": sum(n for n, _ in by_name.values()) / steps,
        "k1_launches_per_step": groups["k1"][0] / steps,
        "k1_us_per_step": groups["k1"][1] / steps,
        "groups": {g: {"launches_per_step": n / steps, "us_per_step": us / steps,
                       "device_share": us / device_us if device_us else 0.0}
                   for g, (n, us) in sorted(groups.items())},
        "top": [{"name": name[:90], "count": n, "us": us}
                for name, (n, us) in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--lm", choices=("", "default", "longcontext", "longcontext_32k"),
                    default="")
    ap.add_argument("--steps", type=int, default=8, help="LM steps (--lm)")
    ap.add_argument("--sp", type=int, default=1, help="ring attention ranks (--lm)")
    ap.add_argument("--layout", default="zigzag", help="the ring's layout (--lm)")
    ap.add_argument("--attn_dtype", default="", choices=("", "bfloat16", "float32"),
                    help="the LM's attention dtype (--lm; default: lm_launch's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", type=int, default=FLAGSHIP_BENCH_KWARGS["side"])
    ap.add_argument("--out", default="chiprun_out/step_profile")
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    if args.lm:
        mode = (f"lm_{args.lm}" + (f"_sp{args.sp}_{args.layout}" if args.sp > 1 else "")
                + (f"_{args.attn_dtype}" if args.attn_dtype else ""))
        widths = {"default": {}, "longcontext": lm_launch.LONGCONTEXT_KWARGS,
                  "longcontext_32k": lm_launch.LONGCONTEXT_32K_KWARGS}[args.lm]
        if args.device == "cpu":  # a dry run of the tool at toy widths
            widths = dict(seq_len=64, d_model=32, n_heads=4, n_layers=1, batch=2,
                          attn_dtype="float32")
        if args.attn_dtype:
            widths = dict(widths, attn_dtype=args.attn_dtype)
        cfg = lm_launch.LM_LAUNCH_DEFAULTS.merged(
            widths, steps=args.steps, log_every=1, device=args.device,
            sp=args.sp, layout=args.layout, profile_dir=str(out / mode))
        if args.device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        res = lm_launch.run(cfg)
        trace = json.loads((out / mode / "trace.json").read_text())
        peak = (torch.cuda.max_memory_allocated() / 1e9 if args.device != "cpu"
                else None)
        summary = {"device": res["device_name"], "mode": mode, "mesh": res["mesh"],
                   "tokens_per_sec": res["tokens_per_sec"], "peak_mem_gb": peak,
                   **summarize(trace, 1, prefix="window ")}
    else:
        mode = f"dp{args.dp}"
        cfg = MESH_LAUNCH_DEFAULTS.merged(
            FLAGSHIP_BENCH_KWARGS, dp=args.dp, epochs=args.epochs, side=args.side,
            device=args.device, profile_dir=str(out / mode))
        res = run(cfg)
        steps_per_epoch = res["samples_trained"] // (len(res["history"]) * args.dp
                                                     * cfg.batch)
        trace = json.loads((out / mode / "trace.json").read_text())
        summary = {"device": res["device_name"], "dp": args.dp,
                   "steps_per_epoch": steps_per_epoch,
                   **summarize(trace, steps_per_epoch)}
    (out / f"step_profile_{mode}.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
