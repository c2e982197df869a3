#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on one card.

Runs the flagship EASGD configuration through its entry point,
``mpit_tpu_torch.train.mesh_launch.run`` at ``FLAGSHIP_BENCH_KWARGS`` with
``--dp`` worker rows, under the entry point's own ``torch.profiler`` trace
(``profile_dir``), then reads the trace.  Epoch 0 is left out; over the
later epochs' ``epoch N`` ranges (each ends when its losses reach the
host, so its device work lies inside it) it reports:

- the wall time per step (host clock, profiler on);
- the device's busy share: the summed time of CUDA kernels and memory
  operations inside the ranges over the ranges' wall time (one stream, so
  they do not overlap);
- device operations per step, and the ten heaviest by device time, with
  K1 (``nesterov_commit``) among them.

Writes the Chrome trace to ``--out``/dp<dp>/trace.json and the summary to
``--out``/step_profile_dp<dp>.json.  Needs a CUDA card:

    python3 tools/torch_step_profile.py --dp 1 --epochs 6
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from collections import defaultdict

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from mpit_tpu_torch.train.mesh_launch import (  # noqa: E402
    FLAGSHIP_BENCH_KWARGS,
    MESH_LAUNCH_DEFAULTS,
    run,
)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize(trace: dict, steps_per_epoch: int) -> dict:
    """Per-step numbers from a ``profile_dir`` trace of ``mesh_launch``,
    over every ``epoch N`` range but the first."""
    events = trace["traceEvents"]
    epochs = sorted(
        (ev for ev in events if ev.get("cat") == "user_annotation"
         and str(ev.get("name", "")).startswith("epoch ")),
        key=lambda ev: ev["ts"])[1:]
    if not epochs:
        raise ValueError("the trace holds no epoch range after epoch 0")
    windows = [(ev["ts"], ev["ts"] + ev["dur"]) for ev in epochs]
    by_name = defaultdict(lambda: [0, 0.0])
    for ev in events:
        if ev.get("cat") in DEVICE_CATS and any(
                lo <= ev["ts"] <= hi for lo, hi in windows):
            entry = by_name[ev["name"]]
            entry[0] += 1
            entry[1] += ev.get("dur", 0.0)
    steps = steps_per_epoch * len(epochs)
    wall_us = sum(hi - lo for lo, hi in windows)
    device_us = sum(us for _, us in by_name.values())
    k1 = [(n, us) for name, (n, us) in by_name.items() if "nesterov_commit" in name]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "epochs": len(epochs), "steps": steps,
        "step_ms": wall_us / steps / 1e3,
        "device_busy_share": device_us / wall_us,
        "device_ms_per_step": device_us / steps / 1e3,
        "device_ops_per_step": sum(n for n, _ in by_name.values()) / steps,
        "k1_launches_per_step": sum(n for n, _ in k1) / steps,
        "k1_us_per_step": sum(us for _, us in k1) / steps,
        "top": [{"name": name[:90], "count": n, "us": us}
                for name, (n, us) in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", type=int, default=FLAGSHIP_BENCH_KWARGS["side"])
    ap.add_argument("--out", default="chiprun_out/step_profile")
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    trace_dir = out / f"dp{args.dp}"
    cfg = MESH_LAUNCH_DEFAULTS.merged(
        FLAGSHIP_BENCH_KWARGS, dp=args.dp, epochs=args.epochs, side=args.side,
        device=args.device, profile_dir=str(trace_dir))
    res = run(cfg)
    steps_per_epoch = res["samples_trained"] // (len(res["history"]) * args.dp * cfg.batch)
    trace = json.loads((trace_dir / "trace.json").read_text())
    summary = {"device": res["device_name"], "dp": args.dp,
               "steps_per_epoch": steps_per_epoch,
               **summarize(trace, steps_per_epoch)}
    (out / f"step_profile_dp{args.dp}.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
