#!/usr/bin/env python3
"""Same-card A/B of K1 (fused Nesterov commit) and K3 (fused Adam): other
versions of ``mpit_tpu_torch/ops/csrc/fused_update.cu`` (and of its
wrapper module) against the ones in this checkout.

Each other version is a directory of its own under ``.ab/`` (listed in
``.gitignore``) holding its ``fused_update.cu`` and, where its wrapper
differs, its ``fused_update.py``; an earlier commit's come from git::

    mkdir -p .ab/old
    git show <commit>:mpit_tpu_torch/ops/csrc/fused_update.cu > .ab/old/fused_update.cu
    git show <commit>:mpit_tpu_torch/ops/fused_update.py > .ab/old/fused_update.py
    python3 tools/fused_update_ab.py --old .ab/old [--old .ab/other ...]

It builds each source under a library name of its own, with the current
build's flags (a version without its own wrapper module gets this
checkout's, bound to its library), holds every version bit-equal to the
plain twin at every shape, and then times them in turns (each old one,
this checkout's twice, the old ones again in reverse: A, B, new, new, B,
A) on one card in one process, at the shapes the main path gives them:

- device us, cold: queued behind a hold (``chip_smoke.time_ms``), over
  buffer sets that together exceed twice the L2, so every launch finds
  its operands in device memory;
- device us, warm: queued, one buffer set (an MNIST step's 2.18 MB
  vectors can find theirs in the L2);
- call us: each wrapper (the old module bound to the old library) called
  from a host loop, as a training step calls it.

Each number is the mean of the version's two turns; both turns are kept.
The per-launch floor, ``torch.cuda._sleep(1)`` queued the same way, is
timed beside them. Prints one JSON object and writes it to ``--out``.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

# (kernel, label, rows, n, retract): K1 at the headline's commit (one row,
# with and without the sync round's retract), at dp=4 and in the 1-D form
# of `launch --np 1 --opt msgd`; K3 at a server's shard (np=4) and at the
# whole vector (adam-single).
SHAPES = (
    ("k1", "1 x 544,522", 1, 544522, False),
    ("k1", "1 x 544,522 + retract", 1, 544522, True),
    ("k1", "4 x 544,522", 4, 544522, False),
    ("k1", "1-D 10,250", 0, 10250, False),
    ("k3", "272,261", 0, 272261, False),
    ("k3", "544,522", 0, 544522, False),
)


def build_old(src: pathlib.Path) -> ctypes.CDLL:
    """``src`` built as the port builds ``fused_update.cu``, under a name of
    its own in the port's build directory."""
    from mpit_tpu_torch.ops import build

    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = build.BUILD_DIR / f"libfused_update_ab_{tag}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc(), *build.flags("fused_update"), "-o", str(out), str(src)],
                       check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def load_old_module(path: pathlib.Path, lib: ctypes.CDLL, name: str):
    """A wrapper module (``path``, or this checkout's where it is missing),
    its ``_lib`` bound to ``lib``."""
    if not path.exists():
        path = REPO / "mpit_tpu_torch" / "ops" / "fused_update.py"
    spec = importlib.util.spec_from_file_location(f"fused_update_ab_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    f32, i64, ptr = ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p
    lib.mpit_nesterov_commit.argtypes = [ptr] * 5 + [i64, i64, f32, ptr]
    lib.mpit_adam.argtypes = [ptr] * 5 + [i64] + [f32] * 5 + [ptr]
    for fn in (lib.mpit_nesterov_commit, lib.mpit_adam):
        fn.restype = ctypes.c_int
    mod._lib = lambda: lib
    return mod


def operands(torch, kernel, rows, n, gen):
    """One buffer set: K1's (w, vt, g, sug, clr) or K3's (p, g, m, v,
    lr_t); 1-D where ``rows`` is 0."""
    dev = torch.device("cuda")
    shape = (n,) if rows == 0 else (rows, n)
    vecs = [torch.randn(shape, device=dev, generator=gen) for _ in range(4)]
    if kernel == "k1":
        vecs[3].mul_(1e-2)
        clr = (torch.tensor(0.01, device=dev) if rows == 0
               else torch.linspace(0.01, 0.04, rows, device=dev))
        return (*vecs, clr)
    vecs[3].abs_()
    return (*vecs, torch.tensor(1e-3 * math.sqrt(1 - 0.999) / (1 - 0.9), device=dev))


def caller(kernel, retract, mod):
    """``mod``'s wrapper over one buffer set."""
    if kernel == "k1":
        return lambda w, vt, g, sug, clr: mod.fused_nesterov_commit(
            w, vt, g, clr, sug=sug if retract else None)
    return lambda p, g, m, v, lr_t: mod.fused_adam(p, g, m, v, lr_t)


def check(torch, kernel, retract, fns, base):
    """Each version bit-equal to the twin on copies of ``base``."""
    from mpit_tpu_torch.ops import fused_update as fu

    if kernel == "k1":
        w, vt, g, sug, clr = base
        want = fu.fused_nesterov_commit_reference(w, vt, g, clr, sug=sug if retract else None)
        outs = lambda s: (s[0], s[1])  # noqa: E731
    else:
        p, g, m, v, lr_t = base
        want = fu.fused_adam_reference(p, g, m, v, lr_t)
        outs = lambda s: (s[0], s[2], s[3])  # noqa: E731
    for name, fn in fns.items():
        s = tuple(x.clone() for x in base)
        fn(*s)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(outs(s), want)):
            raise AssertionError(f"{name} {kernel} differs from its twin")


def host_breakdown(torch, mod, reps=5000):
    """Host us of each part of this checkout's call, by ``perf_counter``
    over ``reps`` calls: the checks; the raw stream; the C entry through
    ctypes with no launch (an empty vector, refused before the launch);
    the C entry with its launch; the whole wrapper.  On vectors of 4,096
    floats, so that the card keeps up with the host and the launch queue
    never fills: the host's cost does not depend on the length."""
    import time

    n = 4096
    gen = torch.Generator(device="cuda").manual_seed(1)
    w, vt, g, _, clr = operands(torch, "k1", 1, n, gen)
    p, g3, m, v, lr_t = operands(torch, "k3", 0, n, gen)
    lib = mod._lib()
    k1, k3, stream = lib.mpit_nesterov_commit, lib.mpit_adam, mod._cuda_stream(w)
    pw, pvt, pg, pc = w.data_ptr(), vt.data_ptr(), g.data_ptr(), clr.data_ptr()
    pp, pg3, pm, pv, pl = (t.data_ptr() for t in (p, g3, m, v, lr_t))
    parts = {
        "k1_checks": lambda: mod._check(w, vt, g, clr, None),
        "k1_stream": lambda: mod._cuda_stream(w),
        "k1_ctypes_no_launch": lambda: k1(pw, pvt, pg, pc, None, 0, n, 0.0, stream),
        "k1_c_launch": lambda: k1(pw, pvt, pg, pc, None, 1, n, 0.0, stream),
        "k1_call": lambda: mod.fused_nesterov_commit(w, vt, g, clr),
        "k3_checks": lambda: mod._check_adam(p, g3, m, v, lr_t),
        "k3_ctypes_no_launch": lambda: k3(pp, pg3, pm, pv, pl, 0, 0.9, 0.1, 0.999, 0.001,
                                          1e-8, stream),
        "k3_c_launch": lambda: k3(pp, pg3, pm, pv, pl, n, 0.9, 0.1, 0.999, 0.001, 1e-8,
                                  stream),
        "k3_call": lambda: mod.fused_adam(p, g3, m, v, lr_t),
    }
    out = {}
    for name, fn in parts.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=pathlib.Path, action="append",
                    help="a directory holding another fused_update.cu (and its "
                         "fused_update.py); repeat for more")
    ap.add_argument("--out", default="chiprun_out/fused_update_ab.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("fused_update_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from mpit_tpu_torch.ops import fused_update as new
    from mpit_tpu_torch.utils.platform import pin_float32

    pin_float32()
    mods = {d.name: load_old_module(d / "fused_update.py", build_old(d / "fused_update.cu"),
                                    d.name)
            for d in args.old}
    if "new" in mods:
        raise SystemExit("--old: 'new' names this checkout's version")
    olds = list(mods)
    mods["new"] = new
    turns = olds + ["new", "new"] + olds[::-1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"device": cs.nvidia_smi(), "torch": torch.__version__,
              "floor_us": [], "shapes": []}
    for kernel, label, rows, n, retract in SHAPES:
        base = operands(torch, kernel, rows, n, gen)
        fns = {name: caller(kernel, retract, mod) for name, mod in mods.items()}
        check(torch, kernel, retract, fns, base)
        n_vecs = (4 if retract else 3) if kernel == "k1" else 4
        set_bytes = n_vecs * 4 * base[0].numel()
        sets = [tuple(x.clone() for x in base) for _ in range(cs.n_sets(set_bytes))]
        row = {"kernel": kernel, "shape": label,
               **{f"{name}_{metric}": [] for name in fns
                  for metric in ("cold_us", "warm_us", "call_us")}}
        for name in turns:
            fn = fns[name]
            row[f"{name}_cold_us"].append(
                1e3 * cs.time_ms(torch, cs.rotating(fn, sets), queued=True))
            row[f"{name}_warm_us"].append(
                1e3 * cs.time_ms(torch, lambda fn=fn: fn(*sets[0]), queued=True))
            row[f"{name}_call_us"].append(1e3 * cs.time_ms(torch, cs.rotating(fn, sets)))
        result["floor_us"].append(
            1e3 * cs.time_ms(torch, lambda: torch.cuda._sleep(1), queued=True))
        for key in [k for k in row if k.endswith("_us")]:
            row[key.replace("_us", "_mean_us")] = sum(row[key]) / len(row[key])
        # Bytes: K1 reads w, vt, g (sug) and writes w, vt; K3 reads p, g,
        # m, v and writes p, m, v.
        moved = (n_vecs + 2 if kernel == "k1" else 7) * 4 * base[0].numel()
        row["bound_us"] = 1e6 * moved / cs.HBM_BYTES_PER_S
        result["shapes"].append(row)
        print(json.dumps({k: row[k] for k in row if not isinstance(row[k], list)}))
        del sets
    result["host_us"] = host_breakdown(torch, new)
    print(json.dumps({"host_us": result["host_us"]}))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(result["device"])
    print(json.dumps({"floor_us": result["floor_us"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
