#!/usr/bin/env python3
"""Same-card A/B of K1 (fused Nesterov commit), K2 (fused elastic) and K3
(fused Adam): other versions of ``mpit_tpu_torch/ops/csrc/fused_update.cu`` (and of its
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
- device us, behind: what the call adds queued behind an elementwise
  PyTorch kernel (``add_`` on a vector of the operands' length), as a
  training step queues it (``chip_smoke.behind_ms``): no sweep before it
  to overlap with;
- call us: each wrapper (the old module bound to the old library) called
  from a host loop, as a training step calls it.

K2 runs at the comm-only EAMSGD path's length (544,522), one float longer
(a scalar tail) and as views one float into their buffers (a scalar
head); a version whose wrapper takes ``out`` writes ``sug`` into a buffer
of the set, at the same offset, and one without allocates it per call.
Each version also runs comm-only EAMSGD's card work of one round as
``optim/easgd.py`` does (the center copied from host memory, K2, ``sug``
copied back), timed on the host clock in blocks of rounds
(``round_us``: each block's mean).

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
import inspect
import json
import math
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

# (kernel, label, rows, n, retract, offset): K1 at the headline's commit
# (one row, with and without the sync round's retract), at dp=4 and in the
# 1-D form of `launch --np 1 --opt msgd`; K2 at comm-only EAMSGD's vector,
# one float longer, and one float into its buffers; K3 at a server's shard
# (np=4) and at the whole vector (adam-single).  `offset`: floats into
# each operand's buffer.
SHAPES = (
    ("k1", "1 x 544,522", 1, 544522, False, 0),
    ("k1", "1 x 544,522 + retract", 1, 544522, True, 0),
    ("k1", "4 x 544,522", 4, 544522, False, 0),
    ("k1", "1-D 10,250", 0, 10250, False, 0),
    ("k2", "544,522", 0, 544522, False, 0),
    ("k2", "544,523", 0, 544523, False, 0),
    ("k2", "544,522 one float in", 0, 544522, False, 1),
    ("k3", "272,261", 0, 272261, False, 0),
    ("k3", "544,522", 0, 544522, False, 0),
)
K2_MVA = 0.45  # ps_eamsgd_lr0_np4's
EAMSGD_N = 544522  # comm-only EAMSGD's vector, the CNN at side 32


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
    lib.mpit_elastic.argtypes = [ptr] * 3 + [i64, f32, ptr]
    lib.mpit_adam.argtypes = [ptr] * 5 + [i64] + [f32] * 5 + [ptr]
    for fn in (lib.mpit_nesterov_commit, lib.mpit_elastic, lib.mpit_adam):
        fn.restype = ctypes.c_int
    mod._lib = lambda: lib
    return mod


def operands(torch, kernel, rows, n, gen, offset=0):
    """One buffer set: K1's (w, vt, g, sug, clr), K2's (w, center, out) or
    K3's (p, g, m, v, lr_t); 1-D where ``rows`` is 0, each vector
    ``offset`` floats into a buffer of its own."""
    dev = torch.device("cuda")
    shape = (n,) if rows == 0 else (rows, n)
    vecs = [torch.randn(offset + math.prod(shape), device=dev, generator=gen)[offset:]
            .view(shape) for _ in range(4)]
    if kernel == "k2":
        return tuple(vecs[:3])
    if kernel == "k1":
        vecs[3].mul_(1e-2)
        clr = (torch.tensor(0.01, device=dev) if rows == 0
               else torch.linspace(0.01, 0.04, rows, device=dev))
        return (*vecs, clr)
    vecs[3].abs_()
    return (*vecs, torch.tensor(1e-3 * math.sqrt(1 - 0.999) / (1 - 0.9), device=dev))


def takes_out(mod) -> bool:
    """Whether ``mod``'s K2 wrapper takes a caller-owned ``out``."""
    return "out" in inspect.signature(mod.fused_elastic).parameters


def caller(kernel, retract, mod):
    """``mod``'s wrapper over one buffer set."""
    if kernel == "k1":
        return lambda w, vt, g, sug, clr: mod.fused_nesterov_commit(
            w, vt, g, clr, sug=sug if retract else None)
    if kernel == "k2":
        if takes_out(mod):
            return lambda w, c, out: mod.fused_elastic(w, c, K2_MVA, out=out)
        return lambda w, c, out: mod.fused_elastic(w, c, K2_MVA)
    return lambda p, g, m, v, lr_t: mod.fused_adam(p, g, m, v, lr_t)


def check(torch, kernel, retract, fns, base):
    """Each version bit-equal to the twin on copies of ``base``."""
    from mpit_tpu_torch.ops import fused_update as fu

    if kernel == "k1":
        w, vt, g, sug, clr = base
        want = fu.fused_nesterov_commit_reference(w, vt, g, clr, sug=sug if retract else None)
        outs = lambda s, r: (s[0], s[1])  # noqa: E731
    elif kernel == "k2":
        want = fu.fused_elastic_reference(base[0], base[1], K2_MVA)
        outs = lambda s, r: r  # noqa: E731 (w, sug)
    else:
        p, g, m, v, lr_t = base
        want = fu.fused_adam_reference(p, g, m, v, lr_t)
        outs = lambda s, r: (s[0], s[2], s[3])  # noqa: E731
    for name, fn in fns.items():
        s = tuple(offset_clone(x) for x in base)
        r = fn(*s)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(outs(s, r), want)):
            raise AssertionError(f"{name} {kernel} differs from its twin")


def offset_clone(t):
    """A copy of ``t`` at the same offset within 16 bytes as ``t``."""
    import torch

    offset = (t.data_ptr() % 16) // t.element_size()
    buf = torch.empty(offset + t.numel(), dtype=t.dtype, device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


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
    w2, c2, out2 = operands(torch, "k2", 0, n, gen)
    k2, pw2, pc2, po2 = lib.mpit_elastic, w2.data_ptr(), c2.data_ptr(), out2.data_ptr()
    parts = {
        "k1_checks": lambda: mod._check(w, vt, g, clr, None),
        "k1_stream": lambda: mod._cuda_stream(w),
        "k1_ctypes_no_launch": lambda: k1(pw, pvt, pg, pc, None, 0, n, 0.0, stream),
        "k1_c_launch": lambda: k1(pw, pvt, pg, pc, None, 1, n, 0.0, stream),
        "k1_call": lambda: mod.fused_nesterov_commit(w, vt, g, clr),
        "k2_checks": lambda: mod._check_operands(mod._K2_NAMES, (w2, c2), 2),
        "k2_empty_like": lambda: torch.empty_like(w2),
        "k2_ctypes_no_launch": lambda: k2(pw2, pc2, po2, 0, K2_MVA, stream),
        "k2_c_launch": lambda: k2(pw2, pc2, po2, n, K2_MVA, stream),
        "k2_call": lambda: mod.fused_elastic(w2, c2, K2_MVA),
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


def eamsgd_round_us(torch, mod, n, blocks=5, rounds=200):
    """Host us of comm-only EAMSGD's card work in one exchange round
    (``optim/easgd.py``): the center's copy from host memory to the card,
    K2 through ``mod``'s wrapper, ``sug``'s copy back to host memory.  The
    mean of each of ``blocks`` blocks of ``rounds`` rounds."""
    import time

    import numpy as np

    center_host = np.random.default_rng(5).standard_normal(n, dtype=np.float32)
    sug_host = np.zeros_like(center_host)
    w = torch.randn(n, device="cuda", generator=torch.Generator("cuda").manual_seed(6))
    out = {"out": torch.empty_like(w)} if takes_out(mod) else {}

    def one_round():
        center = torch.from_numpy(center_host).to(w.device, copy=True)
        _, sug = mod.fused_elastic(w, center, K2_MVA, **out)
        np.copyto(sug_host, sug.cpu().numpy())

    for _ in range(20):
        one_round()
    means = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(rounds):
            one_round()
        means.append((time.perf_counter() - t0) / rounds * 1e6)
    return means


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
    for kernel, label, rows, n, retract, offset in SHAPES:
        base = operands(torch, kernel, rows, n, gen, offset)
        fns = {name: caller(kernel, retract, mod) for name, mod in mods.items()}
        check(torch, kernel, retract, fns, base)
        # The vectors every version reads (K2: w and the center).
        n_vecs = {"k1": 4 if retract else 3, "k2": 2, "k3": 4}[kernel]
        set_bytes = n_vecs * 4 * base[0].numel()
        sets = [tuple(offset_clone(x) for x in base) for _ in range(cs.n_sets(set_bytes))]
        scratch = torch.zeros_like(base[0])
        row = {"kernel": kernel, "shape": label,
               **{f"{name}_{metric}": [] for name in fns
                  for metric in ("cold_us", "warm_us", "behind_us", "call_us")}}
        for name in turns:
            fn = fns[name]
            row[f"{name}_cold_us"].append(
                1e3 * cs.time_ms(torch, cs.rotating(fn, sets), queued=True))
            row[f"{name}_warm_us"].append(
                1e3 * cs.time_ms(torch, lambda fn=fn: fn(*sets[0]), queued=True))
            row[f"{name}_behind_us"].append(
                1e3 * cs.behind_ms(torch, cs.rotating(fn, sets), lambda: scratch.add_(1.0)))
            row[f"{name}_call_us"].append(1e3 * cs.time_ms(torch, cs.rotating(fn, sets)))
        result["floor_us"].append(
            1e3 * cs.time_ms(torch, lambda: torch.cuda._sleep(1), queued=True))
        for key in [k for k in row if k.endswith("_us")]:
            row[key.replace("_us", "_mean_us")] = sum(row[key]) / len(row[key])
        # Bytes: K1 reads w, vt, g (sug) and writes w, vt; K2 reads w, c
        # and writes w, sug; K3 reads p, g, m, v and writes p, m, v.
        moved = {"k1": n_vecs + 2, "k2": 4, "k3": 7}[kernel] * 4 * base[0].numel()
        row["bound_us"] = 1e6 * moved / cs.HBM_BYTES_PER_S
        result["shapes"].append(row)
        print(json.dumps({k: row[k] for k in row if not isinstance(row[k], list)}))
        del sets
    rounds = {name: [] for name in mods}
    for name in turns:
        rounds[name] += eamsgd_round_us(torch, mods[name], EAMSGD_N)
    result["eamsgd_round_us"] = {
        name: {"blocks": r, "mean": sum(r) / len(r), "min": min(r), "max": max(r)}
        for name, r in rounds.items()}
    print(json.dumps({"eamsgd_round_us": {name: {k: v for k, v in r.items() if k != "blocks"}
                                          for name, r in result["eamsgd_round_us"].items()}}))
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
