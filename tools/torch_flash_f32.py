"""Float32 flash attention on the card: K4, K5 and K6 at ``chip_smoke.py``'s
``FA_TIMED`` shapes, each beside its plain twin and
``scaled_dot_product_attention`` on the same float32 tensors.

For each shape it prints and keeps the card ms (queued behind a hold, as
``chip_smoke.time_flash`` times them), the bound (3xTF32, see
``chip_smoke.fa_bound_ms``), the twin's and SDPA's ms and SDPA's backend,
K4 in both output modes, and each kernel's largest gap to its twin.
``--check`` first holds float32 K4 (both modes), K5 (twice, equal bits)
and K6 to their twins at every ``FA_CASES`` shape at ``chip_smoke``'s
limits.  ``--old DIR`` builds another version's float32 K4 and K5
(``DIR/flash_attention.cu`` and ``DIR/flash_common.cuh``, the plain C
entry points ``mpit_fa_fwd`` and ``mpit_fa_bwd_fused`` over 64-key dQ
partial tiles) with this checkout's flags, holds them to the twins too,
and times old and new in turns (old, new, new, old) in this process:
an earlier commit's scalar kernels come from git::

    mkdir -p .ab/scalar
    for f in flash_attention.cu flash_common.cuh; do
      git show <commit>:mpit_tpu_torch/ops/csrc/$f > .ab/scalar/$f; done
    python3 tools/torch_flash_f32.py --check --old .ab/scalar --lm_steps 4

``--truth`` first holds the twin and the kernels (the new K4 and K5, the
scalar K6 and the old ones) to float64 references computed on the card,
at ``lm_default``'s and ``lm_vs_cpu``'s attention.  ``--lm_steps N`` then
runs ``chip_smoke.lm_longcontext_f32`` (``lm_launch``
at ``LONGCONTEXT_KWARGS``, attention in float32) for N steps.  Prints one
JSON object last and writes it to ``chiprun_out/flash_f32.json``.  Needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mpit_tpu_torch.ops import build  # noqa: E402
from mpit_tpu_torch.ops.fused_update import (_cuda_stream,  # noqa: E402
                                             fused_adam, fused_elastic,
                                             fused_nesterov_commit)

fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
OLD_BLOCK_K = 64  # the dQ partials' key tile of the old K5


def build_old(src: pathlib.Path) -> ctypes.CDLL:
    """``src/flash_attention.cu`` compiled with this checkout's flags into
    ``src/_build``; its K4 and K5 entry points bound."""
    out = src / "_build" / "libflash_attention_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.nvcc(), *build.flags("flash_attention"), "-o", str(out),
           str(src / "flash_attention.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geo = [i32] * 6 + [f32, i32]
    lib.mpit_fa_fwd.argtypes = [ptr] * 8 + geo + [i32, ptr]
    lib.mpit_fa_bwd_fused.argtypes = [ptr] * 10 + geo + [ptr]
    lib.mpit_fa_fwd.restype = lib.mpit_fa_bwd_fused.restype = ctypes.c_int
    return lib


def old_fwd(lib, q, k, v, kw, partial=False):
    lead, lq, lk, d = tuple(q.shape[:-2]), q.shape[-2], k.shape[-2], q.shape[-1]
    rows = dict(dtype=torch.float32, device=q.device)
    if partial:
        acc = torch.empty(*lead, lq, d, **rows)
        m, l = torch.empty(*lead, lq, **rows), torch.empty(*lead, lq, **rows)
        outs = (None, None, acc.data_ptr(), m.data_ptr(), l.data_ptr())
    else:
        o, lse = torch.empty_like(q), torch.empty(*lead, lq, **rows)
        outs = (o.data_ptr(), lse.data_ptr(), None, None, None)
    err = lib.mpit_fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), *outs, math.prod(lead),
                          lq, lk, d, kw["q_offset"], kw["kv_offset"], 1.0 / math.sqrt(d),
                          int(kw["causal"]), int(partial), _cuda_stream(q))
    if err:
        raise RuntimeError(f"old K4: CUDA error {err}")
    return (acc, m, l) if partial else (o, lse)


def old_bwd(lib, q, k, v, do, lse, delta, kw):
    lead, lq, lk, d = tuple(q.shape[:-2]), q.shape[-2], k.shape[-2], q.shape[-1]
    dqp = torch.empty(math.ceil(lk / OLD_BLOCK_K), *lead, lq, d, dtype=torch.float32,
                      device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = lib.mpit_fa_bwd_fused(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                dv.data_ptr(), dqp.data_ptr(), math.prod(lead), lq, lk, d,
                                kw["q_offset"], kw["kv_offset"], 1.0 / math.sqrt(d),
                                int(kw["causal"]), _cuda_stream(q))
    if err:
        raise RuntimeError(f"old K5: CUDA error {err}")
    return dq, dk, dv


def queued_ms(fn) -> float:
    """Device ms a call, queued behind a hold, over as many calls as fit a
    quarter second (3 at the least)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    n = max(3, min(cs.TIMED_LAUNCHES, int(0.25 / max(time.perf_counter() - t0, 1e-6))))
    return cs.time_ms(torch, fn, queued=True, n=n)


def inputs(gen, lead, lq, lk, d):
    dev = torch.device("cuda")
    q, k, v = (0.5 * torch.randn(*lead, n, d, device=dev, generator=gen) for n in (lq, lk, lk))
    return q, k, v, torch.randn(*lead, lq, d, device=dev, generator=gen)


def twins(q, k, v, do, kw):
    acc_t, m_t, l_t = fa.block_attention_partial(q, k, v, **kw)
    o_t, lse_t = fa.finalize_partials(acc_t, l_t, q.dtype), fa._lse_of(m_t, l_t)
    delta = (do.float() * o_t.float()).sum(-1)
    want = fa.attention_bwd_reference(q, k, v, do, lse_t, delta, **kw)
    return (acc_t, m_t, l_t, o_t, lse_t), delta, want


def gaps(fwd, fwd_partial, bwd, ref, delta, want, q, k, v, do, bwd_atol):
    """Each output's (max abs gap, share of its limit) against the twins."""
    acc_t, m_t, l_t, o_t, lse_t = ref
    o, lse = fwd()
    acc, m, l = fwd_partial()
    den = torch.where(l_t == 0, 1.0, l_t)[..., None]
    out = {"k4_o": cs.fa_err(torch, o, o_t, cs.FA_FWD_ATOL),
           "k4_lse": cs.fa_err(torch, lse, lse_t, cs.FA_FWD_ATOL),
           "k4_m": cs.fa_err(torch, m, m_t, cs.FA_FWD_ATOL),
           "k4_acc/l": cs.fa_err(torch, acc / den, acc_t / den, cs.FA_FWD_ATOL),
           "k4_l": cs.fa_err(torch, l, l_t, 0.0, cs.FA_PARTIAL_RTOL)}
    got = bwd()
    for grad, a, w in zip(("dq", "dk", "dv"), got, want):
        out[f"k5_{grad}"] = cs.fa_err(torch, a, w, bwd_atol)
    return out


def hold(name, checks):
    for what, (gap, used) in checks.items():
        if not used <= 1.0:
            raise AssertionError(f"{name}: {what} past its limit: gap {gap}, {used} of it")


def check_cases(gen):
    """Float32 K4, K5 (twice, equal bits) and K6 against the twins at every
    FA_CASES shape."""
    out = {}
    for name, lead, lq, lk, d, q_off, kv_off, causal in cs.FA_CASES:
        kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
        q, k, v, do = inputs(gen, lead, lq, lk, d)
        ref, delta, want = twins(q, k, v, do, kw)
        bwd_atol = cs.FA_PAIR_ATOL if (q_off or kv_off) else cs.FA_BWD_ATOL
        checks = gaps(lambda: fa.flash_fwd(q, k, v, **kw),
                      lambda: fa.flash_fwd(q, k, v, partial=True, **kw),
                      lambda: fa.flash_bwd_fused(q, k, v, do, ref[4], delta, **kw),
                      ref, delta, want, q, k, v, do, bwd_atol)
        got5 = fa.flash_bwd_fused(q, k, v, do, ref[4], delta, **kw)
        again5 = fa.flash_bwd_fused(q, k, v, do, ref[4], delta, **kw)
        got6 = fa.flash_bwd_two_kernel(q, k, v, do, ref[4], delta, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got5, again5)):
            raise AssertionError(f"K5 gave other bits on a second run at {name}")
        for grad, a6, w in zip(("dq", "dk", "dv"), got6, want):
            checks[f"k6_{grad}"] = cs.fa_err(torch, a6, w, bwd_atol)
        checks = {key: list(val) for key, val in checks.items()}
        print(f"float32 check {name}: " + json.dumps(checks), flush=True)
        hold(name, {key: tuple(val) for key, val in checks.items()})
        out[name] = checks
        del ref, want, got5, again5, got6
        torch.cuda.empty_cache()
    return out


def float64_reference(q, k, v, do, lse, delta, kw):
    """The attention output and, from the float32 lse and delta the kernels
    are given, the flash backward's grads, all in float64 (the twins cast
    to float32)."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    valid = fa._mask(q.shape[-2], k.shape[-2], kw["q_offset"], kw["kv_offset"],
                     kw["causal"], q.device)
    s = torch.einsum("...qd,...kd->...qk", q, k) * scale
    w = torch.where(valid, torch.exp(s - s.masked_fill(~valid, -math.inf).amax(-1, True)), 0.0)
    o = torch.einsum("...qk,...kd->...qd", w, v) / w.sum(-1, True).clamp_min(1e-300)
    p = torch.where(valid, torch.exp(s - lse.double()[..., None]), 0.0)
    ds = p * (torch.einsum("...qd,...kd->...qk", do, v) - delta.double()[..., None])
    grads = (scale * torch.einsum("...qk,...kd->...qd", ds, k),
             scale * torch.einsum("...qk,...qd->...kd", ds, q),
             torch.einsum("...qk,...qd->...kd", p, do))
    return o, grads


def truth_gaps(gen, name, old):
    """At one FA_CASES shape: each output's largest gap to a float64
    reference computed on the card, for the twin, the kernels (K4, K5, and
    the scalar K6) and, with ``old``, the old K4 and K5."""
    lead, lq, lk, d, q_off, kv_off, causal = next(
        case[1:] for case in cs.FA_CASES if case[0] == name)
    kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
    q, k, v, do = inputs(gen, lead, lq, lk, d)
    ref, delta, want = twins(q, k, v, do, kw)
    lse = ref[4]
    o64, truth = float64_reference(q, k, v, do, lse, delta, kw)
    rows = {"twin": (ref[3], want)}
    rows["new"] = (fa.flash_fwd(q, k, v, **kw)[0],
                   fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw))
    rows["k6"] = (None, fa.flash_bwd_two_kernel(q, k, v, do, lse, delta, **kw))
    if old is not None:
        rows["old"] = (old_fwd(old, q, k, v, kw)[0], old_bwd(old, q, k, v, do, lse, delta, kw))
    out = {"largest": {"o": float(o64.abs().max()),
                       **{g: float(w.abs().max()) for g, w in zip(("dq", "dk", "dv"), truth)}}}
    for who, (o, grads) in rows.items():
        gap = {} if o is None else {"o": float((o.double() - o64).abs().max())}
        for g, a, w in zip(("dq", "dk", "dv"), grads, truth):
            gap[g] = float((a.double() - w).abs().max())
        out[who] = gap
    print(f"float32 against float64 at {name}: " + json.dumps(out), flush=True)
    return out


def timed_shape(gen, name, old):
    lead, lq, lk, d, q_off, kv_off, causal = next(
        case[1:] for case in cs.FA_CASES if case[0] == name)
    kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
    q, k, v, do = inputs(gen, lead, lq, lk, d)
    ref, delta, want = twins(q, k, v, do, kw)
    lse = ref[4]
    rec = {"shape": {"lead": lead, "lq": lq, "lk": lk, "d": d, "causal": causal}}
    rec["gaps_new"] = {key: list(val) for key, val in gaps(
        lambda: fa.flash_fwd(q, k, v, **kw),
        lambda: fa.flash_fwd(q, k, v, partial=True, **kw),
        lambda: fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw),
        ref, delta, want, q, k, v, do, cs.FA_BWD_ATOL).items()}
    hold(f"{name} new", {key: tuple(val) for key, val in rec["gaps_new"].items()})
    rec["largest"] = {f"k5_{g}": float(w.abs().max()) for g, w in zip(("dq", "dk", "dv"), want)}
    rec["largest"]["k4_o"] = float(ref[3].abs().max())
    if old is not None:
        rec["gaps_old"] = {key: list(val) for key, val in gaps(
            lambda: old_fwd(old, q, k, v, kw), lambda: old_fwd(old, q, k, v, kw, True),
            lambda: old_bwd(old, q, k, v, do, lse, delta, kw),
            ref, delta, want, q, k, v, do, cs.FA_BWD_ATOL).items()}
    del ref, want
    torch.cuda.empty_cache()
    # The kernels beside their twins and SDPA, as chip_smoke times them.
    rec.update(cs.time_flash(torch, F, q, k, v, do, lse, delta, kw, lead, lq, lk, d))
    rec["k4_partial_ms"] = queued_ms(lambda: fa.flash_fwd(q, k, v, partial=True, **kw))
    if old is not None:
        new = {"k4": lambda: fa.flash_fwd(q, k, v, **kw),
               "k4_partial": lambda: fa.flash_fwd(q, k, v, partial=True, **kw),
               "k5": lambda: fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw)}
        prev = {"k4": lambda: old_fwd(old, q, k, v, kw),
                "k4_partial": lambda: old_fwd(old, q, k, v, kw, True),
                "k5": lambda: old_bwd(old, q, k, v, do, lse, delta, kw)}
        turns = {}
        for key in new:
            a1, b1, b2, a2 = (queued_ms(f) for f in (prev[key], new[key], new[key],
                                                      prev[key]))
            turns[key] = {"old_ms": [a1, a2], "new_ms": [b1, b2],
                          "old_over_new": (a1 + a2) / (b1 + b2)}
        rec["turns"] = turns
    print(f"float32 {name}: " + json.dumps(rec), flush=True)
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--old", default="")
    parser.add_argument("--lm_steps", type=int, default=0)
    parser.add_argument("--truth", action="store_true")
    parser.add_argument("--out", default=str(ROOT / "chiprun_out" / "flash_f32.json"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_f32: no CUDA device", file=sys.stderr)
        return 1
    from mpit_tpu_torch.utils.platform import pin_float32

    pin_float32()
    t0 = time.perf_counter()
    smi = cs.nvidia_smi()
    result = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    print("device:", smi, torch.__version__, torch.version.cuda, flush=True)
    result["build_s"] = build.build_all()
    for name in build.SOURCES:
        result.setdefault("ptxas", {})[name] = build.ptxas_report(name)
        result.setdefault("tensor_ops", {})[name] = build.tensor_ops(name)
    print("build: " + json.dumps({k: result[k] for k in ("build_s", "ptxas", "tensor_ops")}),
          flush=True)
    old = build_old(pathlib.Path(args.old)) if args.old else None
    gen = torch.Generator(device="cuda").manual_seed(5)
    if args.check:
        result["checks"] = check_cases(gen)
    if args.truth:
        result["truth"] = {name: truth_gaps(gen, name, old) for name in ("lm_default",
                                                                         "lm_vs_cpu")}
    result["timed"] = {name: timed_shape(gen, name, old) for name in cs.FA_TIMED}
    if args.lm_steps:
        kernels = {"k1": fused_nesterov_commit, "k2": fused_elastic, "k3": fused_adam,
                   "k4": fa.flash_fwd, "k5": fa.flash_bwd_fused,
                   "k6": fa.flash_bwd_two_kernel}
        paths = {key: {} for key in kernels}
        result["lm_longcontext_f32"] = cs.lm_longcontext_f32(torch, kernels, paths,
                                                             steps=args.lm_steps)
    result["seconds"] = time.perf_counter() - t0
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
