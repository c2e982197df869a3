"""Float32 flash attention on the card: K4, K5 and K6 at ``chip_smoke.py``'s
``FA_TIMED`` shapes, each beside its plain twin and
``scaled_dot_product_attention`` on the same float32 tensors.

For each shape it prints and keeps the card ms (queued behind a hold, as
``chip_smoke.time_flash`` times them), the bound (3xTF32, see
``chip_smoke.fa_bound_ms``), the twin's and SDPA's ms and SDPA's backend,
K4 in both output modes, and each kernel's largest gap to its twin.
``--check`` first holds float32 K4 (both modes), K5 and K6 (each twice,
equal bits; K6's dK and dV K5's bits) to their twins at every
``FA_CASES`` shape at ``chip_smoke``'s limits.  ``--old DIR`` builds the
scalar float32 K6 that the 3xTF32 one replaced (``DIR/flash_attention.cu``
and ``DIR/flash_common.cuh``, the plain C entry points ``mpit_fa_bwd_dq``
and ``mpit_fa_bwd_dkdv``) with the base nvcc flags, holds it to the twin
too, and times old and new K6 in turns (old, new, new, old) in this
process, also at ``chip_smoke.FA_32K`` in float32: the scalar kernels come
from git, at the commit before they were removed (915540d)::

    mkdir -p .ab/scalar_k6
    for f in flash_attention.cu flash_common.cuh; do
      git show 915540d:mpit_tpu_torch/ops/csrc/$f > .ab/scalar_k6/$f; done
    python3 tools/torch_flash_f32.py --check --truth --old .ab/scalar_k6

``--truth`` first holds the twin and the kernels (K4, K5, K6 and the old
K6) to float64 references computed on the card, at ``lm_default``'s and
``lm_vs_cpu``'s attention, and the backward (the float32 twin, K6 and the
old K6) at ``FA_32K`` to the twin in float64 (``chip_smoke.twin_f64``).  ``--lm_steps N`` then runs
``chip_smoke.lm_longcontext_f32`` (``lm_launch`` at ``LONGCONTEXT_KWARGS``,
attention in float32) for N steps.  Prints one JSON object last and
writes it to ``chiprun_out/flash_f32.json``.  Needs one CUDA card.
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


def build_old(src: pathlib.Path) -> ctypes.CDLL:
    """``src/flash_attention.cu`` compiled with the base nvcc flags (it had
    none of its own) into ``src/_build``; its two K6 entry points bound."""
    out = src / "_build" / "libflash_attention_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src / "flash_attention.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    geo = [i32] * 6 + [f32, i32]
    lib.mpit_fa_bwd_dq.argtypes = [ptr] * 7 + geo + [ptr]
    lib.mpit_fa_bwd_dkdv.argtypes = [ptr] * 8 + geo + [ptr]
    lib.mpit_fa_bwd_dq.restype = lib.mpit_fa_bwd_dkdv.restype = ctypes.c_int
    return lib


def old_k6(lib, q, k, v, do, lse, delta, kw):
    """The old scalar K6's (dq, dk, dv)."""
    lead, lq, lk, d = tuple(q.shape[:-2]), q.shape[-2], k.shape[-2], q.shape[-1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    geo = (math.prod(lead), lq, lk, d, kw["q_offset"], kw["kv_offset"], 1.0 / math.sqrt(d),
           int(kw["causal"]), _cuda_stream(q))
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr())
    for what, err in (("dq", lib.mpit_fa_bwd_dq(*ins, dq.data_ptr(), *geo)),
                      ("dkdv", lib.mpit_fa_bwd_dkdv(*ins, dk.data_ptr(), dv.data_ptr(), *geo))):
        if err:
            raise RuntimeError(f"old K6 ({what}): CUDA error {err}")
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


def gaps(fwd, fwd_partial, bwd, ref, delta, want, q, k, v, do, bwd_atol, k6=None):
    """Each output's (max abs gap, share of its limit) against the twins:
    K4's and K5's, and ``k6``'s where given."""
    acc_t, m_t, l_t, o_t, lse_t = ref
    o, lse = fwd()
    acc, m, l = fwd_partial()
    den = torch.where(l_t == 0, 1.0, l_t)[..., None]
    out = {"k4_o": cs.fa_err(torch, o, o_t, cs.FA_FWD_ATOL),
           "k4_lse": cs.fa_err(torch, lse, lse_t, cs.FA_FWD_ATOL),
           "k4_m": cs.fa_err(torch, m, m_t, cs.FA_FWD_ATOL),
           "k4_acc/l": cs.fa_err(torch, acc / den, acc_t / den, cs.FA_FWD_ATOL),
           "k4_l": cs.fa_err(torch, l, l_t, 0.0, cs.FA_PARTIAL_RTOL)}
    for key, fn in (("k5", bwd), ("k6", k6)):
        if fn is None:
            continue
        for grad, a, w in zip(("dq", "dk", "dv"), fn(), want):
            out[f"{key}_{grad}"] = cs.fa_err(torch, a, w, bwd_atol)
    return out


def hold(name, checks):
    for what, (gap, used) in checks.items():
        if not used <= 1.0:
            raise AssertionError(f"{name}: {what} past its limit: gap {gap}, {used} of it")


def check_cases(gen, old):
    """Float32 K4, K5 and K6 against the twins at every FA_CASES shape, K5
    and K6 each twice (equal bits), K6's dK and dV against K5's bits, and
    with ``old`` the old K6 against the twin."""
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
        again6 = fa.flash_bwd_two_kernel(q, k, v, do, ref[4], delta, **kw)
        torch.cuda.synchronize()
        for key, got, again in (("K5", got5, again5), ("K6", got6, again6)):
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{key} gave other bits on a second run at {name}")
        if not (torch.equal(got5[1], got6[1]) and torch.equal(got5[2], got6[2])):
            raise AssertionError(f"K6's dk, dv are not K5's bits at {name}")
        for grad, a6, w in zip(("dq", "dk", "dv"), got6, want):
            checks[f"k6_{grad}"] = cs.fa_err(torch, a6, w, bwd_atol)
        if old is not None:
            for grad, a, w in zip(("dq", "dk", "dv"),
                                  old_k6(old, q, k, v, do, ref[4], delta, kw), want):
                checks[f"old_k6_{grad}"] = cs.fa_err(torch, a, w, bwd_atol)
        checks = {key: list(val) for key, val in checks.items()}
        print(f"float32 check {name}: " + json.dumps(checks), flush=True)
        hold(name, {key: tuple(val) for key, val in checks.items()})
        out[name] = checks
        del ref, want, got5, again5, got6, again6
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
    reference computed on the card, for the twin, the kernels (K4, K5 and
    K6) and, with ``old``, the old scalar K6."""
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
        rows["old_k6"] = (None, old_k6(old, q, k, v, do, lse, delta, kw))
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
        ref, delta, want, q, k, v, do, cs.FA_BWD_ATOL,
        k6=lambda: fa.flash_bwd_two_kernel(q, k, v, do, lse, delta, **kw)).items()}
    hold(f"{name} new", {key: tuple(val) for key, val in rec["gaps_new"].items()})
    rec["largest"] = {f"k5_{g}": float(w.abs().max()) for g, w in zip(("dq", "dk", "dv"), want)}
    rec["largest"]["k4_o"] = float(ref[3].abs().max())
    if old is not None:
        rec["gaps_old_k6"] = {g: list(cs.fa_err(torch, a, w, cs.FA_BWD_ATOL)) for g, a, w in zip(
            ("dq", "dk", "dv"), old_k6(old, q, k, v, do, lse, delta, kw), want)}
    del ref, want
    torch.cuda.empty_cache()
    # The kernels beside their twins and SDPA, as chip_smoke times them.
    rec.update(cs.time_flash(torch, F, q, k, v, do, lse, delta, kw, lead, lq, lk, d))
    rec["k4_partial_ms"] = queued_ms(lambda: fa.flash_fwd(q, k, v, partial=True, **kw))
    if old is not None:
        rec["turns_k6"] = k6_turns(old, q, k, v, do, lse, delta, kw)
    print(f"float32 {name}: " + json.dumps(rec), flush=True)
    return rec


def k6_turns(old, q, k, v, do, lse, delta, kw):
    """The old and the new K6 queued in turns: old, new, new, old."""
    new = lambda: fa.flash_bwd_two_kernel(q, k, v, do, lse, delta, **kw)  # noqa: E731
    prev = lambda: old_k6(old, q, k, v, do, lse, delta, kw)  # noqa: E731
    a1, b1, b2, a2 = (queued_ms(f) for f in (prev, new, new, prev))
    return {"old_ms": [a1, a2], "new_ms": [b1, b2], "old_over_new": (a1 + a2) / (b1 + b2)}


def truth_32k(old, seed=5):
    """At chip_smoke.FA_32K in float32, from K4's lse: each grad's largest
    gap to the twin in float64, and its share of FA_BWD_ATOL, for the
    float32 twin (one head at a time), K6 and, with ``old``, the old K6.
    The inputs come from a fresh generator seeded ``seed``, drawn as
    ``chip_smoke.check_k6_32k`` draws its own."""
    lead, seq, d = cs.FA_32K
    kw = dict(causal=True, q_offset=0, kv_offset=0)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = inputs(gen, lead, seq, seq, d)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (do * o).sum(-1)
    del o
    truth = cs.twin_f64(torch, q, k, v, do, lse, delta)
    heads = [fa.attention_bwd_reference(*(t[:, h:h + 1] for t in (q, k, v, do, lse, delta)),
                                        **kw) for h in range(lead[-1])]
    rows = {"twin": tuple(torch.cat(parts, dim=1) for parts in zip(*heads))}
    del heads
    rows["k6"] = fa.flash_bwd_two_kernel(q, k, v, do, lse, delta, **kw)
    if old is not None:
        rows["old_k6"] = old_k6(old, q, k, v, do, lse, delta, kw)
    out = {"largest": {g: float(w.abs().max()) for g, w in zip(("dq", "dk", "dv"), truth)}}
    for who, grads in rows.items():
        out[who] = {g: list(cs.fa_err(torch, a, w, cs.FA_BWD_ATOL))
                    for g, a, w in zip(("dq", "dk", "dv"), grads, truth)}
    print("float32 against float64 at FA_32K (max abs gap, share of the limit): "
          + json.dumps(out), flush=True)
    del rows, truth
    torch.cuda.empty_cache()
    return out


def turns_32k(gen, old):
    """The old and the new K6 in turns at chip_smoke.FA_32K in float32 (lse
    and delta from K4), after one check of each against the other."""
    lead, seq, d = cs.FA_32K
    kw = dict(causal=True, q_offset=0, kv_offset=0)
    q, k, v, do = inputs(gen, lead, seq, seq, d)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (do * o).sum(-1)
    del o
    gap = {g: list(cs.fa_err(torch, a, b, cs.FA_BWD_ATOL)) for g, a, b in zip(
        ("dq", "dk", "dv"), fa.flash_bwd_two_kernel(q, k, v, do, lse, delta, **kw),
        old_k6(old, q, k, v, do, lse, delta, kw))}
    rec = {"shape": {"lead": lead, "l": seq, "d": d}, "new_vs_old": gap,
           "turns_k6": k6_turns(old, q, k, v, do, lse, delta, kw)}
    print("float32 K6 at FA_32K: " + json.dumps(rec), flush=True)
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
        result["checks"] = check_cases(gen, old)
    if args.truth:
        result["truth"] = {name: truth_gaps(gen, name, old) for name in ("lm_default",
                                                                         "lm_vs_cpu")}
        result["truth"]["fa_32k"] = truth_32k(old)
    result["timed"] = {name: timed_shape(gen, name, old) for name in cs.FA_TIMED}
    if old is not None:
        result["k6_32k"] = turns_32k(gen, old)
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
