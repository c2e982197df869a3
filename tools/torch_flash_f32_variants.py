"""The accuracy switches of the float32 flash kernels, on the card.

``csrc/flash_attention_tf32.cu`` takes K4's P.V in a fresh accumulator a
key tile up to ``K4_FRESH_PV_MAX_DM`` and keeps hi.hi apart in K5's
products over the head width up to ``K5_APART_MAX_DM``.  This builds the
source as it is and with either switch, or both, set to 0 (each a library
of its own under ``chiprun_out/flash_f32_variants/``, this checkout's
flags), and for each prints and keeps:

- ptxas's registers and spills of each K4 and K5 kernel;
- the largest gap of the twin and the kernels (K4, K5 and K6) to float64 at
  ``lm_default``'s, ``lm_vs_cpu``'s and ``lm_longcontext``'s attention
  (``tools/torch_flash_f32.py``'s ``truth_gaps``);
- ``chip_smoke.lm_gang_adam_vs_cpu``'s reading (the LM gang's three Adam
  steps, card against CPU) and whether it holds, with the largest gap's
  share of its per-element limit.

Each variant runs through the wrappers of ``ops/flash_attention.py``, its
library put in place of the built one.  Writes
``chiprun_out/flash_f32_variants.json``.  Needs one CUDA card:

    python3 tools/torch_flash_f32_variants.py [name ...]
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
import io
import json
import pathlib
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import torch_flash_f32 as f32_tool  # noqa: E402
from mpit_tpu_torch.ops import build  # noqa: E402
from mpit_tpu_torch.ops.fused_update import (fused_adam, fused_elastic,  # noqa: E402
                                             fused_nesterov_commit)

fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
OUT = ROOT / "chiprun_out"
K4 = "K4_FRESH_PV_MAX_DM = 64"
K5 = "K5_APART_MAX_DM = 64"
VARIANTS = {
    "as_built": {},
    "k4_one_accumulator": {K4: "K4_FRESH_PV_MAX_DM = 0"},
    "k5_one_accumulator": {K5: "K5_APART_MAX_DM = 0"},
    "both_one_accumulator": {K4: "K4_FRESH_PV_MAX_DM = 0", K5: "K5_APART_MAX_DM = 0"},
}


def build_variant(name, edits):
    """The source with ``edits`` applied, built; returns the library and
    ptxas's registers and spills by kernel."""
    src = (build.CSRC / "flash_attention_tf32.cu").read_text()
    for old, new in edits.items():
        if old not in src:
            raise ValueError(f"{name}: {old!r} is not in the source")
        src = src.replace(old, new)
    where = OUT / "flash_f32_variants" / name
    where.mkdir(parents=True, exist_ok=True)
    (where / "flash_attention_tf32.cu").write_text(src)
    shutil.copy(build.CSRC / "flash_common.cuh", where)
    lib_path = where / "libflash_attention_tf32.so"
    proc = subprocess.run([build.nvcc(), *build.flags("flash_attention_tf32"), "-o",
                           str(lib_path), str(where / "flash_attention_tf32.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    report, kernel = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            kernel = entry.group(1)
            continue
        used = re.search(r"Used (\d+) registers", line)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if kernel and "tf32_kernel" in kernel and (used or spills):
            rec = report.setdefault(kernel, {"registers": 0, "spill_bytes": 0})
            if used:
                rec["registers"] = int(used.group(1))
            if spills:
                rec["spill_bytes"] = int(spills.group(1)) + int(spills.group(2))
    return fa._bind_tf32(ctypes.CDLL(str(lib_path))), report


def adam_reading(kernels, smi):
    """``lm_gang_adam_vs_cpu``'s printed readings and whether it held."""
    buf = io.StringIO()
    held = True
    try:
        with contextlib.redirect_stdout(buf):
            cs.lm_gang_adam_vs_cpu(torch, kernels, {k: {} for k in kernels}, smi)
    except AssertionError:
        held = False
    out = {"held": held}
    for line in buf.getvalue().splitlines():
        if "3 steps, cuda vs cpu " in line:
            r = json.loads(line.split("cuda vs cpu ", 1)[1])
            out.update({k: r[k] for k in ("max_abs_gap", "max_abs_change", "gap_over_change")})
            out["share_of_limit"] = (r["max_abs_gap"] / r["max_abs_change"]
                                     / cs.LM_GANG_ADAM_MAX_ABS_SHARE)
        elif "the first apply a shard, cuda vs cpu " in line:
            r = json.loads(line.split("cuda vs cpu ", 1)[1])
            out["first_apply"] = {size: {k: v[k] for k in ("grad_max_abs_gap",
                                                           "grad_gap_over_norm")}
                                  for size, v in r.items()}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_f32_variants: no CUDA device", file=sys.stderr)
        return 1
    from mpit_tpu_torch.utils.platform import pin_float32

    pin_float32()
    names = sys.argv[1:] or list(VARIANTS)
    smi = cs.nvidia_smi()
    print("device:", smi, flush=True)
    build.build_all()
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(lambda n: build_variant(n, VARIANTS[n]), names)))
    kernels = {"k1": fused_nesterov_commit, "k2": fused_elastic, "k3": fused_adam,
               "k4": fa.flash_fwd, "k5": fa.flash_bwd_fused, "k6": fa.flash_bwd_two_kernel}
    result = {"device": smi, "variants": {}}
    built_lib = fa._lib_tf32
    try:
        for name, (lib, report) in built.items():
            fa._lib_tf32 = lambda lib=lib: lib
            gen = torch.Generator(device="cuda").manual_seed(5)
            rec = {"ptxas": report,
                   "truth": {shape: f32_tool.truth_gaps(gen, shape, None)
                             for shape in ("lm_default", "lm_vs_cpu", "lm_longcontext")},
                   "lm_gang_adam_vs_cpu": adam_reading(kernels, smi)}
            print(f"{name}: " + json.dumps(rec), flush=True)
            result["variants"][name] = rec
    finally:
        fa._lib_tf32 = built_lib
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "flash_f32_variants.json").write_text(json.dumps(result, indent=1))
    print(json.dumps({name: {"adam_held": r["lm_gang_adam_vs_cpu"]["held"],
                             "adam_share": r["lm_gang_adam_vs_cpu"].get("share_of_limit"),
                             "spills": sum(k["spill_bytes"] for k in r["ptxas"].values())}
                      for name, r in result["variants"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
