"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``ops/csrc/`` is a plain-C interface compiled on its own
into a shared library for Hopper (``sm_90a``) on first use.  Libraries go
to ``ops/_build/`` (listed in ``.gitignore``), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused.  Nothing here runs at import time: the CPU tests import every
module on a machine without ``nvcc``.

Run ``python -m mpit_tpu_torch.ops.build`` to build every kernel and print
``ptxas``'s register and spill report and the tensor-core instructions of
each kernel's SASS.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Each source and the flags of its own.  fused_update: -fmad=false, no
# multiply-add contraction, so K1-K3 round each operation as their plain
# PyTorch twins do and are held to bit equality.  flash_attention (the
# scalar kernels) and flash_attention_tc (the bfloat16 tensor-core K4 and
# K5): their sums run in another order than their twins' anyway, so they
# are held to a tolerance and keep the contraction.
SOURCE_FLAGS = {
    "fused_update": ("-fmad=false",),
    "flash_attention": (),
    "flash_attention_tc": (),
}
SOURCES = tuple(SOURCE_FLAGS)


def nvcc() -> str:
    """``nvcc`` from ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise FileNotFoundError(
            f"nvcc not found on PATH or at {path}: the CUDA kernels are "
            "built on the machine with the card"
        )
    return str(path)


def flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def library_path(name: str) -> pathlib.Path:
    """The library's path, named by a hash of the source, the headers it
    may include (every ``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path.  ``nvcc``'s report goes beside it as
    ``.log``.  A failed build raises with the compiler's output."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # A temporary name of this thread's own: two threads of one process
    # (two servers' first K3) may build at once.
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {name}.cu ({proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_all() -> Dict[str, float]:
    """Build every source at once (one ``nvcc`` each, in parallel);
    returns the seconds each build took."""

    def timed(name: str) -> float:
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        secs = list(pool.map(timed, SOURCES))
    return dict(zip(SOURCES, secs))


def tensor_ops(name: str) -> Dict[str, Dict[str, int]]:
    """The tensor-core instructions of each kernel in ``csrc/<name>.cu``'s
    built library, from its SASS (``cuobjdump -sass``): ``HMMA``
    (``mma.sync``) and ``HGMMA`` (``wgmma``) counts by mangled kernel
    name."""
    tool = pathlib.Path(nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build(name))], capture_output=True,
                          text=True, check=True).stdout
    counts: Dict[str, Dict[str, int]] = {}
    kernel = None
    for line in sass.splitlines():
        if "Function : " in line:
            kernel = line.split("Function : ", 1)[1].strip()
            counts[kernel] = {"HMMA": 0, "HGMMA": 0}
            continue
        found = re.search(r"\b(HGMMA|HMMA)\.", line)
        if kernel is not None and found:
            counts[kernel][found.group(1)] += 1
    return counts


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """What ``ptxas -v`` said of each kernel in ``csrc/<name>.cu``'s build
    log, by mangled name: its registers, its spilled bytes (stores and
    loads), and ``serialized`` = 1 where ptxas noted (C7512) that it
    serialized the kernel's wgmma for want of registers."""
    log = build(name).with_suffix(".log").read_text()
    report: Dict[str, Dict[str, int]] = {}
    kernel = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            kernel = entry.group(1)
            report.setdefault(kernel, {"registers": 0, "spill_bytes": 0, "serialized": 0})
            continue
        if "C7512" in line:  # a note that names no kernel still counts
            note = re.search(r"function '([^']+)'", line)
            report.setdefault(note.group(1) if note else "(unnamed)",
                              {"registers": 0, "spill_bytes": 0,
                               "serialized": 0})["serialized"] = 1
            continue
        if kernel is None:
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills:
            report[kernel]["spill_bytes"] = int(spills.group(1)) + int(spills.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            report[kernel]["registers"] = int(used.group(1))
    return report


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if
    needed; loaded once per process."""
    return ctypes.CDLL(str(build(name)))


if __name__ == "__main__":
    for name, secs in build_all().items():
        print(f"{name}: {secs:.1f}s")
        sys.stdout.write(library_path(name).with_suffix(".log").read_text())
        for kernel, ops in tensor_ops(name).items():
            if any(ops.values()):
                print(f"  tensor-core instructions {kernel}: {ops}")
        for kernel, rep in ptxas_report(name).items():
            print(f"  ptxas {kernel}: {rep}")
