"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``ops/csrc/`` is a plain-C interface compiled on its own
into a shared library for Hopper (``sm_90a``) on first use.  Libraries go
to ``ops/_build/`` (listed in ``.gitignore``), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused.  Nothing here runs at import time: the CPU tests import every
module on a machine without ``nvcc``.

Run ``python -m mpit_tpu_torch.ops.build`` to build every kernel and print
``ptxas``'s register and spill report.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"

# -fmad=false: no multiply-add contraction, so kernels round each operation
# as their plain PyTorch twins do and can be held to bit equality.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

SOURCES = ("fused_update",)


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


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path.  ``nvcc``'s report goes beside it as
    ``.log``.  A failed build raises with the compiler's output."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if
    needed; loaded once per process."""
    return ctypes.CDLL(str(build(name)))


if __name__ == "__main__":
    for name, secs in build_all().items():
        print(f"{name}: {secs:.1f}s")
        sys.stdout.write(library_path(name).with_suffix(".log").read_text())
