"""Build the port's native transport library with ``g++`` and load it.

One translation unit, ``transport.cpp`` (the shm rings, the codec kernels
and the host pool), compiled with the JAX package's own flags:

- ``-O3`` for the auto-vectorizer (the codec loops need it);
- ``-march=native``: the library is built on the host that runs it, and
  the int8 quantize loop needs a vector rounding instruction (SSE4.1+);
- ``-fno-math-errno`` so ``rintf`` lowers to that instruction;
- ``-ffp-contract=off`` so the codec's float results stay bit-identical
  to the numpy paths of ``comm/codec.py`` (its oracle), and so to the JAX
  package's frames.

The library is built at first use into ``native/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one reused.  Processes that build it
at once (the ranks of a gang starting together) each compile into a
per-pid temporary file and swap it in with ``os.replace``, so no process
ever loads a half-written library.  Nothing here runs at import time.

Run ``python -m mpit_tpu_torch.comm.native.build`` to build it and print
its path.
"""

from __future__ import annotations

import functools
import hashlib
import os
import pathlib
import subprocess

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE / "transport.cpp"
BUILD_DIR = HERE / "_build"

CXXFLAGS = ("-std=c++17", "-O3", "-march=native", "-fPIC", "-shared",
            "-pthread", "-Wall", "-fno-math-errno", "-ffp-contract=off")
LIBS = ("-lrt",)


def library_path() -> pathlib.Path:
    """The library's path, named by a hash of the source and the flags."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXXFLAGS + LIBS).encode())
    return BUILD_DIR / f"libmt_transport_{digest.hexdigest()[:16]}.so"


def ensure_built() -> pathlib.Path:
    """Compile ``transport.cpp`` unless its library is already built;
    returns the library's path.  A failed build raises with the
    compiler's output."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXXFLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"native transport build: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native transport build failed:\n$ {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def load():
    """The typed bindings over the built library (one per process)."""
    from mpit_tpu_torch.comm.native._bindings import NativeTransportLib

    return NativeTransportLib(ensure_built())


def main() -> None:
    print(f"built {ensure_built()}")


if __name__ == "__main__":
    main()
