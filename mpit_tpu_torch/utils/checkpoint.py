"""Flat-vector checkpoints — the tester rank's save/load.

The port of ``save_flat`` and ``load_flat`` of the JAX package's
``mpit_tpu/utils/checkpoint.py``, in its npz layout: the vector's raw
bytes (``w_raw``), its dtype name (``w_dtype``) and shape (``w_shape``),
and a JSON metadata string (``meta``), written to a millisecond-stamped
file and published atomically as ``<prefix>_latest.npz``.  By the flat
layout parity of the two packages, a checkpoint written by either loads in
the other.  Server-state checkpoints and resume come with a later slice.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np


def _stamped_atomic_publish(
    directory: str | pathlib.Path, prefix: str, payload: Dict[str, Any]
) -> pathlib.Path:
    """Write ``payload`` (np.savez keys) to a millisecond-stamped file
    (sub-second saves must not overwrite each other) and atomically
    publish it as ``<prefix>_latest.npz`` — a concurrent loader must never
    see a half-written file."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    stamp = time.time_ns() // 1_000_000
    path = directory / f"{prefix}_{stamp}.npz"
    tmp = directory / f".{prefix}_{stamp}.npz.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path)
    tmp2 = directory / f".{prefix}_latest.npz.tmp"
    shutil.copyfile(path, tmp2)
    os.replace(tmp2, directory / f"{prefix}_latest.npz")
    return path


def save_flat(
    directory: str | pathlib.Path,
    w: Any,
    meta: Optional[Dict[str, Any]] = None,
    prefix: str = "ckpt",
) -> pathlib.Path:
    """Save the flat param vector (a numpy array, or a tensor, copied to
    the host); the file is stamped with the wall clock and ``meta`` gets
    ``runtime`` unless it has one."""
    meta = dict(meta or {})
    meta.setdefault("runtime", time.time())
    if hasattr(w, "detach"):  # a torch tensor, possibly on the card
        w = w.detach().cpu().numpy()
    arr = np.asarray(w)
    return _stamped_atomic_publish(directory, prefix, {
        "w_raw": np.frombuffer(arr.tobytes(), np.uint8),
        "w_dtype": str(arr.dtype),
        "w_shape": np.asarray(arr.shape, np.int64),
        "meta": json.dumps(meta),
    })


def load_flat(path: str | pathlib.Path) -> Tuple[np.ndarray, Dict[str, Any]]:
    """(vector, meta) from a ``save_flat`` file of either package.  Only
    numpy dtypes load here (the port's vectors are float32)."""
    with np.load(path, allow_pickle=False) as z:
        if "w" in z:  # the JAX package's legacy layout
            return z["w"], json.loads(str(z["meta"]))
        dtype = np.dtype(str(z["w_dtype"]))
        # copy(): frombuffer over bytes is read-only.
        w = np.frombuffer(z["w_raw"].tobytes(), dtype).reshape(z["w_shape"]).copy()
        return w, json.loads(str(z["meta"]))
