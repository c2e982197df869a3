"""Checkpoints: the tester rank's flat vector and a trainer's whole state.

The port of ``save_flat`` and ``load_flat`` of the JAX package's
``mpit_tpu/utils/checkpoint.py``, in its npz layout: the vector's raw
bytes (``w_raw``), its dtype name (``w_dtype``) and shape (``w_shape``),
and a JSON metadata string (``meta``), written to a millisecond-stamped
file and published atomically as ``<prefix>_latest.npz``.  By the flat
layout parity of the two packages, a checkpoint written by either loads in
the other.

:func:`save_state_dict` and :func:`load_state_dict` carry a trainer's whole
state (``mesh_launch``'s ``w``, ``vt``, ``k`` and ``center``, the LM's
``w``, ``vt`` and ``k``) in the JAX package's npz layout, each array as a
``s_<key>__raw`` / ``__dtype`` / ``__shape`` triplet, so a checkpoint of
either package resumes in the other.  The JAX package's orbax ``step_*``
directories belong to the multi-process mesh, a later slice of the port:
:func:`latest_pytree_step` finds them, and ``mesh_launch`` refuses them.
Server-state checkpoints come with the fault-tolerance slice.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from mpit_tpu_torch.utils.serialize import frombuffer, raw_bytes


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


def _host(arr: Any) -> np.ndarray:
    if hasattr(arr, "detach"):  # a torch tensor, possibly on the card
        arr = arr.detach().cpu().numpy()
    return np.asarray(arr)


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
    arr = _host(w)
    return _stamped_atomic_publish(directory, prefix, {
        "w_raw": np.frombuffer(arr.tobytes(), np.uint8),
        "w_dtype": str(arr.dtype),
        "w_shape": np.asarray(arr.shape, np.int64),
        "meta": json.dumps(meta),
    })


def load_flat(path: str | pathlib.Path) -> Tuple[np.ndarray, Dict[str, Any]]:
    """(vector, meta) from a ``save_flat`` file of either package (numpy
    dtypes as numpy arrays, bfloat16 as a tensor; see
    :func:`mpit_tpu_torch.utils.serialize.resolve_dtype`)."""
    with np.load(path, allow_pickle=False) as z:
        if "w" in z:  # the JAX package's legacy layout
            return z["w"], json.loads(str(z["meta"]))
        w = frombuffer(z["w_raw"].tobytes(), str(z["w_dtype"]),
                       tuple(int(s) for s in z["w_shape"]))
        return w, json.loads(str(z["meta"]))


def _pack_array(prefix: str, arr: Any, out: Dict[str, Any]) -> None:
    """The raw-bytes triplet of one array or tensor (``save_flat``'s
    layout, which keeps a bfloat16 tensor's name and bytes)."""
    raw, name, shape = raw_bytes(arr)
    out[f"{prefix}__raw"] = np.frombuffer(raw, np.uint8)
    out[f"{prefix}__dtype"] = name
    out[f"{prefix}__shape"] = np.asarray(shape, np.int64)


def _unpack_array(prefix: str, z) -> np.ndarray:
    shape = tuple(int(s) for s in z[f"{prefix}__shape"])
    return frombuffer(z[f"{prefix}__raw"].tobytes(), str(z[f"{prefix}__dtype"]), shape)


def save_state_dict(
    directory: str | pathlib.Path,
    state: Dict[str, Any],
    meta: Optional[Dict[str, Any]] = None,
    prefix: str = "mesh",
) -> pathlib.Path:
    """Checkpoint a flat dict of arrays or tensors (a trainer's whole
    state) with ``save_flat``'s atomic ``<prefix>_latest.npz`` publish."""
    payload: Dict[str, Any] = {"meta": json.dumps(dict(meta or {}))}
    payload["keys"] = json.dumps(sorted(state))
    for key, value in state.items():
        _pack_array(f"s_{key}", value, payload)
    return _stamped_atomic_publish(directory, prefix, payload)


def load_state_dict(
    path: str | pathlib.Path,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Inverse of :func:`save_state_dict`: ``(state, meta)``."""
    with np.load(path, allow_pickle=False) as z:
        keys = json.loads(str(z["keys"]))
        state = {k: _unpack_array(f"s_{k}", z) for k in keys}
        return state, json.loads(str(z["meta"]))


def latest_pytree_step(directory: str | pathlib.Path) -> Optional[int]:
    """Highest ``step_N`` (an orbax checkpoint of the JAX package's
    multi-process mesh) under ``directory``, or None."""
    steps = [int(p.name.split("_", 1)[1]) for p in pathlib.Path(directory).glob("step_*")
             if p.name.split("_", 1)[1].isdigit()]
    return max(steps) if steps else None

