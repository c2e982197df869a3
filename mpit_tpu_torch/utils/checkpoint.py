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
either package resumes in the other.  A process group saves through
:func:`save_state_dict_group`: its state gathered into the one-process
layout, process 0 writes it, and every process waits at a barrier until
it is published; every process resumes from that one file, taking its
rows.  The JAX package's multi-process mesh writes orbax ``step_*``
directories instead; the card's machine has no orbax, so
:func:`latest_pytree_step` finds them and ``mesh_launch`` refuses them.

:func:`save_server_state` and :func:`load_server_state` carry one
parameter server's shard, its rule state and a JSON ``meta`` (the FT
dedup table, each client's negotiation) in the JAX package's layout
(``param__raw`` / ``state_<key>__raw`` triplets), as a stamped history of
the newest ``keep`` files plus ``server<rank>_latest.npz``, so a server of
either package restores the other's.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import time
from typing import Any, Callable, Dict, Optional, Tuple

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


def save_server_state(
    directory: str | pathlib.Path,
    rank: int,
    offset: int,
    size: int,
    param: Any,
    rule_state: Optional[Dict[str, Any]],
    meta: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> pathlib.Path:
    """Checkpoint one server's shard: param slice + rule (optimizer) state
    (arrays or tensors, copied to the host).  Published via
    :func:`_stamped_atomic_publish`: a millisecond-stamped version plus the
    ``server<rank>_latest.npz`` alias a loader (resume, a supervisor
    restarting the rank) can always open.  The stamped history is pruned
    to the newest ``keep``: a fault-tolerant server snapshots every
    ``ckpt_interval`` seconds for as long as it runs."""
    payload: Dict[str, Any] = {}
    _pack_array("param", param, payload)
    state = dict(rule_state or {})
    for key, value in state.items():
        _pack_array(f"state_{key}", value, payload)
    payload["meta"] = json.dumps({
        "rank": rank, "offset": offset, "size": size,
        "state_keys": sorted(state), "runtime": time.time(),
        **(meta or {}),
    })
    prefix = f"server{rank}"
    path = _stamped_atomic_publish(directory, prefix, payload)
    if keep > 0:
        stamped = sorted(
            p for p in pathlib.Path(directory).glob(f"{prefix}_*.npz")
            if p.name[len(prefix) + 1:-len(".npz")].isdigit()
        )
        for old in stamped[:-keep]:
            old.unlink(missing_ok=True)
    return path


def load_server_state(
    path: str | pathlib.Path,
) -> Tuple[int, int, np.ndarray, Dict[str, np.ndarray], Dict[str, Any]]:
    """Inverse of :func:`save_server_state`:
    ``(offset, size, param, rule_state, meta)``, host arrays."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        param = _unpack_array("param", z)
        state = {key: _unpack_array(f"state_{key}", z)
                 for key in meta["state_keys"]}
        return int(meta["offset"]), int(meta["size"]), param, state, meta


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


def save_state_dict_group(
    directory: str | pathlib.Path,
    state: Dict[str, Any],
    meta: Optional[Dict[str, Any]] = None,
    prefix: str = "mesh",
    *,
    process_id: int = 0,
    barrier: Callable[[], None] = lambda: None,
) -> Optional[pathlib.Path]:
    """A process group's :func:`save_state_dict`: ``state`` is the whole
    state in the one-process layout in every process (where its rows are
    cut across processes the caller gathered them, and that all-gather,
    which every process enters, is the save's first barrier); process 0
    writes it, and every process waits at ``barrier`` until it is
    published.  Returns the path in process 0, None in the others."""
    path = save_state_dict(directory, state, meta, prefix) if process_id == 0 else None
    barrier()
    return path


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

