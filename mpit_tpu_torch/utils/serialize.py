"""Object and array (de)serialization — the port's copy of
``mpit_tpu/utils/serialize.py``.

Two tiers, byte for byte the JAX package's:

- **Arrays** travel as raw little-endian bytes with a tiny header (the
  dtype's name, the shape);
- **Pytrees / control objects** travel as header-tagged pickled payloads,
  only on cold control paths.

The one change is :func:`resolve_dtype`.  The JAX package reads the
names numpy does not know (``bfloat16`` and the fp8 types) through
``ml_dtypes``, which ships with jax; the port's machine has no jax.  Here a
numpy name resolves to its ``np.dtype``, and ``bfloat16`` to
``torch.bfloat16``: :func:`decode_array` then returns a tensor, since
numpy has no such dtype.  Any other name raises, naming it.  The port's
own states are float32, which needs none of this.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Tuple

import numpy as np
import torch

_ARRAY_MAGIC = b"MTA1"  # mpit-tpu array v1
_OBJECT_MAGIC = b"MTO1"  # mpit-tpu object v1

#: names numpy does not know that the port still reads, as torch dtypes
TORCH_ONLY_DTYPES = {"bfloat16": torch.bfloat16}


def resolve_dtype(name) -> np.dtype | torch.dtype:
    """``np.dtype`` from a name numpy knows; ``torch.bfloat16`` for
    ``bfloat16``; anything else raises ``TypeError`` naming the dtype."""
    if str(name) in TORCH_ONLY_DTYPES:  # even where ml_dtypes taught numpy it
        return TORCH_ONLY_DTYPES[str(name)]
    try:
        dtype = np.dtype(name)
    except TypeError:
        dtype = None
    # Only numpy's own types: where ml_dtypes is imported it registers its
    # fp8 types with numpy, and the port must read the same files alike
    # with and without it.
    if dtype is None or dtype.type.__module__ != "numpy":
        raise TypeError(
            f"dtype {name!r}: neither numpy nor the port reads it (the port "
            "reads numpy dtypes and bfloat16)")
    return dtype


def frombuffer(raw: bytes | memoryview, name: str,
               shape: Tuple[int, ...]) -> np.ndarray | torch.Tensor:
    """An owned array of ``shape`` over ``raw`` in the dtype named
    ``name``: numpy for numpy dtypes, a CPU tensor for bfloat16."""
    dtype = resolve_dtype(name)
    if isinstance(dtype, torch.dtype):
        return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)
    return np.frombuffer(raw, dtype).reshape(shape).copy()


def raw_bytes(array: Any) -> Tuple[bytes, str, Tuple[int, ...]]:
    """``(bytes, dtype name, shape)`` of a numpy array or a tensor (copied
    to the host; a bfloat16 tensor keeps its name and its bytes)."""
    if isinstance(array, torch.Tensor):
        t = array.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), "bfloat16", tuple(t.shape)
        array = t.numpy()
    host = np.asarray(array)
    return host.tobytes(), host.dtype.name, host.shape


def encode_array(array: Any) -> bytes:
    """Array -> bytes.  Accepts numpy arrays and tensors.  A 0-d array
    travels as shape (1,), as the JAX package's ``ascontiguousarray`` makes
    it."""
    raw, name, shape = raw_bytes(array)
    shape = shape or (1,)
    dtype = name.encode()
    header = struct.pack("<4sB", _ARRAY_MAGIC, len(dtype)) + dtype
    header += struct.pack("<B", len(shape))
    header += struct.pack(f"<{len(shape)}q", *shape)
    return header + raw


def decode_array(blob: bytes | memoryview, out: np.ndarray | None = None):
    """Bytes -> an owned array; fills ``out`` in place when given."""
    view = memoryview(blob)
    magic, dlen = struct.unpack_from("<4sB", view, 0)
    if magic != _ARRAY_MAGIC:
        raise ValueError(f"bad array magic {magic!r}")
    offset = 5
    name = bytes(view[offset: offset + dlen]).decode()
    offset += dlen
    (ndim,) = struct.unpack_from("<B", view, offset)
    offset += 1
    shape: Tuple[int, ...] = struct.unpack_from(f"<{ndim}q", view, offset)
    offset += 8 * ndim
    array = frombuffer(view[offset:], name, shape)
    if out is not None:
        if out.shape != array.shape or out.dtype != array.dtype:
            raise ValueError(
                f"payload shape/dtype {array.shape}/{array.dtype} does not "
                f"match out buffer {out.shape}/{out.dtype}")
        np.copyto(out, array)
        return out
    return array


def encode_object(obj: Any) -> bytes:
    return _OBJECT_MAGIC + pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def decode_object(blob: bytes | memoryview) -> Any:
    view = memoryview(blob)
    if bytes(view[:4]) != _OBJECT_MAGIC:
        raise ValueError("bad object magic")
    return pickle.loads(view[4:])


def encode(obj: Any) -> bytes:
    """Dispatch: arrays by value, everything else pickled."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return encode_array(obj)
    return encode_object(obj)


def decode(blob: bytes | memoryview) -> Any:
    head = bytes(memoryview(blob)[:4])
    if head == _ARRAY_MAGIC:
        return decode_array(blob)
    if head == _OBJECT_MAGIC:
        return decode_object(blob)
    raise ValueError(f"unknown payload magic {head!r}")
