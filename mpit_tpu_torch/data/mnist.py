"""MNIST-shaped data for the port, in numpy.

A copy of ``load_mnist`` of ``mpit_tpu/data/mnist.py`` with the same search and
the same split: real MNIST when it is on disk (``mnist.npz`` or idx-ubyte
files under ``$MPIT_DATA``, ``./data`` or ``~/.mpit/data``), else the
committed UCI optdigits fixture (``data/fixtures/optdigits_8x8.npz``)
upsampled to ``side``, split 85/15 by ``default_rng(0)``.  Both packages
therefore train on the same samples in the same order.

The reference's last-resort fallbacks (sklearn's copy of the digits, a
synthetic blob set) are not carried: the fixture is committed, and a
missing fixture raises rather than training on other data.
"""

from __future__ import annotations

import gzip
import os
import pathlib
import struct
from typing import Dict, Tuple

import numpy as np

from mpit_tpu_torch.data.fixtures import fixtures_root

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _search_dirs():
    env = os.environ.get("MPIT_DATA")
    if env:
        yield pathlib.Path(env)
    yield pathlib.Path("data")
    yield pathlib.Path.home() / ".mpit" / "data"


def _load_idx(path: pathlib.Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as fh:
        magic, = struct.unpack(">I", fh.read(4))
        ndim = magic & 0xFF
        shape = struct.unpack(f">{ndim}I", fh.read(4 * ndim))
        return np.frombuffer(fh.read(), dtype=np.uint8).reshape(shape)


def _try_real_mnist() -> Dict | None:
    for base in _search_dirs():
        npz = base / "mnist.npz"
        if npz.exists():
            with np.load(npz) as z:
                return {
                    "x_train": z["x_train"], "y_train": z["y_train"],
                    "x_test": z["x_test"], "y_test": z["y_test"],
                    "source": f"mnist.npz ({npz})",
                }
        for suffix in ("", ".gz"):
            files = [base / (name + suffix) for name in (
                "train-images-idx3-ubyte", "train-labels-idx1-ubyte",
                "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")]
            if all(f.exists() for f in files):
                return {
                    "x_train": _load_idx(files[0]), "y_train": _load_idx(files[1]),
                    "x_test": _load_idx(files[2]), "y_test": _load_idx(files[3]),
                    "source": f"idx-ubyte ({base})",
                }
    return None


def _digits_fixture(side: int):
    fixture = fixtures_root() / "optdigits_8x8.npz"
    with np.load(fixture) as z:
        images = z["images"].astype(np.float32) / 16.0
        target = z["target"]
    factor = max(side // 8, 1)
    up = np.kron(images, np.ones((1, factor, factor), np.float32))
    if up.shape[1] < side:  # side not a multiple of 8: pad with zeros
        pad = side - up.shape[1]
        up = np.pad(up, ((0, 0), (0, pad), (0, pad)))
    elif up.shape[1] > side:  # side < 8: center-crop
        lo = (up.shape[1] - side) // 2
        up = up[:, lo : lo + side, lo : lo + side]
    n = len(up)
    split = int(n * 0.85)
    rng = np.random.default_rng(0)
    order = rng.permutation(n)
    train, test = order[:split], order[split:]
    return {
        "x_train": up[train], "y_train": target[train],
        "x_test": up[test], "y_test": target[test],
        "source": "optdigits fixture (UCI real handwriting, committed)",
    }


def load_mnist(side: int = 32, flatten: bool = True) -> Tuple[Arrays, str]:
    """Returns ((x_train, y_train, x_test, y_test), source)."""
    raw = _try_real_mnist()
    if raw is not None:
        # 28x28 -> side: zero-pad up (28 -> 32, the reference's shape) or
        # center-crop down, as the reference loader does.
        def prep(x):
            x = x.astype(np.float32) / 255.0
            if x.shape[1] < side:
                pad = side - x.shape[1]
                lo, hi = pad // 2, pad - pad // 2
                x = np.pad(x, ((0, 0), (lo, hi), (lo, hi)))
            elif x.shape[1] > side:
                lo = (x.shape[1] - side) // 2
                x = x[:, lo : lo + side, lo : lo + side]
            return x

        x_train, x_test = prep(raw["x_train"]), prep(raw["x_test"])
    else:
        raw = _digits_fixture(side)
        x_train, x_test = raw["x_train"].astype(np.float32), raw["x_test"].astype(np.float32)
    y_train, y_test = raw["y_train"].astype(np.int32), raw["y_test"].astype(np.int32)
    if flatten:
        x_train = x_train.reshape(len(x_train), -1)
        x_test = x_test.reshape(len(x_test), -1)
    return (x_train, y_train, x_test, y_test), raw["source"]
