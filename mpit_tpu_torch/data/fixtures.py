"""Committed-data fixture root — the single place that knows where the
repo's ``data/fixtures`` directory lives relative to the package.

A copy of :mod:`mpit_tpu.data.fixtures`: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import pathlib


def fixtures_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[2] / "data" / "fixtures"
