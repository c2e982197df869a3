"""mpit_tpu_torch.cells — the multi-cell serving fabric (docs/PROTOCOL.md §11).

The port of ``mpit_tpu/cells/``.  Follower *serving cells* subscribe to a
training server's committed version stream (snapshot diffs on the DIFF
channel), install the frames into their own version-counted serving cache,
and answer READ-ONLY reader traffic under an enforced staleness bound —
N cells x M readers cost the training gang one diff stream per cell, not M
reads.  The frames a cell installs are the upstream's encoded snapshots of
the shard K3 applies on the card, byte for byte.

- :mod:`mpit_tpu_torch.cells.wire` — DIFF frame layout + the encoded frame
  history the diff producer draws deltas from.
- :mod:`mpit_tpu_torch.cells.cell` — :class:`ServingCell`, the follower rank.
- :mod:`mpit_tpu_torch.cells.ring` — consistent-hash reader routing.
- :mod:`mpit_tpu_torch.cells.autoscale` — per-cell SLO autoscaling verbs.

Heavy members load lazily: :mod:`mpit_tpu_torch.ps.server` imports the wire
module from here, and :class:`ServingCell` imports the server back — a
module-level import cycle this ``__getattr__`` indirection breaks.
"""

from mpit_tpu_torch.cells.wire import (  # noqa: F401
    DIFF_DELTA,
    DIFF_FULL,
    FrameHistory,
)

_LAZY = {
    "ServingCell": ("mpit_tpu_torch.cells.cell", "ServingCell"),
    "CellRing": ("mpit_tpu_torch.cells.ring", "CellRing"),
    "CellAutoscaler": ("mpit_tpu_torch.cells.autoscale", "CellAutoscaler"),
    "CellSLO": ("mpit_tpu_torch.cells.autoscale", "CellSLO"),
}

__all__ = ["DIFF_DELTA", "DIFF_FULL", "FrameHistory",
           "ServingCell", "CellRing", "CellAutoscaler", "CellSLO"]


def __getattr__(name: str):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module = importlib.import_module(entry[0])
    value = getattr(module, entry[1])
    globals()[name] = value
    return value
