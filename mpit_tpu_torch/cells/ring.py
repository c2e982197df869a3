"""Consistent-hash reader routing across serving cells (§11.5).

The port of ``mpit_tpu/cells/ring.py``, over the port's own
``ft.retry._splitmix64``: given the same members, every reader lands on
the same cell as under the JAX ring.

Readers spread across the live cells of a shard by consistent hashing:
each cell owns ``vnodes`` points on a 64-bit ring (splitmix64 of
``(cell, replica)`` — the same seeded, interpreter-salt-immune hash the
FT jitter uses), and a reader routes to the first point clockwise of
``hash(reader)``.  The properties the fabric leans on:

- **stability** — adding or draining one cell re-routes only the
  readers whose arc it owned (~1/N of them), so an autoscale verb never
  stampedes the whole reader population onto one target;
- **determinism** — the ring is a pure function of the member set, so
  every reader computes the same routing without coordination, and
  tests can assert exact assignments;
- **failover order** — ``successors`` yields the remaining cells in
  ring order from the reader's point, giving each reader its own
  deterministic fail-over sequence (the kill-a-cell path: mark the dead
  cell down, take the next, zero ``RetryExhausted`` while any sibling
  lives).
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Iterator, List, Sequence

from mpit_tpu_torch.ft.retry import _splitmix64

_MASK = (1 << 64) - 1


def _point(*words: int) -> int:
    key = 0
    for w in words:
        key = _splitmix64((key ^ (w & _MASK)) & _MASK)
    return key


class CellRing:
    """An immutable-membership consistent-hash ring over cell ranks;
    liveness is tracked separately (``mark_down`` / ``mark_up``) so a
    failed-over reader keeps the dead member's arc assignment stable
    for everyone else."""

    def __init__(self, cells: Sequence[int], vnodes: int = 32):
        members = sorted(set(int(c) for c in cells))
        if not members:
            raise ValueError("a cell ring needs at least one cell")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self._members: List[int] = members
        self._down: set = set()
        points = []
        for cell in members:
            for replica in range(vnodes):
                points.append((_point(cell, replica), cell))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [c for _, c in points]

    @property
    def members(self) -> List[int]:
        return list(self._members)

    @property
    def live(self) -> List[int]:
        return [c for c in self._members if c not in self._down]

    def mark_down(self, cell: int) -> None:
        if cell in self._members:
            self._down.add(cell)

    def mark_up(self, cell: int) -> None:
        self._down.discard(cell)

    def _walk(self, key: int) -> Iterator[int]:
        """Every member once, in ring order from ``key``'s point."""
        start = bisect_right(self._points, key)
        seen = set()
        n = len(self._owners)
        for i in range(n):
            cell = self._owners[(start + i) % n]
            if cell not in seen:
                seen.add(cell)
                yield cell

    def lookup(self, reader: int) -> int:
        """The live cell owning ``reader``'s point (its primary)."""
        key = _point(reader)
        for cell in self._walk(key):
            if cell not in self._down:
                return cell
        raise LookupError("no live cell in the ring")

    def successors(self, reader: int) -> List[int]:
        """All live cells in this reader's deterministic fail-over
        order (primary first)."""
        key = _point(reader)
        return [c for c in self._walk(key) if c not in self._down]
