"""Reduction plans — who pre-reduces with whom, and the tree above them.

A copy of ``mpit_tpu/agg/plan.py``: the same plan on every client of a
gang, whichever package runs it.

A plan is a pure, deterministic function of its inputs (client ranks,
colocation groups, fan-in, seed), built identically on every client
from the same launch-time configuration.  Nothing about it is
discovered at runtime — discovery would let two clients disagree about
the tree and double-fold a contribution.  Runtime only *verifies*: a
group member checks its representative's published plane carries the
same backend fingerprint (the dplane check) and fails loudly on
mismatch.

Two layers:

- **groups** — clients declared colocated (same process + platform,
  the dplane ``backend_fingerprint`` equivalence).  Each group elects
  its minimum rank as *representative*; members hand their gradient to
  the representative through the in-process device plane
  (:mod:`mpit_tpu_torch.agg.node`) and never touch the wire for GRAD.
- **tree** — a complete ``fanin``-ary tree over the representatives,
  laid out heap-style over a seed-deterministic permutation, so
  "random tree shapes" in the property tests are one integer away.
  Interior nodes fold children in ascending child-rank order — the
  fixed reduction order the bitwise-parity bar is stated against.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

_MASK = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64 finalizer — the repo's standard deterministic mix."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


@dataclass(frozen=True)
class AggConfig:
    """The launch-time aggregation posture, identical on every client.

    ``mode``:

    - ``"off"``   — flat pushes, byte-for-byte the pre-§13 wire.
    - ``"prereduce"`` — colocated groups pre-reduce on-device; every
      representative pushes its group's fold directly (no tree).
    - ``"tree"``  — groups pre-reduce, representatives reduce through
      the REDUCE tree, and only the root pushes upstream.
    """

    mode: str = "off"
    #: colocation groups (tuples of client ranks).  Ranks absent from
    #: every group are singleton groups (their own representative).
    groups: Tuple[Tuple[int, ...], ...] = ()
    #: tree fan-in (children per interior node).
    fanin: int = 2
    #: seed for the deterministic tree permutation.
    tree_seed: int = 0
    #: straggler wall deadline: how long a node waits for missing
    #: contributions before folding without them (the late sender is
    #: re-routed to a direct push).  The *hard* bound — after which a
    #: mid-stream loss of an already-committed sender fails loudly —
    #: is this times (max_retries + 1) plus slack, the never-hang rail.
    deadline_s: float = 5.0
    #: REDUCE hop chunk size in bytes (block-aligned like §12); 0 picks
    #: the FTConfig chunk size or a 1 MiB default.
    chunk_bytes: int = 0

    @property
    def enabled(self) -> bool:
        return self.mode in ("prereduce", "tree")

    @classmethod
    def from_env(cls, **overrides) -> "AggConfig":
        """AggConfig from MPIT_AGG_* env vars; kwargs override env.
        Groups do not travel by env — they are topology, not posture."""
        fields = dict(
            mode=os.environ.get("MPIT_AGG_MODE", "off") or "off",
            fanin=int(os.environ.get("MPIT_AGG_FANIN", "2")),
            tree_seed=int(os.environ.get("MPIT_AGG_TREE_SEED", "0")),
            deadline_s=float(os.environ.get("MPIT_AGG_DEADLINE_S", "5.0")),
            chunk_bytes=int(os.environ.get("MPIT_AGG_CHUNK_BYTES", "0")),
        )
        fields.update(overrides)
        return cls(**fields)


@dataclass
class ReductionPlan:
    """The resolved reduction topology for one gang."""

    cranks: List[int]
    rep_of: Dict[int, int]
    members_of: Dict[int, List[int]]  # rep -> non-rep members, ascending
    parent_of: Dict[int, Optional[int]]  # rep -> tree parent (None: root)
    children_of: Dict[int, List[int]]  # rep -> tree children, ascending
    root: int
    fanin: int = 2
    seed: int = 0
    _depth: Dict[int, int] = field(default_factory=dict)

    @classmethod
    def build(cls, cranks: Sequence[int],
              groups: Sequence[Sequence[int]] = (),
              fanin: int = 2, seed: int = 0) -> "ReductionPlan":
        cranks = sorted(set(int(r) for r in cranks))
        if not cranks:
            raise ValueError("a reduction plan needs at least one client")
        if fanin < 1:
            raise ValueError(f"fanin must be >= 1, got {fanin}")
        rep_of: Dict[int, int] = {}
        members_of: Dict[int, List[int]] = {}
        seen: set = set()
        for group in groups:
            g = sorted(set(int(r) for r in group))
            if not g:
                continue
            bad = [r for r in g if r not in cranks]
            if bad:
                raise ValueError(
                    f"group {g} names non-client ranks {bad}")
            overlap = seen.intersection(g)
            if overlap:
                raise ValueError(
                    f"rank(s) {sorted(overlap)} appear in two groups — "
                    "colocation groups must be disjoint")
            seen.update(g)
            rep = g[0]  # minimum rank is the elected representative
            members_of[rep] = g[1:]
            for r in g:
                rep_of[r] = rep
        for r in cranks:
            if r not in rep_of:
                rep_of[r] = r
                members_of[r] = []
        reps = sorted(members_of)
        # Heap layout over a seed-deterministic permutation of the
        # representatives: perm[0] is the root, perm[i]'s children are
        # perm[fanin*i+1 .. fanin*i+fanin].
        perm = sorted(reps, key=lambda r: (_mix((seed << 20) ^ r), r))
        parent_of: Dict[int, Optional[int]] = {}
        children_of: Dict[int, List[int]] = {r: [] for r in reps}
        for i, r in enumerate(perm):
            if i == 0:
                parent_of[r] = None
            else:
                parent_of[r] = perm[(i - 1) // fanin]
                children_of[perm[(i - 1) // fanin]].append(r)
        for r in reps:
            children_of[r].sort()  # the fixed fold order
        return cls(cranks=cranks, rep_of=rep_of, members_of=members_of,
                   parent_of=parent_of, children_of=children_of,
                   root=perm[0], fanin=fanin, seed=seed)

    # -- queries -------------------------------------------------------------

    def is_rep(self, rank: int) -> bool:
        return self.rep_of.get(rank) == rank

    def rep(self, rank: int) -> int:
        return self.rep_of[rank]

    def members(self, rank: int) -> List[int]:
        return self.members_of.get(rank, [])

    def parent(self, rank: int) -> Optional[int]:
        return self.parent_of.get(rank)

    def children(self, rank: int) -> List[int]:
        return self.children_of.get(rank, [])

    def group_size(self, rank: int) -> int:
        return 1 + len(self.members(self.rep(rank)))

    def subtree_leaves(self, rank: int) -> int:
        """Leaf gradients a full fold at ``rank`` carries upstream —
        the expected ``nfold`` when nobody straggles."""
        total = self.group_size(rank)
        for child in self.children(rank):
            total += self.subtree_leaves(child)
        return total

    def describe(self) -> str:
        reps = sorted(self.members_of)
        lines = [f"root={self.root} fanin={self.fanin} seed={self.seed}"]
        for r in reps:
            lines.append(
                f"  rep {r}: group={[r] + self.members_of[r]} "
                f"parent={self.parent_of[r]} "
                f"children={self.children_of[r]}")
        return "\n".join(lines)
