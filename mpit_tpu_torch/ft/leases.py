"""Server-side liveness: per-client leases over the HEARTBEAT channel.

A copy of ``mpit_tpu/ft/leases.py``: the port imports nothing of the JAX
package.

The pre-FT server's failure mode: every per-client service generator
blocks in a probe loop, and the stop protocol counts STOPs from *all*
clients — one dead worker therefore wedges the whole gang forever.  The
lease registry replaces "wait forever" with a terminal-state machine per
client:

    ACTIVE --lease expiry--> EVICTED --INIT v3 (epoch+1)--> ACTIVE
    ACTIVE --STOP----------> STOPPED
    ACTIVE --RETIRE--------> RETIRED   (elastic scale-down: a goodbye)

Service loops pass ``registry.gone(crank)`` as their recv ``abort``
predicate, so eviction unblocks them at the next probe poll; the stop
condition becomes "every client STOPPED or EVICTED".

Elasticity (ft/elastic.py; shard control in a later slice) adds two moves:
``admit`` registers a rank that was not part of the launch-time set (a
late-joining client, a controller-spawned server), and ``retire`` marks
a member that left *on purpose* after a drain.  RETIRED is terminal
like STOPPED but semantically distinct from EVICTED: a retired rank's
silence is expected — ``expired()`` never reports it, so the controller
never fails over a cleanly-drained server's (empty) shard set, and the
flight recorder never writes a postmortem for a goodbye.  A lease is only
armed for clients that *promised* heartbeats in their INIT v3 flags —
arming it for a legacy (v1/v2) client would evict every pre-FT worker
under a server with a TTL configured.

Time is injected (``clock``) so eviction tests are instant and exact
rather than sleep-based.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

ACTIVE = "active"
EVICTED = "evicted"
STOPPED = "stopped"
RETIRED = "retired"


class LeaseRegistry:
    def __init__(
        self,
        client_ranks: "list[int]",
        ttl_s: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self._state: Dict[int, str] = {c: ACTIVE for c in client_ranks}
        self._expiry: Dict[int, Optional[float]] = {c: None for c in client_ranks}
        self._epoch: Dict[int, int] = {c: 0 for c in client_ranks}
        self._promised: set = set()
        self.evictions = 0

    # -- lifecycle -----------------------------------------------------------

    def arm(self, crank: int, epoch: int, heartbeats: bool = False) -> None:
        """Record the client's announced incarnation and heartbeat
        promise.  The expiry clock starts at the *first renew*, not
        here: between INIT and the first beat sits the seeding phase —
        a large-shard seed can outlast any reasonable TTL, and evicting
        the seeder mid-push wedges startup.  A client that promised
        beats and then beats once is on the clock; one that never beats
        never expires (its death is the supervisor's to notice)."""
        self._epoch[crank] = epoch
        if heartbeats:
            self._promised.add(crank)
        else:
            self._promised.discard(crank)
        self._expiry[crank] = None

    def renew(self, crank: int, epoch: Optional[int] = None) -> None:
        """A heartbeat (or any inbound op) from the client's *current*
        incarnation pushes its expiry out — arming the lease on the
        first one.  Beats from a stale epoch are ignored: a dead
        incarnation's queued beacons must not keep its successor's
        lease alive before the successor announces."""
        if epoch is not None and epoch != self._epoch.get(crank):
            return
        if self.ttl_s > 0 and crank in self._promised:
            self._expiry[crank] = self._clock() + self.ttl_s

    def expired(self) -> List[int]:
        """ACTIVE clients whose armed lease has lapsed (reaper input)."""
        now = self._clock()
        return [
            c for c, exp in self._expiry.items()
            if exp is not None and now > exp and self._state[c] == ACTIVE
        ]

    def evict(self, crank: int) -> None:
        if self._state.get(crank) == ACTIVE:
            self._state[crank] = EVICTED
            self._expiry[crank] = None
            self.evictions += 1

    def stop(self, crank: int) -> None:
        self._state[crank] = STOPPED
        self._expiry[crank] = None

    def retire(self, crank: int) -> None:
        """A clean, drained departure (elastic scale-down).  Unlike
        eviction, retirement is never reported by ``expired()`` again —
        retiring-then-silent is the expected shape, not a death."""
        self._state[crank] = RETIRED
        self._expiry[crank] = None

    def admit(self, crank: int, epoch: int = 0) -> None:
        """Register a rank that joined after construction (late client
        admission / controller-spawned server).  Idempotent for known
        ranks except that it re-activates them."""
        self._state[crank] = ACTIVE
        self._epoch.setdefault(crank, epoch)
        self._expiry.setdefault(crank, None)

    def rejoin(self, crank: int, epoch: int) -> None:
        """A new incarnation re-announced: back to ACTIVE under its new
        epoch (the lease re-arms when the INIT flags promise beats)."""
        self._state[crank] = ACTIVE
        self._epoch[crank] = epoch
        self._expiry[crank] = None

    # -- queries -------------------------------------------------------------

    def epoch(self, crank: int) -> int:
        return self._epoch.get(crank, 0)

    def armed(self, crank: int) -> bool:
        """True once the expiry clock started (first renew seen)."""
        return self._expiry.get(crank) is not None

    def state(self, crank: int) -> str:
        return self._state.get(crank, ACTIVE)

    def gone(self, crank: int) -> bool:
        """Abort predicate for this client's service recv loops."""
        return self._state.get(crank) != ACTIVE

    def all_done(self) -> bool:
        """Stop condition: nobody left ACTIVE."""
        return all(s != ACTIVE for s in self._state.values())
