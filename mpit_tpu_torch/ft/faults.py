"""Deterministic fault injection at the Transport seam.

A copy of ``mpit_tpu/ft/faults.py``: the port imports nothing of the JAX
package.

Every recovery path in this subsystem (retry, dedup, lease eviction,
rejoin) is only trustworthy if a test can force the exact failure it
guards against — so faults are injected where all wire traffic already
funnels: a :class:`FaultyTransport` wraps any real transport and
drops / delays / duplicates / severs **sends** on a schedule that is a
pure function of ``(seed, src, dst, tag, per-channel message count)``.

Determinism decisions:

- **Per-channel counters**, not a global one: the scheduler's
  interleaving of sends *across* channels varies with timing (idle
  backoff, host load), but the send order *within* one (dst, tag)
  channel is fixed by the protocol.  Counting per channel makes "drop
  every 3rd GRAD" mean the same messages on every run.
- **Seeded hash, not ``random``**: rate-based faults decide from a
  splitmix64 of (seed, src, dst, tag, n) — replayable across processes
  and immune to interpreter hash salting.
- **Send-side only**: a dropped send and a dropped delivery are
  indistinguishable to the peer, so one side suffices; keeping receives
  faithful means a test can always drain surviving state.
- **Message-atomic**: a frame's [epoch, seq] header travels inside the
  message (ft/wire.py), so drop/dup/delay act on whole ops — there is
  no torn header/payload state, which is what lets the property test
  assert "bitwise-correct or loud failure, never a hang".

The plan parses from a spec string (``MPIT_FT_FAULT_PLAN``), e.g.::

    seed=7,drop_every=3,dup_every=5,delay_every=4,delay_polls=6
    seed=1,drop_rate=0.05,dup_rate=0.05,delay_rate=0.1,sever_after=200
"""

from __future__ import annotations

import os
import signal as _signal
import time as _time
from dataclasses import dataclass, field
from typing import Any, Optional

from mpit_tpu_torch.comm.transport import Handle, Transport
from mpit_tpu_torch.ft.retry import _splitmix64
from mpit_tpu_torch.obs import metrics as _obs

ENV = "MPIT_FT_FAULT_PLAN"


def inject_preemption(pid: int, grace_s: float, poll_s: float = 0.05,
                      escalate: bool = True) -> str:
    """The process-level preemption arm: SIGTERM now, SIGKILL after the
    grace window if the process is still alive — exactly a cloud spot
    reclaim, and the counterpart of the supervisor's SIGKILL chaos hook
    (a kill is instant death; a preemption is a *notice*).  Returns
    ``"term"`` when the victim exited inside its grace window (the
    graceful path: checkpoint-on-notice and/or a controller drain
    finished in time) and ``"kill"`` when it had to be escalated (the
    replay-from-checkpoint path).  ``escalate=False`` sends only the
    notice — for harnesses that own the escalation themselves."""
    os.kill(pid, _signal.SIGTERM)
    if not escalate:
        return "term"
    deadline = _time.monotonic() + max(grace_s, 0.0)
    while _time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return "term"
        _time.sleep(poll_s)
    try:
        os.kill(pid, _signal.SIGKILL)
    except ProcessLookupError:
        return "term"
    return "kill"

PASS = "pass"
DROP = "drop"
DUP = "dup"
DELAY = "delay"

_MASK = (1 << 64) - 1
_INT_FIELDS = ("seed", "drop_every", "dup_every", "delay_every",
               "delay_polls", "sever_after")
_FLOAT_FIELDS = ("drop_rate", "dup_rate", "delay_rate")


@dataclass(frozen=True)
class FaultPlan:
    seed: int = 0
    #: every k-th message on a channel (1-indexed; 0 = off).  Priority
    #: when several match one message: drop > dup > delay.
    drop_every: int = 0
    dup_every: int = 0
    delay_every: int = 0
    #: how many test() polls a delayed send is deferred before posting.
    delay_polls: int = 3
    #: seeded per-message probabilities (0.0 = off); summed thresholds,
    #: so drop_rate=0.1, dup_rate=0.1 means 10% drop, 10% dup, 80% pass.
    drop_rate: float = 0.0
    dup_rate: float = 0.0
    delay_rate: float = 0.0
    #: sever the link to a peer after this many total sends to it
    #: (-1 = never): every later send to that peer is dropped.
    sever_after: int = -1
    #: restrict faults to these tags (None = every non-negative tag;
    #: transport-internal negative tags are never faulted).
    tags: Optional[frozenset] = None

    def decide(self, src: int, dst: int, tag: int, n: int) -> str:
        """Verdict for the ``n``-th (1-indexed) message on this channel."""
        if tag < 0 or (self.tags is not None and tag not in self.tags):
            return PASS
        if self.drop_every and n % self.drop_every == 0:
            return DROP
        if self.dup_every and n % self.dup_every == 0:
            return DUP
        if self.delay_every and n % self.delay_every == 0:
            return DELAY
        if self.drop_rate or self.dup_rate or self.delay_rate:
            key = (self.seed << 48) ^ (src << 36) ^ (dst << 24) ^ (tag << 16) ^ n
            r = _splitmix64(key & _MASK) / float(_MASK)
            if r < self.drop_rate:
                return DROP
            if r < self.drop_rate + self.dup_rate:
                return DUP
            if r < self.drop_rate + self.dup_rate + self.delay_rate:
                return DELAY
        return PASS

    @classmethod
    def parse(cls, spec: str, **overrides) -> "FaultPlan":
        fields: dict = {}
        for part in (p.strip() for p in spec.split(",") if p.strip()):
            key, _, value = part.partition("=")
            key = key.strip()
            if key in _INT_FIELDS:
                fields[key] = int(value)
            elif key in _FLOAT_FIELDS:
                fields[key] = float(value)
            elif key == "tags":
                fields[key] = frozenset(int(t) for t in value.split("+") if t)
            else:
                raise ValueError(f"unknown fault-plan field {key!r} in {spec!r}")
        fields.update(overrides)
        return cls(**fields)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        spec = os.environ.get(ENV, "")
        return cls.parse(spec) if spec else None


class FaultyTransport(Transport):
    """Transport wrapper applying a :class:`FaultPlan` to outbound sends.

    Fault mechanics reuse the caller-visible Handle contract, so the aio
    poll loops drive recovery without knowing faults exist:

    - DROP: the handle completes immediately; nothing is posted.
    - DUP: two identical inner sends; the handle completes when both do.
    - DELAY: the inner send is *posted* only after ``delay_polls`` test
      calls — the caller's buffer stays alive (liveness rule), so no
      copy is needed and the delayed bytes are exact.
    - severed peer: every send after the cutoff is dropped.

    Receives, probes and blocking conveniences delegate untouched.
    """

    def __init__(self, inner: Transport, plan: FaultPlan):
        self.inner = inner
        self.plan = plan
        self.rank = inner.rank
        self.nranks = inner.nranks
        self._counts: dict = {}  # (dst, tag) -> messages seen
        self._sent_to: dict = {}  # dst -> total sends attempted
        self.severed: set = set()
        # Injected-fault counters ride the obs registry (null when obs
        # is disabled, but the attribute surface below always counts —
        # tests and chaos harnesses read .dropped/.duplicated/.delayed).
        reg = _obs.registry_or_local()
        self._m_dropped = reg.counter("mpit_ft_faults_total",
                                      kind="drop", rank=self.rank)
        self._m_duplicated = reg.counter("mpit_ft_faults_total",
                                         kind="dup", rank=self.rank)
        self._m_delayed = reg.counter("mpit_ft_faults_total",
                                      kind="delay", rank=self.rank)

    @property
    def dropped(self) -> int:
        return int(self._m_dropped.value)

    @property
    def duplicated(self) -> int:
        return int(self._m_duplicated.value)

    @property
    def delayed(self) -> int:
        return int(self._m_delayed.value)

    # -- send-side fault application ----------------------------------------

    def isend(self, data: Any, dst: int, tag: int) -> Handle:
        total = self._sent_to.get(dst, 0) + 1
        self._sent_to[dst] = total
        if dst in self.severed:
            self._m_dropped.inc()
            return Handle(kind="send", peer=dst, tag=tag, meta={"ft": DROP})
        if self.plan.sever_after >= 0 and total > self.plan.sever_after:
            self.severed.add(dst)
            self._m_dropped.inc()
            return Handle(kind="send", peer=dst, tag=tag, meta={"ft": DROP})
        n = self._counts.get((dst, tag), 0) + 1
        self._counts[(dst, tag)] = n
        verdict = self.plan.decide(self.rank, dst, tag, n)
        if verdict == DROP:
            self._m_dropped.inc()
            return Handle(kind="send", peer=dst, tag=tag, meta={"ft": DROP})
        if verdict == DUP:
            self._m_duplicated.inc()
            inner = [self.inner.isend(data, dst, tag),
                     self.inner.isend(data, dst, tag)]
            return Handle(kind="send", peer=dst, tag=tag,
                          meta={"ft": DUP, "inner": inner})
        if verdict == DELAY:
            self._m_delayed.inc()
            return Handle(
                kind="send", peer=dst, tag=tag, buf=data,
                meta={"ft": DELAY, "polls": self.plan.delay_polls},
            )
        return self.inner.isend(data, dst, tag)

    def test(self, handle: Handle) -> bool:
        fault = handle.meta.get("ft")
        if fault is None:
            return self.inner.test(handle)
        if handle.cancelled:
            return False
        if fault == DROP:
            handle.done = True
            return True
        if fault == DUP:
            done = all(self.inner.test(h) for h in handle.meta["inner"])
            handle.done = handle.done or done
            return handle.done
        # DELAY: defer the post itself, then proxy the inner handle.
        inner = handle.meta.get("inner")
        if inner is None:
            handle.meta["polls"] -= 1
            if handle.meta["polls"] > 0:
                return False
            inner = self.inner.isend(handle.buf, handle.peer, handle.tag)
            handle.meta["inner"] = inner
            handle.buf = None  # inner handle owns liveness now
        if self.inner.test(inner):
            handle.done = True
        return handle.done

    def cancel(self, handle: Handle) -> None:
        fault = handle.meta.get("ft")
        if fault is None:
            return self.inner.cancel(handle)
        inner = handle.meta.get("inner")
        if fault == DUP:
            for h in inner or []:
                self.inner.cancel(h)
        elif inner is not None:
            self.inner.cancel(inner)
        handle.cancelled = True
        handle.buf = None

    def sever(self, dst: int) -> None:
        """Hard-cut the link to ``dst`` now (test hook: a crashed peer)."""
        self.severed.add(dst)

    # -- faithful delegation -------------------------------------------------

    def irecv(self, src: int, tag: int, out: Any | None = None) -> Handle:
        return self.inner.irecv(src, tag, out=out)

    def iprobe(self, src: int, tag: int) -> bool:
        return self.inner.iprobe(src, tag)

    def payload(self, handle: Handle) -> Any:
        return self.inner.payload(handle)

    def close(self) -> None:
        self.inner.close()


class LinkClock:
    """A shared serial-link reservation clock: PacedTransport instances
    constructed with the same clock model ONE physical link per
    destination — e.g. a server's inbound NIC shared by a fan-in of
    senders (the §13.6 aggregation A/B), where each sender's private
    pacer would wrongly grant the fan-in N parallel links.  Thread-safe:
    sender threads reserve atomically."""

    def __init__(self):
        import threading

        self._free: dict = {}
        self._lock = threading.Lock()

    def reserve(self, dst: int, seconds: float) -> float:
        """Claim ``seconds`` of dst's link; returns the completion
        time (monotonic)."""
        with self._lock:
            now = _time.monotonic()
            due = max(now, self._free.get(dst, now)) + seconds
            self._free[dst] = due
            return due


class PacedTransport(Transport):
    """A store-and-forward *link model*: every outbound message to a peer
    transits a serial link of ``rate_mbs`` megabytes/second, so a
    message becomes visible to the receiver only after every earlier
    message on that link has finished transmitting plus its own
    ``nbytes / rate`` of link time.  The sender is never blocked — the
    post is deferred, not slept — which is exactly what makes pipeline
    overlap measurable: while one chunk occupies the modeled link, the
    sender's core is free to encode the next one and the receiver's to
    apply the previous one.

    This is a *model*, not a fault plan: it exists for the streaming
    bench/smoke legs (docs/PROTOCOL.md §12.7), the same role the
    member-capacity throttle plays for the elastic sweeps — on a
    time-shared bench host an unmodeled loopback "wire" is a memcpy
    whose cost is indistinguishable from compute, so the A/B would
    measure host scheduling, not transfer pipelining.  Receives,
    probes and small control traffic (``min_bytes``) pass untouched.
    """

    def __init__(self, inner: Transport, rate_mbs: float,
                 min_bytes: int = 4096,
                 tags: "Optional[frozenset]" = None,
                 link: "Optional[LinkClock]" = None):
        self.inner = inner
        self.rank = inner.rank
        self.nranks = inner.nranks
        self.rate = float(rate_mbs) * (1 << 20)
        self.min_bytes = int(min_bytes)
        self.tags = tags
        #: the per-dst link reservation clock; pass a shared LinkClock
        #: to make several transports contend for one physical link
        #: per destination (fan-in modeling, §13.6)
        self._link = link if link is not None else LinkClock()
        #: dst -> deque of (due, data, tag, proxy Handle) awaiting post
        self._queued: dict = {}

    def _pump(self) -> None:
        """Post every queued message whose link time elapsed (called
        from every test/iprobe — the same progress discipline the shm
        transport uses)."""
        now = _time.monotonic()
        for dst, queue in self._queued.items():
            while queue and queue[0][0] <= now:
                _due, data, tag, proxy = queue.pop(0)
                if proxy.cancelled:
                    continue
                proxy.meta["inner"] = self.inner.isend(data, dst, tag)
                proxy.buf = None  # inner handle owns liveness now

    def isend(self, data: Any, dst: int, tag: int) -> Handle:
        nbytes = int(getattr(data, "nbytes", None) or len(data or b""))
        if (tag < 0 or nbytes < self.min_bytes
                or (self.tags is not None and tag not in self.tags)):
            return self.inner.isend(data, dst, tag)
        due = self._link.reserve(dst, nbytes / self.rate)
        proxy = Handle(kind="send", peer=dst, tag=tag, buf=data,
                       meta={"paced": True})
        self._queued.setdefault(dst, []).append((due, data, tag, proxy))
        return proxy

    def test(self, handle: Handle) -> bool:
        self._pump()
        if not handle.meta.get("paced"):
            return self.inner.test(handle)
        if handle.cancelled:
            return False
        inner = handle.meta.get("inner")
        if inner is None:
            return False  # still on the modeled link
        if self.inner.test(inner):
            handle.done = True
        return handle.done

    def cancel(self, handle: Handle) -> None:
        if not handle.meta.get("paced"):
            return self.inner.cancel(handle)
        inner = handle.meta.get("inner")
        if inner is not None:
            self.inner.cancel(inner)
        handle.cancelled = True
        handle.buf = None

    def iprobe(self, src: int, tag: int) -> bool:
        self._pump()
        return self.inner.iprobe(src, tag)

    def irecv(self, src: int, tag: int, out: Any | None = None) -> Handle:
        return self.inner.irecv(src, tag, out=out)

    def payload(self, handle: Handle) -> Any:
        return self.inner.payload(handle)

    def close(self) -> None:
        self.inner.close()
