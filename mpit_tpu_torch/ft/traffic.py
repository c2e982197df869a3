"""Trace-driven workload + chaos traffic generation — deterministic,
seeded, replayable scenario scripts.

A copy of ``mpit_tpu/ft/traffic.py``: the port imports
nothing of the JAX package.

An autoscaler proven only against flat synthetic load is not proven:
the regimes static provisioning handles worst are exactly the shaped
ones — diurnal reader curves, gradient bursts, spot-preemption waves,
slow-joiner churn and stragglers (the imbalanced-arrival pathology,
arxiv 1804.05349).  This module turns those shapes into **data**: a
:class:`Scenario` is an ordered list of :class:`TrafficPhase`\\ s, and
``Scenario.schedule()`` expands it into a flat, fully deterministic
event list — a pure function of ``(seed, phases)``, computed with the
same splitmix64 the fault planner uses (ft/retry.py), **no clocks, no
``random``** — so the same spec string replays the same traffic on
every run, every host, every interpreter (the soak harness's bitwise
bar depends on it, and tests assert schedule equality byte for byte).

Event kinds (:class:`TrafficEvent`):

- ``grad`` — one serialized training round for writer ``target`` (the
  harness sends-and-waits, preserving the cross-client apply order that
  makes chaos runs bitwise-comparable to fault-free ones);
- ``read`` — ``count`` reader pulls dispatched to reader ``target``
  (readers float freely — reads never mutate state, so their
  concurrency is the *load*, not a correctness hazard);
- ``preempt`` — a spot-reclaim notice for one serving rank (the
  harness raises the rank's :class:`PreemptionNotice` flag, or sends a
  real SIGTERM in process gangs — ``ft/faults.py inject_preemption``);
- ``join`` — a slow joiner attaches mid-run (late admission, §9.6);
- ``straggle_on`` / ``straggle_off`` — one serving rank runs
  ``straggle_mult`` x slower (the harness scales its member-capacity
  throttle) — a straggler, not a death.

Reader load shapes: ``curve=flat`` holds ``reads`` per tick;
``curve=sine`` sweeps a half-period diurnal hump over the phase (rush
hour in the middle); ``curve=ramp`` climbs linearly to ``reads``.
Fractional per-tick read budgets accumulate exactly (error carrying),
and a seeded ±25% jitter keeps the trace production-shaped while
staying replayable.

Spec grammar (one line, ``;``-separated; docs/OPERATIONS.md §2)::

    seed=7;name=calm,ticks=8,grads=1,reads=2,duty=0.7;\\
    name=rush,ticks=12,reads=10,curve=sine,duty=0.3;\\
    name=wave,ticks=8,reads=6,preempt_at=2,duty=0.3

Each phase declares ``duty`` — the fraction of its post-settle SLO
windows expected to meet the SLO — which is the per-phase acceptance
bar the soak harness enforces.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, fields
from typing import Dict, Iterator, List, Optional, Tuple

from mpit_tpu_torch.ft.retry import _splitmix64

_MASK = (1 << 64) - 1

#: event kinds
GRAD, READ, PREEMPT, JOIN = "grad", "read", "preempt", "join"
STRAGGLE_ON, STRAGGLE_OFF = "straggle_on", "straggle_off"

_CURVES = ("flat", "sine", "ramp")


@dataclass(frozen=True)
class TrafficPhase:
    """One traffic shape, held for ``ticks`` scheduler ticks."""

    name: str = "phase"
    ticks: int = 8
    #: serialized training rounds per writer per tick.
    grads: int = 1
    #: reader pulls per reader per tick (peak value for shaped curves).
    reads: float = 0.0
    #: reader-load shape across the phase: flat | sine | ramp.
    curve: str = "flat"
    #: every k-th tick multiplies grads by burst_mult (0 = no bursts).
    burst_every: int = 0
    burst_mult: int = 2
    #: tick offsets (within the phase) firing a preemption wave; each
    #: wave targets one serving rank chosen round-robin by the harness.
    preempt_at: Tuple[int, ...] = ()
    #: tick offset a slow joiner attaches at (-1 = none).
    join_at: int = -1
    #: tick offset straggler injection starts (-1 = none) ...
    straggle_at: int = -1
    #: ... how long it lasts (0 = to the end of the phase) and how slow.
    straggle_ticks: int = 0
    straggle_mult: float = 4.0
    #: declared SLO duty-cycle expectation: the fraction of this
    #: phase's post-settle windows expected in-SLO (the soak bar).
    duty: float = 0.5

    def load_at(self, tick: int) -> float:
        """The shaped reader budget (reads per reader) at phase tick."""
        if self.reads <= 0:
            return 0.0
        if self.curve == "sine":
            # Half-period diurnal hump: quiet edges, rush in the middle.
            frac = (tick + 0.5) / max(self.ticks, 1)
            return self.reads * math.sin(math.pi * frac)
        if self.curve == "ramp":
            return self.reads * (tick + 1) / max(self.ticks, 1)
        return self.reads

    def validate(self) -> "TrafficPhase":
        if self.ticks <= 0:
            raise ValueError(f"phase {self.name!r}: ticks must be >= 1")
        if self.curve not in _CURVES:
            raise ValueError(
                f"phase {self.name!r}: curve must be one of {_CURVES}")
        if not 0.0 <= self.duty <= 1.0:
            raise ValueError(f"phase {self.name!r}: duty must be in [0,1]")
        for off in self.preempt_at + ((self.join_at,)
                                      if self.join_at >= 0 else ()):
            if off >= self.ticks:
                raise ValueError(
                    f"phase {self.name!r}: event offset {off} outside "
                    f"{self.ticks} ticks")
        return self


@dataclass(frozen=True)
class TrafficEvent:
    """One scheduled action at a global tick (stable sort order:
    chaos/membership first, then grads, then reads — the order the
    harness executes within a tick)."""

    tick: int
    phase: str
    kind: str
    target: int = 0
    count: int = 1

    def to_dict(self) -> Dict[str, object]:
        return {"tick": self.tick, "phase": self.phase, "kind": self.kind,
                "target": self.target, "count": self.count}


_INT_FIELDS = {"ticks", "grads", "burst_every", "burst_mult", "join_at",
               "straggle_at", "straggle_ticks"}
_FLOAT_FIELDS = {"reads", "straggle_mult", "duty"}


def _parse_phase(part: str) -> TrafficPhase:
    kw: Dict[str, object] = {}
    for item in (p.strip() for p in part.split(",") if p.strip()):
        key, _, value = item.partition("=")
        key = key.strip()
        if key == "name" or key == "curve":
            kw[key] = value.strip()
        elif key == "preempt_at":
            kw[key] = tuple(int(t) for t in value.split("+") if t)
        elif key in _INT_FIELDS:
            kw[key] = int(value)
        elif key in _FLOAT_FIELDS:
            kw[key] = float(value)
        else:
            known = sorted({f.name for f in fields(TrafficPhase)})
            raise ValueError(
                f"unknown phase field {key!r} (have: {known})")
    return TrafficPhase(**kw).validate()


@dataclass(frozen=True)
class Scenario:
    """A seeded sequence of traffic phases + the gang shape it drives."""

    phases: Tuple[TrafficPhase, ...]
    seed: int = 0
    #: how many writer / reader clients the schedule addresses.
    writers: int = 2
    readers: int = 2
    #: seeded jitter amplitude on per-tick read budgets (0 = none).
    jitter: float = 0.25

    def __post_init__(self):
        if not self.phases:
            raise ValueError("a scenario needs at least one phase")

    @property
    def total_ticks(self) -> int:
        return sum(p.ticks for p in self.phases)

    @property
    def shape_changes(self) -> int:
        """Traffic-shape changes = phase boundaries crossed."""
        return len(self.phases) - 1

    def phase_at(self, tick: int) -> Tuple[int, TrafficPhase, int]:
        """(phase index, phase, tick offset within it) for a global tick."""
        off = tick
        for i, phase in enumerate(self.phases):
            if off < phase.ticks:
                return i, phase, off
            off -= phase.ticks
        raise IndexError(f"tick {tick} beyond scenario end "
                         f"({self.total_ticks})")

    def _jittered(self, budget: float, pidx: int, tick: int,
                  reader: int) -> float:
        if self.jitter <= 0 or budget <= 0:
            return budget
        key = ((self.seed << 32) ^ (pidx << 24) ^ (tick << 8)
               ^ reader) & _MASK
        u = _splitmix64(key) / float(_MASK)  # [0, 1) deterministic
        return budget * (1.0 + self.jitter * (2.0 * u - 1.0))

    def schedule(self) -> List[TrafficEvent]:
        """The full deterministic event list — same (spec, seed) =>
        identical list, element for element (tests pin this)."""
        events: List[TrafficEvent] = []
        carry = [0.0] * self.readers  # fractional read budgets accumulate
        preempt_rr = 0
        tick0 = 0
        for pidx, phase in enumerate(self.phases):
            straggle_until = -1
            for off in range(phase.ticks):
                tick = tick0 + off
                # membership / chaos first (the harness executes in
                # list order within a tick)
                if phase.join_at == off:
                    events.append(TrafficEvent(tick, phase.name, JOIN))
                for p_off in phase.preempt_at:
                    if p_off == off:
                        events.append(TrafficEvent(
                            tick, phase.name, PREEMPT, target=preempt_rr))
                        preempt_rr += 1
                if phase.straggle_at == off:
                    last = (off + phase.straggle_ticks - 1
                            if phase.straggle_ticks > 0
                            else phase.ticks - 1)
                    straggle_until = min(last, phase.ticks - 1)
                    events.append(TrafficEvent(
                        tick, phase.name, STRAGGLE_ON,
                        count=max(int(phase.straggle_mult), 1)))
                elif straggle_until == off - 1 and straggle_until >= 0:
                    events.append(TrafficEvent(
                        tick, phase.name, STRAGGLE_OFF))
                    straggle_until = -1
                # serialized training rounds
                grads = phase.grads
                if phase.burst_every and (off + 1) % phase.burst_every == 0:
                    grads *= max(phase.burst_mult, 1)
                for w in range(self.writers):
                    if grads > 0:
                        events.append(TrafficEvent(
                            tick, phase.name, GRAD, target=w, count=grads))
                # shaped + jittered reader load, exact fractional carry
                budget = phase.load_at(off)
                for r in range(self.readers):
                    carry[r] += self._jittered(budget, pidx, tick, r)
                    n = int(carry[r])
                    if n > 0:
                        carry[r] -= n
                        events.append(TrafficEvent(
                            tick, phase.name, READ, target=r, count=n))
            # a straggle window still open at the phase edge closes there
            if straggle_until == phase.ticks - 1:
                events.append(TrafficEvent(
                    tick0 + phase.ticks - 1, phase.name, STRAGGLE_OFF))
            tick0 += phase.ticks
        return events

    def events_json(self) -> str:
        """The schedule as one JSON document (the replayable trace the
        soak harness ships as an artifact next to the decision log)."""
        return json.dumps({
            "seed": self.seed,
            "writers": self.writers,
            "readers": self.readers,
            "jitter": self.jitter,
            "phases": [{f.name: (list(getattr(p, f.name))
                                 if f.name == "preempt_at"
                                 else getattr(p, f.name))
                        for f in fields(TrafficPhase)}
                       for p in self.phases],
            "events": [e.to_dict() for e in self.schedule()],
        })

    # -- construction --------------------------------------------------------

    @classmethod
    def parse(cls, spec: str, **overrides) -> "Scenario":
        """Parse the one-line grammar (module docstring).  The first
        ``;``-segment may set globals (``seed=``, ``writers=``,
        ``readers=``, ``jitter=``); every other segment is a phase."""
        parts = [p.strip() for p in spec.split(";") if p.strip()]
        if not parts:
            raise ValueError("empty scenario spec")
        globals_kw: Dict[str, object] = {}
        first = parts[0]
        if "name=" not in first and any(
                k in first for k in ("seed=", "writers=", "readers=",
                                     "jitter=")):
            for item in (p.strip() for p in first.split(",") if p.strip()):
                key, _, value = item.partition("=")
                key = key.strip()
                if key in ("seed", "writers", "readers"):
                    globals_kw[key] = int(value)
                elif key == "jitter":
                    globals_kw[key] = float(value)
                else:
                    raise ValueError(f"unknown scenario global {key!r}")
            parts = parts[1:]
        phases = tuple(_parse_phase(p) for p in parts)
        globals_kw.update(overrides)
        return cls(phases=phases, **globals_kw)

    @classmethod
    def builtin(cls, name: str, seed: int = 11) -> "Scenario":
        """The named scenarios the harness/CI/bench run (docs/
        OPERATIONS.md §2.3).  ``soak`` crosses >= 5 traffic shapes;
        ``smoke`` is the CI short form (one shape change + one
        preemption wave, then a quiet tail so the scale-down shows);
        ``bench`` is the ptest A/B's bursty leg."""
        if name == "soak":
            spec = (
                f"seed={seed},writers=2,readers=3;"
                "name=calm,ticks=16,grads=1,reads=1.5,duty=0.6;"
                "name=morning,ticks=24,grads=1,reads=8,curve=ramp,duty=0.2;"
                "name=burst,ticks=20,grads=2,reads=5,burst_every=3,"
                "burst_mult=3,duty=0.1;"
                "name=wave,ticks=20,grads=1,reads=5,preempt_at=3,duty=0.2;"
                "name=churn,ticks=20,grads=1,reads=3,join_at=2,"
                "straggle_at=6,straggle_ticks=4,straggle_mult=2,duty=0.1;"
                "name=night,ticks=24,grads=1,reads=0.3,duty=0.5"
            )
        elif name == "smoke":
            spec = (
                f"seed={seed},writers=2,readers=2;"
                "name=calm,ticks=14,grads=1,reads=1,duty=0.5;"
                "name=rush,ticks=12,grads=1,reads=8,preempt_at=4,duty=0.2;"
                "name=night,ticks=20,grads=1,reads=0.3,duty=0.4"
            )
        elif name == "bench":
            spec = (
                f"seed={seed},writers=2,readers=3,jitter=0;"
                "name=warm,ticks=6,grads=1,reads=1,duty=0.5;"
                "name=rush,ticks=30,grads=2,reads=8,burst_every=4,"
                "burst_mult=2,duty=0.2;"
                "name=cool,ticks=6,grads=1,reads=1,duty=0.4"
            )
        else:
            raise ValueError(
                f"unknown builtin scenario {name!r} "
                "(have: soak, smoke, bench)")
        return cls.parse(spec)


def iter_ticks(scenario: Scenario) -> Iterator[Tuple[int, TrafficPhase,
                                                     List[TrafficEvent]]]:
    """(global tick, phase, that tick's events) — the harness's drive
    loop, grouped from one schedule() expansion."""
    by_tick: Dict[int, List[TrafficEvent]] = {}
    for ev in scenario.schedule():
        by_tick.setdefault(ev.tick, []).append(ev)
    for tick in range(scenario.total_ticks):
        _idx, phase, _off = scenario.phase_at(tick)
        yield tick, phase, by_tick.get(tick, [])
