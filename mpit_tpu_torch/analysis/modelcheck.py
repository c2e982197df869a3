"""Bounded interleaving model checker (MT-M7xx) — the schema's handshake
state machines, exhaustively explored.

The recv-recv deadlock shapes the FT/chunking machinery was built to
avoid (the EASGD-lineage PS model's classic failure) were, until now,
only caught dynamically: a wedged gang, a flight-recorder postmortem, a
CI timeout.  This module explores every cooperative-scheduler
interleaving of the INIT/STOP/RETIRE/PREEMPT/SUBSCRIBE handshakes that
:data:`mpit_tpu_torch.analysis.schema.HANDSHAKES` declares — bounded only by
per-channel capacity and a global state cap — and reports:

- **MT-M701 deadlock**: a reachable global state where no transition is
  enabled and some role is resting outside its terminal states (the
  recv-recv wait cycle, generalized);
- **MT-M702 unreachable transition**: a declared transition (an ack
  recv, a reply send) that fires in *no* fault-free execution — dead
  protocol surface, or a handshake that cannot complete the way the
  table claims;
- **MT-M703 unacked terminal**: a fault-free execution reaching
  quiescence while some role still awaits a declared ack (``expects``
  on the send) that can no longer arrive.

Transitions may declare per-hop ``drop``/``dup`` fault toggles — the
tolerances the protocol actually claims (duplicated framed writes are
re-acked by dedup, dropped DIFF deltas are recovered by resync).  A
second exploration pass with faults enabled must *still* be
deadlock-free; unacked-terminal is only judged on fault-free paths
(retry machinery, not the handshake table, owns lost-message recovery).

The model: one FIFO queue per (sender role, receiver role, tag) — the
transport's per-(peer, tag) channel discipline — with sends blocked at
``channel_cap`` in-flight messages (the dispatcher's bounded in-flight
rule; it is also what keeps the reachable state space finite).

Like the rest of mpit_tpu_torch.analysis: stdlib-only, nothing imported from
the code under analysis.  Fixture machines (seeded violations) load
from plain-data python files via ``--machines``.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple

from mpit_tpu_torch.analysis import schema
from mpit_tpu_torch.analysis.core import register_rules

register_rules({
    "MT-M701": ("error", "reachable deadlock state in a handshake machine "
                         "(recv-recv wait cycle)"),
    "MT-M702": ("error", "declared handshake transition never fires in any "
                         "explored execution (unreachable ack)"),
    "MT-M703": ("error", "handshake quiesces with a declared ack still "
                         "outstanding (unacked terminal)"),
    "MT-M704": ("warn", "exploration hit the state bound — verdicts are "
                        "incomplete"),
})


@dataclass(frozen=True)
class Transition:
    role: str
    index: int  # per-role declaration index (coverage key)
    state: str
    action: str  # "send" | "recv" | "tau"
    tag: str
    peer: str
    target: str
    expects: Optional[str] = None
    drop: bool = False
    dup: bool = False

    def label(self) -> str:
        arrow = {"send": "!", "recv": "?", "tau": "·"}[self.action]
        peer = f"→{self.peer}" if self.action == "send" else (
            f"←{self.peer}" if self.action == "recv" else "")
        return f"{self.role}:{self.state}{arrow}{self.tag}{peer}"


@dataclass
class Machine:
    name: str
    doc: str
    channel_cap: int
    roles: List[str]
    start: Dict[str, str]
    terminal: Dict[str, FrozenSet[str]]
    transitions: List[Transition]

    @classmethod
    def from_dict(cls, data: dict) -> "Machine":
        roles = list(data["roles"])
        start, terminal = {}, {}
        transitions: List[Transition] = []
        for role, spec in data["roles"].items():
            start[role] = spec["start"]
            terminal[role] = frozenset(spec["terminal"])
            for i, t in enumerate(spec["transitions"]):
                state, action, tag, peer, target, opts = t
                if action not in ("send", "recv", "tau"):
                    raise ValueError(
                        f"machine {data['name']}: unknown action {action!r}")
                if action != "tau" and peer not in data["roles"]:
                    raise ValueError(
                        f"machine {data['name']}: transition {t!r} names "
                        f"unknown peer role {peer!r}")
                transitions.append(Transition(
                    role=role, index=len(transitions), state=state,
                    action=action, tag=tag, peer=peer, target=target,
                    expects=opts.get("expects"),
                    drop=bool(opts.get("drop")), dup=bool(opts.get("dup"))))
        return cls(name=data["name"], doc=data.get("doc", ""),
                   channel_cap=int(data.get("channel_cap", 2)),
                   roles=roles, start=start, terminal=terminal,
                   transitions=transitions)


#: global state: (role states, channels, pending acks) — all hashable.
#: channels: sorted tuple of ((src, dst, tag), (msg count as tuple of
#: tags — FIFO order preserved)); pending: sorted tuple of (role, tag).
State = Tuple[Tuple[str, ...], tuple, tuple]


@dataclass
class Violation:
    rule: str
    machine: str
    detail: str
    trace: List[str] = field(default_factory=list)

    def render(self) -> str:
        tr = (" [trace: " + " ; ".join(self.trace) + "]") if self.trace \
            else ""
        return f"{self.machine}: {self.rule} {self.detail}{tr}"


@dataclass
class MachineResult:
    machine: str
    states_fault_free: int = 0
    states_faulty: int = 0
    truncated: bool = False
    uncovered: List[str] = field(default_factory=list)
    violations: List[Violation] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {
            "machine": self.machine,
            "states_fault_free": self.states_fault_free,
            "states_faulty": self.states_faulty,
            "truncated": self.truncated,
            "uncovered": list(self.uncovered),
            "violations": [
                {"rule": v.rule, "detail": v.detail, "trace": v.trace}
                for v in self.violations
            ],
        }


def _initial(m: Machine) -> State:
    return (tuple(m.start[r] for r in m.roles), (), ())


def _channels_to_dict(channels: tuple) -> Dict[tuple, tuple]:
    return {k: v for k, v in channels}


def _channels_from_dict(d: Dict[tuple, tuple]) -> tuple:
    return tuple(sorted((k, v) for k, v in d.items() if v))


def _enabled(m: Machine, state: State) -> List[Transition]:
    role_states = dict(zip(m.roles, state[0]))
    chans = _channels_to_dict(state[1])
    out = []
    for t in m.transitions:
        if role_states[t.role] != t.state:
            continue
        if t.action == "send":
            q = chans.get((t.role, t.peer, t.tag), ())
            if len(q) < m.channel_cap:
                out.append(t)
        elif t.action == "recv":
            if chans.get((t.peer, t.role, t.tag), ()):
                out.append(t)
        else:
            out.append(t)
    return out


def _apply(m: Machine, state: State, t: Transition,
           copies: int = 1) -> State:
    """The successor state after firing ``t`` delivering ``copies``
    messages (0 = dropped, 2 = duplicated; recv/tau ignore it)."""
    idx = m.roles.index(t.role)
    roles = list(state[0])
    roles[idx] = t.target
    chans = _channels_to_dict(state[1])
    pending = list(state[2])
    if t.action == "send":
        key = (t.role, t.peer, t.tag)
        q = list(chans.get(key, ()))
        q.extend([t.tag] * copies)
        chans[key] = tuple(q[:m.channel_cap])
        if t.expects:
            pending.append((t.role, t.expects))
    elif t.action == "recv":
        key = (t.peer, t.role, t.tag)
        q = list(chans.get(key, ()))
        q.pop(0)
        chans[key] = tuple(q)
        want = (t.role, t.tag)
        if want in pending:
            pending.remove(want)
    return (tuple(roles), _channels_from_dict(chans),
            tuple(sorted(pending)))


def _all_terminal(m: Machine, state: State) -> bool:
    return all(s in m.terminal[r] for r, s in zip(m.roles, state[0]))


def _blocked_detail(m: Machine, state: State) -> str:
    parts = []
    role_states = dict(zip(m.roles, state[0]))
    for t in m.transitions:
        if role_states[t.role] == t.state and t.action == "recv":
            parts.append(f"{t.role}@{t.state} blocked on recv({t.tag})")
    nonterm = [f"{r}@{s}" for r, s in zip(m.roles, state[0])
               if s not in m.terminal[r]]
    head = "stuck with " + ", ".join(nonterm) + " non-terminal"
    return head + ("; " + "; ".join(sorted(set(parts))) if parts else "")


def _trace(parents: dict, state: State) -> List[str]:
    labels: List[str] = []
    while True:
        prev = parents.get(state)
        if prev is None:
            break
        state, label = prev
        labels.append(label)
    labels.reverse()
    return labels[-12:] if len(labels) > 12 else labels


def explore(m: Machine, faults: bool, max_states: int = 200_000
            ) -> Tuple[int, bool, set, List[Violation]]:
    """BFS over every reachable global state.  Returns (state count,
    truncated, covered transition indices, violations)."""
    violations: List[Violation] = []
    start = _initial(m)
    seen = {start}
    parents: dict = {start: None}
    queue = deque([start])
    covered: set = set()
    deadlocked: set = set()
    truncated = False
    while queue:
        state = queue.popleft()
        enabled = _enabled(m, state)
        if not enabled and not _all_terminal(m, state):
            key = state[0]
            if key not in deadlocked:
                deadlocked.add(key)
                violations.append(Violation(
                    "MT-M701", m.name, _blocked_detail(m, state),
                    _trace(parents, state)))
            continue
        if not faults and state[2] and (
                not enabled or _all_terminal(m, state)):
            # Quiescent (resting or fully terminal) with an ack still
            # owed on a fault-free path.
            owed = ", ".join(f"{r} awaits {tag}" for r, tag in state[2])
            violations.append(Violation(
                "MT-M703", m.name,
                f"quiescent with outstanding acks: {owed}",
                _trace(parents, state)))
            # keep exploring; further states may add distinct violations
        for t in enabled:
            covered.add(t.index)
            variants = [1]
            if faults and t.action == "send":
                if t.drop:
                    variants.append(0)
                if t.dup:
                    variants.append(2)
            for copies in variants:
                nxt = _apply(m, state, t, copies)
                if nxt in seen:
                    continue
                if len(seen) >= max_states:
                    truncated = True
                    continue
                seen.add(nxt)
                suffix = {0: " (dropped)", 2: " (duplicated)"}.get(
                    copies, "")
                parents[nxt] = (state, t.label() + suffix)
                queue.append(nxt)
    return len(seen), truncated, covered, violations


def check_machine(m: Machine, max_states: int = 200_000) -> MachineResult:
    res = MachineResult(machine=m.name)
    n, trunc, covered, vio = explore(m, faults=False,
                                     max_states=max_states)
    res.states_fault_free, res.truncated = n, trunc
    res.violations.extend(vio)
    if any(t.drop or t.dup for t in m.transitions):
        n2, trunc2, covered2, vio2 = explore(m, faults=True,
                                             max_states=max_states)
        res.states_faulty = n2
        res.truncated = res.truncated or trunc2
        covered |= covered2  # fault-recovery transitions count as live
        # fault exploration re-finds fault-free deadlocks; only new
        # deadlock shapes are additional information
        known = {(v.rule, v.detail) for v in res.violations}
        res.violations.extend(v for v in vio2
                              if (v.rule, v.detail) not in known)
    for t in m.transitions:
        if t.index not in covered:
            res.uncovered.append(t.label())
            res.violations.append(Violation(
                "MT-M702", m.name,
                f"transition {t.label()} fires in no explored execution "
                "— the handshake cannot complete the way the table "
                "claims"))
    if res.truncated:
        res.violations.append(Violation(
            "MT-M704", m.name,
            f"exploration truncated at {max_states} states — raise "
            "--max-states or shrink the machine"))
    return res


def machines_from(dicts) -> List[Machine]:
    return [Machine.from_dict(d) for d in dicts]


def live_machines() -> List[Machine]:
    return machines_from(schema.HANDSHAKES)


def load_machines_file(path) -> List[Machine]:
    """Load MACHINES = [...] from a plain-data fixture file (executed —
    fixtures are ours; they carry no imports of the scanned tree)."""
    import pathlib
    src = pathlib.Path(path).read_text(encoding="utf-8")
    ns: dict = {}
    exec(compile(src, str(path), "exec"), ns)  # noqa: S102 — fixture data
    return machines_from(ns["MACHINES"])


def check_all(machines: Optional[List[Machine]] = None,
              max_states: int = 200_000) -> List[MachineResult]:
    return [check_machine(m, max_states=max_states)
            for m in (machines if machines is not None
                      else live_machines())]


def report_dict(results: List[MachineResult]) -> dict:
    return {
        "schema": "mpit_modelcheck/1",
        "machines": [r.to_dict() for r in results],
        "total_states": sum(r.states_fault_free + r.states_faulty
                            for r in results),
        "clean": all(r.clean for r in results),
    }


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.analysis modelcheck",
        description="bounded interleaving exploration of the schema's "
        "handshake state machines")
    ap.add_argument("--machines", default=None,
                    help="fixture file defining MACHINES (default: the "
                    "live schema HANDSHAKES)")
    ap.add_argument("--report", default=None,
                    help="write the explored-state report JSON here")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the report JSON to stdout")
    ap.add_argument("--max-states", type=int, default=200_000)
    args = ap.parse_args(argv)

    machines = (load_machines_file(args.machines)
                if args.machines else live_machines())
    results = check_all(machines, max_states=args.max_states)
    report = report_dict(results)
    if args.report:
        import pathlib
        pathlib.Path(args.report).write_text(
            json.dumps(report, indent=2), encoding="utf-8")
    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        for r in results:
            status = "clean" if r.clean else "VIOLATIONS"
            print(f"modelcheck: {r.machine}: {status} "
                  f"({r.states_fault_free} states fault-free"
                  + (f", {r.states_faulty} with faults"
                     if r.states_faulty else "") + ")")
            for v in r.violations:
                print(f"  {v.render()}")
    return 0 if report["clean"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
