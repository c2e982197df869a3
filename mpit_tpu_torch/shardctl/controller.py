"""The shard-map control plane: one controller rank per gang.

A copy of ``mpit_tpu/shardctl/controller.py``, over the port's ``aio``, ``ft.LeaseRegistry`` and ``obs``: the port imports
nothing of the JAX package.

The controller owns the authoritative :class:`ShardMap` and is the only
writer of new versions.  Everything it knows arrives over the existing
transport fabric — server beats (HEARTBEAT frames carrying per-shard
load reports), directive echoes (MAP_UPDATE/DONE), and client STOPs —
so it deploys exactly like any other rank: in-process for tests, a gang
child in the process launcher, its own host over TCP.

Four responsibilities:

- **liveness of servers** — the PR 3 lease machinery pointed the other
  way: a :class:`~mpit_tpu_torch.ft.leases.LeaseRegistry` over *server* ranks,
  renewed by their beats.  Expiry triggers **shard failover**: the dead
  server's shards are reassigned to survivors, each of which ADOPTs the
  shard from its latest checkpoint — the gang keeps training instead of
  wedging or waiting for a same-rank restart.
- **load-aware rebalancing** — beats carry per-shard busy-seconds
  deltas (from the servers' obs instruments); the
  :class:`~mpit_tpu_torch.shardctl.policy.RebalancePolicy` turns a window of
  them into at most one migration proposal, executed via the live
  RELEASE/ACQUIRE handshake (docs/PROTOCOL.md §7.3).
- **map distribution** — after any flip the new map is broadcast
  (MAP_UPDATE/INSTALL) to every client and surviving server.  Broadcast
  is an optimization; the NACK_MAP path is the correctness mechanism.
- **elastic membership** (docs/PROTOCOL.md §9) — :meth:`scale_up` asks
  the environment (``spawner``) for a fresh server rank, waits for its
  HEARTBEAT lease to arm, then rebalances shards onto the widened set
  via the existing live migration; :meth:`scale_down` drains a server
  (every shard migrated to survivors) and completes the RETIRE
  handshake so the rank exits as a goodbye, not a crash — its lease
  moves to the RETIRED terminal state, which ``expired()`` never
  reports, so a retired rank's silence can never trigger failover
  (retire-vs-dead is a first-class distinction).  A server that
  receives a preemption notice (SIGTERM-with-grace; ft/elastic.py)
  reports it as a PREEMPT directive: a generous window gets the
  graceful drain, a stingy one costs at most replay-from-checkpoint
  through the ordinary lease-expiry failover.  Scale verbs are also
  operator-reachable as the statusd ``/scale`` route (requests are
  queued thread-safely and executed by :meth:`pump`).

Determinism for tests: the clock is injected (lease expiry and policy
windows can be driven by a fake clock), ``pump()`` does one bounded
scan with no sleeps, and ``migrate()``/``failover()``/``scale_up()``/
``scale_down()`` are synchronous methods a test can call directly.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

import numpy as np

from mpit_tpu_torch.aio import LiveFlag, Scheduler, aio_recv, aio_send, deadline_at
from mpit_tpu_torch.ft import LeaseRegistry
from mpit_tpu_torch.obs import (
    obs_enabled,
    register_status_action,
    register_status_provider,
    registry_or_local,
)
from mpit_tpu_torch.ps import tags
from mpit_tpu_torch.shardctl.migrate import SC_DEADLINE_S
from mpit_tpu_torch.shardctl.policy import RebalancePolicy, ShardLoad
from mpit_tpu_torch.shardctl.shardmap import ShardMap
from mpit_tpu_torch.shardctl.wire import (
    ACQUIRE,
    ADOPT,
    DONE,
    INSTALL,
    PREEMPT,
    RELEASE,
    RETIRE,
    RETIRED,
    map_update,
    parse_map_update,
)
from mpit_tpu_torch.utils.logging import get_logger


class ShardController:
    def __init__(
        self,
        rank: int,
        transport,
        server_ranks: List[int],
        client_ranks: List[int],
        smap: Optional[ShardMap] = None,
        policy: Optional[RebalancePolicy] = None,
        lease_ttl_s: float = 0.0,
        op_deadline_s: float = SC_DEADLINE_S,
        scheduler: Optional[Scheduler] = None,
        clock: Callable[[], float] = time.monotonic,
        spawner: Optional[Callable[[int], None]] = None,
        spare_ranks: Optional[List[int]] = None,
        preempt_drain_min_s: float = 0.5,
    ):
        self.rank = rank
        self.transport = transport
        self.sranks = list(server_ranks)
        self.cranks = list(client_ranks)
        self.smap = smap
        self.policy = policy or RebalancePolicy()
        self.sched = scheduler or Scheduler()
        self.live = LiveFlag()
        self.log = get_logger("shardctl", rank)
        self._deadline_s = float(op_deadline_s)
        self._clock = clock
        self.leases = LeaseRegistry(self.sranks, ttl_s=lease_ttl_s,
                                    clock=clock)
        for srank in self.sranks:
            self.leases.arm(srank, 0, heartbeats=True)
        self._dead: Set[int] = set()
        self._stopped: Set[int] = set()
        #: servers whose beats have been seen at least once (join
        #: detection — independent of whether a lease TTL is armed).
        self._beat_seen: Set[int] = set()
        #: current-window loads: server -> shard -> ShardLoad
        self._window: Dict[int, Dict[int, ShardLoad]] = {}
        self._window_t0 = clock()
        self._last_move_t = -1e18
        # Elastic membership (§9): how to get a new server process
        # (in-process tests inject a thread-spawner; the launcher wires
        # the supervisor mailbox), which ranks are available for it,
        # who already left on purpose, and how much preemption grace is
        # worth a graceful drain rather than letting failover pay.
        self.spawner = spawner
        self.spares: List[int] = list(spare_ranks or [])
        self.retired: Set[int] = set()
        self.membership_epoch = 0
        self.preempt_drain_min_s = float(preempt_drain_min_s)
        self._preempted: Set[int] = set()
        self._pending_preempt: Deque[Tuple[int, int]] = deque()
        #: operator requests from the statusd /scale route (HTTP thread
        #: producers, pump() the only consumer).
        self._scale_requests: Deque[Dict[str, str]] = deque()
        #: the closed-loop autoscaler (shardctl/autoscale.py), attached
        #: via attach_autoscaler(); pump() drives it after operator
        #: requests — the manual route always has precedence.
        self.autoscaler = None
        self.metrics = registry_or_local()
        _m, _r = self.metrics, rank
        self._m_beats = _m.counter("mpit_shardctl_beats_seen_total", rank=_r)
        self._m_rebal = _m.counter("mpit_shardctl_rebalances_total", rank=_r)
        self._m_fail = _m.counter("mpit_shardctl_failovers_total", rank=_r)
        self._m_ver = _m.gauge("mpit_shardctl_map_version", rank=_r)
        self._m_gang_srv = _m.gauge("mpit_gang_size", role="server")
        self._m_gang_cli = _m.gauge("mpit_gang_size", role="client")
        self._m_up = _m.counter("mpit_elastic_events_total", kind="up")
        self._m_down = _m.counter("mpit_elastic_events_total", kind="down")
        self._m_pre = _m.counter("mpit_elastic_events_total", kind="preempt")
        self._update_gang_gauges()
        if obs_enabled():
            register_status_provider("controller", self._status_section)
            register_status_action("scale", self._scale_action)

    # -- membership / introspection ------------------------------------------

    def _live_servers(self) -> List[int]:
        """Ranks still serving: not failed over, not retired."""
        return [s for s in self.sranks
                if s not in self._dead and s not in self.retired]

    def _update_gang_gauges(self) -> None:
        self._m_gang_srv.set(len(self._live_servers()))
        self._m_gang_cli.set(len(self.cranks) - len(self._stopped))

    def attach_autoscaler(self, autoscaler) -> None:
        """Bind an :class:`~mpit_tpu_torch.shardctl.autoscale.Autoscaler`:
        pump() drives its cadence, /status grows its section, and
        operator /scale requests suppress it (precedence, §9.5)."""
        self.autoscaler = autoscaler

    def _status_section(self) -> Dict[str, object]:
        """The controller's /status section (statusd thread: plain
        attribute reads only)."""
        if self.autoscaler is not None:
            return {**self._status_base(),
                    "autoscale": self.autoscaler.status_section()}
        return self._status_base()

    def _status_base(self) -> Dict[str, object]:
        return {
            "role": "controller",
            "rank": self.rank,
            "membership_epoch": self.membership_epoch,
            "servers": self._live_servers(),
            "retired": sorted(self.retired),
            "dead": sorted(self._dead),
            "spares": list(self.spares),
            "clients": self.cranks,
            "stopped": sorted(self._stopped),
            "map_version": getattr(self.smap, "version", None),
            "elastic_events": {
                "up": int(self._m_up.value),
                "down": int(self._m_down.value),
                "preempt": int(self._m_pre.value),
            },
        }

    def _scale_action(self, params: Dict[str, str]) -> dict:
        """The statusd ``/scale`` route (operator-driven elasticity).
        Runs on the HTTP thread: validate, enqueue, ack — pump()
        executes.  ``?op=up`` widens by one spare; ``?op=down&rank=K``
        drains and retires K."""
        op = params.get("op", "")
        if op not in ("up", "down"):
            return {"error": "op must be 'up' or 'down'"}
        if op == "down" and "rank" not in params:
            return {"error": "op=down needs rank=<server>"}
        if self.autoscaler is not None:
            # Operator precedence: the loop stands down while a human
            # is driving (plain attribute writes — HTTP thread safe).
            self.autoscaler.note_operator()
        self._scale_requests.append(dict(params))
        return {"queued": dict(params),
                "membership_epoch": self.membership_epoch}

    # -- plumbing ------------------------------------------------------------

    def _run(self, gen, name: str):
        task = self.sched.spawn(gen, name=name)
        return self.sched.wait_for(task)

    def _send(self, payload, dst: int, tag: int, name: str) -> None:
        self._run(
            aio_send(self.transport, payload, dst, tag, live=self.live,
                     deadline=deadline_at(self._deadline_s)),
            name=name,
        )

    def _install(self, smap: ShardMap) -> None:
        if self.smap is None or smap.version > self.smap.version:
            self.smap = smap
            self._m_ver.set(smap.version)

    def _broadcast(self, exclude: Set[int] = frozenset(),
                   kind: int = INSTALL, peer: int = -1) -> None:
        """Push the committed map to every client and live server.
        ``kind``/``peer`` let retirement announce itself (RETIRED) on
        the same fan-out."""
        frame = map_update(kind, -1, peer, self.smap)
        for dst in self.cranks + self._live_servers():
            if dst not in exclude:
                self._send(frame, dst, tags.MAP_UPDATE, f"bcast:{dst}")

    def _gang_stopped(self) -> bool:
        """Every client has sent its STOP (drained here, mid-handshake as
        well): the servers exit with the gang and echo nothing more."""
        self._drain_control()
        return self.done

    def _await_done(self, peer: int, shard_id: int) -> bool:
        """Consume MAP_UPDATE messages from ``peer`` until the DONE echo
        for ``shard_id`` arrives (deadline-bounded, fail loud); True once
        it has.  A handshake still open when every client has stopped is
        abandoned (False) rather than waited out to the deadline: the
        servers left with the gang.  A PREEMPT notice crossing the echo is
        stashed for the next pump, never dropped."""
        def _wait():
            while True:
                payload = yield from aio_recv(
                    self.transport, peer, tags.MAP_UPDATE, live=self.live,
                    deadline=deadline_at(self._deadline_s),
                    abort=self._gang_stopped,
                )
                if payload is None:
                    return False
                kind, sid, rank, smap = parse_map_update(payload)
                if kind == DONE and sid == shard_id:
                    if smap is not None:
                        self._install(smap)
                    return True
                if kind == PREEMPT:
                    self._pending_preempt.append((rank, sid))

        return self._run(_wait(), name=f"await_done:{peer}:{shard_id}")

    # -- migration / failover (synchronous, deadline-bounded) ---------------

    def migrate(self, shard_id: int, dst: int) -> bool:
        """Live-migrate ``shard_id`` to server ``dst``: RELEASE to the
        current owner, ACQUIRE to ``dst``, await the DONE echo, then
        broadcast the committed map.  Returns False for no-ops (already
        there, unknown shard, dead or retired destination) and for a
        handshake the gang's end cut short."""
        if self.smap is None or dst in self._dead or dst in self.retired:
            return False
        try:
            src = self.smap.owner(shard_id)
        except KeyError:
            return False
        if src == dst:
            return False
        new_map = self.smap.moved(shard_id, dst)
        self.log.info("migrating shard %d: server %d -> %d (map v%d)",
                      shard_id, src, dst, new_map.version)
        self._send(map_update(RELEASE, shard_id, dst, new_map), src,
                   tags.MAP_UPDATE, f"release:{src}")
        self._send(map_update(ACQUIRE, shard_id, src, new_map), dst,
                   tags.MAP_UPDATE, f"acquire:{dst}")
        if not self._await_done(dst, shard_id):
            self.log.info("the gang stopped during the migration of shard %d: "
                          "abandoned at map v%d", shard_id, self.smap.version)
            return False
        self._install(new_map)
        self._m_rebal.inc()
        self._last_move_t = self._clock()
        self._broadcast(exclude={src, dst})
        return True

    def failover(self, dead_rank: int) -> bool:
        """Reassign every shard owned by ``dead_rank`` to survivors,
        each ADOPTing from its latest shard checkpoint.  A *retired*
        rank never fails over: its shards were drained before the
        goodbye and its silence is the expected shape (§9.2)."""
        if self.smap is None or dead_rank in self._dead \
                or dead_rank in self.retired:
            return False
        self._dead.add(dead_rank)
        self._update_gang_gauges()
        survivors = self._live_servers()
        moved = [e.shard_id for e in self.smap.shards_of(dead_rank)]
        if not survivors or not moved:
            return False
        new_map = self.smap.reassigned(dead_rank, survivors)
        self.log.warning(
            "server %d lease expired: failing over shard(s) %s to %s "
            "(map v%d)", dead_rank, moved,
            {s: new_map.owner(s) for s in moved}, new_map.version)
        for sid in moved:
            owner = new_map.owner(sid)
            self._send(map_update(ADOPT, sid, dead_rank, new_map), owner,
                       tags.MAP_UPDATE, f"adopt:{owner}")
        for sid in moved:
            self._await_done(new_map.owner(sid), sid)
        self._install(new_map)
        self._m_fail.inc()
        self._last_move_t = self._clock()
        self._broadcast()
        return True

    # -- elastic membership: scale-up / scale-down / preemption (§9) ---------

    def scale_up(self, rank: Optional[int] = None,
                 wait_s: float = 30.0) -> int:
        """Widen the gang by one server: spawn it (``spawner``), wait
        for its first HEARTBEAT to arm the lease, then rebalance shards
        onto the widened set through ordinary live migrations.  Returns
        the new rank.  Fails loudly if no spare rank is available or
        the spawn never beats — a scale-up that silently did nothing
        would fake capacity."""
        if rank is None:
            if not self.spares:
                raise RuntimeError(
                    "scale_up: no spare ranks left (provision more with "
                    "elastic spares; membership has a rank-space ceiling)")
            rank = self.spares.pop(0)
        elif rank in self.spares:
            self.spares.remove(rank)
        if rank in self._live_servers():
            raise ValueError(f"scale_up: rank {rank} is already serving")
        self.log.info("scale-up: spawning server rank %d", rank)
        if self.spawner is not None:
            self.spawner(rank)
        self._dead.discard(rank)
        self.retired.discard(rank)
        self._beat_seen.discard(rank)
        if rank not in self.sranks:
            self.sranks.append(rank)
        self.leases.admit(rank)
        self.leases.arm(rank, 0, heartbeats=True)
        # The join is observable only through the new rank's beats —
        # wait (wall-bounded) for the first one before moving state
        # onto it (when a lease TTL is configured the same beat also
        # arms the lease).
        t0 = time.monotonic()
        while rank not in self._beat_seen:
            self._drain_beats()
            self._drain_control()
            if self.done:
                # The gang finished while the spawn was coming up — the
                # servers are exiting, so there is nothing to widen.
                raise RuntimeError(
                    "scale_up aborted: every client stopped while waiting "
                    f"for rank {rank} to join")
            if time.monotonic() - t0 > wait_s:
                raise TimeoutError(
                    f"scale_up: rank {rank} never heartbeated within "
                    f"{wait_s:.0f}s — spawn failed or the rank wedged")
            time.sleep(0.005)
        # Rebalance: move shards from the widest survivors until the
        # newcomer holds its fair share — and always at least one (a
        # serving member that owns nothing would never appear in the
        # clients' owner set, so it would miss their STOPs at gang end).
        if self.smap is not None:
            target = max(1, len(self.smap.entries) // len(self._live_servers()))
            while len(self.smap.shards_of(rank)) < target:
                donors = sorted(
                    ((len(self.smap.shards_of(s)), s)
                     for s in self._live_servers() if s != rank),
                    reverse=True)
                top_n, top_s = donors[0]
                mine = len(self.smap.shards_of(rank))
                if top_n == 0 or (mine >= 1 and top_n - 1 < mine + 1):
                    break  # nothing movable / further moves just seesaw
                sid = self.smap.shards_of(top_s)[0].shard_id
                if not self.migrate(sid, rank):
                    break
        self.membership_epoch += 1
        self._m_up.inc()
        self._update_gang_gauges()
        self.log.info("scale-up complete: rank %d serving %s (epoch %d)",
                      rank, [e.shard_id for e in
                             (self.smap.shards_of(rank) if self.smap else [])],
                      self.membership_epoch)
        return rank

    def scale_down(self, rank: int) -> bool:
        """Drain ``rank`` (migrate every shard it owns to survivors)
        and complete the RETIRE handshake so it exits as a goodbye.
        Clients learn through the RETIRED broadcast (and, as always,
        through NACK re-routing) — no gang restart."""
        if rank in self.retired or rank in self._dead:
            return False
        if self.smap is None:
            raise RuntimeError(
                "scale_down before the controller learned a map — there "
                "is no drained state to hand a RETIRE receipt for")
        survivors = [s for s in self._live_servers() if s != rank]
        if not survivors:
            raise RuntimeError(
                f"scale_down: rank {rank} is the last live server — "
                "refusing to drain the gang to zero")
        if self.smap is not None:
            for entry in list(self.smap.shards_of(rank)):
                counts = {s: len(self.smap.shards_of(s)) for s in survivors}
                dst = min(counts, key=lambda s: (counts[s], s))
                if not self.migrate(entry.shard_id, dst):
                    if self.done:
                        return False  # the gang stopped mid-drain
                    raise RuntimeError(
                        f"scale_down: draining shard {entry.shard_id} off "
                        f"rank {rank} failed")
        # RETIRE handshake: the rank confirms it holds nothing and
        # exits cleanly; DONE (shard -1) is the goodbye receipt.
        self._send(map_update(RETIRE, -1, rank, self.smap), rank,
                   tags.MAP_UPDATE, f"retire:{rank}")
        self._await_done(rank, -1)
        self.retired.add(rank)
        self.leases.retire(rank)
        # A retired rank's stale load window must not make it look like
        # the coldest migration target next rebalance pass.
        self._window.pop(rank, None)
        self.membership_epoch += 1
        self._m_down.inc()
        self._update_gang_gauges()
        self._broadcast(kind=RETIRED, peer=rank)
        self.log.info("scale-down complete: rank %d retired (epoch %d)",
                      rank, self.membership_epoch)
        return True

    def _on_preempt(self, rank: int, grace_ms: int) -> None:
        """A server reported a preemption notice.  Grace permitting,
        drain it gracefully (checkpoint already written server-side);
        otherwise leave it to die — lease expiry fails its shards over
        from checkpoint, the replay-at-worst path."""
        if rank in self._preempted or rank in self.retired \
                or rank in self._dead:
            return
        self._preempted.add(rank)
        self._m_pre.inc()
        survivors = [s for s in self._live_servers() if s != rank]
        if grace_ms / 1000.0 >= self.preempt_drain_min_s and survivors:
            self.log.warning(
                "server %d preempted with %.1fs grace: draining gracefully",
                rank, grace_ms / 1000.0)
            self.scale_down(rank)
        else:
            self.log.warning(
                "server %d preempted with %.1fs grace: too little to drain "
                "— failover from its checkpoint-on-notice will cover it",
                rank, grace_ms / 1000.0)

    def _drain_server_directives(self) -> None:
        """Server-origin MAP_UPDATE traffic outside a handshake: today
        that is PREEMPT notices (DONE echoes are consumed inside their
        handshakes; anything carrying a newer map installs it)."""
        for srank in self._live_servers():
            while self.transport.iprobe(srank, tags.MAP_UPDATE):
                handle = self.transport.irecv(srank, tags.MAP_UPDATE)
                while not self.transport.test(handle):
                    pass
                kind, sid, rank, smap = parse_map_update(
                    bytes(self.transport.payload(handle)))
                if kind == PREEMPT:
                    self._pending_preempt.append((rank, sid))
                else:
                    self._install(smap)

    def _drain_scale_requests(self) -> None:
        """Execute queued /scale operator requests (§9.5).  An operator
        verb must never take the control plane down: any failure — a
        spawn that never beats, a drain step racing gang shutdown
        (DeadlineExceeded inside the migration), a bad rank — is logged
        and dropped, and the controller keeps serving."""
        while self._scale_requests:
            req = self._scale_requests.popleft()
            if self.done:
                self.log.warning("operator /scale request %r ignored: "
                                 "the gang is stopping", req)
                continue
            try:
                if req.get("op") == "up":
                    self.scale_up(int(req["rank"]) if "rank" in req
                                  else None)
                else:
                    self.scale_down(int(req["rank"]))
            except Exception as exc:  # noqa: BLE001 — operator verbs are
                #                        best-effort; see docstring
                self.log.error("operator /scale request %r failed: %s",
                               req, exc)

    # -- the periodic scan ---------------------------------------------------

    def _drain_beats(self) -> None:
        for srank in self._live_servers():
            while self.transport.iprobe(srank, tags.HEARTBEAT):
                handle = self.transport.irecv(srank, tags.HEARTBEAT)
                while not self.transport.test(handle):
                    pass  # message fully assembled (iprobe contract)
                words = np.frombuffer(bytes(self.transport.payload(handle)),
                                      np.int64)
                self._m_beats.inc()
                self._beat_seen.add(srank)
                self.leases.renew(srank, int(words[0]))
                shards = self._window.setdefault(srank, {})
                nslots = int(words[2]) if words.size >= 3 else 0
                for i in range(nslots):
                    sid, ops, busy_us = (int(x)
                                         for x in words[3 + 3 * i: 6 + 3 * i])
                    load = shards.setdefault(sid, ShardLoad())
                    load.ops += ops
                    load.busy_s += busy_us / 1e6


    def _drain_control(self) -> None:
        """Client-origin traffic: initial map installs and STOPs."""
        for crank in self.cranks:
            while self.transport.iprobe(crank, tags.MAP_UPDATE):
                handle = self.transport.irecv(crank, tags.MAP_UPDATE)
                while not self.transport.test(handle):
                    pass
                _k, _s, _p, smap = parse_map_update(
                    bytes(self.transport.payload(handle)))
                self._install(smap)
            if crank not in self._stopped and \
                    self.transport.iprobe(crank, tags.STOP):
                handle = self.transport.irecv(crank, tags.STOP)
                while not self.transport.test(handle):
                    pass
                self._stopped.add(crank)

    def check_leases(self) -> None:
        for srank in self.leases.expired():
            self.leases.evict(srank)
            self.failover(srank)

    def maybe_rebalance(self) -> bool:
        """Close the current load window and act on the policy (none
        once every client has stopped: the servers are leaving)."""
        if self.done:
            return False
        now = self._clock()
        if now - self._window_t0 < self.policy.cooldown_s:
            return False
        if now - self._last_move_t < self.policy.cooldown_s:
            self._window.clear()
            self._window_t0 = now
            return False
        proposal = (self.policy.propose(self.smap, self._window)
                    if self.smap is not None else None)
        self._window = {}
        self._window_t0 = now
        if proposal is None:
            return False
        shard_id, dst = proposal
        return self.migrate(shard_id, dst)

    def pump(self) -> None:
        """One bounded control scan (no sleeps): beats, client traffic,
        server directives (preemption notices), lease expiry, queued
        operator scale requests, at most one rebalance."""
        self._drain_beats()
        self._drain_control()
        self._drain_server_directives()
        while self._pending_preempt:
            rank, grace_ms = self._pending_preempt.popleft()
            self._on_preempt(rank, grace_ms)
        self.check_leases()
        self._drain_scale_requests()
        if self.autoscaler is not None and not self.done:
            self.autoscaler.pump()
        self.maybe_rebalance()
        self._update_gang_gauges()

    @property
    def done(self) -> bool:
        """Every client stopped — the controller's exit condition."""
        return len(self._stopped) == len(self.cranks)

    def serve(self, poll_s: float = 0.01, timeout: Optional[float] = None) -> None:
        """Run the control loop until every client STOPs (the gang-child
        entry).  ``timeout`` bounds the loop for harness use."""
        t_end = None if timeout is None else self._clock() + timeout
        while self.live.on and not self.done:
            self.pump()
            if t_end is not None and self._clock() > t_end:
                raise TimeoutError(
                    f"shard controller timed out; stopped={sorted(self._stopped)}"
                    f" of clients={self.cranks}")
            time.sleep(poll_s)
        self.log.info("controller done: map v%s, %d rebalances, %d failovers",
                      getattr(self.smap, "version", None),
                      int(self._m_rebal.value), int(self._m_fail.value))

    def stop(self) -> None:
        self.live.stop()
