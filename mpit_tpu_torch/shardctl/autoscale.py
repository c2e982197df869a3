"""SLO-driven autoscaling — the loop that makes the gang operate itself.

A copy of ``mpit_tpu/shardctl/autoscale.py``, reading the port's ``obs/top.py``: the port imports
nothing of the JAX package.

PRs 6-9 built every mechanism a self-operating gang needs: gang-wide
telemetry (obs/top.py pools every rank's ``/metrics``), scale verbs with
an operator ``/scale`` route (controller.py §9), preemption with
checkpoint-on-notice, and replayable fault plans.  Nothing closed the
loop — a human watched ``mpit top`` and called ``/scale`` by hand.  This
module is the closing piece, in three layers that mirror
:class:`~mpit_tpu_torch.shardctl.policy.RebalancePolicy`'s shape:

- **signals** (:class:`TelemetryWindow`, the samplers) — one windowed
  reading of the gang: p99 op latency from the pooled
  ``mpit_ps_op_seconds`` log2 buckets (**bucket-count deltas** between
  consecutive samples, so the quantile describes the window, not the
  run's whole history), BUSY-reply ratio, mean grad staleness, and
  send-queue depth.  Both samplers go through the obs/top read path
  (:func:`~mpit_tpu_torch.obs.top.parse_exposition` + the quantile helpers),
  so what the operator sees in ``mpit top`` and what the control plane
  acts on cannot drift apart.  :class:`RegistrySampler` reads the
  process-local registry (in-process gangs, the soak harness);
  :class:`HttpSampler` polls every rank's statusd endpoint (launched
  gangs, ``--autoscale``).
- **policy** (:class:`AutoscalePolicy`) — a pure, replayable decision
  function over the window stream: SLO targets with a hysteresis band
  (breach above ``high_frac x target``, idle below ``low_frac x
  target``, in-band resets both streaks), consecutive-window debounce,
  a post-action cooldown, a flap-suppression budget (direction
  reversals per sliding budget window), and operator precedence (a
  ``/scale`` request suppresses automatic verbs for
  ``override_hold_s`` — the human always wins).  Every call returns a
  :class:`Decision`, including the no-ops, with the reason and the
  window that justified it.
- **actuation** (:class:`Autoscaler`) — samples on a cadence from the
  controller's pump, executes ``scale_up``/``scale_down`` on breach /
  idle verdicts, and records **every** decision as an auditable event:
  an ``audit`` ring the soak harness dumps as the decision log, the
  ``mpit_autoscale_*`` instruments, a flight-recorder event per
  decision, and a full flight *dump* on every executed scale action and
  on an SLO breach that persists past the settle window — a mis-scaled
  gang produces a postmortem naming the signal that drove it
  (docs/OPERATIONS.md, "reading an autoscale flight dump").

Determinism for tests: the policy never reads a clock — time arrives on
the samples — so replaying a synthetic window sequence reproduces the
decision sequence exactly (tests/test_autoscale.py).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from mpit_tpu_torch.obs import top as _top
from mpit_tpu_torch.utils.logging import get_logger

#: decision actions
UP, DOWN, HOLD = "up", "down", "hold"


# ---------------------------------------------------------------------------
# configuration


@dataclass(frozen=True)
class SLOConfig:
    """Service-level objectives; 0 disables a signal.  Targets are the
    SLO itself — the hysteresis band around them lives in
    :class:`AutoscaleConfig` (``high_frac``/``low_frac``)."""

    #: p99 op latency target (ms) over the pooled mpit_ps_op_seconds
    #: window — the headline serving SLO.
    p99_ms: float = 0.0
    #: max acceptable BUSY-reply ratio (admission rejections / ops).
    busy_ratio: float = 0.0
    #: max acceptable mean grad staleness (committed versions behind).
    staleness: float = 0.0
    #: max acceptable summed send-queue depth (frames queued to peers).
    send_queue: float = 0.0

    def targets(self) -> List[Tuple[str, float]]:
        """The configured (signal, target) pairs, stable order."""
        out = []
        for name in ("p99_ms", "busy_ratio", "staleness", "send_queue"):
            target = getattr(self, name)
            if target and target > 0:
                out.append((name, float(target)))
        return out


@dataclass(frozen=True)
class AutoscaleConfig:
    slo: SLOConfig = field(default_factory=SLOConfig)
    #: sampling cadence — the autoscaler takes one window per window_s.
    window_s: float = 1.0
    #: hysteresis band: breach above high_frac x target, idle only when
    #: every configured signal sits below low_frac x target; in between
    #: neither streak advances (they reset — the band absorbs noise).
    high_frac: float = 1.0
    low_frac: float = 0.5
    #: consecutive breaching / idle windows before a verb fires.
    breach_windows: int = 2
    idle_windows: int = 4
    #: minimum seconds between scale actions (measure, don't predict —
    #: same rationale as RebalancePolicy.cooldown_s).
    cooldown_s: float = 10.0
    #: grace after a scale action (and after a traffic-shape change, in
    #: the harness's duty accounting) before a persisting breach is
    #: postmortem-worthy — the flight dump trigger, not a verb gate.
    settle_s: float = 5.0
    #: flap suppression: at most this many scale-direction reversals
    #: per flap_window_s; proposals beyond it are suppressed (audited
    #: as reason="flap") until the window drains.
    flap_budget: int = 3
    flap_window_s: float = 120.0
    #: operator precedence: a /scale request suppresses automatic verbs
    #: for this long (the manual override always wins, §9.5).
    override_hold_s: float = 30.0
    #: membership bounds the policy may steer within.
    min_servers: int = 1
    max_servers: int = 16
    #: master switch (the bench's static leg).
    enabled: bool = True


@dataclass(frozen=True)
class TelemetryWindow:
    """One windowed gang reading (the policy's only input)."""

    t: float
    p99_ms: Optional[float] = None
    busy_ratio: float = 0.0
    staleness: float = 0.0
    send_queue: float = 0.0
    #: ops completed in the window (rate context for the audit trail).
    ops: float = 0.0
    gang_size: int = 0

    def value(self, signal: str) -> Optional[float]:
        return getattr(self, signal)

    def to_dict(self) -> Dict[str, object]:
        return {
            "t": round(self.t, 4),
            "p99_ms": (round(self.p99_ms, 3)
                       if self.p99_ms is not None else None),
            "busy_ratio": round(self.busy_ratio, 4),
            "staleness": round(self.staleness, 3),
            "send_queue": round(self.send_queue, 1),
            "ops": round(self.ops, 1),
            "gang_size": self.gang_size,
        }


@dataclass(frozen=True)
class Decision:
    """One policy verdict — every pump records one, no-ops included."""

    t: float
    action: str  # up | down | hold
    reason: str
    breaches: Tuple[str, ...] = ()
    window: Optional[TelemetryWindow] = None
    cooldown_s: float = 0.0

    def to_dict(self) -> Dict[str, object]:
        return {
            "t": round(self.t, 4),
            "action": self.action,
            "reason": self.reason,
            "breaches": list(self.breaches),
            "cooldown_s": round(self.cooldown_s, 3),
            "window": self.window.to_dict() if self.window else None,
        }


# ---------------------------------------------------------------------------
# the pure policy


class AutoscalePolicy:
    """Pure decision logic over a window stream — no I/O, no clock.

    State (streak counters, cooldown anchor, flap history, override
    stamp) advances only through :meth:`decide` and
    :meth:`note_override`, both parameterized on the *sample's* time, so
    a replayed window sequence reproduces the decision sequence bit for
    bit (tests/test_autoscale.py pins exact sequences).
    """

    def __init__(self, cfg: AutoscaleConfig):
        self.cfg = cfg
        self._breach_streak = 0
        self._idle_streak = 0
        self._last_action_t = -1e18
        self._last_action: Optional[str] = None
        self._last_override_t = -1e18
        #: (t, direction) of executed actions inside the flap window.
        self._actions: Deque[Tuple[float, str]] = deque()
        #: breach-episode anchor for the settle-window postmortem rule.
        self.breach_since: Optional[float] = None

    # -- inputs --------------------------------------------------------------

    def note_override(self, t: float) -> None:
        """An operator /scale request landed: automatic verbs stand
        down for override_hold_s (and the streaks reset — whatever the
        operator saw, they acted on it)."""
        self._last_override_t = t
        self._breach_streak = 0
        self._idle_streak = 0

    def note_executed(self, decision: Decision) -> None:
        """Confirm a proposed verb actually ran (the actuator may fail,
        e.g. no spare rank) — cooldown and flap accounting key on
        *executed* actions only."""
        self._last_action_t = decision.t
        self._last_action = decision.action
        self._actions.append((decision.t, decision.action))

    # -- the verdict ---------------------------------------------------------

    def cooldown_remaining(self, t: float) -> float:
        return max(0.0, self.cfg.cooldown_s - (t - self._last_action_t))

    def _flap_exhausted(self, t: float, action: str) -> bool:
        """Would executing ``action`` at ``t`` spend a reversal beyond
        the budget?  A reversal is an action whose direction differs
        from the previous executed action's."""
        while self._actions and t - self._actions[0][0] > self.cfg.flap_window_s:
            self._actions.popleft()
        if self._last_action is None or action == self._last_action:
            return False
        reversals = sum(
            1 for i in range(1, len(self._actions))
            if self._actions[i][1] != self._actions[i - 1][1])
        if self._actions and action != self._actions[-1][1]:
            reversals += 1
        return reversals > self.cfg.flap_budget

    def decide(self, window: Optional[TelemetryWindow],
               gang_size: int) -> Decision:
        cfg = self.cfg
        if not cfg.enabled:
            return Decision(t=window.t if window else 0.0, action=HOLD,
                            reason="disabled", window=window)
        if window is None:
            return Decision(t=0.0, action=HOLD, reason="no_data")
        t = window.t
        targets = cfg.slo.targets()
        breaches = tuple(
            name for name, target in targets
            if (v := window.value(name)) is not None
            and v > cfg.high_frac * target)
        idle = bool(targets) and all(
            (window.value(name) is None
             or window.value(name) <= cfg.low_frac * target)
            for name, target in targets)
        # Breach-episode tracking (for the settle-window flight dump)
        # runs regardless of cooldown/override — a breach the policy
        # cannot act on is exactly the one worth a postmortem.
        if breaches:
            if self.breach_since is None:
                self.breach_since = t
        else:
            self.breach_since = None
        if t - self._last_override_t < cfg.override_hold_s:
            return Decision(t=t, action=HOLD, reason="override",
                            breaches=breaches, window=window,
                            cooldown_s=self.cooldown_remaining(t))
        cooldown = self.cooldown_remaining(t)
        if cooldown > 0:
            # The gang is still absorbing the last action: don't let
            # pre-action windows accumulate into the next verdict.
            self._breach_streak = 0
            self._idle_streak = 0
            return Decision(t=t, action=HOLD, reason="cooldown",
                            breaches=breaches, window=window,
                            cooldown_s=cooldown)
        if breaches:
            self._breach_streak += 1
            self._idle_streak = 0
        elif idle:
            self._idle_streak += 1
            self._breach_streak = 0
        else:
            self._breach_streak = 0
            self._idle_streak = 0
            return Decision(t=t, action=HOLD, reason="in_band",
                            window=window)
        if self._breach_streak >= cfg.breach_windows:
            if gang_size >= cfg.max_servers:
                return Decision(t=t, action=HOLD, reason="at_max",
                                breaches=breaches, window=window)
            if self._flap_exhausted(t, UP):
                return Decision(t=t, action=HOLD, reason="flap",
                                breaches=breaches, window=window)
            self._breach_streak = 0
            return Decision(t=t, action=UP,
                            reason="slo:" + "+".join(breaches),
                            breaches=breaches, window=window)
        if self._idle_streak >= cfg.idle_windows:
            if gang_size <= cfg.min_servers:
                return Decision(t=t, action=HOLD, reason="at_min",
                                window=window)
            if self._flap_exhausted(t, DOWN):
                return Decision(t=t, action=HOLD, reason="flap",
                                window=window)
            self._idle_streak = 0
            return Decision(t=t, action=DOWN, reason="idle",
                            window=window)
        return Decision(
            t=t, action=HOLD,
            reason="breach_pending" if breaches else "idle_pending",
            breaches=breaches, window=window)


# ---------------------------------------------------------------------------
# samplers — both ride the obs/top read path


def window_from_samples(t: float, cur: list, prev: Optional[list],
                        gang_size: int = 0) -> TelemetryWindow:
    """Fold one pooled ``parse_exposition`` sample list (optionally
    against the previous one, for counter/bucket deltas) into a
    :class:`TelemetryWindow`.  With no previous sample the cumulative
    totals stand in — the first window of a run describes the run so
    far, which is the right cold-start answer."""
    def _delta(name: str, **match) -> float:
        cur_v = _top.metric_sum(cur, name, **match)
        if prev is None:
            return cur_v
        return max(0.0, cur_v - _top.metric_sum(prev, name, **match))

    if prev is not None:
        p99_s = _top.hist_quantile_between(prev, cur,
                                           "mpit_ps_op_seconds", 0.99)
    else:
        p99_s = _top.hist_quantile(cur, "mpit_ps_op_seconds", 0.99)
    ops = (_delta("mpit_ps_grads_applied_total")
           + _delta("mpit_ps_params_served_total"))
    busy = (_delta("mpit_ps_busy_replies_total")
            + _delta("mpit_shardctl_busy_replies_total"))
    stale_n = _delta("mpit_ps_grad_staleness_count")
    stale_sum = _delta("mpit_ps_grad_staleness_sum")
    return TelemetryWindow(
        t=t,
        p99_ms=(p99_s * 1000.0 if p99_s is not None else None),
        busy_ratio=(busy / (busy + ops) if (busy + ops) > 0 else 0.0),
        staleness=(stale_sum / stale_n if stale_n > 0 else 0.0),
        send_queue=_top.metric_sum(cur, "mpit_tcp_send_queue_depth"),
        ops=ops,
        gang_size=gang_size,
    )


class RegistrySampler:
    """Windows from this process's own obs registry (in-process gangs:
    every role shares the registry, so the pooled exposition *is* the
    gang view).  Obs must be enabled before the roles are built."""

    def __init__(self):
        self._prev: Optional[list] = None

    def __call__(self, t: float, gang_size: int = 0) -> TelemetryWindow:
        from mpit_tpu_torch.obs import get_registry

        cur = _top.parse_exposition(get_registry().exposition())
        window = window_from_samples(t, cur, self._prev, gang_size)
        self._prev = cur
        return window


class HttpSampler:
    """Windows pooled over every rank's statusd ``/metrics`` endpoint
    (launched gangs: one process per rank, so the controller must poll
    — exactly what ``mpit top`` does, through the same collect path).
    Unreachable ranks contribute nothing to the pool (a rank that is
    down is the lease reaper's problem, not the sampler's)."""

    def __init__(self, base_port: int, nranks: int,
                 host: str = "127.0.0.1", timeout: float = 1.0):
        self.base_port = int(base_port)
        self.nranks = int(nranks)
        self.host = host
        self.timeout = float(timeout)
        self._prev: Optional[list] = None

    def __call__(self, t: float, gang_size: int = 0) -> TelemetryWindow:
        pooled: list = []
        for sample in _top.collect(self.host, self.base_port, self.nranks,
                                   timeout=self.timeout).values():
            if sample is not None:
                pooled.extend(sample["metrics"])
        window = window_from_samples(t, pooled, self._prev, gang_size)
        self._prev = pooled
        return window


# ---------------------------------------------------------------------------
# the actuator


class Autoscaler:
    """Binds a policy to a live :class:`ShardController`.

    ``pump()`` runs from the controller's own pump (single consumer, no
    extra thread): every ``window_s`` it samples, asks the policy, and
    executes the verdict through the controller's existing scale verbs
    — the same code path the operator route uses, so autoscale
    decisions ride the §9 protocol unchanged.  Every decision lands in
    the ``audit`` ring, the ``mpit_autoscale_*`` instruments, and the
    flight recorder; executed actions and settle-exceeding breaches
    additionally write a full flight dump with the triggering window.
    """

    def __init__(self, controller, cfg: AutoscaleConfig,
                 sampler: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None,
                 audit_len: int = 1024):
        from mpit_tpu_torch.obs import registry_or_local

        self.ctl = controller
        self.cfg = cfg
        self.policy = AutoscalePolicy(cfg)
        self.sampler = sampler or RegistrySampler()
        self._clock = clock or controller._clock
        self.log = get_logger("autoscale", controller.rank)
        self.audit: Deque[Dict[str, object]] = deque(maxlen=audit_len)
        self.operator_calls = 0
        self._last_sample_t = -1e18
        self._breach_dumped = False
        self.last_decision: Optional[Decision] = None
        _m = registry_or_local()
        self._m_up = _m.counter("mpit_autoscale_decisions_total", action=UP)
        self._m_down = _m.counter("mpit_autoscale_decisions_total",
                                  action=DOWN)
        self._m_hold = _m.counter("mpit_autoscale_decisions_total",
                                  action=HOLD)
        self._m_breach = _m.counter("mpit_autoscale_breach_windows_total")
        self._m_suppressed = _m.counter("mpit_autoscale_suppressed_total")
        self._m_cooldown = _m.gauge("mpit_autoscale_cooldown_seconds")

    # -- counters the harnesses assert on ------------------------------------

    @property
    def ups(self) -> int:
        return int(self._m_up.value)

    @property
    def downs(self) -> int:
        return int(self._m_down.value)

    def note_operator(self) -> None:
        """Called (HTTP thread — plain attribute writes only) when an
        operator /scale request is queued: manual verbs take
        precedence over the loop for override_hold_s."""
        self.operator_calls += 1
        self.policy.note_override(self._clock())

    def status_section(self) -> Dict[str, object]:
        """The controller /status ``autoscale`` sub-section (and `mpit
        top`'s gang status line)."""
        last = self.last_decision
        return {
            "enabled": self.cfg.enabled,
            "slo": {name: target for name, target in
                    self.cfg.slo.targets()},
            "last": last.to_dict() if last is not None else None,
            "cooldown_s": round(
                self.policy.cooldown_remaining(self._clock()), 3),
            "decisions": {"up": self.ups, "down": self.downs,
                          "hold": int(self._m_hold.value)},
            "suppressed": int(self._m_suppressed.value),
            "operator_calls": self.operator_calls,
        }

    # -- decision targets ----------------------------------------------------

    def _pick_down_rank(self) -> Optional[int]:
        """The drain victim for an idle verdict: the live server owning
        the fewest shards (cheapest drain), ties to the highest rank
        (joiners before launch members — give spares back first)."""
        live = self.ctl._live_servers()
        if len(live) <= self.cfg.min_servers or self.ctl.smap is None:
            return None
        return min(live,
                   key=lambda r: (len(self.ctl.smap.shards_of(r)), -r))

    # -- the pump ------------------------------------------------------------

    def pump(self) -> Optional[Decision]:
        """One cadenced sample+decide+act step; returns the Decision
        when a window was taken this call, else None.  Never raises —
        a broken sampler or a failed verb is audited and the control
        plane keeps serving (same contract as the operator route)."""
        now = self._clock()
        if now - self._last_sample_t < self.cfg.window_s:
            return None
        self._last_sample_t = now
        gang = len(self.ctl._live_servers())
        try:
            window = self.sampler(now, gang)
        except Exception as exc:  # noqa: BLE001 — telemetry must never
            #                       take the control plane down
            self.log.warning("autoscale sampler failed: %s", exc)
            window = None
        decision = self.policy.decide(window, gang)
        self.last_decision = decision
        self._m_cooldown.set(decision.cooldown_s)
        if decision.breaches:
            self._m_breach.inc()
        if decision.reason in ("flap", "override", "cooldown"):
            self._m_suppressed.inc()
        executed = False
        error = ""
        if decision.action == UP:
            try:
                new_rank = self.ctl.scale_up()
                executed = True
                self.log.info("autoscale up -> rank %d (%s)", new_rank,
                              decision.reason)
            except Exception as exc:  # noqa: BLE001 — no spare / spawn
                #                       failure: audited, not fatal
                error = repr(exc)
                self.log.error("autoscale up failed: %s", exc)
        elif decision.action == DOWN:
            victim = self._pick_down_rank()
            if victim is None:
                error = "no drainable server"
            else:
                try:
                    executed = bool(self.ctl.scale_down(victim))
                    if executed:
                        self.log.info("autoscale down: drained rank %d "
                                      "(%s)", victim, decision.reason)
                    else:
                        error = f"scale_down({victim}) refused"
                except Exception as exc:  # noqa: BLE001 — same contract
                    error = repr(exc)
                    self.log.error("autoscale down failed: %s", exc)
        if executed:
            self.policy.note_executed(decision)
            (self._m_up if decision.action == UP else self._m_down).inc()
        elif decision.action == HOLD:
            self._m_hold.inc()
        self._record(decision, executed, error)
        return decision

    # -- audit + flight ------------------------------------------------------

    def _record(self, decision: Decision, executed: bool,
                error: str) -> None:
        from mpit_tpu_torch.obs import get_flight

        rec = decision.to_dict()
        rec["executed"] = executed
        if error:
            rec["error"] = error
        self.audit.append(rec)
        flight = get_flight()
        flight.record("autoscale", action=decision.action,
                      reason=decision.reason, executed=executed)
        # Postmortem dumps: every executed verb, plus one per breach
        # episode that outlives the settle window without being fixed —
        # the dump carries the exact window that drove (or failed to
        # drive) the loop.
        if executed:
            flight.dump(f"autoscale_{decision.action}",
                        decision=rec,
                        window=(decision.window.to_dict()
                                if decision.window else None))
            self._breach_dumped = False
        since = self.policy.breach_since
        if since is None:
            self._breach_dumped = False
        elif (not self._breach_dumped
              and decision.t - since > self.cfg.settle_s):
            flight.dump("slo_breach", decision=rec,
                        window=(decision.window.to_dict()
                                if decision.window else None),
                        breach_for_s=round(decision.t - since, 3))
            self._breach_dumped = True

    def audit_log(self) -> List[Dict[str, object]]:
        """The decision audit trail, oldest first (the soak harness's
        artifact)."""
        return list(self.audit)
