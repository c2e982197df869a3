"""Closed-loop autoscaling of the port (``mpit_tpu_torch.shardctl.autoscale``
and ``mpit_tpu_torch.ft.traffic``), a twin of ``tests/test_autoscale.py``.

Every reference test runs against the port's modules: the policy's exact
decision sequences, the traffic generator's determinism and grammar, the
samplers' windowed arithmetic over the port's obs read path, ``top``'s SLO
columns, the autoscale flight dumps, and the closed loop over a real port
gang (servers, clients and controller on the CPU).  Across the packages:
a :class:`Scenario` with the same spec and seed expands to the same
schedule, byte for byte in its JSON form, and the port's policy replays
the JAX policy's decisions on the same seeded telemetry.
"""

import json
import threading

import numpy as np
import pytest

from mpit_tpu_torch import obs
from mpit_tpu_torch.ft.traffic import (
    GRAD,
    JOIN,
    PREEMPT,
    READ,
    STRAGGLE_OFF,
    STRAGGLE_ON,
    Scenario,
    TrafficPhase,
    iter_ticks,
)
from mpit_tpu_torch.obs import top as obs_top
from mpit_tpu_torch.shardctl.autoscale import (
    DOWN,
    HOLD,
    UP,
    AutoscaleConfig,
    AutoscalePolicy,
    Autoscaler,
    HttpSampler,
    RegistrySampler,
    SLOConfig,
    TelemetryWindow,
    window_from_samples,
)


import mpit_tpu.ft.traffic as jtraffic
import mpit_tpu.shardctl.autoscale as jautoscale


@pytest.fixture
def obs_on():
    obs.configure(enabled=True, reset=True)
    try:
        yield
    finally:
        obs.configure(enabled=None, reset=True)


def cfg(**kw):
    base = dict(
        slo=SLOConfig(p99_ms=10.0),
        window_s=1.0, high_frac=1.0, low_frac=0.5,
        breach_windows=2, idle_windows=3,
        cooldown_s=5.0, settle_s=2.0,
        flap_budget=2, flap_window_s=100.0,
        override_hold_s=10.0, min_servers=1, max_servers=4,
    )
    base.update(kw)
    return AutoscaleConfig(**base)


def w(t, p99=None, busy=0.0, stale=0.0, sendq=0.0, gang=2):
    return TelemetryWindow(t=float(t), p99_ms=p99, busy_ratio=busy,
                           staleness=stale, send_queue=sendq,
                           gang_size=gang)


def run_seq(policy, windows, gang=2):
    """Replay a window list; returns [(action, reason)] — the exact
    sequence the determinism contract pins."""
    out = []
    for window in windows:
        d = policy.decide(window, gang)
        if d.action in (UP, DOWN):
            policy.note_executed(d)  # tests model a successful verb
        out.append((d.action, d.reason))
    return out


# ---------------------------------------------------------------------------
# the pure policy: exact decision sequences


class TestPolicyDecisions:
    def test_breach_debounce_then_up(self):
        p = AutoscalePolicy(cfg())
        seq = run_seq(p, [w(0, p99=20), w(1, p99=20), w(2, p99=20)])
        assert seq == [(HOLD, "breach_pending"), (UP, "slo:p99_ms"),
                       (HOLD, "cooldown")]

    def test_hysteresis_holds_inside_the_band(self):
        """Between low (5ms) and high (10ms) nothing ever fires, and
        the band resets both streaks — one breaching window followed by
        in-band windows never accumulates into an action."""
        p = AutoscalePolicy(cfg())
        seq = run_seq(p, [w(0, p99=20), w(1, p99=7), w(2, p99=20),
                          w(3, p99=7), w(4, p99=8), w(5, p99=9)])
        assert seq == [(HOLD, "breach_pending"), (HOLD, "in_band"),
                       (HOLD, "breach_pending"), (HOLD, "in_band"),
                       (HOLD, "in_band"), (HOLD, "in_band")]
        assert p._breach_streak == 0 and p._idle_streak == 0

    def test_idle_debounce_then_down(self):
        p = AutoscalePolicy(cfg())
        seq = run_seq(p, [w(t, p99=2) for t in range(4)])
        assert seq == [(HOLD, "idle_pending"), (HOLD, "idle_pending"),
                       (DOWN, "idle"), (HOLD, "cooldown")]

    def test_cooldown_suppresses_and_resets_streaks(self):
        """Breaching windows inside the cooldown are held AND do not
        accumulate: the first post-cooldown breach starts a fresh
        debounce."""
        p = AutoscalePolicy(cfg())
        seq = run_seq(p, [
            w(0, p99=20), w(1, p99=20),            # -> up at t=1
            w(2, p99=20), w(3, p99=20), w(5, p99=20),  # inside cooldown
            w(7, p99=20),                           # fresh streak: 1
            w(8, p99=20),                           # streak 2 -> up
        ])
        assert seq == [
            (HOLD, "breach_pending"), (UP, "slo:p99_ms"),
            (HOLD, "cooldown"), (HOLD, "cooldown"), (HOLD, "cooldown"),
            (HOLD, "breach_pending"), (UP, "slo:p99_ms"),
        ]

    def test_flap_budget_caps_oscillation(self):
        """Alternating breach/idle regimes force direction reversals;
        once the budget (2 reversals in the window) is spent, further
        reversals are suppressed with reason=flap."""
        p = AutoscalePolicy(cfg(breach_windows=1, idle_windows=1,
                                cooldown_s=0.0, flap_budget=2))
        seq = run_seq(p, [
            w(0, p99=20),   # up        (no reversal yet)
            w(1, p99=2),    # down      (reversal 1)
            w(2, p99=20),   # up        (reversal 2)
            w(3, p99=2),    # would reverse again -> flap
            w(4, p99=2),    # still flap
            w(5, p99=20),   # same direction as last executed (up): ok
        ])
        assert seq == [(UP, "slo:p99_ms"), (DOWN, "idle"),
                       (UP, "slo:p99_ms"), (HOLD, "flap"), (HOLD, "flap"),
                       (UP, "slo:p99_ms")]

    def test_operator_override_wins(self):
        """A /scale note suppresses automatic verbs for override_hold_s
        even under a hard breach; the loop resumes after the hold."""
        p = AutoscalePolicy(cfg())
        p.note_override(0.0)
        seq = run_seq(p, [w(1, p99=50), w(5, p99=50), w(9, p99=50),
                          w(11, p99=50), w(12, p99=50)])
        assert seq == [(HOLD, "override"), (HOLD, "override"),
                       (HOLD, "override"), (HOLD, "breach_pending"),
                       (UP, "slo:p99_ms")]

    def test_membership_bounds(self):
        p = AutoscalePolicy(cfg(breach_windows=1, idle_windows=1,
                                cooldown_s=0.0))
        assert p.decide(w(0, p99=50), gang_size=4).reason == "at_max"
        assert p.decide(w(1, p99=1), gang_size=1).reason == "at_min"

    def test_multi_signal_breach_names_every_signal(self):
        p = AutoscalePolicy(cfg(slo=SLOConfig(p99_ms=10, busy_ratio=0.2,
                                              staleness=4.0),
                                breach_windows=1))
        d = p.decide(w(0, p99=20, busy=0.5, stale=1.0), 2)
        assert d.action == UP
        assert d.reason == "slo:p99_ms+busy_ratio"
        assert d.breaches == ("p99_ms", "busy_ratio")

    def test_disabled_and_no_data(self):
        p = AutoscalePolicy(cfg(enabled=False))
        assert p.decide(w(0, p99=999), 2).reason == "disabled"
        p2 = AutoscalePolicy(cfg())
        assert p2.decide(None, 2).reason == "no_data"

    def test_replay_is_exact(self):
        """The whole contract in one line: two fresh policies fed the
        same window stream produce identical decision sequences."""
        windows = [w(t, p99=(30 if (t // 7) % 2 else 2),
                     gang=2 + (t % 2)) for t in range(40)]
        a = run_seq(AutoscalePolicy(cfg()), windows)
        b = run_seq(AutoscalePolicy(cfg()), windows)
        assert a == b

    def test_breach_episode_tracking(self):
        """breach_since anchors at the first breaching window and
        clears on recovery — the settle-window flight-dump trigger."""
        p = AutoscalePolicy(cfg())
        p.decide(w(3, p99=50), 4)
        assert p.breach_since == 3
        p.decide(w(4, p99=50), 4)
        assert p.breach_since == 3
        p.decide(w(5, p99=1), 4)
        assert p.breach_since is None


# ---------------------------------------------------------------------------
# the traffic generator: bit-reproducible schedules


class TestTrafficDeterminism:
    def test_same_seed_identical_schedule(self):
        for name in ("soak", "smoke", "bench"):
            a = Scenario.builtin(name, seed=7)
            b = Scenario.builtin(name, seed=7)
            assert a.schedule() == b.schedule()
            assert a.events_json() == b.events_json()

    def test_different_seed_different_schedule(self):
        a = Scenario.builtin("soak", seed=7)
        b = Scenario.builtin("soak", seed=8)
        assert a.schedule() != b.schedule()

    def test_schedule_is_stable_across_calls(self):
        s = Scenario.builtin("soak")
        assert s.schedule() == s.schedule()

    def test_grammar_round_trip(self):
        s = Scenario.parse(
            "seed=3,writers=1,readers=2,jitter=0;"
            "name=a,ticks=4,grads=2,reads=1.5,duty=0.7;"
            "name=b,ticks=6,reads=3,curve=sine,preempt_at=1+3,"
            "join_at=2,straggle_at=4,straggle_ticks=2,straggle_mult=3,"
            "duty=0.2")
        assert s.seed == 3 and s.writers == 1 and s.readers == 2
        assert s.shape_changes == 1 and s.total_ticks == 10
        kinds = {e.kind for e in s.schedule()}
        assert {GRAD, READ, PREEMPT, JOIN, STRAGGLE_ON,
                STRAGGLE_OFF} <= kinds
        # two preempt waves, round-robin targets
        waves = [e for e in s.schedule() if e.kind == PREEMPT]
        assert [e.target for e in waves] == [0, 1]
        # straggle_mult rides the event count
        on = next(e for e in s.schedule() if e.kind == STRAGGLE_ON)
        assert on.count == 3

    def test_grammar_rejects_unknowns_and_bad_bounds(self):
        with pytest.raises(ValueError, match="unknown phase field"):
            Scenario.parse("name=a,ticks=2,bogus=1")
        with pytest.raises(ValueError, match="duty"):
            Scenario.parse("name=a,ticks=2,duty=1.5")
        with pytest.raises(ValueError, match="curve"):
            Scenario.parse("name=a,ticks=2,curve=square")
        with pytest.raises(ValueError, match="outside"):
            Scenario.parse("name=a,ticks=2,preempt_at=5")
        with pytest.raises(ValueError, match="unknown scenario global"):
            Scenario.parse("seed=1,bogus=2;name=a,ticks=2")

    def test_fractional_reads_accumulate_exactly(self):
        """reads=0.5 with jitter off must dispatch exactly
        floor-accumulated read counts: 1 read every 2 ticks/reader."""
        s = Scenario.parse("seed=0,writers=1,readers=1,jitter=0;"
                           "name=a,ticks=8,grads=0,reads=0.5")
        reads = [e for e in s.schedule() if e.kind == READ]
        assert sum(e.count for e in reads) == 4

    def test_curves_shape_the_load(self):
        sine = TrafficPhase(name="s", ticks=8, reads=10, curve="sine")
        loads = [sine.load_at(i) for i in range(8)]
        assert max(loads) == max(loads[3], loads[4])  # rush mid-phase
        assert loads[0] < loads[3] and loads[7] < loads[4]
        ramp = TrafficPhase(name="r", ticks=4, reads=8, curve="ramp")
        assert [ramp.load_at(i) for i in range(4)] == [2.0, 4.0, 6.0, 8.0]

    def test_soak_scenario_meets_the_issue_bar(self):
        s = Scenario.builtin("soak")
        assert s.shape_changes >= 5
        kinds = {e.kind for e in s.schedule()}
        assert {GRAD, READ, PREEMPT, JOIN, STRAGGLE_ON} <= kinds

    def test_iter_ticks_covers_every_event_once(self):
        s = Scenario.builtin("smoke")
        flat = [e for _t, _p, evs in iter_ticks(s) for e in evs]
        assert flat == s.schedule()


class TestAcrossPackages:
    @pytest.mark.parametrize("name", ["soak", "smoke", "bench"])
    @pytest.mark.parametrize("seed", [0, 7, 1234])
    def test_builtin_schedules_equal_the_jax_generator(self, name, seed):
        mine = Scenario.builtin(name, seed=seed)
        theirs = jtraffic.Scenario.builtin(name, seed=seed)
        assert mine.events_json() == theirs.events_json()
        assert [vars(e) for e in mine.schedule()] == [vars(e) for e in theirs.schedule()]

    def test_parsed_schedule_equals_the_jax_generator(self):
        spec = ("seed=3,writers=1,readers=2,jitter=0.25;"
                "name=a,ticks=4,grads=2,reads=1.5,duty=0.7;"
                "name=b,ticks=6,reads=3,curve=sine,preempt_at=1+3,"
                "join_at=2,straggle_at=4,straggle_ticks=2,straggle_mult=3,"
                "duty=0.2;name=c,ticks=5,reads=4,curve=ramp")
        assert Scenario.parse(spec).events_json() == \
            jtraffic.Scenario.parse(spec).events_json()

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_policy_replays_the_jax_decisions(self, seed):
        """A seeded telemetry stream (all four signals, gaps with no data,
        gang sizes that move) through both packages' policies: the same
        actions and reasons, window for window."""
        rng = np.random.default_rng(seed)
        kw = dict(window_s=1.0, high_frac=1.0, low_frac=0.5,
                  breach_windows=2, idle_windows=3, cooldown_s=3.0,
                  settle_s=2.0, flap_budget=2, flap_window_s=30.0,
                  override_hold_s=4.0, min_servers=1, max_servers=4)
        slo = dict(p99_ms=10.0, busy_ratio=0.3, staleness=4.0, send_queue=8.0)
        mine = AutoscalePolicy(AutoscaleConfig(slo=SLOConfig(**slo), **kw))
        theirs = jautoscale.AutoscalePolicy(jautoscale.AutoscaleConfig(
            slo=jautoscale.SLOConfig(**slo), **kw))
        gang = 2
        for t in range(300):
            vals = dict(
                t=float(t),
                p99_ms=None if rng.random() < 0.1 else float(rng.exponential(8.0)),
                busy_ratio=float(rng.random() * 0.5),
                staleness=float(rng.exponential(3.0)),
                send_queue=float(rng.exponential(5.0)), gang_size=gang)
            if rng.random() < 0.03:
                mine.note_override(float(t))
                theirs.note_override(float(t))
            a = mine.decide(TelemetryWindow(**vals), gang)
            b = theirs.decide(jautoscale.TelemetryWindow(**vals), gang)
            assert (a.action, a.reason) == (b.action, b.reason), t
            if a.action in (UP, DOWN):
                mine.note_executed(a)
                theirs.note_executed(b)
                gang += 1 if a.action == UP else -1


# ---------------------------------------------------------------------------
# samplers: exposition -> windowed signals (exact delta arithmetic)


class TestSampling:
    def _registry_with(self, ops_ms, busy=0, grads=0, served=0,
                       stale=()):
        from mpit_tpu_torch.obs.metrics import Registry

        reg = Registry()
        hist = reg.histogram("mpit_ps_op_seconds", op="GRAD", side="client")
        for ms in ops_ms:
            hist.observe(ms / 1000.0)
        if busy:
            reg.counter("mpit_ps_busy_replies_total", rank=0).inc(busy)
        if grads:
            reg.counter("mpit_ps_grads_applied_total", rank=0).inc(grads)
        if served:
            reg.counter("mpit_ps_params_served_total", rank=0).inc(served)
        for v in stale:
            reg.histogram("mpit_ps_grad_staleness", rank=0,
                          client=1).observe(v)
        return reg

    def test_hist_quantile_between_sees_only_the_window(self):
        reg = self._registry_with([1.0] * 2000)
        prev = obs_top.parse_exposition(reg.exposition())
        # the window adds 10 slow ops: the windowed p99 must jump to
        # the slow bucket even though the cumulative p99 stays low
        hist = reg.histogram("mpit_ps_op_seconds", op="GRAD", side="client")
        for _ in range(10):
            hist.observe(0.5)
        cur = obs_top.parse_exposition(reg.exposition())
        cum = obs_top.hist_quantile(cur, "mpit_ps_op_seconds", 0.99)
        win = obs_top.hist_quantile_between(prev, cur,
                                            "mpit_ps_op_seconds", 0.99)
        assert win >= 0.5 and cum < 0.5
        # empty window -> None
        assert obs_top.hist_quantile_between(cur, cur,
                                             "mpit_ps_op_seconds",
                                             0.99) is None

    def test_window_from_samples_delta_arithmetic(self):
        reg = self._registry_with([1.0] * 10, busy=2, grads=6, served=2,
                                  stale=[2.0, 4.0])
        prev = obs_top.parse_exposition(reg.exposition())
        reg.counter("mpit_ps_busy_replies_total", rank=0).inc(3)
        reg.counter("mpit_ps_grads_applied_total", rank=0).inc(9)
        reg.histogram("mpit_ps_grad_staleness", rank=0, client=1).observe(6.0)
        cur = obs_top.parse_exposition(reg.exposition())
        win = window_from_samples(5.0, cur, prev, gang_size=3)
        assert win.t == 5.0 and win.gang_size == 3
        assert win.ops == 9.0                       # applied delta only
        assert win.busy_ratio == pytest.approx(3 / (3 + 9))
        assert win.staleness == pytest.approx(6.0)  # the window's one obs
        # cold start (no prev): cumulative totals stand in
        cold = window_from_samples(1.0, cur, None)
        assert cold.ops == 17.0
        assert cold.busy_ratio == pytest.approx(5 / (5 + 17))

    def test_registry_sampler_reads_the_global_registry(self, obs_on):
        reg = obs.get_registry()
        reg.histogram("mpit_ps_op_seconds", op="GRAD",
                      side="client").observe(0.002)
        reg.counter("mpit_ps_grads_applied_total", rank=0).inc(4)
        sampler = RegistrySampler()
        first = sampler(1.0, gang_size=2)
        assert first.ops == 4.0 and first.p99_ms is not None
        reg.counter("mpit_ps_grads_applied_total", rank=0).inc(2)
        second = sampler(2.0, gang_size=2)
        assert second.ops == 2.0  # delta, not cumulative

    def test_http_sampler_pools_statusd_endpoints(self, obs_on):
        from mpit_tpu_torch.obs import statusd

        reg = obs.get_registry()
        reg.histogram("mpit_ps_op_seconds", op="PARAM",
                      side="client").observe(0.004)
        reg.counter("mpit_ps_params_served_total", rank=0).inc(7)
        srv = statusd.StatusServer(0)
        try:
            sampler = HttpSampler(srv.port, nranks=1)
            win = sampler(1.0, gang_size=2)
            assert win.ops == 7.0
            assert win.p99_ms == pytest.approx(7.8125)  # log2 bucket
        finally:
            srv.close()

    def test_http_sampler_tolerates_down_ranks(self):
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead_port = s.getsockname()[1]
        win = HttpSampler(dead_port, nranks=2)(3.0, gang_size=1)
        assert win.ops == 0.0 and win.p99_ms is None


# ---------------------------------------------------------------------------
# mpit top: SLO columns + the autoscale status line


class TestTopSlo:
    def _sample(self, busy=4, grads=12, autoscale=None):
        from mpit_tpu_torch.obs.metrics import Registry

        reg = Registry()
        reg.histogram("mpit_ps_op_seconds", op="GRAD",
                      side="client").observe(0.020)
        reg.counter("mpit_ps_busy_replies_total", rank=0).inc(busy)
        reg.counter("mpit_ps_grads_applied_total", rank=0).inc(grads)
        status = {"role": "server"}
        if autoscale is not None:
            status["controller"] = {"autoscale": autoscale}
        return {"metrics": obs_top.parse_exposition(reg.exposition()),
                "status": status, "port": 1}

    def test_rank_row_busy_ratio_and_slo_verdict(self):
        row = obs_top._rank_row(0, self._sample(), None, None,
                                p99_target_ms=10.0)
        assert row["busy_ratio"] == pytest.approx(4 / 16)
        assert row["slo"] == "hot"  # 20ms observed vs 10ms target
        ok = obs_top._rank_row(0, self._sample(), None, None,
                               p99_target_ms=100.0)
        assert ok["slo"] == "ok"
        none = obs_top._rank_row(0, self._sample(), None, None)
        assert none["slo"] is None and none["p99_target_ms"] is None

    def test_render_table_has_slo_columns(self):
        row = obs_top._rank_row(0, self._sample(), None, None,
                                p99_target_ms=10.0)
        table = obs_top.render_table([row, {"rank": 1, "up": False}])
        head, body = table.splitlines()[0], table.splitlines()[1]
        assert "slo" in head and "busy%" in head
        assert "HOT" in body and "25" in body

    def test_autoscale_status_line(self):
        section = {
            "enabled": True, "slo": {"p99_ms": 24.0},
            "last": {"action": "up", "reason": "slo:p99_ms", "t": 1.0,
                     "breaches": ["p99_ms"], "cooldown_s": 0,
                     "window": None},
            "cooldown_s": 3.2,
            "decisions": {"up": 2, "down": 1, "hold": 40},
            "suppressed": 5, "operator_calls": 0,
        }
        samples = {0: self._sample(), 1: self._sample(autoscale=section)}
        found = obs_top.autoscale_status(samples)
        assert found == section
        line = obs_top.render_autoscale_line(found)
        assert "last=up(slo:p99_ms)" in line
        assert "cooldown=3.2s" in line and "up/down/hold=2/1/40" in line
        assert "p99_ms<=24" in line
        assert obs_top.render_autoscale_line(None) == \
            "autoscale: (not running)"


# ---------------------------------------------------------------------------
# flight dumps: autoscale postmortems validate (and bad ones don't)


class TestAutoscaleFlight:
    def _dump(self, tmp_path, monkeypatch, reason, **extra):
        from mpit_tpu_torch.obs.flight import FlightRecorder, validate_dump

        monkeypatch.setenv("MPIT_OBS_FLIGHT", str(tmp_path))
        rec = FlightRecorder()
        rec.set_identity(rank=0, role="controller")
        rec.record("autoscale", action="up", reason="slo:p99_ms",
                   executed=True)
        path = rec.dump(reason, **extra)
        assert path is not None
        return validate_dump, path

    def test_valid_autoscale_dump(self, tmp_path, monkeypatch, obs_on):
        decision = {"action": "up", "reason": "slo:p99_ms", "t": 1.0}
        window = {"p99_ms": 31.25, "ops": 40}
        validate, path = self._dump(tmp_path, monkeypatch, "autoscale_up",
                                    decision=decision, window=window)
        stats = validate(path)
        assert stats["reason"] == "autoscale_up" and stats["events"] >= 1

    def test_slo_breach_dump_needs_duration(self, tmp_path, monkeypatch,
                                            obs_on):
        decision = {"action": "hold", "reason": "at_max", "t": 9.0}
        validate, path = self._dump(tmp_path, monkeypatch, "slo_breach",
                                    decision=decision, window=None,
                                    breach_for_s=4.2)
        assert validate(path)["reason"] == "slo_breach"
        validate2, bad = self._dump(tmp_path, monkeypatch, "slo_breach",
                                    decision=decision, window=None)
        with pytest.raises(ValueError, match="breach_for_s"):
            validate2(bad)

    def test_dump_without_decision_rejected(self, tmp_path, monkeypatch,
                                            obs_on):
        validate, path = self._dump(tmp_path, monkeypatch, "autoscale_up",
                                    window=None)
        with pytest.raises(ValueError, match="decision"):
            validate(path)
        validate2, path2 = self._dump(tmp_path, monkeypatch,
                                      "autoscale_down",
                                      decision={"action": "down",
                                                "reason": "idle"})
        with pytest.raises(ValueError, match="window"):
            validate2(path2)


# ---------------------------------------------------------------------------
# the closed loop: scripted windows drive a REAL gang through real verbs


class TestClosedLoop:
    def _gang(self, tmp_path):
        """2 servers + 2 clients + controller + 1 spare on the local
        router — the same elastic topology the soak uses, grads
        serialized by the test."""
        from mpit_tpu_torch.comm.local import LocalRouter
        from mpit_tpu_torch.ft import FTConfig
        from mpit_tpu_torch.ps import ParamClient, ParamServer
        from mpit_tpu_torch.shardctl import ShardController

        ft = FTConfig(op_deadline_s=2.0, max_retries=10,
                      backoff_base_s=0.005, backoff_cap_s=0.02)
        router = LocalRouter(6)
        sranks, cranks, spare, ctl_rank = [0, 1], [2, 3], 4, 5
        servers, threads = {}, {}

        def make_server(r, joiner):
            servers[r] = ParamServer(
                r, list(cranks), router.endpoint(r), rule="add", ft=ft,
                device="cpu",
                controller_rank=ctl_rank, ckpt_dir=str(tmp_path),
                ckpt_interval=1e9, shardctl=joiner)
            threads[r] = threading.Thread(target=servers[r].start,
                                          daemon=True)
            threads[r].start()

        for r in sranks:
            make_server(r, joiner=False)
        from mpit_tpu_torch.shardctl import RebalancePolicy

        ctl = ShardController(
            ctl_rank, router.endpoint(ctl_rank), sranks, cranks,
            spawner=lambda r: make_server(r, True), spare_ranks=[spare],
            policy=RebalancePolicy(enabled=False))
        clients = [ParamClient(r, sranks, router.endpoint(r),
                               seed_servers=(r == cranks[0]), ft=ft,
                               shardctl=True, controller_rank=ctl_rank,
                               sc_shards_per_server=2)
                   for r in cranks]
        w0 = np.arange(64, dtype=np.float32)
        starters = []
        for i, c in enumerate(clients):
            p = w0.copy() if i == 0 else np.zeros_like(w0)
            starters.append(threading.Thread(
                target=c.start, args=(p, np.zeros_like(w0)), daemon=True))
            starters[-1].start()
        for t in starters:
            t.join(30)
            assert not t.is_alive()
        ctl.pump()
        assert ctl.smap is not None
        return dict(ctl=ctl, clients=clients, servers=servers,
                    threads=threads)

    def _finish(self, gang):
        for c in gang["clients"]:
            c.stop()
        for t in gang["threads"].values():
            t.join(30)
            assert not t.is_alive()
        gang["ctl"].pump()
        assert gang["ctl"].done

    def test_breach_scales_up_and_idle_scales_down(self, tmp_path,
                                                   obs_on):
        """Scripted windows, real verbs: two breaching windows widen
        the gang onto the spawned spare; a later idle run drains it
        again.  The audit names the driving signal both times and the
        flight dumps validate."""
        from mpit_tpu_torch.obs.flight import validate_dump

        gang = self._gang(tmp_path)
        ctl = gang["ctl"]
        script = iter([
            w(1, p99=50), w(2, p99=50),     # breach x2 -> up
            w(9, p99=1), w(10, p99=1), w(11, p99=1),  # idle x3 -> down
            w(12, p99=8),
        ])
        now = [0.0]
        scaler = Autoscaler(
            ctl, cfg(cooldown_s=0.0, window_s=0.0, idle_windows=3),
            sampler=lambda t, gang_size=0: next(script),
            clock=lambda: now[0])
        ctl.attach_autoscaler(scaler)
        for t in (1, 2):
            now[0] = t
            ctl.pump()
        assert scaler.ups == 1 and len(ctl._live_servers()) == 3
        up_rec = [d for d in scaler.audit_log() if d["action"] == UP][-1]
        assert up_rec["executed"] and up_rec["reason"] == "slo:p99_ms"
        assert up_rec["window"]["p99_ms"] == 50
        for t in (9, 10, 11):
            now[0] = t
            ctl.pump()
        assert scaler.downs == 1 and len(ctl._live_servers()) == 2
        assert 4 in ctl.retired  # the spare drained back out
        # the gang still trains end-to-end after both verbs
        c = gang["clients"][0]
        c.grad[:] = 1.0
        c.async_send_grad()
        c.wait()
        self._finish(gang)
        flight = obs.get_flight()
        assert flight.last_dump_path is not None
        validate_dump(flight.last_dump_path)

    def test_operator_route_suppresses_the_loop(self, tmp_path, obs_on,
                                                monkeypatch):
        """A queued /scale request (the HTTP handler's enqueue path)
        makes the very next breaching windows hold with
        reason=override — the human always wins."""
        monkeypatch.setenv("MPIT_OBS_FLIGHT", str(tmp_path))
        gang = self._gang(tmp_path)
        ctl = gang["ctl"]
        now = [0.0]
        scaler = Autoscaler(
            ctl, cfg(cooldown_s=0.0, window_s=0.0, override_hold_s=100.0),
            sampler=lambda t, gang_size=0: w(t, p99=50),
            clock=lambda: now[0])
        ctl.attach_autoscaler(scaler)
        ctl._scale_action({"op": "down", "rank": "1"})
        assert scaler.operator_calls == 1
        for t in (1, 2, 3):
            now[0] = t
            ctl.pump()
        assert scaler.ups == 0
        reasons = [d["reason"] for d in scaler.audit_log()]
        assert reasons and set(reasons) == {"override"}
        # the operator's own request executed (rank 1 drained)
        assert 1 in ctl.retired
        assert ctl.autoscaler.status_section()["operator_calls"] == 1
        self._finish(gang)

    def test_failed_scale_up_is_audited_not_fatal(self, tmp_path, obs_on):
        """With no spare rank left the verb fails; the autoscaler logs
        the error in the audit record and the control plane keeps
        serving (never raises out of pump)."""
        gang = self._gang(tmp_path)
        ctl = gang["ctl"]
        ctl.spares.clear()
        now = [0.0]
        scaler = Autoscaler(
            ctl, cfg(cooldown_s=0.0, window_s=0.0),
            sampler=lambda t, gang_size=0: w(t, p99=50),
            clock=lambda: now[0])
        ctl.attach_autoscaler(scaler)
        for t in (1, 2):
            now[0] = t
            ctl.pump()
        assert scaler.ups == 0
        rec = scaler.audit_log()[-1]
        assert rec["action"] == UP and not rec["executed"]
        assert "spare" in rec["error"]
        self._finish(gang)


# ---------------------------------------------------------------------------
# status plumbing: the controller /status autoscale section


class TestStatusSection:
    def test_status_section_shape(self, obs_on):
        class _Ctl:
            rank = 9
            sranks = [0, 1]
            spares = []
            _clock = staticmethod(lambda: 0.0)

            def _live_servers(self):
                return [0, 1]

        scaler = Autoscaler(_Ctl(), cfg(), sampler=lambda t, gang_size=0:
                            w(t, p99=1), clock=lambda: 0.0)
        scaler.pump()
        section = scaler.status_section()
        assert section["slo"] == {"p99_ms": 10.0}
        assert section["last"]["action"] == HOLD
        assert section["decisions"]["hold"] == 1
        assert json.dumps(section)  # JSON-serializable for /status
