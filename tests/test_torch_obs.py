"""The port's observability layer (``mpit_tpu_torch.obs``) against the JAX
package's (``mpit_tpu.obs``): twins of ``tests/test_obs.py``.

Each twin runs the reference test's scenario through the port's roles.
Where the reference holds counters to a fault plan's arithmetic, the twin
also runs the same gang through the JAX package's roles on the same seed
and plan and holds the port's counters equal to the JAX package's.  The
disabled path is held with identity checks and a patched clock that counts
its calls, not a wall-time budget.  Across the packages the rule is
equality: each package's ``validate_trace`` and ``validate_dump`` give
equal results on the other package's files.

Obs state is process-wide in each package, so every test that enables it
resets both packages' globals around itself (the ``obs_on`` fixture).
Statusd endpoints take OS-assigned loopback ports, never a fixed base.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import mpit_tpu.obs as jobs
from mpit_tpu.comm.local import LocalRouter as JaxRouter
from mpit_tpu.ft import FaultPlan as JaxFaultPlan
from mpit_tpu.ft import FaultyTransport as JaxFaultyTransport
from mpit_tpu.ft import FTConfig as JaxFTConfig
from mpit_tpu.obs import flight as jflight
from mpit_tpu.obs import trace as jtrace
from mpit_tpu.ps import ParamClient as JaxClient
from mpit_tpu.ps import ParamServer as JaxServer
from mpit_tpu_torch import obs
from mpit_tpu_torch.aio import EXEC, Scheduler, aio_sleep
from mpit_tpu_torch.comm.local import LocalRouter
from mpit_tpu_torch.ft import FaultPlan, FaultyTransport, FTConfig, RetryExhausted
from mpit_tpu_torch.obs import clock as obs_clock
from mpit_tpu_torch.obs import flight as obs_flight
from mpit_tpu_torch.obs import metrics as obs_metrics
from mpit_tpu_torch.obs import profile as obs_profile
from mpit_tpu_torch.obs import spans as obs_spans
from mpit_tpu_torch.obs import statusd as obs_statusd
from mpit_tpu_torch.obs import top as obs_top
from mpit_tpu_torch.obs import trace as obs_trace
from mpit_tpu_torch.obs.__main__ import main as obs_cli
from mpit_tpu_torch.ps import ParamClient, ParamServer, tags

torch.set_num_threads(1)

DATA_TAGS = frozenset({tags.GRAD, tags.PARAM_REQ, tags.PARAM_PUSH})

#: fast retry posture for router-speed gangs (the reference test's)
FAST = dict(op_deadline_s=0.25, max_retries=8, backoff_base_s=0.005,
            backoff_cap_s=0.02)


def reset_both(enabled):
    obs.configure(enabled=enabled, reset=True)
    jobs.configure(enabled=enabled, reset=True)


@pytest.fixture
def obs_on():
    """Both packages' obs on and reset; both restored to the environment
    and reset afterwards."""
    reset_both(True)
    try:
        yield obs.get_registry()
    finally:
        reset_both(None)


def join_all(threads, timeout=30):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "role thread did not stop (hang)"


# ---------------------------------------------------------------------------
# registry primitives



@pytest.fixture
def no_port_pool():
    """A process without the port's worker pool (process-global, made by the
    first chunked transfer or cell XOR): one made by an earlier test is set
    aside for the test and put back after."""
    from mpit_tpu_torch.comm import pool

    saved, pool._GLOBAL = pool._GLOBAL, None
    try:
        yield
    finally:
        made, pool._GLOBAL = pool._GLOBAL, saved
        if made is not None and made is not saved:
            made.close()

class TestRegistry:
    def test_counter_gauge_histogram(self):
        reg = obs_metrics.Registry()
        c = reg.counter("mpit_x_total", rank=1)
        c.inc()
        c.inc(4)
        assert c.value == 5
        assert reg.counter("mpit_x_total", rank=1) is c
        assert reg.counter("mpit_x_total", rank=2) is not c
        g = reg.gauge("mpit_depth")
        g.set(7)
        g.add(-2)
        assert g.value == 5
        h = reg.histogram("mpit_h_seconds")
        for v in (0.75, 1.5, 3.0):
            h.observe(v)
        assert h.count == 3 and h.vmax == 3.0 and h.vmin == 0.75

    def test_log2_bucketing_is_the_jax_packages(self):
        rng = np.random.default_rng(0)
        values = np.concatenate([rng.lognormal(0.0, 8.0, 500), [0.0, -5.0, 2.0 ** 40,
                                                                0.75, 1.0]])
        for v in values:
            assert obs_metrics.bucket_index(float(v)) == \
                jobs.metrics.bucket_index(float(v))
        h, jh = obs_metrics.Histogram("h"), jobs.metrics.Histogram("h")
        for v in values:
            h.observe(float(v))
            jh.observe(float(v))
        assert h.snapshot() == jh.snapshot()
        assert obs_metrics.Histogram("h").snapshot()["count"] == 0

    def test_kind_collision_fails_loudly(self):
        reg = obs_metrics.Registry()
        reg.counter("mpit_k")
        with pytest.raises(TypeError, match="already registered"):
            reg.histogram("mpit_k")

    def test_snapshot_and_exposition_are_the_jax_packages(self):
        regs = (obs_metrics.Registry(), jobs.metrics.Registry())
        for reg in regs:
            reg.counter("mpit_c_total", peer=3).inc(2)
            reg.histogram("mpit_h").observe(1.5)
            reg.gauge("mpit_g", rank=0).set(-4)
        assert regs[0].snapshot() == regs[1].snapshot()
        assert regs[0].exposition() == regs[1].exposition()
        assert regs[0].format_summary(prefix="mpit_c") == \
            regs[1].format_summary(prefix="mpit_c")
        assert 'mpit_c_total{peer="3"} 2' in regs[0].exposition()

    def test_timer_context_observes(self):
        reg = obs_metrics.Registry()
        with reg.timer("mpit_t_seconds", codec="int8"):
            pass
        h = reg.histogram("mpit_t_seconds", codec="int8")
        assert h.count == 1 and h.total >= 0.0

    def test_counter_incs_are_thread_safe_enough(self):
        reg = obs_metrics.Registry()
        c = reg.counter("mpit_mt_total")
        threads = [threading.Thread(target=lambda: [c.inc() for _ in range(10000)])
                   for _ in range(4)]
        for t in threads:
            t.start()
        join_all(threads)
        assert c.value == 40000


# ---------------------------------------------------------------------------
# the disabled path: null objects, and no clock read


class CountingTime:
    """Stands in for the ``time`` module inside the obs modules: every
    call of one of its functions is counted."""

    def __init__(self):
        self.calls = 0

    def __getattr__(self, name):
        real = getattr(time, name)
        if not callable(real):
            return real

        def counted(*a, **kw):
            self.calls += 1
            return real(*a, **kw)

        return counted


@pytest.fixture
def counting_clock(monkeypatch):
    clock = CountingTime()
    for mod in (obs_metrics, obs_spans, obs_flight, obs_profile, obs_clock):
        monkeypatch.setattr(mod, "time", clock)
    return clock


class TestDisabledPath:
    def test_disabled_registry_is_the_null_object(self):
        assert not obs.obs_enabled()
        reg = obs.get_registry()
        assert reg is obs_metrics.NULL_REGISTRY
        assert reg.counter("x") is obs_metrics.NULL
        assert reg.histogram("y", a=1) is obs_metrics.NULL
        assert reg.timer("z") is obs_metrics.NULL
        rec = obs_spans.get_recorder()
        assert rec is obs_spans.NULL_RECORDER
        assert rec.op("GRAD", peer=1) is obs_spans.NULL_SPAN
        assert rec.task_begin("t") is None
        assert rec.open_ops() == []
        fl = obs_flight.get_flight()
        assert fl is obs_flight.NULL_FLIGHT
        fl.record("op", name="GRAD")
        assert fl.dump("anything") is None and fl.events == ()
        prof = obs_profile.get_profiler()
        assert prof is obs_profile.NULL_PROFILER
        assert not prof.enabled
        assert prof.cpu_now() == 0.0
        prof.step("t", 0.5)
        prof.sample(3)
        assert prof.samples == () and prof.cpu_seconds == 0.0
        assert prof.top_tasks() == []
        assert obs_statusd.maybe_start(0) is None
        obs_metrics.NULL.inc(10)
        obs_metrics.NULL.observe(1.0)
        assert obs_metrics.NULL.value == 0
        assert reg.snapshot() == {} and reg.exposition() == ""

    def test_disabled_path_microbenchmark(self, counting_clock):
        """The reference's 260k disabled operations (counter incs, op-span
        lifecycles, flight records, profiler step/sample pairs), held by
        what they read instead of a wall-time budget: the null objects are
        the shared singletons and not one clock call is made."""
        reg = obs.get_registry()
        c = reg.counter("mpit_bench_total")
        rec = obs_spans.get_recorder()
        fl = obs_flight.get_flight()
        prof = obs_profile.get_profiler()
        assert (c, rec, fl, prof) == (obs_metrics.NULL, obs_spans.NULL_RECORDER,
                                      obs_flight.NULL_FLIGHT, obs_profile.NULL_PROFILER)
        for _ in range(200_000):
            c.inc()
        for _ in range(20_000):
            sp = rec.op("GRAD", peer=1, side="client")
            assert sp is obs_spans.NULL_SPAN
            sp.mark("encode")
            sp.end("ok")
        for _ in range(20_000):
            fl.record("op", name="GRAD", outcome="ok")
        for _ in range(20_000):
            prof.step("t", prof.cpu_now())
            prof.sample(0)
        assert counting_clock.calls == 0

    def test_roles_read_no_clock_with_obs_off(self, counting_clock):
        """A framed gang's client and server hot paths with obs off: the
        op spans are the null span, and no obs module reads a clock (the
        scheduler's own FT timers — deadlines, backoff — are not obs)."""
        router = LocalRouter(2)
        server = ParamServer(0, [1], router.endpoint(0), rule="add", device="cpu",
                             ft=FTConfig(rejoin=True))
        client = ParamClient(1, [0], router.endpoint(1), seed_servers=True,
                             ft=FTConfig(**FAST))
        assert client._spans is obs_spans.NULL_RECORDER
        assert server._spans is obs_spans.NULL_RECORDER
        assert client._flight is obs_flight.NULL_FLIGHT
        t = threading.Thread(target=server.start, daemon=True)
        t.start()
        p = np.ones(16, np.float32)
        client.start(p, np.zeros_like(p))
        for _ in range(3):
            client.grad[:] = 0.5
            client.async_send_grad()
            client.async_recv_param()
            client.wait()
        client.stop()
        join_all([t])
        assert server.grads_applied == 3
        assert counting_clock.calls == 0

    def test_configure_flips_and_restores(self):
        obs.configure(enabled=True, reset=True)
        try:
            assert obs.obs_enabled()
            assert obs.get_registry() is not obs_metrics.NULL_REGISTRY
            assert obs_spans.get_recorder().enabled
        finally:
            obs.configure(enabled=None, reset=True)
        assert not obs.obs_enabled()

    def test_configure_reset_clears_every_obs_global(self):
        obs.configure(enabled=True, reset=True)
        try:
            obs_spans.get_recorder().op("GRAD", peer=0).end("ok")
            obs_flight.get_flight().record("op")
            obs.register_status_provider("probe", lambda: {})
            obs_clock.register("client9", obs_clock.ClockEstimator())
            obs.configure(enabled=True, reset=True)
            assert obs_spans.get_recorder().spans == []
            assert list(obs_flight.get_flight().events) == []
            assert "probe" not in obs_statusd._PROVIDERS
            assert "client9" not in obs_clock.snapshot_all()
        finally:
            obs.configure(enabled=None, reset=True)

    def test_registry_or_local_always_counts(self):
        reg = obs.registry_or_local()
        assert reg.enabled
        c = reg.counter("mpit_local_total")
        c.inc()
        assert c.value == 1


# ---------------------------------------------------------------------------
# spans + trace export


class TestSpans:
    def test_op_span_records_phases_and_histogram(self, obs_on):
        rec = obs_spans.get_recorder()
        sp = rec.op("GRAD", peer=3, side="client", epoch=0)
        sp.mark("encode")
        sp.mark("send")
        sp.note(seq=7)
        sp.end("ok", retries=1)
        sp.end("ignored")  # idempotent
        assert len(rec.spans) == 1
        done = rec.spans[0]
        assert done.outcome == "ok"
        assert done.args["seq"] == 7 and done.args["retries"] == 1
        assert [p for p, _ in done.marks] == ["encode", "send"]
        h = obs_on.histogram("mpit_ps_op_seconds", op="GRAD", side="client")
        assert h.count == 1

    def test_scheduler_records_task_lifecycles(self, obs_on):
        sched = Scheduler(idle_usec=0)
        sched.spawn(aio_sleep(0.01), name="nap")
        sched.wait()
        names = [name for name, _, _, _state, _cpu in obs_spans.get_recorder().tasks]
        assert "nap" in names
        assert obs_on.counter("mpit_aio_steps_total").value > 0
        assert obs_on.counter("mpit_aio_tasks_total").value >= 1


class TestTraceExport:
    def test_round_trip_and_balance(self, obs_on, tmp_path):
        rec = obs_spans.get_recorder()
        for i in range(3):
            sp = rec.op("GRAD", peer=0, side="client", epoch=0, seq=i + 1)
            sp.mark("send")
            sp.end("ok")
        tok = rec.task_begin("svc")
        rec.task_end(tok, "svc", "DONE")
        path = obs_trace.write_rank_trace(str(tmp_path / "t.json"), 7, role="client")
        stats = obs_trace.validate_trace(path)
        assert stats["ops"] == 3 and stats["tasks"] == 1
        assert jtrace.validate_trace(path) == stats
        obj = json.load(open(path))
        assert obj["otherData"]["ranks"]["7"]["role"] == "client"
        merged = str(tmp_path / "m.json")
        obs_trace.merge_traces(merged, [path])
        assert obs_trace.validate_trace(merged)["pids"] == 1
        jmerged = str(tmp_path / "jm.json")
        jtrace.merge_traces(jmerged, [path])
        assert open(jmerged).read() == open(merged).read()

    def test_validator_rejects_malformed(self, tmp_path):
        bad = tmp_path / "bad.json"
        for events, match in (
                ([{"ph": "E", "name": "GRAD", "pid": 0, "tid": 1, "ts": 1.0}], "no open B"),
                ([{"ph": "B", "name": "GRAD", "pid": 0, "tid": 1, "ts": 1.0}], "unclosed")):
            bad.write_text(json.dumps({"traceEvents": events}))
            with pytest.raises(ValueError, match=match):
                obs_trace.validate_trace(str(bad))
            with pytest.raises(ValueError, match=match):
                jtrace.validate_trace(str(bad))
        bad.write_text(json.dumps({"nope": 1}))
        with pytest.raises(ValueError, match="traceEvents"):
            obs_trace.validate_trace(str(bad))

    def test_cli_entry(self, obs_on, tmp_path):
        obs_spans.get_recorder().op("PARAM", peer=0).end("ok")
        path = obs_trace.write_rank_trace(str(tmp_path / "t.json"), 0)
        assert obs_trace.main([path]) == 0
        assert obs_trace.main([str(tmp_path / "missing.json")]) == 1


# ---------------------------------------------------------------------------
# the utils/timers shim


class TestTimersFold:
    def test_utils_reexports_are_the_obs_objects(self):
        from mpit_tpu_torch import utils
        from mpit_tpu_torch.obs import timers as obs_timers
        from mpit_tpu_torch.utils import timers as utils_timers

        assert utils_timers.PhaseTimers is obs_timers.PhaseTimers
        assert utils.trace_annotation is obs_timers.trace_annotation
        assert utils_timers.profiler_trace is obs_timers.profiler_trace
        assert obs.PhaseTimers is obs_timers.PhaseTimers

    def test_phase_timers_still_work(self):
        tm = obs.PhaseTimers()
        with tm.phase("feval"):
            pass
        assert tm.count["feval"] == 1

    def test_the_obs_package_loads_without_torch(self):
        """The trace, analyze and top tools cost no ``import torch``."""
        import subprocess
        import sys

        code = ("import sys, mpit_tpu_torch.obs, mpit_tpu_torch.obs.__main__, "
                "mpit_tpu_torch.obs.causal, mpit_tpu_torch.obs.top; "
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('torch', 'jax', 'mpit_tpu')]; print(bad); sys.exit(1 if bad else 0)")
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                              text=True, timeout=120,
                              cwd=os.path.dirname(os.path.dirname(__file__)))
        assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# deterministic counters under seeded fault plans (2s/2c gangs), both packages


PKGS = {
    "torch": dict(router=LocalRouter, server=ParamServer, client=ParamClient,
                  ft=FTConfig, plan=FaultPlan, faulty=FaultyTransport,
                  server_kw={"device": "cpu"}),
    "jax": dict(router=JaxRouter, server=JaxServer, client=JaxClient, ft=JaxFTConfig,
                plan=JaxFaultPlan, faulty=JaxFaultyTransport, server_kw={}),
}


def launch_gang(pkg, nservers, nclients, client_plans=None, client_ft=None,
                server_ft=None):
    """The reference harness's FT topology, in the named package: servers
    0..nservers-1, clients after them, FaultyTransport on client seams
    (``client_plans``: index -> FaultPlan kwargs)."""
    m = PKGS[pkg]
    n = nservers + nclients
    router = m["router"](n)
    sranks, cranks = list(range(nservers)), list(range(nservers, n))
    server_ft = server_ft or dict(rejoin=True)
    client_ft = FAST if client_ft is None else client_ft
    servers, threads = [], []
    for r in sranks:
        servers.append(m["server"](r, cranks, router.endpoint(r), rule="add",
                                   ft=m["ft"](**server_ft), **m["server_kw"]))
        threads.append(threading.Thread(target=servers[-1].start, daemon=True))
    for t in threads:
        t.start()
    clients, transports = [], []
    for i, r in enumerate(cranks):
        ep = router.endpoint(r)
        plan = (client_plans or {}).get(i)
        if plan is not None:
            ep = m["faulty"](ep, m["plan"](**plan))
        transports.append(ep)
        clients.append(m["client"](r, sranks, ep, seed_servers=(r == cranks[0]),
                                   ft=m["ft"](**client_ft)))
    return servers, clients, threads, transports


def start_clients(clients, size=64, rng=None):
    rng = rng or np.random.default_rng(7)
    starters, params = [], []
    for c in clients:
        p = (rng.normal(size=size).astype(np.float32)
             if not params else np.zeros(size, np.float32))
        params.append(p)
        starters.append(threading.Thread(target=c.start,
                                         args=(p, np.zeros(size, np.float32)),
                                         daemon=True))
    for t in starters:
        t.start()
    join_all(starters)
    return rng, params


def run_gang(servers, clients, threads, rounds, size=64):
    rng, params = start_clients(clients, size)
    for _ in range(rounds):
        for c in clients:
            c.grad[:] = rng.normal(size=size).astype(np.float32)
            c.async_send_grad()
            c.wait()
    clients[0].async_recv_param()
    clients[0].wait()
    for c in clients:
        c.stop()
    join_all(threads)
    return params[0].copy()


def simulate_grad_channel(plan, src, dst, rounds):
    """Replay the plan's arithmetic for one client -> server GRAD channel
    under the retry protocol: a dropped frame times out and is resent, a
    passed or duplicated frame is acked.  Returns (sends, drops, dups)."""
    sends = drops = dups = 0
    n = 0
    for _ in range(rounds):
        while True:
            n += 1
            sends += 1
            verdict = plan.decide(src, dst, tags.GRAD, n)
            if verdict == "drop":
                drops += 1
                continue
            if verdict == "dup":
                dups += 1
            break
    return sends, drops, dups


def gang_counts(servers, clients, transports):
    return {"dropped": [getattr(t, "dropped", 0) for t in transports],
            "duplicated": [getattr(t, "duplicated", 0) for t in transports],
            "retries": [c.retries for c in clients],
            "dup_ops": [s.dup_ops for s in servers],
            "stale_drops": [s.stale_drops for s in servers],
            "grads_applied": [s.grads_applied for s in servers]}


_JAX_WARM = []


def warm_jax():
    """One fault-free JAX gang at the tests' size, once per process: the
    JAX server's first apply compiles, and a compile that outlasts the
    0.25 s op deadline would show as a resend the plan never made."""
    if not _JAX_WARM:
        servers, clients, threads, _ = launch_gang("jax", 2, 2, client_ft=dict(
            op_deadline_s=30.0))
        run_gang(servers, clients, threads, 1)
        _JAX_WARM.append(True)


def both_gangs(rounds, nservers, nclients, plans, **kw):
    """The same gang in each package; returns {pkg: (counts, params)}."""
    warm_jax()
    out = {}
    for pkg in ("torch", "jax"):
        servers, clients, threads, transports = launch_gang(
            pkg, nservers, nclients, client_plans=plans, **kw)
        params = run_gang(servers, clients, threads, rounds)
        out[pkg] = (gang_counts(servers, clients, transports), params)
    return out


class TestDeterministicCounters:
    def test_drop_plan_counters_match_plan_arithmetic(self):
        rounds, nservers, nclients = 6, 2, 2
        plans = {i: dict(seed=i, drop_every=3, tags=frozenset({tags.GRAD}))
                 for i in range(nclients)}
        got = both_gangs(rounds, nservers, nclients, plans)
        counts = got["torch"][0]
        for i in range(nclients):
            want = sum(simulate_grad_channel(FaultPlan(**plans[i]), nservers + i, dst,
                                             rounds)[1] for dst in range(nservers))
            assert counts["dropped"][i] == counts["retries"][i] == want > 0
        assert sum(counts["dup_ops"]) == sum(counts["stale_drops"]) == 0
        assert sum(counts["grads_applied"]) == rounds * nclients * nservers
        assert counts == got["jax"][0]
        assert got["torch"][1].tobytes() == got["jax"][1].tobytes()

    def test_dup_plan_counters_match_plan_arithmetic(self):
        rounds, nservers, nclients = 5, 2, 2
        plans = {i: dict(seed=i, dup_every=2, tags=DATA_TAGS) for i in range(nclients)}
        got = both_gangs(rounds, nservers, nclients, plans)
        counts = got["torch"][0]
        assert sum(counts["duplicated"]) > 0
        assert sum(counts["dup_ops"]) == sum(counts["duplicated"])
        assert sum(counts["retries"]) == 0
        assert sum(counts["grads_applied"]) == rounds * nclients * nservers
        assert counts == got["jax"][0]
        assert got["torch"][1].tobytes() == got["jax"][1].tobytes()

    def test_fault_plan_env_spec_drives_the_same_counters(self, monkeypatch):
        monkeypatch.setenv("MPIT_FT_FAULT_PLAN", f"seed=0,drop_every=3,tags={tags.GRAD}")
        plan = FaultPlan.from_env()
        assert plan == FaultPlan(seed=0, drop_every=3, tags=frozenset({tags.GRAD}))
        jplan = JaxFaultPlan.from_env()
        assert [plan.decide(2, d, tags.GRAD, n) for d in (0, 1) for n in range(1, 30)] == \
            [jplan.decide(2, d, tags.GRAD, n) for d in (0, 1) for n in range(1, 30)]


# ---------------------------------------------------------------------------
# the acceptance scenario: fault-injected gang -> attributable trace


def grad_spans(recorder, side):
    return [sp for sp in recorder.spans
            if sp.name == "GRAD" and sp.args.get("side") == side]


class TestFaultTraceAttribution:
    def test_dropped_then_retried_op_is_attributable(self, obs_on, tmp_path):
        """2s/2c gang under an every-2nd drop plan with obs on, in each
        package: the port's trace holds the retried GRAD span with its
        [epoch, seq] identity, retry count and phases, validates under
        both validators, and the port's spans equal the JAX package's in
        count, outcome and retries."""
        rounds, nservers, nclients = 4, 2, 2
        plans = {0: dict(seed=0, drop_every=2, tags=frozenset({tags.GRAD}))}
        got = {}
        for pkg, rec_of in (("torch", obs_spans.get_recorder),
                            ("jax", jobs.spans.get_recorder)):
            servers, clients, threads, transports = launch_gang(
                pkg, nservers, nclients, client_plans=plans)
            run_gang(servers, clients, threads, rounds)
            got[pkg] = (gang_counts(servers, clients, transports), rec_of())
        counts, rec = got["torch"]
        want = sum(simulate_grad_channel(FaultPlan(**plans[0]), nservers, dst, rounds)[1]
                   for dst in range(nservers))
        assert counts["dropped"][0] == counts["retries"][0] == want > 0
        assert sum(counts["dup_ops"]) == 0
        assert counts == got["jax"][0]
        path = obs_trace.write_rank_trace(str(tmp_path / "trace.json"),
                                          rank=nservers, role="worker")
        stats = obs_trace.validate_trace(path)
        assert stats["ops"] > 0 and jtrace.validate_trace(path) == stats
        obj = json.load(open(path))
        retried = [ev for ev in obj["traceEvents"]
                   if ev["ph"] == "B" and ev["name"] == "GRAD"
                   and ev["args"].get("retries", 0) >= 1]
        assert retried, "no retried GRAD span in the trace"
        ev = retried[0]
        assert ev["args"]["epoch"] == 0 and ev["args"]["seq"] >= 1
        assert ev["args"]["peer"] in range(nservers)
        phases = {e["name"] for e in obj["traceEvents"]
                  if e["ph"] == "X" and e["tid"] == ev["tid"]}
        assert "GRAD.backoff" in phases and "GRAD.send" in phases
        applied = [sp for sp in grad_spans(rec, "server") if sp.outcome == "applied"]
        assert len(applied) == rounds * nclients * nservers

        def summary(recorder):
            return sorted((sp.args.get("side"), sp.args.get("rank"), sp.args.get("peer"),
                           sp.args.get("seq"), sp.outcome, sp.args.get("retries", 0),
                           tuple(p for p, _ in sp.marks))
                          for sp in recorder.spans if sp.name == "GRAD")

        assert summary(rec) == summary(got["jax"][1])


# ---------------------------------------------------------------------------
# gradient staleness: deterministic counts under a sequential schedule

STALE = dict(FAST, staleness=True)


def run_sequential(servers, clients, threads, rounds, size=64):
    rng, params = start_clients(clients, size)
    for _ in range(rounds):
        for c in clients:
            c.async_recv_param()
            c.wait()
        for c in clients:
            c.grad[:] = rng.normal(size=size).astype(np.float32)
            c.async_send_grad()
            c.wait()
    for c in clients:
        c.stop()
    join_all(threads)


def replay_staleness(nservers, nclients, rounds):
    version = [1] * nservers
    basis = [[0] * nservers for _ in range(nclients)]
    out = {}
    for _ in range(rounds):
        for ci in range(nclients):
            for s in range(nservers):
                basis[ci][s] = version[s]
        for ci in range(nclients):
            for s in range(nservers):
                stal = version[s] - basis[ci][s]
                pair = out.setdefault((ci, s), {})
                pair[stal] = pair.get(stal, 0) + 1
                version[s] += 1
    return out


def expected_bucket_dict(values):
    out = {}
    for v, n in values.items():
        key = obs_metrics.bucket_index(float(v)) + obs_metrics.HIST_LO_EXP
        out[key] = out.get(key, 0) + n
    return out


def stale_snapshots(registry, clients, nservers):
    return {(c.rank, s): registry.histogram("mpit_ps_grad_staleness", rank=s,
                                            client=c.rank).snapshot()
            for c in clients for s in range(nservers)}


class TestStalenessDeterministic:
    def _run_both(self, rounds, nservers, nclients, plans=None):
        snaps, counts = {}, {}
        for pkg, reg in (("torch", obs.get_registry), ("jax", jobs.get_registry)):
            servers, clients, threads, transports = launch_gang(
                pkg, nservers, nclients, client_plans=plans, client_ft=STALE)
            run_sequential(servers, clients, threads, rounds)
            snaps[pkg] = stale_snapshots(reg(), clients, nservers)
            counts[pkg] = gang_counts(servers, clients, transports)
        want = replay_staleness(nservers, nclients, rounds)
        for (ci, s), values in want.items():
            snap = snaps["torch"][(nservers + ci, s)]
            assert snap["count"] == sum(values.values())
            assert snap["sum"] == float(sum(v * n for v, n in values.items()))
            assert snap["buckets"] == expected_bucket_dict(values)
        assert snaps["torch"] == snaps["jax"]
        assert counts["torch"] == counts["jax"]
        return counts["torch"]

    def test_fault_free_counts_match_replay_exactly(self, obs_on):
        self._run_both(5, 2, 2)

    def test_drop_plan_staleness_and_retries_match_replay(self, obs_on):
        rounds, nservers = 4, 2
        plans = {0: dict(seed=0, drop_every=2, tags=frozenset({tags.GRAD}))}
        counts = self._run_both(rounds, nservers, 2, plans)
        want = sum(simulate_grad_channel(FaultPlan(**plans[0]), nservers, dst, rounds)[1]
                   for dst in range(nservers))
        assert counts["dropped"][0] == counts["retries"][0] == want > 0
        assert sum(counts["dup_ops"]) == 0

    def test_delay_plan_staleness_matches_replay(self, obs_on):
        plans = {i: dict(seed=i, delay_every=2, delay_polls=3,
                         tags=frozenset({tags.GRAD})) for i in range(2)}
        counts = self._run_both(4, 2, 2, plans)
        assert sum(counts["retries"]) == 0

    def test_legacy_init_negotiates_extension_off(self, obs_on):
        rounds, nservers = 2, 2
        n = nservers + 2
        router = LocalRouter(n)
        sranks, cranks = list(range(nservers)), list(range(nservers, n))
        servers = [ParamServer(r, cranks, router.endpoint(r), rule="add", device="cpu",
                               ft=FTConfig(rejoin=True)) for r in sranks]
        threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
        for t in threads:
            t.start()
        clients = [
            ParamClient(cranks[0], sranks, router.endpoint(cranks[0]), seed_servers=True,
                        ft=FTConfig(**STALE)),
            ParamClient(cranks[1], sranks, router.endpoint(cranks[1]), seed_servers=False,
                        ft=FTConfig()),  # legacy v1
        ]
        assert clients[0]._stale and clients[0]._hdr == 24
        assert not clients[1]._stale and clients[1]._hdr == 0
        run_sequential(servers, clients, threads, rounds)
        for s in servers:
            assert s._stale_track[cranks[0]] is True
            assert s._stale_track.get(cranks[1], False) is False
        assert sum(s.grads_applied for s in servers) == rounds * 2 * nservers
        stale_keys = [k for k in obs_on.snapshot() if k.startswith("mpit_ps_grad_staleness")]
        assert stale_keys
        assert all(f'client="{cranks[0]}"' in k for k in stale_keys), stale_keys

    def test_staleness_without_framing_is_inert(self):
        cfg = FTConfig(staleness=True)
        assert not cfg.stale_track
        client = ParamClient(1, [0], LocalRouter(2).endpoint(1), ft=cfg)
        assert not client._stale and client._hdr == 0


# ---------------------------------------------------------------------------
# statusd: the live introspection endpoint


def _http_get(port, route):
    import urllib.error

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=5) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


class TestStatusd:
    def test_endpoints_serve_metrics_status_trace(self, obs_on):
        obs_on.counter("mpit_bench_total", rank=7).inc(3)
        rec = obs_spans.get_recorder()
        rec.op("PARAM", peer=0, side="client", epoch=0, seq=4).end("ok")
        open_span = rec.op("GRAD", peer=1, side="client", epoch=0, seq=5)
        open_span.mark("send")
        obs.register_status_provider("probe", lambda: {"hello": 1})
        srv = obs_statusd.StatusServer(0, rank=3, role="worker")
        try:
            code, body = _http_get(srv.port, "/metrics")
            assert code == 200 and 'mpit_bench_total{rank="7"} 3' in body.decode()
            status = json.loads(_http_get(srv.port, "/status")[1])
            assert (status["rank"], status["role"]) == (3, "worker")
            assert status["probe"] == {"hello": 1}
            (inflight,) = status["inflight_ops"]
            assert (inflight["op"], inflight["seq"], inflight["phase"]) == ("GRAD", 5, "send")
            assert inflight["elapsed_s"] >= 0
            trace = json.loads(_http_get(srv.port, "/trace")[1])
            assert obs_trace.validate_trace(trace)["ops"] == 1
            assert jtrace.validate_trace(trace)["ops"] == 1
            assert _http_get(srv.port, "/nope")[0] == 404
        finally:
            srv.close()
            open_span.end("ok")

    def test_maybe_start_env_gating(self, obs_on, monkeypatch):
        monkeypatch.delenv("MPIT_OBS_HTTP", raising=False)
        assert obs_statusd.maybe_start(0) is None
        monkeypatch.setenv("MPIT_OBS_HTTP", "0")  # port 0: OS-assigned
        srv = obs_statusd.maybe_start(0, role="server")
        try:
            assert srv is not None and srv.port > 0
            assert json.loads(_http_get(srv.port, "/status")[1])["role"] == "server"
        finally:
            srv.close()

    def test_provider_failure_is_contained(self, obs_on):
        def boom():
            raise RuntimeError("provider died")

        obs.register_status_provider("boom", boom)
        srv = obs_statusd.StatusServer(0, rank=1)
        try:
            code, body = _http_get(srv.port, "/status")
            assert code == 200
            assert "provider died" in json.loads(body)["boom"]["error"]
        finally:
            srv.close()

    def test_roles_register_providers_when_obs_on(self, obs_on):
        router = LocalRouter(2)
        server = ParamServer(0, [1], router.endpoint(0), rule="add", device="cpu")
        client = ParamClient(1, [0], router.endpoint(1))
        section = obs_statusd._PROVIDERS["server0"]()
        assert section["role"] == "server"
        assert section["clients"]["1"]["state"] == "active"
        assert section["clients"]["1"]["timing"] is False
        section = obs_statusd._PROVIDERS["client1"]()
        assert section["role"] == "client" and section["rank"] == 1
        jrouter = JaxRouter(2)
        JaxClient(1, [0], jrouter.endpoint(1))
        jsection = jobs.statusd._PROVIDERS["client1"]()
        assert set(section) == set(jsection)
        assert server is not None and client is not None

    def test_free_base_port_holds_a_gang(self):
        base = obs_statusd.free_base_port(4)
        servers = []
        try:
            for r in range(4):
                servers.append(obs_statusd.StatusServer(base + r, rank=r))
            assert [s.port for s in servers] == list(range(base, base + 4))
        finally:
            for s in servers:
                s.close()


# ---------------------------------------------------------------------------
# flight recorder: ring, dumps, failure-path triggers


class TestFlightRecorder:
    def test_ring_is_bounded_and_dump_validates(self, obs_on, tmp_path, monkeypatch):
        monkeypatch.setenv("MPIT_OBS_FLIGHT", str(tmp_path))
        fl = obs_flight.get_flight()
        fl.set_identity(rank=5, role="worker")
        for i in range(obs_flight.CAPACITY + 40):
            fl.record("op", name="GRAD", seq=i)
        assert len(fl.events) == obs_flight.CAPACITY
        path = fl.dump("unit_test", tasks=[("recv_grad:1.g0", "EXEC")], note="hello")
        assert path and str(tmp_path) in path
        stats = obs_flight.validate_dump(path)
        assert stats["reason"] == "unit_test" and stats["rank"] == 5
        assert stats["events"] == obs_flight.CAPACITY and stats["tasks"] == 1
        assert jflight.validate_dump(path) == stats
        assert obs_cli(["flight", path]) == 0
        assert fl.dump("unit_test") != path

    def test_validator_rejects_malformed(self, tmp_path):
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"schema": "nope"}))
        with pytest.raises(ValueError, match="schema"):
            obs_flight.validate_dump(str(bad))
        bad.write_text(json.dumps({
            "schema": "mpit_flight/1", "reason": "x", "pid": 1,
            "wall_time": 1.0, "events": [{"kind": "op"}], "metrics": {}}))
        with pytest.raises(ValueError, match="numeric t"):
            obs_flight.validate_dump(str(bad))
        assert obs_cli(["flight", str(bad)]) == 1

    def test_retry_exhausted_dumps_flight(self, obs_on, tmp_path, monkeypatch):
        monkeypatch.setenv("MPIT_OBS_FLIGHT", str(tmp_path))
        fast = dict(op_deadline_s=0.05, max_retries=1, backoff_base_s=0.005,
                    backoff_cap_s=0.01)
        servers, clients, threads, _ = launch_gang(
            "torch", 1, 1, client_plans={0: dict(sever_after=0)}, client_ft=fast)
        with pytest.raises(Exception) as exc_info:
            clients[0].start(np.zeros(8, np.float32), np.zeros(8, np.float32))
        assert isinstance(getattr(exc_info.value, "cause", exc_info.value), RetryExhausted)
        for role in clients + servers:
            role.live.stop()
        join_all(threads)
        dumps = sorted(tmp_path.glob("mpit_flight_*retry_exhausted*.json"))
        assert dumps, list(tmp_path.iterdir())
        stats = obs_flight.validate_dump(str(dumps[0]))
        assert stats["reason"] == "retry_exhausted"
        assert jflight.validate_dump(str(dumps[0])) == stats
        obj = json.load(open(dumps[0]))
        assert any(ev["kind"] == "retry_exhausted" for ev in obj["events"])

    def test_scheduler_watchdog_dumps_on_stall(self, obs_on, tmp_path, monkeypatch,
                                               no_port_pool):
        monkeypatch.setenv("MPIT_OBS_FLIGHT", str(tmp_path))
        sched = Scheduler(idle_usec=500, stall_s=0.01)

        def parked():
            while True:
                yield EXEC

        sched.spawn(parked(), name="stuck_service")
        deadline = time.monotonic() + 20
        fl = obs_flight.get_flight()
        while fl.last_dump_path is None and time.monotonic() < deadline:
            sched.ping_pass()
        assert fl.last_dump_path, "watchdog never dumped"
        stats = obs_flight.validate_dump(fl.last_dump_path)
        assert stats["reason"] == "scheduler_stall"
        assert jflight.validate_dump(fl.last_dump_path) == stats
        obj = json.load(open(fl.last_dump_path))
        assert ["stuck_service", "EXEC"] in obj["tasks"]
        assert obj["resources"] == {}  # no pool, profiling off: the JAX shape
        assert obs_on.counter("mpit_aio_stall_dumps_total").value == 1
        first = fl.last_dump_path
        for _ in range(50):
            sched.ping_pass()
        assert fl.last_dump_path == first

    def test_eviction_dumps_flight(self, obs_on, tmp_path, monkeypatch):
        monkeypatch.setenv("MPIT_OBS_FLIGHT", str(tmp_path))
        servers, clients, threads, _ = launch_gang(
            "torch", 1, 2, client_ft=dict(heartbeat_s=0.01),
            server_ft=dict(lease_ttl_s=0.15, rejoin=True))
        c0, c1 = clients
        starters = [threading.Thread(
            target=c.start, args=(np.zeros(16, np.float32), np.zeros(16, np.float32)),
            daemon=True) for c in clients]
        for t in starters:
            t.start()
        join_all(starters)
        for _ in range(20):
            c1.ping()
        time.sleep(0.02)
        deadline = time.monotonic() + 20
        while not any(tmp_path.glob("mpit_flight_*eviction*.json")):
            assert time.monotonic() < deadline, "eviction never dumped"
            c0.ping()
            time.sleep(0.005)
        c0.stop()
        c1.live.stop()
        join_all(threads)
        dump = sorted(tmp_path.glob("mpit_flight_*eviction*.json"))[0]
        stats = obs_flight.validate_dump(str(dump))
        assert stats["reason"] == "eviction"
        assert jflight.validate_dump(str(dump)) == stats
        assert servers[0].leases.state(c1.rank) == "evicted"
        assert servers[0].evictions == 1


# ---------------------------------------------------------------------------
# top: exposition parsing + the aggregator read path


class TestTop:
    def test_parse_exposition(self):
        text = ('mpit_ps_grads_applied_total{rank="0"} 42\n'
                '# comment\n'
                'mpit_ps_grad_staleness_sum{client="2",rank="0"} 7\n'
                'mpit_ps_grad_staleness_count{client="2",rank="0"} 14\n'
                'garbage line\n'
                'mpit_shardctl_map_version 3\n')
        samples = obs_top.parse_exposition(text)
        assert samples == jobs.top.parse_exposition(text)
        assert obs_top.metric_sum(samples, "mpit_ps_grads_applied_total") == 42
        assert obs_top.metric_sum(samples, "mpit_ps_grads_applied_total", rank=0) == 42
        assert obs_top.hist_mean(samples, "mpit_ps_grad_staleness") == 0.5
        assert obs_top.metric_sum(samples, "mpit_shardctl_map_version") == 3

    def test_poll_rank_and_table(self, obs_on):
        obs_on.counter("mpit_ps_grads_applied_total", rank=0).inc(10)
        obs_on.counter("mpit_ps_params_served_total", rank=0).inc(5)
        obs_on.histogram("mpit_ps_grad_staleness", rank=0, client=2).observe(2.0)
        obs_on.counter("mpit_ft_retries_total", rank=0).inc(3)
        srv = obs_statusd.StatusServer(0, rank=0, role="server")
        try:
            sample = obs_top.poll_rank("127.0.0.1", srv.port)
            assert sample["status"]["role"] == "server"
            row = obs_top._rank_row(0, sample, None, None)
            assert row["ops_total"] == 15
            assert row["staleness_mean"] == 2.0
            assert row["retries"] == 3
            assert row == jobs.top._rank_row(0, sample, None, None)
            table = obs_top.render_table([row, {"rank": 1, "up": False}])
            assert "server" in table and "(down)" in table
        finally:
            srv.close()

    def test_cli_once_json(self, obs_on, capsys):
        obs_on.counter("mpit_ps_grads_applied_total", rank=0).inc(1)
        srv = obs_statusd.StatusServer(0, rank=0, role="server")
        try:
            rc = obs_top.main(["--np", "1", "--base-port", str(srv.port), "--iters", "1",
                               "--json", "--min-up", "1"])
        finally:
            srv.close()
        assert rc == 0
        snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert snap["ranks"][0]["up"] and snap["ranks"][0]["ops_total"] == 1
        rc = obs_top.main(["--np", "1", "--base-port", str(srv.port), "--iters", "1",
                           "--json", "--min-up", "1"])
        assert rc == 1

    def test_retry_waits_for_the_late_ranks(self, obs_on, capsys):
        """``--retry-s`` waits for ``--min-up`` ranks, not the first one: a
        rank still importing torch is not counted dead before its time."""
        base = obs_statusd.free_base_port(2)
        first = obs_statusd.StatusServer(base, rank=0, role="server")
        late = []
        timer = threading.Timer(1.0, lambda: late.append(
            obs_statusd.StatusServer(base + 1, rank=1, role="worker")))
        timer.start()
        try:
            rc = obs_top.main(["--np", "2", "--base-port", str(base), "--iters", "1",
                               "--json", "--min-up", "2", "--retry-s", "30"])
        finally:
            timer.join()
            first.close()
            for s in late:
                s.close()
        assert rc == 0
        snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert [r["up"] for r in snap["ranks"]] == [True, True]


# ---------------------------------------------------------------------------
# the merge subcommand: leftover parts from a crashed gang


class TestMergeSubcommand:
    def test_merge_assembles_leftover_parts(self, obs_on, tmp_path):
        rec = obs_spans.get_recorder()
        for i in range(2):
            rec.op("GRAD", peer=0, side="client", seq=i + 1).end("ok")
        base = str(tmp_path / "crashed.json")
        obs_trace.write_rank_trace(obs_trace.part_path(base, 0), 0, role="server")
        obs_trace.write_rank_trace(obs_trace.part_path(base, 3), 3, role="worker")
        assert obs_cli(["merge", base]) == 0
        stats = obs_trace.validate_trace(base)
        assert stats["pids"] == 2 and jtrace.validate_trace(base) == stats
        assert sorted(tmp_path.glob("crashed.json.rank*.json"))
        assert set(json.load(open(base))["otherData"]["ranks"]) == {"0", "3"}

    def test_merge_without_parts_errors(self, tmp_path):
        assert obs_cli(["merge", str(tmp_path / "none.json")]) == 1

    def test_default_subcommand_still_validates(self, obs_on, tmp_path):
        path = obs_trace.write_rank_trace(str(tmp_path / "t.json"), 0)
        assert obs_cli([path]) == 0
        assert obs_cli(["validate", path]) == 0


# ---------------------------------------------------------------------------
# a port process gang: per-rank parts merged by the launcher


def test_gang_merges_rank_traces(tmp_path, monkeypatch):
    """``launch --np 4 --device cpu --side 8`` with MPIT_OBS_TRACE: every
    child writes a part, the parent merges them after the clean gang, the
    merged trace validates under both packages' validators and carries one
    pid per rank with its metrics rider, and the parts are gone."""
    from mpit_tpu_torch.train.launch import LAUNCH_DEFAULTS, launch_processes

    trace_path = str(tmp_path / "gang_trace.json")
    monkeypatch.setenv("MPIT_OBS_TRACE", trace_path)
    cfg = LAUNCH_DEFAULTS.merged(np=4, opt="downpour", epochs=1, model="linear",
                                 side=8, batch=64, device="cpu", lr=0.2)
    results = launch_processes(cfg, timeout=600)
    assert set(results) == {0, 1, 2, 3}
    stats = obs_trace.validate_trace(trace_path)
    assert stats["pids"] == 4 and stats["events"] > 0
    assert jtrace.validate_trace(trace_path) == stats
    ranks = json.load(open(trace_path))["otherData"]["ranks"]
    assert set(ranks) == {"0", "1", "2", "3"}
    assert ranks["0"]["metrics"]['mpit_ps_grads_applied_total{rank="0"}'] == \
        results[0]["grads_applied"] > 0
    assert not list(tmp_path.glob("gang_trace.json.rank*"))


def test_launch_timing_flag_reaches_the_wire():
    """``--ft_timing`` is accepted and puts every rank on the FLAG_TIMING
    wire (with a deadline); the JAX launcher's ft_from_cfg gives the same
    config."""
    from mpit_tpu.train import launch as jlaunch
    from mpit_tpu_torch.train import launch

    flags = dict(ft_op_deadline_s=5.0, ft_timing=True)
    got = launch.ft_from_cfg(launch.LAUNCH_DEFAULTS.merged(flags))
    assert got.timing_track
    want = jlaunch.ft_from_cfg(jlaunch.LAUNCH_DEFAULTS.merged(flags))
    assert {k: getattr(got, k) for k in got.__dataclass_fields__} == \
        {k: getattr(want, k) for k in want.__dataclass_fields__}


def test_bicnn_children_accept_the_status_endpoint(monkeypatch):
    from mpit_tpu_torch.train import bicnn_launch

    monkeypatch.setenv(bicnn_launch.STATUSD_ENV, "0")
    bicnn_launch.validate(bicnn_launch.BICNN_LAUNCH_DEFAULTS.merged(
        device="cpu", np=4, valid_mode="none"))


# ---------------------------------------------------------------------------
# the ptest twin's lifted legs, dry runs on the CPU


@pytest.mark.parametrize("leg,rows", [
    ("MPIT_BENCH_HEARTBEAT", [(0, 0), (1, 0)]),
    ("MPIT_BENCH_OBS", [(0, 0), (0, 1)]),
    ("MPIT_BENCH_STATUS", [(0, 0), (0, 1)]),
    ("MPIT_BENCH_DECOMP", [(0, 0), (0, 0)]),
    ("MPIT_BENCH_PROFILE", [(0, 0), (0, 1)]),
])
def test_ptest_lifted_leg_dry_run(leg, rows):
    """``tools/torch_ptest.py`` with one lifted leg at 8 MB on the CPU: the
    plain codec-none row, then the leg's row with its columns (``rows``:
    each row's heartbeat and obs flags)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MPIT_BENCH_DEVICE="cpu", MPIT_BENCH_MB="8",
               MPIT_BENCH_ROUNDS="3", MPIT_BENCH_CODECS="none", OMP_NUM_THREADS="1")
    env[leg] = "1"
    proc = subprocess.run([sys.executable, os.path.join(repo, "tools", "torch_ptest.py")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [(r["heartbeat"], r["obs"]) for r in got] == rows
    assert all(r["value"] > 0 and r["codec"] == "none" for r in got)
    if leg == "MPIT_BENCH_STATUS":
        assert got[1]["status"] == 1 and got[1]["status_polls"] > 0
    elif leg == "MPIT_BENCH_DECOMP":
        assert got[1]["decomp"] == 1
        assert got[1]["join_rate"] == 1.0 and got[1]["joined_ops"] > 0
        assert {"GRAD", "PARAM"} <= set(got[1]["phases"])
    elif leg == "MPIT_BENCH_PROFILE":
        assert got[1]["profile"] == 1
        assert got[1]["counter_events"] > 0 and set(got[1]["cpu_util"]) == {"0", "1", "2", "3"}


# ---------------------------------------------------------------------------
# files across the packages: each package's validators, analyzer and
# profile report on the other package's traces and dumps


def _seeded_records(pkg_obs, seed):
    """Spans, tasks and flight events from a numpy seed, into one
    package's (enabled, reset) recorder and flight ring."""
    rng = np.random.default_rng(seed)
    rec = pkg_obs.get_recorder()
    fl = pkg_obs.get_flight()
    fl.set_identity(rank=int(rng.integers(0, 8)), role="worker")
    for i in range(int(rng.integers(5, 15))):
        op = str(rng.choice(["GRAD", "PARAM", "PARAM_PUSH"]))
        sp = rec.op(op, peer=int(rng.integers(0, 4)), side="client", rank=5,
                    epoch=0, seq=i + 1)
        for phase in rng.choice(["encode", "send", "ack", "backoff"],
                                size=int(rng.integers(1, 4))):
            sp.mark(str(phase))
        sp.end(str(rng.choice(["ok", "exhausted", "aborted"])))
        tok = rec.task_begin(f"pump:{i % 3}")
        rec.task_end(tok, f"pump:{i % 3}", "DONE")
        fl.record("op", name=op, seq=i + 1, value=float(rng.normal()))


@pytest.mark.parametrize("seed", range(2))
def test_traces_and_dumps_read_equal_in_both_packages(seed, tmp_path, monkeypatch):
    """A trace and a flight dump written by each package from the same
    seeded records: both packages' ``validate_trace``, ``validate_dump``,
    ``causal.analyze`` and ``profile.analyze_trace`` return equal dicts on
    each file."""
    monkeypatch.setenv("MPIT_OBS_FLIGHT", str(tmp_path))
    files = {}
    for name, pkg_obs, tr in (("torch", obs, obs_trace), ("jax", jobs, jtrace)):
        reset_both(True)
        try:
            _seeded_records(pkg_obs, seed)
            files[name] = (tr.write_rank_trace(str(tmp_path / f"{name}.json"), 5,
                                               role="worker"),
                           pkg_obs.get_flight().dump("seeded"))
        finally:
            reset_both(None)
    from mpit_tpu.obs import causal as jcausal
    from mpit_tpu.obs import profile as jprofile
    from mpit_tpu_torch.obs import causal as obs_causal

    for trace_path, dump_path in files.values():
        assert obs_trace.validate_trace(trace_path) == jtrace.validate_trace(trace_path)
        assert obs_flight.validate_dump(dump_path) == jflight.validate_dump(dump_path)
        assert obs_causal.analyze(trace_path) == jcausal.analyze(trace_path)
        assert obs_profile.analyze_trace(trace_path) == jprofile.analyze_trace(trace_path)
    assert obs_trace.validate_trace(files["torch"][0])["ops"] == \
        jtrace.validate_trace(files["jax"][0])["ops"]
