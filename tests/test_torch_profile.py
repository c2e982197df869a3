"""The port's CPU/utilization attribution plane (``obs/profile.py``):
twins of ``tests/test_profile.py``'s six classes, and the profile report
across the packages.

The port's worker pool (``comm/pool.py``) is process-global, made by the
first chunked transfer or cell XOR in a process.  These twins run in a
process without one (an autouse fixture sets any pool aside), so the
counter tracks are the scheduler's two (``sched_runq``, ``task_cpu``) and
the resource section has no ``pool`` key: what the JAX package emits in a
process without a pool; ``test_pool_tracks_with_a_pool`` holds the tracks a
pool adds.  Across the packages the rule is equality:
each package's ``profile.analyze_trace`` on the other package's trace (a
synthetic one from a numpy seed, and a real profiled port gang's) returns
an equal dict.
"""

import json
import threading

import numpy as np
import pytest

import mpit_tpu.obs as jobs
from mpit_tpu.obs import flight as jflight
from mpit_tpu.obs import profile as jprofile
from mpit_tpu.obs import trace as jtrace
from mpit_tpu_torch import obs
from mpit_tpu_torch.aio import Scheduler
from mpit_tpu_torch.comm.local import LocalRouter
from mpit_tpu_torch.ft import FTConfig
from mpit_tpu_torch.obs import causal as obs_causal
from mpit_tpu_torch.obs import flight as obs_flight
from mpit_tpu_torch.obs import metrics as obs_metrics
from mpit_tpu_torch.obs import profile as obs_profile
from mpit_tpu_torch.obs import spans as obs_spans
from mpit_tpu_torch.obs import trace as obs_trace
from mpit_tpu_torch.obs.__main__ import main as obs_cli
from mpit_tpu_torch.ps import ParamClient, ParamServer


@pytest.fixture(autouse=True)
def no_port_pool():
    """A process without the port's worker pool: one made by an earlier test
    in this process is set aside for the test and put back after."""
    from mpit_tpu_torch.comm import pool

    saved, pool._GLOBAL = pool._GLOBAL, None
    try:
        yield
    finally:
        made, pool._GLOBAL = pool._GLOBAL, saved
        if made is not None and made is not saved:
            made.close()


@pytest.fixture
def prof_on():
    """obs + profiling on in the port (both packages reset), everything
    reset on the way out.  obs.configure(reset=True) clears the profile
    override too, so the profile flip comes second."""
    obs.configure(enabled=True, reset=True)
    jobs.configure(enabled=None, reset=True)
    obs_profile.configure(enabled=True, reset=True)
    try:
        yield obs_profile.get_profiler()
    finally:
        obs.configure(enabled=None, reset=True)


def burn_task(rounds=40, width=4000):
    acc = 0
    for _ in range(rounds):
        acc += sum(i * i for i in range(width))
        yield
    return acc


# ---------------------------------------------------------------------------
# the profiler primitive + enablement


class TestProfilerPrimitive:
    def test_profiling_off_even_when_obs_on(self):
        obs.configure(enabled=True, reset=True)
        try:
            assert obs.obs_enabled()
            assert not obs_profile.profile_enabled()
            assert obs_profile.get_profiler() is obs_profile.NULL_PROFILER
        finally:
            obs.configure(enabled=None, reset=True)

    def test_env_enablement_implies_obs(self, monkeypatch):
        monkeypatch.setenv(obs_profile.PROFILE_ENV, "1")
        assert obs_metrics.obs_enabled()
        assert obs_profile.profile_enabled()
        monkeypatch.setenv(obs_profile.PROFILE_ENV, "0")
        assert not obs_profile.profile_enabled()
        assert obs_profile.PROFILE_ENV == jprofile.PROFILE_ENV

    def test_step_attributes_and_counts(self, prof_on):
        prof = prof_on
        prof.step("apply", 0.010)
        prof.step("apply", 0.005)
        prof.step("encode", 0.002)
        prof.step("noise", -0.5)
        prof.step("noise", 0.0)
        assert prof.task_cpu["apply"] == pytest.approx(0.015)
        assert "noise" not in prof.task_cpu
        assert prof.cpu_seconds == pytest.approx(0.017)
        c = obs.get_registry().counter("mpit_sched_cpu_seconds_total")
        assert c.value == pytest.approx(0.017)
        assert prof.top_tasks(1) == [["apply", pytest.approx(15000.0)]]

    def test_sample_emits_the_no_pool_tracks_and_throttles(self, prof_on):
        prof = prof_on
        prof._interval = 0.0
        prof.step("t", 0.001)
        prof.sample(3)
        tracks = {track for _, track, _ in prof.samples}
        assert tracks == {"sched_runq", "task_cpu"}  # no pool: no pool tracks
        assert obs_profile.TRACKS == jprofile.TRACKS
        assert prof.last_runq == 3
        assert obs.get_registry().gauge("mpit_sched_runq").value == 3
        n = len(prof.samples)
        prof._interval = 3600.0
        prof.sample(9)
        assert len(prof.samples) == n and prof.last_runq == 3

    def test_pool_tracks_with_a_pool(self, prof_on):
        """With a threaded pool in the process the sampler adds the pool's
        two tracks and the resource section its ``pool`` key, as the JAX
        package's does."""
        from mpit_tpu_torch.comm import pool

        p = pool.configure(2)
        if p.serial:
            pytest.skip("no native library: the pool is serial")
        prof_on._interval = 0.0
        for _ in range(3):  # utilization is windowed: busy over two samples
            p.submit_xor(np.zeros(1 << 16, np.uint8), np.ones(1 << 16, np.uint8),
                         np.empty(1 << 16, np.uint8)).result()
            prof_on.sample(1)
        tracks = {track for _, track, _ in prof_on.samples}
        assert {"pool_util", "pool_depth"} <= tracks <= set(obs_profile.TRACKS)
        assert set(obs_profile.resource_snapshot()["pool"]) >= {
            "threads", "depth", "busy_seconds"}

    def test_cpu_now_is_a_real_clock(self, prof_on):
        t0 = prof_on.cpu_now()
        sum(i * i for i in range(50_000))
        assert prof_on.cpu_now() >= t0

    def test_resource_snapshot_sections(self, prof_on):
        prof_on.step("hot", 0.004)
        prof_on._interval = 0.0
        prof_on.sample(2)
        snap = obs_profile.resource_snapshot()
        assert snap == {"sched": {"runq": 2, "cpu_seconds": pytest.approx(0.004)},
                        "top_tasks": [["hot", pytest.approx(4000.0)]]}
        obs.configure(enabled=None, reset=True)
        assert obs_profile.resource_snapshot() == {}  # no pool, profiling off


# ---------------------------------------------------------------------------
# scheduler integration


class TestSchedulerStamping:
    def test_tasks_carry_cpu(self, prof_on):
        prof = prof_on
        prof._interval = 0.0
        sched = Scheduler(idle_usec=0)
        task = sched.spawn(burn_task(), name="burn")
        sched.wait()
        assert task.cpu_s > 0.0
        assert prof.task_cpu.get("burn", 0.0) > 0.0
        assert prof.cpu_seconds > 0.0
        rows = {name: cpu for name, _, _, _, cpu in obs_spans.get_recorder().tasks}
        assert rows["burn"] > 0.0
        assert any(track == "sched_runq" for _, track, _ in prof.samples)

    def test_disabled_scheduler_stamps_nothing(self):
        obs.configure(enabled=True, reset=True)
        try:
            sched = Scheduler(idle_usec=0)
            task = sched.spawn(burn_task(rounds=3), name="burn")
            sched.wait()
            rows = {name: cpu for name, _, _, _, cpu in obs_spans.get_recorder().tasks}
            assert rows["burn"] == 0.0 and task.cpu_s == 0.0
        finally:
            obs.configure(enabled=None, reset=True)


# ---------------------------------------------------------------------------
# counter-track round trips


def _sampled_trace(tmp_path, prof, rank, n=4):
    prof._interval = 0.0
    for i in range(n):
        prof.step(f"task{rank}", 0.001)
        prof.sample(i)
    path = str(tmp_path / f"trace.rank{rank}.json")
    obs_trace.write_rank_trace(path, rank=rank, role="server")
    return path


class TestCounterTracks:
    def test_round_trip_validates(self, prof_on, tmp_path):
        path = _sampled_trace(tmp_path, prof_on, rank=0)
        stats = obs_trace.validate_trace(path)
        assert stats["counters"] >= 8
        assert jtrace.validate_trace(path) == stats
        events = json.load(open(path))["traceEvents"]
        cs = [ev for ev in events if ev.get("ph") == "C"]
        assert cs and all(ev["cat"] == "resource" and ev["tid"] == 0
                          and isinstance(ev["args"]["value"], (int, float)) for ev in cs)
        assert {ev["name"] for ev in cs} == {"sched_runq", "task_cpu"}

    def test_malformed_counter_rejected(self, prof_on, tmp_path):
        obj = json.load(open(_sampled_trace(tmp_path, prof_on, rank=0)))
        for ev in obj["traceEvents"]:
            if ev.get("ph") == "C":
                ev["args"] = {}
                break
        with pytest.raises(ValueError, match="without numeric args.value"):
            obs_trace.validate_trace(obj)
        with pytest.raises(ValueError, match="without numeric args.value"):
            jtrace.validate_trace(obj)

    def test_merge_keeps_per_rank_tracks_distinct(self, prof_on, tmp_path):
        p0 = _sampled_trace(tmp_path, prof_on, rank=0)
        p1 = _sampled_trace(tmp_path, prof_on, rank=1)
        merged = str(tmp_path / "trace.json")
        obs_trace.merge_traces(merged, [p0, p1])
        assert obs_trace.validate_trace(merged)["counters"] > 0
        by_pid = {}
        for ev in json.load(open(merged))["traceEvents"]:
            if ev.get("ph") == "C":
                by_pid.setdefault(ev["pid"], set()).add(ev["name"])
        assert set(by_pid) == {0, 1}
        assert all("sched_runq" in tracks for tracks in by_pid.values())
        report = obs_profile.analyze_trace(merged)
        assert report == jprofile.analyze_trace(merged)
        assert report["counter_events"] > 0
        assert report["ranks"]["0"]["counter_samples"]["task_cpu"] >= 4


# ---------------------------------------------------------------------------
# cpu attribution math (non-negative, sums-to-wall by construction)


def _synthetic_span_events(cpu_encode, cpu_span):
    return [
        {"ph": "B", "cat": "ps_op", "name": "GRAD", "pid": 0, "tid": 1,
         "ts": 1000.0, "args": {"side": "client", "peer": 1}},
        {"ph": "X", "cat": "ps_phase", "name": "GRAD.encode", "pid": 0,
         "tid": 1, "ts": 1000.0, "dur": 100.0, "args": {"cpu_us": cpu_encode}},
        {"ph": "E", "cat": "ps_op", "name": "GRAD", "pid": 0, "tid": 1,
         "ts": 1300.0, "args": {"outcome": "ok", "cpu_us": cpu_span}},
    ]


def seeded_profile_trace(seed, ranks=3, ops=20):
    """A multi-rank trace from a numpy seed: client and server spans with
    marked phases and cpu riders (some out of range: the clamps), task
    lifecycles, and the two counter tracks per rank."""
    rng = np.random.default_rng(seed)
    events = []
    for pid in range(ranks):
        t = 1_000.0 + float(rng.integers(0, 500))
        side = "server" if pid == 0 else "client"
        events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                       "args": {"name": f"rank {pid} ({side})"}})
        for i in range(ops):
            op = "GRAD" if rng.random() < 0.6 else "PARAM"
            phases = ["encode", "send", "ack"] if side == "client" else ["apply", "ack"]
            durs = rng.exponential(150.0, len(phases)) + 1.0
            events.append({"ph": "B", "cat": "ps_op", "name": op, "pid": pid, "tid": 1,
                           "ts": t, "args": {"side": side, "peer": 0 if pid else 1,
                                             "rank": pid, "epoch": 0, "seq": i + 1}})
            tt = t
            for phase, dur in zip(phases, durs):
                events.append({"ph": "X", "cat": "ps_phase", "name": f"{op}.{phase}",
                               "pid": pid, "tid": 1, "ts": tt, "dur": float(dur),
                               "args": {"cpu_us": float(rng.normal(dur * 0.6, dur))}})
                tt += float(dur)
            events.append({"ph": "E", "cat": "ps_op", "name": op, "pid": pid, "tid": 1,
                           "ts": tt, "args": {"outcome": "ok",
                                              "cpu_us": float(rng.normal(100.0, 200.0))}})
            events.append({"ph": "X", "cat": "task", "name": f"pump:{i % 2}", "pid": pid,
                           "tid": 2, "ts": t, "dur": tt - t,
                           "args": {"state": "DONE", "cpu_us": float(rng.uniform(0, 50))}})
            for k, track in enumerate(("sched_runq", "task_cpu")):
                events.append({"ph": "C", "cat": "resource", "name": track, "pid": pid,
                               "tid": 0, "ts": t + k,
                               "args": {"value": float(rng.integers(0, 8))}})
            t = tt + float(rng.exponential(500.0))
    events.sort(key=lambda e: e.get("ts", -1.0))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"ranks": {str(p): {"role": "server" if p == 0 else "worker",
                                             "metrics": {}} for p in range(ranks)}}}


class TestCpuAttribution:
    @pytest.mark.parametrize("cpu_encode,cpu_span", [
        (40.0, 250.0), (500.0, 900.0), (-30.0, -1.0)])
    def test_non_negative_and_sums_to_wall(self, cpu_encode, cpu_span):
        events = _synthetic_span_events(cpu_encode, cpu_span)
        attr = obs_causal.cpu_attribution(obs_causal.extract_spans(events))
        assert attr == jobs.causal.cpu_attribution(jobs.causal.extract_spans(events))
        rows = attr["GRAD/client"]
        for row in rows.values():
            assert row["cpu_us"] >= 0.0 and row["off_cpu_us"] >= 0.0
            assert row["cpu_us"] + row["off_cpu_us"] == pytest.approx(row["wall_us"])
        assert rows["encode"]["wall_us"] == pytest.approx(100.0)
        assert rows["encode"]["cpu_us"] == pytest.approx(min(max(cpu_encode, 0.0), 100.0))
        assert rows["(span)"]["wall_us"] == pytest.approx(300.0)
        assert rows["(span)"]["cpu_us"] == pytest.approx(min(max(cpu_span, 0.0), 300.0))

    def test_no_riders_means_none(self):
        events = _synthetic_span_events(10.0, 20.0)
        for ev in events:
            ev.get("args", {}).pop("cpu_us", None)
        assert obs_causal.cpu_attribution(obs_causal.extract_spans(events)) is None

    def test_analyze_trace_ops_table(self):
        trace = {"traceEvents": _synthetic_span_events(40.0, 250.0), "otherData": {}}
        report = obs_profile.analyze_trace(trace)
        assert report == jprofile.analyze_trace(json.loads(json.dumps(trace)))
        op = report["ops"]["GRAD/client"]
        assert op["count"] == 1
        assert op["cpu_us"] + op["off_cpu_us"] == pytest.approx(op["wall_us"])
        assert report["cpu_phases"]["GRAD/client"]["encode"]["cpu_us"] == \
            pytest.approx(40.0)

    @pytest.mark.parametrize("seed", range(3))
    def test_seeded_traces_report_equal_in_both_packages(self, seed):
        trace = seeded_profile_trace(seed)
        report = obs_profile.analyze_trace(json.loads(json.dumps(trace)))
        assert report == jprofile.analyze_trace(json.loads(json.dumps(trace)))
        assert report["counter_events"] == 3 * 20 * 2
        assert obs_profile.render_profile(report) == jprofile.render_profile(report)


# ---------------------------------------------------------------------------
# the profile CLI


class TestProfileCLI:
    def test_report_and_json(self, prof_on, tmp_path, capsys):
        sp = obs_spans.get_recorder().op("GRAD", peer=1, side="client", epoch=0)
        sp.mark("encode")
        sp.end("ok")
        path = _sampled_trace(tmp_path, prof_on, rank=0)
        assert obs_cli(["profile", path, "--require-counters"]) == 0
        out = capsys.readouterr().out
        assert "counter sample" in out and "rank 0" in out
        assert obs_cli(["profile", path, "--json"]) == 0
        report = json.loads(capsys.readouterr().out)
        assert report["counter_events"] >= 8
        assert "GRAD/client" in report["ops"]

    def test_require_counters_gates(self, tmp_path, capsys):
        obs.configure(enabled=True, reset=True)
        try:
            path = str(tmp_path / "bare.json")
            obs_trace.write_rank_trace(path, rank=0)
        finally:
            obs.configure(enabled=None, reset=True)
        assert obs_cli(["profile", path]) == 0
        capsys.readouterr()
        assert obs_cli(["profile", path, "--require-counters"]) == 1

    def test_unreadable_trace_is_rc2(self, tmp_path):
        assert obs_cli(["profile", str(tmp_path / "missing.json")]) == 2


def test_a_profiled_port_gang_reports_equal_in_both_packages(prof_on, tmp_path):
    """A framed, profiled port gang (2 servers, 2 clients, 5 rounds): its
    trace validates under both validators, carries the two counter tracks
    and cpu riders, and both packages' profile reports are equal."""
    router = LocalRouter(4)
    servers = [ParamServer(r, [2, 3], router.endpoint(r), rule="add", device="cpu",
                           ft=FTConfig(rejoin=True)) for r in (0, 1)]
    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in threads:
        t.start()
    clients = [ParamClient(r, [0, 1], router.endpoint(r), seed_servers=(r == 2),
                           ft=FTConfig(op_deadline_s=30.0)) for r in (2, 3)]
    rng = np.random.default_rng(3)
    params = [rng.normal(size=64).astype(np.float32), np.zeros(64, np.float32)]
    starters = [threading.Thread(target=c.start, args=(p, np.zeros_like(p)), daemon=True)
                for c, p in zip(clients, params)]
    for t in starters:
        t.start()
    for t in starters:
        t.join(30)
    for _ in range(5):
        for c in clients:
            c.async_recv_param()
            c.grad[:] = rng.normal(size=64).astype(np.float32)
            c.async_send_grad()
            c.wait()
    for c in clients:
        c.stop()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    path = obs_trace.write_rank_trace(str(tmp_path / "gang.json"), 0, role="gang")
    assert obs_trace.validate_trace(path) == jtrace.validate_trace(path)
    report = obs_profile.analyze_trace(path)
    assert report == jprofile.analyze_trace(path)
    assert report["counter_events"] > 0
    assert {"GRAD/client", "GRAD/server"} <= set(report["ops"])
    assert "pool" not in report["ranks"]["0"] or report["ranks"]["0"]["pool"] is None


# ---------------------------------------------------------------------------
# flight-dump resources section


class TestFlightResources:
    def test_stall_dump_carries_resources(self, prof_on, tmp_path, monkeypatch):
        monkeypatch.setenv(obs_flight.ENV_DIR, str(tmp_path))
        prof_on.step("stuck", 0.003)
        prof_on._interval = 0.0
        prof_on.sample(1)
        fl = obs_flight.get_flight()
        fl.record("task", name="stuck", state="RUNNING")
        path = fl.dump("scheduler_stall")
        stats = obs_flight.validate_dump(path)
        assert stats["reason"] == "scheduler_stall"
        assert jflight.validate_dump(path) == stats
        obj = json.load(open(path))
        assert obj["resources"]["sched"]["runq"] == 1
        assert obj["resources"]["top_tasks"][0][0] == "stuck"
        assert "pool" not in obj["resources"]  # the JAX shape with no pool

    def test_validator_enforces_shape(self, prof_on, tmp_path, monkeypatch):
        monkeypatch.setenv(obs_flight.ENV_DIR, str(tmp_path))
        good = json.load(open(obs_flight.get_flight().dump("scheduler_stall")))
        for mutate, match in (
                (lambda d: d.pop("resources"), "no resources section"),
                (lambda d: d["resources"].__setitem__("pool", {"threads": 4}),
                 "resources.pool"),
                (lambda d: d["resources"].__setitem__("sched", {"runq": 0}),
                 "resources.sched"),
                (lambda d: d["resources"].__setitem__("top_tasks", [["t"]]), "top_tasks")):
            bad = json.loads(json.dumps(good))
            mutate(bad)
            with pytest.raises(ValueError, match=match):
                obs_flight.validate_dump(bad)
            with pytest.raises(ValueError, match=match):
                jflight.validate_dump(bad)
        other = json.loads(json.dumps(good))
        other["reason"] = "retry_exhausted"
        other.pop("resources")
        assert obs_flight.validate_dump(other) == jflight.validate_dump(other)
