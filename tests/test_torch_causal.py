"""Causal op tracing in the port — the clock estimator, the FLAG_TIMING
wire, the joiner and the latency decomposition — against the JAX package:
twins of ``tests/test_causal.py``, and the timed gangs across packages.

- The clock estimator, float for float against the JAX estimator on the
  same exchanges from a numpy seed.
- The timing wire, byte for byte: a port gang and a JAX gang on the same
  deterministic per-thread clock send the same stamped frames and tails on
  every channel.
- The analyzer, by equality: each package's ``causal.analyze`` on a
  synthetic trace from a numpy seed and on a real port gang's trace return
  equal dicts.
- Mixed timed gangs: a port client against a JAX server and the other way
  round, in lockstep rounds, end bitwise equal to the all-JAX timed gang;
  each package records its half, writes it with its own exporter, and the
  halves merge and join (join rate 1.0, no violations) under either
  package's merger and analyzer.
- obs on and obs off give the same bits: a timed, traced, profiled
  lockstep Adam gang of the port ends bitwise equal to the same gang with
  obs off, with its applied server GRAD spans equal to its
  ``grads_applied`` and to the calls of the K3 wrapper.
"""

import json
import threading
import zlib

import numpy as np
import pytest
import torch

import mpit_tpu.obs as jobs
from mpit_tpu.comm.local import LocalRouter as JaxRouter
from mpit_tpu.ft import FTConfig as JaxFTConfig
from mpit_tpu.obs import causal as jcausal
from mpit_tpu.obs import clock as jclock
from mpit_tpu.obs import trace as jtrace
from mpit_tpu.ps import ParamClient as JaxClient
from mpit_tpu.ps import ParamServer as JaxServer
from mpit_tpu_torch import obs
from mpit_tpu_torch.comm.local import LocalRouter
from mpit_tpu_torch.ft import (
    ACK_TIMING_WORDS,
    FLAG_FRAMED,
    FLAG_TIMING,
    FaultPlan,
    FaultyTransport,
    FTConfig,
    hdr_bytes,
    pack_reply_stamps,
    pack_tx_stamp,
    reply_hdr_bytes,
    unpack_reply_stamps,
    unpack_tx_stamp,
)
from mpit_tpu_torch.obs import causal as obs_causal
from mpit_tpu_torch.obs import clock as obs_clock
from mpit_tpu_torch.obs import profile as obs_profile
from mpit_tpu_torch.obs import spans as obs_spans
from mpit_tpu_torch.obs import trace as obs_trace
from mpit_tpu_torch.ps import ParamClient, ParamServer, tags

torch.set_num_threads(1)

#: fast retry posture with the timing extension on (router speed)
TIMED = dict(op_deadline_s=0.25, max_retries=8, backoff_base_s=0.005,
             backoff_cap_s=0.02, timing=True)


def reset_both(enabled):
    obs.configure(enabled=enabled, reset=True)
    jobs.configure(enabled=enabled, reset=True)


@pytest.fixture
def obs_on():
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
# clock estimator + wire primitives


class TestClockEstimator:
    def test_symmetric_exchange_recovers_offset_exactly(self):
        clock = obs_clock.PeerClock()
        t1 = 1_000_000
        assert clock.add(t1, t1 + 100 + 5000, t1 + 130 + 5000, t1 + 230)
        assert clock.offset_us == pytest.approx(5000.0)
        assert clock.uncertainty_us == pytest.approx(100.0)

    def test_asymmetry_error_stays_within_rtt_bound(self):
        clock = obs_clock.PeerClock()
        skew, out, back = -7000, 20, 380
        t1 = 2_000_000
        clock.add(t1, t1 + out + skew, t1 + out + skew + 10, t1 + out + 10 + back)
        assert abs(clock.offset_us - skew) <= clock.uncertainty_us

    def test_min_rtt_sample_wins(self):
        clock = obs_clock.PeerClock()
        t1 = 1_000_000
        clock.add(t1, t1 + 500, t1 + 510, t1 + 1010)
        assert clock.rtt_us == pytest.approx(1000.0)
        assert clock.add(t1 + 5000, t1 + 5100, t1 + 5110, t1 + 5210)
        assert clock.rtt_us == pytest.approx(200.0)
        assert not clock.add(t1 + 9000, t1 + 9400, t1 + 9410, t1 + 9810)
        assert clock.rtt_us == pytest.approx(200.0)

    def test_garbage_exchange_rejected(self):
        clock = obs_clock.PeerClock()
        assert not clock.add(2_000_000, 1_000_000, 3_000_000, 2_000_100)
        assert clock.samples == 1 and clock.accepted == 0

    def test_drift_aging_lets_fresh_samples_replace_stale_best(self):
        clock = obs_clock.PeerClock()
        t1 = 1_000_000
        clock.add(t1, t1 + 50, t1 + 60, t1 + 110)
        t2 = t1 + 10_000_000
        assert clock.add(t2, t2 + 250, t2 + 260, t2 + 510)
        assert clock.rtt_us == pytest.approx(500.0)

    @pytest.mark.parametrize("seed", range(4))
    def test_float_for_float_against_the_jax_estimator(self, seed):
        """The same exchanges (per-peer skew, asymmetric jittered wire,
        garbage echoes, drift over minutes) into both estimators: every
        verdict and every snapshot float equal."""
        rng = np.random.default_rng(seed)
        est, jest = obs_clock.ClockEstimator(), jclock.ClockEstimator()
        skews = rng.normal(0.0, 50_000.0, 3)
        t = 1_000_000.0 + rng.integers(0, 10 ** 9)
        for _ in range(400):
            peer = int(rng.integers(0, 3))
            t += float(rng.exponential(200_000.0))
            out, back = rng.exponential(300.0, 2) + 5.0
            turn = float(rng.exponential(50.0))
            t1 = int(t)
            t2 = int(t1 + out + skews[peer])
            t3 = int(t2 + turn)
            t4 = int(t3 - skews[peer] + back)
            if rng.random() < 0.05:  # an echo of another attempt
                t1, t4 = t4, t1
            assert est.add_exchange(peer, t1, t2, t3, t4) == \
                jest.add_exchange(peer, t1, t2, t3, t4)
        assert est.snapshot() == jest.snapshot()
        for peer in est.peers:
            a, b = est.peers[peer], jest.peers[peer]
            assert (a.offset_us, a.uncertainty_us, a.rtt_us) == \
                (b.offset_us, b.uncertainty_us, b.rtt_us)

    def test_estimator_registry_snapshot(self):
        est = obs_clock.ClockEstimator()
        est.add_exchange(0, 1_000_000, 1_000_100, 1_000_110, 1_000_210)
        obs_clock.register("clienttest", est)
        snap = obs_clock.snapshot_all()
        assert "clienttest" in snap and "0" in snap["clienttest"]
        obs_clock.reset()
        assert "clienttest" not in obs_clock.snapshot_all()


class RecordingRouter:
    """Wraps a router: every endpoint records what it sends, as
    ``(src, dst, tag) -> [bytes, ...]``."""

    def __init__(self, router):
        self.router = router
        self.sent = {}

    def endpoint(self, rank):
        ep = self.router.endpoint(rank)
        sent = self.sent

        class Recording:
            def __getattr__(self, name):
                return getattr(ep, name)

            def isend(self, payload, dst, tag):
                data = payload if isinstance(payload, (bytes, bytearray)) else \
                    np.ascontiguousarray(payload).view(np.uint8).tobytes()
                sent.setdefault((rank, dst, tag), []).append(bytes(data))
                return ep.isend(payload, dst, tag)

        return Recording()


class ThreadClock:
    """A deterministic ``wall_us``: each thread counts its own calls from
    its own base, so a lockstep gang stamps the same values in every run
    whatever the threads' interleaving."""

    def __init__(self):
        self.state = threading.local()

    def __call__(self):
        st = self.state
        if not hasattr(st, "t"):
            name = threading.current_thread().name.encode()
            st.t = (zlib.crc32(name) % 1000 + 1) * 10 ** 9
        st.t += 1000
        return st.t


def lockstep_gang(server_pkg, client_pkg, w0, gtab, router, client_ft=TIMED,
                  rule="add", rounds=None, on_round=None):
    """2 servers (ranks 0, 1) and 2 clients (2, 3) of the named packages
    on ``router``; every round each client pulls, then pushes its GRAD and
    waits, in client order (the ``tests/test_torch_ft_gang.py`` schedule).
    Server threads are named by rank.  Returns (client 0's final params,
    servers, clients)."""
    mods = {"jax": (JaxFTConfig, JaxServer, JaxClient),
            "torch": (FTConfig, ParamServer, ParamClient)}
    sft, server_cls, _ = mods[server_pkg]
    cft, _, client_cls = mods[client_pkg]
    servers = []
    for r in (0, 1):
        kw = {"device": "cpu"} if server_pkg == "torch" else {}
        servers.append(server_cls(r, [2, 3], router.endpoint(r), rule=rule,
                                  ft=sft(rejoin=True), **kw))
    threads = [threading.Thread(target=s.start, daemon=True, name=f"server{s.rank}")
               for s in servers]
    for t in threads:
        t.start()
    clients = [client_cls(r, [0, 1], router.endpoint(r), seed_servers=(i == 0),
                          ft=cft(**client_ft)) for i, r in enumerate((2, 3))]
    params = [w0.copy(), np.zeros_like(w0)]
    starters = [threading.Thread(target=c.start, args=(p, np.zeros_like(p)), daemon=True,
                                 name=f"start{c.rank}") for c, p in zip(clients, params)]
    for t in starters:
        t.start()
    join_all(starters)
    try:
        for rnd in range(gtab.shape[1] if rounds is None else rounds):
            for i, c in enumerate(clients):
                c.async_recv_param()
                c.wait()
                c.grad[:] = gtab[i, rnd] if on_round is None else on_round(i, rnd, params[i])
                c.async_send_grad()
                c.wait()
        clients[0].async_recv_param()
        clients[0].wait()
        for c in clients:
            c.stop()
        join_all(threads)
    finally:
        for s in servers:
            s.live.stop()
    return params[0].copy(), servers, clients


class TestTimingWire:
    def test_header_sizes(self):
        assert hdr_bytes(False, False) == 16
        assert hdr_bytes(True, False) == 24
        assert hdr_bytes(False, True) == 24
        assert hdr_bytes(True, True) == 32
        assert reply_hdr_bytes(False, True) == 40
        assert reply_hdr_bytes(True, True) == 48
        assert ACK_TIMING_WORDS == 5
        assert FLAG_TIMING == 8 and not (FLAG_TIMING & (FLAG_FRAMED | 6))

    def test_tx_stamp_roundtrip_last_header_word(self):
        buf = np.zeros(64, np.uint8)
        for hdr in (24, 32):
            pack_tx_stamp(buf, hdr, 123456789)
            assert unpack_tx_stamp(buf, hdr) == 123456789
            assert buf[:16].view(np.int64).tolist() == [0, 0]

    def test_reply_stamps_roundtrip(self):
        buf = np.zeros(64, np.uint8)
        pack_reply_stamps(buf, 24, 1, 2, 3)
        assert unpack_reply_stamps(buf, 24) == (1, 2, 3)

    def test_timing_without_framing_is_inert(self):
        cfg = FTConfig(timing=True)
        assert not cfg.timing_track
        client = ParamClient(1, [0], LocalRouter(2).endpoint(1), ft=cfg)
        assert not client._timing and client._hdr == 0

    @pytest.mark.parametrize("staleness", [False, True])
    def test_stamped_frames_and_tails_are_the_jax_packages(self, staleness,
                                                           monkeypatch):
        """A port gang and a JAX gang on the FLAG_TIMING wire (with and
        without the staleness word), each on the same deterministic
        per-thread clock: every channel carries the same bytes — INIT v3
        with bit 3, stamped GRAD and PARAM_REQ frames, 40-byte acks and
        the PARAM replies' tails."""
        rng = np.random.default_rng(5)
        w0 = rng.normal(size=48).astype(np.float32)
        gtab = rng.normal(size=(2, 3, 48)).astype(np.float32)
        ft = dict(TIMED, staleness=staleness)
        sent = {}
        for pkg, router in (("torch", LocalRouter(4)), ("jax", JaxRouter(4))):
            fake = ThreadClock()
            monkeypatch.setattr(obs_clock, "wall_us", fake)
            monkeypatch.setattr(jclock, "wall_us", fake)
            rec = RecordingRouter(router)
            lockstep_gang(pkg, pkg, w0, gtab, rec, client_ft=ft)
            sent[pkg] = rec.sent
        assert sent["torch"].keys() == sent["jax"].keys()
        for key in sent["jax"]:
            assert sent["torch"][key] == sent["jax"][key], key
        init = np.frombuffer(sent["torch"][(2, 0, tags.INIT)][0], np.int64)
        assert init.size == 5 and int(init[4]) & FLAG_TIMING
        ack = np.frombuffer(sent["torch"][(0, 2, tags.GRAD_ACK)][0], np.int64)
        assert ack.size == ACK_TIMING_WORDS and ack[3] > 0 and ack[4] > ack[3]

    def test_heartbeat_echo_bytes_are_the_jax_packages(self, monkeypatch):
        """A timed beat through a port server and a JAX server: the same
        HEARTBEAT_ECHO bytes back."""
        echoes = {}
        for pkg, router, server_cls in (("torch", LocalRouter(2), ParamServer),
                                        ("jax", JaxRouter(2), JaxServer)):
            monkeypatch.setattr(obs_clock, "wall_us", lambda: 777)
            monkeypatch.setattr(jclock, "wall_us", lambda: 777)
            kw = {"device": "cpu"} if pkg == "torch" else {}
            server = server_cls(0, [1], router.endpoint(0), ft=(
                FTConfig if pkg == "torch" else JaxFTConfig)(rejoin=True), **kw)
            init = np.asarray([0, 8, 0, 0, FLAG_FRAMED | 2 | FLAG_TIMING], np.int64)
            server._alloc_client(1, server._negotiate(1, init.tobytes()))
            wire = router.endpoint(1)
            gen = server._recv_heartbeat(1)
            wire.send(np.asarray([0, 1, 555], np.int64), 0, tags.HEARTBEAT)
            for _ in range(200):
                next(gen)
                if wire.iprobe(0, tags.HEARTBEAT_ECHO):
                    break
            out = np.zeros(ACK_TIMING_WORDS, np.int64)
            wire.recv(0, tags.HEARTBEAT_ECHO, out=out)
            echoes[pkg] = out.tobytes()
            server.live.stop()
        assert echoes["torch"] == echoes["jax"]
        assert np.frombuffer(echoes["torch"], np.int64).tolist() == [0, 1, 555, 777, 777]


# ---------------------------------------------------------------------------
# synthetic traces: known skew in, recovered offset + clean phases out


def synth_trace(skew_us, n_ops=3, clock_meta=None, rng=None):
    """A two-rank trace: client rank 3 drives ``n_ops`` GRADs against
    server rank 0, whose clock runs ``skew_us`` ahead.  With ``rng`` the
    wire, queue and apply times are drawn from it; else the reference
    test's fixed 50 us out, 50 back, 300 apply."""
    events = []
    for i in range(n_ops):
        if rng is None:
            out = back = 50.0
            queue, apply_us, encode, send = 20.0, 300.0, 100.0, 200.0
        else:
            out, back = rng.exponential(80.0, 2) + 5.0
            queue, apply_us = rng.exponential(40.0) + 1.0, rng.exponential(400.0) + 10.0
            encode, send = rng.exponential(120.0) + 1.0, rng.exponential(250.0) + 1.0
        c0 = 1_000_000.0 + i * 10_000
        send_done = c0 + encode + send
        s_recv = send_done + out + skew_us
        s_ack = s_recv + queue + apply_us
        ack_done = s_ack - skew_us + back
        events += [
            {"ph": "B", "name": "GRAD", "cat": "ps_op", "pid": 3, "tid": 1,
             "ts": c0, "args": {"rank": 3, "peer": 0, "side": "client",
                                "epoch": 0, "seq": i + 1}},
            {"ph": "X", "name": "GRAD.encode", "cat": "ps_phase", "pid": 3,
             "tid": 1, "ts": c0, "dur": encode},
            {"ph": "X", "name": "GRAD.send", "cat": "ps_phase", "pid": 3,
             "tid": 1, "ts": c0 + encode, "dur": send},
            {"ph": "X", "name": "GRAD.ack", "cat": "ps_phase", "pid": 3,
             "tid": 1, "ts": send_done, "dur": ack_done - send_done},
            {"ph": "E", "name": "GRAD", "cat": "ps_op", "pid": 3, "tid": 1,
             "ts": ack_done, "args": {"outcome": "ok"}},
            {"ph": "B", "name": "GRAD", "cat": "ps_op", "pid": 0, "tid": 1,
             "ts": s_recv, "args": {"rank": 0, "peer": 3, "side": "server",
                                    "epoch": 0, "seq": i + 1}},
            {"ph": "X", "name": "GRAD.apply", "cat": "ps_phase", "pid": 0,
             "tid": 1, "ts": s_recv + queue, "dur": apply_us - 10.0},
            {"ph": "X", "name": "GRAD.ack", "cat": "ps_phase", "pid": 0,
             "tid": 1, "ts": s_ack - 10.0, "dur": 10.0},
            {"ph": "E", "name": "GRAD", "cat": "ps_op", "pid": 0, "tid": 1,
             "ts": s_ack, "args": {"outcome": "applied"}},
        ]
    events.sort(key=lambda e: e["ts"])
    other = {}
    if clock_meta is not None:
        other["clock"] = clock_meta
    return {"traceEvents": events, "displayTimeUnit": "ms", "otherData": other}


def analyze_both(trace):
    """Each package's analyzer and validator on the same trace: equal
    dicts."""
    report = obs_causal.analyze(json.loads(json.dumps(trace)))
    assert report == jcausal.analyze(json.loads(json.dumps(trace)))
    assert obs_trace.validate_trace(json.loads(json.dumps(trace))) == \
        jtrace.validate_trace(json.loads(json.dumps(trace)))
    return report


class TestSyntheticJoin:
    @pytest.mark.parametrize("skew_us", [0.0, 37_000.0, -250_000.0])
    def test_injected_skew_recovered_within_bound(self, skew_us):
        report = analyze_both(synth_trace(skew_us))
        assert report["ops"]["join_rate"] == 1.0
        assert report["violations"] == []
        (entry,) = report["offsets"]
        assert entry["source"] == "derived"
        assert abs(entry["offset_us"] - skew_us) <= entry["uncertainty_us"]
        assert abs(entry["offset_us"] - skew_us) <= 200.0

    @pytest.mark.parametrize("seed", range(3))
    def test_seeded_traces_analyze_equal_in_both_packages(self, seed):
        rng = np.random.default_rng(seed)
        skew = float(rng.normal(0.0, 100_000.0))
        report = analyze_both(synth_trace(skew, n_ops=12, rng=rng))
        assert report["ops"]["joined"] == 12 and report["violations"] == []
        for d in report["chains"]:
            assert sum(d["phases"].values()) == pytest.approx(
                d["wall_us"], abs=d["uncertainty_us"] + 1.0)

    def test_phases_nonnegative_and_sum_to_wall(self):
        report = analyze_both(synth_trace(37_000.0))
        for d in report["chains"]:
            assert d["joined"]
            assert all(v >= 0.0 for v in d["phases"].values())
            assert sum(d["phases"].values()) == pytest.approx(
                d["wall_us"], abs=d["uncertainty_us"] + 1.0)

    def test_recorded_wire_offsets_preferred(self):
        meta = {"client3": {"0": {"offset_us": 37_000.0, "uncertainty_us": 25.0,
                                  "rtt_us": 50.0, "samples": 8, "accepted": 4}}}
        report = analyze_both(synth_trace(37_000.0, clock_meta=meta))
        (entry,) = report["offsets"]
        assert entry["source"] == "wire" and entry["offset_us"] == 37_000.0
        assert report["violations"] == []

    def test_flow_events_pair_and_validate(self, tmp_path):
        path = tmp_path / "synth.json"
        path.write_text(json.dumps(synth_trace(1000.0, n_ops=2)))
        out, jout = tmp_path / "flow.json", tmp_path / "jflow.json"
        assert obs_causal.emit_flow(str(path), str(out)) == 2 * 2 * 2
        jcausal.emit_flow(str(path), str(jout))
        assert out.read_text() == jout.read_text()
        obj = json.loads(out.read_text())
        starts = [e for e in obj["traceEvents"] if e["ph"] == "s"]
        finishes = [e for e in obj["traceEvents"] if e["ph"] == "f"]
        assert {e["id"] for e in starts} == {e["id"] for e in finishes}
        assert all(e.get("bp") == "e" for e in finishes)
        obs_trace.validate_trace(obj)

    def test_beyond_uncertainty_negative_phase_is_a_violation(self):
        meta = {"client3": {"0": {"offset_us": 0.0, "uncertainty_us": 5.0,
                                  "rtt_us": 10.0, "samples": 8, "accepted": 4}}}
        assert analyze_both(synth_trace(-30_000.0, clock_meta=meta))["violations"]

    def test_cli_json_and_min_join_gate(self, tmp_path, capsys):
        from mpit_tpu_torch.obs.__main__ import main as obs_cli

        path = tmp_path / "synth.json"
        path.write_text(json.dumps(synth_trace(500.0)))
        assert obs_cli(["analyze", str(path), "--json", "--min-join", "0.95"]) == 0
        payload = json.loads(capsys.readouterr().out)
        assert payload["ops"]["join_rate"] == 1.0
        assert payload["critical_path"]["client"] == 3
        obj = synth_trace(500.0)
        obj["traceEvents"] = [e for e in obj["traceEvents"]
                              if (e.get("args") or {}).get("side") != "server"
                              and e.get("pid") != 0]
        path2 = tmp_path / "halved.json"
        path2.write_text(json.dumps(obj))
        assert obs_cli(["analyze", str(path2), "--min-join", "0.95"]) == 1


# ---------------------------------------------------------------------------
# real port gangs: round trip, retries, legacy interop


def launch_timed_gang(nservers=2, nclients=2, client_plans=None, client_ft=TIMED):
    n = nservers + nclients
    router = LocalRouter(n)
    sranks, cranks = list(range(nservers)), list(range(nservers, n))
    servers = [ParamServer(r, cranks, router.endpoint(r), rule="add", device="cpu",
                           ft=FTConfig(rejoin=True)) for r in sranks]
    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in threads:
        t.start()
    clients, transports = [], []
    for i, r in enumerate(cranks):
        ep = router.endpoint(r)
        plan = (client_plans or {}).get(i)
        if plan is not None:
            ep = FaultyTransport(ep, plan)
        transports.append(ep)
        clients.append(ParamClient(r, sranks, ep, seed_servers=(r == cranks[0]),
                                   ft=FTConfig(**client_ft)))
    return servers, clients, threads, transports


def run_rounds(servers, clients, threads, rounds, size=64):
    rng = np.random.default_rng(7)
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


class TestGangRoundTrip:
    def test_timed_gang_trace_joins_and_decomposes(self, obs_on, tmp_path):
        servers, clients, threads, _ = launch_timed_gang()
        run_rounds(servers, clients, threads, rounds=4)
        path = str(tmp_path / "gang.json")
        obs_trace.write_rank_trace(path, rank=0, role="gang")
        report = obs_causal.analyze(path)
        assert report == jcausal.analyze(path)
        assert report["ops"]["completed"] > 0
        assert report["ops"]["join_rate"] == 1.0
        assert report["violations"] == []
        sources = {(e["client"], e["server"]): e["source"] for e in report["offsets"]}
        for c in (2, 3):
            for s in (0, 1):
                assert sources.get((c, s)) == "wire", sources
        for d in report["chains"]:
            assert all(v >= 0.0 for v in d["phases"].values())
            assert sum(d["phases"].values()) == pytest.approx(
                d["wall_us"], abs=max(d["uncertainty_us"], 1.0) + 1.0)
        obj = json.load(open(path))
        assert [e for e in obj["traceEvents"]
                if e["ph"] == "B" and "srv_recv_us" in (e.get("args") or {})]
        assert obj["otherData"]["clock"].keys() >= {"client2", "client3"}

    def test_estimator_offset_near_zero_same_process(self, obs_on):
        servers, clients, threads, _ = launch_timed_gang()
        run_rounds(servers, clients, threads, rounds=4)
        for c in clients:
            for srank in (0, 1):
                clock = c._clock.peers[srank]
                assert clock.accepted > 0
                assert abs(clock.offset_us) <= clock.uncertainty_us + 1.0
        keys = [k for k in obs_on.snapshot() if k.startswith("mpit_clock_offset_us")]
        assert len(keys) == 4


def simulate_grad_channel(plan, src, dst, rounds):
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


#: the drop plan's op deadline.  Only a dropped GRAD may time out here: an
#: ack that arrives after the deadline is resent too, one retry more than the
#: plan's drops, and the counts below then disagree.  Under a loaded host
#: (pytest -n 6) an ack took longer than TIMED's 0.25 s, so the plan's six
#: drops wait this long each instead.
DROP_DEADLINE_S = 2.0


class TestDropPlanAttempts:
    def test_retry_attempts_appear_as_separate_attempt_chains(self, obs_on, tmp_path):
        rounds, nservers = 4, 2
        plans = {0: FaultPlan(seed=0, drop_every=2, tags=frozenset({tags.GRAD}))}
        servers, clients, threads, _ = launch_timed_gang(
            client_plans=plans, client_ft=dict(TIMED, op_deadline_s=DROP_DEADLINE_S))
        run_rounds(servers, clients, threads, rounds)
        want_retries = sum(simulate_grad_channel(plans[0], clients[0].rank, dst, rounds)[1]
                           for dst in range(nservers))
        assert clients[0].retries == want_retries > 0
        path = str(tmp_path / "drop.json")
        obs_trace.write_rank_trace(path, rank=0, role="gang")
        events, _ = obs_causal.load_trace(path)
        chains, _ = obs_causal.join_spans(obs_causal.extract_spans(events))
        grad_chains = [c for c in chains if c.op == "GRAD" and c.key[1] == clients[0].rank]
        retried = [c for c in grad_chains if c.client.args.get("retries", 0) >= 1]
        assert retried, "the drop plan produced no retried GRAD chain"
        total = 0
        for chain in grad_chains:
            attempts = chain.attempts()
            assert len(attempts) == 1 + int(chain.client.args.get("retries", 0) or 0)
            assert chain.joined
            total += len(attempts)
        assert total == rounds * nservers + want_retries
        report = obs_causal.analyze(path)
        assert report == jcausal.analyze(path)
        assert report["violations"] == []
        by_key = {(d["client"], d["server"], d["seq"]): d
                  for d in report["chains"] if d["op"] == "GRAD"}
        for chain in retried:
            d = by_key[(chain.key[1], chain.key[2][1], chain.key[4])]
            assert d["phases"]["retry"] > 0.0


class TestLegacyInterop:
    def test_legacy_peers_negotiate_timing_off_per_pair(self, obs_on):
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
                        ft=FTConfig(**TIMED)),
            ParamClient(cranks[1], sranks, router.endpoint(cranks[1]), seed_servers=False,
                        ft=FTConfig()),
        ]
        assert clients[0]._timing and clients[0]._hdr == 24 and clients[0]._hdr_rx == 40
        assert not clients[1]._timing and clients[1]._hdr == 0
        run_rounds(servers, clients, threads, rounds)
        for s in servers:
            assert s._timing[cranks[0]] is True
            assert s._timing.get(cranks[1], False) is False
            assert s._ack_send[cranks[0]].size == ACK_TIMING_WORDS
            assert cranks[1] not in s._ack_send
        assert clients[0]._clock.peers and all(
            c.accepted for c in clients[0]._clock.peers.values())
        assert not clients[1]._clock.peers
        assert sum(s.grads_applied for s in servers) == rounds * 2 * nservers

    def test_heartbeat_echo_refreshes_clock_while_idle(self, obs_on):
        import time as _time

        ft = dict(op_deadline_s=0.25, heartbeat_s=0.01, timing=True,
                  backoff_base_s=0.005, backoff_cap_s=0.02)
        servers, clients, threads, _ = launch_timed_gang(client_ft=ft)
        started = False
        try:
            rng = np.random.default_rng(7)
            starters = []
            for i, c in enumerate(clients):
                p = (rng.normal(size=64).astype(np.float32) if i == 0
                     else np.zeros(64, np.float32))
                starters.append(threading.Thread(
                    target=c.start, args=(p, np.zeros(64, np.float32)), daemon=True))
            for t in starters:
                t.start()
            join_all(starters)
            started = True
            before = {s: clients[0]._clock.peer(s).samples for s in (0, 1)}
            deadline = _time.monotonic() + 20.0
            while _time.monotonic() < deadline:
                for c in clients:
                    c.ping()
                if all(clients[0]._clock.peer(s).samples > before[s] + 2 for s in (0, 1)):
                    break
                _time.sleep(0.002)
            for s in (0, 1):
                assert clients[0]._clock.peer(s).samples > before[s]
        finally:
            if started:
                for c in clients:
                    c.stop()
                join_all(threads)


# ---------------------------------------------------------------------------
# mixed timed gangs across the packages


class TestMixedTimedGangs:
    @pytest.mark.parametrize("server_pkg,client_pkg", [("jax", "torch"), ("torch", "jax")])
    def test_mixed_timed_gang_equals_the_jax_gang_and_joins(self, server_pkg, client_pkg,
                                                            obs_on, tmp_path):
        rng = np.random.default_rng(13)
        w0 = rng.normal(size=96).astype(np.float32)
        gtab = rng.normal(size=(2, 4, 96)).astype(np.float32)
        want, _, _ = lockstep_gang("jax", "jax", w0, gtab, JaxRouter(4))
        reset_both(True)
        got, servers, clients = lockstep_gang(server_pkg, client_pkg, w0, gtab,
                                              JaxRouter(4))
        assert got.tobytes() == want.tobytes()
        assert all(c._timing for c in clients)
        assert all(s._timing[2] and s._timing[3] for s in servers)
        # each package records its own half; each half is written by its
        # own package's exporter (pid 0: the servers, pid 2: the clients)
        halves = {"torch": (obs_trace, 0 if server_pkg == "torch" else 2),
                  "jax": (jtrace, 0 if server_pkg == "jax" else 2)}
        parts = []
        for pkg, (mod, pid) in halves.items():
            part = str(tmp_path / f"{pkg}.json")
            mod.write_rank_trace(part, rank=pid, role="servers" if pid == 0 else "clients")
            parts.append(part)
        merged = {}
        for pkg, mod in (("torch", obs_trace), ("jax", jtrace)):
            merged[pkg] = str(tmp_path / f"merged_{pkg}.json")
            mod.merge_traces(merged[pkg], parts)
        assert open(merged["torch"]).read() == open(merged["jax"]).read()
        report = obs_causal.analyze(merged["torch"])
        assert report == jcausal.analyze(merged["jax"])
        assert report["ops"]["completed"] > 0
        assert report["ops"]["join_rate"] == 1.0 and report["violations"] == []
        assert {e["source"] for e in report["offsets"]} == {"wire"}
        applied = sum(1 for d in report["chains"] if d["op"] == "GRAD")
        assert applied == sum(s.grads_applied for s in servers) == 16


# ---------------------------------------------------------------------------
# obs on and obs off: the same bits


def adam_gang(obs_enabled, monkeypatch, tmp_path):
    """The port's lockstep Adam gang (2 clients, 2 servers at 2 x 500
    floats, 6 rounds, gradients a function of the pulled params) with
    obs, the profile plane and FLAG_TIMING on or off; the K3 wrapper
    (the rules' ``fused_adam``, its plain twin on the CPU) counts its
    calls."""
    from mpit_tpu_torch.optim import rules

    calls = [0]
    real = rules.fused_adam

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(rules, "fused_adam", counted)
    reset_both(obs_enabled)
    if obs_enabled:
        obs_profile.configure(enabled=True, reset=True)
    rng = np.random.default_rng(21)
    w0 = rng.normal(size=1000).astype(np.float32)
    target = rng.normal(size=(2, 1000)).astype(np.float32)
    ft = dict(TIMED, op_deadline_s=30.0) if obs_enabled else \
        dict(op_deadline_s=30.0, max_retries=8)

    def grad(i, rnd, p):  # a quadratic pull toward each client's target
        return (p - target[i]) * np.float32(0.5 + 0.1 * rnd)

    final, servers, clients = lockstep_gang(
        "torch", "torch", w0, np.zeros((2, 6, 1000), np.float32), LocalRouter(4),
        client_ft=ft, rule=rules.make("adam", lr=1e-2), on_round=grad)
    out = {"final": final, "calls": calls[0],
           "applied": sum(s.grads_applied for s in servers),
           "state": [{k: v.numpy().tobytes() for k, v in s.rule_state.items()}
                     for s in servers]}
    if obs_enabled:
        rec = obs_spans.get_recorder()
        out["server_grads"] = sum(1 for sp in rec.spans if sp.name == "GRAD"
                                  and sp.args.get("side") == "server"
                                  and sp.outcome == "applied")
        path = obs_trace.write_rank_trace(str(tmp_path / "adam.json"), 0, role="gang")
        out["report"] = obs_causal.analyze(path)
        out["profile"] = obs_profile.analyze_trace(path)
    reset_both(None)
    return out


def test_obs_on_and_off_give_the_same_bits(monkeypatch, tmp_path):
    off = adam_gang(False, monkeypatch, tmp_path)
    on = adam_gang(True, monkeypatch, tmp_path)
    assert on["final"].tobytes() == off["final"].tobytes()
    assert on["state"] == off["state"]
    assert off["calls"] == off["applied"] == 2 * 2 * 6
    assert on["server_grads"] == on["applied"] == on["calls"] == 24
    assert on["report"]["ops"]["join_rate"] == 1.0 and on["report"]["violations"] == []
    assert on["profile"]["counter_events"] > 0


# ---------------------------------------------------------------------------
# flight-dump causal chain + top columns


class TestFlightCausalChain:
    def test_open_op_marks_and_clock_ride_the_dump(self, obs_on, tmp_path, monkeypatch):
        monkeypatch.setenv("MPIT_OBS_FLIGHT", str(tmp_path))
        rec = obs.get_recorder()
        span = rec.op("GRAD", peer=0, side="client", rank=3, epoch=0, seq=9)
        for phase in ("encode", "send", "backoff"):
            span.mark(phase)
        est = obs_clock.ClockEstimator()
        est.add_exchange(0, 1_000_000, 1_000_100, 1_000_110, 1_000_210)
        obs_clock.register("client3", est)
        path = obs.get_flight().dump("stall_test")
        span.end("exhausted")
        dump = json.load(open(path))
        (op,) = [o for o in dump["inflight_ops"] if o["op"] == "GRAD"]
        assert [m[0] for m in op["marks"]] == ["encode", "send", "backoff"]
        assert all(isinstance(m[1], float) for m in op["marks"])
        assert op["phase"] == "backoff" and op["seq"] == 9
        assert dump["clock"]["client3"]["0"]["accepted"] == 1
        assert obs.validate_dump(path) == jobs.validate_dump(path)


class TestTopColumns:
    def test_hist_quantile_from_exposition(self):
        from mpit_tpu_torch.obs import top as obs_top
        from mpit_tpu_torch.obs.metrics import Registry

        reg = Registry()
        h = reg.histogram("mpit_ps_op_seconds", op="GRAD", side="client")
        for v in [0.001] * 98 + [3.0, 3.5]:
            h.observe(v)
        samples = obs_top.parse_exposition(reg.exposition())
        p50 = obs_top.hist_quantile(samples, "mpit_ps_op_seconds", 0.50)
        p99 = obs_top.hist_quantile(samples, "mpit_ps_op_seconds", 0.99)
        assert p50 is not None and p50 <= 0.002
        assert p99 is not None and p99 >= 2.0
        assert (p50, p99) == (jobs.top.hist_quantile(samples, "mpit_ps_op_seconds", 0.50),
                              jobs.top.hist_quantile(samples, "mpit_ps_op_seconds", 0.99))
        assert obs_top.hist_quantile(samples, "mpit_nonexistent", 0.99) is None

    def test_rank_row_has_p99_and_sendq_columns(self):
        from mpit_tpu_torch.obs import top as obs_top
        from mpit_tpu_torch.obs.metrics import Registry

        reg = Registry()
        reg.histogram("mpit_ps_op_seconds", op="GRAD", side="client").observe(0.004)
        reg.gauge("mpit_tcp_send_queue_depth", rank=1, peer=0).set(3)
        reg.gauge("mpit_tcp_send_queue_depth", rank=1, peer=2).set(4)
        sample = {"metrics": obs_top.parse_exposition(reg.exposition()),
                  "status": {"role": "worker"}, "port": 1}
        row = obs_top._rank_row(1, sample, None, None)
        assert row["p99_s"] is not None and row["p99_s"] >= 0.004
        assert row["send_queue"] == 7
        assert row == jobs.top._rank_row(1, sample, None, None)
        table = obs_top.render_table([row])
        assert "p99ms" in table and "sendq" in table
