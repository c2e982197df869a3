"""The port's pipelined streaming transfers (``FLAG_CHUNKED``, INIT v5,
``docs/PROTOCOL.md`` §12): twins of ``tests/test_stream.py``.

The contract: chunking a shard transfer into K independent frames changes
*when* bytes move and applies run, and nothing else.  The port decodes and
applies in separate torch ops on every path (its native codec is built
with ``-ffp-contract=off``), so it holds, for codecs none, bf16 and int8
at a tailed shard (10,000: 5,000 a server) and a block-multiple one
(16,384):

- port chunked == port unchunked, bitwise;
- port unchunked == JAX unchunked, bitwise (the JAX gangs run in a child
  process: a JAX server encoding a quantized snapshot starts the JAX
  package's process-global worker pool).

The JAX package's own chunked int8 apply misses its unchunked rounding at
the tailed shard (ROADMAP §C); the port's twins do not copy that rounding
guess.  Faults come from the message-atomic ``FaultPlan`` seam: each chunk
is its own message, so ``drop_every=3`` on the GRAD channel drops chunks.
Client-side plans fault the data channels (GRAD / PARAM_REQ /
PARAM_PUSH), server-side plans the per-chunk acks and reply chunks;
lockstep rounds pin the cross-client apply order.
"""

import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mpit_tpu.ft as jft
from mpit_tpu.comm import codec as jcodec
from mpit_tpu.comm.local import LocalRouter as JaxRouter
from mpit_tpu.ps import ParamClient as JaxClient
from mpit_tpu.ps import ParamServer as JaxServer
from mpit_tpu_torch.aio import TaskError
from mpit_tpu_torch.comm import codec as codec_mod
from mpit_tpu_torch.comm.local import LocalRouter
from mpit_tpu_torch.ft import (
    DUP,
    FLAG_CHUNKED,
    FLAG_FRAMED,
    FLAG_READONLY,
    FRESH,
    STALE,
    DedupTable,
    FaultPlan,
    FaultyTransport,
    FTConfig,
    PacedTransport,
    RetryExhausted,
    chunk_elems_for,
    chunk_spans,
    chunk_stride,
    init_v5,
)
from mpit_tpu_torch.ps import ParamClient, ParamServer, tags

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA_TAGS = frozenset({tags.GRAD, tags.PARAM_REQ, tags.PARAM_PUSH})
REPLY_TAGS = frozenset({tags.GRAD_ACK, tags.PARAM, tags.PARAM_PUSH_ACK})
CODECS = ["none", "bf16", "int8"]


def stream_ft(chunk_bytes=8192, deadline=2.0, retries=10):
    """A fast retry posture for router-speed gangs; 8,192 bytes cuts an f32
    shard at 2,048-element (block-aligned) boundaries."""
    return FTConfig(op_deadline_s=deadline, max_retries=retries,
                    backoff_base_s=0.005, backoff_cap_s=0.02, chunk_bytes=chunk_bytes)


def join_all(threads, timeout=60):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "role thread did not stop (hang)"


@pytest.fixture
def jax_pool_restored():
    """A JAX chunked role makes the JAX package's process-global worker pool:
    put the process back as it was."""
    import mpit_tpu.comm.pool as jpool

    saved = jpool._GLOBAL
    yield
    made = jpool._GLOBAL
    if made is not saved:
        jpool._GLOBAL = saved
        if made is not None:
            made.close()


# ---------------------------------------------------------------------------
# wire units


class TestChunkWire:
    def test_chunk_elems_block_aligned(self):
        for args in [(8192, 4), (4 << 20, 4), (1, 4), (5000, 4), (8192, 8)]:
            assert chunk_elems_for(*args) == jft.chunk_elems_for(*args)
        assert chunk_elems_for(8192, 4) == 2048
        assert chunk_elems_for(5000, 4) == 1024  # rounds DOWN to blocks

    def test_chunk_spans_cover_exactly(self):
        assert chunk_spans(5000, 2048) == [(0, 2048), (2048, 4096), (4096, 5000)]
        assert chunk_spans(4096, 2048) == [(0, 2048), (2048, 4096)]
        assert chunk_spans(100, 2048) == [(0, 100)] == jft.chunk_spans(100, 2048)

    def test_chunk_stride_aligned(self):
        assert chunk_stride(32, 8192) % 64 == 0
        assert chunk_stride(32, 8192) >= 32 + 8192

    @pytest.mark.parametrize("codec_name", CODECS)
    def test_chunk_frames_bit_identical_to_full_frame(self, codec_name):
        """Per-chunk encode == the matching regions of the whole-shard
        encode (gather_chunk), chunked decode == full decode, residual fold
        included — and the frames are the JAX package's bytes."""
        codec, jc = codec_mod.get(codec_name), jcodec.get(codec_name)
        x = np.random.default_rng(7).normal(size=5000).astype(np.float32)
        size = x.size
        full = np.zeros(codec.wire_nbytes(size), np.uint8)
        r_full = np.zeros(size, np.float32)
        codec.encode_into(x, full, residual=r_full if codec.uses_residual else None)
        jfull = np.zeros_like(full)
        jc.encode_into(x, jfull, residual=np.zeros(size, np.float32)
                       if jc.uses_residual else None)
        assert full.tobytes() == jfull.tobytes()
        r_chunk = np.zeros(size, np.float32)
        out_full = np.zeros(size, np.float32)
        codec.decode_into(full, out_full)
        out_chunk = np.zeros(size, np.float32)
        for lo, hi in chunk_spans(size, 2048):
            frame = np.zeros(codec.wire_nbytes(hi - lo), np.uint8)
            codec.encode_into(x[lo:hi], frame,
                              residual=r_chunk[lo:hi] if codec.uses_residual else None)
            ref = np.zeros_like(frame)
            codec_mod.gather_chunk(codec, full, size, lo, hi, ref)
            np.testing.assert_array_equal(frame, ref)
            jref = np.zeros_like(frame)
            jcodec.gather_chunk(jc, full, size, lo, hi, jref)
            np.testing.assert_array_equal(frame, jref)
            codec.decode_into(frame, out_chunk[lo:hi])
            back = np.zeros_like(full)
            codec_mod.scatter_chunk(codec, back, size, lo, hi, frame)
            np.testing.assert_array_equal(back[back != 0], full[back != 0])
        np.testing.assert_array_equal(out_full, out_chunk)
        if codec.uses_residual:
            np.testing.assert_array_equal(r_full, r_chunk)

    def test_unaligned_chunk_start_rejected(self):
        with pytest.raises(ValueError, match="aligned"):
            codec_mod.get("int8").chunk_regions(5000, 100, 2048)
        with pytest.raises(ValueError, match="aligned"):
            codec_mod.gather_chunk(codec_mod.get("none"), np.zeros(16, np.uint8),
                                   4, 1, 2, np.zeros(4, np.uint8))


# ---------------------------------------------------------------------------
# per-(op, chunk) dedup


class TestChunkDedup:
    def test_admit_commit_cycle(self):
        for t in (DedupTable(), jft.DedupTable()):
            assert t.admit_chunk(1, tags.GRAD, 0, 1, 0, 3) == (FRESH, False)
            assert t.admit_chunk(1, tags.GRAD, 0, 1, 0, 3) == (DUP, False)
            assert t.admit_chunk(1, tags.GRAD, 0, 1, 2, 3) == (FRESH, False)
            assert t.admit_chunk(1, tags.GRAD, 0, 1, 1, 3) == (FRESH, True)
            assert t.admit_chunk(1, tags.GRAD, 0, 1, 1, 3) == (DUP, False)
            assert t.is_committed(1, tags.GRAD, 0, 1)
            assert t.admit_chunk(1, tags.GRAD, 0, 2, 0, 3) == (FRESH, False)
            assert not t.is_committed(1, tags.GRAD, 0, 2)

    def test_stale_epoch_and_abandoned_partial(self):
        t = DedupTable()
        t.admit_chunk(1, tags.GRAD, 1, 1, 0, 2)
        assert t.admit_chunk(1, tags.GRAD, 0, 9, 0, 2)[0] == STALE
        assert t.admit_chunk(1, tags.GRAD, 1, 2, 0, 2) == (FRESH, False)
        assert t.admit_chunk(1, tags.GRAD, 1, 2, 1, 2) == (FRESH, True)

    def test_partial_state_roundtrip_grad_only(self):
        t, jt = DedupTable(), jft.DedupTable()
        for table in (t, jt):
            table.admit_chunk(1, tags.GRAD, 0, 5, 1, 3)
            table.admit_chunk(1, tags.PARAM_PUSH, 0, 2, 0, 3)
        part = t.partial_state(tags={tags.GRAD})
        assert part == jt.partial_state(tags={tags.GRAD})
        assert list(part) == [f"1:{tags.GRAD}"]
        fresh = DedupTable()
        fresh.restore_partial(part)
        assert fresh.admit_chunk(1, tags.GRAD, 0, 5, 1, 3) == (DUP, False)
        assert fresh.admit_chunk(1, tags.GRAD, 0, 5, 0, 3) == (FRESH, False)
        assert fresh.admit_chunk(1, tags.GRAD, 0, 5, 2, 3) == (FRESH, True)


# ---------------------------------------------------------------------------
# gang harness (the JAX test's, over the port's roles)


def launch_stream(nservers, nclients, client_ft, client_plans=None, server_plan=None,
                  rule="add", codec=None, pace_mbs=0.0, dplane=None):
    n = nservers + nclients
    router = LocalRouter(n)
    sranks, cranks = list(range(nservers)), list(range(nservers, n))
    servers, threads = [], []
    for r in sranks:
        ep = router.endpoint(r)
        if pace_mbs:
            ep = PacedTransport(ep, pace_mbs)
        if server_plan is not None:
            ep = FaultyTransport(ep, server_plan)
        servers.append(ParamServer(r, cranks, ep, rule=rule, device="cpu",
                                   ft=FTConfig(rejoin=True), dplane=dplane))
        threads.append(threading.Thread(target=servers[-1].start, daemon=True))
    for t in threads:
        t.start()
    clients = []
    for i, r in enumerate(cranks):
        ep = router.endpoint(r)
        if pace_mbs:
            ep = PacedTransport(ep, pace_mbs)
        plan = (client_plans or {}).get(i)
        if plan is not None:
            ep = FaultyTransport(ep, plan)
        clients.append(ParamClient(r, sranks, ep, seed_servers=(r == cranks[0]),
                                   codec=codec, ft=client_ft))
    return servers, clients, threads


def run_gang(nservers, nclients, client_ft, rounds=3, size=10000, client_plans=None,
             server_plan=None, rule="add", codec=None, pace_mbs=0.0, seed=42,
             dplane=None):
    """Seed, run lockstep rounds, read back: (final params of client 0,
    stats) — the JAX test's harness."""
    rng = np.random.default_rng(seed)
    w0 = rng.normal(size=size).astype(np.float32)
    gtab = rng.normal(size=(nclients, max(rounds, 1), size)).astype(np.float32)
    servers, clients, threads = launch_stream(
        nservers, nclients, client_ft, client_plans=client_plans,
        server_plan=server_plan, rule=rule, codec=codec, pace_mbs=pace_mbs,
        dplane=dplane)
    params, starters = [], []
    for i, c in enumerate(clients):
        p = w0.copy() if i == 0 else np.zeros(size, np.float32)
        g = np.zeros(size, np.float32)
        params.append((p, g))
        starters.append(threading.Thread(target=c.start, args=(p, g), daemon=True))
    for t in starters:
        t.start()
    join_all(starters)
    for r in range(rounds):
        for i, c in enumerate(clients):
            params[i][1][:] = gtab[i, r]
            c.async_send_grad()
            c.wait()
    clients[0].async_recv_param()
    clients[0].wait()
    stats = {"applied": sum(s.grads_applied for s in servers),
             "dups": sum(s.dup_ops for s in servers),
             "retries": sum(c.retries for c in clients)}
    for c in clients:
        c.stop()
    join_all(threads)
    return params[0][0].copy(), stats


_JAX_GANGS = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_stream as ts
out = {}
for codec in ("none", "bf16", "int8"):
    for size in (10000, 16384):
        final, _ = ts.run_gang(2, 2, ts.stream_ft(chunk_bytes=0), size=size,
                               codec=codec)
        out[f"{codec}-{size}"] = final.tobytes().hex()
json.dump(out, open(sys.argv[2], "w"))
"""


@pytest.fixture(scope="module")
def jax_unchunked(tmp_path_factory):
    """The JAX package's unchunked framed gangs (2 servers, 2 lockstep
    clients) for every (codec, size), run in a child process."""
    path = tmp_path_factory.mktemp("jax") / "finals.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _JAX_GANGS, str(ROOT / "tests"),
                           str(path)], env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {k: np.frombuffer(bytes.fromhex(v), np.float32)
            for k, v in json.loads(path.read_text()).items()}


# ---------------------------------------------------------------------------
# end-to-end bitwise equality


class TestChunkedBitwise:
    @pytest.mark.parametrize("codec_name", CODECS)
    @pytest.mark.parametrize("size", [10000, 16384])
    def test_chunked_equals_unchunked(self, codec_name, size, jax_unchunked):
        """Fault-free, tailed (10,000: 5,000 a server) and block-multiple
        (16,384): port chunked == port unchunked, bitwise, and port
        unchunked == JAX unchunked bitwise for none and bf16 (exact decodes).
        For int8 this XLA contracts the decode multiply into the apply's add
        (one rounding, an fma) where the port rounds the decoded gradient
        first, as the reference's own host-decoded chunk path does
        (ROADMAP §C): the two stay within one float32 ulp of the result per
        apply (six applies an element here)."""
        clean, _ = run_gang(2, 2, stream_ft(chunk_bytes=0), size=size, codec=codec_name)
        chunked, st = run_gang(2, 2, stream_ft(), size=size, codec=codec_name)
        np.testing.assert_array_equal(clean, chunked)
        ref = jax_unchunked[f"{codec_name}-{size}"]
        if codec_name == "int8":
            gap = np.abs(clean.astype(np.float64) - ref)
            ulps = gap / np.spacing(np.abs(ref))
            assert (ulps <= 6).all(), f"{int((ulps > 6).sum())} elements past 6 ulp"
        else:
            np.testing.assert_array_equal(clean, ref)
        assert st["retries"] == 0

    def test_chunked_equals_unchunked_stateful_rule(self):
        clean, _ = run_gang(2, 2, stream_ft(chunk_bytes=0), rule="rmsprop", codec="int8")
        chunked, _ = run_gang(2, 2, stream_ft(), rule="rmsprop", codec="int8")
        np.testing.assert_array_equal(clean, chunked)

    def test_chunk_drop_dup_matrix_bitwise(self):
        """Every 3rd chunk message dropped + every 4th duplicated client-side,
        every 5th ack/reply chunk dropped + every 3rd duplicated server-side:
        bitwise the fault-free unchunked run, with retries and dups flowing."""
        clean, _ = run_gang(2, 2, stream_ft(chunk_bytes=0))
        client_plans = {i: FaultPlan(seed=i, drop_every=3, dup_every=4, tags=DATA_TAGS)
                        for i in range(2)}
        server_plan = FaultPlan(seed=9, drop_every=5, dup_every=3, tags=REPLY_TAGS)
        faulty, st = run_gang(2, 2, stream_ft(deadline=0.3), client_plans=client_plans,
                              server_plan=server_plan)
        np.testing.assert_array_equal(clean, faulty)
        assert st["retries"] > 0, "the plan never forced a chunk resend?"
        assert st["dups"] > 0, "no duplicate chunk was ever re-acked?"

    def test_int8_error_feedback_exact_under_chunk_faults(self):
        clean, _ = run_gang(2, 2, stream_ft(chunk_bytes=0), codec="int8")
        client_plans = {i: FaultPlan(seed=31 + i, drop_every=3, dup_every=5,
                                     tags=DATA_TAGS) for i in range(2)}
        faulty, st = run_gang(2, 2, stream_ft(deadline=0.3), client_plans=client_plans,
                              codec="int8")
        np.testing.assert_array_equal(clean, faulty)
        assert st["retries"] > 0

    def test_unsplittable_rule_refused_loudly(self):
        """Adam's scalar step counter cannot split across chunks: the
        negotiation refuses, never corrupts quietly (§12.5)."""
        with pytest.raises((TaskError, RetryExhausted, AssertionError)):
            run_gang(1, 1, stream_ft(deadline=0.3, retries=2), rounds=1, rule="adam")
        server = ParamServer(0, [1], LocalRouter(2).endpoint(0), rule="adam",
                             device="cpu")
        with pytest.raises(ValueError, match="non-element-wise state"):
            server._negotiate(1, init_v5(0, 4096, 0, 0, FLAG_FRAMED | FLAG_CHUNKED,
                                         1024).tobytes())

    def test_paced_link_runs_clean(self):
        clean, _ = run_gang(1, 1, stream_ft(chunk_bytes=0), rounds=2)
        paced, _ = run_gang(1, 1, stream_ft(deadline=5.0), rounds=2, pace_mbs=200.0)
        np.testing.assert_array_equal(clean, paced)


# ---------------------------------------------------------------------------
# legacy interop and mixed packages


def _spy_gang(ft):
    router = LocalRouter(2)
    sent = []
    ep = router.endpoint(1)
    inner_isend = ep.isend

    def spy(data, dst, tag):
        sent.append((tag, np.asarray(data).nbytes if isinstance(data, np.ndarray)
                     else len(data)))
        return inner_isend(data, dst, tag)

    ep.isend = spy
    server = ParamServer(0, [1], router.endpoint(0), rule="add", device="cpu")
    th = threading.Thread(target=server.start, daemon=True)
    th.start()
    client = ParamClient(1, [0], ep, seed_servers=True, ft=ft)
    size = 4096
    client.start(np.zeros(size, np.float32), np.ones(size, np.float32))
    client.async_send_grad()
    client.wait()
    client.stop()
    join_all([th])
    return sent, size


class TestLegacyInterop:
    def test_no_flag_pairs_byte_for_byte_unchanged(self):
        """A pair that never negotiates FLAG_CHUNKED keeps the pre-§12 wire:
        a v3 announcement, whole-frame messages."""
        sent, size = _spy_gang(FTConfig(op_deadline_s=5.0))
        assert [n for t, n in sent if t == tags.INIT] == [40]
        assert [n for t, n in sent if t == tags.GRAD] == [16 + 4 * size]

    def test_chunked_init_is_v5(self):
        sent, _size = _spy_gang(stream_ft())
        assert [n for t, n in sent if t == tags.INIT] == [48]
        grads = [n for t, n in sent if t == tags.GRAD]
        assert len(grads) == 2 and len(set(grads)) == 1, "chunk frames not uniform"

    def test_readonly_chunked_announce_rejected(self):
        server = ParamServer(0, [1], LocalRouter(3).endpoint(0), rule="add",
                             device="cpu", reader_ranks=[2])
        with pytest.raises(ValueError, match="READONLY"):
            server._negotiate(2, np.asarray(
                [0, 1024, 0, 0, FLAG_FRAMED | FLAG_READONLY | FLAG_CHUNKED, 1024],
                np.int64).tobytes())

    @pytest.mark.parametrize("server_pkg", ["jax", "torch"])
    def test_mixed_chunked_pairs_equal_the_port_gang(self, server_pkg,
                                                     jax_pool_restored):
        """A port chunked client against a JAX server, and a JAX chunked
        client against a port server (codec none, on a JAX router): the
        same wire, the same final params as the all-port chunked gang, with
        faults dropped and duplicated on the chunk channels."""
        size, rounds = 10000, 3
        ref, _ = run_gang(2, 1, stream_ft(), size=size, rounds=rounds)
        router = JaxRouter(3)
        plan = FaultPlan(seed=5, drop_every=4, dup_every=3, tags=DATA_TAGS)
        jplan = jft.FaultPlan(seed=5, drop_every=4, dup_every=3, tags=DATA_TAGS)
        if server_pkg == "jax":
            servers = [JaxServer(r, [2], router.endpoint(r), rule="add",
                               ft=jft.FTConfig(rejoin=True)) for r in (0, 1)]
            client = ParamClient(2, [0, 1], FaultyTransport(router.endpoint(2), plan),
                                 seed_servers=True, ft=stream_ft(deadline=0.3))
        else:
            servers = [ParamServer(r, [2], router.endpoint(r), rule="add",
                                   device="cpu", ft=FTConfig(rejoin=True))
                       for r in (0, 1)]
            client = JaxClient(2, [0, 1], jft.FaultyTransport(router.endpoint(2), jplan),
                               seed_servers=True,
                               ft=jft.FTConfig(op_deadline_s=0.3, max_retries=10,
                                               backoff_base_s=0.005,
                                               backoff_cap_s=0.02, chunk_bytes=8192))
        threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
        for t in threads:
            t.start()
        rng = np.random.default_rng(42)
        param = rng.normal(size=size).astype(np.float32)
        gtab = rng.normal(size=(1, rounds, size)).astype(np.float32)
        grad = np.zeros(size, np.float32)
        client.start(param, grad)
        for r in range(rounds):
            grad[:] = gtab[0, r]
            client.async_send_grad()
            client.wait()
        client.async_recv_param()
        client.wait()
        assert client.retries > 0, "the plan never bit"
        client.stop()
        join_all(threads)
        np.testing.assert_array_equal(param, ref)


# ---------------------------------------------------------------------------
# chunked spans in a trace: the causal analyzer's stream phase


class TestStreamTrace:
    def test_chunked_gang_trace_shows_the_stream_phase(self, tmp_path):
        """A timed chunked gang's spans carry the chunk marks (``chunk``,
        ``flush``, per-chunk ``apply``/``ack``), and both packages' causal
        analyzers read the same report off the trace, with its streaming
        overlap section (§12.7)."""
        import mpit_tpu.obs as jobs
        from mpit_tpu.obs import causal as jcausal
        from mpit_tpu_torch import obs
        from mpit_tpu_torch.obs import causal as obs_causal
        from mpit_tpu_torch.obs import trace as obs_trace

        obs.configure(enabled=True, reset=True)
        jobs.configure(enabled=True, reset=True)
        try:
            ft = FTConfig(op_deadline_s=2.0, max_retries=10, backoff_base_s=0.005,
                          backoff_cap_s=0.02, chunk_bytes=8192, timing=True)
            run_gang(2, 2, ft, rounds=2)
            path = obs_trace.write_rank_trace(str(tmp_path / "stream.json"), 0,
                                              role="gang")
        finally:
            obs.configure(enabled=None, reset=True)
            jobs.configure(enabled=None, reset=True)
        report = obs_causal.analyze(path)
        assert report == jcausal.analyze(path)
        assert report["ops"]["completed"] > 0 and report["violations"] == []
        assert report["streaming"] is not None and report["streaming"]["ops"] > 0
        phases = {e["name"] for e in json.load(open(path))["traceEvents"]
                  if e.get("ph") == "X"}
        assert {"GRAD.chunk", "GRAD.flush", "GRAD.apply", "GRAD.ack",
                "PARAM.chunk", "PARAM_PUSH.chunk"} <= phases


# ---------------------------------------------------------------------------
# server restart mid-stream (the checkpoint's consistency cut)


class TestChunkedRestart:
    def _half_applied(self, server_cls, ftc, **kw):
        """A server with a chunked client negotiated by hand and chunk 0 of
        seq 1 admitted and applied."""
        router = (LocalRouter if server_cls is ParamServer else JaxRouter)(2)
        server = server_cls(0, [1], router.endpoint(0), rule="add", ft=ftc(rejoin=True),
                            **kw)
        flags = FLAG_FRAMED | FLAG_CHUNKED
        codec = server._negotiate(1, np.asarray(init_v5(0, 4096, 0, 0, flags, 2048)
                                                ).tobytes())
        server._alloc_client(1, codec)
        assert server.dedup.admit_chunk(1, tags.GRAD, 0, 1, 0, 2) == (FRESH, False)
        grad = np.ones(2048, np.float32)
        server._apply_chunk(1, codec, grad.view(np.uint8), 0, 2048, commit=False)
        return server, router, grad

    @pytest.mark.parametrize("writer,reader", [("torch", "torch"), ("torch", "jax"),
                                               ("jax", "torch")])
    def test_checkpoint_carries_grad_chunk_partials(self, tmp_path, writer, reader):
        """A checkpoint cut between chunk applies persists the partial
        admission set beside the partly updated params (the JAX npz layout),
        so a restarted server — of either package — re-acks the applied
        chunk and completes the op on the rest (§12.6)."""
        from mpit_tpu_torch.utils.checkpoint import load_server_state

        if writer == "torch":
            server, _router, grad = self._half_applied(ParamServer, FTConfig,
                                                       device="cpu")
        else:
            server, _router, grad = self._half_applied(JaxServer, jft.FTConfig)
        path = server.save_state(str(tmp_path))
        meta = load_server_state(path)[4]
        assert meta["dedup_chunks"] == {f"1:{tags.GRAD}": [0, 1, 2, [0]]}
        if reader == "torch":
            restarted = ParamServer(0, [1], LocalRouter(2).endpoint(0), rule="add",
                                    device="cpu", ft=FTConfig(rejoin=True))
        else:
            restarted = JaxServer(0, [1], JaxRouter(2).endpoint(0), rule="add",
                                  ft=jft.FTConfig(rejoin=True))
        restarted.restore_state(path)
        assert restarted.dedup.admit_chunk(1, tags.GRAD, 0, 1, 0, 2) == (DUP, False)
        assert restarted.dedup.admit_chunk(1, tags.GRAD, 0, 1, 1, 2) == (FRESH, True)
        assert restarted._chunk.get(1) == 2048
        np.testing.assert_array_equal(np.asarray(restarted.param)[:2048], grad)

    def test_push_partials_are_not_checkpointed(self, tmp_path):
        from mpit_tpu_torch.utils.checkpoint import load_server_state

        server, _router, _grad = self._half_applied(ParamServer, FTConfig, device="cpu")
        server.dedup.admit_chunk(1, tags.PARAM_PUSH, 0, 1, 0, 2)
        meta = load_server_state(server.save_state(str(tmp_path)))[4]
        assert list(meta["dedup_chunks"]) == [f"1:{tags.GRAD}"]


# ---------------------------------------------------------------------------
# the device slot's chunk apply


class TestHbmChunkApply:
    @pytest.mark.parametrize("codec_name", CODECS)
    @pytest.mark.parametrize("size", [4096, 5000])
    def test_chunk_apply_matches_whole_apply(self, codec_name, size):
        """HbmSlot.apply_wire_chunk over every chunk == apply_wire of the
        whole frame, bitwise, block-multiple and tailed; the version bumps
        once per op and the in-place apply keeps the slot's storage."""
        from mpit_tpu_torch.dplane.hbm import HbmSlot, PlaneConfig
        from mpit_tpu_torch.optim.rules import make as make_rule

        codec = codec_mod.get(codec_name)
        g = np.random.default_rng(3).normal(size=size).astype(np.float32)
        wire = np.zeros(codec.wire_nbytes(size), np.uint8)
        codec.encode_into(g, wire)
        cfg = PlaneConfig(device="cpu")
        whole = HbmSlot(size, make_rule("rmsprop"), config=cfg)
        whole.apply_wire(codec, codec.split_wire(wire, size)[0] if codec.identity
                         else codec.split_wire(wire, size))
        chunked = HbmSlot(size, make_rule("rmsprop"), config=cfg)
        ptr = chunked.param.data_ptr()
        spans = chunk_spans(size, 2048)
        for k, (lo, hi) in enumerate(spans):
            frame = np.zeros(codec.wire_nbytes(hi - lo), np.uint8)
            codec_mod.gather_chunk(codec, wire, size, lo, hi, frame)
            parts = codec.split_wire(frame, hi - lo)
            chunked.apply_wire_chunk(codec, parts[0] if codec.identity else parts,
                                     lo, hi - lo, commit=(k == len(spans) - 1))
        assert chunked.version == whole.version == 1
        assert chunked.param.data_ptr() == ptr
        assert chunked.param.numpy().tobytes() == whole.param.numpy().tobytes()


# ---------------------------------------------------------------------------
# the property test: random chunk-level plans


@pytest.mark.parametrize("codec_name", CODECS)
@pytest.mark.parametrize("seed", range(5))
def test_property_chunk_faults_bitwise_or_loud(seed, codec_name):
    """Seed-deterministic random {drop, dup, delay} plans at chunk
    granularity across five seeds and every codec: the run either ends
    bitwise the fault-free *unchunked* control — int8 error feedback
    included — or fails loudly.  Never a hang."""
    rng = np.random.default_rng(seed * 1000 + codec_mod.get(codec_name).wire_id)
    nclients = int(rng.integers(1, 3))
    rounds = 2
    size = int(rng.choice([6144, 10000]))  # block-multiple and tailed
    clean, _ = run_gang(2, nclients, stream_ft(chunk_bytes=0), rounds=rounds,
                        size=size, codec=codec_name, seed=seed)
    client_plans = {i: FaultPlan(seed=seed * 17 + i, drop_rate=0.10, dup_rate=0.08,
                                 delay_rate=0.15, delay_polls=4, tags=DATA_TAGS)
                    for i in range(nclients)}
    server_plan = FaultPlan(seed=seed * 31 + 7, drop_rate=0.08, dup_rate=0.08,
                            delay_rate=0.15, delay_polls=4, tags=REPLY_TAGS)
    box: dict = {}

    def run():
        try:
            box["params"], box["stats"] = run_gang(
                2, nclients, stream_ft(deadline=0.3, retries=8), rounds=rounds,
                size=size, client_plans=client_plans, server_plan=server_plan,
                codec=codec_name, seed=seed)
        except (TaskError, RetryExhausted, AssertionError) as exc:
            box["error"] = exc  # loud is an acceptable outcome

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(120)
    assert not worker.is_alive(), "chunked faulty run HUNG"
    if "params" in box:
        np.testing.assert_array_equal(clean, box["params"])
    else:
        assert "error" in box


# ---------------------------------------------------------------------------
# PacedTransport units


class TestPacedTransport:
    def test_paces_serially_and_preserves_fifo(self):
        router = LocalRouter(2)
        paced = PacedTransport(router.endpoint(0), rate_mbs=4.0, min_bytes=0)
        rx = router.endpoint(1)
        a = np.zeros(1 << 20, np.uint8)  # 1 MB = 0.25 s of modelled link
        t0 = time.monotonic()
        h1 = paced.isend(a, 1, 50)
        h2 = paced.isend(a[:1024], 1, 50)
        assert not rx.iprobe(0, 50)
        paced.test(h1)
        assert not h1.done and not rx.iprobe(0, 50)
        deadline = time.monotonic() + 10
        while not (paced.test(h1) and paced.test(h2)):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert time.monotonic() - t0 >= 0.25
        assert rx.iprobe(0, 50)

    def test_min_bytes_pass_through(self):
        router = LocalRouter(2)
        paced = PacedTransport(router.endpoint(0), rate_mbs=0.001, min_bytes=4096)
        h = paced.isend(np.zeros(16, np.uint8), 1, 50)
        while not paced.test(h):
            pass
        assert router.endpoint(1).iprobe(0, 50)
