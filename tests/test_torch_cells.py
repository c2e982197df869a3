"""The port's serving cells (``mpit_tpu_torch.cells``) against the JAX
package's, a twin of ``tests/test_cells.py``.

- Host logic, byte for byte: DIFF frames (FULL and DELTA, the chunk framing
  of a later slice's subscription), DIFF_REQ and head echoes, the XOR deltas
  and ``FrameHistory``; ``CellRing`` places every reader on the cell the JAX
  ring picks, over many seeded memberships with members marked down.
- The posture: ``cell_ranks=``, ``FLAG_SUBSCRIBE`` and a cell's own reader
  attach are accepted and refused where the JAX package accepts and refuses
  them; a chunk-framed subscription (``FLAG_CHUNKED``, INIT v5) is refused
  naming slice 5f.
- The fabric on the CPU: a port server, a writer, port cells and fabric
  readers as threads over the port's TCP transport.  Every read is bit for
  bit the upstream snapshot at its stamped version, and the stamped lag
  never exceeds ``max_lag``: with cells alive, with one killed, with one
  retired by GOODBYE, and under the reference's drop/delay plans on the
  diff stream.  The reference's two chunk-framed subscription tests wait
  for slice 5f.
- Mixed gangs, in a child process (a JAX server's delta and a JAX cell's
  install run the JAX package's process-global pool): port cells on a JAX
  server, JAX cells on a port server, and fabric readers of both packages
  across cells of both packages, on int8 subscriptions; each gang's reads
  at each version are bitwise the reference gang's (all-JAX under ``add``,
  all-port over the port's Adam shards), every cell installs its upstream's
  frame byte for byte, and the port's ``FrameHistory`` deltas are the JAX
  package's bytes.
- ``launch --cells`` end to end on the CPU, and ``CellAutoscaler``.

The tolerance is bitwise throughout: these are host paths.
"""

import hashlib
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import mpit_tpu.cells.wire as jwire
from mpit_tpu.cells.ring import CellRing as JaxRing
from mpit_tpu_torch.cells import wire as cellwire
from mpit_tpu_torch.cells.cell import ServingCell
from mpit_tpu_torch.cells.ring import CellRing
from mpit_tpu_torch.comm.tcp import TcpTransport, allocate_local_addresses
from mpit_tpu_torch.ft import (
    FLAG_CHUNKED,
    FLAG_FRAMED,
    FLAG_HEARTBEAT,
    FLAG_READONLY,
    FLAG_SUBSCRIBE,
    FaultPlan,
    FaultyTransport,
    FTConfig,
    RetryExhausted,
    init_v3,
)
from mpit_tpu_torch.ps import ParamClient, ParamServer, tags
from mpit_tpu_torch.ps.serve import ReaderClient, parse_serve_header, serve_head

REPO = str(pathlib.Path(__file__).resolve().parents[1])


# ---------------------------------------------------------------------------
# wire units


class TestDiffWire:
    def test_pack_parse_roundtrip(self):
        body = np.arange(64, dtype=np.uint8)
        msg = cellwire.pack_diff(cellwire.DIFF_DELTA, 3, 5, 7, body)
        kind, f, t, head, out = cellwire.parse_diff(msg)
        assert (kind, f, t, head) == (cellwire.DIFF_DELTA, 3, 5, 7)
        np.testing.assert_array_equal(out, body)
        msg = cellwire.pack_diff(cellwire.DIFF_FULL, -1, 0, 0, np.zeros(0, np.uint8))
        assert cellwire.parse_diff(msg)[4].size == 0

    def test_chunked_pack_parse_roundtrip(self):
        """The chunk framing is pure framing and comes over now (the
        chunk-framed subscription itself waits for slice 5f)."""
        body = np.arange(100, dtype=np.uint8)
        msgs = cellwire.pack_diff_chunks(cellwire.DIFF_DELTA, 3, 5, 7, body,
                                         chunk_bytes=40)
        assert len(msgs) == 3
        pieces = []
        for i, msg in enumerate(msgs):
            kind, f, t, head, idx, count, piece = cellwire.parse_diff_chunk(msg)
            assert (kind, f, t, head) == (cellwire.DIFF_DELTA, 3, 5, 7)
            assert (idx, count) == (i, 3)
            pieces.append(piece)
        np.testing.assert_array_equal(np.concatenate(pieces), body)
        assert len(cellwire.pack_diff_chunks(cellwire.DIFF_FULL, -1, 1, 1, body,
                                             chunk_bytes=1024)) == 1

    def test_malformed_frames_are_loud(self):
        with pytest.raises(ValueError, match="too short"):
            cellwire.parse_diff(b"\x00" * 8)
        msg = cellwire.pack_diff(cellwire.DIFF_FULL, -1, 1, 1, np.zeros(16, np.uint8))
        with pytest.raises(ValueError, match="promised"):
            cellwire.parse_diff(bytes(msg)[:-4])
        bad = np.frombuffer(bytes(msg), np.uint8).copy()
        bad[:8].view(np.int64)[0] = 99  # unknown kind
        with pytest.raises(ValueError, match="kind"):
            cellwire.parse_diff(bad)

    def test_xor_delta_is_exact_involution(self):
        rng = np.random.default_rng(7)
        a = rng.standard_normal(257).astype(np.float32)
        b = rng.standard_normal(257).astype(np.float32)
        delta = cellwire.xor_delta(a, b)
        assert cellwire.apply_delta(a, delta).tobytes() == b.tobytes()
        with pytest.raises(ValueError, match="size"):
            cellwire.xor_delta(a, np.zeros(3, np.uint8))

    def test_frame_history_bounded_and_memoized(self):
        hist = cellwire.FrameHistory(keep=3)
        frames = {v: np.full(8, v, np.uint8) for v in range(6)}
        for v, f in frames.items():
            hist.record(v, f)
        assert not hist.has(0) and not hist.has(2) and hist.has(3)
        d1 = hist.delta(4, 5)
        assert hist.delta(4, 5) is d1  # memoized for N cells at one version
        np.testing.assert_array_equal(d1, np.bitwise_xor(frames[4], frames[5]))
        with pytest.raises(ValueError):
            cellwire.FrameHistory(keep=1)

    @pytest.mark.parametrize("codec", ["none", "int8"])
    def test_frames_equal_the_jax_bytes(self, codec):
        """Every DIFF message, request and echo of a seeded version stream,
        byte for byte the JAX package's, and every delta the XOR of its
        frames (float32 frames and int8 frames, encoded by the port's codec:
        the same bytes as the JAX codec's, ``tests/test_torch_codec.py``)."""
        from mpit_tpu_torch.comm import codec as codec_mod

        rng = np.random.default_rng(11)
        c = codec_mod.get(codec)
        frames = []
        for _ in range(5):
            x = rng.standard_normal(3000).astype(np.float32)
            if c.identity:
                frames.append(x)
            else:
                wire = np.empty(c.wire_nbytes(x.size), np.uint8)
                c.encode_into(x, wire)
                frames.append(wire)
        hist = cellwire.FrameHistory(keep=3)
        for v, f in enumerate(frames):
            hist.record(v, f)
        for a, b in ((2, 3), (3, 4), (2, 4)):
            # The JAX delta runs on its package's process-global pool, so
            # its bytes are held in the mixed child below; here the XOR.
            d = hist.delta(a, b)
            assert d.tobytes() == np.bitwise_xor(cellwire.as_u8(frames[a]),
                                                 cellwire.as_u8(frames[b])).tobytes()
            assert cellwire.apply_delta(frames[a], d).tobytes() == \
                cellwire.as_u8(frames[b]).tobytes()
            for kind in (cellwire.DIFF_FULL, cellwire.DIFF_DELTA):
                body = d if kind == cellwire.DIFF_DELTA else frames[b]
                assert cellwire.pack_diff(kind, a, b, 9, body).tobytes() == \
                    jwire.pack_diff(kind, a, b, 9, body).tobytes()
                for cut in (1000, 4096, 1 << 20):
                    got = cellwire.pack_diff_chunks(kind, a, b, 9, body, cut)
                    want = jwire.pack_diff_chunks(kind, a, b, 9, body, cut)
                    assert [m.tobytes() for m in got] == [m.tobytes() for m in want]
        assert cellwire.diff_req(3, 4, 5).tobytes() == jwire.diff_req(3, 4, 5).tobytes()
        assert cellwire.head_echo(3, 4, 5).tobytes() == jwire.head_echo(3, 4, 5).tobytes()
        assert cellwire.parse_diff_req(jwire.diff_req(1, 2, 3)) == (1, 2, 3)
        assert (cellwire.DIFF_HDR_BYTES, cellwire.DIFF_CHUNK_HDR_BYTES,
                cellwire.DIFF_REQ_WORDS, cellwire.HEAD_ECHO_WORDS) == \
            (jwire.DIFF_HDR_BYTES, jwire.DIFF_CHUNK_HDR_BYTES,
             jwire.DIFF_REQ_WORDS, jwire.HEAD_ECHO_WORDS)


class TestRing:
    def test_deterministic_and_covers_members(self):
        ring = CellRing([4, 5, 6], vnodes=16)
        assignments = {r: ring.lookup(r) for r in range(40)}
        assert assignments == {r: CellRing([4, 5, 6], vnodes=16).lookup(r)
                               for r in range(40)}
        assert set(assignments.values()) == {4, 5, 6}

    def test_down_member_only_moves_its_own_readers(self):
        ring = CellRing([4, 5, 6], vnodes=32)
        before = {r: ring.lookup(r) for r in range(64)}
        victim = 5
        ring.mark_down(victim)
        after = {r: ring.lookup(r) for r in range(64)}
        for r in range(64):
            if before[r] != victim:
                assert after[r] == before[r], "stable arc moved"
            else:
                assert after[r] != victim
        ring.mark_up(victim)
        assert {r: ring.lookup(r) for r in range(64)} == before

    def test_successors_and_exhaustion(self):
        ring = CellRing([2, 3], vnodes=8)
        succ = ring.successors(11)
        assert sorted(succ) == [2, 3] and succ[0] == ring.lookup(11)
        ring.mark_down(2)
        ring.mark_down(3)
        with pytest.raises(LookupError):
            ring.lookup(11)
        with pytest.raises(ValueError):
            CellRing([])

    @pytest.mark.parametrize("seed", range(8))
    def test_placement_equals_the_jax_ring(self, seed):
        """Over seeded memberships (up to 12 cells among ranks below 4,096,
        1-64 vnodes) with members marked down one by one, every reader of
        512 gets the JAX ring's cell and fail-over order."""
        rng = np.random.default_rng(seed)
        members = sorted(set(int(x) for x in rng.integers(0, 4096, rng.integers(1, 13))))
        vnodes = int(rng.integers(1, 65))
        ring, jring = CellRing(members, vnodes=vnodes), JaxRing(members, vnodes=vnodes)
        readers = [int(x) for x in rng.integers(0, 1 << 20, 512)]
        for victim in [None] + list(rng.permutation(members)[:-1]):
            if victim is not None:
                ring.mark_down(int(victim))
                jring.mark_down(int(victim))
            assert ring.live == jring.live
            assert [ring.lookup(r) for r in readers] == [jring.lookup(r) for r in readers]
            assert [ring.successors(r) for r in readers[:64]] == \
                [jring.successors(r) for r in readers[:64]]


# ---------------------------------------------------------------------------
# posture validation (no I/O)


class TestPosture:
    def test_server_validates_subscribe_posture(self):
        server = ParamServer(0, [1], transport=None, device="cpu", reader_ranks=[2],
                             cell_ranks=[3])
        base = FLAG_FRAMED | FLAG_READONLY
        with pytest.raises(ValueError, match="FLAG_READONLY"):
            server._negotiate(3, init_v3(0, 16, 0, 0, FLAG_FRAMED | FLAG_SUBSCRIBE).tobytes())
        with pytest.raises(ValueError, match="cell_ranks"):
            server._negotiate(2, init_v3(0, 16, 0, 0, base | FLAG_SUBSCRIBE).tobytes())
        with pytest.raises(ValueError, match="FLAG_SUBSCRIBE"):
            server._negotiate(3, init_v3(0, 16, 0, 0, base).tobytes())
        codec = server._negotiate(3, init_v3(0, 16, 0, 0, base | FLAG_SUBSCRIBE).tobytes())
        assert codec.name == "none" and server._subscribe[3]

    def test_cell_roles_disjoint_and_shardctl_exclusive(self):
        with pytest.raises(ValueError, match="overlap"):
            ParamServer(0, [1], transport=None, device="cpu", cell_ranks=[1])
        with pytest.raises(ValueError, match="overlap"):
            ParamServer(0, [1], transport=None, device="cpu", reader_ranks=[2],
                        cell_ranks=[2])
        from mpit_tpu_torch.shardctl.shardmap import ShardMap
        from mpit_tpu_torch.shardctl.wire import init_v4

        server = ParamServer(0, [1], transport=None, device="cpu", cell_ranks=[3])
        smap = ShardMap.initial(64, [0])
        with pytest.raises(ValueError, match="mutually exclusive"):
            server._negotiate(1, init_v4(0, 0, FLAG_FRAMED, smap).tobytes())

    def test_cell_validates_reader_attach(self):
        cell = ServingCell(5, 0, None, [7], size=64,
                           ft=FTConfig(heartbeat_s=0.1, op_deadline_s=5.0))
        good = FLAG_FRAMED | FLAG_READONLY
        with pytest.raises(ValueError, match="read-only"):
            cell._negotiate(7, init_v3(0, 64, 0, 0, 0).tobytes())
        with pytest.raises(ValueError, match="reader_ranks"):
            cell._negotiate(9, init_v3(0, 64, 0, 0, good).tobytes())
        with pytest.raises(ValueError, match="mirrors"):
            cell._negotiate(7, init_v3(0, 32, 0, 0, good).tobytes())
        with pytest.raises(ValueError, match="subscription codec"):
            cell._negotiate(7, init_v3(0, 64, 2, 0, good).tobytes())
        with pytest.raises(ValueError, match="not to cells"):
            cell._negotiate(7, init_v3(0, 64, 0, 0, good | FLAG_SUBSCRIBE).tobytes())
        assert cell._negotiate(7, init_v3(0, 64, 0, 0, good).tobytes()).name == "none"

    def test_cell_requires_heartbeats(self):
        with pytest.raises(ValueError, match="heartbeat"):
            ServingCell(5, 0, None, [7], size=64, ft=FTConfig(op_deadline_s=5.0))

    def test_serve_header_head_word(self):
        cell = ServingCell(5, 0, None, [7], size=64,
                           ft=FTConfig(heartbeat_s=0.1, op_deadline_s=5.0))
        cell._install(np.zeros(8, np.uint8), 6)
        cell._note_head(9)
        hdr = cell._serve_ok_header(1, 2)
        assert parse_serve_header(hdr)[:2] == (1, 2)
        assert serve_head(hdr) == 9
        from mpit_tpu_torch.ps.serve import serve_reply

        assert serve_head(serve_reply(1, 2, 0, 6)) is None

    def test_chunk_framed_subscription_is_refused_naming_5f(self):
        """The JAX cell's chunk-framed subscription (INIT v5 with
        ``FLAG_SUBSCRIBE | FLAG_CHUNKED``) meets a loud refusal naming slice
        5f, and so does the chunk cut a port cell's subscription would
        need."""
        from mpit_tpu.ft import init_v5

        server = ParamServer(0, [1], transport=None, device="cpu", cell_ranks=[3])
        flags = FLAG_FRAMED | FLAG_HEARTBEAT | FLAG_READONLY | FLAG_SUBSCRIBE | FLAG_CHUNKED
        with pytest.raises(NotImplementedError, match="slice 5f"):
            server._negotiate(3, init_v5(0, 16, 0, 0, flags, 1024).tobytes())
        with pytest.raises(NotImplementedError, match="5f"):
            ServingCell(5, 0, None, [7], size=64,
                        ft=FTConfig(heartbeat_s=0.1, op_deadline_s=5.0, chunk_bytes=4096))


class TestFlightShapes:
    def test_cell_dump_shapes_validated(self, tmp_path):
        from mpit_tpu_torch.obs import flight as obs_flight

        base = {"schema": "mpit_flight/1", "reason": "cell_lag_shed", "pid": 1,
                "wall_time": 0.0, "events": [], "metrics": {}}
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps(base))
        with pytest.raises(ValueError, match="extra"):
            obs_flight.validate_dump(str(bad))
        bad.write_text(json.dumps({**base, "extra": {"window": {}}}))
        with pytest.raises(ValueError, match="version"):
            obs_flight.validate_dump(str(bad))
        bad.write_text(json.dumps({**base, "extra": {"window": {"version": 3}}}))
        with pytest.raises(ValueError, match="head"):
            obs_flight.validate_dump(str(bad))
        good = tmp_path / "good.json"
        good.write_text(json.dumps({**base, "extra": {
            "window": {"version": 3, "head": 9, "max_lag": 4}}}))
        assert obs_flight.validate_dump(str(good))["reason"] == "cell_lag_shed"
        good.write_text(json.dumps({**base, "reason": "cell_failover", "extra": {
            "window": {"version": 3, "dead": 2, "successor": 4}}}))
        assert obs_flight.validate_dump(str(good))["reason"] == "cell_failover"


# ---------------------------------------------------------------------------
# the fabric end to end (in-process TCP gangs)

SIZE = 2048


def _build_mesh(core, nranks, tcp=TcpTransport):
    addrs, socks = allocate_local_addresses(core)
    addrs = addrs + ["127.0.0.1:0"] * (nranks - core)
    tr = {}

    def build(r):
        tr[r] = tcp(r, nranks, addrs, listener=socks[r], reconnect=30.0,
                    dial_peers=list(range(r)))

    ths = [threading.Thread(target=build, args=(r,)) for r in range(core)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(30)
    assert all(r in tr for r in range(core)), "core mesh construction hung"
    return addrs, tr


class _Gang:
    """1 server (rank 0) + 1 writer (rank 1) + N cells + M readers."""

    def __init__(self, ncells=2, nreaders=2, *, server_wrap=None, max_lag=4,
                 cell_hb=0.05, server_ft=None):
        self.ncells, self.nreaders = ncells, nreaders
        core = 2 + ncells
        self.nranks = core + nreaders
        self.cell_ranks = list(range(2, 2 + ncells))
        self.reader_ranks = list(range(core, self.nranks))
        self.addrs, self.tr = _build_mesh(core, self.nranks)
        ep = self.tr[0] if server_wrap is None else server_wrap(self.tr[0])
        self.server = ParamServer(0, [1], ep, rule="add", device="cpu",
                                  cell_ranks=self.cell_ranks,
                                  ft=server_ft or FTConfig(lease_ttl_s=10.0))
        self.sth = threading.Thread(target=self.server.start, daemon=True)
        self.sth.start()
        self.cells, self.cth = {}, {}
        for c in self.cell_ranks:
            cell = ServingCell(c, 0, self.tr[c], reader_ranks=self.reader_ranks,
                               size=SIZE, max_lag=max_lag,
                               ft=FTConfig(heartbeat_s=cell_hb, op_deadline_s=10.0))
            self.cells[c] = cell

            def run(cell=cell):
                try:
                    cell.start()
                except RuntimeError:
                    pass  # killed mid-run (the chaos legs)

            self.cth[c] = threading.Thread(target=run, daemon=True)
            self.cth[c].start()
        self.client = ParamClient(1, [0], self.tr[1], seed_servers=True,
                                  ft=FTConfig(op_deadline_s=30.0))
        self.param = np.arange(SIZE, dtype=np.float32)
        self.grad = np.ones(SIZE, np.float32)
        self.client.start(self.param.copy(), self.grad)

    def commit(self, n=1):
        """n grad applies => n committed versions (each adds 1.0)."""
        for _ in range(n):
            self.client.async_send_grad()
            self.client.wait()

    def expected(self, version):
        """The upstream snapshot at ``version`` (seed = version 1)."""
        return self.param + float(max(version - 1, 0))

    def finish(self, timeout=60):
        self.client.stop()
        for c, t in self.cth.items():
            t.join(timeout)
            assert not t.is_alive(), f"cell {c} never stopped"
        self.sth.join(timeout)
        assert not self.sth.is_alive(), "server never stopped"

    def close(self):
        for c in self.cells.values():
            c.shutdown()
        self.server.live.stop()
        for t in self.tr.values():
            t.close()


def _reader(gang, rank, rounds, out, deadline_s=10.0, read_sleep=0.0, failover_after=2):
    t = TcpTransport(rank, gang.nranks, gang.addrs, reconnect=30.0,
                     dial_peers=gang.cell_ranks, listen=False)
    rc = ReaderClient(rank, [0], t, cells={0: gang.cell_ranks},
                      failover_after=failover_after,
                      ft=FTConfig(op_deadline_s=deadline_s, max_retries=8))
    mirror = np.zeros(SIZE, np.float32)
    reads, errors = [], []
    try:
        rc.start(mirror)
        for _ in range(rounds):
            rc.read_params()
            reads.append((rc.read_versions[0], dict(rc.lags), mirror.copy()))
            if read_sleep:
                time.sleep(read_sleep)
    except RetryExhausted as exc:
        errors.append(exc)
    finally:
        out[rank] = {"reads": reads, "errors": errors, "monotone": rc.monotone,
                     "failovers": rc.failovers, "busy_honored": rc.busy_honored}
        try:
            rc.stop()
        finally:
            t.close()


def _run_readers(gang, rounds, out, join_s=60, **kw):
    threads = [threading.Thread(target=_reader, args=(gang, r, rounds, out),
                                kwargs=kw, daemon=True) for r in gang.reader_ranks]
    for t in threads:
        t.start()
    return threads


def _join(threads, timeout, what):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), what


class TestFabric:
    def test_cells_serve_bitwise_with_one_diff_stream(self):
        """2 cells x 2 readers: every read decodes bit for bit the upstream
        snapshot at its stamped version, versions are monotone per cell,
        lag never exceeds the bound, and the upstream answered no reader
        PARAM at all — the cells absorbed the read fan-out on one diff
        stream each."""
        gang = _Gang(ncells=2, nreaders=2)
        try:
            gang.commit(3)
            out = {}
            rth = _run_readers(gang, 5, out)
            gang.commit(3)
            _join(rth, 60, "reader hung")
            gang.finish()
            for r in gang.reader_ranks:
                rec = out[r]
                assert not rec["errors"] and rec["monotone"] and rec["failovers"] == 0
                for v, lags, mirror in rec["reads"]:
                    np.testing.assert_array_equal(mirror, gang.expected(v))
                    assert lags[0] <= 4
            for cell in gang.cells.values():
                assert cell.version == gang.server._snap_version
                assert cell.diffs_installed >= 1
            assert sum(c.params_served for c in gang.cells.values()) == 2 * 5
            assert gang.server.params_served <= 2  # the writer's own reads
        finally:
            gang.close()

    def test_kill_a_cell_readers_reroute_zero_retry_exhausted(self):
        """SIGKILL-shaped cell death (transport torn, no STOP, no GOODBYE):
        every reader routed to the dead cell fails over to the live sibling
        inside its retry loop — zero RetryExhausted, reads stay bitwise."""
        gang = _Gang(ncells=2, nreaders=4)
        try:
            gang.commit(2)
            out = {}
            rth = _run_readers(gang, 8, out, deadline_s=0.5, read_sleep=0.05)
            time.sleep(0.3)  # a few reads land before the kill
            victim = gang.cell_ranks[0]
            gang.tr[victim].close()
            gang.commit(2)
            _join(rth, 90, "reader hung after the cell kill")
            survivor = gang.cells[gang.cell_ranks[1]]
            failovers = 0
            for r in gang.reader_ranks:
                rec = out[r]
                assert not rec["errors"], rec["errors"]
                failovers += rec["failovers"]
                for v, _lags, mirror in rec["reads"]:
                    np.testing.assert_array_equal(mirror, gang.expected(v))
            assert failovers >= 1, "nobody was routed to the victim?"
            assert survivor.params_served > 0
            gang.client.stop()
        finally:
            gang.close()

    def test_goodbye_retire_reroutes_readers(self):
        """Graceful cell retirement (the autoscale drain verb): readers
        follow GOODBYE-with-successor to the sibling without burning retry
        budget, and the retired cell stops cleanly."""
        gang = _Gang(ncells=2, nreaders=2)
        try:
            gang.commit(2)
            out = {}
            rth = _run_readers(gang, 10, out, read_sleep=0.03)
            time.sleep(0.15)
            victim, survivor = gang.cell_ranks
            gang.cells[victim].retire_serving(survivor)
            gang.commit(2)
            _join(rth, 60, "reader hung across retire")
            gang.finish()
            for r in gang.reader_ranks:
                rec = out[r]
                assert not rec["errors"]
                for v, _lags, mirror in rec["reads"]:
                    np.testing.assert_array_equal(mirror, gang.expected(v))
        finally:
            gang.close()


class TestStalenessEnforcement:
    """The acceptance bar: the bound is enforced, not advisory."""

    def test_property_no_read_beyond_max_lag_under_faults(self):
        """Seeded drop/delay plans on the DIFF channel: across plans, every
        answered read is bitwise the upstream snapshot at its stamped
        version, and the stamped (version, head) window never exceeds
        max_lag.  Drops force resyncs (the FULL path, itself droppable);
        delays force the lag window open."""
        max_lag = 2
        plans = [
            FaultPlan(seed=1, drop_every=3, tags=frozenset({tags.DIFF})),
            FaultPlan(seed=2, delay_every=2, delay_polls=200, tags=frozenset({tags.DIFF})),
            FaultPlan(seed=3, drop_rate=0.3, delay_rate=0.3, delay_polls=120,
                      tags=frozenset({tags.DIFF})),
        ]
        for plan in plans:
            gang = _Gang(ncells=1, nreaders=2, max_lag=max_lag, cell_hb=0.02,
                         server_wrap=lambda tr, plan=plan: FaultyTransport(tr, plan))
            try:
                gang.commit(2)
                out = {}
                rth = _run_readers(gang, 6, out, read_sleep=0.02)
                gang.commit(8)
                _join(rth, 120, f"reader hung under {plan}")
                gang.finish(timeout=90)
                for r in gang.reader_ranks:
                    rec = out[r]
                    assert not rec["errors"], (plan, rec["errors"])
                    assert rec["monotone"]
                    for v, lags, mirror in rec["reads"]:
                        np.testing.assert_array_equal(mirror, gang.expected(v))
                        assert lags[0] <= max_lag, (plan, v, lags)
            finally:
                gang.close()

    def test_lag_shed_busy_and_recovery(self):
        """Hold the diff stream shut while committing past max_lag: the
        cell (told the head by its beat echoes) sheds reads as BUSY; when
        the stream reopens it catches up and the parked reads complete —
        bitwise, within the bound."""
        max_lag = 2
        plan = FaultPlan(seed=9, delay_every=1, delay_polls=2500,
                         tags=frozenset({tags.DIFF}))
        gang = _Gang(ncells=1, nreaders=1, max_lag=max_lag, cell_hb=0.02,
                     server_wrap=lambda tr: FaultyTransport(tr, plan))
        try:
            gang.commit(1)
            cell = gang.cells[2]
            deadline = time.monotonic() + 30
            while cell.version < 0 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert cell.version >= 0, "cell never installed a frame"
            gang.commit(max_lag + 4)
            deadline = time.monotonic() + 30
            while cell.lag <= max_lag and time.monotonic() < deadline:
                time.sleep(0.02)
            assert cell.lag > max_lag, "beat echoes never moved the head"
            out = {}
            th = threading.Thread(target=_reader, args=(gang, gang.reader_ranks[0], 3, out),
                                  kwargs=dict(deadline_s=20.0), daemon=True)
            th.start()
            _join([th], 120, "reader hung in the shed window")
            gang.finish(timeout=90)
            rec = out[gang.reader_ranks[0]]
            assert not rec["errors"]
            assert rec["busy_honored"] >= 1, "no BUSY crossed the shed window"
            assert cell.lag_sheds >= 1
            for v, lags, mirror in rec["reads"]:
                np.testing.assert_array_equal(mirror, gang.expected(v))
                assert lags[0] <= max_lag
        finally:
            gang.close()


def test_launch_cells_mode_end_to_end():
    """``launch --cells N`` on the CPU through the process-gang launcher:
    cells sit between the training roles and the readers, subscribe to
    their upstream servers, and the readers report monotone versions and
    bounded lag, served entirely by the cells (int8 subscriptions)."""
    from mpit_tpu_torch.train.launch import LAUNCH_DEFAULTS, launch_processes

    cfg = LAUNCH_DEFAULTS.merged(
        np=7, serve_readers=2, cells=2, opt="downpour", epochs=1, model="linear",
        side=8, batch=64, device="cpu", ft_op_deadline_s=60.0, ft_heartbeat_s=0.2,
        serve_rounds=4, serve_interval_s=0.02, ring_mb=8)
    results = launch_processes(cfg, timeout=300)
    for r in (3, 4):
        assert results[r]["role"] == "cell" and results[r]["platform"] == "cpu"
        assert results[r]["diffs_installed"] >= 1
    assert sum(results[r]["params_served"] for r in (3, 4)) >= 8
    for r in (5, 6):
        assert results[r]["role"] == "reader"
        assert results[r]["monotone"] is True and results[r]["reads"] == 4
        assert all(v <= cfg.cell_max_lag for v in results[r]["lags"].values())
    assert results[1]["role"] == "worker"
    assert {results[r]["role"] for r in (0, 2)} == {"server"}


# ---------------------------------------------------------------------------
# mixed gangs: port and JAX cells, servers and readers (in a child process)


def mixed_fabric(server_pkg, cell_pkgs, reader_pkgs, rule="add", rounds=5, codec="int8"):
    """1 server + 1 writer + cells + fabric readers over one TCP mesh,
    each role of the package named; the writer commits ``rounds`` seeded
    GRADs, the readers read after each, then once more when every cell has
    installed the last version.  Returns {version: digest of every read at
    it}, the final version, each cell's final frame digest and the server's
    frame digest at the final version."""
    import mpit_tpu.comm.tcp as jtcp
    import mpit_tpu.ft as jft
    import mpit_tpu.ps as jps
    from mpit_tpu.cells.cell import ServingCell as JaxCell

    pkg = {"torch": dict(tcp=TcpTransport, ft=FTConfig, server=ParamServer,
                         client=ParamClient, reader=ReaderClient, cell=ServingCell),
           "jax": dict(tcp=jtcp.TcpTransport, ft=jft.FTConfig, server=jps.ParamServer,
                       client=jps.ParamClient, reader=jps.ReaderClient, cell=JaxCell)}
    ncells, nreaders = len(cell_pkgs), len(reader_pkgs)
    core = 2 + ncells
    nranks = core + nreaders
    cell_ranks = list(range(2, core))
    reader_ranks = list(range(core, nranks))
    addrs, socks = allocate_local_addresses(core)
    addrs = addrs + ["127.0.0.1:0"] * nreaders
    roles = [server_pkg, server_pkg] + list(cell_pkgs)
    tr = {}

    def build(r):
        tr[r] = pkg[roles[r]]["tcp"](r, nranks, addrs, listener=socks[r], reconnect=30.0,
                                      dial_peers=list(range(r)))

    ths = [threading.Thread(target=build, args=(r,)) for r in range(core)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(30)
    P = pkg[server_pkg]
    kw = {"device": "cpu"} if server_pkg == "torch" else {}
    server = P["server"](0, [1], tr[0], rule=rule, cell_ranks=cell_ranks,
                         ft=P["ft"](lease_ttl_s=30.0), **kw)
    sth = threading.Thread(target=server.start, daemon=True)
    sth.start()
    cells, cth = [], []
    for c, cpk in zip(cell_ranks, cell_pkgs):
        C = pkg[cpk]
        cell = C["cell"](c, 0, tr[c], reader_ranks=reader_ranks, size=SIZE, codec=codec,
                         max_lag=64, ft=C["ft"](heartbeat_s=0.05, op_deadline_s=30.0))
        cells.append(cell)
        cth.append(threading.Thread(target=cell.start, daemon=True))
        cth[-1].start()
    rng = np.random.default_rng(5)
    client = P["client"](1, [0], tr[1], seed_servers=True, ft=P["ft"](op_deadline_s=30.0))
    w0 = rng.standard_normal(SIZE).astype(np.float32)
    grad = np.zeros(SIZE, np.float32)
    client.start(w0.copy(), grad)
    rtr, readers, mirrors = [], [], []
    for r, rpk in zip(reader_ranks, reader_pkgs):
        R = pkg[rpk]
        rtr.append(R["tcp"](r, nranks, addrs, reconnect=30.0, dial_peers=cell_ranks,
                            listen=False))
        readers.append(R["reader"](r, [0], rtr[-1], codec=codec, cells={0: cell_ranks},
                                   ft=R["ft"](op_deadline_s=30.0)))
        mirrors.append(np.zeros(SIZE, np.float32))
        readers[-1].start(mirrors[-1])
    seen = {}

    def read_all():
        for rc, m in zip(readers, mirrors):
            rc.read_params()
            seen.setdefault(rc.read_versions[0], set()).add(
                hashlib.sha256(m.tobytes()).hexdigest())

    for _ in range(rounds):
        grad[:] = rng.standard_normal(SIZE).astype(np.float32) * 0.1
        client.async_send_grad()
        client.wait()
        read_all()
    final = server._snap_version
    deadline = time.monotonic() + 30
    while any(c.version < final for c in cells) and time.monotonic() < deadline:
        time.sleep(0.01)
    read_all()
    from mpit_tpu_torch.comm import codec as codec_mod

    frame = server._snap_wire[codec_mod.get(codec).name][1]
    out = {"seen": {str(v): sorted(d) for v, d in seen.items()}, "final": final,
           "cells": [hashlib.sha256(bytes(c._frame)).hexdigest() for c in cells],
           "server_frame": hashlib.sha256(frame.view(np.uint8).tobytes()).hexdigest(),
           "monotone": all(rc.monotone for rc in readers),
           "copies": int(server.snapshot_copies),
           "diffs": int(server._m_diff_full.value) + int(server._m_diff_delta.value)}
    for rc in readers:
        rc.stop()
    client.stop()
    for t in cth + [sth]:
        t.join(60)
    for t in rtr + list(tr.values()):
        t.close()
    return out


MIXED_CHILD = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
    from test_torch_cells import mixed_fabric
    out = {{}}
    for rule, server, cells, readers in (
            ("add", "jax", ("jax", "jax"), ("jax", "jax")),
            ("add", "jax", ("torch", "torch"), ("torch", "jax")),
            ("add", "torch", ("jax", "jax"), ("jax", "torch")),
            ("add", "torch", ("torch", "jax"), ("torch", "jax")),
            ("add", "torch", ("torch", "torch"), ("torch", "torch")),
            ("adam", "torch", ("torch", "torch"), ("torch", "torch")),
            ("adam", "torch", ("jax", "jax"), ("jax", "torch")),
            ("adam", "torch", ("torch", "jax"), ("jax", "torch"))):
        out["-".join((rule, server) + cells + readers)] = mixed_fabric(
            server, cells, readers, rule=rule)
    import numpy as np
    from mpit_tpu.cells import wire as jwire
    from mpit_tpu_torch.cells import wire as twire
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, 5000).astype(np.uint8) for _ in range(4)]
    th, jh = twire.FrameHistory(keep=3), jwire.FrameHistory(keep=3)
    for v, f in enumerate(frames):
        th.record(v, f)
        jh.record(v, f)
    out["deltas_equal"] = all(
        th.delta(a, b).tobytes() == jh.delta(a, b).tobytes()
        and twire.apply_delta(frames[a], th.delta(a, b)).tobytes()
        == jwire.apply_delta(frames[a], jh.delta(a, b)).tobytes()
        for a, b in ((1, 2), (2, 3), (1, 3)))
    print("RESULT " + json.dumps(out))
""")


def test_mixed_cell_gangs_equal_the_jax_gang():
    """Port cells on a JAX server, JAX cells on a port server, mixed cells
    and readers of both packages, on int8 subscriptions: under the ``add``
    rule each gang's reads at every version are the all-JAX gang's bytes;
    over the port server's Adam shards (K3's twin on the CPU; the JAX
    package's Adam rounds some elements an ulp apart through XLA, see
    ``tests/test_torch_rules.py``) JAX cells and readers read the all-port
    gang's bytes.  Every read at a version agrees, and each cell installed
    its upstream's frame byte for byte."""
    code = MIXED_CHILD.format(repo=REPO, tests=os.path.join(REPO, "tests"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=400, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    runs = json.loads(line[len("RESULT "):])
    assert runs.pop("deltas_equal") is True  # FrameHistory deltas: the JAX bytes
    refs = {"add": runs.pop("add-jax-jax-jax-jax-jax"),
            "adam": runs.pop("adam-torch-torch-torch-torch-torch")}
    for want in refs.values():
        assert all(len(d) == 1 for d in want["seen"].values())
        assert want["cells"] == [want["server_frame"]] * 2
    for name, got in runs.items():
        want = refs[name.split("-")[0]]
        assert got["final"] == want["final"], name
        assert got["server_frame"] == want["server_frame"], name
        assert got["cells"] == [want["server_frame"]] * 2, name
        assert got["monotone"], name
        assert got["seen"][str(got["final"])] == want["seen"][str(want["final"])], name
        for v, digests in got["seen"].items():
            assert len(digests) == 1, (name, v)
            if v in want["seen"]:
                assert digests == want["seen"][v], (name, v)


# ---------------------------------------------------------------------------
# autoscale binding


class TestCellAutoscaler:
    def _scaler(self, samples_seq, cells, **cfg_kw):
        from mpit_tpu_torch.cells.autoscale import CellAutoscaler, CellSLO
        from mpit_tpu_torch.shardctl.autoscale import AutoscaleConfig

        cfg = AutoscaleConfig(slo=CellSLO(max_lag=4.0).to_slo(), window_s=1.0,
                              breach_windows=2, idle_windows=4, cooldown_s=0.0,
                              min_servers=1, max_servers=4, **cfg_kw)
        verbs = []
        scaler = CellAutoscaler(cfg, add_cell=lambda: verbs.append("up") or True,
                                drain_cell=lambda: verbs.append("down") or True,
                                live_cells=lambda: list(cells))
        t = [0.0]
        scaler._clock = lambda: t[0]
        seq = iter(samples_seq)
        scaler._sample = lambda: next(seq)
        return scaler, verbs, t

    @staticmethod
    def _sample(lag, rank=2):
        return [("mpit_cell_lag", {"rank": str(rank)}, float(lag)),
                ("mpit_ps_params_served_total", {"rank": str(rank)}, 100.0)]

    def test_lag_breach_scales_up_idle_drains(self):
        cells = [2]
        hot, cold = self._sample(9), self._sample(0)
        scaler, verbs, t = self._scaler([hot, hot, hot, cold, cold, cold, cold, cold], cells)
        actions = []
        for _ in range(8):
            t[0] += 1.5
            d = scaler.pump()
            actions.append(d.action)
            if d.action == "up":
                cells.append(3)
            if d.action == "down" and len(cells) > 1:
                cells.pop()
        assert "up" in actions and verbs[0] == "up"
        assert "down" in actions, actions
        assert scaler.audit and all("window" in a for a in scaler.audit)

    def test_min_bound_holds_drain(self):
        cells = [2]
        scaler, verbs, t = self._scaler([self._sample(0)] * 6, cells)
        for _ in range(6):
            t[0] += 1.5
            scaler.pump()
        assert verbs == []
        assert any(a["reason"] == "at_min" for a in scaler.audit)

    def test_cell_window_restricts_to_cell_ranks(self):
        from mpit_tpu.cells.autoscale import cell_window as jax_cell_window
        from mpit_tpu_torch.cells.autoscale import cell_window

        cur = [("mpit_cell_lag", {"rank": "2"}, 3.0),
               ("mpit_cell_lag", {"rank": "9"}, 50.0),  # not a cell
               ("mpit_ps_params_served_total", {"rank": "2"}, 10.0),
               ("mpit_ps_params_served_total", {"rank": "0"}, 999.0),
               ("mpit_ps_busy_replies_total", {"rank": "2"}, 10.0)]
        w = cell_window(1.0, cur, None, [2])
        assert (w.staleness, w.ops, w.busy_ratio, w.gang_size) == (3.0, 10.0, 0.5, 1)
        assert w.to_dict() == jax_cell_window(1.0, cur, None, [2]).to_dict()
