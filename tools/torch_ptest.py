#!/usr/bin/env python3
"""PS push/pull bandwidth of the port over shm — the twin of
``benchmarks/ptest.py``'s shm leg (the asyncsgd/ptest.lua analog).

Half the ranks serve shards of one flat float32 vector of
``MPIT_BENCH_MB`` megabytes, the rest run ``MPIT_BENCH_ROUNDS`` rounds of
{pull params, push grads, wait}; the row is ``2*T*clients*size*4/elapsed``
MB/s bi-directional (reference ptest.lua:58-67).  The port's
ParamServer/ParamClient talk over the port's native shm transport, and
every server holds its shard on the card (``MPIT_BENCH_DEVICE=cpu`` puts
them on the CPU, for a dry run on a machine without one).

- ``MPIT_BENCH_GANG=procs`` (default): one OS process per rank, the
  reference's ``mpirun -np N`` shape.  Each client times its round loop
  after a client-only barrier; the elapsed time is the union of the
  client windows, so start-up and seeding are left out.  Each server also
  reports its per-GRAD apply: host time from the frame's copy to the
  device to the shard rule's result on the device (synchronized), median
  over its applies.
- ``MPIT_BENCH_GANG=threads``: every rank a thread of this process (one
  GIL: a debugging mode, slower than the processes).

Env, with the JAX twin's names and defaults: ``MPIT_BENCH_MB`` (64),
``MPIT_BENCH_ROUNDS`` (20), ``MPIT_BENCH_SERVERS`` / ``MPIT_BENCH_CLIENTS``
(2 / 2), ``MPIT_BENCH_CODECS`` (comma list: one leg per codec; empty =
``MPIT_PS_CODEC``), ``MPIT_BENCH_REPS`` (1; the row is the median, every
run in ``value_runs``), ``MPIT_BENCH_GANG``.

The fault-tolerance and observability legs of the JAX twin, in process
gangs only:

- ``MPIT_BENCH_HEARTBEAT=1`` / ``MPIT_BENCH_OBS=1``: each codec's leg runs
  with heartbeats (and the servers' leases) off, then on / with the
  metrics registry and op spans off, then on (``heartbeat`` and ``obs``
  in the row);
- ``MPIT_BENCH_STATUS=1``: one more codec-none leg with every child's
  statusd endpoint up (a free loopback base port, or
  ``MPIT_BENCH_STATUS_PORT``) while the parent scrapes rank 0's
  ``/metrics``; ``status_polls`` counts the scrapes, and none is an error;
- ``MPIT_BENCH_DECOMP=1``: one more codec-none leg on the framed
  ``FLAG_TIMING`` wire with every child's trace part, merged and run
  through ``obs analyze``: per-phase p50/p99 (``phases``) and
  ``join_rate`` in the row;
- ``MPIT_BENCH_PROFILE=1``: one more codec-none leg with the CPU profile
  and traces on, run through ``obs profile``: per-rank ``cpu_util``.

The shard-control legs of the JAX twin, in process gangs only:

- ``MPIT_BENCH_SKEW=1``: two more codec-none legs under an injected
  straggler — the last server's replies crawl out ``MPIT_BENCH_SKEW_POLLS``
  (600) test()-polls late — first with the shard-control rebalance policy
  off (a static map), then on; an extra rank runs the controller, which
  migrates the slow server's shard away once its busy report dominates
  (``skew``, ``rebalance``, ``skew_polls``, and the controller's
  ``map_version`` and ``rebalances`` in the row);
- ``MPIT_BENCH_ELASTIC=1``: the 1 -> 2 -> 1 server sweep, three codec-none
  legs (metric ``ps_pushpull_bandwidth_elastic``, ``phase`` start / grown /
  shrunk), each server a fixed-capacity member applying at
  ``MPIT_BENCH_ELASTIC_MBS`` (300; 0 = unthrottled).

The read-path legs of the JAX twin, over the port's TCP event loop (one
process per server, the writer and each cell; reader-host processes drive
many readers each, one transport and one ``ReaderClient`` a reader):

- ``MPIT_BENCH_READERS=64,256``: per count N, ``MPIT_BENCH_SERVERS``
  servers (on the card) + 1 writer + N READ-ONLY readers pulling the whole
  vector (``MPIT_BENCH_READER_MB``, 0.25) ``MPIT_BENCH_READER_ROUNDS`` (6)
  times, one read per ``MPIT_BENCH_READER_INTERVAL_S`` (1.0, start-
  staggered), over ``MPIT_BENCH_READER_HOSTS`` (1) reader-host processes,
  while the writer commits a version per interval once every reader is
  warm; servers admit against ``MPIT_BENCH_READER_BUDGET_MB`` (8).  Row
  ``ps_serve_read_latency``: pooled read p50 (``value``) and p99 in ms,
  aggregate MB/s, BUSY issued and honoured, and ``snapshot_copies`` against
  the committed versions (more copies than versions + servers fails the
  leg: one copy per version whatever the reader count);
- ``MPIT_BENCH_CELLS=2``: per cell count, 1 server + 1 writer + N cells +
  ``MPIT_BENCH_CELL_READERS`` (96) fabric-routed readers over
  ``MPIT_BENCH_CELL_HOSTS`` (2) reader hosts, every serving member modelled
  at ``MPIT_BENCH_CELL_MBS`` (60) of reply capacity; the N=0 control (the
  readers on the server itself) runs first, and with ``MPIT_BENCH_CELL_KILL``
  (1) a kill leg SIGKILLs one cell 40% into the read window and requires
  zero ``RetryExhausted`` and at least one failover.  Row
  ``ps_cells_serving``: aggregate MB/s, read and GRAD p50/p99, failovers,
  the largest lag seen against ``MPIT_BENCH_CELL_MAX_LAG`` (8), diffs and
  resyncs.

The stream, agg and LM legs ride layers of later slices of the port;
setting one raises, naming the slice.

Prints one JSON line per codec:
``{"metric": "ps_pushpull_bandwidth_shm", "value": MB/s, "unit": "MB/s",
"codec": ..., "value_runs": [...], ...}``.  MB/s counts logical payload
bytes, so a quantizing codec's smaller frames show as more MB/s.

Run from the repository root: ``python3 tools/torch_ptest.py``.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

MB = float(os.environ.get("MPIT_BENCH_MB", "64"))
ROUNDS = int(os.environ.get("MPIT_BENCH_ROUNDS", "20"))
NSERVERS = int(os.environ.get("MPIT_BENCH_SERVERS", "2"))
NCLIENTS = int(os.environ.get("MPIT_BENCH_CLIENTS", "2"))
CODECS = [c for c in os.environ.get("MPIT_BENCH_CODECS", "").split(",") if c]
REPS = max(int(os.environ.get("MPIT_BENCH_REPS", "1")), 1)
GANG = os.environ.get("MPIT_BENCH_GANG", "procs")
DEVICE = os.environ.get("MPIT_BENCH_DEVICE", "cuda")
GANG_TIMEOUT = float(os.environ.get("MPIT_BENCH_GANG_TIMEOUT", "900"))


def _on(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0")


HEARTBEAT_SWEEP = _on("MPIT_BENCH_HEARTBEAT")
OBS_SWEEP = _on("MPIT_BENCH_OBS")
STATUS_SWEEP = _on("MPIT_BENCH_STATUS")
STATUS_PORT = int(os.environ.get("MPIT_BENCH_STATUS_PORT", "0"))  # 0: a free one
DECOMP_SWEEP = _on("MPIT_BENCH_DECOMP")
DECOMP_DEADLINE = float(os.environ.get("MPIT_BENCH_DECOMP_DEADLINE", "120"))
PROFILE_SWEEP = _on("MPIT_BENCH_PROFILE")
SKEW_SWEEP = _on("MPIT_BENCH_SKEW")
SKEW_POLLS = int(os.environ.get("MPIT_BENCH_SKEW_POLLS", "600"))
SKEW_DEADLINE = float(os.environ.get("MPIT_BENCH_SKEW_DEADLINE", "30"))
ELASTIC_SWEEP = _on("MPIT_BENCH_ELASTIC")
ELASTIC_MBS = float(os.environ.get("MPIT_BENCH_ELASTIC_MBS", "300"))

READERS_SWEEP = [int(x) for x in os.environ.get("MPIT_BENCH_READERS", "").split(",") if x]
READER_MB = float(os.environ.get("MPIT_BENCH_READER_MB", "0.25"))
READER_ROUNDS = int(os.environ.get("MPIT_BENCH_READER_ROUNDS", "6"))
READER_INTERVAL = float(os.environ.get("MPIT_BENCH_READER_INTERVAL_S", "1.0"))
READER_BUDGET_MB = float(os.environ.get("MPIT_BENCH_READER_BUDGET_MB", "8"))
READER_HOSTS = max(int(os.environ.get("MPIT_BENCH_READER_HOSTS", "1")), 1)
CELLS_SWEEP = [int(x) for x in os.environ.get("MPIT_BENCH_CELLS", "").split(",") if x]
CELL_READERS = int(os.environ.get("MPIT_BENCH_CELL_READERS", "96"))
CELL_MB = float(os.environ.get("MPIT_BENCH_CELL_MB", "0.25"))
CELL_ROUNDS = int(os.environ.get("MPIT_BENCH_CELL_ROUNDS", "6"))
CELL_INTERVAL = float(os.environ.get("MPIT_BENCH_CELL_INTERVAL_S", "0.15"))
CELL_MBS = float(os.environ.get("MPIT_BENCH_CELL_MBS", "60"))
CELL_MAX_LAG = int(os.environ.get("MPIT_BENCH_CELL_MAX_LAG", "8"))
CELL_KILL = _on("MPIT_BENCH_CELL_KILL") or "MPIT_BENCH_CELL_KILL" not in os.environ
CELL_HOSTS = max(int(os.environ.get("MPIT_BENCH_CELL_HOSTS", "2")), 1)

#: legs of the JAX twin that ride layers of later slices of the port
LATER_LEGS = {
    "MPIT_BENCH_STREAM": "chunked streaming (slice 5f, streaming with comm/pool)",
    "MPIT_BENCH_AGG": "hierarchical aggregation (slice 5g, agg)",
    "MPIT_BENCH_LM": "the LM workload through the PS gang (slice 7b, lm)",
}

_GANG_SEQ = itertools.count(1)  # unique shm namespace per gang (pid + sequence)

# A client-only barrier tag, outside the PS and collectives tag ranges.
_SYNC_TAG = 59999


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def refuse_later_legs() -> None:
    for name, owner in LATER_LEGS.items():
        if _on(name):
            raise NotImplementedError(f"{name} belongs to {owner} of the port")
    if (HEARTBEAT_SWEEP or OBS_SWEEP or STATUS_SWEEP or DECOMP_SWEEP
            or PROFILE_SWEEP or SKEW_SWEEP or ELASTIC_SWEEP or READERS_SWEEP
            or CELLS_SWEEP) and GANG != "procs":
        raise ValueError(
            "MPIT_BENCH_HEARTBEAT/MPIT_BENCH_OBS/MPIT_BENCH_STATUS/"
            "MPIT_BENCH_DECOMP/MPIT_BENCH_PROFILE/MPIT_BENCH_SKEW/"
            "MPIT_BENCH_ELASTIC/MPIT_BENCH_READERS/MPIT_BENCH_CELLS need "
            "MPIT_BENCH_GANG=procs")
    mode = os.environ.get("MPIT_BENCH_MODE", "shm")
    if mode != "shm":
        raise NotImplementedError(
            f"MPIT_BENCH_MODE={mode}: the twin measures the shm leg only")
    if GANG not in ("procs", "threads"):
        raise ValueError(f"MPIT_BENCH_GANG must be procs or threads, got {GANG!r}")


def _ring_bytes(size: int) -> int:
    # Ring sized for the rank's aggregate inbound traffic: every peer on
    # the other side may have a full shard in flight into this rank's one
    # inbox ring, so a per-shard ring is perpetually full and each
    # transfer degrades into ring-granularity handoff cycles.
    shard_bytes = size * 4 // max(NSERVERS, 1)
    peers = max(NSERVERS, NCLIENTS)
    return max(64 << 20, 2 * peers * shard_bytes + (16 << 20))


def _mbs(size: int, dt: float) -> float:
    # Bi-directional bytes moved per client per round = 2 * size * 4.
    return 2 * ROUNDS * NCLIENTS * size * 4 / dt / 2**20


def _timed_applies(server, device):
    """Wrap the server's per-GRAD path (frame copy to the device, decode,
    rule apply): each apply's host time, synchronized on the card, is
    appended to the returned list."""
    import torch

    times = []
    rule, on_device = server.rule, server._on_device
    start = [None]

    def timed_on_device(arr):
        if start[0] is None:
            start[0] = time.perf_counter()
        return on_device(arr)

    def timed_apply(p, g, state):
        out = rule.apply(p, g, state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - start[0])
        start[0] = None
        return out

    server._on_device = timed_on_device
    server.rule = rule._replace(apply=timed_apply)
    return times


def _throttle_applies(server, mbs: float) -> None:
    """The elastic sweep's member-capacity model: every GRAD apply blocks
    this server for shard_bytes/rate wall-seconds, so each member is a
    fixed-capacity resource and the aggregate rate follows membership,
    not how the host time-slices N processes."""
    rule = server.rule

    def throttled(p, g, state):
        time.sleep(p.numel() * 4 / (mbs * 2**20))
        return rule.apply(p, g, state)

    server.rule = rule._replace(apply=throttled)


def _client_barrier(client, transport, cranks, rank) -> None:
    """Align the client windows: the first client collects a 'ready' from
    every other client, then answers each with 'go'."""
    if rank == cranks[0]:
        for peer in cranks[1:]:
            while not transport.iprobe(peer, _SYNC_TAG):
                client.ping()
            transport.recv(peer, _SYNC_TAG)
        for peer in cranks[1:]:
            transport.send(b"go", peer, _SYNC_TAG)
    else:
        transport.send(b"rdy", cranks[0], _SYNC_TAG)
        while not transport.iprobe(cranks[0], _SYNC_TAG):
            client.ping()
        transport.recv(cranks[0], _SYNC_TAG)


def _gang_child() -> None:
    """One rank of the process gang (``--gang-child``): a server runs the
    serve loop to completion; a client times its round loop; each writes
    its result to ``PTEST_RESULT``.  In the skew legs an extra last rank
    runs the shard controller and the last server's replies are
    delay-injected (the straggler under test)."""
    import numpy as np
    import statistics

    from mpit_tpu_torch.comm.collectives import HostCollectives
    from mpit_tpu_torch.comm.shm import ShmTransport
    from mpit_tpu_torch.ft import FaultPlan, FaultyTransport, FTConfig
    from mpit_tpu_torch.obs import maybe_start_statusd, maybe_write_rank_trace
    from mpit_tpu_torch.ps import ParamClient, ParamServer, tags

    spec = json.loads(os.environ["PTEST_GANG"])
    rank = int(os.environ["PTEST_RANK"])
    skew = spec.get("skew")
    nranks = spec["nservers"] + spec["nclients"] + (1 if skew else 0)
    sranks = list(range(spec["nservers"]))
    cranks = list(range(spec["nservers"], spec["nservers"] + spec["nclients"]))
    ctl_rank = nranks - 1 if skew else None
    size = spec["size"]
    # Live introspection (no-op unless MPIT_OBS_HTTP rode in: the status leg).
    maybe_start_statusd(rank, role=("controller" if rank == ctl_rank else
                                    "server" if rank in sranks else "client"))
    # Explicit FTConfig either way: the A/B must measure the heartbeat
    # machinery, not whatever MPIT_FT_* is in the caller's env.  A very
    # generous TTL: the leg measures liveness cost, not eviction.
    heartbeat = bool(spec.get("heartbeat"))
    client_ft = FTConfig(heartbeat_s=0.05) if heartbeat else FTConfig()
    server_ft = FTConfig(lease_ttl_s=120.0) if heartbeat else FTConfig()
    if spec.get("decomp"):
        # The decomposition leg: framed wire + FLAG_TIMING tails, with a
        # deadline far above any op (the column is where an op's time
        # goes, not the retry machinery).
        client_ft = FTConfig(op_deadline_s=float(spec["decomp"]["deadline_s"]),
                             timing=True)
    if skew:
        # Shard control: framed ops with a deadline sized for the
        # straggler's delayed replies, server beats for the controller.
        client_ft = FTConfig(op_deadline_s=float(skew["deadline_s"]), max_retries=8)
        server_ft = FTConfig(heartbeat_s=0.05)
    transport = ShmTransport(spec["ns"], rank, nranks, ring_bytes=spec["ring"])
    # No PS traffic until every ring is mapped.
    HostCollectives(transport).barrier()
    if skew and rank == ctl_rank:
        from mpit_tpu_torch.shardctl import RebalancePolicy, ShardController

        ctl = ShardController(rank, transport, sranks, cranks, policy=RebalancePolicy(
            ratio=2.0, min_busy_s=0.01, cooldown_s=0.5, enabled=bool(skew["rebalance"])))
        ctl.serve()
        result = {"role": "controller", "rebalances": int(ctl._m_rebal.value),
                  "map_version": getattr(ctl.smap, "version", None)}
    elif rank in sranks:
        ep = transport
        if skew and rank == skew["slow_server"]:
            # The straggler: every reply crawls out delay_polls test()-polls
            # late (send-side injection, message-atomic).
            ep = FaultyTransport(ep, FaultPlan(
                delay_every=1, delay_polls=int(skew["delay_polls"]),
                tags=frozenset({tags.GRAD_ACK, tags.PARAM, tags.PARAM_PUSH_ACK})))
        server = ParamServer(rank, cranks, ep, rule="add", device=spec["device"],
                             ft=server_ft, controller_rank=ctl_rank)
        if spec.get("throttle_mbs"):
            _throttle_applies(server, float(spec["throttle_mbs"]))
        times = _timed_applies(server, server.device)
        server.start()
        result = {"role": "server", "grads_applied": server.grads_applied,
                  "snapshot_copies": server.snapshot_copies,
                  "snapshot_hits": server.snapshot_hits,
                  "platform": server.device.type,
                  "apply_us": statistics.median(times) * 1e6 if times else None}
    else:
        client = ParamClient(rank, sranks, transport,
                             seed_servers=(rank == cranks[0]), ft=client_ft,
                             shardctl=bool(skew), controller_rank=ctl_rank)
        param = np.zeros(size, np.float32)
        grad = np.full(size, 1e-6, np.float32)
        client.start(param, grad)
        # One warm-up pull per client (every server has served once), then
        # the client-only barrier: the seeding push stays out of the window.
        client.async_recv_param()
        client.wait()
        _client_barrier(client, transport, cranks, rank)
        t0 = time.time()
        for _ in range(spec["rounds"]):
            client.async_recv_param()
            client.async_send_grad()
            client.wait()
        t1 = time.time()
        client.stop()
        result = {"role": "client", "t0": t0, "t1": t1}
    # This rank's trace part (no-op unless MPIT_OBS_TRACE rode in: the
    # decomposition and profile legs); the parent merges and analyzes.
    maybe_write_rank_trace(rank, role=result["role"])
    transport.close()
    with open(os.environ["PTEST_RESULT"], "w") as fh:
        json.dump(result, fh)


def _status_poller(port: int, stop, polls) -> None:
    """Scrape one rank's /metrics until told to stop, counting the
    successful scrapes (the status leg's live-serving column)."""
    import urllib.request

    while not stop.is_set():
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                        timeout=1) as resp:
                if resp.status == 200 and resp.read():
                    polls[0] += 1
        except OSError:
            pass  # the child still importing torch, or already gone
        stop.wait(0.2)


def _shm_run_procs(size: int, seq: int, servers_out: list, *,
                   heartbeat: bool = False, obs: bool = False,
                   status: bool = False, decomp: bool = False,
                   profile: bool = False, extra: dict | None = None,
                   skew_rebalance=None, throttle_mbs: float = 0.0) -> float:
    """One timed gang, one OS process per rank; returns MB/s and appends
    the servers' results to ``servers_out``.  The leg's columns (status
    scrapes, the decomposition, the profile, the skew controller's map)
    land in ``extra``."""
    from mpit_tpu_torch.train.gang import check_shm_room

    nranks = NSERVERS + NCLIENTS + (1 if skew_rebalance is not None else 0)
    ns = f"tptest_{os.getpid()}_{seq}"
    spec = {"ns": ns, "nservers": NSERVERS, "nclients": NCLIENTS,
            "size": size, "ring": _ring_bytes(size), "rounds": ROUNDS,
            "device": DEVICE, "heartbeat": int(heartbeat)}
    if decomp:
        spec["decomp"] = {"deadline_s": DECOMP_DEADLINE}
    if skew_rebalance is not None:
        spec["skew"] = {"slow_server": NSERVERS - 1, "delay_polls": SKEW_POLLS,
                        "rebalance": int(bool(skew_rebalance)),
                        "deadline_s": SKEW_DEADLINE}
    if throttle_mbs:
        spec["throttle_mbs"] = throttle_mbs
    check_shm_room(nranks, spec["ring"])
    tmpdir = tempfile.mkdtemp(prefix=f"{ns}_")
    trace = os.path.join(tmpdir, "trace.json")
    status_port = None
    if status:
        from mpit_tpu_torch.obs.statusd import free_base_port

        status_port = STATUS_PORT or free_base_port(nranks)
    procs, result_files = [], []
    for rank in range(nranks):
        result_path = os.path.join(tmpdir, f"rank{rank}.json")
        result_files.append(result_path)
        # Explicit either way: the A/B measures the obs machinery, not
        # whatever MPIT_OBS* the caller's env carries.
        env = dict(os.environ, PTEST_GANG=json.dumps(spec), PTEST_RANK=str(rank),
                   PTEST_RESULT=result_path, MPIT_OBS="1" if obs else "0")
        for name in ("MPIT_OBS_TRACE", "MPIT_OBS_PROFILE", "MPIT_OBS_HTTP"):
            env.pop(name, None)  # each implies obs
        if decomp or profile:
            env.update(MPIT_OBS="1", MPIT_OBS_TRACE=trace)
        if profile:
            env["MPIT_OBS_PROFILE"] = "1"
        if status_port is not None:
            env["MPIT_OBS_HTTP"] = str(status_port)
        with open(os.path.join(tmpdir, f"rank{rank}.log"), "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--gang-child"],
                env=env, stdout=fh, stderr=subprocess.STDOUT, text=True))
    poll_stop = poller = None
    polls = [0]
    if status_port is not None:
        poll_stop = threading.Event()
        poller = threading.Thread(target=_status_poller,
                                  args=(status_port, poll_stop, polls), daemon=True)
        poller.start()
    deadline = time.monotonic() + GANG_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            bad = next((r for r, p in enumerate(procs)
                        if p.poll() not in (None, 0)), None)
            if bad is not None or time.monotonic() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
                for path in result_files:
                    with open(path.replace(".json", ".log")) as fh:
                        sys.stderr.write(fh.read())
                raise RuntimeError(f"gang rank {bad} failed (logs: {tmpdir})"
                                   if bad is not None else
                                   f"gang timed out (logs: {tmpdir})")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if poll_stop is not None:
            poll_stop.set()
            poller.join(timeout=5)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"gang ranks {bad} failed (logs: {tmpdir})")
    recs = []
    for path in result_files:
        with open(path) as fh:
            recs.append(json.load(fh))
    servers_out.extend(r for r in recs if r["role"] == "server")
    ctl = [r for r in recs if r["role"] == "controller"]
    if ctl and extra is not None:
        extra["map_version"] = ctl[0]["map_version"]
        extra["rebalances"] = ctl[0]["rebalances"]
    windows = [(r["t0"], r["t1"]) for r in recs if r["role"] == "client"]
    dt = max(w[1] for w in windows) - min(w[0] for w in windows)
    if extra is not None:
        if status_port is not None:
            if not polls[0]:
                raise RuntimeError(
                    "status leg: the parent never got a 200 from rank 0's "
                    "/metrics while the gang ran")
            extra["status_polls"] = extra.get("status_polls", 0) + polls[0]
        if decomp:
            extra.update(_analyze_gang_trace(trace))
        if profile:
            extra.update(_profile_gang_trace(trace))
    import shutil

    shutil.rmtree(tmpdir, ignore_errors=True)
    mbs = _mbs(size, dt)
    log(f"[shm] {ROUNDS} rounds x {NCLIENTS} client procs in {dt:.3f}s "
        f"-> {mbs:.1f} MB/s aggregate")
    return mbs


def _merged_trace(base: str) -> str:
    import glob

    from mpit_tpu_torch.obs import trace as obs_trace

    parts = sorted(glob.glob(f"{base}.rank*.json"))
    if not parts:
        raise RuntimeError("the leg completed but no rank wrote a trace part")
    obs_trace.merge_traces(base, parts)
    return base


def _analyze_gang_trace(base: str) -> dict:
    """The decomposition leg's columns: per-(op, phase) p50/p99 in ms and
    the join rate of the merged trace.  A violation is an error."""
    from mpit_tpu_torch.obs import causal as obs_causal

    report = obs_causal.analyze(_merged_trace(base))
    if report["violations"]:
        raise RuntimeError(f"decomposition leg: {len(report['violations'])} "
                           f"violation(s): {report['violations'][:3]}")
    phases = {
        op: {phase: {"p50_ms": round(p["p50_us"] / 1000.0, 3),
                     "p99_ms": round(p["p99_us"] / 1000.0, 3)}
             for phase, p in st["phases"].items() if p["total_us"] > 0}
        for op, st in report["phase_stats"].items()}
    return {"phases": phases, "join_rate": round(report["ops"]["join_rate"], 4),
            "joined_ops": report["ops"]["joined"]}


def _profile_gang_trace(base: str) -> dict:
    """The profile leg's columns: per-rank core use from ``obs profile``.
    A trace without counter samples is an error."""
    from mpit_tpu_torch.obs import profile as obs_profile

    report = obs_profile.analyze_trace(_merged_trace(base))
    if not report["counter_events"]:
        raise RuntimeError("profile leg: no counter-track samples in the trace")
    return {"counter_events": report["counter_events"],
            "cpu_util": {rank: round(row["cpu_util"], 3)
                         for rank, row in report["ranks"].items()}}


def _shm_run_threads(size: int, seq: int) -> float:
    """One timed gang, every rank a thread of this process."""
    import numpy as np

    from mpit_tpu_torch.comm.shm import ShmTransport
    from mpit_tpu_torch.ps import ParamClient, ParamServer

    nranks = NSERVERS + NCLIENTS
    sranks = list(range(NSERVERS))
    cranks = list(range(NSERVERS, nranks))
    ns = f"tptest_{os.getpid()}_{seq}"
    transports = [ShmTransport(ns, r, nranks, ring_bytes=_ring_bytes(size))
                  for r in range(nranks)]
    servers = [ParamServer(r, cranks, transports[r], rule="add", device=DEVICE)
               for r in sranks]
    errors = []

    def guarded(fn, *args):
        try:
            fn(*args)
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    sthreads = [threading.Thread(target=guarded, args=(s.start,), daemon=True)
                for s in servers]
    clients = [ParamClient(r, sranks, transports[r], seed_servers=(r == cranks[0]))
               for r in cranks]
    bufs = [(np.zeros(size, np.float32), np.full(size, 1e-6, np.float32))
            for _ in cranks]

    def start_client(i):
        clients[i].start(*bufs[i])
        clients[i].async_recv_param()
        clients[i].wait()

    def rounds(i):
        for _ in range(ROUNDS):
            clients[i].async_recv_param()
            clients[i].async_send_grad()
            clients[i].wait()

    def run_all(target, what):
        threads = [threading.Thread(target=guarded, args=(target, i), daemon=True)
                   for i in range(NCLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(GANG_TIMEOUT)
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads):
            raise RuntimeError(f"[shm] {what} did not finish in {GANG_TIMEOUT}s")

    try:
        for t in sthreads:
            t.start()
        run_all(start_client, "client start")
        t0 = time.perf_counter()
        run_all(rounds, "client rounds")
        dt = time.perf_counter() - t0
        for c in clients:
            c.stop()
        for t in sthreads:
            t.join(GANG_TIMEOUT)
        if errors:
            raise errors[0]
    finally:
        for t in transports:
            t.close()
    mbs = _mbs(size, dt)
    log(f"[shm] {ROUNDS} rounds x {NCLIENTS} client threads in {dt:.3f}s "
        f"-> {mbs:.1f} MB/s aggregate")
    return mbs


def bench_shm(codec: str = "", heartbeat: bool = False, obs: bool = False,
              status: bool = False, decomp: bool = False,
              profile: bool = False, skew_rebalance=None,
              throttle_mbs: float = 0.0) -> dict:
    """One shm push/pull measurement (``REPS`` runs); ``codec`` overrides
    ``MPIT_PS_CODEC`` for the gang; the flags select the leg (see the
    module docstring)."""
    import statistics

    from mpit_tpu_torch.comm import codec as codec_mod

    if codec:
        os.environ["MPIT_PS_CODEC"] = codec
    codec_name = codec_mod.get(codec or None).name
    size = int(MB * (1 << 20) / 4)
    log(f"[shm] {NSERVERS} servers ({DEVICE}) + {NCLIENTS} clients, codec "
        f"{codec_name} ({codec_mod.native_path()}), payload "
        f"{size * 4 / 2**20:.1f} MB x {REPS} rep(s), gang {GANG}, heartbeat "
        f"{int(heartbeat)}, obs {int(obs)}, status {int(status)}, decomp "
        f"{int(decomp)}, profile {int(profile)}")
    servers: list = []
    runs = []
    extra: dict = {}
    for _ in range(REPS):
        seq = next(_GANG_SEQ)
        runs.append(_shm_run_procs(size, seq, servers, heartbeat=heartbeat,
                                   obs=obs, status=status, decomp=decomp,
                                   profile=profile, extra=extra,
                                   skew_rebalance=skew_rebalance,
                                   throttle_mbs=throttle_mbs)
                    if GANG == "procs" else _shm_run_threads(size, seq))
    mbs = statistics.median(runs)
    row = {
        "metric": "ps_pushpull_bandwidth_shm",
        "value": round(mbs, 1),
        "unit": "MB/s",
        "codec": codec_name,
        "codec_path": codec_mod.native_path(),
        "heartbeat": int(heartbeat),
        "obs": int(obs),
        "gang": GANG,
        "reps": REPS,
        "value_runs": [round(v, 1) for v in runs],
        "clients": NCLIENTS,
        "servers": NSERVERS,
        "device": DEVICE,
        "mb": MB,
        "rounds": ROUNDS,
    }
    for flag, on in (("status", status), ("decomp", decomp), ("profile", profile)):
        if on:
            row[flag] = 1
    row.update(extra)
    if skew_rebalance is not None:
        row["skew"] = 1
        row["rebalance"] = int(bool(skew_rebalance))
        row["skew_polls"] = SKEW_POLLS
    applies = [s["apply_us"] for s in servers if s.get("apply_us") is not None]
    if applies:
        row["server_apply_us"] = statistics.median(applies)
        row["server_platforms"] = sorted({s["platform"] for s in servers})
    return row


def bench_elastic() -> list:
    """The 1 -> 2 -> 1 server sweep: one codec-none leg per membership
    phase, the same clients, payload and rounds throughout, so the three
    rows read as throughput tracking gang size (what a member is worth);
    the transitions themselves are the elastic tests' and
    ``chip_smoke.py``'s."""
    global NSERVERS
    saved = NSERVERS
    rows = []
    try:
        for phase, n in (("start", 1), ("grown", 2), ("shrunk", 1)):
            NSERVERS = n
            row = bench_shm("none", throttle_mbs=ELASTIC_MBS)
            row.update(metric="ps_pushpull_bandwidth_elastic", elastic=1, phase=phase)
            if ELASTIC_MBS > 0:
                row["member_capacity_mbs"] = ELASTIC_MBS
            rows.append(row)
    finally:
        NSERVERS = saved
    log(f"[elastic] 1->2->1 sweep: { {r['phase']: r['value'] for r in rows} } MB/s")
    return rows


# -- the read-path legs (TCP event loop; a process per serving role) ----------


def _raise_nofile() -> int:
    """Lift this process's open-file soft limit to its hard limit (a reader
    host holds a few descriptors per reader: its sockets, the selector and
    the wakeup pipe); returns the soft limit now in force."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    return resource.getrlimit(resource.RLIMIT_NOFILE)[0]


def _listener_from_env():
    """The listening socket the parent bound and handed down (pass_fds):
    inheriting it, not re-binding its port, keeps a sibling's outbound
    connect from taking the port in between."""
    import socket

    fd = os.environ.get("PTEST_LISTEN_FD")
    if fd is None:
        return None
    return socket.socket(socket.AF_INET, socket.SOCK_STREAM, fileno=int(fd))


def _run_role_procs(jobs, spec, flag, socks, kill=None):
    """Start one process per (role, label, batch) job with ``flag`` and the
    spec in ``PTEST_SPEC``; listening roles inherit their socket.  ``kill``
    = (label of a cell, seconds into the read window): once every reader
    host dropped its ``.started`` marker the cell is SIGKILLed that much
    later.  Returns ({(role, label): result}, killed label or None)."""
    import signal
    import shutil

    tmpdir = tempfile.mkdtemp(prefix=f"tptest_{flag.strip('-')}_{os.getpid()}_")
    procs, paths = {}, {}
    for role, label, _batch in jobs:
        paths[(role, label)] = os.path.join(tmpdir, f"{role}{label}.json")
    # Each reader host drops a marker once its readers are attached and
    # warm; the writer commits only then, so the versions move while the
    # readers read.
    markers = [path + ".started" for (role, _l), path in paths.items() if role == "readers"]
    for role, label, batch in jobs:
        path = paths[(role, label)]
        env = dict(os.environ, PTEST_SPEC=json.dumps({**spec, "role": role, "rank": label,
                                                      "batch": batch or [],
                                                      "markers": markers}),
                   PTEST_RESULT=path, MPIT_OBS="0")
        for name in ("MPIT_OBS_TRACE", "MPIT_OBS_PROFILE", "MPIT_OBS_HTTP"):
            env.pop(name, None)  # each implies obs: the legs measure it off
        pass_fds = ()
        if role != "readers":
            env["PTEST_LISTEN_FD"] = str(socks[label].fileno())
            pass_fds = (socks[label].fileno(),)
        with open(path.replace(".json", ".log"), "w") as fh:
            procs[(role, label)] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag], env=env, stdout=fh,
                stderr=subprocess.STDOUT, text=True, pass_fds=pass_fds)
    for sock in socks:
        sock.close()  # the children own their copies now
    victim = ("cell", kill[0]) if kill else None
    kill_at, killed = None, None
    deadline = time.monotonic() + GANG_TIMEOUT
    try:
        while any(p.poll() is None for p in procs.values()):
            if victim and killed is None and kill_at is None \
                    and all(os.path.exists(m) for m in markers):
                kill_at = time.monotonic() + kill[1]
            if victim and killed is None and kill_at is not None \
                    and time.monotonic() >= kill_at:
                procs[victim].send_signal(signal.SIGKILL)
                killed = kill[0]
                log(f"[cells] SIGKILLed cell {killed} in the read window")
            bad = next((job for job, p in procs.items() if p.poll() not in (None, 0)
                        and not (killed is not None and job == victim)), None)
            if bad is not None or time.monotonic() > deadline:
                for path in paths.values():
                    logp = path.replace(".json", ".log")
                    if os.path.exists(logp):
                        with open(logp) as fh:
                            sys.stderr.write(fh.read()[-4000:])
                raise RuntimeError(f"{flag} job {bad} failed (logs: {tmpdir})"
                                   if bad is not None else f"{flag} gang timed out "
                                   f"(logs: {tmpdir})")
            time.sleep(0.05)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = {}
    for job, path in paths.items():
        if job != victim or killed is None:
            with open(path) as fh:
                recs[job] = json.load(fh)
    shutil.rmtree(tmpdir, ignore_errors=True)
    return recs, killed


def _paced_reads(clients, rounds, interval, on_read=None):
    """Drive a batch of readers from one thread: start-staggered reads, one
    per ``interval`` each, every in-flight reader stepped round-robin; each
    read's latency from its async start to its drain.  ``on_read(rank,
    client)`` after each read; a reader's RetryExhausted ends that reader
    and is returned.  Returns (latency samples in s, reads, errors, t0, t1)."""
    import heapq

    from mpit_tpu_torch.ft import RetryExhausted

    batch = sorted(clients)
    base = time.monotonic()
    state = {r: {"t0": None, "reads": 0} for r in batch}
    due = [(base + (i / max(len(batch), 1)) * interval, r) for i, r in enumerate(batch)]
    heapq.heapify(due)
    samples, errors = [], []
    inflight: set = set()
    pending = len(batch)
    t_start = time.time()
    while pending or inflight:
        now = time.monotonic()
        while due and due[0][0] <= now:
            _t, r = heapq.heappop(due)
            clients[r].async_read_params()
            state[r]["t0"] = time.monotonic()
            inflight.add(r)
        for r in list(inflight):
            try:
                busy = clients[r].poll()
            except RetryExhausted as exc:
                errors.append(f"reader {r}: {exc!r}")
                inflight.discard(r)
                pending -= 1
                continue
            if busy:
                continue
            st = state[r]
            samples.append(time.monotonic() - st["t0"])
            st["reads"] += 1
            if on_read is not None:
                on_read(r, clients[r])
            inflight.discard(r)
            if st["reads"] >= rounds:
                pending -= 1
            else:
                heapq.heappush(due, (st["t0"] + interval, r))
        # Yield the core between passes: a driver spinning poll() steals the
        # cycles the serving processes need to produce the replies.
        time.sleep(0.0002 if inflight else 0.001)
    return samples, sum(st["reads"] for st in state.values()), errors, t_start, time.time()


def _await_readers(markers) -> None:
    """The writer's wait for every reader host's warm-up marker."""
    deadline = time.monotonic() + GANG_TIMEOUT
    while not all(os.path.exists(m) for m in markers):
        if time.monotonic() > deadline:
            raise RuntimeError("the reader hosts never warmed up")
        time.sleep(0.02)


def _percentiles_ms(samples):
    import numpy as np

    arr = np.asarray(samples) * 1e3
    return float(np.percentile(arr, 50)), float(np.percentile(arr, 99))


def bench_readers(nreaders: int) -> dict:
    """One serving-tier leg: servers (on the card) + 1 writer + ``nreaders``
    paced readers over the TCP event loop; the servers hold every reader's
    connection on their one I/O thread."""
    from mpit_tpu_torch.comm.tcp import allocate_local_addresses

    size = int(READER_MB * (1 << 20) / 4)
    core = NSERVERS + 1
    nranks = core + nreaders
    addrs, socks = allocate_local_addresses(core)
    addrs = addrs + ["127.0.0.1:0"] * nreaders  # readers never listen
    batches = [list(range(core + i, nranks, READER_HOSTS)) for i in range(READER_HOSTS)]
    log(f"[serve] {NSERVERS} servers ({DEVICE}) + 1 writer + {nreaders} readers "
        f"({READER_HOSTS} host proc(s)), vector {size * 4 / 2**20:.2f} MB, "
        f"{READER_ROUNDS} reads/reader at {READER_INTERVAL:.2f}s pacing")
    spec = {"addrs": addrs, "nservers": NSERVERS, "size": size, "rounds": READER_ROUNDS,
            "interval": READER_INTERVAL, "budget_mb": READER_BUDGET_MB, "device": DEVICE}
    jobs = ([("server", r, None) for r in range(NSERVERS)] + [("writer", NSERVERS, None)]
            + [("readers", core + i, b) for i, b in enumerate(batches) if b])
    recs, _ = _run_role_procs(jobs, spec, "--serve-child", socks)
    hosts = [rec for (role, _l), rec in recs.items() if role == "readers"]
    srv = [recs[("server", r)] for r in range(NSERVERS)]
    samples = [x for h in hosts for x in h["samples"]]
    reads = sum(h["reads"] for h in hosts)
    dt = max(h["t1"] for h in hosts) - min(h["t0"] for h in hosts)
    p50, p99 = _percentiles_ms(samples)
    mbs = reads * size * 4 / dt / 2**20
    copies = sum(s["snapshot_copies"] for s in srv)
    versions = sum(s["snap_version"] for s in srv)
    if copies > versions + NSERVERS:
        raise RuntimeError(
            f"snapshot cache broke under fan-out: {copies} copies for {versions} "
            "committed versions (one copy per version, whatever the reader count)")
    busy = sum(s["busy_replies"] for s in srv)
    honored = sum(h["busy_honored"] for h in hosts)
    log(f"[serve] {nreaders} readers: p50 {p50:.1f} ms, p99 {p99:.1f} ms, {mbs:.1f} MB/s "
        f"aggregate, busy={busy}/{honored} (issued/honored), copies={copies} for "
        f"{versions} versions")
    return {"metric": "ps_serve_read_latency", "unit": "ms", "value": round(p50, 3),
            "p99_ms": round(p99, 3), "readers": nreaders, "reads": reads,
            "mbs": round(mbs, 1), "vector_mb": round(size * 4 / 2**20, 3),
            "interval_s": READER_INTERVAL, "busy_replies": busy, "busy_honored": honored,
            "snapshot_copies": copies, "snap_versions": versions,
            "snapshot_hits": sum(s["snapshot_hits"] for s in srv),
            "servers": NSERVERS, "reader_hosts": READER_HOSTS, "device": DEVICE,
            "server_platforms": sorted({s["platform"] for s in srv}),
            "nofile": min(h["nofile"] for h in hosts)}


def _serve_child() -> None:
    """One process of the serving-tier gang (``--serve-child``): a server or
    the writer for its rank, or a reader host driving a batch of readers."""
    import numpy as np

    from mpit_tpu_torch.comm.tcp import TcpTransport
    from mpit_tpu_torch.ft import FTConfig
    from mpit_tpu_torch.ps import ParamClient, ParamServer, ReaderClient, ServeConfig

    spec = json.loads(os.environ["PTEST_SPEC"])
    addrs = spec["addrs"]
    nranks = len(addrs)
    sranks = list(range(spec["nservers"]))
    wrank = spec["nservers"]
    readers = list(range(wrank + 1, nranks))
    size, rounds, interval = spec["size"], spec["rounds"], spec["interval"]
    role = spec["role"]
    ft = FTConfig(op_deadline_s=120.0)
    if role == "server":
        rank = spec["rank"]
        transport = TcpTransport(rank, nranks, addrs, listener=_listener_from_env(),
                                 reconnect=120.0, dial_peers=list(range(rank)),
                                 connect_timeout=120.0)
        server = ParamServer(rank, [wrank], transport, rule="add", device=spec["device"],
                             reader_ranks=readers, serve=ServeConfig(
                                 budget_bytes=int(spec["budget_mb"] * (1 << 20))))
        server.start()
        result = {"role": "server", "busy_replies": server.busy_replies,
                  "snapshot_copies": server.snapshot_copies,
                  "snapshot_hits": server.snapshot_hits,
                  "snap_version": server._snap_version,
                  "params_served": server.params_served,
                  "grads_applied": server.grads_applied,
                  "platform": server.device.type}
    elif role == "writer":
        transport = TcpTransport(wrank, nranks, addrs, listener=_listener_from_env(),
                                 reconnect=120.0, dial_peers=sranks, connect_timeout=120.0)
        client = ParamClient(wrank, sranks, transport, seed_servers=True, ft=ft)
        client.start(np.arange(size, dtype=np.float32), np.full(size, 1e-6, np.float32))
        _await_readers(spec["markers"])
        # One committed version per pacing interval over the whole read
        # window (+1 slack): readers must see versions move.
        for _ in range(rounds + 1):
            client.async_send_grad()
            client.wait()
            time.sleep(interval)
        client.stop()
        result = {"role": "writer", "grads": rounds + 1}
    else:  # a reader host
        nofile = _raise_nofile()
        transports, clients = {}, {}
        for r in spec["batch"]:
            transports[r] = TcpTransport(r, nranks, addrs, reconnect=120.0, dial_peers=sranks,
                                         listen=False, connect_timeout=120.0)
            clients[r] = ReaderClient(r, sranks, transports[r], ft=ft)
            clients[r].start(np.zeros(size, np.float32))
        for c in clients.values():  # one warm-up read each
            c.read_params()
        open(os.environ["PTEST_RESULT"] + ".started", "w").close()
        samples, reads, errors, t0, t1 = _paced_reads(clients, rounds, interval)
        if errors:
            raise SystemExit(f"readers drew RetryExhausted: {errors}")
        for r, c in clients.items():
            assert c.monotone, f"reader {r} saw a version go back"
            c.stop()
            transports[r].close()
        result = {"role": "readers", "samples": samples, "reads": reads,
                  "busy_honored": sum(c.busy_honored for c in clients.values()),
                  "t0": t0, "t1": t1, "nofile": nofile}
        transport = None
    if transport is not None:
        transport.close()
    with open(os.environ["PTEST_RESULT"], "w") as fh:
        json.dump(result, fh)


def bench_cells(ncells: int, kill: bool = False) -> dict:
    """One serving-fabric leg: 1 server (on the card) + 1 writer + ``ncells``
    replica cells + ``CELL_READERS`` fabric-routed readers, every serving
    member modelled at ``CELL_MBS`` of reply capacity.  ``ncells=0`` is the
    direct-serving control; with ``kill`` one cell is SIGKILLed in the read
    window and the leg requires zero RetryExhausted and a failover."""
    from mpit_tpu_torch.comm.tcp import allocate_local_addresses

    size = int(CELL_MB * (1 << 20) / 4)
    core = 2 + ncells
    nranks = core + CELL_READERS
    cell_ranks = list(range(2, core))
    addrs, socks = allocate_local_addresses(core)
    addrs = addrs + ["127.0.0.1:0"] * CELL_READERS
    log(f"[cells] 1 server ({DEVICE}) + 1 writer + {ncells} cells + {CELL_READERS} "
        f"readers{' (kill leg)' if kill else ''}, vector {size * 4 / 2**20:.2f} MB, "
        f"member capacity {CELL_MBS:.0f} MB/s, {CELL_ROUNDS} reads/reader at "
        f"{CELL_INTERVAL:.2f}s pacing")
    spec = {"addrs": addrs, "ncells": ncells, "cell_ranks": cell_ranks, "size": size,
            "rounds": CELL_ROUNDS, "interval": CELL_INTERVAL, "member_mbs": CELL_MBS,
            "max_lag": CELL_MAX_LAG, "kill": kill, "device": DEVICE}
    batches = [list(range(core + i, nranks, CELL_HOSTS)) for i in range(CELL_HOSTS)]
    jobs = ([("server", 0, None), ("writer", 1, None)]
            + [("cell", c, None) for c in cell_ranks]
            + [("readers", core + i, b) for i, b in enumerate(batches) if b])
    victim = (cell_ranks[0], CELL_ROUNDS * CELL_INTERVAL * 0.4) if (kill and ncells >= 2) \
        else None
    recs, killed = _run_role_procs(jobs, spec, "--cells-child", socks, kill=victim)
    hosts = [rec for (role, _l), rec in recs.items() if role == "readers"]
    cells = [rec for (role, _l), rec in recs.items() if role == "cell"]
    writer, server = recs[("writer", 1)], recs[("server", 0)]
    samples = [x for h in hosts for x in h["samples"]]
    reads = sum(h["reads"] for h in hosts)
    failovers = sum(h["failovers"] for h in hosts)
    errors = [e for h in hosts for e in h["errors"]]
    max_lag_seen = max(h["max_lag_seen"] for h in hosts)
    dt = max(h["t1"] for h in hosts) - min(h["t0"] for h in hosts)
    mbs = reads * size * 4 / dt / 2**20
    p50, p99 = _percentiles_ms(samples)
    if kill:
        if killed is None or failovers < 1:
            raise RuntimeError(f"kill leg: killed {killed}, failovers {failovers}")
        if errors:
            raise RuntimeError(f"kill leg drew RetryExhausted: {errors}")
    if max_lag_seen > CELL_MAX_LAG:
        raise RuntimeError(f"a read stamped lag {max_lag_seen} > max_lag {CELL_MAX_LAG}")
    log(f"[cells] n={ncells}{'+kill' if kill else ''}: {mbs:.1f} MB/s aggregate reads "
        f"(p50 {p50:.1f} ms), GRAD p50 {writer['grad_p50_ms']:.1f} ms, failovers="
        f"{failovers}, max observed lag {max_lag_seen}")
    return {"metric": "ps_cells_serving", "unit": "MB/s", "value": round(mbs, 1),
            "cells": ncells, "kill": bool(kill), "readers": CELL_READERS, "reads": reads,
            "read_p50_ms": round(p50, 3), "read_p99_ms": round(p99, 3),
            "grad_p50_ms": round(writer["grad_p50_ms"], 3),
            "grad_p99_ms": round(writer["grad_p99_ms"], 3), "member_mbs": CELL_MBS,
            "vector_mb": round(size * 4 / 2**20, 3), "interval_s": CELL_INTERVAL,
            "failovers": failovers, "busy_honored": sum(h["busy_honored"] for h in hosts),
            "max_lag_seen": max_lag_seen, "max_lag_bound": CELL_MAX_LAG,
            "diffs_installed": sum(c["diffs_installed"] for c in cells),
            "resyncs": sum(c["resyncs"] for c in cells),
            "diffs_sent": server["diffs_sent"], "snapshot_copies": server["snapshot_copies"],
            "snap_version": server["snap_version"], "server_platform": server["platform"],
            "device": DEVICE}


def _cells_child() -> None:
    """One process of the serving-fabric gang (``--cells-child``): the
    training server (the diff producer; direct serving in the N=0 control),
    the writer (timing its own GRADs), one cell, or a reader host."""
    import numpy as np

    from mpit_tpu_torch.comm.tcp import TcpTransport
    from mpit_tpu_torch.ft import FTConfig
    from mpit_tpu_torch.ps import ParamClient, ParamServer, ReaderClient, ServeConfig

    spec = json.loads(os.environ["PTEST_SPEC"])
    addrs = spec["addrs"]
    nranks = len(addrs)
    cell_ranks, ncells = spec["cell_ranks"], spec["ncells"]
    readers = list(range(2 + ncells, nranks))
    size, rounds, interval = spec["size"], spec["rounds"], spec["interval"]
    role = spec["role"]

    def throttle(member) -> None:
        """A fixed per-member reply capacity: every granted read spends
        frame_bytes / member_mbs of the member's single-threaded time."""
        inner = member._snapshot_wire
        cost = size * 4 / (spec["member_mbs"] * (1 << 20))

        def wrapped(codec):
            time.sleep(cost)
            return inner(codec)

        member._snapshot_wire = wrapped

    transport = None
    if role == "server":
        transport = TcpTransport(0, nranks, addrs, listener=_listener_from_env(),
                                 reconnect=120.0, dial_peers=[], connect_timeout=120.0)
        server = ParamServer(0, [1], transport, rule="add", device=spec["device"],
                             reader_ranks=(readers if ncells == 0 else None),
                             cell_ranks=(cell_ranks or None),
                             serve=ServeConfig(budget_bytes=1 << 30),
                             ft=FTConfig(lease_ttl_s=5.0))
        if ncells == 0:
            throttle(server)  # the control serves the reads itself
        server.start()
        result = {"role": "server", "snap_version": server._snap_version,
                  "params_served": server.params_served,
                  "grads_applied": server.grads_applied,
                  "snapshot_copies": server.snapshot_copies,
                  "diffs_sent": server.diffs_sent, "platform": server.device.type}
    elif role == "writer":
        transport = TcpTransport(1, nranks, addrs, listener=_listener_from_env(),
                                 reconnect=120.0, dial_peers=[0], connect_timeout=120.0)
        client = ParamClient(1, [0], transport, seed_servers=True,
                             ft=FTConfig(op_deadline_s=60.0))
        client.start(np.arange(size, dtype=np.float32), np.full(size, 1e-6, np.float32))
        _await_readers(spec["markers"])
        lat = []
        # One committed version per pacing interval over the read window
        # (+2 slack), each GRAD timed: the "training stays flat" column.
        for _ in range(rounds + 2):
            t0 = time.monotonic()
            client.async_send_grad()
            client.wait()
            lat.append(time.monotonic() - t0)
            time.sleep(interval)
        client.stop()
        p50, p99 = _percentiles_ms(lat)
        result = {"role": "writer", "grads": rounds + 2, "grad_p50_ms": p50,
                  "grad_p99_ms": p99}
    elif role == "cell":
        from mpit_tpu_torch.cells.cell import ServingCell

        rank = spec["rank"]
        transport = TcpTransport(rank, nranks, addrs, listener=_listener_from_env(),
                                 reconnect=120.0, dial_peers=[0], connect_timeout=120.0)
        cell = ServingCell(rank, 0, transport, readers, size=size, max_lag=spec["max_lag"],
                           serve=ServeConfig(budget_bytes=1 << 30),
                           ft=FTConfig(heartbeat_s=0.2, op_deadline_s=60.0))
        throttle(cell)
        cell.start()
        result = {"role": "cell", "version": cell.version,
                  "params_served": cell.params_served,
                  "diffs_installed": cell.diffs_installed, "resyncs": cell.resyncs,
                  "lag_sheds": cell.lag_sheds}
    else:  # a reader host: the paced fabric-routed population
        nofile = _raise_nofile()
        serving = cell_ranks if ncells else [0]
        reader_ft = FTConfig(op_deadline_s=(2.0 if spec["kill"] else 60.0), max_retries=8)
        transports, clients = {}, {}
        for r in spec["batch"]:
            transports[r] = TcpTransport(r, nranks, addrs, reconnect=120.0,
                                         dial_peers=serving, listen=False,
                                         connect_timeout=120.0)
            clients[r] = ReaderClient(r, [0], transports[r], ft=reader_ft,
                                      cells=({0: cell_ranks} if ncells else None))
            clients[r].start(np.zeros(size, np.float32))
        for c in clients.values():  # one warm-up read each
            c.read_params()
        # The paced window starts now: the kill leg's parent waits for this.
        open(os.environ["PTEST_RESULT"] + ".started", "w").close()
        lag = [0]

        def on_read(_r, c):
            lag[0] = max(lag[0], c.lags.get(0, 0))

        samples, reads, errors, t0, t1 = _paced_reads(clients, rounds, interval, on_read)
        if errors and not spec["kill"]:
            raise SystemExit(f"readers drew RetryExhausted: {errors}")
        for r, c in clients.items():
            assert c.monotone, f"reader {r} saw a version go back"
            c.stop()
            transports[r].close()
        result = {"role": "readers", "samples": samples, "reads": reads,
                  "busy_honored": sum(c.busy_honored for c in clients.values()),
                  "failovers": sum(c.failovers for c in clients.values()),
                  "max_lag_seen": lag[0], "errors": errors, "t0": t0, "t1": t1,
                  "nofile": nofile}
    if transport is not None:
        transport.close()
    with open(os.environ["PTEST_RESULT"], "w") as fh:
        json.dump(result, fh)


def main() -> None:
    refuse_later_legs()
    for codec in CODECS or [""]:
        for hb in ([False, True] if HEARTBEAT_SWEEP else [False]):
            for ob in ([False, True] if OBS_SWEEP else [False]):
                print(json.dumps(bench_shm(codec, heartbeat=hb, obs=ob)), flush=True)
    if STATUS_SWEEP:
        print(json.dumps(bench_shm("none", obs=True, status=True)), flush=True)
    if PROFILE_SWEEP:
        print(json.dumps(bench_shm("none", obs=True, profile=True)), flush=True)
    if DECOMP_SWEEP:
        print(json.dumps(bench_shm("none", decomp=True)), flush=True)
    if SKEW_SWEEP:
        # The straggler A/B at codec none (the skew is in the replies).
        for rebalance in (False, True):
            print(json.dumps(bench_shm("none", skew_rebalance=rebalance)), flush=True)
    if ELASTIC_SWEEP:
        for row in bench_elastic():
            print(json.dumps(row), flush=True)
    for n in READERS_SWEEP:
        print(json.dumps(bench_readers(n)), flush=True)
    if CELLS_SWEEP:
        # The direct-serving control first, one leg per cell count, then the
        # kill leg at the largest count of at least 2.
        for n in [0] + [n for n in CELLS_SWEEP if n > 0]:
            print(json.dumps(bench_cells(n)), flush=True)
        killable = [n for n in CELLS_SWEEP if n >= 2]
        if CELL_KILL and killable:
            print(json.dumps(bench_cells(max(killable), kill=True)), flush=True)


if __name__ == "__main__":
    if "--gang-child" in sys.argv:
        _gang_child()
    elif "--serve-child" in sys.argv:
        _serve_child()
    elif "--cells-child" in sys.argv:
        _cells_child()
    else:
        main()
