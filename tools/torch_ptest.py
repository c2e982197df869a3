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

The skew, readers, cells, stream, agg, elastic and LM legs ride layers of
later slices of the port; setting one raises, naming the slice.

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

#: legs of the JAX twin that ride layers of later slices of the port
LATER_LEGS = {
    "MPIT_BENCH_SKEW": "shard control (slice 5c, shardctl)",
    "MPIT_BENCH_ELASTIC": "elastic membership (slice 5c, shardctl with elastic)",
    "MPIT_BENCH_READERS": "the serving tier (slice 5d, ps/serve)",
    "MPIT_BENCH_CELLS": "serving cells (slice 5e, cells)",
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
            or PROFILE_SWEEP) and GANG != "procs":
        raise ValueError(
            "MPIT_BENCH_HEARTBEAT/MPIT_BENCH_OBS/MPIT_BENCH_STATUS/"
            "MPIT_BENCH_DECOMP/MPIT_BENCH_PROFILE need MPIT_BENCH_GANG=procs")
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
    its result to ``PTEST_RESULT``."""
    import numpy as np
    import statistics

    from mpit_tpu_torch.comm.collectives import HostCollectives
    from mpit_tpu_torch.comm.shm import ShmTransport
    from mpit_tpu_torch.ft import FTConfig
    from mpit_tpu_torch.obs import maybe_start_statusd, maybe_write_rank_trace
    from mpit_tpu_torch.ps import ParamClient, ParamServer

    spec = json.loads(os.environ["PTEST_GANG"])
    rank = int(os.environ["PTEST_RANK"])
    nranks = spec["nservers"] + spec["nclients"]
    sranks = list(range(spec["nservers"]))
    cranks = list(range(spec["nservers"], nranks))
    size = spec["size"]
    # Live introspection (no-op unless MPIT_OBS_HTTP rode in: the status leg).
    maybe_start_statusd(rank, role="server" if rank in sranks else "client")
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
    transport = ShmTransport(spec["ns"], rank, nranks, ring_bytes=spec["ring"])
    # No PS traffic until every ring is mapped.
    HostCollectives(transport).barrier()
    if rank in sranks:
        server = ParamServer(rank, cranks, transport, rule="add",
                             device=spec["device"], ft=server_ft)
        times = _timed_applies(server, server.device)
        server.start()
        result = {"role": "server", "grads_applied": server.grads_applied,
                  "snapshot_copies": server.snapshot_copies,
                  "snapshot_hits": server.snapshot_hits,
                  "platform": server.device.type,
                  "apply_us": statistics.median(times) * 1e6 if times else None}
    else:
        client = ParamClient(rank, sranks, transport,
                             seed_servers=(rank == cranks[0]), ft=client_ft)
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
                   profile: bool = False, extra: dict | None = None) -> float:
    """One timed gang, one OS process per rank; returns MB/s and appends
    the servers' results to ``servers_out``.  The leg's columns (status
    scrapes, the decomposition, the profile) land in ``extra``."""
    from mpit_tpu_torch.train.gang import check_shm_room

    nranks = NSERVERS + NCLIENTS
    ns = f"tptest_{os.getpid()}_{seq}"
    spec = {"ns": ns, "nservers": NSERVERS, "nclients": NCLIENTS,
            "size": size, "ring": _ring_bytes(size), "rounds": ROUNDS,
            "device": DEVICE, "heartbeat": int(heartbeat)}
    if decomp:
        spec["decomp"] = {"deadline_s": DECOMP_DEADLINE}
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
              profile: bool = False) -> dict:
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
                                   profile=profile, extra=extra)
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
    applies = [s["apply_us"] for s in servers if s.get("apply_us") is not None]
    if applies:
        row["server_apply_us"] = statistics.median(applies)
        row["server_platforms"] = sorted({s["platform"] for s in servers})
    return row


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


if __name__ == "__main__":
    if "--gang-child" in sys.argv:
        _gang_child()
    else:
        main()
