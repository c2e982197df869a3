"""Process-gang spawner — the built-in ``mpirun -np N`` analog.

The port of the JAX package's ``mpit_tpu/train/gang.py``.  Starts N role
processes wired over the shm transport (or TCP), monitors them as a gang
(one dead rank starves its peers: servers wait for STOPs that never
arrive — the failure shape mpirun handles by killing the job), collects
per-rank JSON results from files, and tears everything down on the first
dead rank or on timeout.

Every child is a fresh interpreter (``python -m <module> --child``), never
a ``fork`` of a process that may have touched CUDA.  Each writes its log
to a file of its own and its result to ``MPIT_RESULT_FILE``.  A child's
device comes from ``MPIT_DEVICE`` (set per rank by the launcher's
``device_policy``), overriding the gang config's ``device``.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, Optional

from mpit_tpu_torch.utils.config import Config

#: the per-rank device override a launcher passes through ``env_overrides``
DEVICE_ENV = "MPIT_DEVICE"

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_GANG_SEQ = itertools.count(1)  # unique shm namespace per gang in a process


def fresh_namespace(prefix: str = "mpit") -> str:
    """A namespace no other gang of this host uses now: pid + sequence, so
    back-to-back gangs of one process and gangs of parallel processes
    never share shm segments."""
    return f"{prefix}{os.getpid()}_{next(_GANG_SEQ)}"


def check_shm_room(nranks: int, ring_bytes: int, path: str = "/dev/shm") -> None:
    """Fail loudly, before any rank starts, when ``path`` cannot hold the
    gang's rings: an over-committed tmpfs accepts ``ftruncate`` and then
    kills a rank with SIGBUS at its first write, mid-run."""
    try:
        st = os.statvfs(path)
    except OSError:
        return  # no tmpfs to inspect: shm_open reports the failure itself
    free = st.f_bavail * st.f_frsize
    need = nranks * ring_bytes
    if free < need:
        raise RuntimeError(
            f"{path} has {free} bytes free; the gang's {nranks} rings of "
            f"{ring_bytes} bytes need {need} (lower --ring_mb)")


def unlink_rings(namespace: str, size: int) -> None:
    """Remove the gang's shm rings that are still there."""
    for rank in range(size):
        try:
            os.unlink(f"/dev/shm/mt_{namespace}_r{rank}")
        except OSError:
            pass


def child_transport(cfg: Config, rank: int, size: int):
    """The gang's wire: shm rings on one host (default), TCP across hosts
    (``transport=tcp`` + ``tcp_addrs=host:port,...`` — one address per
    rank, the hostfile-deployment analog).

    A worker the supervisor restarted (``MPIT_FT_REJOIN``) dials only its
    servers over TCP, and an elastic gang's ranks dial only the peers that
    are up (a spare slot the stamped live set); the others reach them
    through the transport's reconnect service.

    Every gang synchronizes on a startup barrier
    (:class:`mpit_tpu_torch.comm.collectives.HostCollectives`) before any
    role traffic, so a slow-to-start rank can't race the PS seeding
    protocol (disable with ``gang_barrier=0``)."""
    if cfg.get("transport", "shm") == "tcp":
        from mpit_tpu_torch.comm.tcp import TcpTransport

        addrs = [a for a in str(cfg.get("tcp_addrs", "")).split(",") if a]
        if len(addrs) != size:
            raise ValueError(
                f"transport=tcp needs {size} comma-separated tcp_addrs, "
                f"got {len(addrs)}")
        from mpit_tpu_torch.train.launch import assign_roles, read_path_ranks, rejoining

        dial_peers = None
        reconnect = None
        if bool(cfg.get("elastic", False)):
            # Elastic gangs: the rendezvous never waits on a spare slot that
            # has not spawned.  Initial members dial only lower initial
            # ranks; a controller-spawned joiner dials exactly the live set
            # the controller stamped into its spawn request
            # (MPIT_ELASTIC_DIAL).  Later arrivals come in through the
            # transport's accept service, so reconnect mode is on.
            np0 = int(cfg.get("elastic_np0", 0) or 0) or size
            dial_env = os.environ.get("MPIT_ELASTIC_DIAL", "")
            if dial_env:
                dial_peers = [int(x) for x in dial_env.split(",") if x]
            else:
                dial_peers = list(range(min(rank, np0)))
            reconnect = float(os.environ.get("MPIT_TCP_RECONNECT_S", "60"))
        elif rejoining():
            # A supervisor-restarted worker joins a mid-run gang: only its
            # servers must be reachable — a sibling worker that already
            # finished and exited is not a failure (PS traffic is
            # client<->server only, and the barrier is off on rejoin).
            sranks, _cranks, _tester = assign_roles(
                read_path_ranks(size, cfg)[0], int(cfg.get("master_freq", 2)),
                str(cfg.get("tester", "none")))
            if rank not in sranks:
                dial_peers = [r for r in sranks if r < rank]
        transport = TcpTransport(rank, size, addrs, dial_peers=dial_peers,
                                 reconnect=reconnect)
    else:
        from mpit_tpu_torch.comm.shm import ShmTransport

        transport = ShmTransport(cfg.namespace, rank, size,
                                 ring_bytes=int(cfg.get("ring_mb", 64)) << 20)
    if bool(cfg.get("gang_barrier", True)):
        from mpit_tpu_torch.comm.collectives import HostCollectives

        HostCollectives(transport).barrier()
    return transport


def spawn_rank(
    child_module: str, cfg: Config, rank: int, size: int, logdir: str,
    extra_env: Optional[Dict[str, str]] = None,
) -> tuple:
    """Start one ``--child`` rank process; returns (proc, logpath,
    resultpath).  Logs open in append mode, so a restarted rank would
    continue its log."""
    logpath = os.path.join(logdir, f"rank{rank}.log")
    resultpath = os.path.join(logdir, f"rank{rank}.result.json")
    # The child imports this package from where the parent did.
    pythonpath = os.pathsep.join(
        p for p in (_PACKAGE_ROOT, os.environ.get("PYTHONPATH", "")) if p)
    env = {
        **os.environ,
        "PYTHONPATH": pythonpath,
        "MPIT_SIZE": str(size),
        "MPIT_CFG": json.dumps(cfg.to_dict()),
        "MPIT_RANK": str(rank),
        "MPIT_RESULT_FILE": resultpath,
    }
    env.update(extra_env or {})
    with open(logpath, "a") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", child_module, "--child"],
            env=env, stdout=fh, stderr=subprocess.STDOUT, text=True,
        )
    return proc, logpath, resultpath


def launch_gang(
    child_module: str, cfg: Config, timeout: float = 3600.0,
    env_overrides: Optional[Dict[int, Dict[str, str]]] = None,
) -> Dict[int, Dict[str, Any]]:
    """Start ``python -m <child_module> --child`` per rank; gang-monitor.

    ``env_overrides`` maps rank -> extra env vars for that child (the
    device assignment).  Over shm the native library is built here, once,
    before any child starts, and ``/dev/shm`` must hold every ring."""
    size = int(cfg.np)
    namespace = cfg.get("namespace") or fresh_namespace()
    cfg = cfg.merged(namespace=namespace)
    if cfg.get("transport", "shm") != "tcp":
        from mpit_tpu_torch.comm.native import build

        build.ensure_built()
        check_shm_room(size, int(cfg.get("ring_mb", 64)) << 20)
    # Children write to per-rank log files, not pipes: nobody needs to
    # drain them while the gang runs, so a log-heavy child can never block
    # on a full pipe buffer mid-run.
    logdir = tempfile.mkdtemp(prefix=f"{namespace}_logs_")
    procs, logfiles, resultfiles = [], [], []
    for rank in range(size):
        proc, logpath, resultpath = spawn_rank(
            child_module, cfg, rank, size, logdir,
            extra_env=(env_overrides or {}).get(rank))
        procs.append(proc)
        logfiles.append(logpath)
        resultfiles.append(resultpath)
    deadline = time.monotonic() + timeout
    failed: Optional[int] = None
    timed_out = False
    states = [None] * size
    while True:
        states = [p.poll() for p in procs]
        if all(s is not None for s in states):
            break
        bad = next((i for i, s in enumerate(states) if s not in (None, 0)), None)
        timed_out = time.monotonic() > deadline
        if bad is not None or timed_out:
            failed = bad
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            break
        time.sleep(0.05)
    for proc in procs:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    if cfg.get("transport", "shm") != "tcp":
        unlink_rings(namespace, size)  # a rank torn down mid-run never does
    results: Dict[int, Dict[str, Any]] = {}
    for rank, (logpath, resultpath) in enumerate(zip(logfiles, resultfiles)):
        with open(logpath) as fh:
            for line in fh:
                print(line.rstrip("\n"))
        if os.path.exists(resultpath):
            with open(resultpath) as fh:
                results[rank] = json.load(fh)
    if timed_out and failed is None:
        alive = [r for r, s in enumerate(states) if s is None]
        raise RuntimeError(
            f"gang timed out after {timeout:.0f}s; ranks still running at "
            f"teardown: {alive}; gang torn down (logs: {logdir})")
    if failed is not None:
        raise RuntimeError(
            f"rank {failed} exited with {procs[failed].returncode}; "
            f"gang torn down (logs: {logdir})")
    for rank, proc in enumerate(procs):
        if proc.returncode != 0:
            raise RuntimeError(f"rank {rank} exited with {proc.returncode}")
    missing = [r for r in range(size) if r not in results]
    if missing:
        raise RuntimeError(
            f"ranks {missing} exited 0 but reported no result (logs: {logdir})")
    # Merge the children's Chrome-trace parts (MPIT_OBS_TRACE) into one
    # timeline — only after a clean gang, so a failure leaves the parts on
    # disk next to the logs for postmortem.
    from mpit_tpu_torch.obs import maybe_merge_rank_traces

    maybe_merge_rank_traces()
    shutil.rmtree(logdir, ignore_errors=True)  # only useful on failure
    return results


def child_env() -> tuple[int, int, Config]:
    """(rank, size, cfg) from the gang environment, for ``--child`` mains;
    ``MPIT_DEVICE``, where the launcher set it, is the rank's device."""
    rank = int(os.environ["MPIT_RANK"])
    size = int(os.environ["MPIT_SIZE"])
    cfg = Config(**json.loads(os.environ["MPIT_CFG"]))
    device = os.environ.get(DEVICE_ENV)
    if device:
        cfg = cfg.merged(device=device)
    return rank, size, cfg


def write_result(result: Dict[str, Any]) -> None:
    """Results travel over a dedicated file, not stdout: log lines from
    library threads could interleave with (and corrupt) a stdout protocol."""
    result_file = os.environ.get("MPIT_RESULT_FILE")
    if result_file:
        with open(result_file, "w") as fh:
            json.dump(result, fh)
    else:
        print(f"MPIT_RESULT {os.environ.get('MPIT_RANK')} {json.dumps(result)}",
              flush=True)
