"""Gang supervisor — restart dead ranks instead of tearing the gang down.

The port of ``mpit_tpu/ft/supervisor.py``: its children are the port's
``--child`` processes (``train/gang.py``), it builds the shm library and
removes the gang's rings as ``launch_gang`` does, and each result carries
the rank's ``restarts``.  The port imports nothing of the JAX package.

``launch_gang`` (train/gang.py) keeps mpirun's contract: one dead rank
kills the job.  This supervisor keeps the *gang's* contract instead: a
worker that dies is restarted as a new incarnation (epoch + 1) that
re-announces via INIT v3 and resumes against the live servers; a server
that dies is restarted from its latest stamped shard snapshot (resume
path) and keeps serving the surviving clients' retried ops.  The rest of
the gang never exits — client deadlines/retry and server leases cover
the gap while the replacement comes up.

Membership is **dynamic** (docs/PROTOCOL.md §9): the supervised set
starts as ``initial_ranks`` (default: every rank) and changes mid-run
through the elastic mailbox (:class:`mpit_tpu_torch.ft.elastic
.ElasticDirectory`) — a controller-requested spawn joins the set *and
the restart budget* exactly like a launch-time member, and a rank the
controller marked retired leaves the budget: its exit is a goodbye,
never a crash to respawn (the respawn-of-retired flake this replaces).

Restart mechanics per rank:

- the replacement runs with ``MPIT_FT_EPOCH=<restart #>`` and
  ``MPIT_FT_REJOIN=1`` (picked up by ``FTConfig.from_env`` inside the
  child), and a per-child config with the startup barrier off — its
  gang-mates are long past the rendezvous — plus ``resume=True`` for
  server ranks;
- restarts are budgeted (``RestartPolicy.max_restarts``): a rank that
  keeps dying is a bug, not churn, and the supervisor fails loudly with
  its log tail rather than flapping forever.

``chaos_kill_rank``/``chaos_kill_after_s`` are the process-level arm of
the fault-injection harness (ft/faults.py is the message-level arm): the
soak test signals a live rank mid-run through the supervisor itself, so
the fault lands at a reproducible point in the supervision loop.
``chaos_when``, a predicate polled each pass of the supervision loop,
starts the ``chaos_kill_after_s`` timer when it first holds instead of
at the spawn (the port's addition): a kill that must land after some
progress, such as a checkpoint on disk, then does not depend on how long
the children take to start.
``chaos_signal=SIGTERM`` with ``chaos_grace_s`` turns the instant death
into a spot-style preemption: notice first, SIGKILL only if the rank is
still alive when the grace window closes (ft/faults.py
``inject_preemption`` is the same arm for external harnesses).
"""

from __future__ import annotations

import os
import signal
import subprocess
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

from mpit_tpu_torch.obs import clock as obs_clock
from mpit_tpu_torch.utils.logging import get_logger


@dataclass(frozen=True)
class RestartPolicy:
    #: restarts allowed per rank before the supervisor gives up.
    max_restarts: int = 2
    #: pause before respawning (lets the transport notice the death and
    #: the lease reaper run, so the replacement finds a clean slate).
    restart_delay_s: float = 0.5


def supervise_gang(
    child_module: str,
    cfg: Any,
    timeout: float = 3600.0,
    policy: Optional[RestartPolicy] = None,
    env_overrides: Optional[Dict[int, Dict[str, str]]] = None,
    server_ranks: Optional[list] = None,
    chaos_kill_rank: Optional[int] = None,
    chaos_kill_after_s: float = 0.0,
    chaos_signal: int = signal.SIGKILL,
    chaos_grace_s: float = 0.0,
    chaos_when: Optional[Callable[[], bool]] = None,
    initial_ranks: Optional[Iterable[int]] = None,
    elastic_dir: Optional[Any] = None,
    expendable: Optional[Iterable[int]] = None,
) -> Dict[int, Dict[str, Any]]:
    """Run a gang to completion, restarting dead ranks under ``policy``.

    Same result contract as ``launch_gang``: rank -> result dict, each
    with the rank's ``restarts`` (and the chaos victim's with the kill's
    wall-clock time, ``chaos_killed_at``).  A rank's *final* incarnation must exit
    0 and write its result file — except retired ranks, whose goodbye
    needs no report, and ``expendable`` ranks, whose death ends them: never
    restarted, reported as ``{"killed": True, "exit": code}`` (a SIGKILLed
    serving cell is evicted by its upstream's lease and its readers fail
    over to a sibling; a fresh incarnation would wait for readers that
    already left it).
    """
    from mpit_tpu_torch.train.gang import (
        check_shm_room, fresh_namespace, spawn_rank, unlink_rings)
    from mpit_tpu_torch.utils.config import Config

    policy = policy or RestartPolicy()
    log = get_logger("supervisor", 0)
    size = int(cfg.np)
    server_ranks = list(server_ranks or [])
    namespace = cfg.get("namespace") or fresh_namespace()
    cfg = cfg.merged(namespace=namespace)
    shm = cfg.get("transport", "shm") != "tcp"
    if shm:
        from mpit_tpu_torch.comm.native import build

        build.ensure_built()
        check_shm_room(size, int(cfg.get("ring_mb", 64)) << 20)
    logdir = tempfile.mkdtemp(prefix=f"{namespace}_logs_")

    procs: Dict[int, Any] = {}
    logfiles: Dict[int, str] = {}
    resultfiles: Dict[int, str] = {}
    members = set(initial_ranks if initial_ranks is not None
                  else range(size))
    retired: set = set()
    expendable = set(expendable or ())
    killed: Dict[int, int] = {}  # expendable rank -> its exit code
    restarts = {r: 0 for r in members}
    done: Dict[int, int] = {}  # rank -> exit code 0
    for rank in sorted(members):
        procs[rank], logfiles[rank], resultfiles[rank] = spawn_rank(
            child_module, cfg, rank, size, logdir,
            extra_env=(env_overrides or {}).get(rank),
        )
    chaos_at = (
        time.monotonic() + chaos_kill_after_s
        if chaos_kill_rank is not None and chaos_when is None else None
    )
    chaos_done = False
    chaos_wall: Optional[float] = None  # the kill's wall-clock time
    chaos_escalate_at: Optional[float] = None
    deadline = time.monotonic() + timeout

    def _teardown(reason: str) -> None:
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        for p in procs.values():
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if shm:
            unlink_rings(namespace, size)
        raise RuntimeError(f"{reason} (logs: {logdir})")

    def _restart_cfg(rank: int) -> "Config":
        # The replacement must not re-run the startup rendezvous (its
        # gang-mates are mid-run) and a server must reload its shard.
        merged = cfg.merged(gang_barrier=False)
        if rank in server_ranks:
            if not str(cfg.get("server_ckpt_dir", "") or ""):
                _teardown(
                    f"server rank {rank} died but server_ckpt_dir is unset "
                    "— no snapshot to restart from"
                )
            merged = merged.merged(resume=True)
        return merged

    def _poll_elastic() -> None:
        """Membership changes from the controller's mailbox: spawns
        join the supervised set (and restart budget); retirement marks
        strip a rank from the budget before — or after — its exit."""
        if elastic_dir is None:
            return
        for rank, extra in elastic_dir.consume_spawns():
            if rank in members and rank not in done:
                log.warning("spawn request for live rank %d ignored", rank)
                continue
            log.info("elastic: spawning rank %d on controller request", rank)
            members.add(rank)
            done.pop(rank, None)
            retired.discard(rank)
            restarts.setdefault(rank, 0)
            env = dict((env_overrides or {}).get(rank, {}))
            env.update(extra or {})
            # A mid-run join must skip the startup rendezvous.
            procs[rank], logfiles[rank], resultfiles[rank] = spawn_rank(
                child_module, cfg.merged(gang_barrier=False), rank, size,
                logdir, extra_env=env,
            )
        for rank in elastic_dir.retired():
            if rank in members and rank not in retired:
                log.info("elastic: rank %d retired — leaving the restart "
                         "budget", rank)
                retired.add(rank)

    while len(done) < len(members):
        if time.monotonic() > deadline:
            _teardown(f"supervised gang timed out after {timeout:.0f}s")
        _poll_elastic()
        now = time.monotonic()
        if (chaos_at is None and chaos_when is not None
                and chaos_kill_rank is not None and chaos_when()):
            chaos_at = now + chaos_kill_after_s  # the gang reached the point
        if chaos_at is not None and not chaos_done and now >= chaos_at:
            victim = procs[chaos_kill_rank]
            if victim.poll() is not None:
                # A chaos fault that cannot land is a mis-tuned soak, and
                # letting it pass silently would fake the coverage.
                _teardown(
                    f"chaos fault scheduled for rank {chaos_kill_rank} but "
                    "it already exited — lower chaos_kill_after_s or "
                    "lengthen the run"
                )
            log.warning("chaos: signal %d -> rank %d (pid %d)",
                        int(chaos_signal), chaos_kill_rank, victim.pid)
            os.kill(victim.pid, chaos_signal)
            chaos_done = True
            chaos_wall = obs_clock.epoch_offset() + time.monotonic()
            if chaos_signal == signal.SIGTERM and chaos_grace_s > 0:
                chaos_escalate_at = now + chaos_grace_s
        if chaos_escalate_at is not None and now >= chaos_escalate_at:
            victim = procs[chaos_kill_rank]
            if victim.poll() is None:
                log.warning(
                    "chaos: grace window (%.1fs) closed — SIGKILL rank %d",
                    chaos_grace_s, chaos_kill_rank)
                os.kill(victim.pid, signal.SIGKILL)
            chaos_escalate_at = None
        for rank, proc in list(procs.items()):
            if rank in done:
                continue
            code = proc.poll()
            if code is None:
                continue
            if code != 0 and rank in expendable:
                log.warning("rank %d died (exit %s); expendable: not restarted",
                            rank, code)
                killed[rank] = code
                done[rank] = code
                continue
            if code == 0 or rank in retired:
                # A retired rank's exit is a goodbye whatever its code
                # (a preemption may SIGKILL it right after the drain):
                # never respawned, never counted as a failure.
                done[rank] = 0
                continue
            if restarts[rank] >= policy.max_restarts:
                tail = ""
                try:
                    with open(logfiles[rank]) as fh:
                        tail = "".join(fh.readlines()[-20:])
                except OSError:
                    pass
                _teardown(
                    f"rank {rank} exited {code} and exhausted its "
                    f"{policy.max_restarts} restart(s)\n--- rank {rank} "
                    f"log tail ---\n{tail}"
                )
            restarts[rank] += 1
            log.warning(
                "rank %d died (exit %s); restarting as epoch %d "
                "(%d/%d restarts)",
                rank, code, restarts[rank], restarts[rank],
                policy.max_restarts,
            )
            time.sleep(policy.restart_delay_s)
            extra = dict((env_overrides or {}).get(rank, {}))
            extra["MPIT_FT_EPOCH"] = str(restarts[rank])
            extra["MPIT_FT_REJOIN"] = "1"
            procs[rank], logfiles[rank], resultfiles[rank] = spawn_rank(
                child_module, _restart_cfg(rank), rank, size, logdir,
                extra_env=extra,
            )
        time.sleep(0.1)

    if shm:
        unlink_rings(namespace, size)  # a killed rank never unlinks its ring
    import json

    results: Dict[int, Dict[str, Any]] = {}
    for rank in sorted(members):
        with open(logfiles[rank]) as fh:
            for line in fh:
                print(line.rstrip("\n"))
        if os.path.exists(resultfiles[rank]):
            with open(resultfiles[rank]) as fh:
                results[rank] = json.load(fh)
            # How many times the rank was respawned, and when the chaos
            # kill landed: the final incarnation's report cannot know it.
            results[rank]["restarts"] = restarts.get(rank, 0)
            if rank == chaos_kill_rank and chaos_wall is not None:
                results[rank]["chaos_killed_at"] = chaos_wall
        elif rank in retired:
            # A rank escalated to SIGKILL mid-exit wrote no report; its
            # drain already completed, so a synthetic one is honest.
            results[rank] = {"role": "server", "retired": True}
        elif rank in killed:
            results[rank] = {"killed": True, "exit": killed[rank]}
    missing = [r for r in sorted(members) if r not in results]
    if missing:
        raise RuntimeError(
            f"ranks {missing} exited 0 but reported no result (logs: {logdir})"
        )
    import shutil

    shutil.rmtree(logdir, ignore_errors=True)  # only useful on failure
    return results


def grad_accounting(results: Dict[int, Dict[str, Any]],
                    grad_tag: int = 2) -> Dict[int, Dict[str, Any]]:
    """Exactly-once accounting of a supervised gang's GRADs, per server
    rank, from the results of ``launch.run_rank`` (the servers'
    ``admitted`` / ``restored_*`` / ``dedup`` and the workers'
    ``grads_acked``); raises ``RuntimeError`` where it does not hold:

    - every GRAD the server's final process applied was admitted FRESH,
      and each incarnation's admitted seqs are consecutive with none
      applied twice (``count == last - first + 1``);
    - each worker's final incarnation had its last acked GRAD admitted;
    - ``grads_applied + lost == acked + killed``: the applied count equals
      the workers' acknowledged GRADs, where ``lost`` counts the GRADs a
      SIGKILLed server applied and acked after its last checkpoint (the
      restored shard predates them, and the clients never resend an acked
      op) and ``killed`` those admitted from a killed worker incarnation.

    Returns, per server, the counts and ``landed``: for each killed worker
    incarnation, the last GRAD seq it reached."""
    workers = {r: v for r, v in results.items() if v.get("role") == "worker"}
    final = {f"{r}:{w.get('epoch', 0)}" for r, w in workers.items()}
    out: Dict[int, Dict[str, Any]] = {}
    for srank, srv in sorted(results.items()):
        if srv.get("role") != "server":
            continue
        admitted = srv["admitted"]
        applied_here = srv["grads_applied"] - srv["restored_applied"]
        fresh = sum(n for _lo, _hi, n in admitted.values())
        _require(fresh == applied_here,
                 f"server {srank} applied {applied_here} GRADs but admitted {fresh}")
        for key, (lo, hi, n) in admitted.items():
            _require(n == hi - lo + 1,
                     f"server {srank}, incarnation {key}: {n} applies of seqs "
                     f"{lo}..{hi} (one applied twice, or one skipped)")
        acked = lost = 0
        for wrank, w in workers.items():
            epoch = w.get("epoch", 0)
            last = int(w["grads_acked"][str(srank)])
            acked += last
            if last == 0:
                continue
            lo, hi, _n = admitted.get(f"{wrank}:{epoch}", (last + 1, 0, 0))
            _require(hi == last,
                     f"server {srank}: worker {wrank}'s last acked GRAD {last} "
                     f"is not its last admitted one ({hi})")
            base = srv["restored_dedup"].get(f"{wrank}:{grad_tag}")
            start = base[1] if base and base[0] == epoch else 0
            _require(lo - 1 >= start,
                     f"server {srank}: worker {wrank}'s seqs restart at {lo} "
                     f"under the checkpoint's {start}")
            lost += lo - 1 - start
        landed = {k: v[1] for k, v in admitted.items() if k not in final}
        killed = sum(v[2] for k, v in admitted.items() if k not in final)
        _require(srv["grads_applied"] + lost == acked + killed,
                 f"server {srank}: {srv['grads_applied']} applied + {lost} lost "
                 f"!= {acked} acked + {killed} from killed incarnations")
        out[srank] = {"grads_applied": srv["grads_applied"],
                      "restored_applied": srv["restored_applied"],
                      "acked": acked, "lost": lost, "killed": killed,
                      "landed": landed}
    return out


def _require(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"exactly-once accounting: {message}")
