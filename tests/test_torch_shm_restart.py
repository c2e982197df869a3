"""A supervised restart over shm, in each package: the record that it is
the reference's design, not a fault of the port.

Both packages accept ``--supervise`` over the shm transport, and both
``comm/native/transport.cpp`` files are the same bytes.  When the
supervisor restarts a killed worker, the new process maps its inbox ring
anew, and its peers' replies to it still land in the ring the dead process
held: the restarted worker's INIT reaches the servers, which accept the
rejoin, but their acks never reach it, so its first GRAD exhausts its
retries (``RetryExhausted``), it exits 1, and the supervisor gives up once
its restarts are spent (a server that keeps sending into the dead ring can
starve the surviving worker past its deadline too, so either worker may be
the one that spends the last restart).  Restarts ride TCP in both
packages.

Each case runs a ``--np 4`` DOWNPOUR gang over shm on the CPU under the
supervisor (1 restart), SIGKILLs worker rank 3 once the servers are serving
(their first checkpoint is on disk), and holds the shared outcome.  Short
op deadlines keep each case to tens of seconds.
"""

import os
import signal
import threading
import time

import pytest

FT = dict(ft_heartbeat_s=0.25, ft_lease_ttl_s=20.0, ft_op_deadline_s=2.0,
          ft_max_retries=2, supervise=1, server_ckpt_interval=1.0)


def supervised_shm_gang(pkg, tmp_path):
    common = dict(np=4, opt="downpour", lr=0.2, su=1, epochs=2000, batch=64, side=8,
                  model="linear", master_freq=2, transport="shm",
                  server_ckpt_dir=str(tmp_path), **FT)
    if pkg == "jax":
        from mpit_tpu.ft.supervisor import RestartPolicy, supervise_gang
        from mpit_tpu.train.launch import LAUNCH_DEFAULTS, device_env_overrides

        cfg = LAUNCH_DEFAULTS.merged(common, device_policy="cpu")
        return supervise_gang(
            "mpit_tpu.train.launch", cfg, timeout=300,
            policy=RestartPolicy(max_restarts=1, restart_delay_s=0.5),
            env_overrides=device_env_overrides(cfg, 4), server_ranks=[0, 2])
    from mpit_tpu_torch.train import launch

    cfg = launch.LAUNCH_DEFAULTS.merged(common, device="cpu")
    return launch.launch_processes(cfg, timeout=300)


def child_pid(rank):
    """The pid of this process's child that runs gang rank ``rank``."""
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                ppid = int(fh.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{entry}/environ", "rb") as fh:
                env = fh.read().split(b"\0")
        except OSError:
            continue
        if ppid == os.getpid() and f"MPIT_RANK={rank}".encode() in env:
            return int(entry)
    return None


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_a_restarted_shm_worker_never_hears_its_servers(pkg, tmp_path):
    box = {}

    def run():
        try:
            supervised_shm_gang(pkg, tmp_path)
        except BaseException as exc:  # noqa: BLE001 — held below
            box["error"] = exc

    gang = threading.Thread(target=run, daemon=True)
    gang.start()
    deadline = time.monotonic() + 240
    killed = None
    while killed is None and gang.is_alive() and time.monotonic() < deadline:
        if (tmp_path / "server0_latest.npz").exists():
            killed = child_pid(3)
            if killed is not None:
                os.kill(killed, signal.SIGKILL)
        time.sleep(0.1)
    gang.join(300)
    assert killed is not None, f"rank 3 was never seen serving: {box.get('error')}"
    assert not gang.is_alive(), "the supervised gang hung"
    err = box.get("error")
    assert isinstance(err, RuntimeError), err
    # the one restart was spent: on the killed rank 3, or on the survivor
    assert "exited 1 and exhausted its 1 restart" in str(err)
    tail = str(err)  # the failed incarnation's log tail
    assert "RetryExhausted" in tail and "GRAD to server" in tail
