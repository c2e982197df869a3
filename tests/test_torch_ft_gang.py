"""Fault tolerance across the packages and across processes.

- Mixed gangs: port clients against JAX servers and JAX clients against
  port servers, on one JAX ``LocalRouter``, under the reference's
  drop/dup matrix (every 3rd client data message dropped, every 4th
  duplicated, every 3rd server reply dropped), end bitwise equal to the
  all-JAX fault-free run.  In this process only codec ``none`` meets a
  JAX server (a JAX server encoding a quantized snapshot starts the JAX
  package's process-global worker pool); the int8 gangs run in a child
  process, on integer grads whose every int8 block has absmax 127 (scale
  1.0), so every codec carries them exactly whatever each package's
  decode fuses.
- The supervisor: a port process gang at ``--np 4 --device cpu --side 8``
  over TCP whose worker rank 3 is SIGKILLed mid-run and rejoins as epoch
  1, one whose server rank 2 is SIGKILLed and restarts from its
  checkpoint, each held to the exactly-once accounting
  (:func:`mpit_tpu_torch.ft.supervisor.grad_accounting`), and the
  reference chaos soak's twin (marked slow, as the reference marks it).
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

import mpit_tpu.ft as jft
from mpit_tpu.comm.local import LocalRouter as JaxRouter
from mpit_tpu.ps import ParamClient as JaxClient
from mpit_tpu.ps import ParamServer as JaxServer
from mpit_tpu_torch import ft
from mpit_tpu_torch.comm.tcp import allocate_local_addresses
from mpit_tpu_torch.ft.supervisor import grad_accounting
from mpit_tpu_torch.ps import ParamClient, ParamServer, tags
from mpit_tpu_torch.train import launch

torch.set_num_threads(1)

REPO = str(pathlib.Path(__file__).resolve().parents[1])
DATA_TAGS = frozenset({tags.GRAD, tags.PARAM_REQ, tags.PARAM_PUSH})
REPLY_TAGS = frozenset({tags.GRAD_ACK, tags.PARAM, tags.PARAM_PUSH_ACK})


def mixed_gang(server_pkg, client_pkg, w0, gtab, faults, codec="none"):
    """2 servers (ranks 0, 1) and 2 clients (2, 3) of the named packages on
    one JAX LocalRouter, in lockstep rounds; returns (the first client's
    final params, retries, dups, applied).  Each role's faults wrap its
    endpoint with its own package's FaultyTransport."""
    mods = {"jax": (jft, JaxServer, JaxClient), "torch": (ft, ParamServer, ParamClient)}
    sft, server_cls, _ = mods[server_pkg]
    cft, _, client_cls = mods[client_pkg]
    router = JaxRouter(4)
    servers = []
    for r in (0, 1):
        ep = router.endpoint(r)
        if faults:
            ep = sft.FaultyTransport(ep, sft.FaultPlan(seed=9, drop_every=3,
                                                       tags=REPLY_TAGS))
        kw = {"device": "cpu"} if server_pkg == "torch" else {}
        servers.append(server_cls(r, [2, 3], ep, ft=sft.FTConfig(rejoin=True), **kw))
    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in threads:
        t.start()
    clients = []
    for i, r in enumerate((2, 3)):
        ep = router.endpoint(r)
        if faults:
            ep = cft.FaultyTransport(ep, cft.FaultPlan(
                seed=i, drop_every=3, dup_every=4, tags=DATA_TAGS))
        clients.append(client_cls(r, [0, 1], ep, seed_servers=(i == 0), codec=codec,
                                  ft=cft.FTConfig(op_deadline_s=0.25, max_retries=8,
                                                  backoff_base_s=0.005,
                                                  backoff_cap_s=0.02)))
    params = [w0.copy(), np.zeros_like(w0)]
    starters = [threading.Thread(target=c.start, args=(p, np.zeros_like(p)), daemon=True)
                for c, p in zip(clients, params)]
    try:
        for t in starters:
            t.start()
        for t in starters:
            t.join(30)
            assert not t.is_alive(), "client start hung"
        for rnd in range(gtab.shape[1]):
            for i, c in enumerate(clients):
                c.grad[:] = gtab[i, rnd]
                c.async_send_grad()
                c.wait()
        clients[0].async_recv_param()
        clients[0].wait()
        for c in clients:
            c.stop()
        for t in threads:
            t.join(30)
            assert not t.is_alive(), "server did not stop"
    finally:
        for s in servers:
            s.live.stop()
    return (params[0].copy(), sum(c.retries for c in clients),
            sum(s.dup_ops for s in servers), sum(s.grads_applied for s in servers))


@pytest.mark.parametrize("server_pkg,client_pkg", [("jax", "torch"), ("torch", "jax"),
                                                   ("torch", "torch")])
def test_mixed_gangs_under_the_fault_matrix_equal_the_jax_gang(server_pkg, client_pkg):
    rng = np.random.default_rng(7)
    w0 = rng.normal(size=96).astype(np.float32)
    gtab = rng.normal(size=(2, 4, 96)).astype(np.float32)
    want, _, _, applied = mixed_gang("jax", "jax", w0, gtab, faults=False)
    got, retries, dups, got_applied = mixed_gang(server_pkg, client_pkg, w0, gtab,
                                                 faults=True)
    assert got.tobytes() == want.tobytes()
    assert retries > 0 and dups > 0
    assert got_applied == applied == 16


INT8_CHILD = textwrap.dedent("""
    import hashlib, json, sys
    import numpy as np
    sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
    from test_torch_ft_gang import mixed_gang
    rng = np.random.default_rng(11)
    size = 2048  # two int8 blocks a shard
    def blocks(shape):
        x = rng.integers(-120, 120, size=shape).astype(np.float32)
        x.reshape(-1, 1024)[:, 0] = 127.0  # absmax 127: scale 1.0
        return x
    w0 = blocks((size,))
    gtab = blocks((2, 4, size))
    out = {{}}
    for spk, cpk, faults in (("jax", "jax", False), ("jax", "jax", True),
                             ("jax", "torch", True), ("torch", "jax", True),
                             ("torch", "torch", True)):
        p, retries, dups, applied = mixed_gang(spk, cpk, w0, gtab, faults,
                                               codec="int8")
        out[f"{{spk}}-{{cpk}}-{{faults}}"] = [
            hashlib.sha256(p.tobytes()).hexdigest(), retries, dups, applied]
    print("RESULT " + json.dumps(out))
""")


def test_int8_mixed_gangs_under_resends_equal_the_jax_gang():
    """int8 frames resent under the fault matrix, in a child process (the
    JAX server's quantized snapshot starts its process-global pool)."""
    code = INT8_CHILD.format(repo=REPO, tests=os.path.join(REPO, "tests"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    runs = json.loads(line[len("RESULT "):])
    want = runs.pop("jax-jax-False")
    for name, (digest, retries, dups, applied) in runs.items():
        assert digest == want[0], name
        assert retries > 0 and dups > 0 and applied == want[3] == 16, name


# -- the supervisor ----------------------------------------------------------------


@pytest.fixture
def one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")


def supervised_gang(tmp_path, kill_rank, after_s, epochs, **kw):
    """A supervised np=4 Adam gang over TCP whose ``kill_rank`` the
    supervisor SIGKILLs ``after_s`` seconds after the killed rank's
    server (the victim itself, or server 0 for a worker) wrote its first
    checkpoint: by then the gang is training, whatever its start-up."""
    addrs, socks = allocate_local_addresses(4)
    for sock in socks:
        sock.close()
    cfg = launch.LAUNCH_DEFAULTS.merged(dict(
        np=4, opt="adam", lr=0.01, epochs=epochs, batch=64, side=8, device="cpu",
        transport="tcp", tcp_addrs=",".join(addrs), ft_heartbeat_s=0.25,
        ft_lease_ttl_s=20.0, ft_op_deadline_s=5.0, supervise=1,
        server_ckpt_dir=str(tmp_path), server_ckpt_interval=2.0), **kw)
    marker = tmp_path / f"server{kill_rank if kill_rank in (0, 2) else 0}_latest.npz"
    return launch.launch_processes(cfg, timeout=300, chaos=dict(
        chaos_kill_rank=kill_rank, chaos_kill_after_s=after_s,
        chaos_when=marker.exists))


def test_supervised_gang_restarts_a_killed_worker_as_epoch_1(tmp_path,
                                                             one_thread_children):
    """Worker rank 3 is SIGKILLed a second after server 0's first
    checkpoint (2 s into training); the supervisor respawns it as epoch 1, it
    re-announces by INIT v3 to the live servers and trains to the end.
    Every GRAD is applied exactly once: each server's count equals the
    workers' acked GRADs plus those of the killed incarnation."""
    results = supervised_gang(tmp_path, kill_rank=3, after_s=1.0, epochs=80)
    assert {r: v["role"] for r, v in results.items()} == {
        0: "server", 1: "worker", 2: "server", 3: "worker"}
    assert [results[r]["restarts"] for r in range(4)] == [0, 0, 0, 1]
    assert results[3]["epoch"] == 1 and results[1]["epoch"] == 0
    for w in (results[1], results[3]):
        assert w["final_test_err"] < 0.2  # the fault-free np=4 envelope
    for srank in (0, 2):
        assert results[srank]["rejoins"] == 1
        assert results[srank]["launches"]["k3"] == 0  # the CPU runs K3's twin
    books = grad_accounting(results)
    for srank in (0, 2):
        assert books[srank]["lost"] == 0
        assert books[srank]["grads_applied"] == books[srank]["acked"] + \
            books[srank]["killed"]
        assert list(books[srank]["landed"]) == ["3:0"]
        assert books[srank]["landed"]["3:0"] > 0  # it had taken steps


def test_supervised_gang_restarts_a_killed_server_from_its_checkpoint(
        tmp_path, one_thread_children):
    """Server rank 2 is SIGKILLed mid-run and restarts from its latest
    checkpoint (Adam's m and v with it); the workers' retries and the
    restored dedup table carry every op across exactly once."""
    results = supervised_gang(tmp_path, kill_rank=2, after_s=1.0, epochs=80)
    assert [results[r]["restarts"] for r in range(4)] == [0, 0, 1, 0]
    assert results[2]["restored"] and results[2]["restored_applied"] > 0
    assert not results[0]["restored"]
    for w in (results[1], results[3]):
        assert w["epoch"] == 0 and w["final_test_err"] < 0.2
    books = grad_accounting(results)
    assert books[0]["lost"] == 0 and books[0]["grads_applied"] == books[0]["acked"]
    assert books[2]["lost"] >= 0


@pytest.mark.slow
def test_chaos_soak_sigkill_worker_rejoins_and_converges(tmp_path, one_thread_children):
    """The reference soak's twin: np=4 DOWNPOUR over TCP with the FT
    posture on; the supervisor SIGKILLs worker rank 3 mid-run and
    respawns it as epoch 1; both workers land in the fault-free loss
    envelope."""
    results = supervised_gang(tmp_path, kill_rank=3, after_s=6.0, epochs=300,
                              opt="downpour", lr=0.2, supervise=2)
    assert {r: v["role"] for r, v in results.items()} == {
        0: "server", 1: "worker", 2: "server", 3: "worker"}
    workers = [v for v in results.values() if v["role"] == "worker"]
    assert all(w["final_test_err"] < 0.8 for w in workers)
    assert all(v["grads_applied"] > 0 for v in results.values() if v["role"] == "server")
    grad_accounting(results)
