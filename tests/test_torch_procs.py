"""Process gangs of the port (slice 2b), on the CPU at side 8.

- The process-gang topologies of ``tests/test_trainer.py`` through the
  port's ``launch_processes``: every rank a fresh interpreter over the
  port's shm transport, results back as JSON.  The tester's checkpoint
  loads in the JAX package's ``load_flat`` with the port's bytes.
- ``device_policy``: the shapes of the per-rank device assignment, a gang
  whose ranks the policy puts on the CPU, and the parent's refusals.
- One worker, bit for bit: a one-worker np=3 process gang ends with the
  losses, the worker's ``w`` and the server shards of ``run_gang`` (the
  in-process gang, which ``tests/test_torch_gang.py`` holds to the JAX
  gang), one intra-op thread on both sides.
- Mixed process gangs, bit for bit: raw ParamServer/ParamClient gangs whose
  servers are one package's and clients the other's, each side its own OS
  process, over shm and over TCP, with codecs none, bf16 and int8, end
  with the all-JAX process gang's shards.  The seeded values are integers
  whose every int8 block has absmax 127 (scale 1.0), so every codec
  carries them exactly and the shards do not depend on how the two
  clients' pushes interleave: the runs are deterministic, and every byte
  on the wire (INIT, frames, acks) is the other package's.
"""

import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpit_tpu_torch.comm.tcp import allocate_local_addresses
from mpit_tpu_torch.data.mnist import load_mnist
from mpit_tpu_torch.train import gang, launch
from mpit_tpu_torch.utils.checkpoint import load_flat

torch.set_num_threads(1)

REPO = str(pathlib.Path(__file__).resolve().parents[1])
SIDE = 8


@pytest.fixture(autouse=True)
def one_thread_children(monkeypatch):
    # Children are fresh interpreters: one intra-op thread each, as here.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")


def _procs(size, **kw):
    cfg = launch.LAUNCH_DEFAULTS.merged(
        dict(np=size, epochs=1, batch=64, side=SIDE, device="cpu"), **kw)
    return launch.launch_processes(cfg, timeout=300)


def _workers(results):
    return [res for res in results.values() if res["role"] == "worker"]


def _check_children(results):
    for res in results.values():
        assert res["platform"] == "cpu"
        assert res["launches"] == {"k1": 0, "k2": 0, "k3": 0}  # twins on the CPU
        assert all(not isinstance(v, torch.Tensor) for v in res.values())


# -- topologies (tests/test_trainer.py) ---------------------------------------


@pytest.mark.parametrize("opt,kw", [
    ("downpour", dict(lr=0.2, su=1)),
    ("eamsgd", dict(lr=0.2, mom=0.9, mva=0.45, su=5, codec="int8")),
    ("downpour", dict(lr=0.2, su=1, codec="bf16")),
], ids=["downpour", "eamsgd-int8", "downpour-bf16"])
def test_process_gang_np4(opt, kw):
    results = _procs(4, opt=opt, **kw)
    assert {r: res["role"] for r, res in results.items()} == {
        0: "server", 1: "worker", 2: "server", 3: "worker"}
    _check_children(results)
    steps = sum(res["steps"] for res in _workers(results))
    applied = [results[r]["grads_applied"] for r in (0, 2)]
    if opt == "downpour":
        assert applied == [steps, steps]  # every step pushes to both shards
    else:
        assert all(a > 0 for a in applied)
    for res in _workers(results):
        assert res["final_test_err"] < 0.8
        assert len(res["w_sha256"]) == 64


def test_adam_server_stateful_np2():
    results = _procs(2, opt="adam", lr=1e-3, su=1)
    _check_children(results)
    assert results[0]["role"] == "server"
    assert results[0]["grads_applied"] == results[1]["steps"] > 0
    assert results[1]["role"] == "worker"
    assert results[1]["history"][0]["avg_loss"] < np.log(10) + 0.5


def test_tester_role_checkpoint_loads_in_the_jax_package(tmp_path):
    from mpit_tpu.utils.checkpoint import load_flat as jax_load_flat

    results = _procs(3, opt="downpour", lr=0.2, su=1, tester="last",
                     tester_rounds=3, tester_interval=0.05, ckpt_dir=str(tmp_path))
    _check_children(results)
    assert [results[r]["role"] for r in range(3)] == ["server", "worker", "tester"]
    tester = results[2]
    assert len(tester["history"]) == 3
    assert tester["best_test_err"] <= 1.0
    # the server counts the tester among its clients: one shard pull each round
    assert results[0]["params_served"] >= 3
    ckpts = sorted(tmp_path.glob("ckpt_*.npz"))
    assert ckpts and (tmp_path / "ckpt_latest.npz").exists()
    for path in [*ckpts, tmp_path / "ckpt_latest.npz"]:
        w, meta = load_flat(path)
        w_ref, meta_ref = jax_load_flat(path)
        assert w.dtype == w_ref.dtype == np.float32
        assert w.tobytes() == w_ref.tobytes() and meta == meta_ref
    w, meta = load_flat(tmp_path / "ckpt_latest.npz")
    assert meta["test_err"] == tester["best_test_err"]
    assert w.size == 8 * 8 * 10 + 10  # the linear model at side 8


# -- device policy ----------------------------------------------------------------


def test_device_policy_overrides_shapes():
    cfg = launch.LAUNCH_DEFAULTS.merged(np=4)
    assert launch.device_env_overrides(cfg, 4) == {}
    cfg = cfg.merged(device_policy="cpu")
    ov = launch.device_env_overrides(cfg, 4)
    assert set(ov) == {0, 1, 2, 3}
    assert all(v == {gang.DEVICE_ENV: "cpu"} for v in ov.values())
    cfg = cfg.merged(device_policy="workers_accel")
    # master_freq=2: even ranks serve; of the clients {1, 3} only the
    # first keeps the card -> every other rank on the CPU.
    assert set(launch.device_env_overrides(cfg, 4)) == {0, 2, 3}
    # with a tester, the tester keeps the card
    assert set(launch.device_env_overrides(cfg.merged(tester="last"), 5)) == {0, 1, 2, 3}
    with pytest.raises(ValueError, match="device_policy"):
        launch.device_env_overrides(cfg.merged(device_policy="gpu4"), 4)
    # the role each child will run, as the JAX launcher derives it
    import mpit_tpu.train.launch as jax_launch

    for size, tester in ((1, "none"), (4, "none"), (5, "last"), (5, "first"),
                         (2, "last"), (12, "none")):
        c = launch.LAUNCH_DEFAULTS.merged(np=size, tester=tester)
        for rank in range(size):
            assert launch.expected_role(rank, size, c) == jax_launch.expected_role(
                rank, size, jax_launch.LAUNCH_DEFAULTS.merged(np=size, tester=tester))


def test_policy_cpu_puts_every_rank_on_the_cpu():
    """``--device cuda`` (the default) with ``device_policy=cpu``: the
    children report the CPU, which they can only do through the policy's
    per-rank override."""
    results = _procs(2, opt="downpour", lr=0.2, model="linear", device="cuda",
                     device_policy="cpu")
    assert [results[r]["role"] for r in (0, 1)] == ["server", "worker"]
    _check_children(results)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("argv", [
    ["--np", "4", "--opt", "downpour"],
    ["--np", "4", "--opt", "downpour", "--device_policy", "workers_accel"],
])
def test_gang_without_a_card_raises_in_the_parent(monkeypatch, argv):
    def no_spawn(*args, **kw):
        raise AssertionError("a rank process was started")

    monkeypatch.setattr(gang, "spawn_rank", no_spawn)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(argv)


def test_a_dead_rank_fails_the_gang():
    """A child that dies (here: rank 1 given a device that does not exist)
    takes the gang down at once: its peer, a server waiting for a client
    that never comes, is terminated, and the parent raises."""
    cfg = launch.LAUNCH_DEFAULTS.merged(np=2, opt="downpour", device="cpu",
                                        side=SIDE, epochs=1)
    with pytest.raises(RuntimeError, match="rank 1 exited with 1"):
        gang.launch_gang("mpit_tpu_torch.train.launch", cfg, timeout=120,
                         env_overrides={1: {gang.DEVICE_ENV: "tpu"}})


@pytest.mark.parametrize("model", ["linear", "cnn"])
def test_trainer_value_and_grad_equals_torch_func_bitwise(model):
    """The trainer's autograd ``vgf`` (no torch.func import in a worker
    process) gives the bits of the torch.func one that ``vmap`` callers
    keep."""
    from mpit_tpu_torch.models.flat import (
        flatten_module, value_and_grad_nll, value_and_grad_nll_eager)
    from mpit_tpu_torch.models.mnist import make_model

    flat = flatten_module(make_model(model, SIDE), 3, torch.device("cpu"))
    (x, y, _, _), _ = load_mnist(side=SIDE)
    x, y = torch.as_tensor(x[:64]), torch.as_tensor(y[:64], dtype=torch.int64)
    gen = torch.Generator().manual_seed(0)
    w = flat.w0 + 0.01 * torch.randn(flat.w0.shape, generator=gen)
    (l1, g1), (l2, g2) = (value_and_grad_nll(flat)(w, x, y),
                          value_and_grad_nll_eager(flat)(w, x, y))
    assert torch.equal(l1, l2) and torch.equal(g1, g2)
    assert not l2.requires_grad and not g2.requires_grad


def test_ptest_twin_prints_the_shm_row():
    """``tools/torch_ptest.py``'s process leg at a tiny size: one row per
    codec with the JAX twin's keys, from the native codec; the streaming
    A/B leg (landed) adds its control and chunked rows; the aggregation A/B
    (landed) its flat, prereduce and tree rows."""
    env = dict(os.environ, MPIT_BENCH_DEVICE="cpu", MPIT_BENCH_MB="1",
               MPIT_BENCH_ROUNDS="3", MPIT_BENCH_CODECS="none,int8")
    tool = os.path.join(REPO, "tools", "torch_ptest.py")
    proc = subprocess.run([sys.executable, tool], env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["codec"] for r in rows] == ["none", "int8"]
    for r in rows:
        assert r["metric"] == "ps_pushpull_bandwidth_shm" and r["unit"] == "MB/s"
        assert r["value"] > 0 and len(r["value_runs"]) == r["reps"] == 1
        assert (r["servers"], r["clients"], r["gang"]) == (2, 2, "procs")
        assert r["codec_path"] == "native" and r["server_platforms"] == ["cpu"]
        assert r["server_apply_us"] > 0
    proc = subprocess.run([sys.executable, tool], capture_output=True, text=True,
                          timeout=120, env=dict(env, MPIT_BENCH_STREAM="1",
                                                MPIT_BENCH_CODECS="none",
                                                MPIT_BENCH_STREAM_CHUNK_MB="0.25"))
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    stream = [r for r in rows if r["metric"] == "ps_stream_pipeline"]
    assert [r["stream"] for r in stream] == [0, 1]
    assert all(r["grad_p50_ms"] > 0 and r["param_p50_ms"] > 0 and r["retries"] == 0
               for r in stream)
    assert stream[1]["chunk_mb"] == 0.25 and stream[1]["grad_speedup"] > 0
    proc = subprocess.run([sys.executable, tool], capture_output=True, text=True,
                          timeout=60, env=dict(env, MPIT_BENCH_AGG="only",
                                               MPIT_BENCH_CODECS="none",
                                               MPIT_BENCH_AGG_MB="0.25",
                                               MPIT_BENCH_AGG_ROUNDS="2"))
    assert proc.returncode == 0, proc.stderr  # aggregation landed
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [(r["metric"], r["mode"]) for r in rows] == [
        ("ps_agg_hierarchy", m) for m in ("flat", "prereduce", "tree")]
    # flat: every client's GRAD reaches the server; the hierarchy: one a round
    assert [r["grads_applied"] for r in rows] == [4 * 2, 2, 2]
    assert all(r["value"] > 0 and r["round_p50_ms"] > 0 for r in rows)
    assert all(r["speedup_vs_flat"] > 0 for r in rows[1:])


def test_ptest_twin_runs_only_the_straggler_legs():
    """``MPIT_BENCH_SKEW=only``: the straggler A/B at codec none (rebalance
    off, then on), and no plain codec leg before it."""
    env = dict(os.environ, MPIT_BENCH_DEVICE="cpu", MPIT_BENCH_MB="1",
               MPIT_BENCH_ROUNDS="3", MPIT_BENCH_SKEW="only")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "torch_ptest.py")],
                          env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [(r.get("skew"), r.get("rebalance"), r["servers"]) for r in rows] == [
        (1, 0, 2), (1, 1, 2)]
    assert rows[0]["map_version"] == 0
    assert all(r["codec"] == "none" and r["value"] > 0 and r["server_platforms"] == ["cpu"]
               for r in rows)


# -- one worker, bit for bit ----------------------------------------------------------


def _sha256(t):
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("opt,kw", [
    ("downpour", dict(lr=0.05, su=1)),
    ("eamsgd", dict(lr=1e-2, su=2, mom=0.9, mva=0.45)),
])
def test_one_worker_process_gang_equals_run_gang_bitwise(opt, kw):
    """tests/test_torch_gang.py's one-worker configuration (np=3: servers
    0 and 2, the worker 1), as processes and as threads of this process."""
    cfg = launch.LAUNCH_DEFAULTS.merged(np=3, opt=opt, model="cnn", side=SIDE,
                                        epochs=2, batch=128, codec="none",
                                        device="cpu", **kw)
    data, _ = load_mnist(side=SIDE)
    want = launch.run_gang(3, cfg, data=data, timeout=300)
    got = launch.launch_processes(cfg, timeout=300)
    assert [got[r]["role"] for r in range(3)] == ["server", "worker", "server"]
    assert ([h["avg_loss"] for h in got[1]["history"]]
            == [h["avg_loss"] for h in want[1]["history"]])
    assert got[1]["w_sha256"] == _sha256(want[1]["w"])
    for rank in (0, 2):
        assert got[rank]["grads_applied"] == want[rank]["grads_applied"] > 0
        assert got[rank]["param_sha256"] == _sha256(want[rank]["param"])


# -- mixed process gangs, bit for bit ----------------------------------------------------

N = 3000  # two shards of 1,500: one full int8 block and a ragged one each
ROUNDS = 4

# One role host: plays its side (servers or clients, one thread a rank) of
# every gang of the list it takes part in, in the list's order, and writes
# each server's final shard to <out>/<gang>_r<rank>.npy.
_HOST = r'''
import json, os, socket, sys, threading
import numpy as np
sys.path.insert(0, sys.argv[1])
spec = json.loads(open(sys.argv[2]).read())
me = sys.argv[3]
pkg = "mpit_tpu" if me.startswith("jax") else "mpit_tpu_torch"
coll = __import__(pkg + ".comm.collectives", fromlist=["HostCollectives"])
shm = __import__(pkg + ".comm.shm", fromlist=["ShmTransport"])
tcp = __import__(pkg + ".comm.tcp", fromlist=["TcpTransport"])
ps = __import__(pkg + ".ps", fromlist=["ParamClient", "ParamServer"])
w0 = np.load(spec["w0"])
rounds = np.load(spec["rounds"])
sranks, cranks = [0, 1], [2, 3]

def run(g, rank, transport, errors):
    try:
        coll.HostCollectives(transport).barrier()
        if rank in sranks:
            kw = {} if me.startswith("jax") else {"device": "cpu"}
            server = ps.ParamServer(rank, cranks, transport, rule="add", **kw)
            server.start()
            shard = np.asarray(server.param if me.startswith("jax")
                               else server.param.numpy())
            np.save(os.path.join(spec["out"], f"{g['name']}_r{rank}.npy"), shard)
        else:
            i = rank - 2
            client = ps.ParamClient(rank, sranks, transport, seed_servers=(i == 0),
                                    codec=g["codec"])
            param = w0.copy() if i == 0 else np.zeros_like(w0)
            grad = np.zeros_like(w0)
            client.start(param, grad)
            for r in range(rounds.shape[1]):
                grad[:] = rounds[i, r]
                client.async_send_grad()
                client.async_recv_param()
                client.wait()
            client.stop()
    except BaseException as exc:
        errors.append(exc)

for g in spec["gangs"]:
    ranks = sranks if g["servers"] == me else cranks if g["clients"] == me else []
    if not ranks:
        continue
    transports, errors = {}, []
    def make(rank):
        try:
            if g["transport"] == "shm":
                transports[rank] = shm.ShmTransport(g["ns"], rank, 4, ring_bytes=1 << 20)
            else:
                # the listener the parent bound, inherited as a descriptor
                listener = socket.socket(fileno=g["fds"][rank])
                transports[rank] = tcp.TcpTransport(rank, 4, g["addrs"],
                                                    listener=listener,
                                                    connect_timeout=60)
        except BaseException as exc:
            errors.append(exc)
    ts = [threading.Thread(target=make, args=(r,)) for r in ranks]
    [t.start() for t in ts]
    [t.join(90) for t in ts]
    if errors or len(transports) != len(ranks):
        raise SystemExit(f"{me}: {g['name']}: transports: {errors}")
    ts = [threading.Thread(target=run, args=(g, r, transports[r], errors)) for r in ranks]
    [t.start() for t in ts]
    [t.join(90) for t in ts]
    if errors or any(t.is_alive() for t in ts):
        raise SystemExit(f"{me}: {g['name']}: {errors or 'hung'}")
    for t in transports.values():
        t.close()
print(me, "done", flush=True)
'''


def _exact_values(rng, lo, hi, shape):
    """Integers in [lo, hi] with +-127 at every 64th element: every block
    of every shard (a shard's blocks start at its offset) has absmax
    127, so int8's scale is 1.0 and its codes are the values."""
    x = rng.integers(lo, hi + 1, size=shape).astype(np.float32)
    x[..., ::64] = 127.0 * np.where(rng.random(x[..., ::64].shape) < 0.5, -1, 1)
    return x


def test_mixed_process_gangs_equal_the_jax_process_gang_bitwise(tmp_path):
    rng = np.random.default_rng(8)
    w0 = _exact_values(rng, -50, 50, N)
    rounds = _exact_values(rng, -8, 8, (2, ROUNDS, N))
    np.save(tmp_path / "w0.npy", w0)
    np.save(tmp_path / "rounds.npy", rounds)
    gangs, listeners = [], []
    for transport in ("shm", "tcp"):
        for codec in ("none", "bf16", "int8"):
            # (servers, clients): jaxA and jaxB are two JAX processes
            for servers, clients in (("jaxA", "jaxB"), ("jaxA", "torch"),
                                     ("torch", "jaxB")):
                name = f"{transport}_{codec}_{servers}_{clients}"
                g = {"name": name, "transport": transport, "codec": codec,
                     "servers": servers, "clients": clients,
                     "ns": f"tt_mix_{os.getpid()}_{len(gangs)}"}
                if transport == "tcp":
                    # Bound here and inherited by the role hosts, so no
                    # other process can take a port in between.
                    g["addrs"], socks = allocate_local_addresses(4)
                    listeners += socks
                    g["fds"] = [sock.fileno() for sock in socks]
                gangs.append(g)
    spec = {"gangs": gangs, "w0": str(tmp_path / "w0.npy"),
            "rounds": str(tmp_path / "rounds.npy"), "out": str(tmp_path)}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    fds = [sock.fileno() for sock in listeners]
    hosts = {me: subprocess.Popen(
        [sys.executable, "-c", _HOST, REPO, str(tmp_path / "spec.json"), me],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, pass_fds=fds)
        for me in ("jaxA", "jaxB", "torch")}
    try:
        outs = {me: p.communicate(timeout=240)[0] for me, p in hosts.items()}
    finally:
        for p in hosts.values():
            if p.poll() is None:
                p.kill()
        for sock in listeners:
            sock.close()
    assert all(p.returncode == 0 for p in hosts.values()), outs
    exact = w0 + rounds.sum(axis=(0, 1))
    for g in gangs:
        got = np.concatenate([np.load(tmp_path / f"{g['name']}_r{r}.npy")
                              for r in (0, 1)])
        ref = np.concatenate([np.load(
            tmp_path / f"{g['transport']}_{g['codec']}_jaxA_jaxB_r{r}.npy")
            for r in (0, 1)])
        assert got.dtype == np.float32 and got.tobytes() == ref.tobytes(), g["name"]
        assert got.tobytes() == exact.tobytes(), g["name"]
