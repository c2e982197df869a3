"""The port's meshes over a ``torch.distributed`` group of two processes,
on the CPU over gloo.

Every group here is two real OS processes, each with its own timeout and
a free port on the loopback, as ``tests/test_torch_distributed.py`` starts
its group of two.  The settings are small: MNIST at side 8, batch 32; the
LM at ``--seq_len 64 --d_model 32 --n_heads 4 --n_layers 1``.

- Collectives over a ``dp`` axis that spans the two processes (each holds
  two of its four ranks) are bit for bit the one-process collectives,
  the ring shift and the pull over it too (every other axis across
  processes: ``tests/test_torch_multiproc_axes.py``).
- ``mesh_launch`` EASGD at ``--dp 4 --su 2 --mva 0.2`` across two
  processes against one process at ``--dp 4``, the linear model and the
  CNN: bit for bit (the center, w, vt, k, every history entry, both
  processes' results alike).  Each process runs one intra-op thread, as
  this one does: there a row's gradient has the same bits whether the
  ``vmap`` holds two rows or four (a one-process control shows it); with
  several threads the CNN's batched convolution cuts its work by the
  width, and the rows' bits move.
- The same two-process run within ``LOSS_RTOL`` (1e-5) of the JAX
  package's one-process ``mesh_launch`` at dp 4, from the same flax
  ``w0``, test error within one of the 270 test samples.
- ``--opt syncdp`` across two processes within ``tests/test_torch_syncdp.
  py``'s ``LOSS_RTOL`` of one process at the same batch: the mean of the
  processes' mean gradients is the batch's up to float32 rounding.
- Checkpoints: ``--epochs 2``, then ``--resume auto --epochs 4`` across two
  processes gives epochs ``[2, 3]`` (the JAX test's assertion); the file is
  the one-process layout, a one-process run resumes it bit for bit as the
  pair does, and so does the JAX package's one-process ``mesh_launch``
  (within ``LOSS_RTOL``).
- ``lm_launch --dp 2`` across two processes within ``chip_smoke.py``'s
  ``LM_LIMITS["float32"]`` of ``--dp 2`` in one process.
- What still refuses, before any rendezvous: a ``dp`` the processes do not
  divide, a cut whose blocks are not boxes, ``tp``, ``pp`` or ``ep`` across
  processes, ``--device_loop 1``.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpit_tpu_torch.train.lm_launch as tlm
import mpit_tpu_torch.train.mesh_launch as tmesh
from mpit_tpu.data.mnist import load_mnist as jax_load_mnist
from mpit_tpu.models import MnistLinear
from mpit_tpu.models import flatten_module as jax_flatten
from mpit_tpu.train.mesh_launch import MESH_LAUNCH_DEFAULTS as JAX_MESH_DEFAULTS
from mpit_tpu.train.mesh_launch import run as jax_mesh_run
from mpit_tpu_torch.data.mnist import load_mnist
from mpit_tpu_torch.models.flat import FlatModel, flatten_module, value_and_grad_nll
from mpit_tpu_torch.models.mnist import make_model
from mpit_tpu_torch.parallel import (
    Mesh, ProcessGroup, make_mesh, process_local_rows, put_global, put_local)
from mpit_tpu_torch.parallel.mesh import _line_groups, check_split, process_boxes
from mpit_tpu_torch.utils.checkpoint import load_state_dict

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_VARS = ("MPIT_COORDINATOR", "MPIT_NUM_PROCESSES", "MPIT_PROCESS_ID", "MPIT_HOSTFILE")
LOSS_RTOL = 1e-5  # tests/test_torch_slice.py's and tests/test_torch_syncdp.py's
N_TEST = 270  # optdigits fixture: 15% of 1797
CHILD_TIMEOUT_S = 300
EASGD = ["--side", "8", "--batch", "32", "--opt", "easgd", "--su", "2", "--mva", "0.2",
         "--lr", "0.1", "--mom", "0.9", "--dp", "4"]
LM = ["--seq_len", "64", "--d_model", "32", "--n_heads", "4", "--n_layers", "1",
      "--attn_dtype", "float32", "--batch", "4", "--steps", "4", "--log_every", "1",
      "--lr", "1e-3"]

# A launcher's CLI in a child process; with a w0 file, from that flat
# vector (the JAX package's flax init) instead of the port's own init.
CHILD = """
import sys, importlib
import numpy as np
mod = importlib.import_module(sys.argv[1])
if sys.argv[2]:
    from mpit_tpu_torch.models.flat import FlatModel
    w0 = np.load(sys.argv[2])["w0"]
    real = mod.flatten_module
    def from_jax(module, seed, device="cpu"):
        spec = real(module, seed, device)
        return FlatModel(spec.module, spec.from_jax_params(w0).to(device))
    mod.flatten_module = from_jax
mod.main(sys.argv[3:])
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _children(argvs, timeout=CHILD_TIMEOUT_S):
    """Run one fresh interpreter a command line, side by side; each must
    exit 0 within ``timeout``.  Returns their standard outputs."""
    env = {k: v for k, v in os.environ.items() if k not in GROUP_VARS}
    env.update(PYTHONPATH=REPO, MPIT_LOG_STREAM="stderr", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(argv, cwd=REPO, env=env, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for argv in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"process failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _pair(module, args, w0_file=""):
    """``module``'s CLI as a group of two processes on the CPU; both
    results (the JSON ``main`` prints)."""
    port = _free_port()
    outs = _children([
        [sys.executable, "-c", CHILD, module, str(w0_file), *args, "--device", "cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
         "--process_id", str(pid)] for pid in (0, 1)])
    return [json.loads(out) for out in outs]


def _curve(res):
    return [(h["epoch"], h["avg_loss"], h["test_err"]) for h in res["history"]]


def _jax_w0(tmp_path):
    """The JAX package's flax init of the linear model at side 8, seed 1, as
    a flat vector in a file."""
    (x, _, _, _), _ = jax_load_mnist(side=8)
    flat = jax_flatten(MnistLinear(num_classes=10), jax.random.PRNGKey(1), jnp.asarray(x[:2]))
    path = tmp_path / "w0.npz"
    np.savez(path, w0=np.asarray(flat.w0))
    return path


def _one_process(monkeypatch, w0_file, args):
    """The port's ``mesh_launch`` CLI in this process, from the flat ``w0``
    in ``w0_file``."""
    w0 = np.load(w0_file)["w0"]
    real = tmesh.flatten_module

    def from_jax(module, seed, device="cpu"):
        spec = real(module, seed, device)
        return FlatModel(spec.module, spec.from_jax_params(w0).to(device))

    monkeypatch.setattr(tmesh, "flatten_module", from_jax)
    return tmesh.main(args + ["--device", "cpu"])


def _states_equal(dir_a, dir_b, prefix="mesh"):
    a, meta_a = load_state_dict(dir_a / f"{prefix}_latest.npz")
    b, meta_b = load_state_dict(dir_b / f"{prefix}_latest.npz")
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].shape == b[key].shape, key
        assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key
    return a, meta_a, meta_b


# -- the layout ----------------------------------------------------------------


def test_dp_is_cut_across_processes_in_contiguous_blocks():
    """Process 1 of 2 over ``dp=4, shard=2``: ranks 2-3 of dp, every shard
    rank; a batch of 32 rows gives it rows 16-31; the shard axis and a
    one-process mesh hold everything."""
    mesh = make_mesh(dp=4, shard=2, device="cpu", group=ProcessGroup(1, 2, None, "cpu"))
    assert mesh.shape == {"dp": 4, "shard": 2} and mesh.processes == 2
    assert mesh.spans("dp") and not mesh.spans("shard")
    assert (mesh.local_size("dp"), mesh.local_slice("dp")) == (2, slice(2, 4))
    assert (mesh.local_size("shard"), mesh.local_slice("shard")) == (2, slice(0, 2))
    assert process_local_rows(mesh, 4) == slice(2, 4)
    assert process_local_rows(mesh, 32) == slice(16, 32)
    assert process_local_rows(mesh, 6, axis="shard") == slice(0, 6)
    one = make_mesh(dp=4, device="cpu")
    assert not one.spans("dp") and process_local_rows(one, 32) == slice(0, 32)
    assert make_mesh(device="cpu", group=ProcessGroup(0, 2, None, "cpu")).shape["dp"] == 2
    x = np.arange(6.0)
    assert put_local(x, mesh).device.type == put_global(x, mesh).device.type == "cpu"
    with pytest.raises(ValueError, match="do not split over dp=4"):
        process_local_rows(mesh, 6)


@pytest.mark.parametrize("axes, processes, exc, match", [
    (dict(dp=3, shard=1), 2, ValueError, "dp=3 does not split over 2 processes"),
    (dict(dp=1, shard=1), 2, ValueError, "contiguous blocks"),
    (dict(dp=3, sp=2), 2, ValueError, "not a box"),
    # tp and ep, which refused to span processes until they ran across
    # them: (the process, its box, its lines' processes)
    (dict(dp=2, tp=2), 4, None, (1, {"dp": (0, 1), "tp": (1, 2)},
                                 {"dp": [1, 3], "tp": [0, 1]})),
    (dict(ep=4), 2, None, (1, {"ep": (2, 4)}, {"ep": [0, 1]})),
])
def test_layouts_that_refuse(axes, processes, exc, match):
    """The layouts that ``check_split`` and ``Mesh`` refuse; a ``tp`` or
    ``ep`` axis across processes no longer is one (``exc`` None:
    ``match`` holds a process's box and the processes of its lines)."""
    if exc is None:
        pid, box, lines = match
        check_split(axes, processes)
        assert process_boxes(axes, processes)[pid] == box
        mesh = Mesh("cpu", ProcessGroup(pid, processes, None, "cpu"), **axes)
        assert mesh.box == box and {a for a in axes if mesh.spans(a)} == set(lines)
        found = _line_groups(process_boxes(axes, processes), sorted(lines))
        assert {a: next(ln for ln in found[a] if pid in ln) for a in lines} == lines
        return
    with pytest.raises(exc, match=match):
        check_split(axes, processes)
    with pytest.raises(exc, match=match):
        Mesh("cpu", ProcessGroup(0, processes, None, "cpu"), **axes)


# -- collectives across two processes ------------------------------------------

COLLECTIVES_CHILD = """
import sys, torch
from mpit_tpu_torch.parallel import (ProcessGroup, allreduce_mean, bootstrap, gather,
    make_mesh, process_mean, ps_pull, ps_push, psum, ring_shift)
from mpit_tpu_torch.parallel.distributed import shutdown
pg = bootstrap(coordinator="127.0.0.1:" + sys.argv[1], num_processes=2,
               process_id=int(sys.argv[2]), device="cpu")
assert pg.backend == "gloo" and "backend=gloo" in pg.describe()
g = torch.Generator().manual_seed(7)
full = torch.randn(4, 10, generator=g)  # every process draws the whole stack
mesh = make_mesh(dp=4, shard=2, device="cpu", group=pg)
one = make_mesh(dp=4, shard=2, device="cpu")
mine = full[mesh.local_slice("dp")].clone()
checks = {
    "gather": torch.equal(gather(mesh)(mine), full),
    "psum": torch.equal(psum(mesh, "dp")(mine), psum(one, "dp")(full)),
    "allreduce_mean": torch.equal(allreduce_mean(mesh)(mine),
                                  allreduce_mean(one)(full)[mesh.local_slice("dp")]),
    "ps_push": torch.equal(ps_push(mesh, "shard", reduce_axis="dp")(mine),
                           ps_push(one, "shard", reduce_axis="dp")(full)),
    "process_mean": torch.equal(process_mean(mesh)(mine), (full[:2] + full[2:]) / 2),
}
checks["ring_shift"] = torch.equal(ring_shift(mesh, "dp")(mine),
                                   ring_shift(one, "dp")(full)[mesh.local_slice("dp")])
checks["ps_pull"] = torch.equal(ps_pull(mesh, "dp")(mine), ps_pull(one, "dp")(full))
try:
    psum(mesh, "dp")(full)
    checks["block"] = False
except ValueError as e:
    checks["block"] = "this process's 2 of the 4 ranks" in str(e)
print("CHECKS", sorted(checks.items()))
assert all(checks.values()), checks
shutdown()
"""


def test_collectives_over_two_processes_are_the_one_process_bits():
    """Each process holds two of dp's four ranks: the all-gather, ``psum``,
    ``allreduce_mean``, ``ps_push(reduce_axis="dp")``, ``process_mean``,
    and ``ring_shift`` and ``ps_pull`` over dp give both processes the
    one-process bits; a block of the wrong size raises."""
    port = str(_free_port())
    outs = _children([[sys.executable, "-c", COLLECTIVES_CHILD, port, str(pid)]
                      for pid in (0, 1)])
    for out in outs:
        assert "CHECKS" in out and "False" not in out, out


# -- mesh_launch ---------------------------------------------------------------


def test_vmap_width_changes_no_bit_at_one_thread():
    """The one-process control behind the bit-for-bit holds below: at one
    intra-op thread, the per-worker gradients and losses of rows 0-1 taken
    in a ``vmap`` over four rows and over those two rows alone are the
    same bits, for each model."""
    (x, y, _, _), _ = load_mnist(side=8)
    xb = torch.as_tensor(x[:128].reshape(4, 32, -1), dtype=torch.float32)
    yb = torch.as_tensor(y[:128].reshape(4, 32).astype(np.int64))
    assert torch.get_num_threads() == 1
    for model in ("linear", "mlp", "cnn"):
        flat = flatten_module(make_model(model, 8), 1, "cpu")
        vg = torch.func.vmap(value_and_grad_nll(flat))
        w = flat.w0.expand(4, -1).clone()
        (l4, g4), (l2, g2) = vg(w, xb, yb), vg(w[:2], xb[:2], yb[:2])
        assert torch.equal(g4[:2], g2) and torch.equal(l4[:2], l2), model


@pytest.mark.parametrize("model", ["linear", "cnn"])
def test_two_process_easgd_is_the_one_process_run(tmp_path, model):
    """Two processes of two worker rows each against one process of four:
    both processes report the one-process run's history, bit for bit, and
    the checkpoint (gathered to process 0) holds its center, w, vt and k,
    bit for bit."""
    args = [*EASGD, "--model", model, "--epochs", "1"]
    pair = _pair("mpit_tpu_torch.train.mesh_launch", args + ["--ckpt_dir", str(tmp_path / "two")])
    one = tmesh.main(args + ["--device", "cpu", "--ckpt_dir", str(tmp_path / "one")])
    for res in pair:
        assert res["processes"] == 2 and res["backend"] == "gloo"
        assert res["mesh"] == {"dp": 4, "shard": 1}
        assert res["samples_trained"] == one["samples_trained"]
        assert res["steps"] == one["steps"]
        assert _curve(res) == _curve(one)
    _states_equal(tmp_path / "two", tmp_path / "one")


def test_two_process_easgd_matches_the_jax_package(tmp_path, monkeypatch):
    """The two-process run from the flax ``w0`` against the JAX package's
    one-process ``mesh_launch`` on four mesh devices (dp 4), its commit in
    interpret mode: per-epoch losses within ``LOSS_RTOL``, test error within
    one sample; and against the port's one process from the same ``w0``,
    bit for bit."""
    kw = dict(model="linear", side=8, batch=32, opt="easgd", su=2, mva=0.2, lr=0.1,
              mom=0.9, dp=4, epochs=2)
    monkeypatch.setenv("MPIT_FUSED", "1")
    monkeypatch.setenv("MPIT_MESH_DEVICES", "4")
    ref = jax_mesh_run(JAX_MESH_DEFAULTS.merged(kw))
    assert ref["mesh"] == {"dp": 4, "shard": 1}
    w0 = _jax_w0(tmp_path)
    args = [*EASGD, "--model", "linear", "--epochs", "2"]
    pair = _pair("mpit_tpu_torch.train.mesh_launch", args, w0)
    one = _one_process(monkeypatch, w0, args)
    for res in pair:
        assert len(res["history"]) == len(ref["history"]) == 2
        for p, r in zip(res["history"], ref["history"]):
            assert p["epoch"] == r["epoch"]
            np.testing.assert_allclose(p["avg_loss"], r["avg_loss"], rtol=LOSS_RTOL)
            assert abs(p["test_err"] - r["test_err"]) <= 1.0 / N_TEST + 1e-7
        assert res["samples_trained"] == ref["samples_trained"]
        assert _curve(res) == _curve(one)


def test_two_process_syncdp_matches_one_process():
    """``--opt syncdp`` at batch 32 over ``dp=4``: each process takes the
    gradient of its 16 rows, the two are averaged in process order;
    per-epoch losses within ``LOSS_RTOL`` of one process's gradient of the
    whole batch, test error within one sample, both processes alike."""
    args = ["--model", "linear", "--side", "8", "--batch", "32", "--opt", "syncdp",
            "--lr", "0.2", "--mom", "0.9", "--dp", "4", "--epochs", "2"]
    pair = _pair("mpit_tpu_torch.train.mesh_launch", args)
    one = tmesh.main(args + ["--device", "cpu"])
    assert _curve(pair[0]) == _curve(pair[1])
    for res in pair:
        assert res["processes"] == 2 and res["steps"] == one["steps"]
        for p, r in zip(res["history"], one["history"]):
            np.testing.assert_allclose(p["avg_loss"], r["avg_loss"], rtol=LOSS_RTOL)
            assert abs(p["test_err"] - r["test_err"]) <= 1.0 / N_TEST + 1e-7


@pytest.fixture(scope="module")
def pair_checkpoint(tmp_path_factory):
    """Two epochs of two-process EASGD (linear), checkpointed each epoch."""
    ckpt = tmp_path_factory.mktemp("pair_ckpt")
    res = _pair("mpit_tpu_torch.train.mesh_launch",
                [*EASGD, "--model", "linear", "--epochs", "2", "--ckpt_dir", str(ckpt)])
    return ckpt, res


def test_two_process_resume_continues_and_one_process_resumes_it(pair_checkpoint,
                                                                  tmp_path):
    """``--epochs 2``, then ``--resume auto --epochs 4`` across the two
    processes: epochs ``[2, 3]``.  The file the pair wrote is the
    one-process layout at dp 4, and a one-process run resuming it ends on
    the pair's bits."""
    ckpt, first = pair_checkpoint
    assert [h["epoch"] for h in first[0]["history"]] == [0, 1]
    saved, meta = load_state_dict(ckpt / "mesh_latest.npz")
    assert meta["epoch"] == 1 and meta["opt"] == "easgd"
    plong = saved["center"].shape[0]
    assert {k: v.shape for k, v in saved.items()} == {
        "w": (4, plong), "vt": (4, plong), "k": (4,), "center": (plong,)}
    two, one = tmp_path / "two", tmp_path / "one"
    shutil.copytree(ckpt, two)
    shutil.copytree(ckpt, one)
    resumed = _pair("mpit_tpu_torch.train.mesh_launch",
                    [*EASGD, "--model", "linear", "--epochs", "4", "--resume", "auto",
                     "--ckpt_dir", str(two)])
    for res in resumed:
        assert [h["epoch"] for h in res["history"]] == [2, 3]
    alone = tmesh.main([*EASGD, "--model", "linear", "--device", "cpu", "--epochs", "4",
                        "--resume", "auto", "--ckpt_dir", str(one)])
    assert _curve(alone) == _curve(resumed[0]) == _curve(resumed[1])
    _states_equal(two, one)


def test_jax_package_resumes_the_pairs_checkpoint(pair_checkpoint, tmp_path, monkeypatch):
    """The JAX package's one-process ``mesh_launch`` at dp 4 resumes the
    pair's file too, where a one-process port run does: epochs 2 and 3
    within ``LOSS_RTOL``."""
    ckpt, _ = pair_checkpoint
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(ckpt, jax_dir)
    shutil.copytree(ckpt, port_dir)
    monkeypatch.setenv("MPIT_FUSED", "1")
    monkeypatch.setenv("MPIT_MESH_DEVICES", "4")
    ref = jax_mesh_run(JAX_MESH_DEFAULTS.merged(
        model="linear", side=8, batch=32, opt="easgd", su=2, mva=0.2, lr=0.1, mom=0.9,
        dp=4, epochs=4, resume="auto", ckpt_dir=str(jax_dir)))
    port = tmesh.main([*EASGD, "--model", "linear", "--device", "cpu", "--epochs", "4",
                       "--resume", "auto", "--ckpt_dir", str(port_dir)])
    assert [h["epoch"] for h in ref["history"]] == [h["epoch"] for h in port["history"]] == [2, 3]
    for p, r in zip(port["history"], ref["history"]):
        np.testing.assert_allclose(p["avg_loss"], r["avg_loss"], rtol=LOSS_RTOL)
        assert abs(p["test_err"] - r["test_err"]) <= 1.0 / N_TEST + 1e-7


# -- lm_launch -----------------------------------------------------------------


def test_two_process_lm_dp2_within_lm_limits(tmp_path):
    """``lm_launch --dp 2`` across two processes, two rows of each step's
    global batch of four a process, against ``--dp 2`` in one process from
    the same seeded init: ``LM_LIMITS["float32"]`` of
    ``chip_smoke.py`` (w and vt within 1e-6, their gap's norm within 1e-3
    of the change's, per-step losses within 1e-5 relative); both processes
    report the same losses; process 0's checkpoint is the one-process
    layout."""
    args = [*LM, "--dp", "2", "--ckpt_every", "4"]
    pair = _pair("mpit_tpu_torch.train.lm_launch", args + ["--ckpt_dir", str(tmp_path / "two")])
    one = tlm.main(args + ["--device", "cpu", "--ckpt_dir", str(tmp_path / "one")])
    losses = [[h["avg_loss"] for h in r["history"]] for r in (*pair, one)]
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], losses[2], rtol=1e-5, atol=0)
    for res in pair:
        assert res["processes"] == 2 and res["backend"] == "gloo"
        assert res["mesh"] == {"dp": 2, "sp": 1}
        assert res["tokens_trained"] == one["tokens_trained"]
    a, _ = load_state_dict(tmp_path / "two" / "lm_latest.npz")
    b, _ = load_state_dict(tmp_path / "one" / "lm_latest.npz")
    w0 = tlm.build_step(tlm.LM_LAUNCH_DEFAULTS.merged(
        seq_len=64, d_model=32, n_heads=4, n_layers=1, attn_dtype="float32"),
        torch.device("cpu"))[1].numpy()
    for key in ("w", "vt"):
        gap = np.asarray(a[key]) - np.asarray(b[key])
        change = np.asarray(b[key]) - (w0 if key == "w" else 0.0)
        assert np.abs(gap).max() <= 1e-6, key
        assert np.linalg.norm(gap) <= 1e-3 * np.linalg.norm(change), key
    assert int(a["k"]) == int(b["k"]) == 4


# -- refusals, before any rendezvous -------------------------------------------

GROUP_OF_TWO = dict(coordinator="localhost:1", num_processes=2, process_id=0)


@pytest.mark.parametrize("launcher, flags, exc, match", [
    ("mesh", dict(dp=3), ValueError, "dp=3 does not split over 2 processes"),
    ("mesh", dict(dp=3, shard=2), ValueError, "not a box"),
    ("mesh", dict(device_loop=1), ValueError, "device_loop=1 is single-process"),
    ("mesh", dict(measure_throughput=1), ValueError, "measure_throughput is single-process"),
    ("lm", dict(dp=3, batch=6), ValueError, "dp=3 does not split over 2 processes"),
    ("lm", dict(dp=3, sp=2, batch=6), ValueError, "not a box"),
])
def test_refusals_come_before_any_rendezvous(launcher, flags, exc, match):
    """The coordinator ``localhost:1`` has no listener: each refusal must
    come before the group forms."""
    flags = dict(GROUP_OF_TWO, **flags)
    if launcher == "mesh":
        cfg = tmesh.MESH_LAUNCH_DEFAULTS.merged(flags, device="cpu", model="linear", side=8,
                                                epochs=1)
        run = tmesh.run
    else:
        cfg = tlm.LM_LAUNCH_DEFAULTS.merged(flags, device="cpu", seq_len=64, d_model=16,
                                            n_heads=2, n_layers=1)
        run = tlm.run
    with pytest.raises(exc, match=match):
        run(cfg)
    assert not torch.distributed.is_initialized()
