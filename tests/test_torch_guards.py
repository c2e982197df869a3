"""Guards of the PyTorch port: what it imports, where it runs, and what it
refuses.

- no module of ``mpit_tpu_torch``, and not ``chip_smoke.py``, imports
  ``jax``, ``flax`` or ``mpit_tpu`` (an AST scan, and a fresh interpreter
  that imports the entry points);
- entry points run on CUDA unless asked for the CPU, and raise without it;
- what belongs to a later slice raises ``NotImplementedError`` naming it,
  what has landed refuses a bad posture with the reference's
  ``ValueError``, and a parameter-server optimizer without a client raises
  ``ValueError``;
- ``chip_smoke.py`` exits non-zero and prints no result without a card, and
  alone in a directory.
"""

import ast
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpit_tpu_torch.train import launch, mesh_launch
from mpit_tpu_torch.train.trainer import MnistTrainer
from mpit_tpu_torch.utils.config import Config
from mpit_tpu_torch.utils.platform import resolve_device
from mpit_tpu_torch.utils.timing import timed_chained

# One intra-op thread: the suite runs several test processes side by side
# on the CPU, and these tensors are small.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "flax", "mpit_tpu"}


def _port_sources():
    return (sorted((ROOT / "mpit_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("torch_*.py")))


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax_and_no_reference_package():
    sources = _port_sources()
    assert len(sources) > 20
    obs = {p.name for p in sources if p.parent.name == "obs"}
    assert obs >= {"clock.py", "metrics.py", "profile.py", "flight.py", "spans.py",
                   "trace.py", "statusd.py", "causal.py", "top.py", "timers.py",
                   "__init__.py", "__main__.py"}
    for path in sources:
        bad = FORBIDDEN & set(_imported_roots(path))
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_load_without_jax():
    code = ("import sys; import mpit_tpu_torch.train.mesh_launch, "
            "mpit_tpu_torch.train.launch, mpit_tpu_torch.train.lm_launch, "
            "mpit_tpu_torch.train.bicnn_launch, mpit_tpu_torch.train.bicnn, "
            "mpit_tpu_torch.parallel.sync_dp, mpit_tpu_torch.data.qa, "
            "mpit_tpu_torch.models.bicnn, mpit_tpu_torch.utils.serialize, "
            "mpit_tpu_torch.ops.flash_attention, mpit_tpu_torch.ops.build, "
            "mpit_tpu_torch.obs, mpit_tpu_torch.obs.__main__, mpit_tpu_torch.obs.causal, "
            "mpit_tpu_torch.obs.top, mpit_tpu_torch.obs.profile, mpit_tpu_torch.obs.flight, "
            "mpit_tpu_torch.obs.statusd, mpit_tpu_torch.utils.timers, "
            "mpit_tpu_torch.ps.serve, mpit_tpu_torch.cells.cell, "
            "mpit_tpu_torch.cells.autoscale; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    with pytest.raises(ValueError):
        resolve_device("tpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_profile_dir_writes_a_trace_with_epoch_ranges(tmp_path):
    res = mesh_launch.run(mesh_launch.MESH_LAUNCH_DEFAULTS.merged(
        model="linear", side=8, epochs=2, device="cpu", profile_dir=str(tmp_path)))
    assert len(res["history"]) == 2
    names = {ev.get("name") for ev in
             json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"epoch 0", "epoch 1"} <= names


def test_step_profile_reads_only_the_later_epochs():
    spec = importlib.util.spec_from_file_location(
        "torch_step_profile", ROOT / "tools" / "torch_step_profile.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ann = lambda name, ts, dur: {"cat": "user_annotation", "name": name,
                                 "ts": ts, "dur": dur}
    dev = lambda name, ts, dur: {"cat": "kernel", "name": name, "ts": ts, "dur": dur}
    trace = {"traceEvents": [
        ann("epoch 0", 0, 100), dev("conv", 10, 50),  # left out: epoch 0
        ann("epoch 1", 200, 100), dev("conv", 210, 20), dev("nesterov_commit", 250, 5),
        dev("nesterov_commit", 260, 5),
        ann("epoch 2", 400, 100), dev("conv", 410, 30), dev("nesterov_commit", 450, 5),
        dev("nesterov_commit", 460, 5),
        dev("conv", 600, 40),  # outside every epoch: the eval
    ]}
    s = tool.summarize(trace, steps_per_epoch=2)
    assert s["epochs"] == 2 and s["steps"] == 4
    assert s["step_ms"] == pytest.approx(200 / 4 / 1e3)
    assert s["device_busy_share"] == pytest.approx(70 / 200)
    assert s["k1_launches_per_step"] == 1.0
    assert s["k1_us_per_step"] == pytest.approx(5.0)
    assert s["device_ops_per_step"] == pytest.approx(6 / 4)
    assert s["top"][0] == {"name": "conv", "count": 2, "us": 50}


def test_step_profile_groups_the_lm_kernels():
    """LM mode: ``window N`` ranges, one step each; the flash kernels,
    cuBLAS's products and the copies each get their group."""
    spec = importlib.util.spec_from_file_location(
        "torch_step_profile", ROOT / "tools" / "torch_step_profile.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ann = lambda name, ts, dur: {"cat": "user_annotation", "name": name,
                                 "ts": ts, "dur": dur}
    dev = lambda name, ts, dur: {"cat": "kernel", "name": name, "ts": ts, "dur": dur}
    trace = {"traceEvents": [
        ann("window 0", 0, 100), dev("fa_fwd_kernel", 10, 50),  # left out
        ann("window 1", 200, 100),
        dev("void (anonymous namespace)::fa_fwd_kernel<__nv_bfloat16, 128, false>", 210, 10),
        dev("fa_bwd_dq_kernel<float, 32>", 220, 8), dev("fa_bwd_dkdv_kernel<float, 32>", 230, 12),
        dev("fa_bwd_fused_kernel<float, 32>", 245, 5),
        dev("sm80_xmma_gemm_f32f32_f32f32", 250, 20),
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 275, "dur": 2},
        dev("direct_copy_kernel_cuda", 280, 3), dev("nesterov_commit_kernel", 290, 1),
        dev("vectorized_elementwise_kernel", 295, 4),
    ]}
    s = tool.summarize(trace, 1, prefix="window ")
    assert s["epochs"] == 1 and s["steps"] == 1
    us = {g: v["us_per_step"] for g, v in s["groups"].items()}
    assert us == {"k4": 10, "k6": 20, "k5": 5, "matmul": 20, "copy": 5, "k1": 1,
                  "other": 4}
    assert s["groups"]["k6"]["launches_per_step"] == 2
    assert s["device_busy_share"] == pytest.approx(65 / 100)
    assert s["k1_launches_per_step"] == 1.0


def test_stop_at_target_stops_at_the_first_hit():
    res = mesh_launch.run(mesh_launch.MESH_LAUNCH_DEFAULTS.merged(
        model="linear", side=8, epochs=3, device="cpu", target_test_err=1.0,
        stop_at_target=1))
    assert len(res["history"]) == 1
    assert res["time_to_target"] == pytest.approx(res["history"][0]["at"], abs=1e-3)


def test_throughput_leg_needs_the_card():
    with pytest.raises(ValueError):
        mesh_launch.run(mesh_launch.MESH_LAUNCH_DEFAULTS.merged(
            model="linear", side=8, epochs=1, device="cpu", measure_throughput=1))


def test_timing_refuses_cpu_state():
    with pytest.raises(ValueError):
        timed_chained(lambda s: s, {"w": torch.zeros(3)})


@pytest.mark.parametrize("flags", [
    (dict(opt="adamw"), ValueError, "easgd|syncdp"),
    (dict(ckpt_dir="{tmp}", resume="auto"), NotImplementedError, "multi-process"),
    (dict(resume="auto"), ValueError, "requires --ckpt_dir"),
    (dict(hostfile="h"), NotImplementedError, "multi-host"),
    (dict(coordinator="c:1"), NotImplementedError, "multi-host"),
    (dict(num_processes=2), NotImplementedError, "multi-host"),
    (dict(process_id=0), NotImplementedError, "multi-host"),
])
def test_mesh_launch_refuses_later_slices(flags, tmp_path):
    """What still refuses: an unknown optimizer, an orbax ``step_*``
    checkpoint (the multi-process mesh's), ``--resume auto`` without
    ``--ckpt_dir``, and the multi-host flags."""
    flags, exc, match = flags
    (tmp_path / "step_2").mkdir()
    flags = {k: v.format(tmp=tmp_path) if isinstance(v, str) else v
             for k, v in flags.items()}
    with pytest.raises(exc, match=match):
        mesh_launch.run(mesh_launch.MESH_LAUNCH_DEFAULTS.merged(
            flags, device="cpu", model="linear", side=8, epochs=1))


@pytest.mark.parametrize("refused", [
    None,  # an unknown optimizer: ValueError in the parent
    ("tester", "last", "role split"),  # --np 2 leaves the tester no client
    ("shardctl", "1", "role split"),  # landed: --np 2 leaves no worker
    ("elastic", "1", "supervise"),  # landed: needs the supervisor
    ("serve_readers", "1", "ft_op_deadline_s"),  # landed: needs op deadlines
    ("cells", "1", "without --serve_readers"),  # landed: cells serve readers
    ("lm", "1", "slice 7"),
    ("agg", "tree", "slice 5"),
    ("dplane", "1", "slice 6"),
    ("init_v3", 1 | 16, "reader_ranks"),  # landed: FLAG_READONLY from a non-reader
    ("ft_chunk_bytes", "65536", "slice 5"),
    ("init_v3", 1 | 8 | 64, "slice 5"),  # FLAG_TIMING with FLAG_CHUNKED
    ("init_v5", 1 | 2 | 16 | 32 | 64, "slice 5f"),  # a chunk-framed subscription
])
def test_launch_refuses_gangs_and_ps_optimizers(refused, monkeypatch):
    """The CLI's --np N refuses in the parent, before any process starts:
    an unknown optimizer and a role split with no client raise
    ValueError, as the reference's launcher does (so do shard control with
    no worker left, --elastic without the supervisor, --serve_readers
    without op deadlines and --cells without readers), and the flags of
    later slices and an INIT flag of a later slice raise
    NotImplementedError naming the slice (a cell's chunk-framed
    subscription, INIT v5, names slice 5f); a READ-ONLY announcement from a
    rank outside ``reader_ranks`` is a ValueError, as in the reference; a
    PS optimizer without a client raises ValueError, as the reference's
    trainer does."""
    from mpit_tpu_torch.train import gang

    def no_spawn(*args, **kw):
        raise AssertionError("a rank process was started")

    monkeypatch.setattr(gang, "spawn_rank", no_spawn)
    if refused is None:
        with pytest.raises(ValueError, match="unknown optimizer"):
            launch.main(["--np", "2", "--device", "cpu", "--opt", "nope"])
        trainer = MnistTrainer(Config(opt="downpour", device="cpu", side=8))
        with pytest.raises(ValueError, match="parameter client"):
            trainer.optimizer
        with pytest.raises(ValueError):
            MnistTrainer(Config(opt="nope", device="cpu", side=8)).optimizer
        return
    flag, value, owner = refused
    if flag in ("init_v3", "init_v5"):
        from mpit_tpu_torch.comm.local import LocalRouter
        from mpit_tpu_torch.ps import ParamServer

        # rank 1 a client of the first, a cell of the second
        server = (ParamServer(0, [1], LocalRouter(2).endpoint(0), device="cpu")
                  if flag == "init_v3" else
                  ParamServer(0, [2], LocalRouter(3).endpoint(0), device="cpu",
                              cell_ranks=[1]))
        words = [0, 8, 0, 1, value] + ([1024] if flag == "init_v5" else [])
        exc = ValueError if value & 64 == 0 else NotImplementedError
        with pytest.raises(exc, match=owner):
            server._negotiate(1, np.asarray(words, np.int64).tobytes())
        return
    argv = ["--np", "2", "--device", "cpu", "--side", "8", f"--{flag}", value]
    if flag in ("tester", "shardctl", "elastic", "serve_readers", "cells"):
        with pytest.raises(ValueError, match=owner):
            launch.main(argv)
        return
    with pytest.raises(NotImplementedError, match=owner):
        launch.main(argv)


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def _assert_no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and obj.get("ok")), line


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    _assert_no_result(_run_smoke(ROOT))


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _assert_no_result(_run_smoke(tmp_path))
