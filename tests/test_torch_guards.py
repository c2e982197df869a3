"""Guards of the PyTorch port: what it imports, where it runs, and what it
refuses.

- no module of ``mpit_tpu_torch``, and not ``chip_smoke.py``, imports
  ``jax``, ``flax`` or ``mpit_tpu`` (an AST scan, and a fresh interpreter
  that imports the entry points);
- entry points run on CUDA unless asked for the CPU, and raise without it;
- what belongs to a later slice raises ``NotImplementedError``;
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
    return sorted((ROOT / "mpit_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
    for path in sources:
        bad = FORBIDDEN & set(_imported_roots(path))
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_load_without_jax():
    code = ("import sys; import mpit_tpu_torch.train.mesh_launch, "
            "mpit_tpu_torch.train.launch, mpit_tpu_torch.ops.build; "
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
    dict(opt="syncdp"), dict(device_loop=1), dict(ckpt_dir="x"),
    dict(resume="auto"), dict(hostfile="h"), dict(coordinator="c:1"),
    dict(num_processes=2), dict(process_id=0),
])
def test_mesh_launch_refuses_later_slices(flags):
    with pytest.raises(NotImplementedError):
        mesh_launch.run(mesh_launch.MESH_LAUNCH_DEFAULTS.merged(flags, device="cpu"))


def test_launch_refuses_gangs_and_ps_optimizers():
    with pytest.raises(NotImplementedError):
        launch.main(["--np", "2", "--device", "cpu"])
    trainer = MnistTrainer(Config(opt="downpour", device="cpu", side=8))
    with pytest.raises(NotImplementedError):
        trainer.optimizer
    with pytest.raises(ValueError):
        MnistTrainer(Config(opt="nope", device="cpu", side=8)).optimizer


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
