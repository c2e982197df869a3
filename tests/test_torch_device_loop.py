"""``mesh_launch --device_loop 1`` of the port on the CPU, against its own
host loop and against the JAX package's device-loop contract.

The port's device loop takes the host loop's order (``default_rng(seed)``
permutations), so it must train bit for bit as the host loop with
``device_stream=1``: every epoch's ``avg_loss`` and ``test_err``, and the
final worker rows, velocities, counters and center.  On the CPU the same
epoch body runs without capture; on a card it runs from CUDA graphs
(``tests/test_torch_cuda.py`` holds that path).  The JAX device loop
shuffles with ``jax.random``, so against it only the result contract is
held: the keys, ``train_wall_mode``, ``at`` on the last epoch alone, and
when ``time_to_target`` is set (``tests/test_mesh_launch.py``).

Small: the CNN at side 8 (53,002 parameters), dp 2, batch 128 (five
steps an epoch), two or three epochs.
"""

import logging

import numpy as np
import pytest
import torch

import mpit_tpu_torch.train.mesh_launch as tmesh
from mpit_tpu.train.mesh_launch import MESH_LAUNCH_DEFAULTS as JAX_MESH_DEFAULTS
from mpit_tpu.train.mesh_launch import run as jax_mesh_run
from mpit_tpu_torch.parallel.easgd import MeshEASGD

torch.set_num_threads(1)

BASE = dict(model="cnn", side=8, dp=2, su=2, batch=128, lr=1e-2, mom=0.99)
STEPS_PER_EPOCH = (1797 - 270) // (2 * 128)


def _run(**kw):
    return tmesh.run(tmesh.MESH_LAUNCH_DEFAULTS.merged(BASE, device="cpu", **kw))


@pytest.fixture
def states(monkeypatch):
    """Every trainer state :meth:`MeshEASGD.init` hands out, in order (the
    run updates it in place, so it holds the final state afterwards)."""
    out = []
    real = MeshEASGD.init

    def init(self, w0):
        state = real(self, w0)
        out.append((self, state))
        return state

    monkeypatch.setattr(MeshEASGD, "init", init)
    return out


@pytest.mark.parametrize("su,epochs", [(2, 3), (3, 2)])
def test_device_loop_trains_bit_for_bit_as_the_host_loop(states, su, epochs):
    """su 2 and 3 against five steps an epoch: the epochs start at every
    phase of the sync schedule."""
    host = _run(su=su, epochs=epochs, device_stream=1, precompile=1)
    loop = _run(su=su, epochs=epochs, device_loop=1)
    assert [(h["avg_loss"], h["test_err"]) for h in loop["history"]] == \
        [(h["avg_loss"], h["test_err"]) for h in host["history"]]
    (_, host_state), (_, loop_state) = states
    for key in ("w", "vt", "k", "center"):
        assert torch.equal(loop_state[key], host_state[key]), key
    assert loop["steps"] == host["steps"] == epochs * STEPS_PER_EPOCH
    assert loop["samples_trained"] == host["samples_trained"]
    assert loop["final_test_err"] == host["final_test_err"]
    assert loop["device_loop"] == {"captured": False, "warmup_steps": 0, "graphs": []}
    assert host["device_loop"] is None


def test_device_loop_keeps_the_jax_contract(monkeypatch):
    kw = dict(BASE, epochs=2, target_test_err=0.01)
    monkeypatch.setenv("MPIT_MESH_DEVICES", "2")
    ref = jax_mesh_run(JAX_MESH_DEFAULTS.merged(kw, device_loop=1))
    port = _run(epochs=2, target_test_err=0.01, device_loop=1)
    assert set(ref) <= set(port)
    for res in (ref, port):
        assert res["train_wall_mode"] == "device_loop"
        assert [h["epoch"] for h in res["history"]] == [0, 1]
        assert res["history"][0]["at"] is None and res["history"][1]["at"] is not None
        assert res["time_to_target"] is None  # not met, and not asked to stop
        assert res["samples_per_sec"] > 0
    assert port["samples_trained"] == ref["samples_trained"]
    assert port["mesh"] == ref["mesh"] == {"dp": 2, "shard": 1}
    assert port["final_test_err"] == port["history"][-1]["test_err"]


def test_device_loop_stops_after_one_epoch_at_a_target_any_epoch_meets():
    res = _run(epochs=3, device_loop=1, stop_at_target=1, target_test_err=0.95)
    assert len(res["history"]) == 1
    assert res["time_to_target"] is not None
    assert res["history"][0]["at"] == pytest.approx(res["time_to_target"], abs=1e-3)
    assert res["steps"] == STEPS_PER_EPOCH
    host = _run(epochs=3, device_stream=1, stop_at_target=1, target_test_err=0.95)
    assert [h["avg_loss"] for h in res["history"]] == [h["avg_loss"] for h in host["history"]]


def test_device_loop_mid_run_hit_without_stop_has_no_time_to_target():
    """The host loop times a target met mid-run; the device loop has no
    per-epoch wall time, so it reports None and says why."""
    kw = dict(epochs=2, stop_at_target=0, target_test_err=0.95)
    seen = []
    handler = logging.Handler()
    handler.emit = seen.append
    logger = logging.getLogger("mpit[mesh 0]")
    logger.addHandler(handler)
    try:
        loop = _run(device_loop=1, **kw)
    finally:
        logger.removeHandler(handler)
    host = _run(device_stream=1, **kw)
    assert host["time_to_target"] is not None
    assert loop["time_to_target"] is None
    assert len(loop["history"]) == 2
    assert any(r.levelno == logging.WARNING and "stop_at_target=0" in r.getMessage()
               for r in seen)


@pytest.mark.parametrize("epochs", [2, 3])
def test_device_loop_resyncs_the_schedule_for_the_steps_after_it(states, monkeypatch, epochs):
    """The schedule's counter is set to the steps the loop trained, so a
    step after the loop (as the throughput leg's) takes the kind the
    schedule gives it: 10 steps, then a sync step; 15, then a local one
    (su 2)."""
    calls = []
    real = MeshEASGD.set_steps
    monkeypatch.setattr(MeshEASGD, "set_steps",
                        lambda self, n: (calls.append(n), real(self, n))[1])
    res = _run(epochs=epochs, device_loop=1)
    steps = epochs * STEPS_PER_EPOCH
    assert calls[-1] == steps == res["steps"]
    (trainer, state), = states
    center = state["center"].clone()
    gen = np.random.default_rng(0)
    x = torch.from_numpy(gen.random((2, 128, 64), dtype=np.float32))
    y = torch.from_numpy(gen.integers(0, 10, size=(2, 128)))
    trainer.step(state, x, y)
    assert trainer.steps == steps + 1
    assert (not torch.equal(state["center"], center)) == (steps % 2 == 0)


@pytest.mark.parametrize("flag", [dict(ckpt_dir="ck"), dict(resume="auto"),
                                  dict(profile_dir="prof")])
def test_device_loop_refuses_checkpoint_resume_and_profile(flag):
    with pytest.raises(ValueError, match="device_loop"):
        _run(device_loop=1, **flag)
