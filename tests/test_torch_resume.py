"""Checkpoint/resume of ``mesh_launch`` and ``lm_launch``, and the npz
layout they share with the JAX package, on the CPU.

- the port's 2 + 2 epochs (``--ckpt_dir``, then ``--resume auto``) equal
  its straight 4, bit for bit, for EASGD with staged epochs
  (``--device_stream 1``, at dp 2, with the sync schedule out of phase at
  the resume: 46 steps, su 3) and for sync-DP; the LM's 3 + 3 steps equal
  its straight 6;
- a JAX ``mesh_latest.npz`` / ``lm_latest.npz`` resumes in the port, and
  the next epochs or steps are within tolerance of the JAX continuation:
  epoch losses within rtol 1e-5 and test error within one sample (the
  MNIST models; summation order only), LM losses within rtol 2e-4 / atol
  2e-5 (the flash kernels' tolerance in ``tests/test_torch_lm.py``).
  EASGD resumes out of phase (su 3) under both of the reference's
  schedules: staged epochs continue it, the per-batch host loop restarts
  it, and a port that did otherwise leaves the JAX losses;
- the port's checkpoint loads in the JAX ``load_state_dict`` with equal
  bytes and resumes in the JAX ``mesh_launch`` as in the port;
- the guards, as ``tests/test_mesh_launch.py::test_resume_guards``:
  seed, keys and shapes, the LM's model, batch and corpus, ``--resume
  auto`` without ``--ckpt_dir``, and an orbax ``step_*`` directory (the
  multi-process mesh, a later slice);
- ``utils.serialize`` without ``ml_dtypes``: bfloat16 through
  ``torch.bfloat16``, other unknown names raising.
"""

import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

import mpit_tpu_torch.train.lm_launch as tlm
import mpit_tpu_torch.train.mesh_launch as tmesh
from mpit_tpu.train.lm_launch import LM_LAUNCH_DEFAULTS as JAX_LM_DEFAULTS
from mpit_tpu.train.lm_launch import run as jax_lm_run
from mpit_tpu.train.mesh_launch import MESH_LAUNCH_DEFAULTS as JAX_MESH_DEFAULTS
from mpit_tpu.train.mesh_launch import run as jax_mesh_run
from mpit_tpu.utils import serialize as jser
from mpit_tpu.utils.checkpoint import load_state_dict as jax_load_state_dict
from mpit_tpu_torch.utils import serialize as tser
from mpit_tpu_torch.utils.checkpoint import load_state_dict, save_state_dict

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
LM_RTOL, LM_ATOL = 2e-4, 2e-5
N_TEST = 270
MESH = {
    # dp 2 x batch 32: 23 steps an epoch, so the resume at step 46 falls
    # one step into su=3's schedule.
    "easgd": dict(opt="easgd", model="linear", side=8, dp=2, batch=32, su=3, mva=0.2,
                  lr=0.1, mom=0.9),
    "syncdp": dict(opt="syncdp", model="linear", side=8, batch=64, lr=0.2, mom=0.9),
}
LM = dict(seq_len=64, d_model=16, n_heads=2, n_layers=1, batch=2, attn_dtype="float32",
          log_every=2, lr=1e-2)


def _mesh(kw, **over):
    return tmesh.run(tmesh.MESH_LAUNCH_DEFAULTS.merged(kw, device="cpu", **over))


def _curve(res):
    return [(h["epoch"], h["avg_loss"], h["test_err"]) for h in res["history"]]


@pytest.mark.parametrize("opt", ["easgd", "syncdp"])
def test_mesh_resume_is_the_straight_run(opt, tmp_path):
    # Staged epochs: the schedule the reference continues at a resume.
    kw = dict(MESH[opt], device_stream=1)
    straight = _mesh(kw, epochs=4)
    first = _mesh(kw, epochs=2, ckpt_dir=str(tmp_path))
    resumed = _mesh(kw, epochs=4, ckpt_dir=str(tmp_path), resume="auto")
    assert _curve(first) + _curve(resumed) == _curve(straight)
    for key in straight["state"]:
        assert torch.equal(resumed["state"][key], straight["state"][key]), key
    assert resumed["steps"] == straight["steps"]
    # The earlier run's seconds are carried into the clock.
    assert resumed["history"][0]["at"] >= first["history"][-1]["at"]
    assert len(list(tmp_path.glob("mesh_*.npz"))) == 5  # 4 stamped + latest


def _jax_mesh(kw, monkeypatch, **over):
    monkeypatch.setenv("MPIT_MESH_DEVICES", str(kw.get("dp", 1)))
    monkeypatch.setenv("MPIT_FUSED", "1")
    return jax_mesh_run(JAX_MESH_DEFAULTS.merged(kw, compile_cache=0, **over))


def _assert_continues_alike(port, ref, epochs):
    assert [h["epoch"] for h in port["history"]] == [h["epoch"] for h in ref["history"]] == epochs
    for p, r in zip(port["history"], ref["history"]):
        np.testing.assert_allclose(p["avg_loss"], r["avg_loss"], rtol=LOSS_RTOL)
        assert abs(p["test_err"] - r["test_err"]) <= 1.0 / N_TEST + 1e-7


@pytest.mark.parametrize("device_stream", [0, 1])
@pytest.mark.parametrize("opt", ["easgd", "syncdp"])
def test_jax_mesh_checkpoint_resumes_in_the_port(opt, device_stream, tmp_path, monkeypatch):
    # EASGD at su 3 resumes one step into the schedule (step 46): the JAX
    # package's staged epochs continue it and its host loop restarts it.
    kw = dict(MESH[opt], device_stream=device_stream)
    _jax_mesh(kw, monkeypatch, epochs=2, ckpt_dir=str(tmp_path / "jax"))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    ref = _jax_mesh(kw, monkeypatch, epochs=4, resume="auto", ckpt_dir=str(tmp_path / "jax"))
    port = _mesh(kw, epochs=4, resume="auto", ckpt_dir=str(tmp_path / "port"))
    _assert_continues_alike(port, ref, [2, 3])


def test_port_mesh_checkpoint_loads_and_resumes_in_jax(tmp_path, monkeypatch):
    kw = MESH["easgd"]
    _mesh(kw, epochs=2, ckpt_dir=str(tmp_path))
    port_state, port_meta = load_state_dict(tmp_path / "mesh_latest.npz")
    state, meta = jax_load_state_dict(tmp_path / "mesh_latest.npz")
    assert meta == port_meta and meta["epoch"] == 1 and meta["opt"] == "easgd"
    assert sorted(state) == ["center", "k", "vt", "w"]
    for key, arr in state.items():
        assert arr.dtype == port_state[key].dtype
        assert arr.tobytes() == port_state[key].tobytes(), key
    assert state["w"].shape == (2, 650) and state["k"].dtype == np.int32
    ref = _jax_mesh(kw, monkeypatch, epochs=3, resume=str(tmp_path / "mesh_latest.npz"))
    port = _mesh(kw, epochs=3, resume=str(tmp_path / "mesh_latest.npz"))
    _assert_continues_alike(port, ref, [2])


def test_resume_guards(tmp_path):
    kw = MESH["easgd"]
    _mesh(kw, epochs=1, ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="seed"):
        _mesh(kw, epochs=2, seed=99, resume="auto", ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="requires --ckpt_dir"):
        _mesh(kw, epochs=2, resume="auto")
    with pytest.raises(ValueError, match="keys|shape"):
        _mesh(MESH["syncdp"], epochs=2, resume="auto", ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="shape"):
        _mesh(dict(kw, dp=4), epochs=2, resume="auto", ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="device_loop"):
        _mesh(kw, epochs=2, resume="auto", ckpt_dir=str(tmp_path), device_loop=1)
    (tmp_path / "step_3").mkdir()  # newer than mesh_latest.npz
    with pytest.raises(NotImplementedError, match="multi-process"):
        _mesh(kw, epochs=2, resume="auto", ckpt_dir=str(tmp_path))
    # A path names its npz: the orbax step beside it does not matter.
    res = _mesh(kw, epochs=2, resume=str(tmp_path / "mesh_latest.npz"))
    assert [h["epoch"] for h in res["history"]] == [1]


def _lm(**over):
    return tlm.run(tlm.LM_LAUNCH_DEFAULTS.merged(LM, device="cpu", **over))


def test_lm_resume_is_the_straight_run(tmp_path):
    straight = _lm(steps=6)
    _lm(steps=3, ckpt_dir=str(tmp_path), ckpt_every=3)
    resumed = _lm(steps=6, ckpt_dir=str(tmp_path), ckpt_every=3, resume="auto")
    for key in ("w", "vt", "k"):
        assert torch.equal(resumed["state"][key], straight["state"][key]), key
    assert int(resumed["state"]["k"]) == 6 and resumed["steps"] == 3
    # Windows of log_every 2 end at steps 1, 3 and 5: the resumed run's
    # first window is the rest of window 1 (step 3 alone).
    assert [h["step"] for h in resumed["history"]] == [3, 5]
    assert resumed["history"][-1] == straight["history"][-1]
    assert resumed["tokens_trained"] == 3 * LM["batch"] * LM["seq_len"]


def test_jax_lm_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    monkeypatch.setenv("MPIT_MESH_DEVICES", "1")
    jax_lm_run(JAX_LM_DEFAULTS.merged(LM, steps=3, ckpt_every=3, compile_cache=0,
                                       ckpt_dir=str(tmp_path / "jax")))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    ref = jax_lm_run(JAX_LM_DEFAULTS.merged(LM, steps=6, compile_cache=0, resume="auto",
                                             ckpt_dir=str(tmp_path / "jax")))
    port = _lm(steps=6, resume="auto", ckpt_dir=str(tmp_path / "port"))
    assert [h["step"] for h in port["history"]] == [h["step"] for h in ref["history"]]
    np.testing.assert_allclose([h["avg_loss"] for h in port["history"]],
                               [h["avg_loss"] for h in ref["history"]],
                               rtol=LM_RTOL, atol=LM_ATOL)
    # The port's own checkpoint of the continuation loads in the JAX package.
    _lm(steps=7, resume="auto", ckpt_dir=str(tmp_path / "port"), ckpt_every=1)
    state, meta = jax_load_state_dict(tmp_path / "port" / "lm_latest.npz")
    assert meta["step"] == 6 and int(state["k"]) == 7 and meta["model"]["d_model"] == 16


def test_lm_resume_guards(tmp_path):
    _lm(steps=2, ckpt_dir=str(tmp_path), ckpt_every=2)
    for over, match in ((dict(n_heads=4), "model config"), (dict(seed=2), "seed"),
                        (dict(batch=4), "batch"), (dict(d_model=8, n_heads=2), "params"),
                        (dict(text_file=str(tmp_path / "corpus.txt")), "corpus")):
        (tmp_path / "corpus.txt").write_bytes(bytes(range(256)) * 64)
        with pytest.raises(ValueError, match=match):
            _lm(steps=4, resume="auto", ckpt_dir=str(tmp_path), **over)
    with pytest.raises(ValueError, match="requires --ckpt_dir"):
        _lm(steps=4, resume="auto")


def test_serialize_reads_bfloat16_without_ml_dtypes():
    arr = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    blob = jser.encode_array(arr.astype(ml_dtypes.bfloat16))  # the JAX package's frame
    got = tser.decode(blob)
    want = torch.from_numpy(arr).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert tser.encode_array(want) == blob
    for a in (arr, arr.astype(np.int32)):
        blob = jser.encode_array(a)
        assert tser.encode_array(a) == blob and np.array_equal(tser.decode(blob), a)
    assert tser.decode(jser.encode_object({"k": 1})) == {"k": 1}
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        tser.resolve_dtype("float8_e4m3fn")


def test_bfloat16_state_dict_round_trips(tmp_path):
    """A bfloat16 array of a JAX checkpoint loads as a bfloat16 tensor."""
    from mpit_tpu.utils.checkpoint import save_state_dict as jax_save_state_dict

    w = (np.arange(5, dtype=np.float32) / 3).astype(ml_dtypes.bfloat16)
    jax_save_state_dict(tmp_path, {"w": w, "k": np.int32(4)}, meta={"step": 0})
    state, meta = load_state_dict(tmp_path / "mesh_latest.npz")
    assert state["w"].dtype == torch.bfloat16 and int(state["k"]) == 4
    assert torch.equal(state["w"], torch.from_numpy(np.asarray(w, np.float32)).bfloat16())
    save_state_dict(tmp_path / "p", state, meta)
    back, _ = jax_load_state_dict(tmp_path / "p" / "mesh_latest.npz")
    assert back["w"].dtype == w.dtype and back["w"].tobytes() == w.tobytes()
    assert meta == {"step": 0} and int(back["k"]) == 4
