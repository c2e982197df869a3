"""Sync data parallel (``--opt syncdp``) of the port against the JAX
package, on the CPU.

- :class:`mpit_tpu_torch.parallel.SyncDataParallel` against
  :class:`mpit_tpu.parallel.SyncDataParallel` at dp 1, 2 and 4 (the JAX side
  on that many of its host devices, the batch sharded over them and the
  gradients all-reduced; the port's rows share one device and take the
  whole batch's gradient), three steps of the CNN at side 8 from one flax
  ``w0``, with lr decay and L2, its Pallas commit in interpret mode:
  ``w``, ``vt`` and the losses within atol 2e-6 (the two differ by the
  summation order of the per-device partial gradients), ``k`` equal;
- ``mesh_launch --opt syncdp`` against the JAX ``mesh_launch`` (dp=1):
  per-epoch losses within rtol 1e-5, test error within one sample;
- ``mesh_launch --opt syncdp`` trains a tiny configuration to its target,
  as the JAX test does;
- the device loop's epoch body (``--device_loop 1``, run eagerly on the
  CPU) bit-equal to the host loop, and at ``mom == 0`` the plain commit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpit_tpu_torch.train.mesh_launch as tmesh
from mpit_tpu.data.mnist import load_mnist as jax_load_mnist
from mpit_tpu.models import MnistCNN, MnistLinear
from mpit_tpu.models import flatten_module as jax_flatten
from mpit_tpu.optim.msgd import MSGDConfig as JaxCfg
from mpit_tpu.parallel import SyncDataParallel as JaxSyncDP
from mpit_tpu.parallel import make_mesh as jax_mesh
from mpit_tpu.train.mesh_launch import MESH_LAUNCH_DEFAULTS as JAX_MESH_DEFAULTS
from mpit_tpu.train.mesh_launch import run as jax_mesh_run
from mpit_tpu.utils.platform import default_devices
from mpit_tpu_torch.models.flat import FlatModel, flatten_module, value_and_grad_nll_eager
from mpit_tpu_torch.models.mnist import make_model
from mpit_tpu_torch.optim.msgd import MSGDConfig
from mpit_tpu_torch.parallel import SyncDataParallel, make_mesh

torch.set_num_threads(1)

ATOL = 2e-6
LOSS_RTOL = 1e-5
N_TEST = 270
SIDE, BATCH, STEPS = 8, 32, 3
HP = dict(lr=0.05, mom=0.9, l2wd=1e-4, lrd=0.05, lrp=0.5)


def _jax_w0(module, seed):
    x = np.zeros((2, SIDE * SIDE), np.float32)
    return jax_flatten(module, jax.random.PRNGKey(seed), jnp.asarray(x))


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_three_steps_match_jax(dp):
    _three_steps_match_jax(dp, 1)


@pytest.mark.parametrize("dp, shard", [(2, 2), (4, 2)])
def test_shard_cut_matches_jax(dp, shard):
    """Parameters and velocity cut over ``shard`` (the JAX side's over that
    many devices of its mesh, its Pallas commit on each slice; the port's
    gradient pushed to the owners of the ``(shard, plong / shard)`` stack
    and committed in one call)."""
    _three_steps_match_jax(dp, shard)


@pytest.mark.parametrize("shard", [2, 3])
def test_shard_cut_is_bit_for_bit_shard_one(shard):
    """Three steps over ``shard`` cuts (3 pads the last shard: the CNN's
    size is odd) leave every bit of ``w``, ``vt`` and ``k`` as at
    ``shard=1``."""
    rng = np.random.default_rng(7)
    xs = rng.random((STEPS, BATCH, SIDE * SIDE), dtype=np.float32)
    ys = rng.integers(0, 10, size=(STEPS, BATCH)).astype(np.int64)
    tflat = flatten_module(make_model("cnn", SIDE), 0)
    assert (tflat.size % shard != 0) == (shard == 3)
    states = []
    for sh in (1, shard):
        tr = SyncDataParallel(make_mesh(dp=2, shard=sh, device="cpu"),
                              value_and_grad_nll_eager(tflat), MSGDConfig(**HP))
        state = tr.init(tflat.w0)
        for s in range(STEPS):
            state, _ = tr.step(state, *tr.shard_batch(xs[s], ys[s]))
        states.append(state)
    for key in states[0]:
        assert torch.equal(states[1][key], states[0][key]), key


def _three_steps_match_jax(dp, shard):
    rng = np.random.default_rng(7)
    xs = rng.random((STEPS, BATCH, SIDE * SIDE), dtype=np.float32)
    ys = rng.integers(0, 10, size=(STEPS, BATCH)).astype(np.int32)
    jflat = _jax_w0(MnistCNN(side=SIDE), 3)

    def jvgf(w, xb, yb):
        def loss_fn(w):
            logp = jflat.apply_flat(w, xb)
            return -jnp.mean(jnp.take_along_axis(logp, yb[:, None], axis=1))
        return jax.value_and_grad(loss_fn)(w)

    jtr = JaxSyncDP(jax_mesh(default_devices()[:dp * shard], dp=dp, shard=shard), jvgf,
                    JaxCfg(use_fused=True, **HP))
    assert jtr._use_fused
    jstate = jtr.init(jflat.w0)
    jlosses = []
    for s in range(STEPS):
        jstate, loss = jtr.step(jstate, *jtr.shard_batch(jnp.asarray(xs[s]),
                                                          jnp.asarray(ys[s])))
        jlosses.append(float(loss))

    tflat = flatten_module(make_model("cnn", SIDE), 0)
    w0 = tflat.from_jax_params(jax.tree_util.tree_map(np.asarray, jflat.unravel(jflat.w0)))
    ttr = SyncDataParallel(make_mesh(dp=dp, shard=shard, device="cpu"),
                           value_and_grad_nll_eager(tflat), MSGDConfig(**HP))
    tstate = ttr.init(w0)
    tlosses = []
    for s in range(STEPS):
        tstate, loss = ttr.step(tstate, *ttr.shard_batch(xs[s], ys[s].astype(np.int64)))
        tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, jlosses, atol=ATOL)
    for key in ("w", "vt"):
        np.testing.assert_allclose(tstate[key].numpy(), np.asarray(jstate[key]),
                                   atol=ATOL, err_msg=key)
    assert int(tstate["k"]) == int(jstate["k"]) == STEPS == ttr.steps
    assert torch.equal(w0, tflat.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jflat.unravel(jflat.w0))))  # w0 untouched


def test_batch_must_split_over_dp():
    tflat = flatten_module(make_model("linear", SIDE), 0)
    tr = SyncDataParallel(make_mesh(dp=3, device="cpu"), value_and_grad_nll_eager(tflat),
                          MSGDConfig(**HP))
    with pytest.raises(ValueError, match="dp=3"):
        tr.shard_batch(np.zeros((32, SIDE * SIDE), np.float32))
    with pytest.raises(ValueError, match="dp=3"):
        tmesh.run(tmesh.MESH_LAUNCH_DEFAULTS.merged(
            opt="syncdp", model="linear", side=SIDE, dp=3, batch=32, device="cpu"))


def test_mesh_launch_syncdp_matches_jax(monkeypatch):
    kw = dict(opt="syncdp", model="linear", side=SIDE, dp=1, epochs=2, batch=64,
              lr=0.2, mom=0.9, precompile=1)
    monkeypatch.setenv("MPIT_FUSED", "1")
    monkeypatch.setenv("MPIT_MESH_DEVICES", "1")
    ref = jax_mesh_run(JAX_MESH_DEFAULTS.merged(kw))
    assert ref["mesh"] == {"dp": 1, "shard": 1}
    (x, _, _, _), _ = jax_load_mnist(side=SIDE)
    jflat = jax_flatten(MnistLinear(num_classes=10), jax.random.PRNGKey(1), jnp.asarray(x[:2]))
    params = jax.tree_util.tree_map(np.asarray, jflat.unravel(jflat.w0))
    real = tmesh.flatten_module

    def from_jax(module, seed, device="cpu"):
        spec = real(module, seed, device)
        return FlatModel(spec.module, spec.from_jax_params(params).to(device))

    monkeypatch.setattr(tmesh, "flatten_module", from_jax)
    port = tmesh.run(tmesh.MESH_LAUNCH_DEFAULTS.merged(kw, device="cpu"))
    assert len(port["history"]) == len(ref["history"]) == 2
    for p, r in zip(port["history"], ref["history"]):
        np.testing.assert_allclose(p["avg_loss"], r["avg_loss"], rtol=LOSS_RTOL)
        assert abs(p["test_err"] - r["test_err"]) <= 1.0 / N_TEST + 1e-7
    assert port["samples_trained"] == ref["samples_trained"]
    assert port["steps"] == port["samples_trained"] // 64 == int(port["state"]["k"])
    assert set(port["state"]) == {"w", "vt", "k"}


def test_mesh_launch_syncdp_trains_to_target():
    res = tmesh.run(tmesh.MESH_LAUNCH_DEFAULTS.merged(
        opt="syncdp", model="linear", side=SIDE, epochs=3, batch=128, lr=0.2, mom=0.9,
        target_test_err=0.3, device="cpu"))
    assert res["final_test_err"] < 0.3
    assert res["time_to_target"] is not None
    assert res["history"][-1]["avg_loss"] < res["history"][0]["avg_loss"]


@pytest.mark.parametrize("mom", [0.9, 0.0])
def test_device_loop_epoch_body_is_the_host_loop(mom):
    """``--device_loop 1`` runs its epoch body eagerly on the CPU: every
    epoch's loss and test error, and the final state, equal to the host
    loop's bits (``device_stream=1`` and the plain per-step loop)."""
    base = tmesh.MESH_LAUNCH_DEFAULTS.merged(
        opt="syncdp", model="cnn", side=SIDE, epochs=2, batch=128, lr=0.2, mom=mom,
        device="cpu")
    runs = [tmesh.run(base.merged(kw)) for kw in
            ({"device_loop": 1}, {"device_stream": 1}, {})]
    curves = [[(h["avg_loss"], h["test_err"]) for h in r["history"]] for r in runs]
    assert curves[0] == curves[1] == curves[2]
    for r in runs[1:]:
        for key in ("w", "vt", "k"):
            assert torch.equal(runs[0]["state"][key], r["state"][key]), key
    assert runs[0]["steps"] == runs[1]["steps"] == 2 * ((1797 - N_TEST) // 128)
    assert runs[0]["device_loop"] == {"captured": False, "warmup_steps": 0, "graphs": []}
