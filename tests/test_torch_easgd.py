"""MeshEASGD of the PyTorch port against :class:`mpit_tpu.parallel.MeshEASGD`.

``dp=2``, ``su=2``, four steps of the CNN at side 8 from one flax ``w0`` on
the same numpy batches.  The JAX side runs on a 2-device CPU mesh with its
Pallas commit in interpret mode (``use_fused=True``); the port holds both
worker rows on one device and commits them in one K1 call.  Tolerances:
the per-worker gradients differ by the convolutions' summation order
(under 1e-7 per step, tests/test_torch_models.py), which four steps of
momentum 0.9 carry into the state: rtol 1e-5 / atol 1e-6 for w, vt and the
center, as for the fused updates themselves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models import MnistCNN
from mpit_tpu.models import flatten_module as jax_flatten
from mpit_tpu.optim.msgd import MSGDConfig as JaxCfg
from mpit_tpu.parallel import MeshEASGD as JaxEASGD
from mpit_tpu.parallel import make_mesh as jax_mesh
from mpit_tpu.utils.platform import default_devices
from mpit_tpu_torch.models.flat import flatten_module, value_and_grad_nll
from mpit_tpu_torch.models.mnist import make_model
from mpit_tpu_torch.optim.msgd import MSGDConfig
from mpit_tpu_torch.parallel import MeshEASGD, make_mesh

# One intra-op thread: the suite runs several test processes side by side
# on the CPU, and these tensors are small.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
DP, SU, STEPS, SIDE, BATCH = 2, 2, 4, 8, 16
HP = dict(lr=0.05, mom=0.9, l2wd=1e-4, lrd=0.05, lrp=0.5)


def _batches():
    rng = np.random.default_rng(11)
    xs = rng.random((STEPS, DP, BATCH, SIDE * SIDE), dtype=np.float32)
    ys = rng.integers(0, 10, size=(STEPS, DP, BATCH)).astype(np.int32)
    return xs, ys


@pytest.fixture(scope="module")
def runs():
    xs, ys = _batches()
    jflat = jax_flatten(MnistCNN(side=SIDE), jax.random.PRNGKey(3), jnp.asarray(xs[0, 0, :2]))

    def jvgf(w, xb, yb):
        def loss_fn(w):
            logp = jflat.apply_flat(w, xb)
            return -jnp.mean(jnp.take_along_axis(logp, yb[:, None], axis=1))
        return jax.value_and_grad(loss_fn)(w)

    mesh = jax_mesh(default_devices()[:DP], dp=DP, shard=1)
    jtr = JaxEASGD(mesh, jvgf, JaxCfg(use_fused=True, **HP), mva=0.9 / DP, su=SU)
    assert jtr._use_fused
    jstate = jtr.init(jflat.w0)
    jlosses = []
    for s in range(STEPS):
        jstate, loss = jtr.step(jstate, *jtr.shard_batch(jnp.asarray(xs[s]), jnp.asarray(ys[s])))
        jlosses.append(np.asarray(loss))

    tflat = flatten_module(make_model("cnn", SIDE), 0)
    w0 = tflat.from_jax_params(jax.tree_util.tree_map(np.asarray, jflat.unravel(jflat.w0)))
    ttr = MeshEASGD(make_mesh(dp=DP, device="cpu"), value_and_grad_nll(tflat),
                    MSGDConfig(**HP), mva=0.9 / DP, su=SU)
    tstate = ttr.init(w0)
    tlosses = []
    for s in range(STEPS):
        tstate, loss = ttr.step(tstate, *ttr.shard_batch(xs[s], ys[s].astype(np.int64)))
        tlosses.append(loss.numpy().copy())
    return jstate, jlosses, tstate, tlosses, ttr


@pytest.mark.parametrize("key", ["w", "vt", "center"])
def test_state_matches_jax(runs, key):
    jstate, _, tstate, _, _ = runs
    np.testing.assert_allclose(tstate[key].numpy(), np.asarray(jstate[key]),
                               rtol=RTOL, atol=ATOL, err_msg=key)


def test_losses_and_counters_match_jax(runs):
    jstate, jlosses, tstate, tlosses, ttr = runs
    np.testing.assert_allclose(np.stack(tlosses), np.stack(jlosses), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tstate["k"].numpy(), np.asarray(jstate["k"]))
    assert ttr._steps == STEPS


def _port_trainer(mom=0.9, su=SU):
    tflat = flatten_module(make_model("cnn", SIDE), 4)
    tr = MeshEASGD(make_mesh(dp=DP, device="cpu"), value_and_grad_nll(tflat),
                   MSGDConfig(lr=0.05, mom=mom), mva=0.3, su=su)
    return tr, tflat.w0


@pytest.mark.parametrize("mom", [0.9, 0.0])
def test_run_epoch_equals_step_loop(mom):
    xs, ys = _batches()
    x, y = torch.from_numpy(xs), torch.from_numpy(ys).long()
    tr_a, w0 = _port_trainer(mom)
    sa = tr_a.init(w0)
    for s in range(STEPS):
        sa, _ = tr_a.step(sa, x[s], y[s])
    tr_b, _ = _port_trainer(mom)
    sb, losses = tr_b.run_epoch(tr_b.init(w0), x, y)
    assert losses.shape == (STEPS, DP)
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key


def test_precompile_leaves_state_and_schedule_alone():
    xs, ys = _batches()
    x, y = torch.from_numpy(xs), torch.from_numpy(ys).long()
    tr, w0 = _port_trainer()
    state = tr.init(w0)
    before = {k: v.clone() for k, v in state.items()}
    tr.precompile(state, x[0], y[0])
    assert tr._steps == 0
    for key in state:
        assert torch.equal(state[key], before[key]), key


def test_sync_schedule_follows_su():
    """The center moves only on sync steps (every su-th, the first
    included) and not between them."""
    xs, ys = _batches()
    x, y = torch.from_numpy(xs), torch.from_numpy(ys).long()
    tr, w0 = _port_trainer(su=3)
    state = tr.init(w0)
    centers = []
    for s in range(STEPS):
        state, _ = tr.step(state, x[s], y[s])
        centers.append(state["center"].clone())
    assert torch.equal(centers[0], w0)  # step 0: sync with w == center
    assert torch.equal(centers[1], centers[0]) and torch.equal(centers[2], centers[1])
    assert not torch.equal(centers[3], centers[2])  # step 3: sync


def test_mesh_refuses_what_needs_more_devices():
    with pytest.raises(NotImplementedError):
        make_mesh(dp=2, shard=2, device="cpu")
    with pytest.raises(NotImplementedError):
        make_mesh([torch.device("cpu"), torch.device("cpu")])
    mesh = make_mesh(dp=3, device="cpu")
    assert mesh.shape == {"dp": 3, "shard": 1}
    with pytest.raises(ValueError):
        MeshEASGD(mesh, lambda w, x, y: (w, w), MSGDConfig(lr=0.1), mva=0.0)
