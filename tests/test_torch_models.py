"""The port's models and flat layout against the JAX package.

One flax init gives ``w0``; :meth:`FlatModel.from_jax_params` carries it
into the port, which must give the same log-probs and the same gradient
with respect to the flat vector.  Tolerances: the two packages sum the
convolutions and matrix products in different orders (XLA:CPU against
PyTorch's CPU kernels), so agreement is to f32 rounding of those sums:
log-probs to atol/rtol 1e-5, gradients to atol 1e-6 / rtol 1e-5
(measured differences: under 1e-6 and 1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models import MnistCNN, MnistLinear, MnistMLP
from mpit_tpu.models import flatten_module as jax_flatten
from mpit_tpu_torch.models.flat import flatten_module, value_and_grad_nll
from mpit_tpu_torch.models.mnist import make_model

# One intra-op thread: the suite runs several test processes side by side
# on the CPU, and these tensors are small.
torch.set_num_threads(1)

JAX_MODELS = {
    "linear": lambda side: MnistLinear(num_classes=10),
    "mlp": lambda side: MnistMLP(num_classes=10),
    "cnn": lambda side: MnistCNN(side=side, num_classes=10),
}


def _pair(name, side, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((16, side * side), dtype=np.float32)
    y = (np.arange(16) % 10).astype(np.int32)
    jflat = jax_flatten(JAX_MODELS[name](side), jax.random.PRNGKey(seed),
                        jnp.asarray(x[:2]))
    params = jax.tree_util.tree_map(np.asarray, jflat.unravel(jflat.w0))
    tflat = flatten_module(make_model(name, side), seed)
    return jflat, tflat, params, x, y


@pytest.mark.parametrize("name,side", [("linear", 8), ("linear", 16), ("mlp", 8),
                                       ("mlp", 16), ("cnn", 8), ("cnn", 16)])
def test_same_w0_same_logprobs_and_grads(name, side):
    jflat, tflat, params, x, y = _pair(name, side)
    w = tflat.from_jax_params(params)
    assert tflat.size == jflat.size
    np.testing.assert_array_equal(w.numpy(), np.asarray(jflat.w0))

    logp_j = np.asarray(jflat.apply_flat(jflat.w0, jnp.asarray(x)))
    logp_t = tflat.apply_flat(w, torch.from_numpy(x))
    np.testing.assert_allclose(logp_t.detach().numpy(), logp_j, rtol=1e-5, atol=1e-5)

    def jloss(wj):
        logp = jflat.apply_flat(wj, jnp.asarray(x))
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=1))

    lj, gj = jax.value_and_grad(jloss)(jflat.w0)
    lt, gt = value_and_grad_nll(tflat)(w, torch.from_numpy(x), torch.from_numpy(y).long())
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["linear", "mlp", "cnn"])
def test_jax_params_round_trip_bit_exact(name):
    _, tflat, params, _, _ = _pair(name, 8)
    back = tflat.to_jax_params(tflat.from_jax_params(params))
    flat_a = jax.tree_util.tree_leaves(params)
    flat_b = jax.tree_util.tree_leaves(back)
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(back)
    for a, b in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_cnn_flat_layout_at_full_width():
    """Side 32: 544,522 parameters, ravel order bias-before-kernel, Dense_0
    the 4096x128 NHWC-flatten head."""
    tflat = flatten_module(make_model("cnn", 32), 1)
    assert tflat.size == 544_522
    assert [name for name, _ in tflat.spec] == [
        "Conv_0.bias", "Conv_0.kernel", "Conv_1.bias", "Conv_1.kernel",
        "Dense_0.bias", "Dense_0.kernel", "Dense_1.bias", "Dense_1.kernel"]
    assert dict(tflat.spec)["Dense_0.kernel"] == (4096, 128)
    assert dict(tflat.spec)["Conv_1.kernel"] == (3, 3, 32, 64)


def test_seeded_init_is_lecun_normal_and_deterministic():
    a = flatten_module(make_model("mlp", 16), 5)
    b = flatten_module(make_model("mlp", 16), 5)
    assert torch.equal(a.w0, b.w0)
    leaves = a.unravel(a.w0)
    assert torch.count_nonzero(leaves["Dense_0.bias"]) == 0
    k = leaves["Dense_0.kernel"]
    std = (1 / 256) ** 0.5
    assert float(k.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(float(k.std()) - std) < 0.05 * std


def test_from_jax_params_rejects_wrong_shapes():
    _, tflat, params, _, _ = _pair("linear", 8)
    params["Dense_0"]["kernel"] = params["Dense_0"]["kernel"][:, :5]
    with pytest.raises(ValueError):
        tflat.from_jax_params(params)
