"""The port's two entry points against the JAX package, end to end on CPU.

- ``mpit_tpu_torch.train.mesh_launch.run`` (EASGD, CNN at side 8, dp=2,
  two epochs) against ``mpit_tpu.train.mesh_launch.run``;
- ``mpit_tpu_torch.train.launch`` (``--np 1 --opt msgd``, one epoch)
  against ``mpit_tpu.train.trainer.MnistTrainer``.

Both sides start from the same flax ``w0`` (the port's init is replaced by
the JAX one through ``from_jax_params``), read the same data in the same
order (``default_rng(seed)``), and the JAX side commits through its Pallas
kernel in interpret mode (``MPIT_FUSED=1``).  Tolerances: per-epoch mean
losses to rtol 1e-5, the reference's own for its fused updates (the
gradients differ only by the summation order of the convolutions and
matrix products; measured: at most 6e-8 relative); test error to within
one of the 270 test samples, since an arg-max near a tie may flip on
another CPU (measured: equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpit_tpu_torch.train.launch as tlaunch
import mpit_tpu_torch.train.mesh_launch as tmesh
import mpit_tpu_torch.train.trainer as ttrainer
from mpit_tpu.data.mnist import load_mnist as jax_load_mnist
from mpit_tpu.models import MnistCNN, MnistLinear
from mpit_tpu.models import flatten_module as jax_flatten
from mpit_tpu.train.mesh_launch import MESH_LAUNCH_DEFAULTS as JAX_MESH_DEFAULTS
from mpit_tpu.train.mesh_launch import run as jax_mesh_run
from mpit_tpu.train.trainer import TRAINER_DEFAULTS as JAX_TRAINER_DEFAULTS
from mpit_tpu.train.trainer import MnistTrainer as JaxTrainer
from mpit_tpu_torch.data.mnist import load_mnist
from mpit_tpu_torch.models.flat import FlatModel

# One intra-op thread: the suite runs several test processes side by side
# on the CPU, and these tensors are small.
torch.set_num_threads(1)

LOSS_RTOL = 1e-5
N_TEST = 270  # optdigits fixture: 15% of 1797
N_TRAIN = 1797 - N_TEST


def _jax_params(module, seed, side):
    (x, _, _, _), _ = jax_load_mnist(side=side)
    flat = jax_flatten(module, jax.random.PRNGKey(seed), jnp.asarray(x[:2]))
    return jax.tree_util.tree_map(np.asarray, flat.unravel(flat.w0))


def _init_from(params, target, monkeypatch):
    """Make the port's entry point start from the flax parameters."""
    real = target.flatten_module

    def from_jax(module, seed, device="cpu"):
        spec = real(module, seed, device)
        return FlatModel(spec.module, spec.from_jax_params(params).to(device))

    monkeypatch.setattr(target, "flatten_module", from_jax)


def _assert_histories_match(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert p["epoch"] == r["epoch"]
        np.testing.assert_allclose(p["avg_loss"], r["avg_loss"], rtol=LOSS_RTOL)
        assert abs(p["test_err"] - r["test_err"]) <= 1.0 / N_TEST + 1e-7


def test_data_identical_to_reference():
    for side in (8, 32):
        (a, _) = load_mnist(side=side)
        (b, _) = jax_load_mnist(side=side)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("device_stream", [0, 1])
def test_mesh_launch_matches_jax(monkeypatch, device_stream):
    kw = dict(model="cnn", side=8, dp=2, epochs=2, su=2, batch=128,
              lr=1e-2, mom=0.99, device_stream=device_stream, precompile=1)
    monkeypatch.setenv("MPIT_FUSED", "1")
    # Two mesh devices, so the reference's mesh is dp=2, shard=1 as well.
    monkeypatch.setenv("MPIT_MESH_DEVICES", "2")
    ref = jax_mesh_run(JAX_MESH_DEFAULTS.merged(kw))
    assert ref["mesh"] == {"dp": 2, "shard": 1}
    _init_from(_jax_params(MnistCNN(side=8), 1, 8), tmesh, monkeypatch)
    port = tmesh.run(tmesh.MESH_LAUNCH_DEFAULTS.merged(kw, device="cpu"))
    _assert_histories_match(port["history"], ref["history"])
    assert port["history"][1]["avg_loss"] < port["history"][0]["avg_loss"]
    assert set(ref) <= set(port)
    assert port["mesh"] == {"dp": 2, "shard": 1}
    assert port["samples_trained"] == ref["samples_trained"]
    assert port["steps"] == port["samples_trained"] // (2 * 128)
    assert port["device"] == "cpu"


def test_launch_np1_msgd_matches_jax_trainer(monkeypatch, capsys):
    kw = dict(side=8, epochs=1)
    monkeypatch.setenv("MPIT_FUSED", "1")
    ref = JaxTrainer(JAX_TRAINER_DEFAULTS.merged(kw)).run()
    _init_from(_jax_params(MnistLinear(num_classes=10), 1, 8), ttrainer, monkeypatch)
    port = tlaunch.main(["--np", "1", "--opt", "msgd", "--device", "cpu",
                         "--side", "8", "--epochs", "1"])
    _assert_histories_match(port["history"], ref["history"])
    assert port["role"] == "local"
    assert port["steps"] == N_TRAIN // 128
    assert '"rank0"' in capsys.readouterr().out
