"""The slice as a whole: in-process parameter-server gangs of the port
against the JAX package's, and the topologies of tests/test_trainer.py.

One-worker gangs (np=3: servers on ranks 0 and 2, the worker on rank 1)
of the port and of the JAX package run side by side on the CPU over their
own in-process routers, from one flax ``w0`` (the worker's PRNGKey(seed +
rank), carried over through ``from_jax_params``), on the same data in the
same order.  With one worker the per-server FIFO op chains make the run
deterministic.  Both the per-epoch mean losses and the final server shards
are held to the reference's tolerance for its fused updates, rtol 1e-5 /
atol 1e-6 (tests/test_ops.py): the two sides differ only by the summation
order of the convolutions and matrix products (measured: at most 6e-8
relative in a loss, tests/test_torch_slice.py) and by XLA's fused
multiply-adds in the rules.  The JAX side commits msgd through its Pallas
kernel in interpret mode (``MPIT_FUSED=1``), and so runs its server-side
Adam.

Every gang here uses codec ``none`` against a JAX server: a JAX server
encoding a quantized snapshot starts the JAX package's process-global
worker pool, which other test files of the reference do not expect.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpit_tpu.train.launch as jax_launch
import mpit_tpu_torch.train.trainer as ttrainer
from mpit_tpu.comm.local import LocalRouter as JaxRouter
from mpit_tpu.data.mnist import load_mnist as jax_load_mnist
from mpit_tpu.models import MnistCNN
from mpit_tpu.models import flatten_module as jax_flatten
from mpit_tpu_torch.data.mnist import load_mnist
from mpit_tpu_torch.models.flat import FlatModel, flatten_module
from mpit_tpu_torch.models.mnist import make_model
from mpit_tpu_torch.train import launch
from mpit_tpu_torch.utils.config import Config

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
SIDE = 8
WORKER = 1  # the one worker's rank at np=3


@pytest.fixture(scope="module")
def data():
    (x_train, y_train, x_test, y_test), _ = load_mnist(side=SIDE)
    return x_train, y_train, x_test, y_test


@pytest.fixture(scope="module")
def small_data(data):
    x_train, y_train, x_test, y_test = data
    return x_train[:512], y_train[:512], x_test[:256], y_test[:256]


def _jax_params(module, seed):
    (x, _, _, _), _ = jax_load_mnist(side=SIDE)
    flat = jax_flatten(module, jax.random.PRNGKey(seed), jnp.asarray(x[:2]))
    return jax.tree_util.tree_map(np.asarray, flat.unravel(flat.w0))


def _jax_gang(size, cfg, data):
    """The JAX package's gang on threads over its router (as
    tests/test_trainer.py runs topologies); returns each rank's result
    with each server's final shard under ``param``."""
    router = JaxRouter(size)
    results, errors, servers = {}, {}, {}

    class RecordingServer(jax_launch.ParamServer):
        def start(self):
            servers[self.rank] = self
            super().start()

    def target(rank):
        try:
            results[rank] = jax_launch.run_rank(rank, size, cfg,
                                                router.endpoint(rank), data=data)
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors[rank] = exc

    real = jax_launch.ParamServer
    jax_launch.ParamServer = RecordingServer
    try:
        threads = [threading.Thread(target=target, args=(r,), daemon=True)
                   for r in range(size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        jax_launch.ParamServer = real
    assert not errors, errors
    for rank, server in servers.items():
        results[rank]["param"] = np.asarray(server.param)
    return results


@pytest.mark.parametrize("opt,kw", [
    ("downpour", dict(lr=0.05, su=1)),
    ("adam", dict(lr=1e-3, su=1)),
    ("eamsgd", dict(lr=1e-2, su=2, mom=0.9, mva=0.45)),
])
def test_one_worker_gang_matches_jax(monkeypatch, data, opt, kw):
    monkeypatch.setenv("MPIT_FUSED", "1")
    common = dict(np=3, opt=opt, model="cnn", side=SIDE, epochs=2, batch=128,
                  codec="none", **kw)
    ref = _jax_gang(3, jax_launch.LAUNCH_DEFAULTS.merged(common), data)

    params = _jax_params(MnistCNN(side=SIDE), 1 + WORKER)
    real = ttrainer.flatten_module

    def from_jax(module, seed, device="cpu"):
        spec = real(module, seed, device)
        return FlatModel(spec.module, spec.from_jax_params(params).to(device))

    monkeypatch.setattr(ttrainer, "flatten_module", from_jax)
    port = launch.run_gang(3, Config(**common, device="cpu"), data=data)

    assert {r: res["role"] for r, res in port.items()} == {
        r: res["role"] for r, res in ref.items()} == {0: "server", 1: "worker",
                                                       2: "server"}
    want, got = ref[WORKER]["history"], port[WORKER]["history"]
    assert len(got) == len(want) == 2
    for p, r in zip(got, want):
        np.testing.assert_allclose(p["avg_loss"], r["avg_loss"], rtol=RTOL, atol=ATOL)
    assert got[1]["avg_loss"] < got[0]["avg_loss"]
    for rank in (0, 2):
        assert port[rank]["grads_applied"] == ref[rank]["grads_applied"] > 0
        np.testing.assert_allclose(port[rank]["param"].numpy(), ref[rank]["param"],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("size,master_freq", [(2, 2), (4, 2), (12, 2), (6, 3)])
def test_roles_and_server_rules_match_jax(size, master_freq):
    for tester in ("none", "first", "last"):
        if size - (tester != "none") < 2:
            continue
        assert launch.assign_roles(size, master_freq, tester) == tuple(
            jax_launch.assign_roles(size, master_freq, tester))
    with pytest.raises(ValueError):
        launch.assign_roles(1)
    for opt in ("downpour", "eamsgd", "adam", "rmsprop", "adam-single"):
        port = launch.server_rule_for(Config(opt=opt, lr=0.1))
        ref = jax_launch.server_rule_for(Config(opt=opt, lr=0.1))
        name = lambda rule: getattr(rule.apply, "func", rule.apply).__name__
        assert name(port) == name(ref)


def _gang(size, data, **kw):
    cfg = launch.LAUNCH_DEFAULTS.merged(np=size, epochs=1, batch=64, side=SIDE,
                                        device="cpu", **kw)
    return launch.run_gang(size, cfg, data=data, timeout=300)


def _workers(results):
    return [res for res in results.values() if res["role"] == "worker"]


class TestTopologies:
    def test_downpour_np4(self, small_data):
        results = _gang(4, small_data, opt="downpour", lr=0.2, su=1)
        assert {r: res["role"] for r, res in results.items()} == {
            0: "server", 1: "worker", 2: "server", 3: "worker"}
        for rank in (0, 2):
            assert results[rank]["grads_applied"] == 2 * 8  # 2 workers x 8 steps
        for res in _workers(results):
            assert res["final_test_err"] < 0.8
            assert res["w"].device.type == "cpu"

    @pytest.mark.parametrize("codec", ["none", "int8"])
    def test_eamsgd_np4(self, small_data, codec):
        """The flagship EASGD topology, uncompressed and with int8 shard
        transfer (the client-held residual carries the quantization error
        across sync rounds): both reach the same test-error bar."""
        results = _gang(4, small_data, opt="eamsgd", lr=0.2, mom=0.9, mva=0.45,
                        su=5, codec=codec)
        workers = _workers(results)
        assert len(workers) == 2
        assert all(w["final_test_err"] < 0.8 for w in workers)
        # 8 steps at su=5 sync on steps 0 and 5: 2 rounds per worker.
        assert all(res["grads_applied"] == 4 for res in results.values()
                   if res["role"] == "server")

    def test_adam_server_stateful_np2(self, small_data):
        results = _gang(2, small_data, opt="adam", lr=1e-3, su=1)
        assert results[0]["role"] == "server" and results[0]["grads_applied"] == 8
        assert results[1]["role"] == "worker"
        assert results[1]["history"][0]["avg_loss"] < np.log(10) + 0.5

    def test_adam_single_mirrors_the_worker(self, small_data):
        results = _gang(2, small_data, opt="adam-single", lr=1e-3)
        assert results[0]["grads_applied"] == 0
        # The single-mode server mirrors the worker's last pushed vector.
        assert torch.equal(results[0]["param"], results[1]["w"])

    def test_eamsgd_comm_only_draws_workers_together(self, small_data):
        """lr = 0: no local update, every step a sync round through the
        elastic force alone (K2's path); the workers start apart (seed +
        rank) and end together.

        How close depends on how the two workers' rounds interleave, which
        the threads' scheduling decides: interleaved rounds, the usual
        case, leave them ~120x closer after 8 rounds each (4.43 -> 0.037),
        but under load one worker may finish its rounds before the other
        has done many (seen: 0.60 apart, in 4 of 112 loaded runs), and a
        worker that finishes first stops where the center was, which the
        other then pulls only halfway back: fully serialized rounds end
        start / 2 apart.  So the test holds the workers to that bound,
        which every interleaving meets, and holds the exchange itself
        exactly: each round moves the elastic difference from a worker to
        the center, so the sum of both workers and the center stays what it
        was (the center seeded with rank 1's start)."""
        results = _gang(4, small_data, opt="eamsgd", lr=0.0, mva=0.45, su=1)
        assert all(res["grads_applied"] == 16 for res in results.values()
                   if res["role"] == "server")
        module = make_model("linear", SIDE)
        w1, w3 = flatten_module(module, 2).w0, flatten_module(module, 4).w0
        start = float((w1 - w3).norm())
        end = float((results[1]["w"] - results[3]["w"]).norm())
        assert end < start / 2
        center = torch.cat([results[0]["param"], results[2]["param"]])
        torch.testing.assert_close(results[1]["w"] + results[3]["w"] + center,
                                   2 * w1 + w3, rtol=RTOL, atol=ATOL)
