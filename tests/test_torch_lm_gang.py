"""The LM through the PS gang (``mpit_tpu_torch.lm``) against the JAX
package's (``mpit_tpu.lm``), on the CPU, where the port's LM runs the plain
attention (the JAX side its jnp reference).

- Data: ``doc_batch`` and ``PackedStream`` arrays equal to the JAX ones for
  the same seeds and steps, exactly.
- The plan: ``plan(...).layout`` (every Shard's start and end) and the
  footprint equal to the JAX plan's at two widths and two weightings, the
  port planning over the flax-named tree of ``FlatModel.to_jax_params``
  and over the launcher's shape-only tree; the audit covers the train
  state.
- The model: ``build()``'s loss and gradient from the JAX ``build()``'s
  ``flat.w0`` within 2e-5 (``test_torch_lm.py``'s ``MODEL_ATOL``).
- Gangs: one DOWNPOUR worker on 2 weighted servers, the port's gang
  against the JAX gang from one ``w0``, per-step losses within rtol 2e-4 /
  atol 2e-5 (``test_torch_lm.py``'s ``LOSS_RTOL``/``LOSS_ATOL``); a port
  LM worker against JAX servers on the weighted cut (codec none: a JAX
  server encoding a quantized snapshot would start the JAX package's
  process-global pool in this process), against the all-JAX gang.
- The static ``layout=`` seam: servers adopt the weighted cut; chunked int8
  with a reader; the reader's layout; the validation errors, in the JAX
  package's words.
- The trainer (``TestLmTrainer``) and the launcher (``--lm 1`` as a process
  gang with ``--agg tree``, its refusals).
"""

import threading

import jax
import numpy as np
import pytest
import torch

import mpit_tpu.lm as jlm
from mpit_tpu.comm.local import LocalRouter as JaxRouter
from mpit_tpu.data import tokens as jtokens
from mpit_tpu.ft import FTConfig as JaxFT
from mpit_tpu.ps import ParamClient as JaxClient
from mpit_tpu.ps import ParamServer as JaxServer
from mpit_tpu.utils.config import Config as JaxConfig
from mpit_tpu_torch.comm.local import LocalRouter
from mpit_tpu_torch.data import tokens
from mpit_tpu_torch.ft import FTConfig
from mpit_tpu_torch.lm import (
    EOS,
    LmTrainer,
    PackedStream,
    audit_rules,
    build,
    packed_batch,
    plan,
    train_state_tree,
)
from mpit_tpu_torch.ps import ParamClient, ParamServer
from mpit_tpu_torch.ps.serve import ReaderClient
from mpit_tpu_torch.train import launch
from mpit_tpu_torch.utils.config import Config

torch.set_num_threads(1)

MODEL_ATOL = 2e-5
LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5
WIDTHS = dict(d_model=32, n_heads=4, n_layers=1, seq_len=32)


def join_all(threads, timeout=60):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "gang thread did not stop (hang)"


def jax_model(**widths):
    return jlm.build(use_flash=False, **{**WIDTHS, **widths})


# ---------------------------------------------------------------------------
# the data


class TestPackedStream:
    @pytest.mark.parametrize("seed,step,budget", [(0, 0, 100), (11, 7, 2048),
                                                  (2**31, 3, 513)])
    def test_doc_batch_equals_jax(self, seed, step, budget):
        ours = tokens.doc_batch(seed, step, budget=budget)
        theirs = jtokens.doc_batch(seed, step, budget=budget)
        assert len(ours) == len(theirs)
        assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
                   for a, b in zip(ours, theirs))

    @pytest.mark.parametrize("seed,batch,seq_len", [(1, 8, 128), (3, 4, 32),
                                                    (100_004, 2, 1024)])
    def test_packed_stream_equals_jax(self, seed, batch, seq_len):
        ours, theirs = PackedStream(seed, batch, seq_len), jlm.PackedStream(seed, batch,
                                                                          seq_len)
        for step in (0, 1, 9):
            a, b = ours.batch_at(step), theirs.batch_at(step)
            assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()

    def test_shape_eos_and_purity(self):
        b = packed_batch(3, 0, batch=4, seq_len=32)
        assert b.shape == (4, 33) and b.min() >= 0 and b.max() < 256
        assert (b == EOS).any() and (b != EOS).sum() > b.size // 2
        state = np.random.get_state()[1].copy()
        assert packed_batch(3, 0, batch=4, seq_len=32).tobytes() == b.tobytes()
        np.testing.assert_array_equal(np.random.get_state()[1], state)
        with pytest.raises(ValueError):
            packed_batch(0, 0, batch=2, seq_len=1)


# ---------------------------------------------------------------------------
# the plan


class TestLmPlan:
    @pytest.mark.parametrize("widths", [
        dict(d_model=16, n_heads=2, n_layers=1, seq_len=16),
        dict(d_model=64, n_heads=4, n_layers=3, seq_len=128),
    ])
    @pytest.mark.parametrize("n,weights,rule", [(2, None, "add"), (3, [3, 1, 2], "adam"),
                                                (2, [3, 2], "rmsprop")])
    def test_layout_equals_the_jax_plan(self, widths, n, weights, rule):
        jm = jax_model(**widths)
        theirs = jlm.plan(jm.flat.unravel(jm.flat.w0), n, rule=rule,
                          server_weights=weights)
        pm = build(device="cpu", use_flash=False, w0=np.asarray(jm.flat.w0), **widths)
        ours = plan(pm.flat.to_jax_params(pm.flat.w0), n, rule=rule,
                    server_weights=weights)
        edges = [(s.offset, s.end) for s in ours.layout]
        assert edges == [(s.offset, s.end) for s in theirs.layout]
        assert [tuple(s) for s in ours.segments] == [tuple(s) for s in theirs.segments]
        assert ours.summary() == theirs.summary()
        assert [ours.footprint_bytes(i) for i in range(n)] == \
            [theirs.footprint_bytes(i) for i in range(n)]
        # the launcher plans over shapes alone and cuts the same
        cfg = launch.LAUNCH_DEFAULTS.merged(
            lm=1, opt=rule if rule != "add" else "downpour", device="cpu",
            lm_d_model=widths["d_model"], lm_heads=widths["n_heads"],
            lm_layers=widths["n_layers"], lm_seq=widths["seq_len"],
            lm_weights=",".join(str(w) for w in weights) if weights else "")
        assert [(s.offset, s.end) for s in launch.lm_layout(cfg, n)] == edges
        assert launch.serve_vec_len(cfg) == ours.plong

    def test_footprint_audit_and_shard_map(self):
        pm = build(device="cpu", use_flash=False, d_model=16, n_heads=2, n_layers=1,
                   seq_len=16)
        params = pm.flat.to_jax_params(pm.flat.w0)
        p_add, p_adam = plan(params, 2, rule="add"), plan(params, 2, rule="adam")
        assert p_add.layout == p_adam.layout
        assert p_adam.footprint_bytes(0) == 3 * p_add.footprint_bytes(0)
        smap = p_add.shard_map([0, 2])
        assert smap.plong == pm.flat.size and [e.owner for e in smap.entries] == [0, 2]
        report = audit_rules(train_state_tree(params, "adam"))
        jm = jax_model(d_model=16, n_heads=2, n_layers=1, seq_len=16)
        want = jlm.audit_rules(jlm.train_state_tree(jm.flat.unravel(jm.flat.w0), "adam"))
        assert report == want
        with pytest.raises(ValueError):
            plan(params, 2, server_weights=[1, 2, 3])
        with pytest.raises(ValueError):
            plan(params, 0)


# ---------------------------------------------------------------------------
# the model


def test_loss_and_grad_match_the_jax_build():
    jm = jax_model(n_layers=2)
    w0 = np.asarray(jm.flat.w0)
    grid = packed_batch(4, 0, batch=4, seq_len=WIDTHS["seq_len"])
    jloss, jgrad = jax.jit(jm.value_and_grad)(jm.flat.w0, grid)
    for use_flash in (False, True):
        pm = build(device="cpu", use_flash=use_flash, w0=w0, **{**WIDTHS, "n_layers": 2})
        assert pm.flat.w0.numpy().tobytes() == w0.tobytes()
        loss, grad = pm.value_and_grad(pm.flat.w0, torch.from_numpy(grid))
        np.testing.assert_allclose(float(loss), float(jloss), atol=MODEL_ATOL)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=MODEL_ATOL)
        np.testing.assert_allclose(float(pm.loss(pm.flat.w0, grid)), float(jloss),
                                   atol=MODEL_ATOL)


# ---------------------------------------------------------------------------
# gangs: the port's against the JAX package's


def gang_ft(pkg_ft, chunk_bytes=0):
    return pkg_ft(op_deadline_s=5.0, max_retries=8, backoff_base_s=0.005,
                  backoff_cap_s=0.02, chunk_bytes=chunk_bytes)


def lm_gang(server_pkg, worker_pkg, w0, layout, *, steps=6, opt="downpour", lr=0.3):
    """Two servers (ranks 0, 1) holding ``layout`` and one LM worker (rank
    2) of the named packages on one router, from ``w0``; returns the
    worker's per-step losses and the servers' final params."""
    jax_gang = "jax" in (server_pkg, worker_pkg)
    router = JaxRouter(3) if jax_gang else LocalRouter(3)
    rule = "add" if opt == "downpour" else opt
    servers = [JaxServer(r, [2], router.endpoint(r), rule=rule, ft=gang_ft(JaxFT))
               if server_pkg == "jax" else
               ParamServer(r, [2], router.endpoint(r), rule=rule, device="cpu",
                           ft=gang_ft(FTConfig))
               for r in (0, 1)]
    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in threads:
        t.start()
    kw = dict(opt=opt, lr=lr, steps=steps, batch=4, eval_every=1, eval_batches=1,
              seed=1, use_flash=0, **WIDTHS)
    if worker_pkg == "jax":
        pc = JaxClient(2, [0, 1], router.endpoint(2), seed_servers=True, codec="none",
                       ft=gang_ft(JaxFT), layout=layout)
        trainer = jlm.LmTrainer(JaxConfig(**kw), pclient=pc, rank=2)
        trainer.w = trainer.w.at[:].set(w0)
    else:
        pc = ParamClient(2, [0, 1], router.endpoint(2), seed_servers=True, codec="none",
                         ft=gang_ft(FTConfig), layout=layout)
        trainer = LmTrainer(Config(device="cpu", **kw), pclient=pc, rank=2)
        trainer.w = torch.from_numpy(w0.copy())
    res = trainer.run()
    for s in servers:
        s.live.stop()
    join_all(threads)
    held = np.concatenate([np.asarray(torch.as_tensor(s.param).cpu()) if server_pkg != "jax"
                           else np.asarray(s.param) for s in servers])
    return [h["avg_loss"] for h in res["history"]], held, res


@pytest.fixture(scope="module")
def jax_lm_gang():
    jm = jax_model()
    w0 = np.asarray(jm.flat.w0)
    layout = jlm.plan(jm.flat.unravel(jm.flat.w0), 2, server_weights=[3, 1]).layout
    losses, held, _ = lm_gang("jax", "jax", w0, layout)
    return w0, layout, losses, held


def test_downpour_gang_tracks_the_jax_gang(jax_lm_gang):
    """One DOWNPOUR worker on 2 servers holding the 3:1 weighted cut: the
    port's whole gang against the JAX gang, per-step losses."""
    w0, layout, want, held_jax = jax_lm_gang
    got, held, res = lm_gang("torch", "torch", w0, layout)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(held, held_jax, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert res["tokens_total"] == 6 * 4 * WIDTHS["seq_len"]


def test_port_worker_against_jax_servers(jax_lm_gang):
    """A port LM worker announces the weighted cut to JAX servers, which
    adopt it (a mismatched shard size would fail at INIT)."""
    w0, layout, want, held_jax = jax_lm_gang
    got, held, _ = lm_gang("jax", "torch", w0, layout)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(held, held_jax, rtol=LOSS_RTOL, atol=LOSS_ATOL)


# ---------------------------------------------------------------------------
# the static layout= seam


class TestClientLayout:
    def _run(self, layout, size, *, codec=None, chunk_bytes=0, reader=False):
        nserv = len(layout)
        router = LocalRouter(nserv + 1 + (1 if reader else 0))
        ftc = gang_ft(FTConfig, chunk_bytes)
        servers = [ParamServer(r, [nserv], router.endpoint(r), ft=ftc, device="cpu",
                               reader_ranks=([nserv + 1] if reader else None))
                   for r in range(nserv)]
        threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
        for t in threads:
            t.start()
        client = ParamClient(nserv, list(range(nserv)), router.endpoint(nserv),
                             seed_servers=True, codec=codec, ft=ftc, layout=layout)
        param, grad = np.arange(size, dtype=np.float32), np.zeros(size, np.float32)
        client.start(param, grad)
        grad[:] = 1.0
        client.async_send_grad()
        client.async_recv_param()
        client.wait()
        read = None
        if reader:
            rc = ReaderClient(nserv + 1, list(range(nserv)), router.endpoint(nserv + 1),
                              codec=codec, ft=ftc, layout=layout)
            mirror = np.zeros(size, np.float32)
            rc.start(mirror)
            rc.read_params()
            read = mirror.copy()
            rc.stop()
        client.stop()
        for s in servers:
            s.live.stop()
        join_all(threads)
        return servers, param, read

    def test_servers_adopt_the_weighted_cut(self):
        params = {"a": np.zeros((6, 4), np.float32), "b": np.zeros(40, np.float32),
                  "c": np.zeros((8, 2), np.float32)}
        layout = plan(params, 2, server_weights=[3, 1]).layout
        servers, param, _ = self._run(layout, 80)
        for srv, shard in zip(servers, layout):
            assert (srv.offset, srv.size) == (shard.offset, shard.size)
        assert param.tobytes() == (np.arange(80, dtype=np.float32) + 1.0).tobytes()

    def test_layout_composes_with_chunked_int8(self):
        params = {"a": np.zeros(96, np.float32), "b": np.zeros((32, 8), np.float32),
                  "c": np.zeros(160, np.float32)}
        layout = plan(params, 2, server_weights=[5, 3]).layout
        servers, param, read = self._run(layout, 512, codec="int8", chunk_bytes=256,
                                         reader=True)
        held = np.concatenate([s.param.cpu().numpy() for s in servers])
        assert param.tobytes() == read.tobytes()
        q = float(np.abs(held).max()) / 127.0
        np.testing.assert_allclose(param, held, atol=2 * q)

    def test_reader_layout_matches_writers(self):
        params = {"a": np.zeros(30, np.float32), "b": np.zeros(34, np.float32)}
        layout = plan(params, 2, server_weights=[2, 1]).layout
        _, param, read = self._run(layout, 64, reader=True)
        assert read.tobytes() == param.tobytes()

    def test_layout_validation_is_loud(self):
        router = LocalRouter(2)
        layout = plan({"a": np.zeros(64, np.float32)}, 1).layout
        with pytest.raises(ValueError, match="exactly one each"):
            ParamClient(1, [0, 2], router.endpoint(1), layout=layout)
        with pytest.raises(ValueError, match="cannot combine"):
            ParamClient(1, [0], router.endpoint(1), layout=layout, shardctl=True,
                        ft=FTConfig(op_deadline_s=1.0))
        with pytest.raises(ValueError, match="exactly one each"):
            ReaderClient(1, [0, 2], router.endpoint(1), layout=layout,
                         ft=FTConfig(op_deadline_s=1.0))
        client = ParamClient(1, [0], router.endpoint(1), layout=layout)
        with pytest.raises(ValueError, match="registered vector"):
            client.start(np.zeros(32, np.float32), np.zeros(32, np.float32))
        reader = ReaderClient(1, [0], router.endpoint(1), layout=layout,
                              ft=FTConfig(op_deadline_s=1.0))
        with pytest.raises(ValueError, match="mirror has"):
            reader.start(np.zeros(32, np.float32))


# ---------------------------------------------------------------------------
# the trainer


class TestLmTrainer:
    CFG = Config(d_model=32, n_heads=2, n_layers=1, seq_len=32, batch=4, opt="sgd",
                 lr=0.5, steps=30, eval_every=15, eval_batches=1, seed=0, use_flash=0,
                 device="cpu")

    def test_local_sgd_learns(self):
        res = LmTrainer(self.CFG).run()
        losses = [h["avg_loss"] for h in res["history"]]
        assert all(np.isfinite(x) for x in losses) and losses[-1] < losses[0]
        assert res["final_eval_loss"] < 6.5

    def test_tokens_accounting_and_result_keys(self):
        res = LmTrainer(self.CFG.merged(steps=6, eval_every=3)).run()
        assert res["tokens_total"] == 6 * 4 * 32
        assert res["tokens_per_s"] > 0 and res["train_seconds"] > 0
        assert all(h["tokens_per_s"] > 0 for h in res["history"])
        jres = jlm.LmTrainer(JaxConfig(**{k: v for k, v in self.CFG.merged(
            steps=2, eval_every=1).to_dict().items() if k != "device"})).run()
        assert set(res) == set(jres)
        assert set(res["history"][0]) == set(jres["history"][0])

    def test_defaults_are_the_jax_defaults_on_the_card(self):
        from mpit_tpu_torch.lm import LM_DEFAULTS

        want = jlm.LM_DEFAULTS.to_dict()
        got = LM_DEFAULTS.to_dict()
        assert got.pop("device") == "cuda" and got == want
        assert LmTrainer.KNOWN_OPTS == jlm.LmTrainer.KNOWN_OPTS

    def test_server_opts_require_a_client(self):
        with pytest.raises(ValueError, match="parameter client"):
            LmTrainer(self.CFG.merged(opt="downpour")).run()
        with pytest.raises(ValueError, match="unknown optimizer"):
            LmTrainer(self.CFG.merged(opt="nope")).run()


# ---------------------------------------------------------------------------
# the launcher


LM_FLAGS = ["--device", "cpu", "--lm", "1", "--lm_d_model", "32", "--lm_heads", "4",
            "--lm_layers", "1", "--lm_seq", "32", "--lm_steps", "4",
            "--lm_eval_every", "2", "--batch", "4"]


def test_launch_lm_process_gang_with_the_tree():
    """``launch --np 4 --lm 1 --agg tree`` on the CPU: two workers reduce
    through the tree onto two servers holding the 3:2 weighted cut; each
    server applies one GRAD a round, the losses are finite, and each
    child reports the flash kernels' launches (0: the CPU runs the plain
    attention)."""
    res = launch.main(["--np", "4", "--opt", "downpour", "--lr", "0.3",
                       "--lm_weights", "3,2", "--ft_op_deadline_s", "30",
                       "--ft_chunk_bytes", "65536", "--codec", "int8", "--agg", "tree",
                       "--agg_deadline_s", "60"] + LM_FLAGS)
    workers = [r for r in res.values() if r["role"] == "worker"]
    servers = [r for r in res.values() if r["role"] == "server"]
    assert len(workers) == len(servers) == 2
    assert all(s["grads_applied"] == 4 for s in servers)
    assert all(np.isfinite(h["avg_loss"]) for w in workers for h in w["history"])
    assert all(w["tokens_total"] == 4 * 4 * 32 for w in workers)
    assert all(r["launches"] == {"k1": 0, "k2": 0, "k3": 0, "k4": 0, "k5": 0, "k6": 0}
               for r in res.values())


def test_launch_lm_in_process_and_alone():
    """``run_gang`` with --lm and an Adam server rule; ``--np 1 --lm 1``
    trains locally (sgd)."""
    cfg = launch.LAUNCH_DEFAULTS.parse_args(
        LM_FLAGS + ["--opt", "adam", "--lr", "1e-3", "--ft_op_deadline_s", "30",
                    "--lm_weights", "1,1"])
    res = launch.run_gang(3, cfg, timeout=120)
    assert res[1]["role"] == "worker" and res[1]["steps"] == 4
    assert res[0]["grads_applied"] + res[2]["grads_applied"] == 2 * 4
    local = launch.main(["--np", "1", "--opt", "sgd", "--lr", "0.5"] + LM_FLAGS)
    assert local["role"] == "local" and local["tokens_total"] == 4 * 4 * 32


@pytest.mark.parametrize("flags,match", [
    (["--tester", "last"], "mutually exclusive"),
    (["--serve_readers", "1", "--cells", "1", "--ft_op_deadline_s", "5"],
     "not composed yet"),
    (["--opt", "adam-single"], "unknown LM optimizer"),
    (["--lm_weights", "1,2,3"], "--lm_weights names 3 servers"),
])
def test_launch_lm_refusals(flags, match):
    """The JAX launcher's refusals under --lm, with its words (the weights
    mismatch raises in the ranks, the rest in the parent)."""
    argv = ["--np", "4"] + LM_FLAGS + flags
    if "--lm_weights" in flags:
        cfg = launch.LAUNCH_DEFAULTS.parse_args(argv)
        with pytest.raises(ValueError, match=match):
            launch.lm_layout(cfg, 2)
        return
    with pytest.raises(ValueError, match=match):
        launch.main(argv)
