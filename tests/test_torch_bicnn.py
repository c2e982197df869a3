"""BiCNN (slice 4) of the port against the JAX package, on the CPU.

At the JAX tests' small widths (embedding 6, hidden 8, 10 filters, conv
width 2, 4 negatives, batch 8; ``tests/test_bicnn_train.py``) on the
synthetic corpus, read by each package's own loader (bit-equal,
``tests/test_torch_qa.py``).  The flax ``w0`` is carried into the port by
``FlatModel.from_jax_params``.  The tower's embeddings and ``vgf`` are
also held at conv width 3, ``tools/torch_bicnn_scale.py``'s.  Tolerances:

- layers, the GESD head and the tower's embeddings: values within atol
  2e-6, gradients within atol 1e-5 (float32; the two differ by summation
  order only);
- the trainer: ``vgf``'s loss within rtol 1e-5 and its clipped gradient
  within atol 1e-5; ``sample_negatives`` and ``_pool_score``'s counts
  exact; five ``sgd`` steps (momentum 0.9) track the JAX losses within
  rtol 1e-5, and ``test3``'s accuracies are equal;
- the launcher's roles, tester flags and server rules: equal;
- gangs: a one-worker gang of port workers against JAX servers on a JAX
  ``LocalRouter`` (codec ``none``) within rtol 1e-5 / atol 1e-6 of the
  all-JAX gang, in its losses and in the servers' shards, under the
  ``add`` rule and under server-side Adam (``step_div`` 72).

Every one of the 14 optimization names trains in a port gang on the CPU,
and a process gang (``bicnn_launch --np 4 --device cpu``) gives its roles
and a tester checkpoint that the JAX ``load_flat`` reads.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpit_tpu.train.bicnn_launch as jax_launch
import mpit_tpu_torch.train.bicnn as tbicnn
from mpit_tpu.comm.local import LocalRouter as JaxRouter
from mpit_tpu.data import qa as jqa
from mpit_tpu.models import bicnn as jmodel
from mpit_tpu.models import layers as jlayers
from mpit_tpu.train.bicnn import BICNN_DEFAULTS as JAX_DEFAULTS
from mpit_tpu.train.bicnn import BiCNNTrainer as JaxTrainer
from mpit_tpu.train.bicnn import _pool_score as jax_pool_score
from mpit_tpu.train.bicnn import server_rule_for as jax_server_rule_for
from mpit_tpu.utils.checkpoint import load_flat as jax_load_flat
from mpit_tpu_torch.comm.local import LocalRouter
from mpit_tpu_torch.data import qa as tqa
from mpit_tpu_torch.models import bicnn as tmodel
from mpit_tpu_torch.models import layers as tlayers
from mpit_tpu_torch.models.flat import FlatModel
from mpit_tpu_torch.ps import ParamServer
from mpit_tpu_torch.train import bicnn_launch
from mpit_tpu_torch.train.bicnn import BICNN_DEFAULTS, BiCNNTrainer, gesd_np, server_rule_for

torch.set_num_threads(1)

VAL_ATOL, GRAD_ATOL = 2e-6, 1e-5
LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6
TINY = dict(embedding_dim=6, word_hidden_dim=8, num_filters=10, cont_conv_width=2,
            maxnegsample=4, batch_size=8, eval_chunk=16, loss_report_every=10**9)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("qa_port")
    return jqa.synthetic_qa(d, n_labels=10, n_train=96, n_eval=16,
                            embedding_dim=6, vocab_words=60, seed=11)


@pytest.fixture(scope="module")
def jdata(corpus):
    return jqa.load_qa_files(embedding_dim=6, conv_width=2, **corpus)


@pytest.fixture(scope="module")
def tdata(corpus):
    return tqa.load_qa_files(embedding_dim=6, conv_width=2, **corpus)


@pytest.fixture(scope="module")
def data_at_width(corpus, jdata, tdata):
    """Both packages' data by conv width: 2 (``TINY``'s) and 3 (the
    3,000-filter ``bicnn_scale`` configuration's)."""
    return {2: (jdata, tdata),
            3: (jqa.load_qa_files(embedding_dim=6, conv_width=3, **corpus),
                tqa.load_qa_files(embedding_dim=6, conv_width=3, **corpus))}


def _jax_params(flat, w):
    return jax.tree_util.tree_map(np.asarray, flat.unravel(w))


def _pair(jdata, tdata, **over):
    """A JAX trainer and a port trainer on the CPU from the JAX ``w0``."""
    jt = JaxTrainer(JAX_DEFAULTS.merged(TINY).merged(over), data=jdata)
    tt = BiCNNTrainer(BICNN_DEFAULTS.merged(TINY).merged(over, device="cpu"), data=tdata)
    tt.w = tt.flat.from_jax_params(_jax_params(jt.flat, jt.w))
    return jt, tt


def _batch(trainer, data, idx, as_jax):
    tr = data.train
    nt, nl = trainer.sample_negatives([tr.labels[i] for i in idx])
    arrays = (tr.q_tokens[idx], tr.q_len[idx], tr.a_tokens[idx], tr.a_len[idx], nt, nl)
    return tuple(jnp.asarray(a) if as_jax else torch.from_numpy(np.ascontiguousarray(a))
                 for a in arrays)


# -- layers and model ---------------------------------------------------------


def _vjp_pair(jfn, tfn, *inputs, ct_seed=5):
    """Values and input gradients of ``sum(f(x) * ct)`` in both packages."""
    jout, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in inputs))
    ct = np.random.default_rng(ct_seed).standard_normal(jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))
    targs = [torch.tensor(x, requires_grad=True) for x in inputs]
    tout = tfn(*targs)
    tgrads = torch.autograd.grad((tout * torch.from_numpy(ct)).sum(), targs)
    return (np.asarray(jout), tout.detach().numpy(),
            [np.asarray(g) for g in jgrads], [g.numpy() for g in tgrads])


@pytest.mark.parametrize("p", [2.0, np.inf])
def test_lp_normalize_matches(p):
    x = np.random.default_rng(0).standard_normal((4, 7)).astype(np.float32)
    jv, tv, jg, tg = _vjp_pair(lambda a: jlayers.lp_normalize(a, p=p),
                               lambda a: tlayers.lp_normalize(a, p=p), x)
    np.testing.assert_allclose(tv, jv, atol=VAL_ATOL)
    np.testing.assert_allclose(tg[0], jg[0], atol=GRAD_ATOL)


def test_masked_max_pool_splits_a_tie_as_jax_does():
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((3, 6, 5)).astype(np.float32)
    frames[0, 1, :] = frames[0, 3, :] = 9.0  # a tie inside the valid frames
    frames[1, 4, 2] = 50.0  # the largest value of row 1, in a masked frame
    n_valid = np.array([5, 3, 6], np.int32)
    jv, tv, jg, tg = _vjp_pair(lambda f: jlayers.masked_max_pool(f, jnp.asarray(n_valid)),
                               lambda f: tlayers.masked_max_pool(f, torch.from_numpy(n_valid)),
                               frames)
    np.testing.assert_allclose(tv, jv, atol=VAL_ATOL)
    np.testing.assert_allclose(tg[0], jg[0], atol=GRAD_ATOL)
    # The cotangent is split evenly over the tie, and none reaches a mask.
    np.testing.assert_allclose(tg[0][0, 1], tg[0][0, 3])
    assert np.all(tg[0][0, 1] != 0) and tg[0][1, 4, 2] == 0


def test_gesd_and_margin_loss_match():
    rng = np.random.default_rng(2)
    u, v = (rng.standard_normal((5, 9)).astype(np.float32) * 0.3 for _ in range(2))
    jv, tv, jg, tg = _vjp_pair(jmodel.gesd, tmodel.gesd, u, v)
    np.testing.assert_allclose(tv, jv, atol=VAL_ATOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL)
    sp, sn = rng.random(6).astype(np.float32), rng.random(6).astype(np.float32)
    np.testing.assert_allclose(
        tmodel.margin_ranking_loss(torch.from_numpy(sp), torch.from_numpy(sn), 0.1).numpy(),
        np.asarray(jmodel.margin_ranking_loss(jnp.asarray(sp), jnp.asarray(sn), 0.1)),
        atol=VAL_ATOL)
    np.testing.assert_allclose(tlayers.divide_constant(torch.tensor([2.0, 4.0]), 3.0),
                               [1.5, 0.75])


@pytest.mark.parametrize("width", [2, 3])
def test_tower_embeddings_and_gradients_match(data_at_width, width):
    jdata, tdata = data_at_width[width]
    jt, tt = _pair(jdata, tdata, optimization="sgd", cont_conv_width=width)
    tokens, lengths = jdata.train.a_tokens[:12], jdata.train.a_len[:12]
    ct = np.random.default_rng(3).standard_normal((12, 10)).astype(np.float32)

    def jloss(w):
        e = jt.flat.apply_flat(w, jnp.asarray(tokens), jnp.asarray(lengths),
                               method=jmodel.BiCNN.embed)
        return jnp.sum(e * ct), e

    (_, je), jg = jax.value_and_grad(jloss, has_aux=True)(jt.w)
    w = tt.w.clone().requires_grad_(True)
    te = tt.flat.apply_flat(w, torch.from_numpy(tokens), torch.from_numpy(lengths),
                            method=tmodel.BiCNN.embed)
    (tg,) = torch.autograd.grad((te * torch.from_numpy(ct)).sum(), w)
    np.testing.assert_allclose(te.detach().numpy(), np.asarray(je), atol=VAL_ATOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=GRAD_ATOL)
    # The leaves keep flax's names and layouts, the conv kernel (k, H, F).
    assert dict(tt.flat.spec)["tower.conv.kernel"] == (width, 8, 10)


# -- the trainer --------------------------------------------------------------


def test_sample_negatives_draw_the_same_rows(jdata, tdata):
    jt, tt = _pair(jdata, tdata, optimization="sgd")
    labels = [jdata.train.labels[i] for i in range(8)]
    for _ in range(3):
        (jn, jl), (tn, tl) = jt.sample_negatives(labels), tt.sample_negatives(labels)
        assert np.array_equal(jn, tn) and np.array_equal(jl, tl)


@pytest.mark.parametrize("over", [dict(), dict(l1reg=1e-3, margin=0.5, grad_clip=0.01),
                                  dict(cont_conv_width=3)])
def test_vgf_loss_and_clipped_grad_match(data_at_width, over):
    jdata, tdata = data_at_width[over.get("cont_conv_width", 2)]
    jt, tt = _pair(jdata, tdata, optimization="sgd", **over)
    idx = np.arange(8)
    jl, jg = jt._vgf(jt.w, *_batch(jt, jdata, idx, True))
    tl, tg = tt._vgf(tt.w, *_batch(tt, tdata, idx, False))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=GRAD_ATOL)
    assert float(tg.abs().max()) <= tt.cfg.grad_clip


def test_no_violation_means_zero_loss_and_grad(tdata):
    tt = BiCNNTrainer(BICNN_DEFAULTS.merged(TINY).merged(
        optimization="sgd", l2reg=0.0, margin=-10.0, device="cpu"), data=tdata)
    loss, g = tt._vgf(tt.w, *_batch(tt, tdata, np.arange(8), False))
    assert float(loss) == 0.0 and float(g.abs().max()) == 0.0


def test_pool_score_counts_exactly(jdata, tdata):
    """The port's scorer counts what the JAX scorer and the reference's host
    loop (``gesd_np``, last maximum on ties) count, unknown candidates and
    empty pools included."""
    import dataclasses

    _, tt = _pair(jdata, tdata, optimization="sgd")
    ans = tt._embed_chunked(tt.w, tdata.answer_tokens, tdata.answer_len)
    l2r = tdata.label2row
    sets = [(n, getattr(tdata, n)) for n in ("valid", "test1", "test2")]
    es = tdata.valid
    sets.append(("broken", dataclasses.replace(
        es, pools=[[] if i % 3 == 0 else p + [10**9] for i, p in enumerate(es.pools)])))
    for name, es in sets:
        q = tt._embed_chunked(tt.w, es.q_tokens, es.q_len)
        idx, mask, hit = tt._pool_tables(es, name)
        got = int(tbicnn._pool_score(q, ans, idx, mask, hit))
        ref = int(jax_pool_score(jnp.asarray(q.numpy()), jnp.asarray(ans.numpy()),
                                 jnp.asarray(idx.numpy().astype(np.int32)),
                                 jnp.asarray(mask.numpy()), jnp.asarray(hit.numpy())))
        oracle = 0
        for i in range(len(es)):
            pool = [v for v in es.pools[i] if v in l2r]
            if pool:
                sims = gesd_np(q[i].numpy(), ans[[l2r[v] for v in pool]].numpy())
                best = max(range(len(pool)), key=lambda j: (sims[j], j))
                oracle += pool[best] in es.labels[i]
        assert got == ref == oracle, name


def test_five_sgd_steps_track_jax(jdata, tdata):
    jt, tt = _pair(jdata, tdata, optimization="sgd", momentum=0.9, learning_rate=0.05)
    jl, tl = [], []
    for s in range(5):
        idx = np.arange(s * 8, (s + 1) * 8)
        jl.append(float(jt.step(idx)))
        tl.append(float(tt.step(idx)))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tt.w.numpy(), np.asarray(jt.w), atol=GRAD_ATOL)
    assert tt.test3() == jt.test3()


def test_checkpoint_loads_in_jax_and_resumes(jdata, tdata, tmp_path):
    _, tt = _pair(jdata, tdata, optimization="sgd", outputprefix=str(tmp_path / "ck"))
    tt._save_checkpoint()
    w, meta = jax_load_flat(tmp_path / "ck_latest.npz")
    assert w.dtype == np.float32 and w.tobytes() == tt.w.numpy().tobytes()
    assert meta["epoch"] == 0
    back = BiCNNTrainer(BICNN_DEFAULTS.merged(TINY).merged(
        optimization="sgd", device="cpu", loadmodel=str(tmp_path / "ck_latest.npz")),
        data=tdata)
    assert torch.equal(back.w, tt.w)


def test_float32_only(tdata):
    with pytest.raises(NotImplementedError, match="later slice"):
        BiCNNTrainer(BICNN_DEFAULTS.merged(TINY, dtype="float64", device="cpu"), data=tdata)
    router = LocalRouter(2)
    ParamServer(0, [1], router.endpoint(0), device="cpu", dtype="float32")
    for dtype in ("float64", "bfloat16"):
        with pytest.raises(NotImplementedError, match="later slice"):
            ParamServer(0, [1], router.endpoint(0), device="cpu", dtype=dtype)
    with pytest.raises(NotImplementedError, match="later slice"):
        bicnn_launch.main(["--np", "4", "--device", "cpu", "--dtype", "float64",
                           "--valid_mode", "none"])


def test_default_device_is_the_card(tdata, monkeypatch):
    assert BICNN_DEFAULTS.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        BiCNNTrainer(BICNN_DEFAULTS.merged(TINY), data=tdata)
    with pytest.raises(RuntimeError, match="CUDA"):
        bicnn_launch.main(["--np", "4", "--valid_mode", "none"])
    # The live endpoint no longer refuses: with MPIT_OBS_HTTP set the
    # launcher still asks for the card before any child starts.
    monkeypatch.setenv(bicnn_launch.STATUSD_ENV, "8931")
    with pytest.raises(RuntimeError, match="CUDA"):
        bicnn_launch.main(["--np", "4", "--valid_mode", "none"])


# -- the launcher -------------------------------------------------------------


@pytest.mark.parametrize("size,master_freq,tf,tl,mode,tester", [
    (s, f, tf, tl, m, t)
    for s in (2, 3, 4, 6, 7)
    for f in (2, 3)
    for tf, tl in ((False, False), (True, False), (False, True), (True, True))
    for m in ("none", "lastClient", "additionalTester", "bogus")
    for t in ("", "first", "last", "none")
    if (s + f + m.__len__() + len(t)) % 3 == 0  # a third of the grid
])
def test_roles_and_tester_flags_match_jax(size, master_freq, tf, tl, mode, tester):
    cfg = dict(testerfirst=tf, testerlast=tl, tester=tester)

    def outcome(mod):
        try:
            flags = mod.resolve_tester_flags(cfg)
            return flags, mod.assign_roles(size, master_freq, *flags, mode)
        except ValueError as exc:
            return "ValueError", str(exc)

    assert outcome(bicnn_launch) == outcome(jax_launch)


@pytest.mark.parametrize("name", BiCNNTrainer.KNOWN_OPTS)
def test_server_rule_for_every_name(name):
    assert BiCNNTrainer.KNOWN_OPTS == JaxTrainer.KNOWN_OPTS
    cfg = dict(optimization=name)
    port = server_rule_for(BICNN_DEFAULTS.merged(cfg))
    ref = jax_server_rule_for(JAX_DEFAULTS.merged(cfg))
    for attr, default in (("__name__", None), ("keywords", {})):
        assert (getattr(getattr(port.apply, "func", port.apply), attr, default)
                == getattr(getattr(ref.apply, "func", ref.apply), attr, default))
    assert getattr(port.apply, "keywords", {}) == getattr(ref.apply, "keywords", {})
    if name == "adam":
        assert port.apply.keywords["step_div"] == 72


# -- gangs --------------------------------------------------------------------


def _threads(size, target):
    results, errors = {}, {}

    def run(rank):
        try:
            results[rank] = target(rank)
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors[rank] = exc

    threads = [threading.Thread(target=run, args=(r,), daemon=True) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return results


@pytest.mark.parametrize("opt", ["downpour", "adam"])
def test_port_workers_against_jax_servers_match_the_jax_gang(jdata, tdata, opt,
                                                             monkeypatch):
    """np=3: servers on ranks 0 and 2 (the JAX package's), the one worker on
    rank 1 (the port's, then the JAX package's), over a JAX router."""
    common = dict(TINY, np=3, optimization=opt, valid_mode="none", epoch=2,
                  learning_rate=0.05)
    jcfg = jax_launch.BICNN_LAUNCH_DEFAULTS.merged(common)
    tcfg = bicnn_launch.BICNN_LAUNCH_DEFAULTS.merged(common, device="cpu")
    servers = {}

    class RecordingServer(jax_launch.ParamServer):
        def start(self):
            servers[self.rank] = self
            super().start()

    monkeypatch.setattr(jax_launch, "ParamServer", RecordingServer)
    params = _jax_params(*(lambda t: (t.flat, t.w))(JaxTrainer(jcfg, data=jdata)))
    real = tbicnn.flatten_module

    def from_jax(module, seed, device="cpu"):
        spec = real(module, seed, device)
        return FlatModel(spec.module, spec.from_jax_params(params).to(device))

    monkeypatch.setattr(tbicnn, "flatten_module", from_jax)
    runs = {}
    for name, port_worker in (("jax", False), ("mixed", True)):
        router = JaxRouter(3)
        servers.clear()

        def target(rank):
            if rank == 1 and port_worker:
                return bicnn_launch.run_rank(rank, 3, tcfg, router.endpoint(rank), tdata)
            return jax_launch.run_rank(rank, 3, jcfg, router.endpoint(rank), jdata)

        res = _threads(3, target)
        runs[name] = (res, {r: np.asarray(s.param) for r, s in servers.items()})
    (ref, ref_shards), (got, got_shards) = runs["jax"], runs["mixed"]
    assert [got[r]["role"] for r in range(3)] == ["server", "worker", "server"]
    np.testing.assert_allclose([h["avg_loss"] for h in got[1]["history"]],
                               [h["avg_loss"] for h in ref[1]["history"]], rtol=RTOL, atol=ATOL)
    for r in (0, 2):
        assert got[r]["grads_applied"] == ref[r]["grads_applied"] == 24
        np.testing.assert_allclose(got_shards[r], ref_shards[r], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("opt", BiCNNTrainer.KNOWN_OPTS)
def test_every_optimization_trains_in_a_port_gang(tdata, opt):
    """Each of the 14 names in a port gang on the CPU (threads over the
    port's router): ``sgd`` alone (``--np 1``), the rest at np=4 (servers
    on ranks 0 and 2), one epoch; the ``*single`` names make mirrors of
    the servers."""
    size = 1 if opt == "sgd" else 4
    cfg = bicnn_launch.BICNN_LAUNCH_DEFAULTS.merged(
        TINY, np=size, optimization=opt, valid_mode="none", epoch=1, device="cpu",
        momentum=0.9 if opt in ("sgd", "eamsgd") else 0.0)
    router = LocalRouter(size)
    res = _threads(size, lambda r: bicnn_launch.run_rank(
        r, size, cfg, router.endpoint(r) if size > 1 else None, tdata))
    roles = [res[r]["role"] for r in range(size)]
    assert roles == (["local"] if size == 1 else ["server", "worker", "server", "worker"])
    for r in res.values():
        if r["role"] in ("local", "worker"):
            assert r["steps"] == 12 and np.isfinite(r["history"][0]["avg_loss"])
            assert set(r["accuracy"]) == {"valid", "test1", "test2"}
        if r["role"] == "server" and not opt.endswith("single"):
            # A mirror (the *single names) takes whole vectors: no GRAD.
            assert r["grads_applied"] > 0 and r["params_served"] > 0


def test_process_gang_with_a_tester(corpus, tmp_path):
    """``bicnn_launch --np 4 --device cpu`` with the tester first: every rank
    a process over shm; the tester's checkpoint loads in the JAX
    ``load_flat`` at the model's flat size."""
    files = [a for k, p in corpus.items() for a in (f"--{k}", str(p))]
    tiny = [a for k, v in TINY.items() for a in (f"--{k}", str(v))]
    res = bicnn_launch.main(
        ["--np", "4", "--device", "cpu", "--optimization", "eamsgd", "--epoch", "1",
         "--testerfirst", "true", "--valid_mode", "additionalTester",
         "--tester_rounds", "2", "--valid_sleep_time", "0.1",
         "--outputprefix", str(tmp_path / "ck"), *files, *tiny])
    assert {r: v["role"] for r, v in res.items()} == {
        0: "tester", 1: "worker", 2: "server", 3: "worker"}
    assert all(v["platform"] == "cpu" for v in res.values())
    assert all(v["launches"] == {"k1": 0, "k2": 0, "k3": 0} for v in res.values())
    assert len(res[0]["history"]) == 2 and res[1]["steps"] == res[3]["steps"] == 12
    w, meta = jax_load_flat(tmp_path / "ck_latest.npz")
    size = BiCNNTrainer(BICNN_DEFAULTS.merged(TINY, device="cpu", optimization="sgd",
                                              **{k: str(p) for k, p in corpus.items()})
                        ).flat.size
    assert w.shape == (size,) and np.isfinite(w).all() and meta["epoch"] == 1
