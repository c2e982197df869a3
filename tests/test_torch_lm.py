"""The port's long-context LM (TinyDecoder, ``train/lm_launch.py``) against
the JAX package, on the CPU.

- The model: ``TinyDecoder`` from one flax ``w0`` (``from_jax_params``),
  log-probs and flat grads against flax's, with flash attention (the
  port's twins; JAX's Pallas kernels in interpret mode) and with the plain
  reference.  Tolerance 2e-5 for both, the reference's flash forward
  tolerance: the two sides differ by f32 summation order and by
  LayerNorm's variance formula (flax: mean(x^2) - mean^2; PyTorch: a
  centred sum).
- The flat layout: ``param_spec`` is ``ravel_pytree``'s order and shapes,
  ``DecoderBlock_10`` before ``DecoderBlock_2``; the parameter counts at
  the launcher's defaults and at the long-context widths, by
  ``jax.eval_shape`` and on PyTorch's meta device.
- The data: ``_corpus`` byte-identical for the synthetic stream and for a
  ``--text_file``.
- The slice: ``lm_launch.run`` at dp = sp = 1, and at ``--sp 4`` (ring
  attention over four virtual ranks, zigzag and contiguous) against JAX's
  at dp 1, sp 4 on four CPU devices, from the same ``w0``; per-step losses
  within rtol 2e-4 / atol 2e-5, the JAX package's own tolerance for one
  trajectory across attention schedules (tests/test_lm_launch.py).  Equal
  losses step after step also show that both drew the same batches.  The
  port's ``sp`` 1, 2 and 4 in both layouts agree with each other under the
  same tolerance (the twin of the JAX package's factorization test), and
  a JAX checkpoint written at ``sp`` 4 resumes in the port at ``sp`` 4.
- Guards: a layout or a group that cannot form raises before any
  rendezvous; the default device is the card.
"""

import functools
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import mpit_tpu_torch.train.lm_launch as tlm
from mpit_tpu.models.transformer import TinyDecoder as JaxTinyDecoder
from mpit_tpu.models.transformer import default_attn as jax_default_attn
from mpit_tpu.train.lm_launch import LM_LAUNCH_DEFAULTS as JAX_LM_DEFAULTS
from mpit_tpu.train.lm_launch import _corpus as jax_corpus
from mpit_tpu.train.lm_launch import run as jax_lm_run
from mpit_tpu.utils.config import Config as JaxConfig
from mpit_tpu_torch.models.flat import FlatModel, param_spec
from mpit_tpu_torch.models.transformer import TinyDecoder, default_attn
from mpit_tpu_torch.utils.logging import get_logger

# One intra-op thread: the suite runs several test processes side by side
# on the CPU, and these tensors are small.
torch.set_num_threads(1)

MODEL_ATOL = 2e-5
LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5
TINY = dict(seq_len=256, d_model=32, n_heads=4, n_layers=1, batch=8,
            attn_dtype="float32", steps=6, log_every=1, lr=1e-3)


def _jax_model(use_flash, **kw):
    return JaxTinyDecoder(attn_fn=jax_default_attn(causal=True, use_flash=use_flash),
                          **kw)


def _jax_params(seed, batch, **kw):
    model = _jax_model(False, **kw)
    sample = jnp.zeros((batch, kw["max_len"]), jnp.int32)
    return jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(seed), sample)["params"])


@pytest.mark.parametrize("use_flash", [True, False])
def test_tiny_decoder_matches_flax(use_flash):
    widths = dict(vocab=256, d_model=32, n_heads=4, n_layers=2, max_len=16)
    params = _jax_params(0, 2, **widths)
    toks = np.random.default_rng(3).integers(0, 256, (2, 17)).astype(np.int32)
    jmodel = _jax_model(use_flash, **widths)
    w0, unravel = ravel_pytree(params)

    def jax_loss(w):
        logp = jmodel.apply({"params": unravel(w)}, jnp.asarray(toks[:, :-1]))
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(toks[:, 1:, None]), -1))

    jlogp = jmodel.apply({"params": params}, jnp.asarray(toks[:, :-1]))
    jgrad = jax.grad(jax_loss)(w0)

    module = TinyDecoder(attn_fn=default_attn(causal=True, use_flash=use_flash), **widths)
    spec = FlatModel(module, torch.zeros(sum(math.prod(s) for _, s in param_spec(module))))
    flat = FlatModel(module, spec.from_jax_params(params))
    np.testing.assert_array_equal(flat.w0.numpy(), np.asarray(w0))
    w = flat.w0.clone().requires_grad_()
    t = torch.from_numpy(toks).long()
    logp = flat.apply_flat(w, t[:, :-1])
    loss = -torch.take_along_dim(logp, t[:, 1:, None], dim=-1).mean()
    loss.backward()
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(jlogp), atol=MODEL_ATOL)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jgrad), atol=MODEL_ATOL)
    back = flat.to_jax_params(flat.w0)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, params))


def _jax_spec(params):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out.append((".".join(p.key for p in path), tuple(leaf.shape)))
    return out


def test_param_spec_is_ravel_pytree_order():
    """Eleven layers: sorted keys put DecoderBlock_10 before _2."""
    widths = dict(vocab=256, d_model=8, n_heads=2, n_layers=11, max_len=4)
    shapes = jax.eval_shape(_jax_model(False, **widths).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))["params"]
    spec = param_spec(TinyDecoder(**widths))
    assert spec == _jax_spec(shapes)
    assert [n.split(".")[0] for n, _ in spec].index("DecoderBlock_10") < \
        [n.split(".")[0] for n, _ in spec].index("DecoderBlock_2")


@pytest.mark.parametrize("widths, count", [
    (dict(d_model=256, n_heads=8, n_layers=2, max_len=1024), 1_971_200),
    (dict(d_model=1024, n_heads=8, n_layers=4, max_len=8192), 59_283_456),
])
def test_parameter_counts(widths, count):
    shapes = jax.eval_shape(_jax_model(False, vocab=256, **widths).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, widths["max_len"]), jnp.int32))["params"]
    assert sum(math.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes)) == count
    with torch.device("meta"):
        module = TinyDecoder(vocab=256, **widths)
    assert param_spec(module) == _jax_spec(shapes)
    assert sum(math.prod(s) for _, s in param_spec(module)) == count


def test_corpus_is_byte_identical(tmp_path):
    log = get_logger("test", 0)
    base = dict(seq_len=64, batch=4)
    synth = tlm._corpus(tlm.LM_LAUNCH_DEFAULTS.merged(base), log)
    want = jax_corpus(JaxConfig(**JAX_LM_DEFAULTS.merged(base).to_dict()), log)
    assert synth.dtype == want.dtype and np.array_equal(synth, want)
    text = tmp_path / "corpus.txt"
    text.write_bytes(bytes(np.random.default_rng(5).integers(0, 256, 5000, np.uint8)))
    base["text_file"] = str(text)
    got = tlm._corpus(tlm.LM_LAUNCH_DEFAULTS.merged(base), log)
    want = jax_corpus(JAX_LM_DEFAULTS.merged(base), log)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="corpus"):
        tlm._corpus(tlm.LM_LAUNCH_DEFAULTS.merged(base, batch=100), log)


def _jax_lm(monkeypatch, devices, **kw):
    """The JAX ``lm_launch.run`` at TINY on ``devices`` CPU mesh devices."""
    monkeypatch.setenv("MPIT_MESH_DEVICES", str(devices))
    return jax_lm_run(JAX_LM_DEFAULTS.merged(TINY, compile_cache=0, **kw))


def _port_lm_from_jax_w0(monkeypatch, **kw):
    """The port's ``lm_launch.run`` at TINY on the CPU from the flax ``w0``
    the JAX run draws."""
    params = _jax_params(1, 1, vocab=256, d_model=TINY["d_model"],
                         n_heads=TINY["n_heads"], n_layers=TINY["n_layers"],
                         max_len=TINY["seq_len"])
    real = tlm.flatten_module

    def from_jax(module, seed, device="cpu"):
        spec = real(module, seed, device)
        return FlatModel(spec.module, spec.from_jax_params(params).to(device))

    monkeypatch.setattr(tlm, "flatten_module", from_jax)
    return tlm.run(tlm.LM_LAUNCH_DEFAULTS.merged(TINY, device="cpu", **kw))


def _assert_same_losses(port, ref):
    got = [h["avg_loss"] for h in port["history"]]
    want = [h["avg_loss"] for h in ref["history"]]
    assert [h["step"] for h in port["history"]] == [h["step"] for h in ref["history"]]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_lm_launch_matches_jax(monkeypatch):
    ref = _jax_lm(monkeypatch, 1)
    assert ref["mesh"] == {"dp": 1, "sp": 1}
    port = _port_lm_from_jax_w0(monkeypatch)
    _assert_same_losses(port, ref)
    assert set(ref) <= set(port)
    assert port["params"] == ref["params"]
    assert port["tokens_trained"] == ref["tokens_trained"] == 6 * 8 * 256
    assert port["device"] == "cpu" and port["state"]["w"].shape == (port["params"],)
    assert int(port["state"]["k"]) == 6


@pytest.mark.parametrize("layout", ["zigzag", "contiguous"])
def test_lm_launch_sp4_matches_jax(monkeypatch, layout):
    """``--sp 4``: the port's ring over four virtual ranks of one device
    against the JAX ring over four CPU devices, dp 1."""
    ref = _jax_lm(monkeypatch, 4, dp=1, sp=4, layout=layout)
    assert ref["mesh"] == {"dp": 1, "sp": 4}
    port = _port_lm_from_jax_w0(monkeypatch, sp=4, layout=layout)
    assert port["mesh"] == {"dp": 1, "sp": 4}
    _assert_same_losses(port, ref)
    assert int(port["state"]["k"]) == 6


@functools.lru_cache(maxsize=1)
def _sp1_run():
    return tlm.run(tlm.LM_LAUNCH_DEFAULTS.merged(TINY, device="cpu", steps=4, seq_len=128))


@pytest.mark.parametrize("sp, layout", [(2, "contiguous"), (2, "zigzag"),
                                        (4, "contiguous"), (4, "zigzag")])
def test_sp_and_layouts_agree(sp, layout):
    """Same seed, same batches: the trajectory at ``--sp 2`` and ``4``, in
    either layout, is the one at ``sp 1``: the ring is exact attention."""
    res = tlm.run(tlm.LM_LAUNCH_DEFAULTS.merged(TINY, device="cpu", steps=4, seq_len=128,
                                                sp=sp, layout=layout))
    assert res["mesh"] == {"dp": 1, "sp": sp}
    _assert_same_losses(res, _sp1_run())


def test_jax_sp4_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    """A checkpoint the JAX package writes at ``sp 4`` (flat ``w``, ``vt``,
    ``k``: sp-agnostic) resumes in the port at ``sp 4`` on the JAX
    continuation's trajectory."""
    kw = dict(dp=1, sp=4, layout="contiguous", log_every=1)
    _jax_lm(monkeypatch, 4, steps=3, ckpt_every=3, ckpt_dir=str(tmp_path / "jax"), **kw)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    ref = _jax_lm(monkeypatch, 4, steps=6, resume="auto", ckpt_dir=str(tmp_path / "jax"),
                  **kw)
    port = tlm.run(tlm.LM_LAUNCH_DEFAULTS.merged(
        TINY, device="cpu", steps=6, resume="auto", ckpt_dir=str(tmp_path / "port"), **kw))
    assert [h["step"] for h in port["history"]] == [3, 4, 5]
    _assert_same_losses(port, ref)
    assert int(port["state"]["k"]) == 6


def test_cli_runs_on_the_cpu(capsys):
    res = tlm.main(["--device", "cpu", "--seq_len", "64", "--d_model", "32",
                    "--n_heads", "4", "--n_layers", "1", "--steps", "4",
                    "--attn_dtype", "float32", "--log_every", "3"])
    assert [h["step"] for h in res["history"]] == [2, 3]
    assert all(np.isfinite(h["avg_loss"]) for h in res["history"])
    assert '"tokens_per_sec"' in capsys.readouterr().out


@pytest.mark.parametrize("flags, owner", [
    (dict(coordinator="localhost:1", num_processes=2, process_id=0, dp=3, sp=2, batch=6),
     (ValueError, "not a box")),
    (dict(hostfile="{tmp}/hosts", process_id=1, dp=3, batch=6),
     (ValueError, "dp=3 does not split over 2 processes")),
    (dict(num_processes=2), (ValueError, "process_id required")),
    (dict(coordinator="localhost:1", num_processes=2, process_id=5),
     (ValueError, "out of range")),
    (dict(ckpt_dir="{tmp}", resume="auto"), (FileNotFoundError, "lm_latest")),
    (dict(resume="auto"), (ValueError, "requires --ckpt_dir")),
])
def test_refuses_later_slices(flags, owner, tmp_path):
    """Before any rendezvous, a group of two processes whose blocks of the
    ``(dp, sp)`` grid are not boxes raises a ValueError naming the block,
    and so does one whose ``dp`` they do not divide; the group's flags are
    checked as the JAX package checks them; a resume with nothing to
    resume raises (an empty ``--ckpt_dir``, or no ``--ckpt_dir`` for
    ``auto``)."""
    exc, owner = owner
    (tmp_path / "hosts").write_text("alpha\nbeta\n")
    flags = {k: v.format(tmp=tmp_path) if isinstance(v, str) else v
             for k, v in flags.items()}
    with pytest.raises(exc, match=owner):
        tlm.run(tlm.LM_LAUNCH_DEFAULTS.merged(flags, device="cpu", seq_len=64,
                                              d_model=16, n_heads=2, n_layers=1))


def test_default_device_is_the_card():
    assert tlm.LM_LAUNCH_DEFAULTS.device == "cuda"
    with pytest.raises(ValueError, match="attn_dtype"):
        tlm.run(tlm.LM_LAUNCH_DEFAULTS.merged(attn_dtype="float16", device="cpu"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.run(tlm.LM_LAUNCH_DEFAULTS.merged(steps=1))


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("flags", [dict(process_id=0),
                                   dict(num_processes=1, coordinator="localhost:{port}")])
def test_group_of_one_runs(flags):
    """The multi-host flags naming a group of one form it (gloo on the
    CPU), train, and take it down."""
    flags = {k: v.format(port=_free_port()) if isinstance(v, str) else v
             for k, v in flags.items()}
    res = tlm.run(tlm.LM_LAUNCH_DEFAULTS.merged(flags, device="cpu", seq_len=64, d_model=16,
                                                n_heads=2, n_layers=1, steps=2, batch=2,
                                                attn_dtype="float32"))
    assert res["processes"] == 1 and np.isfinite(res["final_loss"])
    assert not torch.distributed.is_initialized()


def _lm_limits_hold(port, ref, w0, ref_state):
    """``LM_LIMITS["float32"]`` of ``chip_smoke.py``: w and vt within 1e-6
    of the other run's, their gap's norm within 1e-3 of the change's, and
    the per-step losses within 1e-5 relative."""
    got = [h["avg_loss"] for h in port["history"]]
    want = [h["avg_loss"] for h in ref["history"]]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    for key in ("w", "vt"):
        a, b = port["state"][key].numpy(), np.asarray(ref_state[key])
        change = b - (w0 if key == "w" else 0.0)
        assert np.abs(a - b).max() <= 1e-6, key
        assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(change), key


def test_lm_launch_dp2_sp4_matches_jax(monkeypatch, tmp_path):
    """``--dp 2 --sp 4``: the port's ``dp x sp`` virtual ranks against the
    JAX package's ``dp=2, sp=4`` mesh of eight CPU devices, from one w0,
    within ``LM_LIMITS["float32"]`` (the JAX run's final w and vt read back
    from its checkpoint)."""
    from mpit_tpu_torch.utils.checkpoint import load_state_dict

    kw = dict(dp=2, sp=4, layout="zigzag")
    ref = _jax_lm(monkeypatch, 8, ckpt_dir=str(tmp_path), ckpt_every=TINY["steps"], **kw)
    assert ref["mesh"] == {"dp": 2, "sp": 4}
    port = _port_lm_from_jax_w0(monkeypatch, **kw)
    assert port["mesh"] == {"dp": 2, "sp": 4}
    ref_state, _ = load_state_dict(str(tmp_path / "lm_latest.npz"))
    w0 = ravel_pytree(_jax_params(1, 1, vocab=256, d_model=TINY["d_model"],
                                  n_heads=TINY["n_heads"], n_layers=TINY["n_layers"],
                                  max_len=TINY["seq_len"]))[0]
    _lm_limits_hold(port, ref, np.asarray(w0), ref_state)
    assert int(port["state"]["k"]) == int(ref_state["k"]) == TINY["steps"]


def _factor_run(dp, sp, layout, **kw):
    kw = dict(dict(steps=4), **kw)
    return tlm.run(tlm.LM_LAUNCH_DEFAULTS.merged(TINY, device="cpu", seq_len=128, dp=dp,
                                                 sp=sp, layout=layout, **kw))


@pytest.mark.parametrize("dp, sp, layout", [(8, 1, "contiguous"), (2, 4, "contiguous"),
                                            (2, 4, "zigzag"), (4, 2, "zigzag")])
def test_dp_and_sp_factorizations_agree(dp, sp, layout):
    """The twin of the JAX package's factorization test: however the
    batch and the sequence are cut, the trajectory is sp 1's (the ring is
    exact attention and the loss a global-batch mean); and ``dp`` changes
    no bit of ``--dp 1`` at the same ``sp``, layout and batch: its groups'
    rows ride the same launches."""
    res = _factor_run(dp, sp, layout)
    assert res["mesh"] == {"dp": dp, "sp": sp}
    _assert_same_losses(res, _sp1_run())
    one = _factor_run(1, sp, layout)
    assert [h["avg_loss"] for h in res["history"]] == [h["avg_loss"] for h in one["history"]]
    for key in ("w", "vt", "k"):
        assert torch.equal(res["state"][key], one["state"][key]), key


def test_learns_on_synthetic_bytes():
    """The JAX test's run at ``dp=2, sp=4``: 40 steps at lr 3e-3, and the
    loss falls."""
    res = tlm.run(tlm.LM_LAUNCH_DEFAULTS.merged(TINY, device="cpu", steps=40, lr=3e-3,
                                                log_every=10, dp=2, sp=4,
                                                layout="contiguous"))
    losses = [h["avg_loss"] for h in res["history"]]
    assert all(np.isfinite(x) for x in losses)
    assert losses[-1] < losses[0] - 0.05, losses
    assert res["mesh"] == {"dp": 2, "sp": 4}


def test_resume_at_dp2_continues_bit_for_bit(tmp_path):
    """A ``--dp 2 --sp 4`` run stopped at step 3 and resumed to 6 ends on
    the straight run's bits, and its last steps' losses are the straight
    run's; resuming it at another batch raises, as in the JAX package."""
    straight = _factor_run(2, 4, "zigzag", steps=6)
    _factor_run(2, 4, "zigzag", steps=3, ckpt_dir=str(tmp_path), ckpt_every=3)
    resumed = _factor_run(2, 4, "zigzag", steps=6, ckpt_dir=str(tmp_path), resume="auto")
    assert [h["step"] for h in resumed["history"]] == [3, 4, 5]
    assert resumed["history"] == straight["history"][3:]
    for key in ("w", "vt", "k"):
        assert torch.equal(resumed["state"][key], straight["state"][key]), key
    with pytest.raises(ValueError, match="batch"):
        _factor_run(2, 4, "zigzag", steps=8, batch=16, ckpt_dir=str(tmp_path),
                    resume="auto")


def test_init_with_dp_not_dividing_local_rows():
    """``dp=4 sp=2 batch=8``: two rows a data parallel group, which dp does
    not divide (the JAX test's init-sample case)."""
    res = _factor_run(4, 2, "contiguous", steps=2)
    assert res["mesh"] == {"dp": 4, "sp": 2}
    assert np.isfinite(res["history"][-1]["avg_loss"])


@pytest.mark.parametrize("flags", [dict(dp=8, batch=9), dict(dp=3, sp=2, batch=8),
                                   dict(sp=3, seq_len=128)])
def test_bad_factorization_raises(flags):
    """The JAX package's ``batch % dp`` and ``seq_len % sp`` checks (its
    ``dp * sp == devices`` check has no counterpart on one card)."""
    with pytest.raises(ValueError, match="divisible"):
        tlm.run(tlm.LM_LAUNCH_DEFAULTS.merged(TINY, device="cpu", **flags))
