"""Tensor, pipeline and expert parallelism of the port against the JAX
package's, on the CPU.

The JAX side runs on its 8-virtual-device CPU mesh (``tests/conftest.py``);
the port holds the same 8 ranks as virtual ranks of one device.  The same
numpy inputs, drawn from a seed, go through both, at the JAX tests' own
tolerances (``tests/test_tp_pp_ep.py``: atol 2e-5 forward, 5e-5 grads).
Each of its seven tests has a twin here, plus the head-parallel
attention's backward against ``jax.grad``, a pipeline of two
``DecoderBlock``s carried from the JAX ``TinyDecoder``'s flax parameters by
the flat converter, and a router tie in ``ep_moe``.

The attention twin runs at a head width of 8, not the JAX test's 2: the
port's ``tp_self_attention`` attends through ``flash_attention``, whose
kernels take a head width that is a multiple of 8 (on the CPU its wrappers
run their plain twins, the same function as the JAX body's
``attention_reference``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from mpit_tpu.models.transformer import DecoderBlock as JaxBlock
from mpit_tpu.models.transformer import TinyDecoder as JaxDecoder
from mpit_tpu.models.transformer import default_attn as jax_default_attn
from mpit_tpu.parallel import ep_moe as jax_ep_moe
from mpit_tpu.parallel import moe_reference as jax_moe_reference
from mpit_tpu.parallel import pipeline as jax_pipeline
from mpit_tpu.parallel import stack_stage_params as jax_stack
from mpit_tpu.parallel import tp_mlp as jax_tp_mlp
from mpit_tpu.parallel import tp_self_attention as jax_tp_attention
from mpit_tpu.utils.platform import default_devices
from mpit_tpu_torch.models.flat import FlatModel, param_spec
from mpit_tpu_torch.models.transformer import DecoderBlock, TinyDecoder
from mpit_tpu_torch.ops.flash_attention import attention_reference
from mpit_tpu_torch.parallel import (
    Mesh,
    ep_moe,
    moe_reference,
    pipeline,
    stack_stage_params,
    tp_mlp,
    tp_self_attention,
)
from mpit_tpu_torch.parallel.tensor_parallel import gelu

torch.set_num_threads(1)

FWD_ATOL, GRAD_ATOL = 2e-5, 5e-5
N = 8  # ranks, as the JAX tests' mesh


def _jax_mesh(axis, n=N):
    return JaxMesh(np.array(default_devices()[:n]), (axis,))


def _arr(rng, *shape):
    return (rng.normal(size=shape) * 0.3).astype(np.float32)


def _t(*arrays, grad=False):
    out = tuple(torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays)
    return out if len(out) > 1 else out[0]


def _close(got, want, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, err_msg=what)


def _dense_mlp(x, w1, b1, w2, b2):
    return torch.matmul(gelu(torch.matmul(x, w1) + b1), w2) + b2


class TestTensorParallel:
    def test_mlp_matches_dense(self, rng):
        d, h = 16, 64  # h divisible by 8
        args = (_arr(rng, 4, 10, d), _arr(rng, d, h), _arr(rng, h), _arr(rng, h, d),
                _arr(rng, d))
        want = jax.jit(jax_tp_mlp(_jax_mesh("tp")))(*(jnp.asarray(a) for a in args))
        got = tp_mlp(Mesh("cpu", tp=N))(*_t(*args))
        _close(got, want, FWD_ATOL)
        _close(_dense_mlp(*_t(*args)), want, FWD_ATOL, "the dense MLP")

    def test_mlp_grads(self, rng):
        d, h = 8, 32
        args = (_arr(rng, 2, 6, d), _arr(rng, d, h), _arr(rng, h), _arr(rng, h, d),
                _arr(rng, d))
        f = jax_tp_mlp(_jax_mesh("tp"))
        want = jax.grad(lambda *a: jnp.sum(f(*a) ** 2), argnums=(1, 3))(
            *(jnp.asarray(a) for a in args))
        ts = _t(*args, grad=True)
        (tp_mlp(Mesh("cpu", tp=N))(*ts) ** 2).sum().backward()
        for got, w, name in zip((ts[1].grad, ts[3].grad), want, ("w1", "w2")):
            _close(got, w, GRAD_ATOL, name)

    def _attention_inputs(self, rng):
        b, length, d, heads = 2, 12, 64, 8  # head width 8: the kernels' least
        return (_arr(rng, b, length, d), _arr(rng, d, 3, heads, d // heads),
                _arr(rng, heads, d // heads, d))

    def test_attention_matches_dense(self, rng):
        x, wqkv, wo = self._attention_inputs(rng)
        want = jax.jit(jax_tp_attention(_jax_mesh("tp"), causal=True))(
            jnp.asarray(x), jnp.asarray(wqkv), jnp.asarray(wo))
        got = tp_self_attention(Mesh("cpu", tp=N), causal=True)(*_t(x, wqkv, wo))
        _close(got, want, FWD_ATOL)
        # and the unsplit heads, as the JAX test's dense oracle
        tx, twqkv, two = _t(x, wqkv, wo)
        qkv = torch.einsum("bld,dthk->tbhlk", tx, twqkv)
        heads = attention_reference(qkv[0], qkv[1], qkv[2], causal=True)
        _close(torch.einsum("bhlk,hkd->bld", heads, two), want, FWD_ATOL, "dense")

    def test_attention_grads_match_jax(self, rng):
        x, wqkv, wo = self._attention_inputs(rng)
        f = jax_tp_attention(_jax_mesh("tp"), causal=True)
        want = jax.grad(lambda *a: jnp.sum(f(*a) ** 2), argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(wqkv), jnp.asarray(wo))
        ts = _t(x, wqkv, wo, grad=True)
        (tp_self_attention(Mesh("cpu", tp=N), causal=True)(*ts) ** 2).sum().backward()
        for t, w, name in zip(ts, want, ("x", "wqkv", "wo")):
            _close(t.grad, w, GRAD_ATOL, name)

    def test_attention_stacks_every_rank_in_one_kernel_call(self, rng, monkeypatch):
        """One ``flash_attention`` call a ``tp_self_attention`` call, its
        leading axes ``(n, B, H/n)`` contiguous: on the card one K4 launch
        forward (and one K5) serves every rank; never ``attention_reference``."""
        import importlib

        tp_mod = importlib.import_module("mpit_tpu_torch.parallel.tensor_parallel")
        fa_mod = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
        calls = {"fa": [], "fwd": 0, "bwd": 0}
        real_fa, real_fwd = tp_mod.flash_attention, fa_mod.flash_fwd
        real_bwd = fa_mod.flash_bwd_fused

        def fa(q, k, v, **kw):
            calls["fa"].append((tuple(q.shape), q.is_contiguous()))
            return real_fa(q, k, v, **kw)

        def fwd(*a, **kw):
            calls["fwd"] += 1
            return real_fwd(*a, **kw)

        def bwd(*a, **kw):
            calls["bwd"] += 1
            return real_bwd(*a, **kw)

        monkeypatch.setattr(tp_mod, "flash_attention", fa)
        monkeypatch.setattr(fa_mod, "flash_fwd", fwd)
        monkeypatch.setattr(fa_mod, "flash_bwd_fused", bwd)
        monkeypatch.setattr(fa_mod, "attention_reference", None)  # must not be reached
        x, wqkv, wo = self._attention_inputs(rng)
        ts = _t(x, wqkv, wo, grad=True)
        tp_self_attention(Mesh("cpu", tp=N), causal=True)(*ts).sum().backward()
        assert calls == {"fa": [((N, 2, 1, 12, 8), True)], "fwd": 1, "bwd": 1}

    def test_attention_takes_the_kernels_head_widths(self, rng):
        """The JAX test's head width 2 is one the kernels refuse."""
        x = torch.zeros(2, 12, 16)
        with pytest.raises(ValueError, match="multiple of 8"):
            tp_self_attention(Mesh("cpu", tp=N))(x, torch.zeros(16, 3, 8, 2),
                                                 torch.zeros(8, 2, 16))
        with pytest.raises(ValueError, match="not divisible by the 8 ranks"):
            tp_mlp(Mesh("cpu", tp=N))(x, torch.zeros(16, 12), torch.zeros(12),
                                      torch.zeros(12, 16), torch.zeros(16))


class TestPipeline:
    @staticmethod
    def _jax_stage(params, x):
        return jnp.tanh(x @ params["w"] + params["b"])

    @staticmethod
    def _stage(params, x):
        return torch.tanh(x @ params["w"] + params["b"])

    def _stages(self, rng, n, d):
        return [{"w": _arr(rng, d, d), "b": _arr(rng, d)} for _ in range(n)]

    def test_matches_sequential(self, rng):
        n, d, m, b = N, 12, 5, 4
        stages = self._stages(rng, n, d)
        xs = _arr(rng, m, b, d)
        want = jax.jit(jax_pipeline(_jax_mesh("pp"), self._jax_stage))(
            jax_stack([jax.tree_util.tree_map(jnp.asarray, s) for s in stages]),
            jnp.asarray(xs))
        port_stages = [{k: _t(v) for k, v in s.items()} for s in stages]
        got = pipeline(Mesh("cpu", pp=n), self._stage)(stack_stage_params(port_stages),
                                                        _t(xs))
        _close(got, want, FWD_ATOL)
        refs = []
        for x in _t(xs):  # microbatch by microbatch, stage by stage
            for p in port_stages:
                x = self._stage(p, x)
            refs.append(x)
        assert torch.equal(got, torch.stack(refs))  # the same calls on the same inputs

    def test_backprop_through_pipe(self, rng):
        n, d, m, b = N, 8, 4, 2
        stages = self._stages(rng, n, d)
        xs = _arr(rng, m, b, d)
        pipe = jax_pipeline(_jax_mesh("pp"), self._jax_stage)
        jstacked = jax_stack([jax.tree_util.tree_map(jnp.asarray, s) for s in stages])
        want = jax.grad(lambda st: jnp.sum(pipe(st, jnp.asarray(xs)) ** 2))(jstacked)
        stacked = {k: v.requires_grad_() for k, v in
                   stack_stage_params([{k: _t(v) for k, v in s.items()} for s in stages]
                                      ).items()}
        (pipeline(Mesh("cpu", pp=n), self._stage)(stacked, _t(xs)) ** 2).sum().backward()
        for key in ("w", "b"):
            _close(stacked[key].grad, want[key], GRAD_ATOL, key)

    def test_bubble_cells_are_skipped(self, rng):
        """``n * m`` stage calls, each stage on each microbatch once, in the
        schedule's order: the fill and drain cells are never called."""
        n, d, m, b = 4, 6, 3, 2
        stages = [{k: _t(v) for k, v in s.items()} for s in self._stages(rng, n, d)]
        stacked = stack_stage_params(stages)
        seen = []

        def stage(params, x):
            i = next(j for j, s in enumerate(stages) if torch.equal(s["w"], params["w"]))
            seen.append(i)
            return self._stage(params, x)

        pipeline(Mesh("cpu", pp=n), stage)(stacked, _t(_arr(rng, m, b, d)))
        want = [i for t in range(m + n - 1) for i in range(n) if 0 <= t - i < m]
        assert seen == want and len(seen) == n * m

    def test_decoder_blocks_match_jax(self, rng):
        """Two ``DecoderBlock``s of a JAX ``TinyDecoder`` as two stages:
        its flax parameters carried into the port by the flat converter,
        each block's dict stacked; the forward and the blocks' gradients
        against the JAX pipeline of the same blocks (plain attention on the
        JAX side, the kernels' twins on the port's)."""
        d, heads, length, m, b = 32, 4, 16, 3, 2
        jdec = JaxDecoder(vocab=16, d_model=d, n_heads=heads, n_layers=2, max_len=length)
        jparams = jdec.init(jax.random.PRNGKey(5), jnp.zeros((1, length), jnp.int32))["params"]
        jblock = JaxBlock(d, heads, attn_fn=jax_default_attn(use_flash=False))

        def jstage(p, x):
            return jblock.apply({"params": p}, x)

        xs = _arr(rng, m, b, length, d)
        pipe = jax_pipeline(_jax_mesh("pp", 2), jstage)
        jstacked = jax_stack([jparams["DecoderBlock_0"], jparams["DecoderBlock_1"]])
        want_out = pipe(jstacked, jnp.asarray(xs))
        # the mean, not the sum: the blocks' gradients of a sum of squares
        # over 3,072 outputs reach ~100, where f32's ulp is ~1e-5
        want_grads = jax.grad(lambda st: jnp.mean(pipe(st, jnp.asarray(xs)) ** 2))(jstacked)

        module = TinyDecoder(vocab=16, d_model=d, n_heads=heads, n_layers=2, max_len=length)
        flat = FlatModel(module, torch.zeros(sum(int(np.prod(s)) for _, s in
                                                 param_spec(module))))
        views = flat.unravel(flat.from_jax_params(
            jax.tree_util.tree_map(np.asarray, jparams)))
        blocks = [{name[len(f"DecoderBlock_{i}."):]: t.clone() for name, t in views.items()
                   if name.startswith(f"DecoderBlock_{i}.")} for i in range(2)]
        stacked = {k: v.requires_grad_() for k, v in stack_stage_params(blocks).items()}
        block = DecoderBlock(d, heads)

        def stage(p, x):
            return torch.func.functional_call(block, p, (x,))

        got = pipeline(Mesh("cpu", pp=2), stage)(stacked, _t(xs))
        _close(got, want_out, FWD_ATOL, "out")
        (got ** 2).mean().backward()
        for name, g in stacked.items():
            node = want_grads
            for key in name.split("."):
                node = node[key]
            _close(g.grad, node, GRAD_ATOL, name)


class TestMoE:
    def _inputs(self, rng, e, d, h, lead):
        return (_arr(rng, *lead, d), _arr(rng, d, e), _arr(rng, e, d, h), _arr(rng, e, h),
                _arr(rng, e, h, d), _arr(rng, e, d))

    def test_matches_reference(self, rng):
        args = self._inputs(rng, 16, 8, 16, (3, 7))
        jargs = [jnp.asarray(a) for a in args]
        want = jax.jit(jax_ep_moe(_jax_mesh("ep")))(*jargs)
        got = ep_moe(Mesh("cpu", ep=N))(*_t(*args))
        _close(got, want, FWD_ATOL)
        _close(moe_reference(*_t(*args)), jax_moe_reference(*jargs), FWD_ATOL, "reference")
        _close(moe_reference(*_t(*args)), got, FWD_ATOL, "port reference")

    def test_router_grads_flow(self, rng):
        x, gate, w1, b1, w2, b2 = self._inputs(rng, 8, 8, 8, (2, 5))
        f = jax_ep_moe(_jax_mesh("ep"))
        jx, jb1, jw2, jb2 = (jnp.asarray(a) for a in (x, b1, w2, b2))
        want = jax.grad(lambda g, w: jnp.sum(f(jx, g, w, jb1, jw2, jb2) ** 2),
                        argnums=(0, 1))(jnp.asarray(gate), jnp.asarray(w1))
        tg, tw1 = _t(gate, w1, grad=True)
        (ep_moe(Mesh("cpu", ep=N))(_t(x), tg, tw1, *_t(b1, w2, b2)) ** 2).sum().backward()
        _close(tg.grad, want[0], GRAD_ATOL, "gate")
        _close(tw1.grad, want[1], GRAD_ATOL, "w1")
        assert float(tg.grad.abs().max()) > 0  # the combine weight's path

    def test_router_tie_routes_to_the_first_expert(self, rng):
        """Two equal gate columns score every token alike for experts 2 and
        5 (on different ranks); where those lead, both packages pick expert
        2, the first maximum."""
        x, gate, w1, b1, w2, b2 = self._inputs(rng, 8, 8, 8, (4, 6))
        gate[:, 5] = gate[:, 2]
        gate[:, 2] += 2.0 * np.abs(gate).max()  # make the pair lead somewhere
        gate[:, 5] = gate[:, 2]
        scores = x.reshape(-1, 8) @ gate
        lead = scores.argmax(-1)
        assert (lead == 2).any()
        jargs = [jnp.asarray(a) for a in (x, gate, w1, b1, w2, b2)]
        want = jax.jit(jax_ep_moe(_jax_mesh("ep")))(*jargs)
        got = ep_moe(Mesh("cpu", ep=N))(*_t(x, gate, w1, b1, w2, b2))
        _close(got, want, FWD_ATOL)
        # expert 2's output, never expert 5's
        tokens = torch.from_numpy(x.reshape(-1, 8))
        y2 = (gelu(tokens @ torch.from_numpy(w1[2]) + torch.from_numpy(b1[2]))
              @ torch.from_numpy(w2[2]) + torch.from_numpy(b2[2]))
        probs = torch.softmax(tokens @ torch.from_numpy(gate), -1)
        tie = torch.from_numpy(lead == 2)
        _close((y2 * probs[:, 2:3])[tie], got.reshape(-1, 8)[tie].detach().numpy(), FWD_ATOL)
