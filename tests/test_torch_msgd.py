"""msgd of the PyTorch port against :mod:`mpit_tpu.optim.msgd`.

Both run five steps of ``msgd_step`` from the same start on the same
quadratic, whose gradient each package computes in f32 from numpy inputs,
with the momentum ramp, lr decay and L2 on; the JAX side commits through
its Pallas kernel (interpret mode, ``use_fused=True``).  Tolerance: the
reference's own for its fused updates, rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.optim.msgd import MSGDConfig as JaxCfg
from mpit_tpu.optim.msgd import msgd_init as jax_init
from mpit_tpu.optim.msgd import msgd_step as jax_step
from mpit_tpu_torch.optim.msgd import MSGD, MSGDConfig, msgd_commit, msgd_init, msgd_step

# One intra-op thread: the suite runs several test processes side by side
# on the CPU, and these tensors are small.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N = 300


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    target = rng.normal(size=N).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=N).astype(np.float32)
    w0 = rng.normal(size=N).astype(np.float32)
    return target, scale, w0


def _jax_vgf(target, scale):
    t, a = jnp.asarray(target), jnp.asarray(scale)

    def vgf(w):
        d = w - t
        return 0.5 * jnp.sum(a * d * d), a * d

    return vgf


def _torch_vgf(target, scale):
    t, a = torch.from_numpy(target), torch.from_numpy(scale)

    def vgf(w):
        d = w - t
        return 0.5 * torch.sum(a * d * d), a * d

    return vgf


HYPER = [
    dict(lr=0.05, mom=0.9, momdecay=2.0, mommax=0.95, lrd=0.1, lrp=0.75, l2wd=1e-3),
    dict(lr=0.05, mom=0.9),
    dict(lr=0.05, l2wd=1e-2),  # no momentum: the plain commit, no kernel
]


@pytest.mark.parametrize("hp", HYPER)
def test_five_steps_match_jax(hp):
    target, scale, w0 = _problem()
    jcfg = JaxCfg(use_fused=True, **hp)
    jstep = jax.jit(lambda w, s: jax_step(_jax_vgf(target, scale), w, s, jcfg))
    jw, js = jnp.asarray(w0), jax_init(jnp.asarray(w0))

    tcfg = MSGDConfig(**hp)
    tw = torch.from_numpy(w0.copy())
    ts = msgd_init(tw)
    vgf = _torch_vgf(target, scale)
    for _ in range(5):
        jw, js, jl = jstep(jw, js)
        tw, ts, tl = msgd_step(vgf, tw, ts, tcfg)
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts["vt"].numpy(), np.asarray(js["vt"]), rtol=RTOL, atol=ATOL)
    assert int(ts["k"]) == int(js["k"]) == 5
    assert ts["k"].dtype == torch.int32


@pytest.mark.parametrize("mom", [0.9, 0.0])
def test_commit_retract_follows_the_update(mom):
    """``msgd_commit(sug=...)`` on worker rows is the commit without it and
    then ``w -= sug``: with momentum inside K1's one sweep, without it as a
    second subtraction.  Each operation rounds alone either way: bit
    equality."""
    rng = np.random.default_rng(5)
    w0, g, sug = (torch.from_numpy(rng.normal(size=(3, N)).astype(np.float32))
                  for _ in range(3))
    cfg = MSGDConfig(lr=0.05, mom=mom, l2wd=1e-3, lrd=0.1, lrp=0.5)

    def state():
        return {"k": torch.tensor([0, 4, 9], dtype=torch.int32),
                "vt": torch.from_numpy(rng.normal(size=(3, N)).astype(np.float32))}

    sa = state()
    sb = {k: v.clone() for k, v in sa.items()}
    wa, sa = msgd_commit(w0.clone(), g, sa, cfg, sug=sug)
    wb, sb = msgd_commit(w0.clone(), g, sb, cfg)
    assert torch.equal(wa, wb - sug)
    assert torch.equal(sa["vt"], sb["vt"])
    assert sa["k"].tolist() == [1, 5, 10]


def test_msgd_object_updates_in_place():
    target, scale, w0 = _problem(1)
    opt = MSGD(MSGDConfig(lr=0.1, mom=0.5), _torch_vgf(target, scale))
    w = torch.from_numpy(w0.copy())
    losses = []
    for _ in range(20):
        w_out, loss = opt.step(w, )
        assert w_out is w
        losses.append(float(loss))
    assert losses[-1] < 0.1 * losses[0]
