"""K1 (fused Nesterov commit), K2 (fused elastic) and K3 (fused Adam) of
the PyTorch port against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX Pallas
kernel (interpret mode, as tests/test_ops.py runs it), the JAX plain
reference and the port's plain twin.  The CPU wrapper of the port must
equal its twin bit for bit (it is the twin, in place).  The kernels
themselves run only on a CUDA card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.ops import fused_adam as jax_adam
from mpit_tpu.ops import fused_adam_reference as jax_adam_reference
from mpit_tpu.ops import fused_elastic as jax_elastic
from mpit_tpu.ops import fused_elastic_reference as jax_elastic_reference
from mpit_tpu.ops import fused_nesterov_commit as jax_commit
from mpit_tpu.ops import fused_nesterov_commit_reference as jax_reference
from mpit_tpu_torch.ops import (
    fused_adam,
    fused_adam_reference,
    fused_elastic,
    fused_elastic_reference,
    fused_nesterov_commit,
    fused_nesterov_commit_reference,
)

# One intra-op thread: the suite runs several test processes side by side
# on the CPU, and these tensors are small.
torch.set_num_threads(1)

# The reference's own tolerances for its fused updates (tests/test_ops.py).
RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("n", [1, 1025, 40000])
@pytest.mark.parametrize("l2wd", [0.0, 1e-4])
@pytest.mark.parametrize("with_sug", [False, True])
def test_twin_matches_jax_kernel_and_reference(n, l2wd, with_sug):
    w, vt, g, sug = _inputs(n, (n,))
    clr = np.float32(0.05)
    sug_j = jnp.asarray(sug) if with_sug else None
    jw, jvt = jax_commit(jnp.asarray(w), jnp.asarray(vt), jnp.asarray(g), clr,
                         l2wd=l2wd, sug=sug_j, interpret=True)
    rw, rvt = jax_reference(jnp.asarray(w), jnp.asarray(vt), jnp.asarray(g), clr,
                            l2wd=l2wd, sug=sug_j)
    tw, tvt = fused_nesterov_commit_reference(
        torch.from_numpy(w), torch.from_numpy(vt), torch.from_numpy(g),
        torch.tensor(clr), l2wd=l2wd,
        sug=torch.from_numpy(sug) if with_sug else None)
    for want_w, want_vt in ((jw, jvt), (rw, rvt)):
        np.testing.assert_allclose(tw.numpy(), np.asarray(want_w), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tvt.numpy(), np.asarray(want_vt), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_sug", [False, True])
def test_row_batched_matches_jax_per_row(with_sug):
    """(rows, n) with a distinct clr per row == the JAX kernel row by row."""
    rows, n = 3, 1025
    w, vt, g, sug = _inputs(7, (rows, n))
    clr = np.array([0.01, 0.02, 0.05], np.float32)
    tw, tvt = torch.from_numpy(w.copy()), torch.from_numpy(vt.copy())
    fused_nesterov_commit(tw, tvt, torch.from_numpy(g), torch.from_numpy(clr),
                          l2wd=1e-4, sug=torch.from_numpy(sug) if with_sug else None)
    for r in range(rows):
        jw, jvt = jax_commit(jnp.asarray(w[r]), jnp.asarray(vt[r]), jnp.asarray(g[r]),
                             clr[r], l2wd=1e-4,
                             sug=jnp.asarray(sug[r]) if with_sug else None,
                             interpret=True)
        np.testing.assert_allclose(tw[r].numpy(), np.asarray(jw), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tvt[r].numpy(), np.asarray(jvt), rtol=RTOL, atol=ATOL)


def test_cpu_wrapper_is_the_twin_in_place():
    w, vt, g, sug = _inputs(3, (2, 513))
    clr = torch.tensor([0.1, 0.3])
    tw, tvt = torch.from_numpy(w.copy()), torch.from_numpy(vt.copy())
    out = fused_nesterov_commit(tw, tvt, torch.from_numpy(g), clr, l2wd=1e-3,
                                sug=torch.from_numpy(sug))
    assert out[0] is tw and out[1] is tvt
    rw, rvt = fused_nesterov_commit_reference(
        torch.from_numpy(w), torch.from_numpy(vt), torch.from_numpy(g), clr,
        l2wd=1e-3, sug=torch.from_numpy(sug))
    assert torch.equal(tw, rw) and torch.equal(tvt, rvt)


@pytest.mark.parametrize("case", ["dtype", "shape", "clr_rows", "contiguous",
                                  "alias", "ndim", "clr_not_tensor"])
def test_wrapper_rejects_bad_operands(case):
    w, vt, g = (torch.zeros(2, 8) for _ in range(3))
    clr = torch.zeros(2)
    if case == "dtype":
        g = g.double()
    elif case == "shape":
        g = torch.zeros(2, 9)
    elif case == "clr_rows":
        clr = torch.zeros(3)
    elif case == "contiguous":
        w = torch.zeros(8, 2).t()
    elif case == "alias":
        vt = w
    elif case == "ndim":
        w, vt, g = (torch.zeros(1, 2, 8) for _ in range(3))
    elif case == "clr_not_tensor":
        clr = 0.1
    with pytest.raises((TypeError, ValueError)):
        fused_nesterov_commit(w, vt, g, clr)


# -- K2: fused elastic --------------------------------------------------------


@pytest.mark.parametrize("n", [1, 1027, 40000])
@pytest.mark.parametrize("mva", [0.15, 0.45])
def test_k2_twin_matches_jax_kernel_and_reference(n, mva):
    w, c, _, _ = _inputs(n + 11, (n,))
    jw, jsug = jax_elastic(jnp.asarray(w), jnp.asarray(c), mva, interpret=True)
    rw, rsug = jax_elastic_reference(jnp.asarray(w), jnp.asarray(c), mva)
    tw, tsug = fused_elastic_reference(torch.from_numpy(w), torch.from_numpy(c), mva)
    for want_w, want_sug in ((jw, jsug), (rw, rsug)):
        np.testing.assert_allclose(tw.numpy(), np.asarray(want_w), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tsug.numpy(), np.asarray(want_sug), rtol=RTOL, atol=ATOL)
    # One f32 rounding per operation on both sides: bit-equal to the plain
    # JAX reference.
    assert np.array_equal(tw.numpy(), np.asarray(rw))
    assert np.array_equal(tsug.numpy(), np.asarray(rsug))


def test_k2_cpu_wrapper_is_the_twin_in_place():
    w, c, _, _ = _inputs(5, (1029,))
    tw = torch.from_numpy(w.copy())
    out_w, sug = fused_elastic(tw, torch.from_numpy(c), 0.3)
    assert out_w is tw
    rw, rsug = fused_elastic_reference(torch.from_numpy(w), torch.from_numpy(c), 0.3)
    assert torch.equal(tw, rw) and torch.equal(sug, rsug)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [5, 1029])
def test_k2_cpu_wrapper_on_views_is_the_jax_reference(n, offset):
    """``w`` and the center as views ``offset`` floats into their buffers,
    as a card run gives the sweep a scalar head: ``w`` updated in place
    through the view, bit-equal to the JAX reference."""
    w, c, _, _ = _inputs(n + offset, (n,))
    tw = torch.zeros(offset + n)[offset:].copy_(torch.from_numpy(w))
    tc = torch.zeros(offset + n)[offset:].copy_(torch.from_numpy(c))
    got_w, sug = fused_elastic(tw, tc, 0.45)
    rw, rsug = jax_elastic_reference(jnp.asarray(w), jnp.asarray(c), 0.45)
    assert got_w is tw
    assert np.array_equal(tw.numpy(), np.asarray(rw))
    assert np.array_equal(sug.numpy(), np.asarray(rsug))


# -- K3: fused Adam -------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 1027, 40000])
@pytest.mark.parametrize("betas", [(0.9, 0.999), (0.8, 0.99)])
def test_k3_twin_matches_jax_kernel_and_reference(n, betas):
    beta1, beta2 = betas
    p, g, m, v = _inputs(n + 13, (n,))
    v = np.abs(v)
    for t in (1, 2, 3):  # three steps, each feeding the next
        lr_t = np.float32(1e-3 * np.sqrt(1 - beta2**t) / (1 - beta1**t))
        args = [jnp.asarray(a) for a in (p, g, m, v)]
        jout = jax_adam(*args, lr_t, beta1=beta1, beta2=beta2, interpret=True)
        rout = jax_adam_reference(*args, lr_t, beta1=beta1, beta2=beta2)
        tout = fused_adam_reference(*(torch.from_numpy(a) for a in (p, g, m, v)),
                                    torch.tensor(lr_t), beta1=beta1, beta2=beta2)
        for want in (jout, rout):
            for got, exp in zip(tout, want):
                np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                                           rtol=RTOL, atol=ATOL)
        p, m, v = (x.numpy() for x in tout)


def test_k3_cpu_wrapper_is_the_twin_in_place():
    p, g, m, v = _inputs(9, (1029,))
    v = np.abs(v)
    lr_t = torch.tensor(2e-3)
    tp, tm, tv = (torch.from_numpy(x.copy()) for x in (p, m, v))
    out = fused_adam(tp, torch.from_numpy(g), tm, tv, lr_t, beta1=0.8)
    assert out[0] is tp and out[1] is tm and out[2] is tv
    want = fused_adam_reference(*(torch.from_numpy(x) for x in (p, g, m, v)),
                                lr_t, beta1=0.8)
    assert all(torch.equal(a, b) for a, b in zip((tp, tm, tv), want))


def test_k3_constants_round_once_from_doubles():
    """1 - beta taken in double and rounded once, as the reference's
    weak-typed scalars are; f32 arithmetic gives other numbers."""
    g = torch.ones(1)
    _, m, v = fused_adam_reference(torch.zeros(1), g, torch.zeros(1), torch.zeros(1),
                                   torch.tensor(0.0))
    assert m.item() == np.float32(1 - 0.9) and v.item() == np.float32(1 - 0.999)
    assert np.float32(1) - np.float32(0.999) != np.float32(1 - 0.999)


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguous", "alias", "ndim",
                                  "lr_t_not_tensor", "lr_t_shape"])
def test_k2_k3_wrappers_reject_bad_operands(case):
    p, g, m, v = (torch.zeros(8) for _ in range(4))
    lr_t = torch.tensor(1e-3)
    if case == "dtype":
        g = g.double()
    elif case == "shape":
        g = torch.zeros(9)
    elif case == "contiguous":
        p = torch.zeros(16)[::2]
    elif case == "alias":
        m = p
    elif case == "ndim":
        p, g, m, v = (torch.zeros(2, 4) for _ in range(4))
    elif case == "lr_t_not_tensor":
        lr_t = 1e-3
    elif case == "lr_t_shape":
        lr_t = torch.zeros(2)
    with pytest.raises((TypeError, ValueError)):
        fused_adam(p, g, m, v, lr_t)
    if not case.startswith("lr_t"):
        with pytest.raises((TypeError, ValueError)):
            fused_elastic(p, g if case != "alias" else p, 0.5)
