"""K1 (fused Nesterov commit) of the PyTorch port against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX Pallas
kernel (interpret mode, as tests/test_ops.py runs it), the JAX plain
reference and the port's plain twin.  The CPU wrapper of the port must
equal its twin bit for bit (it is the twin, in place).  The kernel itself
runs only on a CUDA card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.ops import fused_nesterov_commit as jax_commit
from mpit_tpu.ops import fused_nesterov_commit_reference as jax_reference
from mpit_tpu_torch.ops import fused_nesterov_commit, fused_nesterov_commit_reference

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
