"""Kernels of the PyTorch port on a CUDA card, against their plain twins.

Every test here carries the ``cuda`` marker and skips without a card: a
CUDA kernel has no CPU mode.  The file imports neither JAX nor the JAX
package, so it also runs on a machine with PyTorch and the card alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which that machine may
not have.)  K1 must be bit-equal to its twin: both round every operation,
and the kernel is built with ``-fmad=false``.
"""

import pytest
import torch

from mpit_tpu_torch.ops import fused_nesterov_commit, fused_nesterov_commit_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _operands(dev, rows, n, offset=0):
    """w, vt, g, sug of shape (rows, n); ``offset`` floats into a larger
    buffer, so ``offset % 4 != 0`` gives pointers that are not 16-byte
    aligned (the kernel's scalar loop)."""
    gen = torch.Generator(device=dev).manual_seed(rows * 7919 + n + offset)
    out = []
    for _ in range(4):
        buf = torch.randn(offset + rows * n, device=dev, generator=gen)
        out.append(buf[offset:].view(rows, n))
    return out


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("n", [1, 3, 1025, 544522])
@pytest.mark.parametrize("offset", [0, 1])
def test_k1_bit_equal_to_twin(dev, rows, n, offset):
    w, vt, g, sug = _operands(dev, rows, n, offset)
    clr = torch.linspace(0.01, 0.04, rows, device=dev)
    for l2wd in (0.0, 1e-4):
        for s in (None, sug):
            want_w, want_vt = fused_nesterov_commit_reference(w, vt, g, clr, l2wd=l2wd, sug=s)
            kw, kvt = w.clone(), vt.clone()
            before = fused_nesterov_commit.launches
            fused_nesterov_commit(kw, kvt, g, clr, l2wd=l2wd, sug=s)
            torch.cuda.synchronize()
            assert fused_nesterov_commit.launches == before + 1
            assert torch.equal(kw, want_w) and torch.equal(kvt, want_vt)


def test_k1_one_dimensional_form(dev):
    w, vt, g, sug = (t[0] for t in _operands(dev, 1, 10250))
    clr = torch.tensor(0.05, device=dev)
    want_w, want_vt = fused_nesterov_commit_reference(w, vt, g, clr, l2wd=1e-3, sug=sug)
    fused_nesterov_commit(w, vt, g, clr, l2wd=1e-3, sug=sug)
    torch.cuda.synchronize()
    assert torch.equal(w, want_w) and torch.equal(vt, want_vt)


def test_k1_refuses_mixed_devices(dev):
    w, vt, g, _ = _operands(dev, 2, 64)
    with pytest.raises(ValueError):
        fused_nesterov_commit(w, vt, g.cpu(), torch.zeros(2, device=dev))
