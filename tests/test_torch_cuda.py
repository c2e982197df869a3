"""Kernels of the PyTorch port on a CUDA card, against their plain twins.

Every test here carries the ``cuda`` marker and skips without a card: a
CUDA kernel has no CPU mode.  The file imports neither JAX nor the JAX
package, so it also runs on a machine with PyTorch and the card alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which that machine may
not have.)  Each kernel must be bit-equal to its twin: both round every
operation, in the same order, and the kernels are built with
``-fmad=false``.  Shapes: the main path's (544,522 for K1 and K2; 272,261
and 544,522 for K3), odd lengths (the scalar tail), and views one float
into a buffer (pointers not 16-byte aligned: the scalar loop).
"""

import pytest
import torch

from mpit_tpu_torch.ops import (
    fused_adam,
    fused_adam_reference,
    fused_elastic,
    fused_elastic_reference,
    fused_nesterov_commit,
    fused_nesterov_commit_reference,
)

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


def _flat(dev, n, offset, count, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(offset + n, device=dev, generator=gen)[offset:]
            for _ in range(count)]


@pytest.mark.parametrize("n", [1, 3, 1027, 544522])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("mva", [0.45, 0.15])
def test_k2_bit_equal_to_twin(dev, n, offset, mva):
    w, c = _flat(dev, n, offset, 2, n + offset)
    want_w, want_sug = fused_elastic_reference(w, c, mva)
    kw = w.clone() if offset == 0 else torch.empty(offset + n, device=dev)[offset:].copy_(w)
    before = fused_elastic.launches
    out_w, sug = fused_elastic(kw, c, mva)
    torch.cuda.synchronize()
    assert fused_elastic.launches == before + 1
    assert out_w is kw
    assert torch.equal(kw, want_w) and torch.equal(sug, want_sug)


@pytest.mark.parametrize("n", [1, 3, 1027, 272261, 544522])
@pytest.mark.parametrize("offset", [0, 1])
def test_k3_bit_equal_to_twin(dev, n, offset):
    p, g, m, v = _flat(dev, n, offset, 4, 3 * n + offset)
    v.abs_()  # a second moment is never negative
    for t, (beta1, beta2) in enumerate(((0.9, 0.999), (0.8, 0.99)), start=1):
        lr_t = torch.tensor(1e-3 * (1 - beta2 ** t) ** 0.5 / (1 - beta1 ** t),
                            device=dev)
        want = fused_adam_reference(p, g, m, v, lr_t, beta1=beta1, beta2=beta2)
        kp, km, kv = (x.clone() for x in (p, m, v))
        before = fused_adam.launches
        fused_adam(kp, g, km, kv, lr_t, beta1=beta1, beta2=beta2)
        torch.cuda.synchronize()
        assert fused_adam.launches == before + 1
        for got, exp in zip((kp, km, kv), want):
            assert torch.equal(got, exp)


def test_k3_reads_lr_t_on_the_card(dev):
    p, g, m, v = _flat(dev, 4096, 0, 4, 7)
    v.abs_()
    lr_t = torch.tensor(2e-3, device=dev)
    want = fused_adam_reference(p, g, m, v, lr_t)
    lr_t_later = torch.tensor(0.0, device=dev)
    fused_adam(p, g, m, v, lr_t_later)
    # The kernel read the pointer's value at launch time, on the stream.
    lr_t_later.copy_(lr_t)
    torch.cuda.synchronize()
    assert not torch.equal(p, want[0])
    p2, g2, m2, v2 = _flat(dev, 4096, 0, 4, 7)
    v2.abs_()
    fused_adam(p2, g2, m2, v2, lr_t_later)
    torch.cuda.synchronize()
    assert torch.equal(p2, want[0])


def test_k2_k3_refuse_mixed_devices(dev):
    w, c = _flat(dev, 64, 0, 2, 1)
    with pytest.raises(ValueError):
        fused_elastic(w, c.cpu(), 0.5)
    p, g, m, v = _flat(dev, 64, 0, 4, 2)
    with pytest.raises(ValueError):
        fused_adam(p, g, m, v, torch.tensor(1e-3))
