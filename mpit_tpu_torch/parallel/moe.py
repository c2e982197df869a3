"""Expert parallelism on the one-card stand-in mesh: a Switch-style top-1
MoE layer over an ``ep`` axis — the port of ``mpit_tpu/parallel/moe.py``.

- The experts' MLP weights are stacked on a leading expert axis and cut
  over the ``ep`` ranks, ``E/n`` experts a rank (virtual ranks of one card
  here, :mod:`mpit_tpu_torch.parallel.mesh`).
- Routing is **dense dispatch**, as in the reference: every rank runs all
  tokens through its local experts and masks by the router's one-hot
  choice; the ranks combine with one
  :func:`mpit_tpu_torch.parallel.collective.psum`.  No sort and no ragged
  all-to-all.
- Top-1 routing with the Switch combine (the chosen expert's output times
  its softmax probability) keeps the router differentiable.

``argmax`` takes the first maximum in both packages, so a tie routes
alike.  No Pallas kernel lies on this path: every op is a plain PyTorch
one, and the products run all ranks' local experts as one batched product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mpit_tpu_torch.parallel.collective import psum
from mpit_tpu_torch.parallel.mesh import Mesh
from mpit_tpu_torch.parallel.tensor_parallel import Act, gelu


def _route(x, gate_w):
    """The router: the softmax over ``E`` experts, each token's chosen
    expert (the first maximum) and its probability, the combine weight."""
    probs = torch.softmax(torch.einsum("...d,de->...e", x, gate_w), dim=-1)
    choice = torch.argmax(probs, dim=-1)
    combine = torch.gather(probs, -1, choice[..., None])[..., 0]
    return choice, combine


def _experts(x, w1, b1, w2, b2, activation):
    """Every token through every expert of the leading axes of ``w1 (...,
    d, h)``: ``(..., tokens, d)`` outputs, ``x (tokens, d)``."""
    h = activation(torch.matmul(x, w1) + b1[..., None, :])
    return torch.matmul(h, w2) + b2[..., None, :]


def ep_moe(mesh: Mesh, axis: str = "ep", activation: Act = gelu):
    """Build ``fn(x, gate_w, w1, b1, w2, b2) -> y``.

    ``x (..., d)``; ``gate_w (d, E)``; expert weights stacked ``w1 (E, d,
    h)``, ``b1 (E, h)``, ``w2 (E, h, d)``, ``b2 (E, d)``, ``E`` divisible
    by the axis's ranks.  The output is shaped like ``x``."""
    mesh.local_only(axis, "ep_moe")
    n = mesh.size(axis)
    reduce = psum(mesh, axis)

    def fn(x, gate_w, w1, b1, w2, b2):
        for name, t in (("x", x), ("gate_w", gate_w), ("w1", w1), ("b1", b1),
                        ("w2", w2), ("b2", b2)):
            mesh.check_device(t, name)
        e, d, h = w1.shape
        if e % n:
            raise ValueError(f"{e} experts not divisible by the {n} ranks of axis {axis!r}")
        el = e // n
        lead = x.shape[:-1]
        tokens = x.reshape(-1, d)
        choice, combine = _route(tokens, gate_w)
        # Each rank's mask over its own experts: (n, tokens, E/n).
        local_ids = torch.arange(e, device=x.device).reshape(n, 1, el)
        dispatch = (choice[None, :, None] == local_ids).to(x.dtype)
        y_exp = _experts(tokens, w1.reshape(n, el, d, h), b1.reshape(n, el, h),
                         w2.reshape(n, el, h, d), b2.reshape(n, el, d), activation)
        y_local = torch.einsum("nte,netd->ntd", dispatch, y_exp)
        y = reduce(y_local) * combine[:, None]
        return y.reshape(*lead, d)

    return fn


def moe_reference(x, gate_w, w1, b1, w2, b2, activation: Act = gelu):
    """Unsharded top-1 MoE with the same routing: the test oracle."""
    e, d, _ = w1.shape
    tokens = x.reshape(-1, d)
    choice, combine = _route(tokens, gate_w)
    y_exp = _experts(tokens, w1, b1, w2, b2, activation)
    onehot = F.one_hot(choice, e).to(x.dtype)
    y = torch.einsum("te,etd->td", onehot, y_exp) * combine[:, None]
    return y.reshape(*x.shape[:-1], d)
