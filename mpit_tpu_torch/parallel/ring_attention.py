"""Sequence-parallel ring attention over the port's meshes — the port of
``mpit_tpu/parallel/ring_attention.py``.

The sequence axis of ``(B, L, H, D)`` activations is cut over the ``n``
virtual ranks of a mesh axis (``sp``, :func:`mpit_tpu_torch.parallel.mesh.
sp_mesh`): every rank holds one chunk of the sequence and all heads, and
the ranks' chunks are stacked on the card, the rank axis first.  In each
of the ``n`` ring steps every rank computes the blockwise attention of its
Q chunk against the KV chunk in hand, masked by **global** positions
through the q and kv offsets, and then the KV stack moves one hop by
:func:`mpit_tpu_torch.parallel.collective.ring_shift` (one device copy
inside a process; where the axis spans processes, a boundary block a
stack sent to the next process).  The per-step unnormalized partials
``(acc, m, l)`` merge by the online-softmax combine
(:func:`mpit_tpu_torch.ops.flash_attention.merge_partials`), so the result
is exactly full attention.

Two implementations, as in the reference:

- ``"plain"`` (the reference's ``jnp``): each pair is
  :func:`~mpit_tpu_torch.ops.flash_attention.block_attention_partial`, and
  autograd differentiates the whole ring;
- ``"flash"`` (the reference's ``pallas``): an ``autograd.Function`` whose
  forward runs the ring over K4's partial mode
  (:func:`~mpit_tpu_torch.ops.flash_attention.flash_attention_partial`) and
  keeps ``(out, lse)``, and whose backward is a second ring over the pair
  backward (:func:`~mpit_tpu_torch.ops.flash_attention.
  flash_attention_bwd_pair`: K5 or K6, as the gate decides for the pair's
  shape) with ``delta`` from the float32 ``do * o``.  The (dk, dv)
  accumulators ride the KV rotation in float32 and one last hop brings them
  home; dq sums locally; each is cast once.  No ``(C, C)`` matrix is held.
  On a CUDA tensor every pair launches a kernel and nothing falls back to
  the plain ring; on the CPU the kernels' wrappers run their plain twins.

``"auto"`` picks ``"flash"`` for CUDA tensors and ``"plain"`` on the CPU.

Two layouts of a causal ring.  ``contiguous``: rank ``r`` holds chunk
``r``, and every rank computes all ``n`` pairs, the wholly masked ones
included (``n**2`` pairs a pass, as the reference computes them).
``zigzag``: the sequence is cut in ``2n`` half-chunks and rank ``r`` holds
half-chunks ``r`` and ``2n-1-r``, which balances the causal work.  Of the
four (q half, kv half) pairs of a step, (late q, early kv) is always live,
(early q, early kv) live where ``rank >= owner`` and (late q, late kv)
where ``owner >= rank`` (the reference's ``lax.cond`` branches, taken or
not), and (early q, late kv) never: ``n(2n+1)`` pairs a pass.  The rank
stack is ``(n, h, B, H, c, D)`` with ``h`` half-chunks of ``c`` positions a
rank (``h`` 1 for contiguous, 2 for zigzag), so every pair's operands are
contiguous blocks, as the kernels take them.

Skipping a dead zigzag pair leaves the bits as the reference's merge of
its zero partial would (``merge_partials`` leaves the live side as it is
where the other has ``m = -inf``), and so does starting each rank's merge
from its first partial rather than from a zero partial.

The reference's Pallas and XLA levers ``block_q``, ``block_k``,
``interpret`` and ``precision`` have no counterpart: the kernels' tiles
are fixed by their sources, and products are float32 as
:func:`mpit_tpu_torch.utils.platform.pin_float32` sets them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from mpit_tpu_torch.ops.flash_attention import (
    _lse_of,
    block_attention_partial,
    finalize_partials,
    flash_attention_bwd_pair,
    flash_attention_partial,
    merge_partials,
)
from mpit_tpu_torch.parallel.collective import gather, ring_shift
from mpit_tpu_torch.parallel.mesh import Mesh, sp_mesh

__all__ = ["ring_attention", "sp_mesh", "zigzag_order", "zigzag_permute",
           "zigzag_unpermute", "ring_pairs"]

IMPLS = ("auto", "plain", "flash")
LAYOUTS = ("contiguous", "zigzag")


def zigzag_order(n: int) -> List[int]:
    """Global half-chunk ids in rank order for the zigzag layout: rank ``d``
    owns half-chunks ``(d, 2n-1-d)``."""
    order = []
    for d in range(n):
        order.extend([d, 2 * n - 1 - d])
    return order


def _inverse(order: List[int]) -> List[int]:
    inv = [0] * len(order)
    for pos, g in enumerate(order):
        inv[g] = pos
    return inv


def _chunk_index(x: torch.Tensor, n: int, axis: int, order: List[int]) -> torch.Tensor:
    length = x.shape[axis]
    if length % (2 * n):
        raise ValueError(f"sequence length {length} not divisible by 2n={2 * n}")
    c = length // (2 * n)
    idx = torch.cat([torch.arange(g * c, (g + 1) * c) for g in order])
    return x.index_select(axis, idx.to(x.device))


def zigzag_permute(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Reorder a sequence axis of ``2n`` equal chunks into the zigzag rank
    layout (inverse: :func:`zigzag_unpermute`)."""
    return _chunk_index(x, n, axis, zigzag_order(n))


def zigzag_unpermute(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    return _chunk_index(x, n, axis, _inverse(zigzag_order(n)))


def ring_pairs(n: int, layout: str) -> int:
    """Pairs a pass of the ring computes: ``n**2`` contiguous, ``n(2n+1)``
    zigzag (the launches of K4's partial mode in the forward, and of the
    pair backward in the backward, of the flash ring)."""
    return n * n if layout == "contiguous" else n * (2 * n + 1)


class _Ring:
    """One ring's geometry: ``n`` ranks, this process's range ``[lo, hi)``
    of them (all of them in one process), the layout's half-chunks, the
    mask and the scale, and the rank axis's hop.  Ranks and owners are
    global; the stacks hold this process's ranks, row ``rank - lo``."""

    def __init__(self, mesh: Mesh, axis: str, layout: str, causal: bool,
                 sm_scale: Optional[float]):
        self.n = mesh.size(axis)
        self.lo, self.hi = mesh.box[axis]
        self.h = 2 if layout == "zigzag" else 1
        self.causal, self.sm_scale = causal, sm_scale
        self.shift = ring_shift(mesh, axis)

    def offset(self, rank: int, half: int, c: int) -> int:
        """Global position of half-chunk ``half`` of ``rank``'s chunk."""
        if self.h == 1:
            return rank * c
        return (rank if half == 0 else 2 * self.n - 1 - rank) * c

    def live(self, rank: int, owner: int) -> Tuple[Tuple[int, int], ...]:
        """The (q half, kv half) pairs ``rank`` computes against ``owner``'s
        KV chunk, in the reference's merge order."""
        if self.h == 1:
            return ((0, 0),)
        pairs = [(1, 0)]
        if rank >= owner:
            pairs.append((0, 0))
        if owner >= rank:
            pairs.append((1, 1))
        return tuple(pairs)

    def steps(self):
        """``(s, rank, owner, i)`` over the ring, this process's ranks:
        after ``s`` hops ``rank`` (row ``i`` of the stacks) holds the KV
        chunk of ``owner = rank - s``."""
        for s in range(self.n):
            for i, rank in enumerate(range(self.lo, self.hi)):
                yield s, rank, (rank - s) % self.n, i

    def forward(self, q, k, v, partial_fn):
        """The forward ring over ``(local n, h, *lead, c, D)`` stacks:
        ``partial_fn(q, k, v, q_offset, kv_offset) -> (acc, m, l)``.
        Returns the output stack in q's dtype and the float32 row lse."""
        c = q.shape[-2]
        parts = {}
        kb, vb = k, v
        for s, rank, owner, i in self.steps():
            if s and i == 0:
                kb, vb = self.shift(kb, vb)
            for qi, ki in self.live(rank, owner):
                part = partial_fn(q[i, qi], kb[i, ki], vb[i, ki],
                                  self.offset(rank, qi, c), self.offset(owner, ki, c))
                key = (i, qi)
                parts[key] = merge_partials(parts[key], part) if key in parts else part
        keys = [(i, qi) for i in range(self.hi - self.lo) for qi in range(self.h)]
        out = torch.stack([finalize_partials(parts[key][0], parts[key][2], q.dtype)
                           for key in keys])
        lse = torch.stack([_lse_of(parts[key][1], parts[key][2]) for key in keys])
        shape = (self.hi - self.lo, self.h)
        return out.view(*shape, *out.shape[1:]), lse.view(*shape, *lse.shape[1:])

    def backward(self, q, k, v, do, o, lse, pair_bwd):
        """The backward ring: ``pair_bwd(q, k, v, do, lse, delta, q_offset,
        kv_offset) -> (dq, dk, dv)`` for each pair the forward computed.
        (dk, dv) ride the KV rotation in float32 and one last hop brings
        them home; dq sums in place; each is cast once."""
        c = q.shape[-2]
        delta = (do.float() * o.float()).sum(-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kb, vb = k, v
        for s, rank, owner, i in self.steps():
            if s and i == 0:
                kb, vb, dk, dv = self.shift(kb, vb, dk, dv)
            for qi, ki in self.live(rank, owner):
                dqi, dki, dvi = pair_bwd(q[i, qi], kb[i, ki], vb[i, ki],
                                         do[i, qi], lse[i, qi], delta[i, qi],
                                         self.offset(rank, qi, c),
                                         self.offset(owner, ki, c))
                dq[i, qi] += dqi.float()
                dk[i, ki] += dki.float()
                dv[i, ki] += dvi.float()
        dk, dv = self.shift(dk, dv)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

    def partial(self, impl: str) -> Callable:
        fn = block_attention_partial if impl == "plain" else flash_attention_partial

        def partial_fn(q, k, v, q_offset, kv_offset):
            return fn(q, k, v, causal=self.causal, sm_scale=self.sm_scale,
                      q_offset=q_offset, kv_offset=kv_offset)

        return partial_fn

    def pair_bwd(self, q, k, v, do, lse, delta, q_offset, kv_offset):
        return flash_attention_bwd_pair(q, k, v, do, lse, delta=delta, causal=self.causal,
                                        sm_scale=self.sm_scale, q_offset=q_offset,
                                        kv_offset=kv_offset)


class _TakeLocal(torch.autograd.Function):
    """This process's rows of the whole ``(n, ...)`` q, k and v stacks; the
    gradients' rows come back all-gathered over the ring's line, so the
    layers before attention see the whole sequence's."""

    @staticmethod
    def forward(ctx, mesh, axis, *stacks):
        ctx.gather = gather(mesh, axis)
        rows = mesh.local_slice(axis)
        return tuple(t[rows] for t in stacks)

    @staticmethod
    def backward(ctx, *grads):
        whole = ctx.gather(torch.stack(grads, 1))  # one all-gather for the three
        return (None, None, *whole.unbind(1))


class _GatherOut(torch.autograd.Function):
    """Every process's output rows, all-gathered over the ring's line; the
    cotangent of the gathered output is the same in every process of the
    line (each computes the dense backward after attention), so each
    takes its own rows."""

    @staticmethod
    def forward(ctx, mesh, axis, out):
        ctx.rows = mesh.local_slice(axis)
        return gather(mesh, axis)(out)

    @staticmethod
    def backward(ctx, g):
        return None, None, g[ctx.rows]


class _FlashRing(torch.autograd.Function):
    """The flash ring: K4's partial mode forward (keeping ``out`` and
    ``lse``), the pair backward ring."""

    @staticmethod
    def forward(ctx, q, k, v, ring):
        out, lse = ring.forward(q, k, v, ring.partial("flash"))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = ring
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.ring.backward(q, k, v, g.to(q.dtype).contiguous(), o, lse,
                                       ctx.ring.pair_bwd)
        return dq, dk, dv, None


def ring_attention(
    mesh: Mesh,
    axis: str = "sp",
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    impl: str = "auto",
    layout: str = "contiguous",
    permute_inputs: bool = True,
    batch_axis: Optional[str] = None,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Build the sequence-parallel attention fn over ``mesh[axis]``.

    The fn takes and returns ``(B, L, H, D)`` tensors on the mesh's device,
    L cut evenly over the axis's ranks.  ``impl``: ``"plain"``,
    ``"flash"``, or ``"auto"`` (flash on a CUDA tensor, plain on the CPU).

    ``layout="zigzag"`` (causal only) balances the causal work over the
    ring.  With ``permute_inputs`` (default) the fn takes and returns
    natural sequence order; with ``permute_inputs=False`` it takes and
    returns the zigzag order of :func:`zigzag_permute`.

    ``batch_axis``: B cut over another axis of the mesh as well (the ``dp
    x sp`` composition), each data parallel group running a ring of its
    own.  The groups' rings are independent and alike, so on one card
    their rows ride the leading batch axis of the same ring: the launches
    a pass stay :func:`ring_pairs`, however many groups.  B (this
    process's rows) must divide evenly over this process's ranks of that
    axis.

    Where ``axis`` spans processes, q, k and v arrive whole, as in the JAX
    package, and each process computes the pairs of its own ranks only
    (``ring_pairs / P`` of them a pass for ``P`` processes of one rank
    each), by global rank and owner; the KV blocks, and in the backward
    the float32 (dk, dv) accumulators, take the hop between processes
    (:class:`~mpit_tpu_torch.parallel.collective.RingHop`); the output
    rows are all-gathered over the ring's line, and so are the q, k and v
    gradients' rows, so the layers before and after attention see the
    whole sequence, the same bits in every process of the line."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be auto|plain|flash, got {impl!r}")
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be contiguous|zigzag, got {layout!r}")
    if layout == "zigzag" and not causal:
        raise ValueError(
            "layout='zigzag' requires causal=True (the static block-"
            "liveness it exploits is the causal structure)"
        )
    groups = 1
    if batch_axis is not None:
        if batch_axis == axis:
            raise ValueError(f"batch_axis {batch_axis!r} is the ring's own axis")
        groups = mesh.local_size(batch_axis)
    ring = _Ring(mesh, axis, layout, bool(causal),
                 None if sm_scale is None else float(sm_scale))
    spans = mesh.spans(axis)
    n, h = ring.n, ring.h
    order = zigzag_order(n) if layout == "zigzag" and permute_inputs else None
    inverse = _inverse(order) if order is not None else None

    def to_ranks(x: torch.Tensor, c: int) -> torch.Tensor:
        # (B, L, H, D) -> (n, h, B, H, c, D), each (rank, half) block contiguous.
        b, _, heads, d = x.shape
        x = x.reshape(b, n * h, c, heads, d)
        if order is not None:
            x = x[:, order]
        return x.reshape(b, n, h, c, heads, d).permute(1, 2, 0, 4, 3, 5).contiguous()

    def from_ranks(y: torch.Tensor) -> torch.Tensor:
        _, _, b, heads, c, d = y.shape
        y = y.permute(2, 0, 1, 4, 3, 5).reshape(b, n * h, c, heads, d)
        if inverse is not None:
            y = y[:, inverse]
        return y.reshape(b, n * h * c, heads, d)

    def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        for name, t in (("q", q), ("k", k), ("v", v)):
            mesh.check_device(t, name)
            if t.dim() != 4 or t.shape != q.shape:
                raise ValueError(f"q, k and v must be (B, L, H, D) of one shape, got "
                                 f"{name} {tuple(t.shape)}, q {tuple(q.shape)}")
        b, length, heads, d = q.shape
        if b % groups:
            raise ValueError(f"batch {b} not divisible by the {groups} ranks of axis "
                             f"{batch_axis!r}")
        if length % n:
            raise ValueError(f"sequence length {length} not divisible by the {n} ranks "
                             f"of axis {axis!r}")
        chunk = length // n
        if h == 2 and chunk % 2:
            raise ValueError(
                f"zigzag layout needs an even per-rank chunk, got {chunk} "
                f"(global L must divide evenly by 2n={2 * n})")
        qs, ks, vs = (to_ranks(t, chunk // h) for t in (q, k, v))
        if spans:
            qs, ks, vs = _TakeLocal.apply(mesh, axis, qs, ks, vs)
        use = impl if impl != "auto" else ("flash" if q.device.type == "cuda" else "plain")
        if use == "flash":
            out = _FlashRing.apply(qs, ks, vs, ring)
        else:
            out, _ = ring.forward(qs, ks, vs, ring.partial("plain"))
        if spans:
            out = _GatherOut.apply(mesh, axis, out)
        return from_ranks(out)

    return attend
