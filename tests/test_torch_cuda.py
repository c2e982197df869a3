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
into a buffer (pointers not 16-byte aligned).  K1, K2 and K3 also at
lengths and offsets that reach every path of their sweep (16-byte chunks
in one or more turns of the grid, the scalar head and tail, the scalar
path alone) and replayed from a CUDA graph.  ``mesh_launch``'s device
loop, which replays K1 from captured graphs, trains bit for bit as its
host loop on the card.  Process gangs on the card count each kernel in the
process that launches it.

The flash-attention kernels (K4 forward in both output modes, K5 fused
backward, K6 two-kernel backward) sum in another order than their twins,
so they are held to tolerances: for float32 inputs the reference's own
(atol 2e-5 forward, 3e-5 backward, 3e-4 on a ragged, offset pair; the
partials ``acc`` and ``l``, sums of up to Lk terms, as ``acc / l`` and
``l`` to 1e-5 of itself).  For bfloat16 inputs ``m``, ``lse`` and ``l``
(float32 functions of float32 scores, rounded by neither side) keep those
limits; ``o``, ``acc`` and the grads depend on P and dS rounded to bf16
(K4 rounds P with its running max, the twin with the row's final max:
about 2**-9 of a row apart) and ``o`` and the grads are rounded to bf16
(one step, at most 2**-7 of an element).  Those are held row by row, over
the D elements of one row of one head: the gap's norm within 2**-6 of
the twin's row norm plus atol sqrt(D), each element within 2**-7 of
itself plus 2**-5 of its row's rms plus atol.  A lost tile moves a row
by far more than 2**-6 of it.

bfloat16 K4, K5 and K6 run on the tensor cores
(csrc/flash_attention_tc.cu), so their tiles get checks of their own,
tighter than the row rule, on inputs where kernel and twin round the same
values: multiples of 1/16 in [-2, 2] (``_exact``), whose scores and dP are
exact in float32 in any summation order (on random inputs a score an ulp
apart rounds P to the neighbouring bf16 value now and then).  K5 and K6
round P and dS from the same lse as their twin: every element of dq, dk
and dv lies within one bf16 step, 2**-7 of the twin's value plus atol.
K4 where every key fits one of its 128-key tiles rounds P with the final
row max, as the twin does: o and acc / l lie within one step there too.
K5 and K6 give the same bits twice, and the bfloat16 kernels refuse an
operand that does not start on 16 bytes.

float32 K4, K5 and K6 run on the tensor cores too, by 3xTF32
(csrc/flash_attention_tf32.cu): their SASS carries HMMA and ptxas spills
nothing; K5 and K6 give the same bits twice, and K6's dK and dV are K5's
bit for bit (its dK/dV kernel is K5's sweep); at the LM's shapes K4, K5
and K6 keep the reference's limits against the twins, and K5 and K6
against each other; and they refuse an operand that does not start on 16
bytes.

Slice 9 on the card: ``tp_self_attention`` launches K4 once a call for
every rank's heads and never runs the plain attention; a pipeline of
``DecoderBlock``s is its blocks run in sequence bit for bit; ``lm_launch
--dp 2`` and ``mesh_launch --shard 2`` make the launches and the bits of
their ``1``s.
"""

import importlib
import math

import pytest
import torch

from mpit_tpu_torch.ops import (
    attention_bwd_reference,
    block_attention_partial,
    finalize_partials,
    flash_attention,
    flash_bwd_fused,
    flash_bwd_two_kernel,
    flash_fwd,
    fused_adam,
    fused_adam_reference,
    fused_elastic,
    fused_elastic_reference,
    fused_nesterov_commit,
    fused_nesterov_commit_reference,
)

# The module, not the function of the same name that mpit_tpu_torch.ops
# exports.
fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")

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


# Lengths that reach every path of K1's and K3's sweep
# (csrc/fused_update.cu): less than one 16-byte chunk (the scalar path
# alone), one chunk and its neighbours (a scalar head and tail beside the
# chunks), the grid's cap of a chunk a thread ("grid": 16 blocks of 256
# threads an SM, 16,384 floats an SM, resolved at run time from the card's
# SM count) and its neighbours (one chunk more takes a second turn of the
# grid-stride loop), and the main path's lengths.
SWEEP_LENGTHS = [*range(1, 18), "grid-1", "grid", "grid+1", "grid+4", 10250,
                 272261, 544522]
# K1's (rows, n): one row at every length above; four rows of the
# headline's vector (dp=4: past the grid's cap on a 132-SM card; each row
# boundary inside a chunk); rows whose boundary falls inside a chunk
# (1,025 floats), rows shorter than a chunk (a chunk spans several rows).
K1_SWEEP = [(1, n) for n in SWEEP_LENGTHS] + [(4, 544522), (3, 1025), (5, 3), (6, 1),
                                              (2, "grid+1"), (7, 40001)]
# K3's lengths: the above, and 4 x 544,522.
K3_SWEEP = SWEEP_LENGTHS + [4 * 544522]


def _sweep_n(dev, n):
    if isinstance(n, int):
        return n
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * 16384 + int(n[len("grid"):] or 0)


def _offset_copy(t, offset):
    """A copy of ``t`` that starts ``offset`` floats into a buffer of its own."""
    buf = torch.empty(offset + t.numel(), device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


def _k1_bit_equal(w, vt, g, sug, clr, out_offsets):
    """K1 in every variant (l2wd, retract) on copies of ``w`` and ``vt`` that
    start ``out_offsets`` floats into their buffers, bit-equal to the twin."""
    for l2wd in (0.0, 1e-4):
        for s in (None, sug):
            want_w, want_vt = fused_nesterov_commit_reference(w, vt, g, clr, l2wd=l2wd, sug=s)
            kw, kvt = _offset_copy(w, out_offsets[0]), _offset_copy(vt, out_offsets[1])
            before = fused_nesterov_commit.launches
            fused_nesterov_commit(kw, kvt, g, clr, l2wd=l2wd, sug=s)
            torch.cuda.synchronize()
            assert fused_nesterov_commit.launches == before + 1
            assert torch.equal(kw, want_w) and torch.equal(kvt, want_vt), (l2wd, s is None)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("rows,n", K1_SWEEP, ids=[f"{r}x{n}" for r, n in K1_SWEEP])
def test_k1_sweep_bit_equal_on_every_path(dev, rows, n, offset):
    """Every operand ``offset`` floats into its buffer: the elements before
    the first 16-byte boundary take the scalar head."""
    w, vt, g, sug = _operands(dev, rows, _sweep_n(dev, n), offset)
    clr = torch.linspace(0.01, 0.04, rows, device=dev)
    _k1_bit_equal(w, vt, g, sug, clr, (offset, offset))


@pytest.mark.parametrize("rows,n", [(1, 17), (1, 544522), (4, 544522)])
def test_k1_mixed_offsets_take_the_scalar_path(dev, rows, n):
    """Operands at different offsets within 16 bytes share no chunk grid:
    every element takes the scalar path."""
    w, vt, g, sug = _operands(dev, rows, n, 1)
    clr = torch.linspace(0.01, 0.04, rows, device=dev)
    _k1_bit_equal(w, vt, g, sug, clr, (0, 2))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", K3_SWEEP, ids=str)
def test_k3_sweep_bit_equal_on_every_path(dev, n, offset):
    n = _sweep_n(dev, n)
    p, g, m, v = _flat(dev, n, offset, 4, 5 * n + offset)
    v.abs_()
    lr_t = torch.tensor(1e-3 * (1 - 0.999) ** 0.5 / (1 - 0.9), device=dev)
    want = fused_adam_reference(p, g, m, v, lr_t)
    for outs in ((offset,) * 3, (0, 1, 2)):  # one grid, then none (scalar)
        kp, km, kv = (_offset_copy(x, o) for x, o in zip((p, m, v), outs))
        before = fused_adam.launches
        fused_adam(kp, g, km, kv, lr_t)
        torch.cuda.synchronize()
        assert fused_adam.launches == before + 1
        for got, exp in zip((kp, km, kv), want):
            assert torch.equal(got, exp), outs


def test_k1_k3_replay_in_a_cuda_graph_bit_equal_to_eager(dev):
    """K1 (four rows with the retract and l2wd) and K3 (the server's shard)
    captured once in a CUDA graph and replayed three times, with lr_t
    rewritten on the card before each replay, give the bits of three
    eager launches.  The capture counts one launch of each, the replays
    none.  A host sync or an allocation on the card in the call path would
    break the capture."""
    w, vt, g, sug = _operands(dev, 4, 544522)
    clr = torch.tensor([0.01, 0.02, 0.03, 0.04], device=dev)
    p, g3, m, v = _flat(dev, 272261, 0, 4, 11)
    v.abs_()
    lr_t = torch.empty((), device=dev)
    lrs = (1e-3, 2e-3, 5e-4)

    def step(state):
        fused_nesterov_commit(state[0], state[1], g, clr, l2wd=1e-4, sug=sug)
        fused_adam(state[2], g3, state[3], state[4], lr_t)

    eager = [x.clone() for x in (w, vt, p, m, v)]
    for lr in lrs:
        lr_t.fill_(lr)
        step(eager)
    graphed = [x.clone() for x in (w, vt, p, m, v)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = (fused_nesterov_commit.launches, fused_adam.launches)
    with torch.cuda.graph(graph):
        step(graphed)
    assert (fused_nesterov_commit.launches, fused_adam.launches) == (before[0] + 1,
                                                                     before[1] + 1)
    for lr in lrs:
        lr_t.fill_(lr)
        graph.replay()
    torch.cuda.synchronize()
    assert (fused_nesterov_commit.launches, fused_adam.launches) == (before[0] + 1,
                                                                     before[1] + 1)
    for got, want in zip(graphed, eager):
        assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", SWEEP_LENGTHS, ids=str)
def test_k2_sweep_bit_equal_on_every_path(dev, n, offset):
    """K2's ``w`` ``offset`` floats into its buffer; ``sug`` comes back at
    the same offset.  The center at that offset too (one chunk grid: a
    scalar head unless ``offset`` is 0, and the tail) and at another (the
    scalar path alone)."""
    n = _sweep_n(dev, n)
    w, c = _flat(dev, n, offset, 2, 7 * n + offset)
    want_w, want_sug = fused_elastic_reference(w, c, 0.45)
    for c_offset in (offset, (offset + 1) % 4):
        kw, kc = _offset_copy(w, offset), _offset_copy(c, c_offset)
        before = fused_elastic.launches
        got_w, sug = fused_elastic(kw, kc, 0.45)
        torch.cuda.synchronize()
        assert fused_elastic.launches == before + 1
        assert got_w is kw and sug.data_ptr() % 16 == kw.data_ptr() % 16
        assert torch.equal(kw, want_w) and torch.equal(sug, want_sug), c_offset


def test_k2_replays_in_a_cuda_graph_bit_equal_to_eager(dev):
    """K2 at the comm-only path's length captured once and replayed three
    times with the center rewritten on the card before each replay: the
    bits of three eager launches, ``sug`` in the graph's own output.  The
    capture counts one launch, the replays none."""
    w, c = _flat(dev, 544522, 0, 2, 13)
    centers = _flat(dev, 544522, 0, 3, 17)
    eager_w, eager_sugs = w.clone(), []
    for center in centers:
        _, s = fused_elastic(eager_w, center, 0.45)
        eager_sugs.append(s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = fused_elastic.launches
    with torch.cuda.graph(graph):
        _, sug = fused_elastic(w, c, 0.45)
    assert fused_elastic.launches == before + 1
    for center, want_sug in zip(centers, eager_sugs):
        c.copy_(center)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(sug, want_sug)
    assert fused_elastic.launches == before + 1
    assert torch.equal(w, eager_w)


def _mesh_run(**kw):
    from mpit_tpu_torch.train import mesh_launch

    base = dict(model="cnn", side=8, dp=2, su=2, batch=128, lr=1e-2, mom=0.99,
                device="cuda")
    return mesh_launch.run(mesh_launch.MESH_LAUNCH_DEFAULTS.merged(base, **kw))


@pytest.fixture
def deterministic_cudnn():
    """cuDNN held to deterministic algorithms: its default weight gradient
    of the first convolution sums with atomics and does not repeat its
    bits from run to run."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = before


def test_device_loop_on_the_card_trains_as_the_host_loop(dev, deterministic_cudnn):
    """Three epochs (five steps each, su 2: the epochs start at both phases
    of the schedule) from two captured CUDA graphs, bit for bit as the
    host loop with device_stream=1, which repeats its own bits under
    deterministic cuDNN.  K1's wrapper runs once a step while a graph is
    captured and not at all while it replays: the count is the warm-up's
    steps (precompile's two and one epoch on copies) and each graph's
    steps, and the graphs' steps times their replays are the steps
    trained."""
    hosts = [_mesh_run(epochs=3, device_stream=1, precompile=1) for _ in range(2)]
    before = fused_nesterov_commit.launches
    loop = _mesh_run(epochs=3, device_loop=1)
    launches = fused_nesterov_commit.launches - before
    curves = [[(h["avg_loss"], h["test_err"]) for h in r["history"]] for r in (*hosts, loop)]
    assert curves[0] == curves[1], "the host loop does not repeat its own bits"
    assert curves[2] == curves[0]
    info, spe = loop["device_loop"], 5
    assert info["captured"] and sorted(g["phase"] for g in info["graphs"]) == [0, 1]
    assert all(g["steps"] == spe for g in info["graphs"])
    assert info["warmup_steps"] == 2 + spe
    assert launches == info["warmup_steps"] + sum(g["steps"] for g in info["graphs"])
    assert sum(g["steps"] * g["replays"] for g in info["graphs"]) == loop["steps"] == 3 * spe


def test_device_loop_then_the_throughput_leg_on_the_card(dev):
    """The bench flow: the device loop, the schedule resynced, then the
    steady-state leg's eager passes."""
    res = _mesh_run(epochs=2, device_loop=1, measure_throughput=1)
    assert res["samples_per_sec_steady"] > 0
    assert res["steps"] > 2 * 5 and (res["steps"] - 2 * 5) % 5 == 0


def test_process_gangs_on_the_card_count_their_kernels(dev):
    """Process gangs (``launch --np N``), every rank on the card: each
    child reports ``cuda`` and counts its own launches.  EAMSGD np=3 (one
    worker): K1 once a worker step, in the worker's process only; Adam
    np=2: K3 once an apply, in the server's process only."""
    from mpit_tpu_torch.train import launch

    base = launch.LAUNCH_DEFAULTS.merged(model="cnn", side=8, epochs=1, batch=64)
    res = launch.launch_processes(base.merged(np=3, opt="eamsgd", lr=1e-2, mom=0.9,
                                              mva=0.45, su=2), timeout=600)
    assert all(r["platform"] == "cuda" for r in res.values())
    assert res[1]["role"] == "worker" and res[1]["steps"] > 0
    assert res[1]["launches"] == {"k1": res[1]["steps"], "k2": 0, "k3": 0}
    assert res[0]["launches"] == res[2]["launches"] == {"k1": 0, "k2": 0, "k3": 0}
    res = launch.launch_processes(base.merged(np=2, opt="adam", lr=1e-3, su=1),
                                  timeout=600)
    assert all(r["platform"] == "cuda" for r in res.values())
    assert res[0]["grads_applied"] == res[1]["steps"] > 0
    assert res[0]["launches"] == {"k1": 0, "k2": 0, "k3": res[0]["grads_applied"]}
    assert res[1]["launches"] == {"k1": 0, "k2": 0, "k3": 0}


# (leading axes, Lq, Lk, q_offset, kv_offset, causal): odd lengths, a
# ragged pair whose first q rows are dead (no key at or before them), a
# ragged pair with the diagonal inside, full attention over a partial key
# tile.
FA_CASES = [
    ((2, 3), 77, 77, 0, 0, True),
    ((5,), 131, 67, 20, 40, True),
    ((5,), 131, 67, 100, 40, True),
    ((2,), 100, 150, 0, 0, False),
]


def _fa_inputs(dev, lead, lq, lk, d, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = 0.5 * torch.randn(*lead, lq, d, device=dev, generator=gen)
    k, v = (0.5 * torch.randn(*lead, lk, d, device=dev, generator=gen) for _ in range(2))
    do = torch.randn(*lead, lq, d, device=dev, generator=gen)
    return tuple(t.to(dtype) for t in (q, k, v, do))


def _assert_close(got, want, atol, rtol=0.0, rows=False):
    """Elementwise within atol + rtol |want|; with ``rows`` (an output that
    depends on bf16 rounding) by the bf16 rule of the module docstring."""
    got, want = got.float(), want.float()
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert bool(torch.isfinite(got[fin]).all())
    if not rows:
        torch.testing.assert_close(got[fin], want[fin], atol=atol, rtol=rtol)
        return
    gap = got - want
    d = want.shape[-1]
    row_norm = want.norm(dim=-1)
    row_limit = 2.0**-6 * row_norm + atol * math.sqrt(d)
    assert bool((gap.norm(dim=-1) <= row_limit).all()), float(
        (gap.norm(dim=-1) / row_limit).max())
    elem_limit = 2.0**-7 * want.abs() + 2.0**-5 * (row_norm / math.sqrt(d))[..., None] + atol
    assert bool((gap.abs() <= elem_limit).all()), float((gap.abs() / elem_limit).max())


@pytest.mark.parametrize("case", range(len(FA_CASES)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 24, 32, 64, 128])
def test_flash_kernels_match_twins(dev, case, dtype, d):
    lead, lq, lk, q_off, kv_off, causal = FA_CASES[case]
    q, k, v, do = _fa_inputs(dev, lead, lq, lk, d, dtype, 100 * case + d)
    kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
    bwd_atol = 3e-4 if (q_off or kv_off) else 3e-5
    acc_t, m_t, l_t = block_attention_partial(q, k, v, **kw)
    o_t = finalize_partials(acc_t, l_t, dtype)
    lse_t = m_t + torch.log(torch.where(l_t == 0, 1.0, l_t))

    before = flash_fwd.launches
    o, lse = flash_fwd(q, k, v, **kw)
    acc, m, l = flash_fwd(q, k, v, partial=True, **kw)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 2
    assert o.dtype == dtype and lse.dtype == acc.dtype == torch.float32
    rows = dtype == torch.bfloat16
    _assert_close(o, o_t, 2e-5, rows=rows)
    _assert_close(lse, lse_t, 2e-5)
    _assert_close(m, m_t, 2e-5)
    den = torch.where(l_t == 0, 1.0, l_t)[..., None]
    _assert_close(acc / den, acc_t / den, 2e-5, rows=rows)
    _assert_close(l, l_t, 0.0, rtol=1e-5)
    assert bool(torch.isneginf(m).any()) == (causal and q_off < kv_off)

    delta = (do.float() * o.float()).sum(-1)
    want = attention_bwd_reference(q, k, v, do, lse, delta, **kw)
    fused_before, two_before = flash_bwd_fused.launches, flash_bwd_two_kernel.launches
    got5 = flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    got6 = flash_bwd_two_kernel(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert flash_bwd_fused.launches == fused_before + 1
    assert flash_bwd_two_kernel.launches == two_before + 2
    for a5, a6, w in zip(got5, got6, want):
        assert a5.dtype == a6.dtype == dtype
        _assert_close(a5, w, bwd_atol, rows=rows)
        _assert_close(a6, w, bwd_atol, rows=rows)
        _assert_close(a5, a6, bwd_atol, rows=rows)


@pytest.mark.parametrize("fused", ["1", "0"])
def test_flash_autograd_runs_the_gated_schedule(dev, fused, monkeypatch):
    monkeypatch.setenv("MPIT_FA_FUSED_BWD", fused)
    q, k, v, do = _fa_inputs(dev, (2, 4), 200, 200, 32, torch.float32, 7)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counts = [f.launches for f in (flash_fwd, flash_bwd_fused, flash_bwd_two_kernel)]
    flash_attention(q, k, v, causal=True).backward(do)
    torch.cuda.synchronize()
    got = [f.launches - c for f, c in zip((flash_fwd, flash_bwd_fused,
                                          flash_bwd_two_kernel), counts)]
    assert got == ([1, 1, 0] if fused == "1" else [1, 0, 2])
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa.attention_reference(qr, kr, vr, causal=True).backward(do)
    for a, b in zip((q.grad, k.grad, v.grad), (qr.grad, kr.grad, vr.grad)):
        torch.testing.assert_close(a, b, atol=3e-5, rtol=0)


def test_flash_refused_launch_raises(dev, monkeypatch):
    """A geometry the C side refuses (D not a multiple of 8, let past the
    wrapper's own check here) raises and counts no launch."""
    q, k, v, _ = _fa_inputs(dev, (2,), 16, 16, 12, torch.float32, 3)
    monkeypatch.setattr(fa, "_check_qkv", lambda q, k, v: ((2,), 16, 16, 12))
    before = flash_fwd.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        flash_fwd(q, k, v)
    assert flash_fwd.launches == before


def test_flash_refuses_mixed_devices(dev):
    q, k, v, _ = _fa_inputs(dev, (2,), 16, 16, 16, torch.float32, 4)
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, q_offset=2**30)
    assert math.isfinite(float(flash_attention(q, k, v).sum()))


BF16_STEP = 2.0**-7


def _exact(*tensors):
    """Each tensor rounded to a multiple of 1/16 in [-2, 2], in bf16."""
    return tuple((torch.round(t.float() * 16) / 16).clamp(-2, 2).to(torch.bfloat16)
                 for t in tensors)


def _bwd_within_one_step_and_deterministic(bwd, dev, case, d):
    """bf16 ``bwd`` (K5 or K6) on exact inputs: twice the same bits, and
    every element of dq, dk and dv within one bf16 step of the twin."""
    lead, lq, lk, q_off, kv_off, causal = FA_CASES[case]
    q, k, v, do = _exact(*_fa_inputs(dev, lead, lq, lk, d, torch.float32, 300 * case + d))
    kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
    acc_t, m_t, l_t = block_attention_partial(q, k, v, **kw)
    lse = m_t + torch.log(torch.where(l_t == 0, 1.0, l_t))
    delta = (do.float() * finalize_partials(acc_t, l_t, q.dtype).float()).sum(-1)
    want = attention_bwd_reference(q, k, v, do, lse, delta, **kw)
    got = bwd(q, k, v, do, lse, delta, **kw)
    again = bwd(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    atol = 3e-4 if (q_off or kv_off) else 3e-5
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        _assert_close(a, w, atol, rtol=BF16_STEP)


@pytest.mark.parametrize("case", range(len(FA_CASES)))
@pytest.mark.parametrize("d", [8, 32, 64, 128])
def test_k5_bf16_within_one_step_and_deterministic(dev, case, d):
    _bwd_within_one_step_and_deterministic(flash_bwd_fused, dev, case, d)


@pytest.mark.parametrize("case", range(len(FA_CASES)))
@pytest.mark.parametrize("d", [8, 32, 64, 128])
def test_k6_bf16_within_one_step_and_deterministic(dev, case, d):
    _bwd_within_one_step_and_deterministic(flash_bwd_two_kernel, dev, case, d)


@pytest.mark.parametrize("lead,seq", [((8, 8), 1024), ((1, 2), 4096)])
def test_k6_bf16_agrees_with_k5_at_lm_shapes(dev, lead, seq):
    """bf16 K6 and K5 on the same causal inputs at D 128 and D 32 (the
    LM's head widths), held to each other by the bf16 row rule: they sum
    dQ in another order (K5 over per-key-tile partials, K6 in one
    accumulator)."""
    for d in (32, 128):
        q, k, v, do = _fa_inputs(dev, lead, seq, seq, d, torch.bfloat16, seq + d)
        o, lse = flash_fwd(q, k, v, causal=True)
        delta = (do.float() * o.float()).sum(-1)
        got6 = flash_bwd_two_kernel(q, k, v, do, lse, delta, causal=True)
        got5 = flash_bwd_fused(q, k, v, do, lse, delta, causal=True)
        torch.cuda.synchronize()
        for a6, a5 in zip(got6, got5):
            _assert_close(a6, a5, 3e-5, rows=True)


# Lk within one 128-key tile of the bfloat16 forward: (leading axes, Lq, Lk,
# q_offset, kv_offset, causal).
FA_ONE_TILE = [
    ((2, 3), 200, 128, 0, 0, True),
    ((2, 3), 200, 64, 0, 0, True),
    ((2, 3), 200, 64, 0, 0, False),
    ((2, 3), 200, 61, 20, 60, True),
    ((2, 3), 200, 37, 100, 40, False),
]


@pytest.mark.parametrize("case", range(len(FA_ONE_TILE)))
@pytest.mark.parametrize("d", [16, 64, 128])
def test_k4_bf16_one_key_tile_within_one_step(dev, case, d):
    lead, lq, lk, q_off, kv_off, causal = FA_ONE_TILE[case]
    q, k, v = _exact(*_fa_inputs(dev, lead, lq, lk, d, torch.float32, 400 * case + d)[:3])
    kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
    acc_t, m_t, l_t = block_attention_partial(q, k, v, **kw)
    o, _ = flash_fwd(q, k, v, **kw)
    acc, m, l = flash_fwd(q, k, v, partial=True, **kw)
    torch.cuda.synchronize()
    _assert_close(o, finalize_partials(acc_t, l_t, q.dtype), 2e-5, rtol=BF16_STEP)
    den = torch.where(l_t == 0, 1.0, l_t)[..., None]
    _assert_close(acc / den, acc_t / den, 2e-5, rtol=BF16_STEP)
    _assert_close(m, m_t, 2e-5)
    _assert_close(l, l_t, 0.0, rtol=1e-5)


@pytest.mark.parametrize("which", ["q", "k", "v", "do"])
def test_bf16_kernels_refuse_unaligned_operands(dev, which):
    """A contiguous view one element into a buffer starts 2 bytes off a
    16-byte boundary: the tensor-core kernels' TMA copies refuse it."""
    ops = dict(zip(("q", "k", "v", "do"),
                   _fa_inputs(dev, (2,), 64, 64, 32, torch.bfloat16, 9)))
    ops["lse"] = ops["delta"] = torch.zeros(2, 64, device=dev)
    buf = torch.empty(ops[which].numel() + 8, dtype=ops[which].dtype, device=dev)
    ops[which] = buf[1:1 + ops[which].numel()].view_as(ops[which]).copy_(ops[which])
    kernels = (flash_fwd, flash_bwd_fused, flash_bwd_two_kernel)
    before = [f.launches for f in kernels]
    for bwd in (flash_bwd_fused, flash_bwd_two_kernel):
        with pytest.raises(ValueError, match="16-byte"):
            bwd(*(ops[x] for x in ("q", "k", "v", "do", "lse", "delta")))
    if which in ("q", "k", "v"):
        with pytest.raises(ValueError, match="16-byte"):
            flash_fwd(ops["q"], ops["k"], ops["v"])
    assert [f.launches for f in kernels] == before


def test_f32_k4_k5_run_on_the_tensor_cores(dev):
    """float32 K4, K5 and K6 come from flash_attention_tf32.cu: mma.sync
    (HMMA) in every width's kernel, no spill."""
    from mpit_tpu_torch.ops import build

    ops = build.tensor_ops("flash_attention_tf32")
    for kernel in ("fa_fwd_tf32_kernel", "fa_bwd_tf32_kernel", "fa_bwd_dq_tf32_kernel",
                   "fa_bwd_dkdv_tf32_kernel"):
        found = {k: o for k, o in ops.items() if kernel in k}
        assert len(found) >= 3 and all(o["HMMA"] for o in found.values()), found
    report = build.ptxas_report("flash_attention_tf32")
    assert report and not any(r["spill_bytes"] for r in report.values()), report


@pytest.mark.parametrize("case", range(len(FA_CASES)))
@pytest.mark.parametrize("d", [8, 32, 64, 128])
def test_k5_f32_tensor_cores_deterministic(dev, case, d):
    """float32 K5 (3xTF32): twice the same bits, its dQ summed from the
    per-key-tile partials in one fixed order."""
    lead, lq, lk, q_off, kv_off, causal = FA_CASES[case]
    q, k, v, do = _fa_inputs(dev, lead, lq, lk, d, torch.float32, 500 * case + d)
    kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
    o, lse = flash_fwd(q, k, v, **kw)
    delta = (do * o).sum(-1)
    got = flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    again = flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", range(len(FA_CASES)))
@pytest.mark.parametrize("d", [8, 32, 64, 128])
def test_k6_f32_dkdv_is_k5s_and_deterministic(dev, case, d):
    """float32 K6's dK/dV kernel is K5's sweep without the dQ work: its dk
    and dv are K5's bit for bit, and K6 run twice gives the same bits."""
    lead, lq, lk, q_off, kv_off, causal = FA_CASES[case]
    q, k, v, do = _fa_inputs(dev, lead, lq, lk, d, torch.float32, 600 * case + d)
    kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
    o, lse = flash_fwd(q, k, v, **kw)
    delta = (do * o).sum(-1)
    got = flash_bwd_two_kernel(q, k, v, do, lse, delta, **kw)
    again = flash_bwd_two_kernel(q, k, v, do, lse, delta, **kw)
    _, dk5, dv5 = flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[1], dk5) and torch.equal(got[2], dv5)


@pytest.mark.parametrize("lead,seq,d", [((8, 8), 1024, 32), ((1, 2), 4096, 128)])
def test_f32_tensor_cores_agree_with_twins_and_k6_at_lm_shapes(dev, lead, seq, d):
    """float32 K4, K5 and K6 at the LM's head widths, causal: o and lse
    within 2e-5 of the twin, K5's and K6's grads within 3e-5 of the twin's
    and of each other's, from the same lse."""
    q, k, v, do = _fa_inputs(dev, lead, seq, seq, d, torch.float32, seq + d)
    acc_t, m_t, l_t = block_attention_partial(q, k, v, causal=True)
    o, lse = flash_fwd(q, k, v, causal=True)
    _assert_close(o, finalize_partials(acc_t, l_t, q.dtype), 2e-5)
    _assert_close(lse, m_t + torch.log(l_t), 2e-5)
    delta = (do * o).sum(-1)
    got5 = flash_bwd_fused(q, k, v, do, lse, delta, causal=True)
    got6 = flash_bwd_two_kernel(q, k, v, do, lse, delta, causal=True)
    want = attention_bwd_reference(q, k, v, do, lse, delta, causal=True)
    torch.cuda.synchronize()
    for a5, a6, w in zip(got5, got6, want):
        _assert_close(a5, w, 3e-5)
        _assert_close(a6, w, 3e-5)
        _assert_close(a5, a6, 3e-5)


@pytest.mark.parametrize("which", ["q", "k", "v", "do"])
def test_f32_tensor_core_kernels_refuse_unaligned_operands(dev, which):
    """A contiguous float32 view one element into a buffer starts 4 bytes
    off a 16-byte boundary: float32 K4, K5 and K6, which copy 16 bytes a
    thread, refuse it and count no launch."""
    ops = dict(zip(("q", "k", "v", "do"),
                   _fa_inputs(dev, (2,), 64, 64, 32, torch.float32, 9)))
    ops["lse"] = ops["delta"] = torch.zeros(2, 64, device=dev)
    buf = torch.empty(ops[which].numel() + 8, dtype=ops[which].dtype, device=dev)
    ops[which] = buf[1:1 + ops[which].numel()].view_as(ops[which]).copy_(ops[which])
    kernels = (flash_fwd, flash_bwd_fused, flash_bwd_two_kernel)
    before = [f.launches for f in kernels]
    for bwd in (flash_bwd_fused, flash_bwd_two_kernel):
        with pytest.raises(ValueError, match="16-byte"):
            bwd(*(ops[x] for x in ("q", "k", "v", "do", "lse", "delta")))
    if which in ("q", "k", "v"):
        with pytest.raises(ValueError, match="16-byte"):
            flash_fwd(ops["q"], ops["k"], ops["v"])
    assert [f.launches for f in kernels] == before


# -- slice 4: BiCNN on the card ----------------------------------------------

BICNN_SHARD = 1_365_250 // 2  # a server's shard of the docqa model at np=4


@pytest.mark.parametrize("n", [BICNN_SHARD, BICNN_SHARD + 1])
def test_k3_bit_equal_at_a_bicnn_server_shard(dev, n):
    """K3 as BiCNN's server-side Adam runs it (step_div 72), against its
    twin: the rule's lr_t, then the kernel on the shard, bit for bit."""
    from mpit_tpu_torch.optim import rules

    gen = torch.Generator(device=dev).manual_seed(11)
    p, g, m, v = (torch.randn(n, device=dev, generator=gen) for _ in range(4))
    v.abs_()
    rule = rules.make("adam", lr=1e-3, step_div=72)
    state = {"t": torch.full((), 100, dtype=torch.int32, device=dev), "m": m.clone(),
             "v": v.clone()}
    exponent = (torch.tensor(101, device=dev) // 72 + 1).float()
    lr_t = 1e-3 * torch.sqrt(1.0 - torch.pow(0.999, exponent)) / (1.0 - torch.pow(0.9, exponent))
    want = fused_adam_reference(p, g, m, v, lr_t)
    before = fused_adam.launches
    got, state = rule.apply(p.clone(), g, state)
    torch.cuda.synchronize()
    assert fused_adam.launches == before + 1
    for a, b in zip((got, state["m"], state["v"]), want):
        assert torch.equal(a, b)


def test_bicnn_sgd_steps_on_the_card_match_the_cpu(dev, tmp_path):
    """Three ``sgd`` steps (momentum 0.9: K1 once a step) of a small BiCNN
    on the card against the CPU from one w0 and the same negatives: the
    gradients differ by summation order only, far below a step's change."""
    import numpy as np

    from mpit_tpu_torch.data import qa
    from mpit_tpu_torch.train.bicnn import BICNN_DEFAULTS, BiCNNTrainer

    paths = qa.synthetic_qa(tmp_path, n_labels=10, n_train=96, n_eval=16,
                            embedding_dim=16, vocab_words=60, seed=11)
    data = qa.load_qa_files(embedding_dim=16, conv_width=3, **paths)
    cfg = BICNN_DEFAULTS.merged(optimization="sgd", momentum=0.9, learning_rate=0.05,
                                num_filters=300, word_hidden_dim=64, cont_conv_width=3,
                                maxnegsample=20, batch_size=8, eval_chunk=16)
    finals = {}
    for device in ("cuda", "cpu"):
        tr = BiCNNTrainer(cfg.merged(device=device), data=data)
        w0 = tr.w.cpu().clone()
        before = fused_nesterov_commit.launches
        for s in range(3):
            tr.step(np.arange(8 * s, 8 * s + 8))
        if device == "cuda":
            torch.cuda.synchronize()
            assert fused_nesterov_commit.launches == before + 3
            assert tr.w.device.type == "cuda"
        finals[device] = tr.w.cpu()
    gap = (finals["cuda"] - finals["cpu"]).abs().max()
    change = (finals["cpu"] - w0).abs().max()
    assert float(change) > 1e-3 and float(gap) <= 1e-5


@pytest.mark.parametrize("size", [985600, 272261])
def test_slot_over_four_ranks_on_the_card(dev, size):
    """A slot over ``shard=4`` virtual ranks of the card (985,600 floats cut
    246,400 a rank; 272,261, which 4 does not divide, replicated): one
    block a rank, K3 launched 4 times an Adam apply, and every apply's
    result and state bit-equal to the one-rank slot's."""
    from mpit_tpu_torch.dplane import HbmSlot, PlaneConfig
    from mpit_tpu_torch.optim.rules import make as make_rule
    from mpit_tpu_torch.parallel.mesh import make_mesh

    mesh = HbmSlot(size, make_rule("adam"), config=PlaneConfig(
        device="cuda", mesh=make_mesh(dp=1, shard=4, device="cuda")))
    one = HbmSlot(size, make_rule("adam"), config=PlaneConfig(device="cuda"))
    assert len(mesh.blocks) == 4 and len({b.data_ptr() for b in mesh.blocks}) == 4
    assert all(b.is_cuda for b in mesh.blocks)
    gen = torch.Generator(device=dev).manual_seed(size)
    for _ in range(3):
        g = torch.randn(size, device=dev, generator=gen)
        before = fused_adam.launches
        mesh.apply_grad(g)
        assert fused_adam.launches - before == 4
        one.apply_grad(g)
        assert torch.equal(mesh.pull_device(), one.pull_device())
    assert mesh.describe()["spec"] == (["shard"] if size % 4 == 0 else [])
    for k, v in one.state_host().items():
        assert (mesh.state_host()[k] == v).all(), k
    assert [int(st["t"]) for st in mesh.states] == [3] * 4


def test_exchange_on_the_card_crosses_streams(dev):
    """The device exchange on the card: the client's thread submits from a
    side stream and the server's thread applies on its own stream; the
    device path's bits equal an Adam slot's on the CPU, and the pulled
    vector is read on the client's stream after the apply."""
    import threading

    import numpy as np

    from mpit_tpu_torch.comm.local import LocalRouter
    from mpit_tpu_torch.dplane import ExchangeClient, HbmSlot, PlaneConfig
    from mpit_tpu_torch.optim.rules import make as make_rule
    from mpit_tpu_torch.ps import ParamClient, ParamServer

    router = LocalRouter(3)
    servers = [ParamServer(r, [2], router.endpoint(r), rule="adam",
                           dplane=PlaneConfig()) for r in (0, 1)]
    threads = [threading.Thread(target=s.start, daemon=True) for s in servers]
    for t in threads:
        t.start()
    client = ExchangeClient(ParamClient(2, [0, 1], router.endpoint(2),
                                        seed_servers=True))
    n = 2 * 272261
    client.start(np.zeros(n, np.float32), np.zeros(n, np.float32))
    gen = torch.Generator(device=dev).manual_seed(0)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        upd = torch.randn(n, device=dev, generator=gen)
        out = client.sync_device(upd)
        host = out.to("cpu")
    assert client.device_ranks == [0, 1]
    ref = HbmSlot(n // 2, make_rule("adam"), config=PlaneConfig(device="cpu"))
    ref.apply_grad(upd[: n // 2].cpu())
    assert torch.allclose(host[: n // 2], ref.param, rtol=0, atol=1e-6)
    client.stop()
    for t in threads:
        t.join(30)
        assert not t.is_alive()


# Ring attention on the card (the twins of chip_smoke.py's ring_kernels at a
# smaller width): the flash ring's output against the plain ring's, its grads
# against the same backward ring over the pairs' twin on its own (o, lse), and
# both against flash_attention at sp 1, under the bf16 row rule; K4 once a
# pair, K5 once (K6 twice) a pair.
ring_mod = importlib.import_module("mpit_tpu_torch.parallel.ring_attention")


def _ring_run(fn, q, k, v, do):
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = fn(qs, ks, vs)
    return (out.detach(),) + tuple(torch.autograd.grad(out, (qs, ks, vs), do))


def _twin_pair(q, k, v, do, lse, *, delta, **kw):
    return attention_bwd_reference(q, k, v, do, lse, delta, **kw)


@pytest.mark.parametrize("layout, fused", [("zigzag", "1"), ("contiguous", "1"),
                                           ("contiguous", "0")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_ring_matches_its_plain_version(dev, layout, fused, dtype, monkeypatch):
    from mpit_tpu_torch.models.transformer import default_attn
    from mpit_tpu_torch.parallel import ring_attention, sp_mesh

    n, b, length, h, d = 4, 1, 2048, 4, 64
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v = ((0.5 * torch.randn(b, length, h, d, device=dev, generator=gen)).to(dtype)
               for _ in range(3))
    do = torch.randn(b, length, h, d, device=dev, generator=gen).to(dtype)
    mesh = sp_mesh(n, dev)
    flash_ring = ring_attention(mesh, impl="flash", layout=layout)
    plain = _ring_run(ring_attention(mesh, impl="plain", layout=layout), q, k, v, do)
    local = _ring_run(default_attn(causal=True), q, k, v, do)
    with monkeypatch.context() as m:
        m.setattr(ring_mod, "flash_attention_bwd_pair", _twin_pair)
        twin = _ring_run(flash_ring, q, k, v, do)
    monkeypatch.setenv("MPIT_FA_FUSED_BWD", fused)
    counts = [f.launches for f in (flash_fwd, flash_bwd_fused, flash_bwd_two_kernel)]
    got = _ring_run(flash_ring, q, k, v, do)
    torch.cuda.synchronize()
    pairs = ring_mod.ring_pairs(n, layout)
    assert [f.launches - c for f, c in zip(
        (flash_fwd, flash_bwd_fused, flash_bwd_two_kernel), counts)] == (
        [pairs, pairs, 0] if fused == "1" else [pairs, 0, 2 * pairs])
    rows = dtype == torch.bfloat16
    for i, (g, p, t, s) in enumerate(zip(got, plain, twin, local)):
        atol = 2e-5 if i == 0 else 3e-5
        _assert_close(g, p if i == 0 else t, atol, rows=rows)
        _assert_close(g, s, atol, rows=rows)


def test_flash_ring_never_runs_the_plain_ring_on_the_card(dev, monkeypatch):
    from mpit_tpu_torch.parallel import ring_attention, sp_mesh

    def refuse(*a, **kw):
        raise AssertionError("the plain ring ran on a CUDA tensor")

    monkeypatch.setattr(ring_mod, "block_attention_partial", refuse)
    q = torch.randn(1, 256, 2, 32, device=dev, dtype=torch.bfloat16, requires_grad=True)
    out = ring_attention(sp_mesh(4, dev), impl="auto", layout="zigzag")(q, q, q)
    out.float().sum().backward()
    assert bool(torch.isfinite(q.grad.float()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead, lq, lk, d, q_off, kv_off", [
    ((1, 8), 1024, 1024, 128, 0, 1024), ((2, 3), 203, 131, 64, 20, 223)])
def test_wholly_masked_pair_gives_exact_zeros(dev, dtype, lead, lq, lk, d, q_off, kv_off):
    """Every key after every query: K4's partials are acc 0, m -inf, l 0 and
    K5's and K6's grads exact zeros, as their twins', each output allocated
    over NaN."""
    q, k, v, do = _fa_inputs(dev, lead, lq, lk, d, dtype, 5)
    gen = torch.Generator(device=dev).manual_seed(6)
    lse = torch.randn(*lead, lq, device=dev, generator=gen) + 3.0
    delta = torch.randn(*lead, lq, device=dev, generator=gen)
    kw = dict(causal=True, q_offset=q_off, kv_offset=kv_off)
    outs = []
    for call in (lambda: flash_fwd(q, k, v, partial=True, **kw),
                 lambda: flash_bwd_fused(q, k, v, do, lse, delta, **kw),
                 lambda: flash_bwd_two_kernel(q, k, v, do, lse, delta, **kw)):
        nan = [torch.full((*lead, n, d), float("nan"), dtype=t, device=dev)
               for n, t in ((lq, torch.float32), (lq, dtype), (lk, dtype), (lk, dtype))]
        del nan
        outs.append(call())
    torch.cuda.synchronize()
    acc, m, l = outs[0]
    want = block_attention_partial(q, k, v, **kw)
    assert torch.equal(acc, want[0]) and not bool(acc.any())
    assert bool(torch.isneginf(m).all()) and torch.equal(l, want[2]) and not bool(l.any())
    twin = attention_bwd_reference(q, k, v, do, lse, delta, **kw)
    for grads in outs[1:]:
        for g, t in zip(grads, twin):
            assert torch.equal(g, t) and not bool(g.any())


def test_collectives_on_the_card_are_their_definitions(dev):
    from mpit_tpu_torch.parallel import Mesh, allreduce_mean, ps_pull, ps_push, ps_pushpull
    from mpit_tpu_torch.parallel import ring_shift

    mesh = Mesh(dev, dp=4, shard=4)
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(4, 4096, device=dev, generator=gen)
    w = torch.randint(-1000, 1000, (4, 4096), device=dev, generator=gen).float()
    assert torch.equal(ring_shift(mesh, "shard")(x), torch.cat([x[-1:], x[:-1]]))
    assert torch.equal(ring_shift(mesh, "shard", reverse=True)(x), torch.cat([x[1:], x[:1]]))
    assert torch.equal(ps_pull(mesh)(x), x.reshape(-1))
    assert torch.equal(ps_push(mesh, reduce_axis="dp")(w),
                       (w[0] + w[1] + w[2] + w[3]).view(4, -1))
    assert torch.equal(allreduce_mean(mesh)(w), ((w[0] + w[1] + w[2] + w[3]) / 4).expand(4, -1))
    full, shards = ps_pushpull(mesh, lambda p, g: p + g)(x, w.reshape(-1))
    assert torch.equal(shards, x + w) and torch.equal(full, shards.reshape(-1))


def test_measure_ps_pushpull_on_the_card(dev):
    from mpit_tpu_torch.parallel.collective import measure_ps_pushpull

    res = measure_ps_pushpull(8, rounds=5)
    assert res["devices"] == 1 and res["payload_mb"] == 8.0
    assert res["mbs"] > 0 and math.isclose(res["mbs"], 2 * 8 / (res["ms_per_round"] / 1e3))


@pytest.mark.parametrize("layout", ["zigzag", "contiguous"])
def test_lm_launch_sp4_on_the_card(dev, layout):
    """``lm_launch --sp 4`` on the card: K1 once a step, K4 and K5 once a
    live pair a layer a pass, and the first steps' losses as at sp 1."""
    from mpit_tpu_torch.train.lm_launch import LM_LAUNCH_DEFAULTS, run

    kw = dict(seq_len=512, d_model=128, n_heads=4, n_layers=2, batch=2, steps=3,
              log_every=1, attn_dtype="float32", device="cuda")
    counts = [f.launches for f in (fused_nesterov_commit, flash_fwd, flash_bwd_fused)]
    res = run(LM_LAUNCH_DEFAULTS.merged(kw, sp=4, layout=layout))
    torch.cuda.synchronize()
    pairs = ring_mod.ring_pairs(4, layout)
    assert [f.launches - c for f, c in zip(
        (fused_nesterov_commit, flash_fwd, flash_bwd_fused), counts)] == [
        4, 2 * 4 * pairs, 2 * 4 * pairs]
    assert res["mesh"] == {"dp": 1, "sp": 4} and res["device"].startswith("cuda")
    local = run(LM_LAUNCH_DEFAULTS.merged(kw))
    torch.testing.assert_close([h["avg_loss"] for h in res["history"]],
                               [h["avg_loss"] for h in local["history"]],
                               rtol=1e-5, atol=0)


def test_tp_self_attention_runs_k4_once_never_the_reference(dev, monkeypatch):
    """Head-parallel attention on the card: one K4 launch a call for every
    rank's heads, K5 once backward, and never the plain attention."""
    from mpit_tpu_torch.parallel import Mesh, tp_self_attention

    fa_mod = importlib.import_module("mpit_tpu_torch.ops.flash_attention")

    def refuse(*a, **kw):
        raise AssertionError("the plain attention ran on a CUDA tensor")

    monkeypatch.setattr(fa_mod, "attention_reference", refuse)
    monkeypatch.setattr(fa_mod, "block_attention_partial", refuse)
    gen = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn(2, 256, 64, device=dev, generator=gen, requires_grad=True)
    wqkv = torch.randn(64, 3, 8, 8, device=dev, generator=gen) / 8
    wo = torch.randn(8, 8, 64, device=dev, generator=gen) / 8
    counts = [f.launches for f in (flash_fwd, flash_bwd_fused)]
    tp_self_attention(Mesh(dev, tp=4), causal=True)(x, wqkv, wo).sum().backward()
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip((flash_fwd, flash_bwd_fused), counts)] == [1, 1]
    assert bool(torch.isfinite(x.grad).all())


def test_pipeline_of_decoder_blocks_on_the_card_is_the_sequential_blocks(dev):
    """Two ``DecoderBlock``s as two stages over three microbatches: the
    output bit for bit the blocks run in sequence, K4 once a stage call."""
    from mpit_tpu_torch.models.transformer import DecoderBlock
    from mpit_tpu_torch.parallel import Mesh, pipeline, stack_stage_params

    gen = torch.Generator(device=dev).manual_seed(32)
    block = DecoderBlock(64, 4).to(dev)
    blocks = [{k: torch.randn(v.shape, device=dev, generator=gen) * 0.1 + (k.endswith("scale"))
               for k, v in block.named_parameters()} for _ in range(2)]
    xs = torch.randn(3, 1, 128, 64, device=dev, generator=gen)

    def stage(p, x):
        return torch.func.functional_call(block, p, (x,))

    before = flash_fwd.launches
    out = pipeline(Mesh(dev, pp=2), stage)(stack_stage_params(blocks), xs)
    torch.cuda.synchronize()
    assert flash_fwd.launches - before == 6
    ref = torch.stack([stage(blocks[1], stage(blocks[0], x)) for x in xs])
    assert torch.equal(out, ref)


def test_lm_launch_dp2_on_the_card_is_dp1(dev):
    """``--dp 2 --sp 4`` at batch 2 on the card: the launches and, under
    deterministic algorithms, the bits of ``--dp 1 --sp 4``."""
    import os

    from mpit_tpu_torch.train.lm_launch import LM_LAUNCH_DEFAULTS, run

    kw = dict(seq_len=512, d_model=128, n_heads=4, n_layers=2, batch=2, steps=3,
              log_every=1, attn_dtype="bfloat16", device="cuda", sp=4)
    was = torch.are_deterministic_algorithms_enabled()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for dp in (2, 1):
            counts = [f.launches for f in (fused_nesterov_commit, flash_fwd, flash_bwd_fused)]
            res = run(LM_LAUNCH_DEFAULTS.merged(kw, dp=dp))
            torch.cuda.synchronize()
            runs.append((res, [f.launches - c for f, c in zip(
                (fused_nesterov_commit, flash_fwd, flash_bwd_fused), counts)]))
    finally:
        torch.use_deterministic_algorithms(was)
    (two, n2), (one, n1) = runs
    assert two["mesh"] == {"dp": 2, "sp": 4} and n2 == n1
    assert two["history"] == one["history"]
    assert all(torch.equal(two["state"][k], one["state"][k]) for k in ("w", "vt", "k"))


def test_mesh_launch_shard2_on_the_card_is_shard1(dev):
    """``--dp 4 --shard 2`` on the card, under deterministic cuDNN: K1 as
    many launches and every bit of ``--shard 1``."""
    from mpit_tpu_torch.train.mesh_launch import MESH_LAUNCH_DEFAULTS, run

    base = MESH_LAUNCH_DEFAULTS.merged(model="cnn", side=8, dp=4, epochs=2, su=2, batch=32,
                                       lr=1e-2, mom=0.99, device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for shard in (2, 1):
            before = fused_nesterov_commit.launches
            res = run(base.merged(shard=shard))
            runs.append((res, fused_nesterov_commit.launches - before))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (two, k2), (one, k1) = runs
    assert two["mesh"] == {"dp": 4, "shard": 2} and k2 == k1 == two["steps"]
    assert all(torch.equal(two["state"][k], one["state"][k]) for k in two["state"])
