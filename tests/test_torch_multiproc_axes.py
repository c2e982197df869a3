"""Every mesh axis across the processes of a ``torch.distributed`` group,
on the CPU over gloo: ``sp`` and ``shard`` cut as the JAX package cuts its
devices (the row-major grid in contiguous blocks, each a box).

Every group here is two or four real OS processes at one intra-op thread,
each with its own timeout and a free port on the loopback, as
``tests/test_torch_multiproc.py`` starts its pairs.  The settings are
small: ring attention at B 2, L 64, H 2, D 16; the LM at
``tests/test_torch_lm.py``'s ``TINY`` widths (L 256, d 32, 4 heads, 1
layer, batch 8); MNIST at side 8, batch 32.

- Layouts, before any rendezvous: the five cuts (dp 1 x sp 2 and sp 4
  over two processes, dp 2 x sp 2 over four, dp 1 x shard 2 over two,
  dp 2 x shard 2 over four) with their ranges and rows; a block that is
  not a box raises ``ValueError`` naming it; ``tp``, ``pp`` and ``ep``
  across processes lay out as every other axis (each process its box,
  each spanning axis its lines), and their entry points build over an
  axis that spans (``tests/test_torch_multiproc_tp_pp_ep.py`` runs them).
- Collectives, over the line of each axis: ``ring_shift`` forward and
  backward, ``ps_pull``, ``ps_push``, ``ps_pushpull``, ``psum``,
  ``allreduce_mean``, ``gather`` and ``process_mean`` give every process
  the one-process bits, over two processes and over four; ``replicate``
  gives every process of a line its first process's copy.
- The ring across two processes, both impls, every layout: bit for bit
  the one-process ring at the same n (2 and 4), forward and gradients, and
  within ``tests/test_torch_ring_attention.py``'s tolerances of JAX's
  ``jnp`` ring at n 2.
- ``lm_launch --sp 2`` over two processes bit for bit ``--sp 2`` in one
  (each process feeds the whole batch, and the ring's pairs are the same
  bits); ``--dp 2 --sp 2`` over four within ``LM_LIMITS["float32"]`` of one
  process (the mean of two half-batch gradients is the batch's up to
  float32 rounding); the pair from the flax ``w0`` within
  ``LM_LIMITS["float32"]`` of the JAX package's one-process
  ``lm_launch --dp 1 --sp 2``.
- ``mesh_launch`` EASGD and ``--opt syncdp`` at ``--dp 1 --shard 2`` over
  two processes and ``--dp 2 --shard 2`` over four against one process at
  the same ``dp`` and ``shard`` (bit for bit; sync-DP over four within
  ``LOSS_RTOL``, its gradient the mean of two half batches) and against
  the JAX package's one-process ``mesh_launch`` within ``LOSS_RTOL``; the
  checkpoint of a ``--shard 2`` pair in the one-process layout, resumed by
  one process on the pair's bits.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import mpit_tpu_torch.train.lm_launch as tlm
import mpit_tpu_torch.train.mesh_launch as tmesh
from mpit_tpu.data.mnist import load_mnist as jax_load_mnist
from mpit_tpu.models import MnistLinear
from mpit_tpu.models import flatten_module as jax_flatten
from mpit_tpu.models.transformer import TinyDecoder as JaxTinyDecoder
from mpit_tpu.models.transformer import default_attn as jax_default_attn
from mpit_tpu.parallel import ring_attention as jax_ring_attention
from mpit_tpu.parallel import sp_mesh as jax_sp_mesh
from mpit_tpu.train.lm_launch import LM_LAUNCH_DEFAULTS as JAX_LM_DEFAULTS
from mpit_tpu.train.lm_launch import run as jax_lm_run
from mpit_tpu.train.mesh_launch import MESH_LAUNCH_DEFAULTS as JAX_MESH_DEFAULTS
from mpit_tpu.train.mesh_launch import run as jax_mesh_run
from mpit_tpu.utils.platform import default_devices
from mpit_tpu_torch.data.mnist import load_mnist
from mpit_tpu_torch.models.flat import FlatModel, flatten_module, value_and_grad_nll
from mpit_tpu_torch.models.mnist import make_model
from mpit_tpu_torch.parallel import (
    Mesh, ProcessGroup, ep_moe, make_mesh, pipeline, process_local_rows, tp_mlp,
    tp_self_attention)
from mpit_tpu_torch.parallel.mesh import _line_groups, check_split, process_boxes
from mpit_tpu_torch.utils.checkpoint import load_state_dict

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_VARS = ("MPIT_COORDINATOR", "MPIT_NUM_PROCESSES", "MPIT_PROCESS_ID", "MPIT_HOSTFILE")
CHILD_TIMEOUT_S = 300
LOSS_RTOL = 1e-5  # tests/test_torch_multiproc.py's
N_TEST = 270  # optdigits fixture: 15% of 1797
FWD_ATOL, GRAD_ATOL = 3e-5, 5e-5  # tests/test_torch_ring_attention.py's
TINY = dict(seq_len=256, d_model=32, n_heads=4, n_layers=1, batch=8,
            attn_dtype="float32", steps=6, log_every=1, lr=1e-3)  # test_torch_lm.py's
MNIST = dict(side=8, batch=32, lr=0.1, mom=0.9, epochs=2)


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _children(argvs, timeout=CHILD_TIMEOUT_S):
    """Run one fresh interpreter a command line, side by side; each must
    exit 0 within ``timeout``.  Returns their standard outputs."""
    env = {k: v for k, v in os.environ.items() if k not in GROUP_VARS}
    env.update(PYTHONPATH=REPO, MPIT_LOG_STREAM="stderr", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(argv, cwd=REPO, env=env, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for argv in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"process failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


# -- the layout ----------------------------------------------------------------

# (axes, processes, process, its ranges, the rows of a batch of 8 it feeds)
CUTS = [
    (dict(dp=1, sp=2), 2, 1, dict(dp=(0, 1), sp=(1, 2)), (0, 8)),
    (dict(sp=4), 2, 1, dict(sp=(2, 4)), None),
    (dict(dp=2, sp=2), 4, 2, dict(dp=(1, 2), sp=(0, 1)), (4, 8)),
    (dict(dp=1, shard=2), 2, 0, dict(dp=(0, 1), shard=(0, 1)), (0, 8)),
    (dict(dp=2, shard=2), 4, 3, dict(dp=(1, 2), shard=(1, 2)), (4, 8)),
]


@pytest.mark.parametrize("axes, processes, pid, ranges, rows", CUTS)
def test_box_cuts_are_accepted(axes, processes, pid, ranges, rows):
    """Each of the five cuts passes ``check_split``; the process holds its
    box, an axis spans where its range is not the whole axis, and it
    feeds the rows of its ``dp`` ranges (the whole batch where ``dp`` lies
    in it)."""
    check_split(axes, processes)
    mesh = Mesh("cpu", ProcessGroup(pid, processes, None, "cpu"), **axes)
    for axis, (lo, hi) in ranges.items():
        assert mesh.local_slice(axis) == slice(lo, hi), axis
        assert mesh.local_size(axis) == hi - lo
        assert mesh.spans(axis) == (hi - lo < axes[axis])
    if rows is not None:
        assert process_local_rows(mesh, 8) == slice(*rows)
    with pytest.raises(RuntimeError, match="before the process group formed"):
        mesh.line(next(a for a in axes if mesh.spans(a)))


def test_make_mesh_over_four_processes():
    """``make_mesh(dp=2, shard=2)`` over four processes: process 1 holds
    dp rank 0 and shard rank 1; ``dp`` left unset is one a process."""
    mesh = make_mesh(dp=2, shard=2, device="cpu", group=ProcessGroup(1, 4, None, "cpu"))
    assert (mesh.local_slice("dp"), mesh.local_slice("shard")) == (slice(0, 1), slice(1, 2))
    assert make_mesh(shard=2, device="cpu",
                     group=ProcessGroup(3, 4, None, "cpu")).shape == {"dp": 4, "shard": 2}


def held_layout(axes, processes, boxes, lines):
    """Each process's box of ``axes`` over ``processes``, its mesh's box
    and spanning axes, and each spanning axis's lines (process ids)."""
    check_split(axes, processes)
    assert process_boxes(axes, processes) == boxes
    assert _line_groups(boxes, sorted(lines)) == lines
    for pid, box in enumerate(boxes):
        mesh = Mesh("cpu", ProcessGroup(pid, processes, None, "cpu"), **axes)
        assert mesh.box == box
        assert {a for a in axes if mesh.spans(a)} == set(lines)


@pytest.mark.parametrize("axes, processes, exc, match", [
    (dict(dp=3, sp=2), 2, ValueError,
     r"process 0's block, flat ranks \[0, 3\).*\(0, 0\), \(0, 1\), \(1, 0\).*not a box"),
    (dict(dp=2, shard=3), 4, ValueError, "dp=2 x shard=3 does not split over 4 processes"),
    # tp, pp and ep, which refused to span processes until they ran across
    # them: each process's box and each spanning axis's lines
    (dict(tp=2), 2, None, ([{"tp": (0, 1)}, {"tp": (1, 2)}], {"tp": [[0, 1]]})),
    (dict(dp=1, pp=4), 2, None, ([{"dp": (0, 1), "pp": (0, 2)}, {"dp": (0, 1), "pp": (2, 4)}],
                                 {"pp": [[0, 1]]})),
    (dict(dp=2, ep=2), 4, None, ([{"dp": (0, 1), "ep": (0, 1)}, {"dp": (0, 1), "ep": (1, 2)},
                                  {"dp": (1, 2), "ep": (0, 1)}, {"dp": (1, 2), "ep": (1, 2)}],
                                 {"dp": [[0, 2], [1, 3]], "ep": [[0, 1], [2, 3]]})),
])
def test_cuts_that_refuse(axes, processes, exc, match):
    """A grid that ``P`` does not divide and a block that is not a box
    refuse, in ``check_split`` and in ``Mesh``; a ``tp``, ``pp`` or ``ep``
    axis across processes no longer does (``exc`` None: ``match`` holds
    the boxes and the lines)."""
    if exc is None:
        held_layout(axes, processes, *match)
        return
    with pytest.raises(exc, match=match):
        check_split(axes, processes)
    with pytest.raises(exc, match=match):
        Mesh("cpu", ProcessGroup(0, processes, None, "cpu"), **axes)


@pytest.mark.parametrize("build", [
    lambda mesh: (tp_mlp(mesh, "sp"), ((2, 3, 8), (8, 8), (8,), (8, 8), (8,))),
    lambda mesh: (tp_self_attention(mesh, "sp"), ((1, 8, 16), (16, 3, 2, 8), (2, 8, 16))),
    lambda mesh: (lambda w, xs: pipeline(mesh, lambda p, x: x @ p["w"], "sp")({"w": w}, xs),
                  ((2, 4, 4), (3, 1, 4))),
    lambda mesh: (ep_moe(mesh, "sp"), ((2, 4), (4, 2), (2, 4, 4), (2, 4), (2, 4, 4), (2, 4))),
])
def test_tp_pp_ep_over_an_axis_across_processes_refuse(build):
    """Tensor, pipeline and expert parallelism refused an axis that spans
    processes until they ran across them: each entry point now builds
    over one, and its call needs the line's sub-group, so before the
    process group forms it raises rather than compute this process's
    ranks alone."""
    mesh = Mesh("cpu", ProcessGroup(0, 2, None, "cpu"), dp=1, sp=2)
    assert mesh.spans("sp")
    fn, shapes = build(mesh)
    with pytest.raises(RuntimeError, match="before the process group formed"):
        fn(*(torch.zeros(shape) for shape in shapes))


# -- collectives over the lines of each axis ----------------------------------

COLLECTIVES_CHILD = """
import sys, torch
from mpit_tpu_torch.parallel import (allreduce_mean, bootstrap, gather, process_mean,
    ps_pull, ps_push, ps_pushpull, psum, replicate, ring_shift)
from mpit_tpu_torch.parallel.mesh import Mesh
from mpit_tpu_torch.parallel.distributed import shutdown
port, pid, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
pg = bootstrap(coordinator="127.0.0.1:" + port, num_processes=world, process_id=pid,
               device="cpu")
g = torch.Generator().manual_seed(7)
eq = torch.equal
checks = {}

def shifts(name, axes, axis):
    # one hop of two stacks at once, both directions, forward and backward
    mesh, one = Mesh("cpu", pg, **axes), Mesh("cpu", **axes)
    n, rows = axes[axis], mesh.local_slice(axis)
    fulls = [torch.randn(n, 3, 5, generator=g), torch.randn(n, 2, generator=g)]
    cots = [torch.randn(f.shape, generator=g) for f in fulls]
    for reverse in (False, True):
        mine = [f[rows].clone().requires_grad_() for f in fulls]
        ours = ring_shift(mesh, axis, reverse=reverse)(*mine)
        sum((y * c[rows]).sum() for y, c in zip(ours, cots)).backward()
        whole = [f.clone().requires_grad_() for f in fulls]
        theirs = ring_shift(one, axis, reverse=reverse)(*whole)
        sum((y * c).sum() for y, c in zip(theirs, cots)).backward()
        checks[f"{name}_ring_shift_{'back' if reverse else 'fwd'}"] = all(
            eq(a, b[rows]) and eq(x.grad, w.grad[rows])
            for a, b, x, w in zip(ours, theirs, mine, whole))
    single = ring_shift(mesh, axis)(fulls[0][rows].clone())
    checks[f"{name}_ring_shift_one"] = eq(single, torch.roll(fulls[0], 1, 0)[rows])

def reductions(name, axes, axis):
    mesh, one = Mesh("cpu", pg, **axes), Mesh("cpu", **axes)
    rows = mesh.local_slice(axis)
    full = torch.randn(axes[axis], 10, generator=g)
    checks[f"{name}_gather"] = eq(gather(mesh, axis)(full[rows].clone()), full)
    checks[f"{name}_psum"] = eq(psum(mesh, axis)(full[rows]), psum(one, axis)(full))
    checks[f"{name}_allreduce_mean"] = eq(allreduce_mean(mesh, axis)(full[rows]),
                                          allreduce_mean(one, axis)(full)[rows])

def shards(name, axes):
    mesh, one = Mesh("cpu", pg, **axes), Mesh("cpu", **axes)
    n, dp = axes["shard"], axes["dp"]
    rows, dps = mesh.local_slice("shard"), mesh.local_slice("dp")
    p_full = torch.randn(n, 6, generator=g)
    grad = torch.randn(n * 6, generator=g)
    workers = torch.randn(dp, n * 6, generator=g)
    checks[f"{name}_ps_pull"] = eq(ps_pull(mesh)(p_full[rows].clone()), ps_pull(one)(p_full))
    checks[f"{name}_ps_push"] = eq(ps_push(mesh)(grad), ps_push(one)(grad)[rows])
    checks[f"{name}_ps_push_dp"] = eq(ps_push(mesh, reduce_axis="dp")(workers[dps]),
                                      ps_push(one, reduce_axis="dp")(workers)[rows])
    add = lambda p, gr: p + gr
    flat, mine = ps_pushpull(mesh, add)(p_full[rows].clone(), grad)
    flat1, all1 = ps_pushpull(one, add)(p_full, grad)
    checks[f"{name}_ps_pushpull"] = eq(flat, flat1) and eq(mine, all1[rows])

def means(name, axes):
    # the dp line's mean: the processes of one dp row hold the same tensor
    mesh = Mesh("cpu", pg, **axes)
    full = torch.randn(axes["dp"], 7, generator=g)
    mine = full[mesh.local_slice("dp")].sum(0)  # one tensor a process, its dp rows'
    got = process_mean(mesh)(mine)
    parts = [full[i * mesh.local_size("dp"):(i + 1) * mesh.local_size("dp")].sum(0)
             for i in range(axes["dp"] // mesh.local_size("dp"))]
    want = parts[0]
    for p in parts[1:]:
        want = want + p
    checks[f"{name}_process_mean"] = eq(got, want / len(parts))

def replicas(name, axes, axis, want):
    # every process of a line takes its first process's copy
    got = replicate(Mesh("cpu", pg, **axes), axis)(torch.full((3,), float(pid)))
    checks[f"{name}_replicate"] = eq(got, torch.full((3,), float(want)))

if world == 2:
    replicas("dp1_sp2", dict(dp=1, sp=2), "sp", 0)
    replicas("dp2_sp1", dict(dp=2, sp=1), "sp", pid)
    shifts("dp1_sp2", dict(dp=1, sp=2), "sp")
    shifts("sp4", dict(sp=4), "sp")
    reductions("sp4", dict(sp=4), "sp")
    reductions("dp1_shard2", dict(dp=1, shard=2), "shard")
    shards("dp1_shard2", dict(dp=1, shard=2))
    shards("dp4_shard1", dict(dp=4, shard=1))
    means("dp1_sp2", dict(dp=1, sp=2))
else:
    replicas("dp2_sp2_sp", dict(dp=2, sp=2), "sp", pid // 2 * 2)
    replicas("dp2_sp2_dp", dict(dp=2, sp=2), "dp", pid % 2)
    shifts("dp2_sp2_sp", dict(dp=2, sp=2), "sp")
    shifts("dp2_sp2_dp", dict(dp=2, sp=2), "dp")
    reductions("dp2_sp2_dp", dict(dp=2, sp=2), "dp")
    reductions("dp2_sp2_sp", dict(dp=2, sp=2), "sp")
    shards("dp2_shard2", dict(dp=2, shard=2))
    means("dp2_sp2", dict(dp=2, sp=2))
    means("dp4_sp2", dict(dp=4, sp=2))
print("CHECKS", sorted(checks.items()))
assert all(checks.values()), checks
shutdown()
"""


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_over_lines_are_the_one_process_bits(world):
    """Over two processes (sp 2 one rank each, sp 4 two each, shard 2) and
    over four (dp 2 x sp 2, whose dp line of process 0 is processes 0 and
    2, and dp 2 x shard 2): every collective gives every process the
    one-process collective's bits, the ring shift's gradients too, and
    ``replicate`` gives each line its first process's copy."""
    port = str(_free_ports(1)[0])
    outs = _children([[sys.executable, "-c", COLLECTIVES_CHILD, port, str(pid), str(world)]
                      for pid in range(world)])
    for out in outs:
        assert "CHECKS" in out and "False" not in out, out


# -- ring attention across two processes ---------------------------------------

B, L, H, D = 2, 64, 2, 16
RING_CASES = [("contiguous", False), ("contiguous", True), ("zigzag", True)]

RING_CHILD = """
import sys, numpy as np, torch
from mpit_tpu_torch.parallel import bootstrap, ring_attention
from mpit_tpu_torch.parallel.mesh import Mesh
from mpit_tpu_torch.parallel.distributed import shutdown
port, pid, out_file = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
pg = bootstrap(coordinator="127.0.0.1:" + port, num_processes=2, process_id=pid, device="cpu")
rng = np.random.default_rng(0)
qkv = [(rng.normal(size=(2, 64, 2, 16)) * 0.5).astype(np.float32) for _ in range(3)]

def run(mesh, impl, layout, causal):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in qkv)
    out = ring_attention(mesh, causal=causal, impl=impl, layout=layout)(q, k, v)
    (out ** 2).sum().backward()
    return [out.detach()] + [t.grad for t in (q, k, v)]

saved, same = {{}}, {{}}
for n in (2, 4):
    mesh, one = Mesh("cpu", pg, sp=n), Mesh("cpu", sp=n)
    for impl in ("plain", "flash"):
        for layout, causal in {cases!r}:
            key = f"{{n}}_{{impl}}_{{layout}}_{{causal}}"
            ours, theirs = run(mesh, impl, layout, causal), run(one, impl, layout, causal)
            same[key] = all(torch.equal(a, b) for a, b in zip(ours, theirs))
            for name, t in zip(("out", "dq", "dk", "dv"), ours):
                saved[f"{{key}}_{{name}}"] = t.numpy()
np.savez(out_file.format(pid=pid), **saved)
print("SAME", sorted(same.items()))
assert all(same.values()), same
shutdown()
""".format(cases=RING_CASES)


@pytest.fixture(scope="module")
def ring_pair(tmp_path_factory):
    """Both impls and every layout at n 2 and 4 over two processes; each
    process checks its bits against the one-process ring and saves its
    outputs and gradients."""
    out = str(tmp_path_factory.mktemp("ring") / "ring_{pid}.npz")
    port = str(_free_ports(1)[0])
    _children([[sys.executable, "-c", RING_CHILD, port, str(pid), out] for pid in (0, 1)])
    return [dict(np.load(out.format(pid=pid))) for pid in (0, 1)]


def test_ring_across_two_processes_is_the_one_process_ring(ring_pair):
    """Both processes hold the same bits, which are the one-process ring's
    (each child asserts that, for every impl, layout and n)."""
    a, b = ring_pair
    assert sorted(a) == sorted(b) and len(a) == 2 * 2 * len(RING_CASES) * 4
    for key in a:
        assert np.array_equal(a[key], b[key]), key


@functools.lru_cache(maxsize=None)
def _jax_ring(layout, causal):
    """JAX's ``jnp`` ring at n 2 on the children's inputs: the output and
    the gradients of sum(out**2), as numpy."""
    rng = np.random.default_rng(0)
    q, k, v = ((rng.normal(size=(B, L, H, D)) * 0.5).astype(np.float32) for _ in range(3))
    fn = jax_ring_attention(jax_sp_mesh(default_devices()[:2]), causal=causal, impl="jnp",
                            layout=layout)
    return [np.asarray(jax.jit(fn)(q, k, v))] + [np.asarray(g) for g in jax.jit(jax.grad(
        lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2)))(q, k, v)]


@pytest.mark.parametrize("impl", ["plain", "flash"])
@pytest.mark.parametrize("layout, causal", RING_CASES)
def test_ring_across_two_processes_matches_jax(ring_pair, impl, layout, causal):
    """n 2 over two processes against JAX's ``jnp`` ring on two CPU
    devices: atol 3e-5 forward, 5e-5 gradients."""
    want = _jax_ring(layout, causal)
    got = ring_pair[0]
    for name, w in zip(("out", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(got[f"2_{impl}_{layout}_{causal}_{name}"], w,
                                   atol=FWD_ATOL if name == "out" else GRAD_ATOL)


# -- the launchers over a group: every run of a list in one set of children ---------

# One process of a group: each run of the JSON list is a launcher's CLI
# (``main``) over a group of its own (its own port), from the flax w0 in
# the run's ``w0`` file where one is given; one RESULT line a run.
GROUP_CHILD = """
import json, sys
import numpy as np
import torch
from mpit_tpu_torch.models.flat import FlatModel
from mpit_tpu_torch.train import lm_launch, mesh_launch
torch.set_num_threads(1)
runs, pid, world = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
for run in runs:
    mod = lm_launch if run["module"] == "lm" else mesh_launch
    real = mod.flatten_module
    if run["w0"]:
        w0 = np.load(run["w0"])["w0"]
        def from_jax(module, seed, device="cpu"):
            spec = real(module, seed, device)
            return FlatModel(spec.module, spec.from_jax_params(w0).to(device))
        mod.flatten_module = from_jax
    try:
        res = mod.main(run["argv"] + ["--device", "cpu", "--num_processes", world,
                                      "--process_id", pid,
                                      "--coordinator", "127.0.0.1:%d" % run["port"]])
    finally:
        mod.flatten_module = real
    res.pop("state")
    print("RESULT " + json.dumps(res), flush=True)
"""


def _group_runs(world, runs):
    """Every run of ``runs`` (``module`` "mesh" or "lm", ``argv``, ``w0``
    file or "") over a group of ``world`` processes, one set of children
    running them in turn: per run, every process's result."""
    spec = [dict(r, port=port) for r, port in zip(runs, _free_ports(len(runs)))]
    outs = _children([[sys.executable, "-c", GROUP_CHILD, json.dumps(spec), str(pid),
                       str(world)] for pid in range(world)])
    results = [[json.loads(ln[len("RESULT "):]) for ln in out.splitlines()
                if ln.startswith("RESULT ")] for out in outs]
    return [[results[pid][i] for pid in range(world)] for i in range(len(runs))]


def _cli(kw):
    return [a for k, v in kw.items() for a in (f"--{k}", str(v))]


def _flax_linear_w0(path):
    """The JAX package's flax init of the linear model at side 8, seed 1."""
    (x, _, _, _), _ = jax_load_mnist(side=8)
    flat = jax_flatten(MnistLinear(num_classes=10), jax.random.PRNGKey(1), jnp.asarray(x[:2]))
    np.savez(path, w0=np.asarray(flat.w0))
    return str(path)


def _flax_lm_w0(path):
    """The flax init of TinyDecoder at ``TINY``'s widths, as
    ``tests/test_torch_lm.py`` draws it (seed 1)."""
    model = JaxTinyDecoder(attn_fn=jax_default_attn(causal=True, use_flash=False), vocab=256,
                           d_model=TINY["d_model"], n_heads=TINY["n_heads"],
                           n_layers=TINY["n_layers"], max_len=TINY["seq_len"])
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, TINY["seq_len"]), jnp.int32))
    w0 = np.asarray(ravel_pytree(params["params"])[0])
    np.savez(path, w0=w0)
    return str(path), w0


def _one(module, kw, w0=""):
    """A launcher's CLI in this process on the CPU, from the flax w0 in
    ``w0`` where one is given."""
    mod = tlm if module == "lm" else tmesh
    real = mod.flatten_module
    if w0:
        flat_w0 = np.load(w0)["w0"]

        def from_jax(module, seed, device="cpu"):
            spec = real(module, seed, device)
            return FlatModel(spec.module, spec.from_jax_params(flat_w0).to(device))

        mod.flatten_module = from_jax
    try:
        return mod.main(_cli(kw) + ["--device", "cpu"])
    finally:
        mod.flatten_module = real


def _curve(res):
    return [(h["epoch"], h["avg_loss"], h["test_err"]) for h in res["history"]]


def _states(path, prefix="mesh"):
    return load_state_dict(path / f"{prefix}_latest.npz")[0]


def _states_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].shape == b[key].shape and np.array_equal(a[key], b[key]), key


def _within_jax(results, ref):
    for res in results:
        assert len(res["history"]) == len(ref["history"])
        for p, r in zip(res["history"], ref["history"]):
            assert p["epoch"] == r["epoch"]
            np.testing.assert_allclose(p["avg_loss"], r["avg_loss"], rtol=LOSS_RTOL)
            assert abs(p["test_err"] - r["test_err"]) <= 1.0 / N_TEST + 1e-7


def _width_keeps_bits(model, wide, narrow):
    """The one-process control (``tests/test_torch_multiproc.py``'s, at
    these widths): whether the per-worker gradients and losses of the
    first ``narrow`` rows are the same bits in a ``vmap`` over ``wide``
    rows and over those rows alone, at one intra-op thread.  At side 8 the
    CNN's batched convolution gives one row other bits than two."""
    (x, y, _, _), _ = load_mnist(side=8)
    xb = torch.as_tensor(x[:32 * wide].reshape(wide, 32, -1), dtype=torch.float32)
    yb = torch.as_tensor(y[:32 * wide].reshape(wide, 32).astype(np.int64))
    flat = flatten_module(make_model(model, 8), 1, "cpu")
    vg = torch.func.vmap(value_and_grad_nll(flat))
    w = flat.w0.expand(wide, -1).clone()
    (lw, gw), (ln, gn) = vg(w, xb, yb), vg(w[:narrow], xb[:narrow], yb[:narrow])
    return torch.equal(gw[:narrow], gn) and torch.equal(lw[:narrow], ln)


def _states_close(a, b):
    """K1's tolerances (``chip_smoke.py``'s ``K1_RTOL``, ``K1_ATOL``), for
    rows whose bits move with the ``vmap`` width alone."""
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-6, err_msg=key)


EASGD = dict(MNIST, opt="easgd", su=2, mva=0.2)
SYNCDP = dict(MNIST, opt="syncdp", lr=0.2)
LAYOUTS = {2: dict(dp=1, shard=2), 4: dict(dp=2, shard=2)}


@pytest.mark.parametrize("world", [2, 4])
def test_easgd_across_shard(world, tmp_path, monkeypatch):
    """EASGD at ``--dp 1 --shard 2`` over two processes and ``--dp 2
    --shard 2`` over four: every process reports the one-process run's
    history at the same ``dp`` and ``shard``, and the checkpoints (the
    one-process layout, gathered to process 0) hold its state: bit for bit
    where the ``vmap`` width control keeps the rows' bits (the linear
    model, from the flax w0, and the CNN over two processes, each holding
    the one ``dp`` row), else within K1's tolerances (the CNN over four,
    one row a process against two); the linear model within ``LOSS_RTOL``
    of the JAX package's one-process ``mesh_launch`` on ``dp x shard``
    mesh devices."""
    w0 = _flax_linear_w0(tmp_path / "w0.npz")
    runs = {"linear": dict(EASGD, model="linear", **LAYOUTS[world]),
            "cnn": dict(EASGD, model="cnn", epochs=1, **LAYOUTS[world])}
    group = _group_runs(world, [
        dict(module="mesh", w0=w0 if model == "linear" else "",
             argv=_cli(dict(kw, ckpt_dir=str(tmp_path / f"group_{model}"))))
        for model, kw in runs.items()])
    for (model, kw), results in zip(runs.items(), group):
        one = _one("mesh", dict(kw, ckpt_dir=str(tmp_path / f"one_{model}")),
                   w0 if model == "linear" else "")
        exact = _width_keeps_bits(model, kw["dp"], 1)
        for res in results:
            assert res["processes"] == world and res["backend"] == "gloo"
            assert res["mesh"] == LAYOUTS[world] == one["mesh"]
            assert res["steps"] == one["steps"]
            assert _curve(res) == _curve(results[0])
            if exact:
                assert _curve(res) == _curve(one), model
            for (_, lp, tp), (_, lo, to) in zip(_curve(res), _curve(one)):
                assert abs(lp - lo) <= 1e-5 * abs(lo) and abs(tp - to) <= 1.0 / N_TEST + 1e-7
        held = _states_equal if exact else _states_close
        held(_states(tmp_path / f"group_{model}"), _states(tmp_path / f"one_{model}"))
    assert _width_keeps_bits("linear", 2, 1)
    monkeypatch.setenv("MPIT_FUSED", "1")
    monkeypatch.setenv("MPIT_MESH_DEVICES", str(world))
    ref = jax_mesh_run(JAX_MESH_DEFAULTS.merged(runs["linear"]))
    assert ref["mesh"] == LAYOUTS[world]
    _within_jax(group[0], ref)


@pytest.mark.parametrize("world", [2, 4])
def test_syncdp_across_shard(world, tmp_path, monkeypatch):
    """``--opt syncdp``, the velocity's shards with their owners: over two
    processes (each the whole batch) bit for bit one process at ``--dp 1
    --shard 2``, checkpoint included; over four (each half the batch, the
    ``dp`` line's mean) within ``LOSS_RTOL``; within ``LOSS_RTOL`` of the
    JAX package's one-process run.  The pair's checkpoint is the
    one-process layout (``vt`` whole); the pair resumes it to four epochs
    (each process takes its owned columns) and one process resumes it on
    the same bits."""
    w0 = _flax_linear_w0(tmp_path / "w0.npz")
    kw = dict(SYNCDP, model="linear", **LAYOUTS[world])
    runs = [dict(module="mesh", w0=w0, argv=_cli(dict(kw, ckpt_dir=str(tmp_path / "group"))))]
    resume = dict(kw, epochs=4, resume=str(tmp_path / "group" / "mesh_latest.npz"))
    if world == 2:
        runs.append(dict(module="mesh", w0=w0, argv=_cli(dict(
            resume, ckpt_dir=str(tmp_path / "group_resumed")))))
    group = _group_runs(world, runs)
    one = _one("mesh", dict(kw, ckpt_dir=str(tmp_path / "one")), w0)
    for res in group[0]:
        assert res["processes"] == world and res["mesh"] == LAYOUTS[world]
        assert _curve(res) == _curve(group[0][0])
        for p, r in zip(res["history"], one["history"]):
            np.testing.assert_allclose(p["avg_loss"], r["avg_loss"], rtol=LOSS_RTOL)
            assert abs(p["test_err"] - r["test_err"]) <= 1.0 / N_TEST + 1e-7
    saved = _states(tmp_path / "group")
    assert {k: v.shape for k, v in saved.items()} == {"w": (650,), "vt": (650,), "k": ()}
    if world == 2:
        assert _curve(group[0][0]) == _curve(one)
        _states_equal(saved, _states(tmp_path / "one"))
        alone = _one("mesh", dict(resume, ckpt_dir=str(tmp_path / "one_resumed")), w0)
        assert [h["epoch"] for h in alone["history"]] == [2, 3]
        for res in group[1]:
            assert _curve(res) == _curve(alone)
        _states_equal(_states(tmp_path / "group_resumed"), _states(tmp_path / "one_resumed"))
    monkeypatch.setenv("MPIT_FUSED", "1")
    monkeypatch.setenv("MPIT_MESH_DEVICES", str(world))
    _within_jax(group[0], jax_mesh_run(JAX_MESH_DEFAULTS.merged(kw)))


def _lm_limits_hold(got, want, w0):
    """``LM_LIMITS["float32"]`` of ``chip_smoke.py`` on the final w and vt
    (within 1e-6, the gap's norm within 1e-3 of the change's)."""
    for key in ("w", "vt"):
        gap = np.asarray(got[key]) - np.asarray(want[key])
        change = np.asarray(want[key]) - (w0 if key == "w" else 0.0)
        assert np.abs(gap).max() <= 1e-6, key
        assert np.linalg.norm(gap) <= 1e-3 * np.linalg.norm(change), key


def _lm_losses(res):
    return [h["avg_loss"] for h in res["history"]]


@pytest.mark.parametrize("world", [2, 4])
def test_lm_across_sp(world, tmp_path, monkeypatch):
    """``lm_launch --sp 2 --layout zigzag`` over two processes (one ``sp``
    rank each, both feeding the whole batch) is ``--sp 2`` in one process
    bit for bit: losses, and w, vt and k in the checkpoint; and within
    ``LM_LIMITS["float32"]`` of the JAX package's one-process ``--dp 1
    --sp 2`` from the same flax w0.  ``--dp 2 --sp 2`` over four (each
    process one rank of each axis, half the batch) within
    ``LM_LIMITS["float32"]`` of one process: the mean of the ``dp`` line's
    two half-batch gradients is the batch's up to float32 rounding."""
    w0_file, w0 = _flax_lm_w0(tmp_path / "w0.npz")
    kw = dict(TINY, dp=world // 2, sp=2, layout="zigzag", steps=6 if world == 2 else 4)
    kw["ckpt_every"] = kw["steps"]
    (results,) = _group_runs(world, [dict(module="lm", w0=w0_file, argv=_cli(
        dict(kw, ckpt_dir=str(tmp_path / "group"))))])
    one = _one("lm", dict(kw, ckpt_dir=str(tmp_path / "one")), w0_file)
    for res in results:
        assert res["processes"] == world and res["backend"] == "gloo"
        assert res["mesh"] == {"dp": world // 2, "sp": 2}
        assert res["tokens_trained"] == one["tokens_trained"]
        assert _lm_losses(res) == _lm_losses(results[0])
    got, want = _states(tmp_path / "group", "lm"), _states(tmp_path / "one", "lm")
    assert int(got["k"]) == kw["steps"]
    if world == 2:
        assert _lm_losses(results[0]) == _lm_losses(one)
        _states_equal(got, want)
        monkeypatch.setenv("MPIT_MESH_DEVICES", "2")
        ref = jax_lm_run(JAX_LM_DEFAULTS.merged(kw, compile_cache=0,
                                                ckpt_dir=str(tmp_path / "jax")))
        assert ref["mesh"] == {"dp": 1, "sp": 2}
        np.testing.assert_allclose(_lm_losses(results[0]), _lm_losses(ref), rtol=1e-5, atol=0)
        want = _states(tmp_path / "jax", "lm")
    np.testing.assert_allclose(_lm_losses(results[0]), _lm_losses(one), rtol=1e-5, atol=0)
    _lm_limits_hold(got, want, w0)


@pytest.mark.parametrize("plong", [650, 653])
def test_syncdp_owned_columns_cover_the_padded_vector(plong):
    """Over a ``shard`` of 3 that spans three processes, the owned columns
    of processes 0, 1 and 2, in order, are the vector padded to a multiple
    of 3 (``pad_shards``'s cut); each a view where nothing is padded."""
    from mpit_tpu_torch.parallel import SyncDataParallel
    from mpit_tpu_torch.parallel.collective import pad_shards

    x = torch.arange(plong, dtype=torch.float32)
    parts = []
    for pid in range(3):
        mesh = make_mesh(dp=1, shard=3, device="cpu", group=ProcessGroup(pid, 3, None, "cpu"))
        trainer = SyncDataParallel(mesh, lambda w, xb, yb: None, tlm.MSGDConfig(0.1, 0.9))
        cols = trainer.owned(x)
        shares = cols.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
        assert shares == (plong % 3 == 0)
        parts.append(cols)
    assert torch.equal(torch.cat(parts), pad_shards(x, 3)[0])
    assert trainer.init(x)["vt"].shape == parts[-1].shape
