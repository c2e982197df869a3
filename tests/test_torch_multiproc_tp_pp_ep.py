"""Tensor, pipeline and expert parallelism across the processes of a
``torch.distributed`` group, on the CPU over gloo: ``tp``, ``pp`` and
``ep`` cut as the JAX package cuts them over the devices of its mesh.

Two groups run every case: one pair of processes (``tp 4``, ``pp 4``,
``pp 2`` and ``ep 4`` over two, each process two ranks, or one stage of
the decoder's two) and one quartet (``dp 2 x tp 2`` over four: one rank
of each axis a process, two ``tp`` lines and two ``dp`` lines at once).
The children are fresh interpreters at one intra-op thread, each with its
own timeout and a free port on the loopback, as
``tests/test_torch_multiproc_axes.py`` starts them; they import only
``mpit_tpu_torch``, ``torch`` and ``numpy``.  Their inputs, drawn here from
a seed at ``tests/test_torch_tp_pp_ep.py``'s widths (and the JAX
``TinyDecoder``'s two blocks carried into the port's layout by the flat
converter), reach them as one ``.npz``; each runs every case over its
group and again in one process at the same ``n`` (virtual ranks), and
saves both.  Each case is held three ways:

1. against the port's one-process run at the same ``n``: the outputs and
   the whole weight gradients bit for bit (every rank's arithmetic is
   unchanged), the replicated inputs' gradients (the line's shares added
   in another order) within the grad atol 5e-5, every gap printed;
2. against the JAX package on its 8-device CPU mesh within
   ``tests/test_tp_pp_ep.py``'s atol: 2e-5 forward, 5e-5 gradients;
3. each replicated input's gradient is the JAX package's and not ``P``
   times it, and every process of a line ends with the same whole
   weight gradients.

A last case holds the differentiable ``psum``, ``copy_to_line`` and
``take_cuts`` themselves to the one-process gradients.
"""

import os
import socket
import subprocess
import sys

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
from mpit_tpu.parallel import pipeline as jax_pipeline
from mpit_tpu.parallel import stack_stage_params as jax_stack
from mpit_tpu.parallel import tp_mlp as jax_tp_mlp
from mpit_tpu.parallel import tp_self_attention as jax_tp_attention
from mpit_tpu.utils.platform import default_devices
from mpit_tpu_torch.models.flat import FlatModel, param_spec
from mpit_tpu_torch.models.transformer import TinyDecoder

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_VARS = ("MPIT_COORDINATOR", "MPIT_NUM_PROCESSES", "MPIT_PROCESS_ID", "MPIT_HOSTFILE")
CHILD_TIMEOUT_S = 300
FWD_ATOL, GRAD_ATOL = 2e-5, 5e-5  # tests/test_tp_pp_ep.py's
DEC = dict(d=32, heads=4, length=16, m=3, b=2)  # test_decoder_blocks_match_jax's

# case -> (the replicated input, the whole weights, the JAX mesh's axis and n)
CASES = {
    "tp_mlp": ("x", ("w1", "b1", "w2", "b2"), ("tp", 4)),
    "tp_attn": ("x", ("wqkv", "wo"), ("tp", 4)),
    "pp_tanh": ("xs", ("w", "b"), ("pp", 4)),
    "pp_decoder": ("xs", None, ("pp", 2)),  # every stacked leaf
    "ep_moe": ("x", ("gate", "w1", "b1", "w2", "b2"), ("ep", 4)),
}


def _arr(rng, *shape):
    return (rng.normal(size=shape) * 0.3).astype(np.float32)


def _decoder_blocks():
    """The JAX ``TinyDecoder``'s flax parameters (seed 5) and its two
    blocks in the port's layout, by the flat converter."""
    d, heads, length = DEC["d"], DEC["heads"], DEC["length"]
    jdec = JaxDecoder(vocab=16, d_model=d, n_heads=heads, n_layers=2, max_len=length)
    jparams = jdec.init(jax.random.PRNGKey(5), jnp.zeros((1, length), jnp.int32))["params"]
    module = TinyDecoder(vocab=16, d_model=d, n_heads=heads, n_layers=2, max_len=length)
    flat = FlatModel(module, torch.zeros(sum(int(np.prod(s)) for _, s in param_spec(module))))
    views = flat.unravel(flat.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams)))
    blocks = [{name[len(f"DecoderBlock_{i}."):]: t.numpy().copy() for name, t in views.items()
               if name.startswith(f"DecoderBlock_{i}.")} for i in range(2)]
    return jparams, blocks


def _inputs():
    """Every case's inputs, as one flat dict ``case/name -> array``."""
    rng = np.random.default_rng(21)
    d, h = 8, 32
    out = {"tp_mlp/x": _arr(rng, 2, 6, d), "tp_mlp/w1": _arr(rng, d, h),
           "tp_mlp/b1": _arr(rng, h), "tp_mlp/w2": _arr(rng, h, d), "tp_mlp/b2": _arr(rng, d)}
    b, length, d, heads = 2, 12, 64, 8  # head width 8: the kernels' least
    out.update({"tp_attn/x": _arr(rng, b, length, d),
                "tp_attn/wqkv": _arr(rng, d, 3, heads, d // heads),
                "tp_attn/wo": _arr(rng, heads, d // heads, d)})
    n, d, m, b = 4, 8, 4, 2
    out.update({"pp_tanh/w": _arr(rng, n, d, d), "pp_tanh/b": _arr(rng, n, d),
                "pp_tanh/xs": _arr(rng, m, b, d)})
    out["pp_decoder/xs"] = _arr(rng, DEC["m"], DEC["b"], DEC["length"], DEC["d"])
    blocks = _decoder_blocks()[1]
    for name in blocks[0]:
        out[f"pp_decoder/leaf/{name}"] = np.stack([blk[name] for blk in blocks])
    e, d, h = 8, 8, 8
    out.update({"ep_moe/x": _arr(rng, 2, 5, d), "ep_moe/gate": _arr(rng, d, e),
                "ep_moe/w1": _arr(rng, e, d, h), "ep_moe/b1": _arr(rng, e, h),
                "ep_moe/w2": _arr(rng, e, h, d), "ep_moe/b2": _arr(rng, e, d)})
    out["psum/blocks"] = _arr(rng, 4, 5, 3)
    out["psum/cot"] = _arr(rng, 5, 3)
    out["psum/whole"] = _arr(rng, 8, 8)
    return out


# One process of a group: every case over the group and in one process at
# the same n, both saved; the bit-for-bit checks made in the child too.
CHILD = r"""
import sys
import numpy as np
import torch
from mpit_tpu_torch.models.transformer import DecoderBlock
from mpit_tpu_torch.parallel import (Mesh, bootstrap, ep_moe, gather, pipeline,
    process_local_rows, psum, tp_mlp, tp_self_attention)
from mpit_tpu_torch.parallel.collective import copy_to_line, take_cuts
from mpit_tpu_torch.parallel.distributed import shutdown
torch.set_num_threads(1)
port, pid, world, inputs, out_file = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                      sys.argv[4], sys.argv[5])
pg = bootstrap(coordinator="127.0.0.1:" + port, num_processes=world, process_id=pid,
               device="cpu")
arrays = dict(np.load(inputs))
saved, same = {}, {}

def run(case, names, call, loss, rows=slice(None)):
    # the output and every input's gradient of loss(out); the first input
    # (the replicated one) cut to this process's dp rows
    ts = [torch.from_numpy(arrays[f"{case}/{k}"][rows if i == 0 else slice(None)].copy()
                           ).requires_grad_() for i, k in enumerate(names)]
    out = call(*ts)
    loss(out).backward()
    return [out.detach()] + [t.grad for t in ts]

def held(case, names, ours, theirs, replicated):
    # saves both; the outputs and the weights' grads must be the same bits
    for key, a, b in zip(["out"] + list(names), ours, theirs):
        saved[f"{case}/{key}"], saved[f"{case}/one_{key}"] = a.numpy(), b.numpy()
        if key != replicated:
            same[f"{case}/{key}"] = torch.equal(a, b)

sq = lambda out: (out ** 2).sum()

def tp_cases(mesh, one, tag, rows=slice(None)):
    names = ("x", "w1", "b1", "w2", "b2")
    held(f"tp_mlp{tag}", names, run("tp_mlp", names, tp_mlp(mesh), sq, rows),
         run("tp_mlp", names, tp_mlp(one), sq, rows), "x")
    names = ("x", "wqkv", "wo")
    attn = lambda m: tp_self_attention(m, causal=True)
    held(f"tp_attn{tag}", names, run("tp_attn", names, attn(mesh), sq, rows),
         run("tp_attn", names, attn(one), sq, rows), "x")

if world == 2:
    tp_cases(Mesh("cpu", pg, tp=4), Mesh("cpu", tp=4), "")

    tanh = lambda p, x: torch.tanh(x @ p["w"] + p["b"])
    def pipe(m, stage, keys):
        return lambda xs, *ls: pipeline(m, stage)(dict(zip(keys, ls)), xs)
    names = ("xs", "w", "b")
    held("pp_tanh", names, run("pp_tanh", names, pipe(Mesh("cpu", pg, pp=4), tanh, ("w", "b")), sq),
         run("pp_tanh", names, pipe(Mesh("cpu", pp=4), tanh, ("w", "b")), sq), "xs")

    keys = sorted(k[len("pp_decoder/leaf/"):] for k in arrays if k.startswith("pp_decoder/leaf/"))
    d = arrays["pp_decoder/xs"].shape[-1]
    block = DecoderBlock(d, 4)
    dec = lambda p, x: torch.func.functional_call(block, p, (x,))
    names = ("xs",) + tuple(f"leaf/{k}" for k in keys)
    mean = lambda out: (out ** 2).mean()
    held("pp_decoder", names, run("pp_decoder", names, pipe(Mesh("cpu", pg, pp=2), dec, keys), mean),
         run("pp_decoder", names, pipe(Mesh("cpu", pp=2), dec, keys), mean), "xs")

    names = ("x", "gate", "w1", "b1", "w2", "b2")
    held("ep_moe", names, run("ep_moe", names, ep_moe(Mesh("cpu", pg, ep=4)), sq),
         run("ep_moe", names, ep_moe(Mesh("cpu", ep=4)), sq), "x")

    # the collectives themselves: each block's, the input's and the whole
    # tensor's gradient, against one process
    mesh, one = Mesh("cpu", pg, tp=4), Mesh("cpu", tp=4)
    rows = mesh.local_slice("tp")
    blocks = torch.from_numpy(arrays["psum/blocks"])
    cot = torch.from_numpy(arrays["psum/cot"])
    mine = blocks[rows].clone().requires_grad_()
    whole = blocks.clone().requires_grad_()
    out, out1 = psum(mesh, "tp")(mine), psum(one, "tp")(whole)
    (out * cot).sum().backward()
    (out1 * cot).sum().backward()
    same["psum/out"] = torch.equal(out, out1)
    same["psum/grad"] = torch.equal(mine.grad, whole.grad[rows])
    same["psum/grad_is_cot"] = all(torch.equal(g, cot) for g in mine.grad)
    saved["psum/grad"] = mine.grad.numpy()
    x = torch.from_numpy(arrays["psum/cot"]).clone().requires_grad_()
    (copy_to_line(mesh, "tp")(x) * float(pid + 1)).sum().backward()
    same["copy_to_line/fwd_grad"] = torch.equal(x.grad, torch.full_like(x, 1.0 + 2.0))
    w = torch.from_numpy(arrays["psum/whole"]).clone().requires_grad_()
    v = torch.from_numpy(arrays["psum/whole"]).clone().requires_grad_()
    a, b = take_cuts(mesh, "tp", (1, 0))(w, v)
    same["take_cuts/fwd"] = (torch.equal(a, w.detach()[:, 4 * pid:4 * pid + 4])
                             and torch.equal(b, v.detach()[4 * pid:4 * pid + 4]))
    (a * (pid + 1)).sum().backward()
    want = torch.ones(8, 8)
    want[:, 4:] = 2.0
    same["take_cuts/grad"] = torch.equal(w.grad, want) and torch.equal(v.grad, torch.zeros(8, 8))
else:
    mesh = Mesh("cpu", pg, dp=2, tp=2)
    rows = process_local_rows(mesh, 2)
    tp_cases(mesh, Mesh("cpu", tp=2), "_dp2", rows)
    # the dp line's sum of the two halves' weight grads: the whole batch's
    for case, names in (("tp_mlp_dp2", ("w1", "b1", "w2", "b2")), ("tp_attn_dp2", ("wqkv", "wo"))):
        for key in names:
            g = torch.from_numpy(saved[f"{case}/{key}"])
            parts = gather(mesh, "dp")(g[None])
            saved[f"{case}/dpsum_{key}"] = (parts[0] + parts[1]).numpy()
np.savez(out_file.format(pid=pid), **saved)
print("SAME", sorted(same.items()))
assert all(same.values()), same
shutdown()
"""


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
            assert p.returncode == 0, f"process failed:\n{out[-2000:]}\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _group(tmp, world):
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **_inputs())
    out = str(tmp / f"out{world}_{{pid}}.npz")
    port = str(_free_ports(1)[0])
    _children([[sys.executable, "-c", CHILD, port, str(pid), str(world), inputs, out]
               for pid in range(world)])
    return [dict(np.load(out.format(pid=pid))) for pid in range(world)]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Every two-process case in one pair of children."""
    return _group(tmp_path_factory.mktemp("pair"), 2)


@pytest.fixture(scope="module")
def quartet(tmp_path_factory):
    """``dp 2 x tp 2`` over four children."""
    return _group(tmp_path_factory.mktemp("quartet"), 4)


def _jax_mesh(axis, n):
    return JaxMesh(np.array(default_devices()[:n]), (axis,))


_JAX = {}


def _jax(case, batch=slice(None)):
    """The JAX package's output and input gradients for ``case`` (of
    ``sum(out**2)``; the decoder's of ``mean(out**2)``), as numpy, keyed as
    the children save them."""
    key = (case, batch.start, batch.stop)
    if key in _JAX:
        return _JAX[key]
    a = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in _inputs().items()
         if k.startswith(case.split("_dp")[0] + "/")}
    if case.startswith("tp_mlp"):
        n = 2 if case.endswith("_dp2") else 4
        names = ("x", "w1", "b1", "w2", "b2")
        f = jax_tp_mlp(_jax_mesh("tp", n))
        args = [a["x"][batch]] + [a[k] for k in names[1:]]
    elif case.startswith("tp_attn"):
        n = 2 if case.endswith("_dp2") else 4
        names = ("x", "wqkv", "wo")
        f = jax_tp_attention(_jax_mesh("tp", n), causal=True)
        args = [a["x"][batch], a["wqkv"], a["wo"]]
    elif case == "pp_tanh":
        names = ("xs", "w", "b")
        pipe = jax_pipeline(_jax_mesh("pp", 4),
                            lambda p, x: jnp.tanh(x @ p["w"] + p["b"]))

        def f(xs, w, b):
            return pipe({"w": w, "b": b}, xs)

        args = [a["xs"], a["w"], a["b"]]
    elif case == "pp_decoder":
        jparams, _ = _decoder_blocks()
        jblock = JaxBlock(DEC["d"], DEC["heads"], attn_fn=jax_default_attn(use_flash=False))
        pipe = jax_pipeline(_jax_mesh("pp", 2),
                            lambda p, x: jblock.apply({"params": p}, x))
        stacked = jax_stack([jparams["DecoderBlock_0"], jparams["DecoderBlock_1"]])
        out = pipe(stacked, a["xs"])
        gxs, gst = jax.grad(lambda xs, st: jnp.mean(pipe(st, xs) ** 2), argnums=(0, 1))(
            a["xs"], stacked)
        res = {"out": np.asarray(out), "xs": np.asarray(gxs)}
        for path, g in jax.tree_util.tree_flatten_with_path(gst)[0]:
            res["leaf/" + ".".join(p.key for p in path)] = np.asarray(g)
        _JAX[key] = res
        return res
    else:
        names = ("x", "gate", "w1", "b1", "w2", "b2")
        f = jax_ep_moe(_jax_mesh("ep", 4))
        args = [a[k] for k in names]
    out = jax.jit(f)(*args)
    grads = jax.jit(jax.grad(lambda *xs: jnp.sum(f(*xs) ** 2),
                             argnums=tuple(range(len(args)))))(*args)
    res = {"out": np.asarray(out)}
    res.update({k: np.asarray(g) for k, g in zip(names, grads)})
    _JAX[key] = res
    return res


def _keys(saved, case):
    return sorted(k.split("/", 1)[1] for k in saved
                  if k.startswith(case + "/") and "/one_" not in k and "/dpsum_" not in k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_is_the_one_process_run(pair, case):
    """Over two processes, against the one-process run at the same ``n``:
    the output and every weight's whole gradient bit for bit (each child
    also asserts that), the replicated input's gradient within 5e-5."""
    replicated = CASES[case][0]
    for saved in pair:
        gaps = {}
        for key in _keys(saved, case):
            got, want = saved[f"{case}/{key}"], saved[f"{case}/one_{key}"]
            gaps[key] = float(np.abs(got - want).max())
            if key != replicated:
                assert np.array_equal(got, want), (case, key)
        print(case, "gaps to one process:", gaps)
        assert gaps[replicated] <= GRAD_ATOL, gaps


@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_matches_jax(pair, case):
    """Against the JAX package on its CPU mesh at the same ``n``: atol 2e-5
    forward, 5e-5 gradients, in both processes."""
    want = _jax(case)
    for saved in pair:
        keys = _keys(saved, case)
        assert sorted(want) == keys
        for key in keys:
            np.testing.assert_allclose(saved[f"{case}/{key}"], want[key],
                                       atol=FWD_ATOL if key == "out" else GRAD_ATOL,
                                       err_msg=f"{case}/{key}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_replicated_input_grad_is_not_p_times(pair, case):
    """The replicated input's gradient in each process is the JAX
    package's, and far from twice it (each process's share alone, or the
    whole counted once a process, would miss)."""
    replicated = CASES[case][0]
    want = _jax(case)[replicated]
    assert np.abs(want).max() > 100 * GRAD_ATOL
    for saved in pair:
        got = saved[f"{case}/{replicated}"]
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL)
        assert np.abs(got - 2 * want).max() > 100 * GRAD_ATOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_line_holds_one_whole_gradient(pair, case):
    """Both processes of the line end with the same bits: the output,
    every whole weight gradient and the input's gradient, each of the
    whole tensor's shape."""
    a, b = pair
    keys = _keys(a, case)
    assert keys == _keys(b, case)
    for key in keys:
        assert a[f"{case}/{key}"].shape == a[f"{case}/one_{key}"].shape
        assert np.array_equal(a[f"{case}/{key}"], b[f"{case}/{key}"]), key


def test_collectives_give_the_one_process_gradients(pair):
    """The differentiable ``psum`` gives each process's blocks the result's
    gradient (a slice of the gathered stack's cotangent, not the line's
    sum of it), ``copy_to_line`` adds the line's gradients, and
    ``take_cuts`` gives each whole tensor its whole gradient: each child
    asserts the bits, and both held the same ``psum`` output."""
    cot = _inputs()["psum/cot"]
    for saved in pair:
        assert np.array_equal(saved["psum/grad"], np.broadcast_to(cot, (2, *cot.shape)))


@pytest.mark.parametrize("case", ["tp_mlp", "tp_attn"])
def test_dp_tp_quartet_is_the_one_process_run(quartet, case):
    """``dp 2 x tp 2`` over four: each process's half batch (its ``dp``
    rows) through its ``tp`` line bit for bit the one-process ``tp 2`` run
    on those rows (output and whole weight grads), ``x``'s grad within
    5e-5; the two processes of a ``tp`` line hold the same bits, and the
    two ``dp`` rows differ."""
    name = f"{case}_dp2"
    weights = CASES[case][1]
    for saved in quartet:
        np.testing.assert_allclose(saved[f"{name}/x"], saved[f"{name}/one_x"], atol=GRAD_ATOL)
        for key in ("out",) + weights:
            assert np.array_equal(saved[f"{name}/{key}"], saved[f"{name}/one_{key}"]), key
    for key in ("out", "x") + weights:
        assert np.array_equal(quartet[0][f"{name}/{key}"], quartet[1][f"{name}/{key}"])
        assert np.array_equal(quartet[2][f"{name}/{key}"], quartet[3][f"{name}/{key}"])
    assert not np.array_equal(quartet[0][f"{name}/out"], quartet[2][f"{name}/out"])


@pytest.mark.parametrize("case", ["tp_mlp", "tp_attn"])
def test_dp_tp_quartet_matches_jax(quartet, case):
    """Against the JAX package's ``tp 2`` mesh on the whole batch: each
    process's output and ``x`` gradient rows within 2e-5 and 5e-5, and the
    ``dp`` line's sum of the two half batches' weight gradients within
    5e-5 in every process."""
    name = f"{case}_dp2"
    want = _jax(name)
    for pid, saved in enumerate(quartet):
        row = slice(pid // 2, pid // 2 + 1)
        np.testing.assert_allclose(saved[f"{name}/out"], want["out"][row], atol=FWD_ATOL)
        np.testing.assert_allclose(saved[f"{name}/x"], want["x"][row], atol=GRAD_ATOL)
        for key in CASES[case][1]:
            np.testing.assert_allclose(saved[f"{name}/dpsum_{key}"], want[key], atol=GRAD_ATOL,
                                       err_msg=key)
