"""The port's shard rules against ``mpit_tpu.optim.rules``, step by step.

Each of the six rules runs four steps from the same numpy inputs in both
packages (the port in place, the JAX rules functionally) at the reference's
own tolerances for its stateful rules, rtol 1e-5 / atol 1e-6
(tests/test_ops.py): the port rounds every operation on its own, where XLA
may contract a multiply-add, and its ``pow`` may differ in the last place.
Adam runs its flat shard through K3's CPU twin (the wrapper's routing),
and JAX's through the Pallas kernel in interpret mode as well as through
the plain math; the add rule must agree bit for bit.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.optim import rules as jax_rules
from mpit_tpu_torch.optim import rules

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
STEPS = 4

HYPER = {
    "add": {},
    "rmsprop": {"lr": 1e-2, "decay": 0.95, "momentum": 0.9, "epsilon": 1e-4},
    "adam": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
    "adamax": {"lr": 2e-3},
    "adagrad": {"lr": 1e-2, "lrd": 1e-2},
    "adadelta": {"lr": 1.0, "rho": 0.9},
}


def _run_both(name, hp, shape, jax_extra=None):
    rng = np.random.default_rng(sum(map(ord, name)))
    p0 = rng.normal(size=shape).astype(np.float32)
    grads = [rng.normal(size=shape).astype(np.float32) for _ in range(STEPS)]
    jrule = jax_rules.make(name, **hp, **(jax_extra or {}))
    trule = rules.make(name, **hp)
    jp = jnp.asarray(p0)
    jst = jrule.init(jp)
    tp = torch.from_numpy(p0.copy())
    tst = trule.init(tp)
    for g in grads:
        jp, jst = jrule.apply(jp, jnp.asarray(g), jst)
        out, tst = trule.apply(tp, torch.from_numpy(g), tst)
        assert out is tp  # updated in place
    return (jp, jst), (tp, tst)


@pytest.mark.parametrize("name", ["add", "rmsprop", "adam", "adamax", "adagrad",
                                  "adadelta"])
@pytest.mark.parametrize("shape", [(1027,), (3, 5)])
def test_rule_matches_jax_over_steps(name, shape):
    (jp, jst), (tp, tst) = _run_both(name, HYPER[name], shape)
    if name == "add":
        assert np.array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL, atol=ATOL)
    assert set(tst) == set(jst)
    for key in jst:
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   rtol=RTOL, atol=ATOL)
        if key == "t":
            assert tst[key].dtype == torch.int32 and tst[key].dim() == 0


@pytest.mark.parametrize("step_div", [None, 3])
def test_adam_against_the_pallas_kernel(step_div):
    """JAX's Adam through its Pallas kernel (interpret mode), with either
    bias-correction exponent, against the port's (K3's twin on the CPU)."""
    hp = dict(HYPER["adam"], step_div=step_div)
    (jp, jst), (tp, tst) = _run_both("adam", hp, (4099,),
                                     jax_extra={"use_fused": True})
    for got, want in ((tp, jp), (tst["m"], jst["m"]), (tst["v"], jst["v"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert int(tst["t"]) == int(jst["t"]) == STEPS


def test_registry_matches_reference():
    assert rules.names() == jax_rules.names()
    assert rules.STATE_SLOTS == jax_rules.STATE_SLOTS
    for name in rules.names():
        state = rules.make(name).init(torch.zeros(6))
        vectors = [k for k, v in state.items() if v.shape == (6,)]
        assert len(vectors) == rules.STATE_SLOTS[name]
    with pytest.raises(ValueError, match="unknown rule"):
        rules.make("sgd")
    with pytest.raises(ValueError, match="no hyperparameter"):
        rules.make("adam", lr=1e-3, betta1=0.9)


_FIRST_USE_PROBE = r"""
import threading
import torch
import mpit_tpu_torch.optim.rules  # noqa: F401  (settles the CPU kernels)

out = []
gate = threading.Barrier(4)


def apply():
    gate.wait()
    t = torch.zeros((), dtype=torch.int32).add_(1)
    e = t.to(torch.float32)
    b1, b2 = 1.0 - torch.pow(0.9, e), 1.0 - torch.pow(0.999, e)
    out.append(float(1e-3 * torch.sqrt(b2) / b1).hex())


threads = [threading.Thread(target=apply) for _ in range(4)]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(" ".join(out))
"""


def test_adam_correction_is_exact_on_first_use_in_threads():
    """Adam's ``lr_t`` at ``t = 1``, computed at once by four threads of a
    fresh process that imported the rules: every thread gets the bits one
    thread gets alone, in each of 16 processes.  (Before the rules settled
    the CPU kernels at import, the first concurrent ``torch.sqrt`` read 1,400
    ulps off in about 1 process in 32.)"""
    import subprocess
    import sys

    want = float(1e-3 * torch.sqrt(1.0 - torch.pow(0.999, torch.ones(())))
                 / (1.0 - torch.pow(0.9, torch.ones(())))).hex()
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_USE_PROBE],
                              stdout=subprocess.PIPE, text=True) for _ in range(16)]
    got = [p.communicate(timeout=120)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert all(row == [want] * 4 for row in got), got


def test_adam_amplifies_a_gradient_gap_only_near_zero():
    """Adam's first step moves an element by ``lr * g / (|g| + eps')`` with
    ``eps' = eps / sqrt(1 - beta2)`` (3.2e-7): about ``lr`` wherever ``|g|``
    is well above ``eps'``, whatever ``g``, but with slope ``lr / eps'``
    (3,162 at lr 1e-3) at ``g = 0``.  So two devices whose gradients differ
    only by summation order, a gap far below the LM comparison's 1e-6, can
    move a near-zero element by more than 1e-6, while the same gap leaves a
    large element where it was: the mechanism that holds ``chip_smoke.py``'s
    LM Adam gang to a share of the largest change, not to 1e-6 absolute."""
    lr, gap = 1e-3, 2e-9
    g = torch.tensor([0.0, -1e-7, 1e-4, -1e-2, 0.5], dtype=torch.float32)

    def first_step(grad):
        p = torch.zeros_like(grad)
        rules.adam_apply(p, grad, rules.adam_init(p), lr=lr)
        return p

    base, moved = first_step(g), first_step(g + gap)
    step_gap = (moved - base).abs()
    eps_prime = 1e-8 / math.sqrt(1 - 0.999)
    assert float(step_gap[:2].min()) > 1e-6  # a 2e-9 gradient gap, near zero
    assert float(step_gap[:2].max()) <= lr * gap / eps_prime * 1.01  # the slope at 0
    assert float(step_gap[2:].max()) < 1e-8  # far from zero it vanishes
    assert float(base[2:].abs().min()) > 0.99 * lr  # each large element moves ~lr
    assert float(step_gap.max()) < 2.0**-7 * float(base.abs().max())
