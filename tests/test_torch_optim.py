"""The port's optimizers against the reference's, formula for formula.

The same params and gradients (numpy, a fixed seed) go through
``repro.optim`` and ``repro_torch.optim`` for 5 steps.  Tolerance 1e-7
absolute on the params (about an ulp of their magnitude): both compute
in float32 in the same order, the bias corrections from ``t = step + 1``
in float32, but the power and the square root are each library's own.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import optim as joptim
from repro_torch import optim as toptim

STEPS = 5


def _tree(rng):
    return {"layer_0": {"w": rng.normal(size=(6, 5)).astype(np.float32),
                        "b": rng.normal(size=(5,)).astype(np.float32)},
            "layer_1": {"w": rng.normal(size=(5, 2, 3)).astype(np.float32)}}


def _to_torch(tree):
    return toptim.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _run(jopt, topt, seed):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _to_torch(params)
    ts = topt.init(tp)
    for step in range(STEPS):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, grads[step]), js, jp,
                             jnp.asarray(step, jnp.int32))
        tp, ts = topt.update(_to_torch(grads[step]), ts, tp, step)
        for a, b in zip(jax.tree.leaves(jp), _leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-7)
    return js, ts


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("lr", [5e-3, 1e-1])
def test_adam_matches_reference(lr):
    js, ts = _run(joptim.adam(lr), toptim.adam(lr), seed=int(lr * 1000))
    for a, b in zip(jax.tree.leaves(js["m"]), _leaves(ts["m"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-7)
    for a, b in zip(jax.tree.leaves(js["v"]), _leaves(ts["v"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=0)


def test_adamw_matches_reference():
    _run(joptim.adamw(1e-2, weight_decay=0.05),
         toptim.adamw(1e-2, weight_decay=0.05), seed=3)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    _run(joptim.sgd(0.1, momentum=momentum),
         toptim.sgd(0.1, momentum=momentum), seed=4)


def test_constant_schedule_is_float32():
    lr = toptim.constant_schedule(5e-3)(7)
    assert lr.dtype == torch.float32
    assert float(lr) == float(np.float32(5e-3))
