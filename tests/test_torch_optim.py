"""The port's optimizers against the reference's, formula for formula.

The same params and gradients (numpy, a fixed seed) go through
``repro.optim`` and ``repro_torch.optim`` for 5 steps.  Tolerance 1e-7
absolute on the params (about an ulp of their magnitude): both compute
in float32 in the same order, the bias corrections from ``t = step + 1``
in float32, but the power and the square root are each library's own.
Adafactor (1-D, 2-D and stacked 3-D leaves, under a constant rate and
the warmup-cosine schedule) adds reductions, its row and column means,
whose order is each library's own: its factored state is held at 3e-7
relative (measured 2.2e-7 after 5 steps) and its params at that bar plus
one float32 ulp of the param (rtol 1.2e-7; measured one ulp at lr 0.1).
The schedule is held at 1e-7 relative (the cosine is each library's
own), and the global-norm clip at 1e-7 relative.
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


def _run(jopt, topt, seed, rtol=0.0):
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
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                       atol=1e-7)
    return js, ts


def _leaves(tree):
    return toptim.tree_leaves(tree)


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


def _states_close(js, ts, rtol):
    jl, tl = jax.tree.leaves(js), _leaves(ts)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                   atol=0)


@pytest.mark.parametrize("lr", ["const", "schedule"])
def test_adafactor_matches_reference(lr):
    """1-D ``b``, 2-D ``w`` and the stacked 3-D ``layer_1/w`` (its
    leading dim kept, the two trailing dims factored)."""
    if lr == "const":
        jopt, topt = joptim.adafactor(0.1), toptim.adafactor(0.1)
    else:
        jopt = joptim.adafactor(joptim.warmup_cosine_schedule(0.1, 2, 5))
        topt = toptim.adafactor(toptim.warmup_cosine_schedule(0.1, 2, 5))
    js, ts = _run(jopt, topt, seed=7, rtol=1.2e-7)
    assert set(ts["layer_1"]["w"]) == {"row", "col"}
    assert tuple(ts["layer_1"]["w"]["row"].shape) == (5, 2)
    assert tuple(ts["layer_1"]["w"]["col"].shape) == (5, 3)
    assert set(ts["layer_0"]["b"]) == {"v"}
    _states_close(js, ts, rtol=3e-7)


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 7), (0, 5)])
def test_warmup_cosine_schedule_matches_reference(warmup, total):
    """Steps 0, warmup - 1, warmup, the midpoint of the decay and past the
    end, as float32 host scalars."""
    js = joptim.warmup_cosine_schedule(3e-4, warmup, total)
    ts = toptim.warmup_cosine_schedule(3e-4, warmup, total)
    for step in (0, max(warmup - 1, 0), warmup, (warmup + total) // 2,
                 total, total + 5):
        got = ts(step)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        want = float(js(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(float(got), want, rtol=1e-7, atol=0)


@pytest.mark.parametrize("scale", [10.0, 0.01])
def test_clip_by_global_norm_matches_reference(scale):
    """Above the bar (scaled down to norm 1) and below it (unchanged), on
    a tree of dicts and lists."""
    rng = np.random.default_rng(int(scale * 100))
    tree = {"a": (scale * rng.normal(size=(4, 3))).astype(np.float32),
            "pattern": [{"w": (scale * rng.normal(size=(2, 5))).astype(
                np.float32)}], "b": np.float32(scale) * np.ones(
                    (3,), np.float32)}
    want = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    got = toptim.clip_by_global_norm(_to_torch(tree), 1.0)
    for a, b in zip(jax.tree.leaves(want), _leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-7,
                                   atol=0)
    if scale < 1:
        for a, b in zip(jax.tree.leaves(tree), _leaves(got)):
            np.testing.assert_array_equal(b.numpy(), a)


def test_make_optimizer_covers_the_registry():
    from repro.optim.optimizers import REGISTRY as JREG
    assert list(toptim.REGISTRY) == list(JREG)
    for name in toptim.REGISTRY:
        jopt = joptim.make_optimizer(name, 1e-2)
        topt = toptim.make_optimizer(name, 1e-2)
        assert topt.name == jopt.name
    _run(joptim.make_optimizer("adafactor", 1e-2, decay=0.5),
         toptim.make_optimizer("adafactor", 1e-2, decay=0.5), seed=9,
         rtol=1.2e-7)


def test_exports_match_reference():
    assert set(joptim.__all__) <= set(toptim.__all__)
    assert set(toptim.__all__) - set(joptim.__all__) == {
        "REGISTRY", "tree_leaves", "tree_map"}


def test_tree_map_walks_lists_and_tuples():
    tree = {"pattern": [{"w": 1, "b": 2}, {"w": 3}], "tail": (4, 5), "x": 6}
    got = toptim.tree_map(lambda a, b: a + b, tree, tree)
    assert got == {"pattern": [{"w": 2, "b": 4}, {"w": 6}], "tail": [8, 10],
                   "x": 12}
    assert toptim.tree_leaves(tree) == [2, 1, 3, 4, 5, 6]    # keys sorted
    assert toptim.tree_map(lambda a: a, ()) == []
