"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on the same numpy inputs, and the reference's own
MoE properties (tests/test_moe.py) held on the port.

Tolerances: 1e-5 of max |out| in fp32 (matrix products of another
library, sums in another order; measured ~1e-7).  bf16 expert inputs:
both sides take bf16 products summed in fp32 and round the hidden
activation to bf16 once, so an element whose two fp32 sums straddle a
bf16 rounding boundary differs by one bf16 ulp (2^-8 relative) there;
2^-7 of max |out| bounds what such elements carry to the output.  The
routing, the capacity path's dispatch and drops are integer work and
equal exactly; the inputs are continuous random values, so no two router
logits of a token tie (``torch.topk`` and ``jax.lax.top_k`` may order
ties differently).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_arch as jget
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.nn import init_params as jinit
from repro_torch.configs import get_smoke_arch as tget
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.nn import params_from_numpy

REL = 1e-5


def _params(rng, d, e, ff):
    """The reference test's parameters (tests/test_moe.py::_params)."""
    return {"router": rng.normal(size=(d, e)).astype(np.float32),
            "w_gate": (rng.normal(size=(e, d, ff)) * 0.1).astype(np.float32),
            "w_up": (rng.normal(size=(e, d, ff)) * 0.1).astype(np.float32),
            "w_down": (rng.normal(size=(e, ff, d)) * 0.1).astype(np.float32)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_batched_matches_reference(dtype):
    rng = np.random.default_rng(0)
    p = _params(rng, 16, 4, 32)
    xs = rng.normal(size=(4, 6, 16)).astype(np.float32)
    jx = jnp.asarray(xs).astype(dtype)
    tx = torch.from_numpy(xs).to(getattr(torch, dtype))
    want = jmoe._expert_ffn_batched(jx, *(jnp.asarray(p[k]) for k in
                                          ("w_gate", "w_up", "w_down")))
    got = tmoe._expert_ffn_batched(tx, *(torch.from_numpy(p[k]) for k in
                                         ("w_gate", "w_up", "w_down")))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) < (REL if dtype == "float32" else 2.0 ** -7)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_matches_reference(k):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(40, 16)).astype(np.float32)
    router = rng.normal(size=(16, 8)).astype(np.float32)
    jw, jids, jlog = jmoe._route(jnp.asarray(x), jnp.asarray(router), k)
    tw, tids, tlog = tmoe._route(torch.from_numpy(x),
                                 torch.from_numpy(router), k)
    assert tids.dtype == torch.int32
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("e,k", [(4, 1), (8, 2)])
def test_load_balance_loss_matches_reference(e, k):
    rng = np.random.default_rng(e + k)
    logits = rng.normal(size=(200, e)).astype(np.float32)
    ids = np.argsort(-logits, axis=1)[:, :k].astype(np.int32)
    want = jmoe.load_balance_loss(jnp.asarray(logits), jnp.asarray(ids), e)
    got = tmoe.load_balance_loss(torch.from_numpy(logits),
                                 torch.from_numpy(ids), e)
    assert abs(float(got) - float(want)) < 1e-6


@pytest.mark.parametrize("e,k", [(2, 1), (4, 2), (8, 3)])
def test_moe_ref_matches_reference(e, k):
    rng = np.random.default_rng(10 * e + k)
    jp, tp = _both(_params(rng, 16, e, 32))
    x = rng.normal(size=(2, 8, 16)).astype(np.float32)
    want = jmoe.moe_ref(jnp.asarray(x), jp, k)
    got = tmoe.moe_ref(torch.from_numpy(x), tp, k)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) < REL


@pytest.mark.parametrize("shard_idx,num_shards", [(0, 1), (0, 2), (1, 2),
                                                  (3, 4)])
@pytest.mark.parametrize("capacity", [1, 3, 24])
def test_moe_local_matches_reference(shard_idx, num_shards, capacity):
    """One shard's experts at capacities that drop most, some and none
    of the assignments (the reference's per-device computation, called
    with a plain shard index)."""
    rng = np.random.default_rng(capacity + 7 * shard_idx + num_shards)
    p = _params(rng, 16, 8, 32)
    e_loc = 8 // num_shards
    lo = shard_idx * e_loc
    x = rng.normal(size=(24, 16)).astype(np.float32)
    local = {k: p[k][lo:lo + e_loc] for k in ("w_gate", "w_up", "w_down")}
    kw = dict(k=2, num_experts=8, shard_idx=shard_idx,
              num_shards=num_shards, capacity_per_expert=capacity)
    want = jmoe._moe_local(jnp.asarray(x), jnp.asarray(p["router"]),
                           *(jnp.asarray(local[k]) for k in
                             ("w_gate", "w_up", "w_down")), **kw)
    got = tmoe._moe_local(torch.from_numpy(x), torch.from_numpy(p["router"]),
                          *(torch.from_numpy(local[k]) for k in
                            ("w_gate", "w_up", "w_down")), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=REL * float(np.abs(want).max()) + 1e-30)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_ep_matches_reference(capacity_factor, k):
    """The capacity path at factors that drop (0.5, 1.25) and that do not
    (4.0 = E), and moe_ffn's three impls."""
    rng = np.random.default_rng(int(capacity_factor * 4) + k)
    jp, tp = _both(_params(rng, 16, 4, 32))
    x = rng.normal(size=(4, 12, 16)).astype(np.float32)
    want = jmoe.moe_ep(jnp.asarray(x), jp, k,
                       capacity_factor=capacity_factor)
    got = tmoe.moe_ep(torch.from_numpy(x), tp, k,
                      capacity_factor=capacity_factor)
    assert got.shape == want.shape
    assert _rel(got, want) < REL
    for impl in ("auto", "ref", "ep"):
        want = jmoe.moe_ffn(jnp.asarray(x), jp, k, impl=impl,
                            capacity_factor=capacity_factor)
        got = tmoe.moe_ffn(torch.from_numpy(x), tp, k, impl=impl,
                           capacity_factor=capacity_factor)
        assert _rel(got, want) < REL, impl


def test_moe_ep_is_deterministic_and_combines_in_order():
    """Two runs of the capacity path equal bit for bit, and its combine
    equals a sequential scatter-add (``index_add_`` on the CPU visits the
    rows in order) bit for bit."""
    rng = np.random.default_rng(5)
    _, tp = _both(_params(rng, 16, 8, 32))
    x = torch.from_numpy(rng.normal(size=(4, 16, 16)).astype(np.float32))
    a = tmoe.moe_ep(x, tp, 3, capacity_factor=1.0)
    b = tmoe.moe_ep(x, tp, 3, capacity_factor=1.0)
    assert torch.equal(a, b)
    t, k, d = 50, 3, 8
    tok = torch.from_numpy(rng.integers(0, t + 1, size=(6, 20)))
    # At most k rows a token below t, any number of drop-slot rows.
    seen = {}
    for i, v in enumerate(tok.reshape(-1).tolist()):
        if v < t and seen.setdefault(v, 0) >= k:
            tok.view(-1)[i] = t
        elif v < t:
            seen[v] += 1
    contrib = torch.from_numpy(rng.normal(size=(120, d)).astype(np.float32))
    want = torch.zeros((t + 1, d)).index_add_(0, tok.reshape(-1),
                                              contrib)[:t]
    assert torch.equal(tmoe._combine(tok.reshape(-1), contrib, t, k), want)


def test_moe_ep_refuses_a_mesh():
    rng = np.random.default_rng(0)
    _, tp = _both(_params(rng, 16, 4, 32))
    with pytest.raises(NotImplementedError, match="item 8e"):
        tmoe.moe_ep(torch.zeros((1, 4, 16)), tp, 1, mesh=object())


# ---------------------------------------------------------------------------
# The reference's properties (tests/test_moe.py), on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,k,seed", [(2, 1, 0), (2, 2, 1), (4, 1, 2),
                                      (4, 3, 3), (8, 2, 4), (8, 3, 5)])
def test_capacity_path_matches_dropless(e, k, seed):
    rng = np.random.default_rng(seed)
    _, tp = _both(_params(rng, 16, e, 32))
    x = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    ref = tmoe.moe_ref(x, tp, k)
    out = tmoe.moe_ep(x, tp, k, capacity_factor=float(e))
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


def test_low_capacity_drops_but_stays_close():
    rng = np.random.default_rng(0)
    _, tp = _both(_params(rng, 32, 4, 64))
    x = torch.from_numpy(rng.normal(size=(4, 32, 32)).astype(np.float32))
    ref = tmoe.moe_ref(x, tp, 2)
    out = tmoe.moe_ep(x, tp, 2, capacity_factor=1.25)
    corr = float(torch.corrcoef(torch.stack([out.reshape(-1),
                                             ref.reshape(-1)]))[0, 1])
    assert corr > 0.9


def test_gradients_flow_to_router_and_experts():
    rng = np.random.default_rng(1)
    _, tp = _both(_params(rng, 16, 4, 32))
    x = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    loss = torch.sum(tmoe.moe_ep(x, leaves, 2, capacity_factor=4.0) ** 2)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for key, g in zip(leaves, grads):
        assert float(g.abs().max()) > 0, key


def test_load_balance_loss_prefers_uniform():
    e, t = 4, 1000
    rng = np.random.default_rng(0)
    uniform = torch.from_numpy(rng.normal(size=(t, e)) * 0.01)
    skewed = uniform.clone()
    skewed[:, 0] += 10.0
    lu = float(tmoe.load_balance_loss(
        uniform, torch.argmax(uniform, -1)[:, None].int(), e))
    ls = float(tmoe.load_balance_loss(
        skewed, torch.argmax(skewed, -1)[:, None].int(), e))
    assert ls > lu
    assert abs(lu - 1.0) < 0.2     # E·Σ f·p ≈ 1 at uniform


@pytest.mark.parametrize("name", ["llama4_scout_17b_a16e", "kimi_k2_1t_a32b"])
def test_aux_moe_loss_matches_reference(name):
    jcfg, tcfg = jget(name), tget(name)
    jp = jinit(jax.random.PRNGKey(0), jt.arch_specs(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 24))
    want = jt.aux_moe_loss(jcfg, jp, jnp.asarray(toks, jnp.int32))
    got = tt.aux_moe_loss(tcfg, tp, torch.from_numpy(toks))
    assert abs(float(got) - float(want)) < 1e-6
    dense = dataclasses.replace(tcfg, num_experts=0)
    assert float(tt.aux_moe_loss(dense, tp, torch.from_numpy(toks))) == 0.0
