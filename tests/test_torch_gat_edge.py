"""K5's plain version (what ``gat_edge_partial_cuda`` runs on CPU
tensors), its oracle and ``gat_aggregate`` against the reference: the
Pallas kernel in interpret mode and the jnp oracle, at the reference's
shapes and bars (tests/test_kernels_gat_edge.py: 1e-5 on m and l, 1e-4
on acc), and ``gat_aggregate`` head by head against the port's own GAT
layer on flickr-sim (1e-5 of max |out|: the layer normalises before its
SpMM, the split form merges two online partials).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.gat_edge import gat_aggregate as jgat_aggregate
from repro.kernels.gat_edge import gat_edge_partial_pallas
from repro.kernels.gat_edge import gat_edge_partial_ref as jpartial_ref
from repro_torch.core import digest as tdigest
from repro_torch.graph import make_dataset
from repro_torch.kernels.gat_edge import (gat_aggregate,
                                          gat_edge_partial_cuda,
                                          gat_edge_partial_plain,
                                          gat_edge_partial_ref,
                                          merge_partials)
from repro_torch.models import gnn as tgnn
from repro_torch.nn import init_params
from torch_gat_cases import INF_ROW, NAN_ROW, NO_VALID, bits, edge_case

STAT_TOL = dict(atol=1e-5, rtol=1e-5)
ACC_TOL = dict(atol=1e-4, rtol=1e-4)


def _case(rng, rows, deg, ncols, feat, guard=True):
    """The reference test's inputs; ``guard`` gives every row a valid
    first edge (the reference's assertions exclude degenerate rows)."""
    nbr = rng.integers(0, ncols + 1, size=(rows, deg)).astype(np.int32)
    valid = (rng.random((rows, deg)) > 0.3) & (nbr < ncols)
    if guard:
        valid[:, 0] = True
        nbr[:, 0] = rng.integers(0, ncols, size=rows)
    s_dst = rng.normal(size=(rows,)).astype(np.float32)
    s_src = rng.normal(size=(ncols + 1,)).astype(np.float32)
    z = rng.normal(size=(ncols + 1, feat)).astype(np.float32)
    z[-1] = 0
    return nbr, valid, s_dst, s_src, z


def _t(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _check_partial(got, want):
    for name, g, w, tol in zip(("acc", "m", "l"), got, want,
                               (ACC_TOL, STAT_TOL, STAT_TOL)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **tol)


@pytest.mark.parametrize("rows,deg,ncols,feat", [
    (128, 8, 64, 128), (256, 4, 200, 128), (128, 1, 10, 256),
])
def test_gat_partial_matches_pallas(rows, deg, ncols, feat):
    args = _case(np.random.default_rng(rows), rows, deg, ncols, feat)
    want = gat_edge_partial_pallas(*map(jnp.asarray, args), interpret=True)
    _check_partial(gat_edge_partial_cuda(*_t(args)), want)
    _check_partial(gat_edge_partial_plain(*_t(args)), want)
    _check_partial(gat_edge_partial_ref(*_t(args)),
                   jpartial_ref(*map(jnp.asarray, args)))


@pytest.mark.parametrize("seed", range(6))
def test_gat_partial_ragged_shapes(seed):
    """Row and feature counts the reference's 128-divisible guard refuses,
    against its oracle."""
    rng = np.random.default_rng(100 + seed)
    rows, deg, ncols, feat = (int(rng.integers(1, 300)),
                              int(rng.integers(1, 12)),
                              int(rng.integers(2, 120)),
                              int(rng.integers(1, 70)))
    args = _case(rng, rows, deg, ncols, feat)
    _check_partial(gat_edge_partial_cuda(*_t(args)),
                   jpartial_ref(*map(jnp.asarray, args)))


def test_rows_without_valid_edges_follow_the_kernel():
    """A row with no valid edge keeps the kernel's online state (m =
    -1e30, l = deg, acc = the sum of its gathered rows), as the Pallas
    kernel does; the merge weighs it by 0 beside a valid partial."""
    args = list(_case(np.random.default_rng(3), 128, 5, 30, 128,
                      guard=False))
    args[1][:7] = False
    want = gat_edge_partial_pallas(*map(jnp.asarray, args), interpret=True)
    got = gat_edge_partial_plain(*_t(args))
    _check_partial(got, want)
    assert got[1][0] == np.float32(-1e30) and float(got[2][0]) == 5.0


def _online_loop(nbr, valid, s_dst, s_src, z):
    """The plain version as it was before its two-phase form: m, l and
    acc updated together, slot by slot (the TPU kernel's fori_loop)."""
    rows, deg = nbr.shape
    idx = nbr.long()
    m = torch.full((rows,), -1e30)
    l = torch.zeros((rows,))
    acc = torch.zeros((rows, z.shape[1]))
    for k in range(deg):
        col = idx[:, k]
        e = s_dst + s_src.index_select(0, col)
        e = torch.where(e >= 0, e, 0.2 * e)
        e = torch.where(valid[:, k], e, -1e30)
        m_new = torch.maximum(m, e)
        alpha = torch.exp(m - m_new)
        p = torch.exp(e - m_new)
        l = alpha * l + p
        acc = acc * alpha[:, None] + p[:, None] * z.index_select(0, col)
        m = m_new
    return acc, m, l


@pytest.mark.parametrize("kind", ["masked", "nan_score", "inf_z"])
@pytest.mark.parametrize("deg", [0, 1, 31, 32, 33, 129, 300])
def test_plain_two_phase_equals_online_loop(kind, deg):
    """The two-phase plain version (running max by ``cummax``, alpha and p
    at once, then the ordered l / acc chain) equals the online loop bit
    for bit in acc, m and l, NaN positions included: across 32-slot groups
    and 128-slot segments, rows with no or only late valid slots, a NaN
    score at a valid slot and an Inf / NaN z row behind an invalid slot."""
    args = _t(edge_case(kind, deg))
    got = gat_edge_partial_plain(*args)
    want = _online_loop(*args)
    for name, g, w in zip(("acc", "m", "l"), got, want):
        assert torch.equal(bits(g), bits(w)), name
    acc, m, l = got
    if deg:
        assert bool((m[NO_VALID:NO_VALID + 3] == -1e30).all())
        assert bool((l[NO_VALID:NO_VALID + 3] == deg).all())
    if deg and kind == "nan_score":
        assert bool(m[NAN_ROW].isnan()) and bool(l[NAN_ROW].isnan())
    if deg and kind == "inf_z":
        assert bool(acc[INF_ROW].isnan().any())


@pytest.mark.parametrize("kind", ["nan_score", "inf_z"])
@pytest.mark.parametrize("deg", [1, 33])
def test_nan_and_inf_follow_the_pallas_kernel(kind, deg):
    """The NaN-score and Inf-z cases against the Pallas kernel in interpret
    mode: m and l NaN where a valid slot's score is NaN (``jnp.maximum``
    carries NaN), and acc NaN exactly where the reference has it."""
    args = edge_case(kind, deg)
    want = gat_edge_partial_pallas(*map(jnp.asarray, args), interpret=True)
    got = gat_edge_partial_cuda(*_t(args))
    for g, w in zip(got, want):
        assert np.array_equal(g.isnan().numpy(), np.isnan(np.asarray(w)))
    _check_partial(got, want)
    if kind == "nan_score":
        assert np.isnan(np.asarray(want[1])[NAN_ROW])
        assert bool(got[1][NAN_ROW].isnan()) and bool(got[2][NAN_ROW].isnan())
    else:
        assert np.isnan(np.asarray(want[0])[INF_ROW]).any()


def test_split_merge_equals_joint_softmax():
    rng = np.random.default_rng(0)
    rows, deg, ncols, feat = 64, 6, 40, 32
    nbr = rng.integers(0, ncols, size=(rows, 2 * deg)).astype(np.int32)
    valid = np.ones((rows, 2 * deg), bool)
    s_dst = rng.normal(size=(rows,)).astype(np.float32)
    s_src = rng.normal(size=(ncols + 1,)).astype(np.float32)
    z = rng.normal(size=(ncols + 1, feat)).astype(np.float32)
    acc, _, l = gat_edge_partial_ref(*_t((nbr, valid, s_dst, s_src, z)))
    joint = acc / l[:, None]
    for fn in (gat_edge_partial_ref, gat_edge_partial_cuda):
        parts = [fn(*_t((nbr[:, i * deg:(i + 1) * deg],
                         valid[:, i * deg:(i + 1) * deg], s_dst, s_src, z)))
                 for i in range(2)]
        torch.testing.assert_close(merge_partials(parts), joint,
                                   atol=1e-5, rtol=1e-5)


def test_gat_aggregate_matches_reference():
    rng = np.random.default_rng(1)
    rows, deg, nloc, nhalo, feat = 128, 4, 60, 30, 128
    in_nbr, in_valid, s_dst, s_loc, z_loc = _case(rng, rows, deg, nloc,
                                                  feat)
    out_nbr, out_valid, _, s_halo, z_halo = _case(rng, rows, deg, nhalo,
                                                  feat)
    args = (in_nbr, in_valid, out_nbr, out_valid, s_dst, s_loc, s_halo,
            z_loc, z_halo)
    want = jgat_aggregate(*map(jnp.asarray, args), backend="jnp")
    for backend in ("auto", "jnp"):
        got = gat_aggregate(*_t(args), backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACC_TOL)
    with pytest.raises(ValueError, match="backend"):
        gat_aggregate(*_t(args), backend="pallas")


def test_gat_partial_refuses_bad_inputs():
    args = _t(_case(np.random.default_rng(2), 8, 3, 5, 4))
    for i, bad in ((0, args[0].long()), (1, args[1].int()),
                   (2, args[2].double()), (4, args[4].double())):
        with pytest.raises(TypeError):
            gat_edge_partial_cuda(*args[:i], bad, *args[i + 1:])
    with pytest.raises(ValueError):
        gat_edge_partial_cuda(args[0], args[1], args[2][:-1], *args[3:])
    with pytest.raises(ValueError):
        gat_edge_partial_cuda(*args[:4], args[4].t())


@functools.lru_cache(maxsize=None)
def _flickr():
    g = make_dataset("flickr-sim", scale=0.1, seed=2)
    return g, tdigest.prepare_graph_data(g, 4, seed=0, device="cpu")


def gat_heads_by_k5(p, x_local, x_halo, struct):
    """The GAT layer's aggregation through ``gat_aggregate``, one call per
    head: the layer's ``s_dst``, padded ``src_loc``/``src_out`` and
    ``z_loc``/``z_out`` (models/gnn.py::_gat_layer) as K5's inputs."""
    S, H = x_local.shape[0], x_halo.shape[0]
    z_loc = tgnn._pad_sentinel(torch.einsum("sd,dhk->shk", x_local, p["w"]))
    z_out = torch.einsum("sd,dhk->shk", tgnn._pad_sentinel(x_halo), p["w"])
    s_dst = torch.einsum("shk,hk->sh", z_loc[:S], p["a_dst"])
    src_loc = torch.einsum("shk,hk->sh", z_loc, p["a_src"])
    src_out = torch.einsum("shk,hk->sh", z_out, p["a_src"])
    in_nbr, out_nbr = struct["in_nbr"], struct["out_nbr"]
    return torch.stack([gat_aggregate(
        in_nbr, in_nbr < S, out_nbr, out_nbr < H,
        s_dst[:, h].contiguous(), src_loc[:, h].contiguous(),
        src_out[:, h].contiguous(), z_loc[:, h].contiguous(),
        z_out[:, h].contiguous()) for h in range(p["a_src"].shape[0])], 1)


@pytest.mark.parametrize("layer", [0, 1])
def test_gat_aggregate_equals_gat_layer_per_head(layer):
    g, data = _flickr()
    cfg = tgnn.GNNConfig(model="gat", num_layers=2,
                         in_dim=g.features.shape[1], hidden_dim=32,
                         num_classes=int(g.labels.max()) + 1, heads=4)
    p = init_params(tgnn.gnn_specs(cfg), torch.Generator().manual_seed(0),
                    "cpu")[f"layer_{layer}"]
    p["b"] = torch.randn(p["b"].shape, generator=torch.Generator()
                         .manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    din = p["w"].shape[0]
    for m in range(data["local_ids"].shape[0]):
        st = {k: v[m] for k, v in data["struct"].items()}
        S, H = st["in_nbr"].shape[0], data["halo_ids"].shape[1]
        x_local = torch.randn((S, din), generator=gen)
        x_halo = torch.randn((H, din), generator=gen)
        want = tgnn.gnn_layer(cfg, p, x_local, x_halo, st) - p["b"]
        got = gat_heads_by_k5(p, x_local, x_halo, st)
        want = want.reshape(got.shape)
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (m, err)
