"""The SpMM backward: the host-built transposed ELL, the two backward
kernels' plain versions against ``jax.vjp`` of the reference's
``spmm_ref`` on a real flickr-sim in-ELL, the autograd Function around K1
(its node, what it computes and which backward it runs), the halo
kernels' refusal of inputs that require grad, and the GAT layer's
gradients against ``jax.grad`` of the reference layer.

Tolerances: 1e-6 of the output's max |value| for the backward kernels,
which sum each output in a fixed sequential order where JAX's scatter-add
and dot sum in their own (a near-zero dot of 70 terms keeps an absolute,
not a relative, error); 1e-5 of each leaf's max |g| for the GAT layer's
gradients, which run through matrix products and a softmax of another
library.
"""
import dataclasses
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import digest as jdigest
from repro.core import halo_exchange as jhx
from repro.graph import make_dataset
from repro.kernels.spmm import spmm_ref as j_spmm_ref
from repro.models import gnn as jgnn
from repro.nn import init_params
from repro_torch.core import digest as tdigest
from repro_torch.core import halo_exchange as thx
from repro_torch.graph.transpose import ell_transpose
from repro_torch.kernels.spmm import (halo_spmm_cuda, halo_spmm_stream_cuda,
                                      spmm, spmm_bwd_table_plain,
                                      spmm_bwd_wts_plain, spmm_cuda)
from repro_torch.models import gnn as tgnn
from repro_torch.nn import params_from_numpy

spmm_module = importlib.import_module("repro_torch.kernels.spmm.spmm")


def _part(scale=0.3, parts=3, m=1):
    g = make_dataset("flickr-sim", scale=scale, seed=5)
    data = tdigest.prepare_graph_data(g, parts, seed=0, device="cpu")
    return g, data, {k: v[m] for k, v in data["struct"].items()}


def test_transpose_lists_positions_in_order():
    _, data, st = _part()
    nbr = st["in_nbr"].numpy()
    rows, deg = nbr.shape
    pos = ell_transpose(nbr, rows + 1)
    flat = nbr.reshape(-1)
    for j in range(rows + 1):
        want = np.nonzero(flat == j)[0] if j < rows else np.array([])
        got = pos[j][pos[j] < rows * deg]
        np.testing.assert_array_equal(got, want)
        assert (pos[j][len(got):] == rows * deg).all()
    stacked = data["struct"]["in_pos"].numpy()
    allnbr = data["struct"]["in_nbr"].numpy()
    for m in range(allnbr.shape[0]):
        mine = ell_transpose(allnbr[m], rows + 1)
        np.testing.assert_array_equal(stacked[m, :, :mine.shape[1]], mine)
        assert (stacked[m, :, mine.shape[1]:] == rows * deg).all()
    with pytest.raises(ValueError):
        ell_transpose(nbr, rows)          # an id outside the table


@pytest.mark.parametrize("feat", [16, 70])
def test_backward_plains_match_jax_vjp(feat):
    _, _, st = _part()
    nbr, wts, pos = st["in_nbr"], st["in_wts"], st["in_pos"]
    rows = nbr.shape[0]
    rng = np.random.default_rng(feat)
    table = rng.normal(size=(rows + 1, feat)).astype(np.float32)
    table[-1] = 0
    g = rng.normal(size=(rows, feat)).astype(np.float32)
    _, vjp = jax.vjp(lambda w, t: j_spmm_ref(jnp.asarray(nbr.numpy()), w, t),
                     jnp.asarray(wts.numpy()), jnp.asarray(table))
    jw, jt = vjp(jnp.asarray(g))
    tg = torch.from_numpy(g)
    dtab = spmm_bwd_table_plain(pos, wts, tg)
    dw = spmm_bwd_wts_plain(nbr, tg, torch.from_numpy(table))
    for got, want in ((dtab, jt), (dw, jw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    assert not dtab[-1].any()            # the sentinel row gets nothing


@pytest.mark.parametrize("needs", ["table", "wts", "both"])
def test_function_runs_only_the_backward_asked_for(monkeypatch, needs):
    _, _, st = _part()
    nbr, pos = st["in_nbr"], st["in_pos"]
    rows = nbr.shape[0]
    rng = np.random.default_rng(1)
    wts = st["in_wts"].clone().requires_grad_(needs in ("wts", "both"))
    table = torch.from_numpy(
        rng.normal(size=(rows + 1, 8)).astype(np.float32))
    table[-1] = 0
    table.requires_grad_(needs in ("table", "both"))
    calls = []
    for name in ("spmm_bwd_table", "spmm_bwd_wts"):
        real = getattr(spmm_module, name)

        def spy(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)

        monkeypatch.setattr(spmm_module, name, spy)
    out = spmm(nbr, wts, table, pos=pos)
    assert type(out.grad_fn).__name__ == "SpmmFunctionBackward"
    g = torch.from_numpy(rng.normal(size=(rows, 8)).astype(np.float32))
    out.backward(g)
    want = {"table": ["spmm_bwd_table"], "wts": ["spmm_bwd_wts"],
            "both": ["spmm_bwd_wts", "spmm_bwd_table"]}[needs]
    assert calls == want
    if needs != "wts":
        np.testing.assert_array_equal(
            table.grad.numpy(), spmm_bwd_table_plain(pos, st["in_wts"],
                                                     g).numpy())
    if needs != "table":
        np.testing.assert_array_equal(
            wts.grad.numpy(),
            spmm_bwd_wts_plain(nbr, g, table.detach()).numpy())


def test_function_builds_the_transpose_when_absent():
    _, _, st = _part()
    nbr = st["in_nbr"]
    rows = nbr.shape[0]
    table = torch.randn((rows + 1, 5), generator=torch.Generator()
                        .manual_seed(0))
    g = torch.randn((rows, 5), generator=torch.Generator().manual_seed(1))
    grads = []
    for pos in (st["in_pos"], None):
        t = table.clone().requires_grad_()
        spmm_cuda(nbr, st["in_wts"], t, pos).backward(g)
        grads.append(t.grad)
    assert torch.equal(grads[0], grads[1])
    with pytest.raises(ValueError, match="transposed ELL"):
        spmm_cuda(nbr, st["in_wts"], table, st["in_pos"][:-1])


def test_no_grad_calls_skip_the_function():
    _, _, st = _part()
    rows = st["in_nbr"].shape[0]
    table = torch.zeros((rows + 1, 4), requires_grad=True)
    assert spmm(st["in_nbr"], st["in_wts"], table).grad_fn is not None
    with torch.no_grad():
        assert spmm(st["in_nbr"], st["in_wts"], table).grad_fn is None
    assert spmm(st["in_nbr"], st["in_wts"], table.detach()).grad_fn is None


def test_halo_kernels_raise_on_grad():
    """K2 and K3 have no backward: an input that requires grad raises
    instead of yielding a result cut off from autograd (K4: in
    test_torch_skip.py).  An unscaled slab without a predictor is K1,
    which differentiates."""
    n = torch.zeros((4, 2), dtype=torch.int32)
    w = torch.rand((4, 2))
    data = torch.randn((3, 8))
    scale = torch.ones((3, 1))
    for fn in (halo_spmm_cuda, halo_spmm_stream_cuda):
        for args in ((w.clone().requires_grad_(), data, scale),
                     (w, data.clone().requires_grad_(), scale),
                     (w, data, scale.clone().requires_grad_())):
            with pytest.raises(RuntimeError, match="no backward"):
                fn(n, *args)
    out = halo_spmm_cuda(n, w, data.clone().requires_grad_())
    assert out.grad_fn is not None


def test_config_fields_match_the_reference():
    jf = {f.name: f.default for f in dataclasses.fields(jgnn.GNNConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tgnn.GNNConfig)}
    assert list(jf) == list(tf)
    jf.pop("backend"), tf.pop("backend")   # "jnp" there, "auto" here
    assert jf == tf
    jp = {f.name: f.default for f in dataclasses.fields(jhx.HaloPrecision)}
    tp = {f.name: f.default for f in dataclasses.fields(thx.HaloPrecision)}
    assert jp == tp
    for storage in ("fp32", "bf16", "int8"):
        for hidden in (1, 64, 128):
            assert (thx.HaloPrecision(storage, True).row_bytes(hidden)
                    == jhx.HaloPrecision(storage, True).row_bytes(hidden))


@pytest.mark.parametrize("dedup", [True, False])
def test_gat_layer_gradients_match_jax(dedup):
    """Gradients of one GAT layer (both heads' in- and out-side attention,
    through the detached softmax shift) against ``jax.grad``; with
    ``dedup`` the halo table is pre-projected (constant), without it the
    halo rows are projected by the layer's W."""
    g, data, st = _part(scale=0.2, parts=2, m=0)
    jdata = jdigest.prepare_graph_data(g, 2, seed=0)
    jst = {k: v[0] for k, v in jdata["struct"].items()}
    cfg = dict(model="gat", num_layers=2, in_dim=g.features.shape[1],
               hidden_dim=16, num_classes=8, heads=2)
    jcfg, tcfg = jgnn.GNNConfig(**cfg), tgnn.GNNConfig(**cfg)
    jp = init_params(jax.random.PRNGKey(3), jgnn.gnn_specs(jcfg))
    jl = jp["layer_0"]
    rng = np.random.default_rng(7)
    rows = st["in_nbr"].shape[0]
    n_halo = data["halo_ids"].shape[1] + 1
    x = rng.normal(size=(rows, cfg["in_dim"])).astype(np.float32)
    if dedup:
        halo = rng.normal(size=(n_halo, 16)).astype(np.float32)
    else:
        halo = rng.normal(size=(n_halo, cfg["in_dim"])).astype(np.float32)
    halo[-1] = 0
    r = rng.normal(size=(rows, 16)).astype(np.float32)

    def jref():
        if dedup:
            return jgnn.projected_halo_ref(jnp.asarray(halo), None,
                                           jst["out_nbr"], jst["out_wts"])
        return jgnn.halo_ref(jnp.asarray(halo), None, jst["out_nbr"],
                             jst["out_wts"])

    def jloss(p):
        out = jgnn.gnn_layer(jcfg, p, jnp.asarray(x), jref(), jst)
        return jnp.sum(out * jnp.asarray(r))

    jg = jax.grad(jloss)(jl)
    tp = {k: v.requires_grad_() for k, v in
          params_from_numpy(jax.tree.map(np.asarray, jl), "cpu").items()}
    th = torch.from_numpy(halo)
    tref = (tgnn.projected_halo_ref(th, None, st["out_nbr"], st["out_wts"])
            if dedup else
            tgnn.halo_ref(th, None, st["out_nbr"], st["out_wts"]))
    out = tgnn.gnn_layer(tcfg, tp, torch.from_numpy(x), tref, st)
    (out * torch.from_numpy(r)).sum().backward()
    for k in tp:
        want = np.asarray(jg[k])
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(tp[k].grad.numpy(), want, rtol=0,
                                   atol=1e-5 * scale, err_msg=k)


def test_gat_score_gather_backward_matches_autograd():
    """GAT's score gather differentiates through the transposed ELL: the
    same table gradient as autograd's scatter-add (1e-6 of its max; the
    sums run in another order), the sentinel row left at 0."""
    _, _, st = _part()
    nbr = st["in_nbr"]
    rows = nbr.shape[0]
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(rows + 1, 4))
                             .astype(np.float32))
    g = torch.from_numpy(rng.normal(size=tuple(nbr.shape) + (4,))
                         .astype(np.float32))
    grads = []
    for backend in ("auto", "jnp"):
        t = table.clone().requires_grad_()
        out = tgnn._gather_rows(nbr, t, st["in_pos"], backend)
        out.backward(g)
        grads.append(t.grad)
    mine, want = grads
    assert not mine[-1].any()
    np.testing.assert_allclose(mine[:-1].numpy(), want[:-1].numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))
