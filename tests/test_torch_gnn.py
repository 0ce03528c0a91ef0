"""The port's GNN forward against the reference, on the reference's own
parameters (``params_from_numpy``): full-graph logits and reps, single
layers on the per-part structs (plain and int8 halo tables), evaluate.

Tolerance 1e-5 (atol = rtol): sums are taken in another order (the
reference's jnp oracle reduces over k vectorised, the port sequentially),
and the matrix products are another library's.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import digest as jdigest
from repro.core import halo_exchange as jhx
from repro.graph import make_dataset
from repro.models import gnn as jgnn
from repro.nn import init_params
from repro_torch.core import digest as tdigest
from repro_torch.models import gnn as tgnn
from repro_torch.nn import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
CASES = [("gcn", 2), ("gcn", 3), ("sage", 2), ("gat", 2), ("gat", 3)]


@functools.lru_cache(maxsize=None)
def _data():
    g = make_dataset("flickr-sim", scale=0.1, seed=2)
    jdata = jdigest.prepare_graph_data(g, 4, seed=0)
    tdata = tdigest.prepare_graph_data(g, 4, seed=0, device="cpu")
    return g, jdata, tdata


@functools.lru_cache(maxsize=None)
def _model(model, layers):
    g, _, _ = _data()
    kw = dict(model=model, num_layers=layers, in_dim=g.features.shape[1],
              hidden_dim=32, num_classes=int(g.labels.max()) + 1)
    jcfg = jgnn.GNNConfig(**kw)
    jparams = init_params(jax.random.PRNGKey(0), jgnn.gnn_specs(jcfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tgnn.GNNConfig(**kw), tparams


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("model,layers", CASES)
def test_full_graph_forward(model, layers):
    _, jdata, tdata = _data()
    jcfg, jparams, tcfg, tparams = _model(model, layers)
    jlogits, jreps = jdigest.full_graph_forward(jcfg, jparams, jdata)
    tlogits, treps = tdigest.full_graph_forward(tcfg, tparams, tdata)
    _close(tlogits, jlogits)
    assert len(treps) == len(jreps) == layers - 1
    for t, j in zip(treps, jreps):
        _close(t, j)


@pytest.mark.parametrize("model,layers", CASES[::2])
@pytest.mark.parametrize("halo", ["plain", "int8"])
def test_gnn_layer_on_parts(model, layers, halo):
    """Layer 0 of every subgraph: in-ELL over local rows plus the
    out-of-subgraph side, as a plain (H, d) table or an int8 halo ref
    (the fused K2 path)."""
    _, jdata, tdata = _data()
    jcfg, jparams, tcfg, tparams = _model(model, layers)
    x = np.asarray(jdata["x_global"])
    for m in range(jdata["local_ids"].shape[0]):
        xl = x[np.asarray(jdata["local_ids"][m])]
        js = {k: v[m] for k, v in jdata["struct"].items()}
        ts = {k: v[m] for k, v in tdata["struct"].items()}
        if halo == "plain":
            xh = x[np.asarray(jdata["halo_ids"][m])]
            jh, th = jnp.asarray(xh), torch.from_numpy(xh)
        else:
            rows = jnp.asarray(x[np.asarray(jdata["halo_ids_x"][m])])
            q, s = jhx.quantize_rows(rows, jhx.HaloPrecision("int8"))
            jh = jgnn.halo_ref(q, s, js["out_nbr"], js["out_wts"])
            th = tgnn.halo_ref(torch.from_numpy(np.array(q)),
                               torch.from_numpy(np.array(s)),
                               ts["out_nbr"], ts["out_wts"])
        want = jgnn.gnn_layer(jcfg, jparams["layer_0"], jnp.asarray(xl), jh,
                              js)
        got = tgnn.gnn_layer(tcfg, tparams["layer_0"], torch.from_numpy(xl),
                             th, ts)
        _close(got, want)


def test_gat_layer_with_projected_halo():
    """A hidden GAT layer against a pre-projected int8 halo table
    (``projected_halo_ref``: rows already W·h̃, flat heads·head_dim)."""
    _, jdata, tdata = _data()
    jcfg, jparams, tcfg, tparams = _model("gat", 3)
    rng = np.random.default_rng(4)
    m = 1
    js = {k: v[m] for k, v in jdata["struct"].items()}
    ts = {k: v[m] for k, v in tdata["struct"].items()}
    xl = rng.normal(size=(js["in_nbr"].shape[0], 32)).astype(np.float32)
    rows = rng.normal(size=(jdata["halo_ids_x"].shape[1], 32))
    rows[-1] = 0
    w = np.asarray(jparams["layer_1"]["w"])
    z = (rows.astype(np.float32) @ w.reshape(32, -1)).astype(np.float32)
    zq, zs = jhx.quantize_rows(jnp.asarray(z), jhx.HaloPrecision("int8"))
    jh = jgnn.projected_halo_ref(zq, zs, js["out_nbr"], js["out_wts"])
    th = tgnn.projected_halo_ref(torch.from_numpy(np.array(zq)),
                                 torch.from_numpy(np.array(zs)),
                                 ts["out_nbr"], ts["out_wts"])
    want = jgnn.gnn_layer(jcfg, jparams["layer_1"], jnp.asarray(xl), jh, js)
    got = tgnn.gnn_layer(tcfg, tparams["layer_1"], torch.from_numpy(xl), th,
                         ts)
    _close(got, want)


@pytest.mark.parametrize("model,layers", CASES[1:4])
def test_evaluate(model, layers):
    _, jdata, tdata = _data()
    jcfg, jparams, tcfg, tparams = _model(model, layers)
    want = jdigest.evaluate(jcfg, jparams, {
        k: v for k, v in jdata.items() if not k.startswith("_")})
    got = tdigest.evaluate(tcfg, tparams, tdata)
    for split in ("train", "val", "test"):
        assert float(got[f"{split}_f1"]) == float(want[f"{split}_f1"])
        np.testing.assert_allclose(float(got[f"{split}_loss"]),
                                   float(want[f"{split}_loss"]), **TOL)


def test_gnn_module_holds_reference_keys():
    """nn.Module wrapper: state_dict keys are the reference pytree's, and
    its forward is the functional forward."""
    _, _, tdata = _data()
    _, jparams, tcfg, tparams = _model("gat", 2)
    net = tgnn.GNN(tcfg, tparams)
    keys = {f"{layer}.{name}" for layer, leaves in jparams.items()
            for name in leaves}
    assert set(net.state_dict()) == keys
    assert net.state_dict()["layer_0.w"].shape == jparams["layer_0"]["w"].shape
    x = tdata["x_global"][tdata["full_ids"][0].long()]
    struct = {k: v[0] for k, v in tdata["full_struct"].items()}
    tables, struct = tdigest.empty_halo_struct(tcfg, struct)
    got, _ = net(x, tables, struct)
    want, _ = tdigest.full_graph_forward(tcfg, tparams, tdata)
    assert torch.equal(got, want)
    fresh = tgnn.GNN.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    again = tgnn.GNN.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, again.state_dict()[k])
        assert v.shape == net.state_dict()[k].shape
