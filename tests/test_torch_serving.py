"""The port's serving path against the reference (the setup of
tests/test_serving.py, ported): refreshed stores, served logits, cache
counters, degraded refreshes and the Zipf stream.

Tolerance 1e-5 (atol = rtol) for logits against the reference: the sums
run in another order.  Where both packages are fed the same
representations the stored rows and int8 codes must be equal bit for bit
(scales within 1e-6 relative), and the port's own
served gcn/sage logits must equal its own full-graph forward bit for bit
on the CPU with an fp32 store (the invariant of test_serving.py, held port
against port).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import serving as js
from repro.core.digest import prepare_graph_data as j_prepare
from repro.core.digest import top_layer_reps as j_top_layer_reps
from repro.graph import make_dataset
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import gnn_specs
from repro.nn import init_params
from repro_torch.core import serving as ts
from repro_torch.core.digest import full_graph_forward as t_forward
from repro_torch.core.digest import prepare_graph_data as t_prepare
from repro_torch.core.digest import top_layer_reps as t_top_layer_reps
from repro_torch.launch.serving_driver import run_serve_loop
from repro_torch.models.gnn import GNNConfig as TConfig
from repro_torch.nn import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _setup():
    g = make_dataset("flickr-sim", scale=0.1, seed=2)
    jdata = j_prepare(g, 4, seed=0)
    tdata = t_prepare(g, 4, seed=0, device="cpu")
    return g, jdata, tdata, js.build_serve_plan(jdata), \
        ts.build_serve_plan(tdata)


@functools.lru_cache(maxsize=None)
def _model(model: str, key: int = 0):
    g = _setup()[0]
    kw = dict(model=model, num_layers=2, in_dim=g.features.shape[1],
              hidden_dim=32, num_classes=int(g.labels.max()) + 1)
    jcfg = JConfig(**kw)
    jparams = init_params(jax.random.PRNGKey(key), gnn_specs(jcfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, TConfig(**kw), tparams


def _reps(model: str) -> np.ndarray:
    """The reference's top-layer rows, fed to both refreshes so the two
    stores hold the same input."""
    _, jdata, _, _, _ = _setup()
    jcfg, jparams, _, _ = _model(model)
    return np.asarray(j_top_layer_reps(jcfg, jparams, jdata))


def _stores(model: str, storage: str):
    _, _, _, jplan, tplan = _setup()
    reps = _reps(model)
    jstore = js.init_serve_store(jplan, 32, js.ServeConfig(
        storage=storage).precision)
    jstore = js.make_refresh_fn()(jstore, jnp.asarray(reps),
                                  jplan.refresh_data())
    tstore = ts.init_serve_store(tplan, 32, ts.ServeConfig(
        storage=storage).precision, "cpu")
    tstore = ts.make_refresh_fn()(tstore, torch.from_numpy(reps.copy()),
                                  tplan.refresh_data("cpu"))
    return jstore, tstore


def _own_store(tcfg, tparams, storage="fp32"):
    _, _, tdata, _, tplan = _setup()
    store = ts.init_serve_store(tplan, tcfg.hidden_dim,
                                ts.ServeConfig(storage=storage).precision,
                                "cpu")
    return ts.make_refresh_fn()(store,
                                t_top_layer_reps(tcfg, tparams, tdata),
                                tplan.refresh_data("cpu"))


def _batches(num_nodes, b):
    for lo in range(0, num_nodes, b):
        q = np.full(b, num_nodes, np.int32)
        ids = np.arange(lo, min(lo + b, num_nodes), dtype=np.int32)
        q[:len(ids)] = ids
        yield q, len(ids)


def _t_serve_all(cfg, scfg, params, store, cache, qdata, num_nodes):
    outs = []
    for q, k in _batches(num_nodes, scfg.batch_size):
        logits, cache = ts.serve_query(cfg, scfg, params, store, cache,
                                       qdata, torch.from_numpy(q))
        outs.append(logits.numpy()[:k])
    return np.concatenate(outs), cache


def _j_serve_all(cfg, scfg, params, store, cache, qdata, num_nodes):
    outs = []
    for q, k in _batches(num_nodes, scfg.batch_size):
        logits, cache = js.serve_query(cfg, scfg, params, store, cache,
                                       qdata, jnp.asarray(q))
        outs.append(np.asarray(logits)[:k])
    return np.concatenate(outs), cache


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
def test_refreshed_store_equals_reference(storage):
    jstore, tstore = _stores("gcn", storage)
    assert sorted(jstore) == sorted(tstore)
    got = tstore["data"]
    want = np.asarray(jstore["data"].astype(jnp.float32))
    assert got.dtype == {"fp32": torch.float32, "bf16": torch.bfloat16,
                         "int8": torch.int8}[storage]
    np.testing.assert_array_equal(got.float().numpy(), want)
    if storage == "int8":
        # Scales within 1 ulp: under jit the reference's max(amax)/127 is
        # not always the correctly rounded quotient the port computes.
        np.testing.assert_allclose(tstore["scale"].numpy(),
                                   np.asarray(jstore["scale"]), rtol=1e-6,
                                   atol=0)
    assert int(tstore["version"]) == int(jstore["version"]) == 1


@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
def test_served_logits_match_reference(model, storage):
    g, _, _, jplan, tplan = _setup()
    jcfg, jparams, tcfg, tparams = _model(model)
    jstore, tstore = _stores(model, storage)
    jscfg = js.ServeConfig(batch_size=64, cache_rows=128, storage=storage)
    tscfg = ts.ServeConfig(batch_size=64, cache_rows=128, storage=storage)
    want, _ = _j_serve_all(jcfg, jscfg, jparams, jstore,
                           js.init_cache(jscfg, jcfg.num_classes),
                           jplan.query_data(), g.num_nodes)
    got, _ = _t_serve_all(tcfg, tscfg, tparams, tstore,
                          ts.init_cache(tscfg, tcfg.num_classes, "cpu"),
                          tplan.query_data("cpu"), g.num_nodes)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("model", ["gcn", "sage"])
def test_served_logits_bitwise_vs_own_forward(model):
    g, _, tdata, _, tplan = _setup()
    _, _, tcfg, tparams = _model(model)
    ref = t_forward(tcfg, tparams, tdata)[0].numpy()[:g.num_nodes]
    store = _own_store(tcfg, tparams)
    scfg = ts.ServeConfig(batch_size=64, cache_rows=128)
    cache = ts.init_cache(scfg, tcfg.num_classes, "cpu")
    qdata = tplan.query_data("cpu")
    served, cache = _t_serve_all(tcfg, scfg, tparams, store, cache, qdata,
                                 g.num_nodes)
    np.testing.assert_array_equal(served, ref)
    # Second sweep: hits serve the memoised row — still bitwise.
    served2, cache = _t_serve_all(tcfg, scfg, tparams, store, cache, qdata,
                                  g.num_nodes)
    np.testing.assert_array_equal(served2, ref)
    assert int(cache["hits"]) > 0


def test_cache_matches_reference_on_zipf_stream():
    """Hit/miss counters after every batch, and the final cache state
    (tags, versions, LRU clocks), equal the reference's on one Zipf
    stream with duplicate-heavy batches."""
    g, _, _, jplan, tplan = _setup()
    jcfg, jparams, tcfg, tparams = _model("gcn")
    jstore, tstore = _stores("gcn", "int8")
    hot = np.argsort(-g.degrees()).astype(np.int32)
    stream = ts.zipf_queries(g.num_nodes, 32, 12, 1.1, seed=1, hot_ids=hot)
    jscfg = js.ServeConfig(batch_size=32, cache_rows=64, storage="int8")
    tscfg = ts.ServeConfig(batch_size=32, cache_rows=64, storage="int8")
    jcache = js.init_cache(jscfg, jcfg.num_classes)
    tcache = ts.init_cache(tscfg, tcfg.num_classes, "cpu")
    jq, tq = jplan.query_data(), tplan.query_data("cpu")
    for q in stream:
        jl, jcache = js.serve_query(jcfg, jscfg, jparams, jstore, jcache, jq,
                                    jnp.asarray(q))
        tl, tcache = ts.serve_query(tcfg, tscfg, tparams, tstore, tcache, tq,
                                    torch.from_numpy(q))
        assert (int(tcache["hits"]), int(tcache["misses"])) == \
            (int(jcache["hits"]), int(jcache["misses"]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(tcache["hits"]) > 0
    for k in ("tags", "vers", "last", "step"):
        np.testing.assert_array_equal(tcache[k].numpy(),
                                      np.asarray(jcache[k]))
    assert ts.hit_rate(tcache) == js.hit_rate(jcache)


def test_zipf_queries_equal_reference():
    hot = np.random.default_rng(0).permutation(500).astype(np.int32)
    for kw in (dict(seed=0), dict(seed=3, hot_ids=hot)):
        np.testing.assert_array_equal(
            ts.zipf_queries(500, 16, 5, 1.3, **kw),
            js.zipf_queries(500, 16, 5, 1.3, **kw))


def test_refresh_or_degrade_keeps_old_version_serving():
    g, _, tdata, _, tplan = _setup()
    _, _, tcfg, tparams = _model("gcn")
    _, _, _, tparams2 = _model("gcn", key=7)
    store = _own_store(tcfg, tparams)
    scfg = ts.ServeConfig(batch_size=64, cache_rows=128)
    qdata, rdata = tplan.query_data("cpu"), tplan.refresh_data("cpu")
    cache = ts.init_cache(scfg, tcfg.num_classes, "cpu")
    before, cache = _t_serve_all(tcfg, scfg, tparams, store, cache, qdata,
                                 g.num_nodes)
    refresh = ts.make_refresh_fn(donate=False)
    reps = t_top_layer_reps(tcfg, tparams2, tdata)
    bad = reps[:, :5]                       # wrong width: the push raises
    kept, stats = ts.refresh_or_degrade(refresh, store, bad, rdata)
    assert kept is store and stats == {"refreshes": 0,
                                       "degraded_refreshes": 1}
    assert int(kept["version"]) == 1
    hits = int(cache["hits"])
    after, cache = _t_serve_all(tcfg, scfg, tparams, kept, cache, qdata,
                                g.num_nodes)
    np.testing.assert_array_equal(after, before)
    assert int(cache["hits"]) > hits            # old entries still valid
    new, stats = ts.refresh_or_degrade(refresh, kept, reps, rdata, stats)
    assert stats == {"refreshes": 1, "degraded_refreshes": 1}
    assert int(new["version"]) == 2 and int(store["version"]) == 1
    hits = int(cache["hits"])
    served, cache = _t_serve_all(tcfg, scfg, tparams2, new, cache, qdata,
                                 g.num_nodes)
    assert int(cache["hits"]) == hits           # no stale hit survives
    ref2 = t_forward(tcfg, tparams2, tdata)[0].numpy()[:g.num_nodes]
    np.testing.assert_array_equal(served, ref2)


def test_donated_refresh_updates_in_place():
    _, _, tdata, _, tplan = _setup()
    _, _, tcfg, tparams = _model("gcn")
    store = ts.init_serve_store(tplan, 32, ts.ServeConfig(
        storage="int8").precision, "cpu")
    ptrs = {k: v.data_ptr() for k, v in store.items()}
    refresh = ts.make_refresh_fn()
    reps = t_top_layer_reps(tcfg, tparams, tdata)
    rdata = tplan.refresh_data("cpu")
    for _ in range(2):
        store = refresh(store, reps, rdata)
    assert {k: v.data_ptr() for k, v in store.items()} == ptrs
    assert int(store["version"]) == 2


def test_padding_and_disabled_cache_counters():
    g, _, tdata, _, tplan = _setup()
    _, _, tcfg, tparams = _model("gcn")
    store = _own_store(tcfg, tparams)
    qdata = tplan.query_data("cpu")
    scfg = ts.ServeConfig(batch_size=32, cache_rows=128)
    q = np.full(32, g.num_nodes, np.int32)           # all padding ...
    q[:5] = np.arange(5)                             # ... but 5 queries
    _, cache = ts.serve_query(tcfg, scfg, tparams, store,
                              ts.init_cache(scfg, tcfg.num_classes, "cpu"),
                              qdata, torch.from_numpy(q))
    assert int(cache["hits"]) + int(cache["misses"]) == 5
    off = ts.ServeConfig(batch_size=64, cache_rows=0)
    served, cache = _t_serve_all(tcfg, off, tparams, store,
                                 ts.init_cache(off, tcfg.num_classes, "cpu"),
                                 qdata, g.num_nodes)
    assert (int(cache["hits"]), int(cache["misses"])) == (0, g.num_nodes)
    ref = t_forward(tcfg, tparams, tdata)[0].numpy()[:g.num_nodes]
    np.testing.assert_array_equal(served, ref)
    with pytest.raises(ValueError, match="batch_size"):
        ts.serve_query(tcfg, off, tparams, store, cache, qdata,
                       torch.zeros(3, dtype=torch.int32))


def test_serve_loop_stats():
    calls = []

    def step(carry, item):
        calls.append(item)
        return carry + 1, torch.tensor([item])

    carry, outs, stats = run_serve_loop(step, range(6), carry=0, warmup=2,
                                        items_per_call=8)
    assert carry == 6 and len(outs) == 6 and calls == list(range(6))
    assert len(stats.steady) == 4 and stats.per_sec > 0
    assert stats.summary()["calls"] == 6
