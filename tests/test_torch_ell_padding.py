"""The ELL layout that K1 and the SpMM table gradient rely on to skip
padding, on every ELL the port feeds them.

K1 (``csrc/spmm.cu``) skips a slot exactly when its weight is 0 and its
row is the table's last, the zero sentinel; the table gradient
(``csrc/spmm_bwd.cu``) ends a row's walk at its first padding position.
Both are exact only while: every slot on a sentinel has weight exactly 0
(else a skipped slot would carry weight), the transposed ELL's padding is
trailing (else positions after it would be dropped), and the sentinel rows
of the tables built on the main path are zero (else the plain version's
0 * table[sentinel] could be NaN).  Small sizes: products-sim and
papers-sim at scale 0.1, on the CPU.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.core import serving
from repro_torch.core.digest import (TrainSettings, init_state,
                                     make_epoch_fn, prepare_graph_data,
                                     top_layer_reps)
from repro_torch.core.halo_exchange import HaloPrecision
from repro_torch.graph import make_dataset
from repro_torch.models.gnn import GNN, GNNConfig
from repro_torch.optim import adam

DATASETS = ("products-sim", "papers-sim")


@functools.lru_cache(maxsize=None)
def _data(name):
    g = make_dataset(name, scale=0.1, seed=0)
    data = prepare_graph_data(g, 4, seed=0, order="rcm",
                              stream_chunk_rows=64, device="cpu")
    return g, data, serving.build_serve_plan(data)


def _ells(name):
    """(what, nbr, wts, sentinel) of every ELL K1 reads on the main
    paths: the full-graph in-ELL (refresh), each subgraph's in-ELL (over
    the local table, sentinel S) and out-ELL (over the halo slab, sentinel
    H), and query batches mapped through ``serve_map`` (over the serving
    store, sentinel R - 1)."""
    g, data, plan = _data(name)
    full = data["full_struct"]
    yield "full in", full["in_nbr"], full["in_wts"], full["in_nbr"].shape[1]
    st = data["struct"]
    yield "in", st["in_nbr"], st["in_wts"], st["in_nbr"].shape[1]
    yield ("out", st["out_nbr"], st["out_wts"],
           int(data["halo_ids"].shape[1]))
    qdata = plan.query_data("cpu")
    queries = serving.zipf_queries(g.num_nodes, 64, 4, 1.1, seed=1)
    for q in queries:
        ids = qdata["nbr"][torch.from_numpy(q).long()].long()
        yield ("query", qdata["serve_map"][ids], qdata["wts"][q],
               plan.store_rows - 1)


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("view", ["full in", "in", "out", "query"])
def test_sentinel_slots_have_zero_weight(name, view):
    """Every slot on the sentinel row weighs exactly 0, and no real slot
    of these graphs weighs 0: so K1's skipped slots are just the
    padding."""
    seen = 0
    for what, nbr, wts, sentinel in _ells(name):
        if what != view:
            continue
        assert int(nbr.max()) <= sentinel and int(nbr.min()) >= 0
        pad = nbr == sentinel
        assert bool((wts[pad] == 0).all()), what
        assert bool((wts[~pad] != 0).all()), what
        seen += int(pad.sum())
    assert seen > 0                   # the views do hold padding


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("struct", ["struct", "full_struct"])
@pytest.mark.parametrize("side", ["in", "out"])
def test_transposed_padding_is_trailing(name, struct, side):
    """In the transposed ELL (the table gradient's input) each row's live
    positions come first, ascending, then only padding (rows * deg); the
    sentinel row is all padding."""
    _, data, _ = _data(name)
    nbr = data[struct][f"{side}_nbr"]
    pos = data[struct][f"{side}_pos"]
    n_pos = nbr.shape[1] * nbr.shape[2]
    pad = pos >= n_pos
    assert bool((pos[pad] == n_pos).all())
    # Once padding starts, it does not stop.
    assert bool((pad[..., 1:] >= pad[..., :-1]).all())
    assert bool(pad[:, -1].all())
    live = torch.where(pad, torch.full_like(pos, -1), pos)
    assert bool((live[..., 1:][~pad[..., 1:]]
                 > live[..., :-1][~pad[..., 1:]]).all())


def _model(g, model="gcn"):
    cfg = GNNConfig(model=model, num_layers=2, in_dim=g.features.shape[1],
                    hidden_dim=16, num_classes=int(g.labels.max()) + 1,
                    heads=2 if model == "gat" else 1, stream_chunk_rows=64)
    return cfg, GNN.init(cfg, torch.Generator().manual_seed(0), "cpu").tree()


@pytest.mark.parametrize("name", DATASETS)
def test_input_features_sentinel_row_is_zero(name):
    """x_global's row N, which the layer-0 halo slabs gather for their
    sentinel (halo_ids_x pads with N), is zero."""
    g, data, _ = _data(name)
    x = data["x_global"]
    assert x.shape[0] == g.num_nodes + 1
    assert bool((x[-1] == 0).all())
    halo0 = x[data["halo_ids_x"].long()]
    assert bool((halo0[:, -1] == 0).all())


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
def test_training_slab_sentinel_rows_are_zero(name, storage):
    """After training epochs with pushes and pulls, every subgraph's
    pulled halo slab keeps its last row (the out-ELL's sentinel) zero."""
    g, data, _ = _data(name)
    cfg, params = _model(g)
    settings = TrainSettings(sync_interval=1, mode="digest",
                             precision=HaloPrecision(storage))
    opt = adam(1e-2)
    state = init_state(cfg, opt, data, precision=settings.precision,
                       params=params)
    epoch = make_epoch_fn(cfg, opt, settings)
    for _ in range(2):
        state, _ = epoch(state, data)
    slab = state["cache"]["data"]
    assert bool(slab[:, :, :-1].any())          # pulled rows, not zeros
    assert bool((slab[:, :, -1] == 0).all())


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
def test_serving_store_sentinel_row_is_zero(name, storage):
    """The serving store, which query batches read through serve_map, keeps
    its last row (their sentinel, R - 1) zero across refreshes."""
    g, data, plan = _data(name)
    cfg, params = _model(g)
    reps = top_layer_reps(cfg, params, data)
    store = serving.init_serve_store(plan, cfg.hidden_dim,
                                     HaloPrecision(storage), "cpu")
    refresh = serving.make_refresh_fn()
    for k in range(2):
        store = refresh(store, reps * (1 + k), plan.refresh_data("cpu"))
    rows = store["data"][0]
    assert rows.shape[0] == plan.store_rows
    assert bool(rows[:-1].any())
    assert bool((rows[-1] == 0).all())
    assert int(np.asarray(plan.serve_map)[-1]) == plan.store_rows - 1
