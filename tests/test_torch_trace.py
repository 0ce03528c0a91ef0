"""The port's spans and counters (``repro_torch/trace.py``) on the DIGEST
epoch, on the CPU: two epochs of a small GCN and GAT (dedup on) at
N = 2, so epoch 1 pushes and epoch 2 pulls.

Each span appears as often as its phase runs and nests under its parent;
with no profiler recording no ``record_function`` is entered, and the
epoch's outputs are the same bits with and without one; the store's and
the gather's byte counters equal closed forms of the shapes.
"""
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.core.digest import (TrainSettings, init_state,
                                     make_epoch_fn, prepare_graph_data)
from repro_torch.core.halo_exchange import HaloPrecision
from repro_torch.graph.generators import sbm_graph
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim import adam

M, N, EPOCHS = 2, 2, 2
PARENT = {"digest.epoch": None, "digest.gather": "digest.epoch",
          "store.pull": "digest.epoch", "digest.subgraph": "digest.epoch",
          "gnn.forward": "digest.subgraph",
          "gnn.backward": "digest.subgraph",
          "digest.update": "digest.epoch", "store.probe": "digest.epoch",
          "store.push": "digest.epoch"}


@pytest.fixture(scope="module")
def data():
    g = sbm_graph(num_nodes=240, num_classes=5, feature_dim=12, seed=3)
    return g, prepare_graph_data(g, M, device="cpu")


def _cfg(g, model):
    return GNNConfig(model=model, num_layers=3, in_dim=g.features.shape[1],
                     hidden_dim=8, num_classes=5, heads=2,
                     gat_halo_dedup=True)


def _run(data, model, precision="fp32"):
    """Two epochs from a fresh state: (states' params, metrics)."""
    g, d = data
    cfg, prec = _cfg(g, model), HaloPrecision(precision)
    opt = adam(5e-3)
    state = init_state(cfg, opt, d, seed=1, precision=prec)
    epoch_fn = make_epoch_fn(cfg, opt, TrainSettings(sync_interval=N,
                                                     precision=prec))
    out = []
    for _ in range(EPOCHS):
        state, metrics = epoch_fn(state, d)
        out.append((state["params"], metrics))
    return out


def _spans(prof) -> list:
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation() and e.name() in PARENT),
                  key=lambda s: (s[1], -s[2]))


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_spans_count_and_nest(data, model):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(data, model)
    spans = _spans(prof)
    counts = {name: sum(s[0] == name for s in spans) for name in PARENT}
    assert counts == {"digest.epoch": EPOCHS, "digest.gather": 2 * EPOCHS,
                      "store.pull": 1, "digest.subgraph": M * EPOCHS,
                      "gnn.forward": M * EPOCHS, "gnn.backward": M * EPOCHS,
                      "digest.update": 2 * EPOCHS, "store.probe": EPOCHS,
                      "store.push": 1}
    epochs = [s for s in spans if s[0] == "digest.epoch"]
    for name, lo, hi in spans:
        holders = [s for s in spans if s[1] <= lo and hi <= s[2]
                   and (s[1], s[2]) != (lo, hi)]
        parent = max(holders, key=lambda s: s[1])[0] if holders else None
        assert parent == PARENT[name], name
    # Epoch 1 pushes (r - 1 = 0 is a multiple of N), epoch 2 pulls.
    push = next(s for s in spans if s[0] == "store.push")
    pull = next(s for s in spans if s[0] == "store.pull")
    assert epochs[0][1] <= push[1] and push[2] <= epochs[0][2]
    assert epochs[1][1] <= pull[1] and pull[2] <= epochs[1][2]


def test_no_record_function_without_a_profiler(data, monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    _run(data, "gcn")
    assert entered == []
    assert trace.span("digest.epoch") is trace.OFF
    with profile(activities=[ProfilerActivity.CPU]):
        _run(data, "gcn")
    assert entered.count("digest.epoch") == EPOCHS
    assert set(entered) == set(PARENT)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_outputs_equal_with_and_without_a_profiler(data, model):
    plain = _run(data, model)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _run(data, model)
    for (p0, m0), (p1, m1) in zip(plain, traced):
        for a, b in zip(_leaves([p0, m0]), _leaves([p1, m1])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_byte_counters_equal_the_shapes(data, model, precision):
    g, d = data
    cfg = _cfg(g, model)
    trace.reset_counters()
    _run(data, model, precision)
    c = trace.COUNTERS
    s = int(d["local_ids"].shape[1])
    h1 = int(d["halo_ids"].shape[1]) + 1
    l1 = cfg.num_layers - 1
    value = 4 if precision == "fp32" else 1
    scale = 0 if precision == "fp32" else 4
    assert c["digest.epochs"] == EPOCHS
    # One pull (epoch 2): each subgraph's (H+1)-row slab of every hidden
    # layer; under GAT dedup, of each projected z table (the next layer's
    # output width).
    if model == "gat":
        widths = [cfg.layer_dims[ell + 1][1] for ell in range(l1)]
    else:
        widths = [cfg.hidden_dim] * l1
    assert c["store.pull_bytes"] == sum(M * h1 * (w * value + scale)
                                        for w in widths)
    # One push (epoch 1): each part's S rows of every hidden layer, and
    # its sentinel row re-zeroed.
    assert c["store.push_bytes"] == l1 * M * (s + 1) * (
        cfg.hidden_dim * value + scale)

