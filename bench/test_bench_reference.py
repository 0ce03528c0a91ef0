"""The benchmark's inputs and reference against the program on the CPU,
at products-sim scale 0.05 (600 nodes): the generator draws the
program's graph, the reference partitions it as the program does, and a
whole run of each cell (the port's plain CPU paths in the kernels'
place) comes out correct."""
import numpy as np
import pytest
import torch

from bench import graphgen, harness, spec
from bench.reference import partition

NODES = 600
CELLS = [w["name"] for w in spec.load()["workloads"]]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _config():
    return {**spec.resolve("gcn-products.n10")["config"],
            "num_nodes": NODES}


def test_generator_draws_the_programs_graph():
    from repro_torch.graph.generators import make_dataset
    from repro_torch.graph.graph import from_edges
    seed = 2 ** 31 + 7
    config = _config()
    config["graph"] = {**config["graph"], "graph_seed": seed}
    ours = graphgen.generate(config, seed)
    g = make_dataset("products-sim", seed=seed, scale=NODES / 12000)
    mine = from_edges(NODES, ours["edges"], ours["features"],
                      ours["labels"])
    assert np.array_equal(mine.indptr, g.indptr)
    assert np.array_equal(mine.indices, g.indices)
    assert np.array_equal(ours["features"], g.features)
    assert np.array_equal(ours["labels"], g.labels)
    for k in ("train", "val", "test"):
        assert np.array_equal(ours[k], getattr(g, f"{k}_mask"))


def test_the_graph_is_the_configurations_and_the_rest_the_seeds():
    a, b = (graphgen.generate(_config(), s) for s in (1, 2))
    assert np.array_equal(a["edges"], b["edges"])
    assert np.array_equal(a["labels"], b["labels"])
    assert not np.array_equal(a["features"], b["features"])
    assert not np.array_equal(a["train"], b["train"])


def test_reference_partition_is_the_programs():
    from repro_torch.graph.graph import from_edges, gcn_norm_weights
    from repro_torch.graph.partition import greedy_partition
    ours = graphgen.generate(_config(), 3)
    adj = partition.adjacency(NODES, ours["edges"], "cpu")
    g = from_edges(NODES, ours["edges"], ours["features"], ours["labels"])
    assert np.array_equal(adj["indptr"], g.indptr)
    assert np.array_equal(adj["indices"], g.indices)
    rows, cols, wts = gcn_norm_weights(g)
    assert np.array_equal(adj["rows"].numpy(), rows)
    assert np.array_equal(adj["cols"].numpy(), cols)
    assert np.array_equal(adj["wts"].numpy(), wts)
    assert np.array_equal(
        partition.greedy_partition(adj["indptr"], adj["indices"], 8),
        greedy_partition(g, 8))


@pytest.mark.parametrize("name", CELLS)
def test_the_program_agrees_with_the_reference(name):
    from bench import compare
    cell = spec.resolve(name)
    cell["config"] = {**cell["config"], "num_nodes": NODES}
    prog, rec, graph, params0 = harness.warm_up(cell, 12345, "cpu")
    del prog
    nums, stats = harness.judge(cell, rec, graph, params0, "cpu")
    assert compare.verdict(nums, cell["limits"]), nums
    assert nums["leaves_compared"] == nums["leaves"]
    assert sum(p["nodes"] for p in stats["parts"]) == NODES
