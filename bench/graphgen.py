"""The benchmark's input graph.

A stochastic block model with community-aligned labels and
class-informative features, after the port's ``sbm_graph``
(``src/repro_torch/graph/generators.py``).  The graph itself (labels and
edges) is the configuration's, drawn from its ``graph_seed``: as
ogbn-products is one graph, every run trains on the same one, so every
seed partitions into the same subgraph sizes and does the same work.  A
run's seed draws what a training run varies: the features around the
class centres and the train / validation / test split (and, in
``bench.harness``, the parameters).  With both seeds equal it draws what
``make_dataset("products-sim", seed, scale)`` draws.  The edge list is
returned as drawn (self loops and duplicates included): the program and
the reference each derive their own adjacency from it.
"""
from __future__ import annotations

import numpy as np


def _features(labels: np.ndarray, num_classes: int, dim: int, noise: float,
              rng: np.random.Generator) -> np.ndarray:
    centers = rng.normal(size=(num_classes, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[labels] + noise * rng.normal(size=(len(labels), dim))
    return x.astype(np.float32)


def _masks(n: int, frac, rng: np.random.Generator) -> tuple:
    idx = rng.permutation(n)
    a = int(frac[0] * n)
    b = a + int(frac[1] * n)
    train = np.zeros(n, bool)
    train[idx[:a]] = True
    val = np.zeros(n, bool)
    val[idx[a:b]] = True
    test = np.zeros(n, bool)
    test[idx[b:]] = True
    return train, val, test


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) & (2 ** 64 - 1))


def sbm(graph_seed: int, seed: int, num_nodes: int, num_classes: int,
        avg_degree: float, p_in_out_ratio: float, feature_dim: int,
        noise: float, split) -> dict:
    """Draw the graph: ``{"num_nodes", "edges" (E, 2) int64, "features"
    (N, feature_dim) float32, "labels" (N,) int32, "train", "val",
    "test" (N,) bool}``, labels and edges from ``graph_seed``, features
    and split from ``seed`` (any integers; the same seeds give the same
    arrays)."""
    rng = _rng(graph_seed)
    labels = rng.integers(num_classes, size=num_nodes).astype(np.int32)
    n_in = num_nodes / num_classes
    n_out = num_nodes - n_in
    p_out = avg_degree / (p_in_out_ratio * n_in + n_out)
    p_in = p_in_out_ratio * p_out
    # Intra-class edges are drawn per class: rejection over uniform pairs
    # would under-produce same-class pairs by about num_classes times.
    edges = []
    m_intra = int(rng.poisson(0.5 * p_in * n_in * num_nodes))
    m_inter = int(rng.poisson(0.5 * p_out * n_out * num_nodes))
    nodes_by_class = [np.where(labels == c)[0] for c in range(num_classes)]
    sizes = np.array([len(nc) for nc in nodes_by_class], np.float64)
    wts = np.maximum(sizes, 1.0) ** 2
    per_class = rng.multinomial(m_intra, wts / wts.sum())
    for c, m_c in enumerate(per_class):
        nc = nodes_by_class[c]
        if len(nc) < 2 or m_c == 0:
            continue
        u = rng.choice(nc, size=m_c)
        v = rng.choice(nc, size=m_c)
        edges.append(np.stack([u, v], 1))
    u = rng.integers(num_nodes, size=int(1.5 * m_inter) + 1)
    v = rng.integers(num_nodes, size=int(1.5 * m_inter) + 1)
    diff = labels[u] != labels[v]
    edges.append(np.stack([u[diff][:m_inter], v[diff][:m_inter]], 1))
    edges = np.concatenate(edges, axis=0).astype(np.int64)
    if seed != graph_seed:
        rng = _rng(seed)
    feats = _features(labels, num_classes, feature_dim, noise, rng)
    train, val, test = _masks(num_nodes, split, rng)
    return {"num_nodes": num_nodes, "edges": edges, "features": feats,
            "labels": labels, "train": train, "val": val, "test": test}


GENERATORS = {"sbm": sbm}


def generate(config: dict, seed: int) -> dict:
    """The graph of a configuration (its ``num_nodes`` and ``graph``
    block) with a run's ``seed``."""
    graph = config["graph"]
    kw = {k: v for k, v in graph.items()
          if k not in ("generator", "preset", "scale", "graph_seed")}
    return GENERATORS[graph["generator"]](graph["graph_seed"], seed,
                                          config["num_nodes"], **kw)
