"""Synthetic graph generators (offline stand-ins for OGB/Flickr/Reddit).

Each generator produces a :class:`Graph` with class-informative node features
so the GNN training curves behave like the paper's (loss drops, F1 rises, and
partition-induced information loss is *measurable*).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.graph import Graph, from_edges


def _features_from_labels(labels: np.ndarray, num_classes: int, dim: int,
                          noise: float, rng: np.random.Generator
                          ) -> np.ndarray:
    centers = rng.normal(size=(num_classes, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[labels] + noise * rng.normal(size=(len(labels), dim))
    return x.astype(np.float32)


def _masks(n: int, frac: tuple[float, float, float],
           rng: np.random.Generator):
    idx = rng.permutation(n)
    a = int(frac[0] * n)
    b = a + int(frac[1] * n)
    train = np.zeros(n, bool); train[idx[:a]] = True
    val = np.zeros(n, bool); val[idx[a:b]] = True
    test = np.zeros(n, bool); test[idx[b:]] = True
    return train, val, test


def sbm_graph(num_nodes: int = 4000, num_classes: int = 8,
              avg_degree: float = 12.0, p_in_out_ratio: float = 8.0,
              feature_dim: int = 64, noise: float = 0.8, seed: int = 0,
              frac=(0.6, 0.2, 0.2), name: str = "sbm") -> Graph:
    """Stochastic block model with community-aligned labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(num_classes, size=num_nodes).astype(np.int32)
    # Expected degree: d = p_in * n_in + p_out * n_out.
    n_in = num_nodes / num_classes
    n_out = num_nodes - n_in
    p_out = avg_degree / (p_in_out_ratio * n_in + n_out)
    p_in = p_in_out_ratio * p_out

    # Sample edges in blocks without materializing the N^2 matrix.
    # Intra-class edges are drawn PER CLASS (rejection sampling over
    # uniform pairs under-produces same-class pairs by ~num_classes x,
    # silently destroying homophily for many-class datasets).
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
    edges = np.concatenate(edges, axis=0)

    feats = _features_from_labels(labels, num_classes, feature_dim, noise,
                                  rng)
    return from_edges(num_nodes, edges, feats, labels,
                      masks=_masks(num_nodes, frac, rng), name=name)


def powerlaw_graph(num_nodes: int = 4000, num_classes: int = 8,
                   m_attach: int = 6, feature_dim: int = 64,
                   noise: float = 0.8, seed: int = 0,
                   frac=(0.6, 0.2, 0.2), name: str = "powerlaw") -> Graph:
    """Barabási–Albert preferential attachment; labels by spectral-ish
    propagation from random seeds so they correlate with structure."""
    rng = np.random.default_rng(seed)
    targets = list(range(m_attach))
    repeated: list[int] = list(range(m_attach))
    edges = []
    for v in range(m_attach, num_nodes):
        choice = rng.choice(len(repeated), size=m_attach, replace=False)
        chosen = {repeated[c] for c in choice}
        for u in chosen:
            edges.append((v, u))
            repeated.append(u)
        repeated.extend([v] * len(chosen))
    edges = np.asarray(edges, np.int64)

    # Structure-correlated labels: seed random labels, 3 rounds of majority.
    labels = rng.integers(num_classes, size=num_nodes).astype(np.int32)
    adj = [[] for _ in range(num_nodes)]
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    for _ in range(3):
        new = labels.copy()
        for v in range(num_nodes):
            if adj[v]:
                vals, cnt = np.unique(labels[adj[v]], return_counts=True)
                new[v] = vals[np.argmax(cnt)]
        labels = new

    feats = _features_from_labels(labels, num_classes, feature_dim, noise,
                                  rng)
    return from_edges(num_nodes, edges, feats, labels,
                      masks=_masks(num_nodes, frac, rng), name=name)


def community_powerlaw_graph(num_nodes: int = 40000, num_comm: int = None,
                             num_classes: int = 8, avg_degree: float = 10.0,
                             gamma: float = 2.5, p_intra: float = 0.9,
                             feature_dim: int = 64, noise: float = 0.8,
                             seed: int = 0, frac=(0.6, 0.2, 0.2),
                             name: str = "community-powerlaw") -> Graph:
    """Degree-corrected community Chung–Lu graph, fully vectorized.

    The production-scale generator: every step is a numpy bulk op (no
    per-edge Python loop, unlike :func:`powerlaw_graph`'s preferential
    attachment), so million-node instances build in seconds — big enough
    to exercise the O(E) streaming partitioner and the chunk-skipping
    kernel regime.  Nodes split into ``num_comm`` communities (default
    ``num_nodes // 100``); per-node expected degrees follow a power law
    with exponent ``gamma`` (weights ``rank^(-1/(gamma-1))``, the classic
    Chung–Lu construction), a ``p_intra`` fraction of edges sampled
    weight-proportionally *within* each community and the rest globally.
    The community structure is what gives partition-time locality work
    to do: RCM row ordering clusters each part's rows by community, so
    halo references concentrate into few slab chunks (see
    ``graph.partition``).  Labels are community-aligned (``comm %
    num_classes``) with the usual class-informative features.
    """
    rng = np.random.default_rng(seed)
    if num_comm is None:
        num_comm = max(num_nodes // 100, 8)
    comm = np.sort(rng.integers(num_comm, size=num_nodes)).astype(np.int32)
    starts = np.searchsorted(comm, np.arange(num_comm))
    ends = np.searchsorted(comm, np.arange(num_comm), side="right")
    csize = ends - starts
    # Power-law expected degrees, restarting the rank ladder inside each
    # community so every community gets its own hubs.
    rank = np.arange(num_nodes) - starts[comm] + 1.0
    w = rank ** (-1.0 / (gamma - 1.0))

    m = int(avg_degree * num_nodes / 2)
    m_in = int(p_intra * m)
    m_out = m - m_in
    edges = []
    # Intra-community edges: weight-proportional endpoints inside each
    # community, edge budget split by community size.  One cumulative-sum
    # table over all nodes serves every community (per-community CDF =
    # slice of the global cumsum minus its left edge).
    cum = np.cumsum(w)
    left = cum[starts] - w[starts]
    tot = cum[ends - 1] - left
    per = rng.multinomial(m_in, csize / max(csize.sum(), 1))
    e_comm = np.repeat(np.arange(num_comm), per)
    if len(e_comm):
        lo, width = left[e_comm], tot[e_comm]
        u = np.searchsorted(cum, lo + rng.random(len(e_comm)) * width)
        v = np.searchsorted(cum, lo + rng.random(len(e_comm)) * width)
        edges.append(np.stack([u, v], 1))
    # Global (inter-community) edges: weight-proportional over all nodes.
    if m_out:
        cdf = cum / cum[-1]
        u = np.searchsorted(cdf, rng.random(m_out))
        v = np.searchsorted(cdf, rng.random(m_out))
        edges.append(np.stack([u, v], 1))
    edges = np.concatenate(edges, axis=0)
    edges = np.minimum(edges, num_nodes - 1)

    labels = (comm % num_classes).astype(np.int32)
    feats = _features_from_labels(labels, num_classes, feature_dim, noise,
                                  rng)
    return from_edges(num_nodes, edges, feats, labels,
                      masks=_masks(num_nodes, frac, rng), name=name)


# ---------------------------------------------------------------------------
# Named dataset registry — scaled stand-ins for the paper's four benchmarks.
# (# nodes/edges scaled ~40x down to the CPU budget; density ordering and
# train-fraction profiles match Table 3 of the paper.)
# ---------------------------------------------------------------------------

def make_dataset(name: str, seed: int = 0, scale: float = 1.0) -> Graph:
    n = lambda base: max(256, int(base * scale))
    # p_in_out_ratio ≈ num_classes keeps ~50-65% of edges intra-class
    # (matching the real datasets' homophily); with the default 8 a
    # 40-class SBM would be ~17% homophilous and aggregation would mix
    # classes into the global mean.
    if name == "arxiv-sim":      # OGB-Arxiv: medium, sparse, 40 classes
        return sbm_graph(n(4200), num_classes=40, avg_degree=13.7,
                         p_in_out_ratio=60.0,
                         feature_dim=128, noise=0.7, seed=seed,
                         frac=(0.537, 0.176, 0.287), name=name)
    if name == "flickr-sim":     # Flickr: small, sparse, 7 classes
        return sbm_graph(n(2200), num_classes=7, avg_degree=10.1,
                         feature_dim=100, noise=1.0, seed=seed,
                         frac=(0.5, 0.25, 0.25), name=name)
    if name == "reddit-sim":     # Reddit: dense (deg ~100), 41 classes
        return sbm_graph(n(2900), num_classes=41, avg_degree=99.6,
                         p_in_out_ratio=60.0,
                         feature_dim=120, noise=0.8, seed=seed,
                         frac=(0.66, 0.10, 0.24), name=name)
    if name == "products-sim":   # OGB-Products: large, deg ~50, 47 classes
        return sbm_graph(n(12000), num_classes=47, avg_degree=50.5,
                         p_in_out_ratio=70.0,
                         feature_dim=100, noise=0.8, seed=seed,
                         frac=(0.08, 0.02, 0.90), name=name)
    if name == "powerlaw-sim":
        return powerlaw_graph(n(3000), seed=seed, name=name)
    if name == "papers-sim":     # OGB-Papers100M-ish: huge, power-law,
        return community_powerlaw_graph(    # community-structured
            n(40000), seed=seed, name=name)
    raise KeyError(f"unknown dataset {name!r}")


DATASETS = ["arxiv-sim", "flickr-sim", "reddit-sim", "products-sim",
            "powerlaw-sim", "papers-sim"]
