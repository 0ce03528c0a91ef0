"""Graph containers: host-side CSR plus jit-friendly padded ELL forms.

TPU adaptation note (DESIGN.md §3): neighbor aggregation on TPU wants an
*affine* access pattern, so the runtime format is degree-padded ELL
(``(num_nodes, max_degree)`` neighbor-id and weight matrices) rather than
CSR+scatter.  Padding entries point at a sentinel row with weight 0.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    """Undirected graph in CSR with node features/labels (host side)."""

    indptr: np.ndarray       # (N+1,) int64
    indices: np.ndarray      # (E,) int32 — column ids, sorted per row
    features: np.ndarray     # (N, d) float32
    labels: np.ndarray       # (N,) int32
    train_mask: np.ndarray   # (N,) bool
    val_mask: np.ndarray     # (N,) bool
    test_mask: np.ndarray    # (N,) bool
    name: str = "graph"

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def validate(self) -> None:
        n = self.num_nodes
        assert self.indptr[0] == 0 and self.indptr[-1] == len(self.indices)
        assert np.all(np.diff(self.indptr) >= 0)
        assert self.indices.min(initial=0) >= 0
        assert self.indices.max(initial=-1) < n
        assert self.features.shape[0] == n
        assert self.labels.shape[0] == n


def from_edges(num_nodes: int, edges: np.ndarray, features: np.ndarray,
               labels: np.ndarray, masks: Optional[tuple] = None,
               name: str = "graph") -> Graph:
    """Build a symmetrized, dedup'd CSR graph from an (E, 2) edge list."""
    e = np.asarray(edges, np.int64)
    e = e[e[:, 0] != e[:, 1]]                       # drop self loops (P adds them)
    both = np.concatenate([e, e[:, ::-1]], axis=0)  # symmetrize
    key = both[:, 0] * num_nodes + both[:, 1]
    both = both[np.unique(key, return_index=True)[1]]
    order = np.lexsort((both[:, 1], both[:, 0]))
    both = both[order]
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.add.at(indptr, both[:, 0] + 1, 1)
    indptr = np.cumsum(indptr)
    if masks is None:
        n = num_nodes
        idx = np.random.default_rng(0).permutation(n)
        tr, va = int(0.6 * n), int(0.8 * n)
        train = np.zeros(n, bool); train[idx[:tr]] = True
        val = np.zeros(n, bool); val[idx[tr:va]] = True
        test = np.zeros(n, bool); test[idx[va:]] = True
        masks = (train, val, test)
    return Graph(indptr=indptr, indices=both[:, 1].astype(np.int32),
                 features=np.asarray(features, np.float32),
                 labels=np.asarray(labels, np.int32),
                 train_mask=masks[0], val_mask=masks[1], test_mask=masks[2],
                 name=name)


def gcn_norm_weights(g: Graph, add_self_loops: bool = True
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """GCN propagation P = D^{-1/2} (A + I) D^{-1/2} in COO.

    Returns (rows, cols, weights) including self loops.
    """
    rows = np.repeat(np.arange(g.num_nodes, dtype=np.int32),
                     g.degrees().astype(np.int64))
    cols = g.indices.astype(np.int32)
    if add_self_loops:
        loop = np.arange(g.num_nodes, dtype=np.int32)
        rows = np.concatenate([rows, loop])
        cols = np.concatenate([cols, loop])
    deg = np.zeros(g.num_nodes, np.float64)
    np.add.at(deg, rows, 1.0)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    w = (dinv[rows] * dinv[cols]).astype(np.float32)
    return rows, cols, w


@dataclasses.dataclass
class EllMatrix:
    """Padded ELL sparse matrix: out[i] = sum_k w[i,k] * x[nbr[i,k]]."""

    nbr: np.ndarray   # (rows, max_deg) int32 — column index; sentinel = n_cols
    wts: np.ndarray   # (rows, max_deg) float32 — 0 at padding
    n_cols: int       # logical column count (sentinel row appended at n_cols)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nbr.shape[0], self.n_cols)

    @property
    def max_degree(self) -> int:
        return self.nbr.shape[1]

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, np.float64)
        rows = np.repeat(np.arange(self.nbr.shape[0]), self.nbr.shape[1])
        cols = self.nbr.reshape(-1)
        vals = self.wts.reshape(-1).astype(np.float64)
        keep = cols < self.n_cols
        np.add.at(out, (rows[keep], cols[keep]), vals[keep])
        return out.astype(np.float32)


def coo_to_ell(rows: np.ndarray, cols: np.ndarray, wts: np.ndarray,
               n_rows: int, n_cols: int, min_pad: int = 1,
               pad_multiple: int = 1) -> EllMatrix:
    """Convert COO to padded ELL. Padding slots point at column ``n_cols``."""
    order = np.argsort(rows, kind="stable")
    rows, cols, wts = rows[order], cols[order], wts[order]
    counts = np.zeros(n_rows, np.int64)
    np.add.at(counts, rows, 1)
    max_deg = max(int(counts.max(initial=0)), min_pad)
    if pad_multiple > 1:
        max_deg = ((max_deg + pad_multiple - 1) // pad_multiple) * pad_multiple
    nbr = np.full((n_rows, max_deg), n_cols, np.int32)
    w = np.zeros((n_rows, max_deg), np.float32)
    start = np.zeros(n_rows + 1, np.int64)
    start[1:] = np.cumsum(counts)
    slots = np.arange(len(rows), dtype=np.int64) - start[rows]
    nbr[rows, slots] = cols
    w[rows, slots] = wts
    return EllMatrix(nbr=nbr, wts=w, n_cols=n_cols)
