"""The adjacency and the partition, worked out again from the edge list.

``adjacency`` symmetrises and de-duplicates the drawn edges (self loops
dropped) into a CSR sorted by (row, column), and gives GCN's propagation
weights ``P = D^-1/2 (A + I) D^-1/2`` over it.  ``greedy_partition`` is
the LDG-style streaming partition over a depth-first order from random
roots that the configuration names ("greedy", ``halo_weight`` 0): a
node goes to the part holding most of its assigned neighbours, scaled
by the part's free capacity, ties to the emptiest part.  The same graph
and seed give the same assignment as the program's partitioner, so the
two sides train on the same subgraphs.
"""
from __future__ import annotations

import numpy as np
import torch


def adjacency(num_nodes: int, edges: np.ndarray, device) -> dict:
    """CSR of the undirected graph and P's COO (self loops appended):
    ``{"indptr", "indices"}`` as host int64 / int32 arrays, ``{"rows",
    "cols", "wts"}`` as tensors on ``device`` (int64, float32)."""
    e = torch.from_numpy(np.asarray(edges, np.int64)).to(device)
    e = e[e[:, 0] != e[:, 1]]
    both = torch.cat([e, e.flip(1)])
    key = torch.unique(both[:, 0] * num_nodes + both[:, 1])   # sorted
    rows, cols = key // num_nodes, key % num_nodes
    indptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=num_nodes), 0)
    loop = torch.arange(num_nodes, device=device)
    p_rows = torch.cat([rows, loop])
    p_cols = torch.cat([cols, loop])
    deg = torch.bincount(p_rows, minlength=num_nodes).double()
    dinv = 1.0 / torch.sqrt(torch.clamp_min(deg, 1.0))
    wts = (dinv[p_rows] * dinv[p_cols]).float()
    return {"indptr": indptr.cpu().numpy(),
            "indices": cols.to(torch.int32).cpu().numpy(),
            "rows": p_rows, "cols": p_cols, "wts": wts}


def _dfs_order(indptr: np.ndarray, indices: np.ndarray,
               rng: np.random.Generator) -> np.ndarray:
    """Visit order: roots in a random permutation; from each, a stack
    that pops the newest node and pushes its unseen neighbours in CSR
    order."""
    n = len(indptr) - 1
    order = np.empty(n, np.int64)
    seen = np.zeros(n, bool)
    stack = np.empty(n, np.int64)
    pos = 0
    for root in rng.permutation(n):
        if seen[root]:
            continue
        stack[0] = root
        top = 1
        seen[root] = True
        while top:
            top -= 1
            v = stack[top]
            order[pos] = v
            pos += 1
            ns = indices[indptr[v]:indptr[v + 1]]
            new = ns[~seen[ns]]
            if len(new):
                seen[new] = True
                stack[top:top + len(new)] = new
                top += len(new)
    return order


def greedy_partition(indptr: np.ndarray, indices: np.ndarray,
                     num_parts: int, seed: int = 0,
                     slack: float = 1.05) -> np.ndarray:
    """(N,) int32 part of every node."""
    n = len(indptr) - 1
    rng = np.random.default_rng(seed)
    capacity = slack * n / num_parts
    assign = np.full(n, -1, np.int32)
    sizes = np.zeros(num_parts, np.int64)
    for v in _dfs_order(indptr, indices, rng):
        assigned = assign[indices[indptr[v]:indptr[v + 1]]]
        counts = np.bincount(assigned[assigned >= 0],
                             minlength=num_parts).astype(np.float64)
        score = counts * (1.0 - sizes / capacity)
        score += 1e-9 * (capacity - sizes)
        best = int(np.argmax(score))
        assign[v] = best
        sizes[best] += 1
    return assign
