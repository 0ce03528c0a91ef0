"""Transposed ELL of an ELL adjacency, built on the host (numpy only).

The ELL SpMM ``out[i] = sum_k wts[i, k] * table[nbr[i, k]]`` has the
table gradient

    dtable[j] = sum over (i, k) with nbr[i, k] == j of wts[i, k] * g[i].

A scatter-add over the ELL would need atomics (summing in a run-to-run
order), so the backward kernel gathers instead, through this transpose:
row ``j`` of ``pos`` lists the flat ELL positions ``p = i * deg + k`` with
``nbr[i, k] == j`` in ascending ``p`` (a stable argsort), padded to the
widest row with ``rows * deg`` (one past the last position).  ``wts``
changes every epoch for GAT and SAGE, so the transpose holds positions,
not weights: the backward reads ``wts.flatten()[p]`` and ``g[p // deg]``
at run time.

The last table row is the layout's zero sentinel, which every padding
slot of the ELL points at.  It is a constant of the layout, never a
differentiated row, so its positions are left out (its row of ``pos`` is
all padding) — otherwise the padding of every short row would pile up in
one list as long as the ELL's whole slack.
"""
from __future__ import annotations

import numpy as np


def ell_transpose(nbr: np.ndarray, n_tab: int) -> np.ndarray:
    """Transposed ELL of ``nbr`` over a ``n_tab``-row table (sentinel row
    ``n_tab - 1`` included).

    Args:
      nbr: (rows, deg) or (M, rows, deg) integer row ids < ``n_tab``.
    Returns:
      int32 (n_tab, t_deg) or (M, n_tab, t_deg) positions, ascending in
      each row and padded with ``rows * deg``; ``t_deg`` is the most
      positions any non-sentinel row has (at least 1), shared by the M
      stacked views.
    """
    nbr = np.asarray(nbr)
    stacked = nbr.ndim == 3
    if not stacked:
        nbr = nbr[None]
    if nbr.ndim != 3:
        raise ValueError(f"nbr must be (rows, deg) or (M, rows, deg), got "
                         f"shape {nbr.shape}")
    m, rows, deg = nbr.shape
    flat = nbr.reshape(m, rows * deg).astype(np.int64)
    if flat.size and (flat.min() < 0 or flat.max() >= n_tab):
        raise ValueError(f"nbr ids must lie in [0, {n_tab})")
    sentinel = n_tab - 1
    counts = np.stack([np.bincount(f, minlength=n_tab) for f in flat])
    counts[:, sentinel] = 0
    t_deg = max(int(counts.max()) if counts.size else 0, 1)
    pos = np.full((m, n_tab, t_deg), rows * deg, np.int32)
    for b in range(m):
        order = np.argsort(flat[b], kind="stable")        # ascending p
        ids = flat[b][order]
        keep = ids != sentinel
        order, ids = order[keep], ids[keep]
        # Slot of each position inside its row: its rank among equal ids.
        starts = np.concatenate([[0], np.cumsum(counts[b])[:-1]])
        slot = np.arange(ids.size) - starts[ids]
        pos[b, ids, slot] = order
    return pos if stacked else pos[0]
