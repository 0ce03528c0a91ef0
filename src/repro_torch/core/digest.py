"""DIGEST data preparation and the exact full-graph forward (the forward
subset of ``src/repro/core/digest.py``; the training epoch is the next
slice of the port).

:func:`prepare_graph_data` partitions the graph with the port's own copy
of the reference partitioner, so every integer and float array equals the
reference's, and returns them as tensors on ``device``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.graph import Graph
from repro_torch.graph.partition import StackedPartitions, build_partitions
from repro_torch.kernels.spmm import STREAM_CHUNK_ROWS
from repro_torch.models.gnn import GNNConfig, gnn_forward
from repro_torch.nn import micro_f1, softmax_cross_entropy

Pytree = Any

# Output-row block of the reference's TPU kernels; the chunk worklists
# are built at this geometry so they equal the reference's.
BLOCK_ROWS = 128


def prepare_graph_data(g: Graph, num_parts: int, method: str = "greedy",
                       seed: int = 0, halo_weight: float = 0.0,
                       stream_chunk_rows: int = None, order: str = "none",
                       device="cuda") -> dict:
    """Build the tensor dict consumed by the forward and serving paths.

    Same keys and values as the reference (``halo_weight``/``order``/
    ``stream_chunk_rows`` as there), as tensors on ``device``, plus the
    host-side ``_sp`` (partition build), ``_graph`` and ``_worklist``
    entries.  Raises when ``device`` is CUDA and no card is present.
    """
    dev = resolve_device(device)
    chunk_rows = (STREAM_CHUNK_ROWS if stream_chunk_rows is None
                  else stream_chunk_rows)
    sp = build_partitions(g, num_parts, method=method, seed=seed,
                          halo_weight=halo_weight, order=order,
                          order_chunk_rows=chunk_rows)
    full = build_partitions(g, 1, method="random", seed=seed)
    x_global = np.concatenate(
        [g.features, np.zeros((1, g.features.shape[1]), np.float32)], axis=0)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def _struct(s: StackedPartitions) -> tuple:
        wl = s.chunk_worklist(chunk_rows, BLOCK_ROWS)
        return {"in_nbr": t(s.in_nbr), "in_wts": t(s.in_wts),
                "out_nbr": t(s.out_nbr), "out_wts": t(s.out_wts),
                "wl_ids": t(wl.ids), "wl_cnt": t(wl.cnt)}, wl

    struct, worklist = _struct(sp)
    full_struct, _ = _struct(full)
    plan = sp.pull_plan()
    # halo_ids with a sentinel column: gathering x_global at these ids
    # gives each subgraph's (H+1)-row halo slab, row H the zero sentinel.
    halo_ids_x = np.concatenate(
        [sp.halo_ids, np.full((sp.num_parts, 1), g.num_nodes, np.int32)],
        axis=1)
    return {
        "x_global": t(x_global),
        "struct": struct,
        "local_ids": t(sp.local_ids),
        "local_valid": t(sp.local_valid),
        "halo_ids": t(sp.halo_ids),
        "halo_valid": t(sp.halo_valid),
        "halo_ids_x": t(halo_ids_x),
        "local_slots": t(sp.local_slots),
        "local_boundary": t(sp.local_boundary),
        "halo_slots": t(sp.halo_slots),
        "store_ids": t(sp.store_ids),
        "sentinel_slots": t(sp.sentinel_slots),
        "pull_send": t(plan.send_offsets),
        "pull_recv": t(plan.recv_positions),
        "labels": t(sp.labels),
        "train_mask": t(sp.train_mask),
        "val_mask": t(sp.val_mask),
        "test_mask": t(sp.test_mask),
        # Full-graph (M=1) view for exact eval and serving.
        "full_struct": full_struct,
        "full_ids": t(full.local_ids),
        "full_valid": t(full.local_valid),
        "full_labels": t(full.labels),
        "full_train_mask": t(full.train_mask),
        "full_val_mask": t(full.val_mask),
        "full_test_mask": t(full.test_mask),
        # Host-side metadata.
        "_sp": sp,
        "_graph": g,
        "_worklist": worklist,
    }


def empty_halo_struct(cfg: GNNConfig, struct: dict, rows: int = 8
                      ) -> tuple[list, dict]:
    """Per-layer all-zero halo tables + a struct whose out-ELL is remapped
    into them — the "no out-of-subgraph information" view of the M=1
    full-graph forward.  The zero tables contribute exact ±0.0 terms."""
    dev = struct["out_nbr"].device
    tables = [torch.zeros((rows, cfg.in_dim), device=dev)]
    tables += [torch.zeros((rows, cfg.hidden_dim), device=dev)
               for _ in range(cfg.num_layers - 1)]
    struct = dict(struct)
    struct["out_nbr"] = torch.clamp_max(struct["out_nbr"], rows)
    return tables, struct


def full_graph_forward(cfg: GNNConfig, params: Pytree, data: dict
                       ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Exact (no staleness, no partition) forward; returns
    (logits (N_pad, classes), reps)."""
    x = data["x_global"][data["full_ids"][0].long()]
    struct = {k: v[0] for k, v in data["full_struct"].items()}
    tables, struct = empty_halo_struct(cfg, struct)
    return gnn_forward(cfg, params, x, tables, struct)


def top_layer_reps(cfg: GNNConfig, params: Pytree, data: dict
                   ) -> torch.Tensor:
    """h^(L-1) for every node in the full view's global-id row order
    (N_pad, hidden) — ``reps[-1]`` of :func:`full_graph_forward`, what a
    serving-store refresh pushes."""
    if cfg.num_layers < 2:
        raise ValueError("serving from stored representations needs "
                         "num_layers >= 2 (a 1-layer GNN reads raw "
                         "features; there is no (L-1)-layer row to store)")
    _, reps = full_graph_forward(cfg, params, data)
    return reps[-1]


def evaluate(cfg: GNNConfig, params: Pytree, data: dict) -> dict:
    """Micro-F1 and loss of the full-graph forward on each split."""
    logits, _ = full_graph_forward(cfg, params, data)
    out = {}
    for split in ("train", "val", "test"):
        mask = data[f"full_{split}_mask"][0].float()
        out[f"{split}_f1"] = micro_f1(logits, data["full_labels"][0], mask)
        out[f"{split}_loss"] = softmax_cross_entropy(
            logits, data["full_labels"][0], mask)
    return out
