"""Analytic communication/time model — paper §3.3 complexity, with hardware
constants — behind the speedup tables (Table 1 / Fig. 4 / Fig. 5): one card
has no interconnect to measure, so the per-epoch wire bytes are counted
from the partition and turned into time by datasheet rates.

Per-epoch communication:
  partition:    params only                      O(M·|W|)
  digest:       params + (pull halo + push local)·d·(L-1)/N    [amortized]
  propagation:  params + fresh k-hop halos every epoch, k = 1..L-1
                (neighbor explosion: the ℓ-th layer's exact recompute needs
                 the ℓ-hop halo)

A copy of ``src/repro/core/comm_model.py`` re-rooted on the port's
``HaloPrecision``, ``Graph`` and ``StackedPartitions``: given the same
constants every number equals the reference's.  Only the default
constants differ — they are an H100's (:class:`CommConstants`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.halo_exchange import HaloPrecision
from repro_torch.graph.graph import Graph
from repro_torch.graph.partition import StackedPartitions


@dataclasses.dataclass(frozen=True)
class CommConstants:
    """One NVIDIA H100 SXM5 80 GB and its NVLink 4.  Datasheet figures,
    not measurements: the model's times are analytic.  The field
    semantics are the reference's (``t_comm = bytes / (M ·
    link_bandwidth)``, ``t_compute = flops / flops``)."""
    # One direction of NVLink 4's 900 GB/s per GPU (NVIDIA H100 datasheet).
    link_bandwidth: float = 450e9
    # Dense bf16 tensor-core peak, no sparsity (NVIDIA H100 datasheet).
    flops: float = 989.4e12
    bytes_per_scalar: int = 4         # fp32 representations and params


def khop_halo_sizes(g: Graph, sp: StackedPartitions, k_max: int
                    ) -> np.ndarray:
    """(M, k_max) — size of the k-hop halo of each subgraph (BFS on host)."""
    M = sp.num_parts
    out = np.zeros((M, k_max), np.int64)
    assign = np.full(g.num_nodes, -1, np.int64)
    for m in range(M):
        loc = sp.local_ids[m][sp.local_valid[m]]
        assign[loc] = m
    for m in range(M):
        frontier = set(sp.local_ids[m][sp.local_valid[m]].tolist())
        visited = set(frontier)
        halo_total: set = set()
        for k in range(k_max):
            nxt = set()
            for v in frontier:
                for u in g.neighbors(int(v)):
                    if u not in visited:
                        visited.add(u)
                        nxt.add(int(u))
            halo_total |= nxt
            out[m, k] = len(halo_total)
            frontier = nxt
    return out


def epoch_comm_bytes(mode: str, sp: StackedPartitions, g: Graph,
                     param_count: int, hidden: int, num_layers: int,
                     sync_interval: int = 10,
                     consts: CommConstants = CommConstants(),
                     halo_precision: Optional[HaloPrecision] = None
                     ) -> float:
    """Per-epoch wire bytes.  ``halo_precision`` (digest only) swaps the
    §3.3 pull/push terms onto the HaloExchange wire format: compact
    boundary rows in fp32/bf16/int8(+scale) instead of dense fp32."""
    B = consts.bytes_per_scalar
    M = sp.num_parts
    params_bytes = 2.0 * M * param_count * B           # broadcast + reduce
    L1 = max(num_layers - 1, 0)
    if mode == "partition":
        return params_bytes
    halo1 = sp.halo_valid.sum(axis=1).astype(np.float64)       # (M,)
    local = sp.local_valid.sum(axis=1).astype(np.float64)
    if mode == "digest":
        if halo_precision is not None:
            rb = halo_precision.row_bytes(hidden)
            pull = float(sp.pull_rows()) * L1 * rb
            push = float(sp.push_rows()) * L1 * rb
        else:
            pull = float(halo1.sum()) * hidden * L1 * B
            push = float(local.sum()) * hidden * L1 * B
        return params_bytes + (pull + push) / sync_interval
    if mode == "propagation":
        khop = khop_halo_sizes(g, sp, L1) if L1 else np.zeros((M, 0))
        fresh = float(khop.sum()) * hidden * B
        return params_bytes + fresh
    raise ValueError(mode)


def epoch_time_model(mode: str, sp: StackedPartitions, g: Graph,
                     param_count: int, hidden: int, num_layers: int,
                     feature_dim: int, sync_interval: int = 10,
                     consts: CommConstants = CommConstants()) -> dict:
    """Compute + communication per-epoch time under the analytic model."""
    M = sp.num_parts
    S = float(sp.local_valid.sum(axis=1).max())
    deg = float((sp.in_wts > 0).sum() + (sp.out_wts > 0).sum()) / max(
        sp.local_valid.sum(), 1)
    # Per-device FLOPs: L·(aggregation 2·S·deg·d + dense 2·S·d·d).
    d = hidden
    flops = num_layers * (2 * S * deg * d + 2 * S * max(d, feature_dim) * d)
    t_compute = flops / consts.flops
    comm = epoch_comm_bytes(mode, sp, g, param_count, hidden, num_layers,
                            sync_interval, consts)
    t_comm = comm / (M * consts.link_bandwidth)
    return {"bytes": comm, "t_compute": t_compute, "t_comm": t_comm,
            "t_epoch": t_compute + t_comm}
