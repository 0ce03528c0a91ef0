"""Seed-batched, fanout-bounded neighbor sampling for the mini-batch
training regime (VR-GCN-style control variates, arXiv 1710.10568).

The sampler is the *host-side* half of sampled DIGEST training: built once
at partition time from the stacked per-subgraph in-ELL
(:class:`repro_torch.graph.partition.StackedPartitions` via the prepared
data dict), it draws one batch per optimizer step —

  * a **seed set** per subgraph: up to ``batch_seeds`` training rows whose
    loss terms make up this step's objective;
  * a **fanout-bounded edge sample** per local row: ``min(fanout, deg)``
    of the row's in-subgraph ELL entries, uniform without replacement,
    with the inverse-inclusion scale ``deg / n_sampled`` that makes the
    scaled sampled sum an unbiased estimator of the full neighbor sum.

The device-side estimator (``repro_torch.models.gnn.gnn_forward_sampled``)
consumes the batch as *weight masks over the existing ELL*: sampled
entries aggregate fresh representations at ``in_wts · edge_scale``, the
complement reads the historical activations at the residual weight
``in_wts − in_wts · edge_scale`` — so when ``fanout >= deg`` the scale is
exactly 1.0, the residual weight is exactly 0.0, and the estimator
collapses bitwise to the full-batch aggregation (the property the parity
tests pin).

Determinism contract: batches are a pure function of ``(seed, step)`` —
drawn from a fresh ``np.random.default_rng([seed, step])`` per step, with
no dependence on call history, process state, or device — so
any two runs (and any two mesh shapes) consume bitwise-identical batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NeighborSampler:
    """Per-subgraph neighbor sampler over the stacked in-ELL.

    Build with :func:`build_sampler`; ``sample(step)`` returns the numpy
    batch dict the sampled epoch converts to device arrays:

      seed_mask   (M, S)       bool — sampled training rows (loss mask)
      edge_scale  (M, S, Din)  f32 — deg/n_sampled at sampled entries,
                               0.0 elsewhere (multiplies ``in_wts`` into
                               the fresh-term weights)
      edge_keep   (M, S, Din)  bool — sampled-entry indicator (drives the
                               GAT masked-attention fallback)
    """
    fanout: int
    batch_seeds: int
    seed: int
    in_valid: np.ndarray     # (M, S, Din) bool — real (non-sentinel) entries
    in_deg: np.ndarray       # (M, S) int64 — valid entries per row
    train_mask: np.ndarray   # (M, S) bool
    num_parts: int
    part_rows: int
    ell_width: int

    @property
    def max_in_degree(self) -> int:
        """Largest in-ELL degree; ``fanout >= max_in_degree`` makes the
        control-variate estimator exact (full-batch parity)."""
        return int(self.in_deg.max()) if self.in_deg.size else 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, int(step)])

    def sample(self, step: int) -> dict:
        rng = self._rng(step)
        M, S, Din = self.in_valid.shape

        # Seeds: up to batch_seeds train rows per part, uniform without
        # replacement (all of them when the part has fewer).
        seed_mask = np.zeros((M, S), bool)
        for m in range(M):
            rows = np.flatnonzero(self.train_mask[m])
            if rows.size > self.batch_seeds:
                rows = rng.choice(rows, size=self.batch_seeds,
                                  replace=False)
            seed_mask[m, rows] = True

        # Edges: rank i.i.d. uniforms over each row's valid entries; the
        # n_sampled smallest are the sample — uniform without replacement,
        # fully vectorized over the stacked ELL.
        n_samp = np.minimum(self.in_deg, self.fanout)          # (M, S)
        key = np.where(self.in_valid, rng.random((M, S, Din)), 2.0)
        order = np.argsort(key, axis=-1, kind="stable")
        ranks = np.empty_like(order)
        np.put_along_axis(ranks, order,
                          np.broadcast_to(np.arange(Din), (M, S, Din)),
                          axis=-1)
        edge_keep = (ranks < n_samp[..., None]) & self.in_valid

        # Inverse-inclusion scale, pinned to exactly 1.0 when the whole
        # neighborhood is sampled (deg <= fanout) so the residual weight
        # in_wts − in_wts·scale is exactly +0.0 — the bitwise-parity case.
        deg_f = self.in_deg.astype(np.float32)
        scale = np.where(self.in_deg <= self.fanout, np.float32(1.0),
                         deg_f / np.maximum(n_samp, 1).astype(np.float32))
        edge_scale = np.where(edge_keep, scale[..., None],
                              np.float32(0.0)).astype(np.float32)
        return {"seed_mask": seed_mask, "edge_scale": edge_scale,
                "edge_keep": edge_keep}

    def full_batch(self) -> dict:
        """The deterministic full-coverage batch: every train row a seed,
        every valid edge sampled at scale 1.0 — the sampled epoch then
        reproduces the full-batch epoch bitwise (gcn/sage)."""
        return {
            "seed_mask": self.train_mask.copy(),
            "edge_scale": self.in_valid.astype(np.float32),
            "edge_keep": self.in_valid.copy(),
        }


def build_sampler(data: dict, fanout: int, batch_seeds: int,
                  seed: int = 0) -> NeighborSampler:
    """Build the sampler from a prepared data dict
    (:func:`repro_torch.core.digest.prepare_graph_data`) — partition
    time, host side, numpy only.  The dict holds tensors (on the card by
    default); ``in_nbr`` and ``train_mask`` are copied to the host once,
    here."""
    if fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    if batch_seeds < 1:
        raise ValueError(f"batch_seeds must be >= 1, got {batch_seeds}")
    in_nbr = data["struct"]["in_nbr"].cpu().numpy()
    M, S, Din = in_nbr.shape
    in_valid = in_nbr < S                       # sentinel == S
    return NeighborSampler(
        fanout=int(fanout), batch_seeds=int(batch_seeds), seed=int(seed),
        in_valid=in_valid, in_deg=in_valid.sum(axis=-1),
        train_mask=data["train_mask"].cpu().numpy().astype(bool),
        num_parts=M, part_rows=S, ell_width=Din)
