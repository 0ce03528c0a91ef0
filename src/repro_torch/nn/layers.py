"""Functional layer primitives of the GNN stack."""
from __future__ import annotations

from typing import Optional

import torch


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., in) @ w: (in, out) [+ b] — a plain matrix product, left to
    the framework as the reference leaves it to XLA."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean CE over (optionally masked) positions. labels: int ids."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    pred = torch.argmax(logits, dim=-1)
    hit = (pred == labels).float()
    if mask is None:
        return torch.mean(hit)
    mask = mask.float()
    return torch.sum(hit * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def micro_f1(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Micro-averaged F1 == accuracy for single-label classification; kept
    as a named metric to mirror the paper's reporting."""
    return accuracy(logits, labels, mask)
