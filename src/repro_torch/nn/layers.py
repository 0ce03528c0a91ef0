"""Functional layer primitives shared by the GNN and transformer stacks."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., in) @ w: (in, out) [+ b] — a plain matrix product, left to
    the framework as the reference leaves it to XLA."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


class _TakeRows(torch.autograd.Function):
    """``table[idx]`` on the CPU whose backward adds the rows back in
    index order (``index_add_``).

    Autograd's own backward of an index is ``index_put_`` with
    ``accumulate=True``: on CUDA a sort-based kernel that gives the same
    bits run to run, but on the CPU a parallel accumulation whose order
    (and so whose rounding) changes with the threads' timing once a
    gradient is large enough to be split among threads."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        flat_idx = idx.reshape(-1)
        flat = grad.reshape((flat_idx.numel(),) + tuple(ctx.table_shape[1:]))
        return grad.new_zeros(ctx.table_shape).index_add_(0, flat_idx,
                                                          flat), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (rows of dim 0, ``idx`` int64 of any shape) with a
    backward that gives the same bits on every run, on every device: on
    the CPU under grad through :class:`_TakeRows`, elsewhere autograd's
    own."""
    if (table.device.type == "cpu" and torch.is_grad_enabled()
            and table.requires_grad):
        return _TakeRows.apply(table, idx)
    return table[idx]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in fp32 with the ``1 + scale`` form (zero-initialised
    scales), cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = dense(x, w_gate)
    u = dense(x, w_up)
    return dense(F.silu(g) * u, w_down)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq).  Rotates the two halves of the head dim in fp32."""
    inv = rope_freqs(x.shape[-1], theta, x.device)     # (hd/2,)
    ang = positions[..., :, None].float() * inv    # (..., seq, hd/2)
    sin = torch.sin(ang)[..., :, None, :]          # (..., seq, 1, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


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
