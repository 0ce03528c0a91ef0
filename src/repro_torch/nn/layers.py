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


def count_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)`` for ids known to lie in
    ``[0, n)``: an ``n``-long int64 count by ``scatter_add_``, whose
    shape is static, so it runs on meta tensors too (bincount has no meta
    kernel and sizes its result from the data).  Integer adds are exact:
    the same counts on every device."""
    flat = ids.reshape(-1).long()
    return torch.zeros((n,), dtype=torch.int64, device=ids.device
                       ).scatter_add_(0, flat, torch.ones_like(flat))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in fp32 with the ``1 + scale`` form (zero-initialised
    scales), cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm with its statistics in fp32 (the biased variance, as
    ``jnp.var``), cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = dense(x, w_gate)
    u = dense(x, w_up)
    return dense(F.silu(g) * u, w_down)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    return dense(gelu(dense(x, w_up)), w_down)


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


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's negative log-likelihood of its label, in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       offset: int, group=None) -> torch.Tensor:
    """:func:`token_nll` of logits whose vocabulary is cut over the ranks
    of ``group``: ``logits`` is this rank's block, the columns
    ``[offset, offset + logits.shape[-1])``.  The max is taken over the
    ranks (one gather); each rank's sum of exponentials and its share of
    the label's logit (the rank that owns the id gives it, the others 0)
    are added in rank order (one gather, ``core.collectives.ordered_sum``,
    whose backward hands each rank its share's gradient).  The gradient
    of a block is its softmax block minus its one-hot block.  Every rank
    returns the same bits."""
    # Imported here: repro_torch.core imports this package.
    from repro_torch.core import collectives
    logits = logits.float()
    peak = torch.stack(collectives.all_gather(
        logits.detach().amax(dim=-1), group)).amax(dim=0)
    local = labels.long() - offset
    mine = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])
    both = collectives.ordered_sum(torch.stack(
        [torch.sum(torch.exp(logits - peak[..., None]), dim=-1),
         torch.where(mine, gold[..., 0], 0.0)]), group)
    return peak + torch.log(both[0]) - both[1]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean CE over (optionally masked) positions. labels: int ids."""
    nll = token_nll(logits, labels)
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
