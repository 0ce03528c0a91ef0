"""Pure-torch oracle for flash attention (mirrors the reference's jnp
oracle, ``src/repro/kernels/flash_attention/ref.py``)."""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  sm_scale: float | None = None) -> torch.Tensor:
    """q, k, v: (bh, seq, head_dim).  Dense softmax(QKᵀ)V in fp32, cast
    back to q's dtype."""
    bh, seq, hd = q.shape
    if sm_scale is None:
        sm_scale = hd ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = torch.tril(torch.ones((seq, seq), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
