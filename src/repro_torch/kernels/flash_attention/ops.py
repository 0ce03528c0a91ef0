"""Public attention entry point with backend dispatch.

Takes (batch, seq, heads, head_dim) with GQA K/V (fewer kv heads), as the
reference's ``multi_head_attention`` does.  ``backend``:

  * ``"auto"`` — K6 (:func:`.flash_attention.flash_attention_cuda`): the
    kernel on CUDA tensors, its plain version on CPU tensors.  K/V heads
    are read in place (no repeat) through a strided (B, H, S, D) view.
  * ``"jnp"`` — the dense oracle :func:`.ref.attention_ref` on the
    reference's flattened layout, K/V heads repeated first.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import attention_ref

BACKENDS = ("auto", "jnp")


def multi_head_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, causal: bool = True,
                         backend: str = "auto") -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, KV, D) with H % KV == 0.

    Returns (B, S, H, D).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    b, s, h, d = q.shape
    if backend == "auto":
        out = flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal)
        return out.transpose(1, 2)
    rep = h // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, s, d)
    kf = k.transpose(1, 2).reshape(b * h, s, d)
    vf = v.transpose(1, 2).reshape(b * h, s, d)
    out = attention_ref(qf, kf, vf, causal=causal)
    return out.reshape(b, h, s, d).transpose(1, 2)
