"""Attention of the LM transformer: GQA + RoPE + qk-norm, full /
sliding-window / chunked (flash-style) prefill, KV-cache decode, and
cross-attention (VLM).

Backend policy of :func:`prefill_attention` (``ArchConfig.attn_backend``):

  * ``"kernel"`` → K6, the hand-written flash-attention
    kernel (:mod:`repro_torch.kernels.flash_attention`) on CUDA tensors,
    its plain version on CPU tensors — the counterpart of the reference's
    ``"pallas"``.
  * ``"dense"`` → the dense oracle (``attention_ref``), no kernel.
  * ``"chunked"`` → :func:`chunked_attention`, a loop over KV chunks with
    online softmax in plain PyTorch (also every ``window > 0`` call).
  * decode (1 token) → :func:`decode_attention`, a plain einsum over the
    cache.
  * text-to-vision (``xattn`` blocks) → :func:`cross_attention`, a plain
    einsum with no mask, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import multi_head_attention

NEG_INF = -1e30
BACKENDS = ("kernel", "dense", "chunked")


def repeat_kv(k: torch.Tensor, rep: int) -> torch.Tensor:
    """(B, S, KV, D) → (B, S, KV * rep, D), each KV head repeated in
    place (``jnp.repeat`` on axis 2)."""
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True, window: int = 0,
                      chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Flash-style attention as a loop over KV chunks (plain PyTorch).

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D).  ``window`` > 0 limits
    attention to the last ``window`` positions (sliding window).
    ``q_offset`` is the absolute position of q[0].  As in the reference,
    the scaled Q and the probabilities are rounded to the input dtype
    before their products, which accumulate in fp32.  The last chunk may
    be short: the reference pads it with masked keys, which add exact 0.
    """
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    chunk = min(chunk, sk)
    q_s = (q * d ** -0.5).to(q.dtype).float().transpose(1, 2)  # (B,H,Sq,D)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for k0 in range(0, sk, chunk):
        kci = repeat_kv(k[:, k0:k0 + chunk], rep)          # (B, C, H, D)
        vci = repeat_kv(v[:, k0:k0 + chunk], rep)
        s = torch.matmul(q_s, kci.float().permute(0, 2, 3, 1))
        k_pos = torch.arange(k0, k0 + kci.shape[1], device=q.device)
        mask = torch.ones((sq, kci.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window > 0:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(vci.dtype).float(), vci.float().transpose(1, 2))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                # (B, Sq, H, D)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, window: int = 0, backend: str = "kernel",
                      chunk: int = 1024) -> torch.Tensor:
    """Training/prefill attention with backend dispatch (module
    docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f"attention backend {backend!r} not in {BACKENDS}")
    if backend == "kernel" and window == 0:
        return multi_head_attention(q, k, v, causal=True, backend="auto")
    if backend == "dense" and window == 0:
        return multi_head_attention(q, k, v, causal=True, backend="jnp")
    return chunked_attention(q, k, v, causal=True, window=window,
                             chunk=chunk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """One-token decode: q (B, 1, H, D) vs cache (B, S, KV, D).

    ``pos`` (B,) is the index of the new token (cache entries > pos are
    invalid).
    """
    b, _, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    rep = h // kv
    q32 = q[:, 0].float() * d ** -0.5                      # (B, H, D)
    kf = repeat_kv(k_cache, rep).float()                   # (B, S, H, D)
    vf = repeat_kv(v_cache, rep).float()
    logits = torch.einsum("bhd,bshd->bhs", q32, kf)
    k_pos = torch.arange(s, device=q.device)
    mask = k_pos[None, :] <= pos[:, None]                  # (B, S)
    if window > 0:
        mask = mask & (pos[:, None] - k_pos[None, :] < window)
    logits = torch.where(mask[:, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, vf)
    return out[:, None].to(q.dtype)                        # (B, 1, H, D)


def cross_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Text-to-vision cross attention (no mask), in fp32.  q: (B, S, H, D);
    k, v: (B, P, KV, D)."""
    rep = q.shape[2] // k.shape[2]
    kf = repeat_kv(k, rep).float()
    vf = repeat_kv(v, rep).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * q.shape[-1] ** -0.5, kf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
