"""Stale-KV block attention — DIGEST's mechanism applied to long context.

A token attending over a long history is the transformer analogue of a
GNN node aggregating over a huge neighbourhood.  Following Eq. 4 of the
paper the "neighbours" are split:

  * in-subgraph → the local window (last W positions): attended exactly,
    from a ring-buffer KV cache;
  * out-of-subgraph → everything older: attended through a **stale
    summary table** (mean-pooled KV per R-token block) that is only
    updated ("pushed") once per R decode steps — periodic stale
    synchronisation.

Cost per decode step: O(W + S/R) instead of O(S).  The two partial
attentions are merged with the online-softmax combine, so the local part
is exact and only the far field is approximated.

Unlike the reference, whose arrays are immutable, :func:`stale_kv_decode`
writes the new K/V rows and the pushed summary into the cache's tensors
in place (no copy of the cache per step) and returns the same tensors.
The push is branch-free: the summary slot is rewritten every step, with
the pooled block on a push step and with its own value otherwise, so the
step never reads a position back to the host.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.attention import repeat_kv

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class StaleKVConfig:
    max_seq: int          # S
    window: int = 4096    # W — exact local span
    ratio: int = 64       # R — tokens per stale summary slot

    @property
    def num_slots(self) -> int:
        return self.max_seq // self.ratio


def init_stale_kv_cache(cfg: StaleKVConfig, batch: int, kv_heads: int,
                        head_dim: int, dtype=torch.bfloat16,
                        device="cuda") -> dict:
    def zeros(n):
        return torch.zeros((batch, n, kv_heads, head_dim), dtype=dtype,
                           device=device)

    return {"k_win": zeros(cfg.window), "v_win": zeros(cfg.window),
            "k_sum": zeros(cfg.num_slots), "v_sum": zeros(cfg.num_slots),
            # Pending block accumulator (the not-yet-pushed fresh rows).
            "k_pend": zeros(cfg.ratio), "v_pend": zeros(cfg.ratio)}


def _partial_attn(q32: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> tuple:
    """(m, l, acc) online-softmax partials.

    q32: (B, H, D) f32 (pre-scaled); k, v: (B, T, H, D); mask: (B, T)."""
    s = torch.einsum("bhd,bthd->bht", q32, k.float())
    s = torch.where(mask[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                                     # (B, H)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bht,bthd->bhd", p, v.float())
    return m, l, acc


def _merge(p1, p2):
    m1, l1, a1 = p1
    m2, l2, a2 = p2
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return m, c1 * l1 + c2 * l2, c1[..., None] * a1 + c2[..., None] * a2


def stale_kv_decode(cfg: StaleKVConfig, cache: dict, q: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    pos: torch.Tensor) -> tuple:
    """One decode step with stale far-field attention.

    q: (B, 1, H, D); k_new, v_new: (B, 1, KV, D); pos: (B,) current index
    (the same for every row; pos[0] drives the ring and the push).
    Returns (attn_out (B, 1, H, D), cache), the cache updated in place.
    """
    b, _, h, d = q.shape
    rep = h // k_new.shape[2]
    p = pos[:1].long()                                     # (1,)

    # --- cache writes -----------------------------------------------------
    win_slot = p % cfg.window
    pend_slot = p % cfg.ratio
    cache["k_win"].index_copy_(1, win_slot, k_new)
    cache["v_win"].index_copy_(1, win_slot, v_new)
    cache["k_pend"].index_copy_(1, pend_slot, k_new)
    cache["v_pend"].index_copy_(1, pend_slot, v_new)

    # Periodic PUSH: a completed R-block → its mean-pooled stale summary.
    push = pend_slot == cfg.ratio - 1
    slot = torch.clamp_max(p // cfg.ratio, cfg.num_slots - 1)
    for name in ("k", "v"):
        pooled = cache[f"{name}_pend"].float().mean(
            dim=1, keepdim=True).to(cache[f"{name}_sum"].dtype)
        old = cache[f"{name}_sum"].index_select(1, slot)
        cache[f"{name}_sum"].index_copy_(1, slot,
                                         torch.where(push, pooled, old))

    # --- attention ---------------------------------------------------------
    q32 = q[:, 0].float() * d ** -0.5

    # Local window (exact): ring index i holds absolute position abs_pos[i],
    # valid iff it lies in (p - window, p].
    idx = torch.arange(cfg.window, device=q.device)
    abs_pos = torch.where(idx <= win_slot, p - win_slot + idx,
                          p - win_slot + idx - cfg.window)
    win_mask = (abs_pos >= 0) & (abs_pos > p - cfg.window) & (abs_pos <= p)
    part_local = _partial_attn(
        q32, repeat_kv(cache["k_win"], rep), repeat_kv(cache["v_win"], rep),
        win_mask[None].expand(b, cfg.window))

    # Stale far field: only slots fully outside the local window.
    slots = torch.arange(cfg.num_slots, device=q.device)
    slot_end = (slots + 1) * cfg.ratio - 1
    sum_mask = slot_end < torch.clamp_min(p - cfg.window + 1, 0)
    m_f, l_f, a_f = _partial_attn(
        q32, repeat_kv(cache["k_sum"], rep), repeat_kv(cache["v_sum"], rep),
        sum_mask[None].expand(b, cfg.num_slots))
    # Weight each summary slot by the R tokens it stands for.
    part_far = (m_f, l_f * cfg.ratio, a_f * cfg.ratio)

    m, l, acc = _merge(part_local, part_far)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out[:, None].to(q.dtype), cache


def summaries_from_full_kv(cfg: StaleKVConfig, k_full: torch.Tensor,
                           v_full: torch.Tensor) -> tuple:
    """Prefill→decode transition: pool an existing (B, S, KV, D) cache
    into the stale summary table."""
    b, s, kv, d = k_full.shape
    n = s // cfg.ratio

    def pool(t):
        return t[:, :n * cfg.ratio].reshape(b, n, cfg.ratio, kv, d).float(
        ).mean(dim=2).to(t.dtype)

    return pool(k_full), pool(v_full)
