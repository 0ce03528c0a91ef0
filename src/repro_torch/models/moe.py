"""Mixture-of-Experts FFN: the reference's two implementations, one math.

* :func:`moe_ref`: exact dropless MoE (every expert on every token) — the
  oracle of the tests and what ``moe_impl="auto"`` runs on one device.
* :func:`moe_ep`: the capacity path.  Each token's top-k assignments are
  ranked by (expert, arrival order); each expert takes its first
  ``capacity`` rows (overflow dropped, Switch-style) as one static
  (E, C, d) batch for the dense expert products.  Only its single-device
  branch is ported: expert parallelism over a ``DeviceMesh`` is
  ROADMAP.md §1 item 8e.

The arithmetic is the reference's (``src/repro/models/moe.py``): the
router in fp32, the capacity ``max(int(cf * T * k / E), 1)`` in Python
floats, a stable sort, the drop slot at row T.  Two differences of
mechanism, none of arithmetic:

* The reference combines the experts' outputs by one scatter-add
  (``out.at[sel_tok].add``), which visits a token's contributions in
  ascending expert order from 0.  Float atomics (``index_add_`` on CUDA)
  would add them in any order once k > 1, so here each token gathers its
  at most k contributions, ordered by expert, and sums them in that
  order from 0: the same additions, the same bits run to run.
* The gathers differentiate through ``nn.take_rows``, whose backward
  adds rows in a fixed order on the CPU too (autograd's own is a
  parallel accumulation there).
* The expert products of bf16 activations are bf16 products summed in
  fp32 (the reference's ``preferred_element_type=f32``): here the bf16
  operands are widened to fp32, exactly, and multiplied in fp32.

Plain matrix products go to ``torch.matmul``, as the reference leaves
them to XLA: no TPU kernel is on this path.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.nn.layers import take_rows


def _expert_ffn_batched(xs: torch.Tensor, w_gate: torch.Tensor,
                        w_up: torch.Tensor,
                        w_down: torch.Tensor) -> torch.Tensor:
    """Capacity-batched SwiGLU.  xs: (E_loc, C_e, d); weights (E_loc, d,
    f).  Weights are rounded to xs's dtype, products summed in fp32; the
    hidden activation is rounded to xs's dtype.  Returns fp32."""
    def mm(a, w):
        return torch.bmm(a.float(), w.to(xs.dtype).float())

    h = (F.silu(mm(xs, w_gate)) * mm(xs, w_up)).to(xs.dtype)
    return mm(h, w_down)


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, k: int) -> tuple:
    """Returns (weights (T, k) f32, ids (T, k) int32, logits (T, E) f32):
    the top-k router logits in descending order and their softmax."""
    logits = torch.matmul(x_flat.float(), router_w.float())
    top_vals, top_ids = torch.topk(logits, k, dim=-1)
    weights = torch.softmax(top_vals, dim=-1)
    return weights, top_ids.int(), logits


def load_balance_loss(logits: torch.Tensor, ids: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * Σ_e f_e · p_e (f: the top-1 dispatch
    fraction, p: the mean router probability)."""
    probs = torch.softmax(logits.float(), dim=-1)
    p_mean = probs.mean(dim=0)
    one_hot = F.one_hot(ids[:, 0].long(), num_experts).float()
    f_mean = one_hot.mean(dim=0)
    return num_experts * torch.sum(f_mean * p_mean)


def moe_ref(x: torch.Tensor, params: dict, k: int) -> torch.Tensor:
    """Exact dropless MoE (all experts on all tokens).  x: (B, S, d);
    params: router (d, E), w_gate / w_up (E, d, f), w_down (E, f, d)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d).float()
    weights, ids, _ = _route(xf, params["router"], k)
    # (E, T, f) for every expert, each weight read in place.
    g = torch.matmul(xf, params["w_gate"].float())
    u = torch.matmul(xf, params["w_up"].float())
    y_all = torch.matmul(F.silu(g) * u, params["w_down"].float())
    del g, u
    tok = torch.arange(b * s, device=x.device)[:, None]
    sel = y_all[ids.long(), tok]                          # (T, k, d)
    out = torch.sum(weights[..., None] * sel, dim=1)
    return out.reshape(b, s, d).to(x.dtype)


def _moe_local(x_flat: torch.Tensor, router_w: torch.Tensor,
               w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, *, k: int, num_experts: int,
               shard_idx: int, num_shards: int,
               capacity_per_expert: int) -> torch.Tensor:
    """One shard's experts (the reference's per-device computation).

    Sort-based capacity dispatch: assignments targeting this shard's
    resident experts are ranked by (local expert, arrival order); each
    expert processes its first C_e rows (overflow dropped), a static
    (E_loc, C_e, d) batch for the dense expert products.  Returns
    (T, d) in x's dtype."""
    t, d = x_flat.shape
    dev = x_flat.device
    e_loc = num_experts // num_shards
    c_e = capacity_per_expert
    weights, ids, _ = _route(x_flat, router_w, k)

    fid = ids.reshape(-1).long()                          # (T*k,)
    fw = weights.reshape(-1)
    ftok = torch.arange(t * k, device=dev) // k

    local_e = fid - shard_idx * e_loc
    mine = (local_e >= 0) & (local_e < e_loc)
    sort_key = torch.where(mine, local_e, e_loc)          # invalid → tail
    order = torch.argsort(sort_key, stable=True)
    counts = torch.bincount(sort_key, minlength=e_loc + 1)[:e_loc]
    starts = torch.cumsum(counts, 0) - counts

    # (E_loc, C_e) assignment indices into the flat lists (+ validity).
    ranks = torch.arange(c_e, device=dev)[None, :]
    idx_mat = torch.clamp_max(starts[:, None] + ranks, t * k - 1)
    valid = ranks < counts[:, None]
    sel = order[idx_mat]
    sel_tok = torch.where(valid, ftok[sel], t)            # t = drop slot
    sel_w = torch.where(valid, take_rows(fw, sel), 0.0)

    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))])
    ys = _expert_ffn_batched(take_rows(x_pad, sel_tok), w_gate, w_up,
                             w_down)
    return _combine(sel_tok.reshape(-1), (sel_w[..., None] * ys)
                    .reshape(-1, d), t, k).to(x_flat.dtype)


def _combine(tok: torch.Tensor, contrib: torch.Tensor, t: int,
             k: int) -> torch.Tensor:
    """``zeros((t + 1, d)).index_add(0, tok, contrib)[:t]`` in the order a
    sequential scatter takes: each token's contributions in the order of
    their rows (ascending expert), added to 0 one at a time.  A token has
    at most k rows (its k experts differ); rows of the drop slot t are
    left out.  No atomics: the same bits on every run."""
    n, d = contrib.shape
    order = torch.argsort(tok, stable=True)               # by token, then row
    tok_o = tok[order]
    counts = torch.bincount(tok, minlength=t + 1)
    rank = (torch.arange(n, device=tok.device)
            - (torch.cumsum(counts, 0) - counts)[tok_o])
    keep = tok_o < t
    slot = torch.full((t, k), n, dtype=torch.long, device=tok.device)
    slot[tok_o[keep], rank[keep]] = order[keep]
    padded = torch.cat([contrib, contrib.new_zeros((1, d))])
    out = torch.zeros((t, d), dtype=contrib.dtype, device=contrib.device)
    for j in range(k):
        out = out + take_rows(padded, slot[:, j])
    return out


def moe_ep(x: torch.Tensor, params: dict, k: int, *,
           capacity_factor: float = 1.25, mesh: Optional[object] = None,
           model_axis: str = "model",
           batch_axes: tuple = ("pod", "data")) -> torch.Tensor:
    """Capacity-path MoE on one device.  x: (B, S, d); params as
    :func:`moe_ref`.  A ``mesh`` (expert parallelism over a
    ``DeviceMesh``) raises: ROADMAP.md §1 item 8e."""
    if mesh is not None:
        raise NotImplementedError(
            f"moe_ep over a mesh (experts sharded on {model_axis!r}, tokens "
            f"on {batch_axes}) is not ported yet: ROADMAP.md §1 item 8e")
    b, s, d = x.shape
    num_experts = params["router"].shape[1]
    t = b * s
    c_e = max(int(capacity_factor * t * k / num_experts), 1)
    out = _moe_local(x.reshape(t, d), params["router"], params["w_gate"],
                     params["w_up"], params["w_down"], k=k,
                     num_experts=num_experts, shard_idx=0, num_shards=1,
                     capacity_per_expert=c_e)
    return out.reshape(b, s, d)


def moe_ffn(x: torch.Tensor, params: dict, k: int, *, impl: str = "auto",
            capacity_factor: float = 1.25) -> torch.Tensor:
    """``impl``: "ref" (:func:`moe_ref`), "ep" (:func:`moe_ep`) or "auto",
    which is "ref" here as in the reference when no mesh is active."""
    if impl == "auto":
        impl = "ref"
    if impl == "ref":
        return moe_ref(x, params, k)
    return moe_ep(x, params, k, capacity_factor=capacity_factor)

