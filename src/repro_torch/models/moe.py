"""Mixture-of-Experts FFN: the reference's two implementations, one math.

* :func:`moe_ref`: exact dropless MoE (every expert on every token) — the
  oracle of the tests and what ``moe_impl="auto"`` runs on one device.
* :func:`moe_ep`: the capacity path.  Each token's top-k assignments are
  ranked by (expert, arrival order); each expert takes its first
  ``capacity`` rows (overflow dropped, Switch-style) as one static
  (E, C, d) batch for the dense expert products.  Over a ``DeviceMesh``
  with a ``"model"`` dimension (``launch.mesh.make_mesh(model=...)``) the
  experts are sharded over "model" and the tokens over the batch
  dimensions ("pod", "data"); each rank runs its experts on its tokens
  and the partial outputs are added over "model" — the reference's
  expert parallelism, with no all-to-all.

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

from repro_torch.core import collectives
from repro_torch.launch.mesh import dim_size
from repro_torch.nn.layers import count_ids, take_rows

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


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


def moe_ref(x: torch.Tensor, params: dict, k: int, *,
            mesh: Optional[object] = None,
            model_axis: str = "model") -> torch.Tensor:
    """Exact dropless MoE (all experts on all tokens).  x: (B, S, d);
    params: router (d, E), w_gate / w_up (E, d, f), w_down (E, f, d).

    Over a ``mesh`` with ``model_axis`` the experts are sharded as in
    :func:`moe_ep` (global or this rank's weights): each rank runs its
    experts on every token of ``x``, keeps the assignments routed to them
    and the partials are added over "model" in rank order
    (``collectives.ordered_sum``); the router stays whole."""
    b, s, d = x.shape
    num_experts = params["router"].shape[1]
    shard, n_shards = 0, 1
    if mesh is not None and model_axis in (mesh.mesh_dim_names or ()):
        shard, n_shards = (mesh.get_local_rank(model_axis),
                           dim_size(mesh, model_axis))
        if num_experts % n_shards:
            raise ValueError(f"E={num_experts} % model={n_shards}")
    elif params["w_gate"].shape[0] != num_experts:
        raise ValueError("moe_ref needs every expert's weights; sharded "
                         "experts run through moe_ep over their mesh")
    w_gate, w_up, w_down = (expert_rows(params[key], num_experts, shard,
                                        n_shards) for key in EXPERT_LEAVES)
    xf = x.reshape(b * s, d).float()
    weights, ids, _ = _route(xf, params["router"], k)
    # (E_loc, T, f) for every local expert, each weight read in place.
    g = torch.matmul(xf, w_gate.float())
    u = torch.matmul(xf, w_up.float())
    y_all = torch.matmul(F.silu(g) * u, w_down.float())
    del g, u
    tok = torch.arange(b * s, device=x.device)[:, None]
    if n_shards == 1:
        sel = y_all[ids.long(), tok]                      # (T, k, d)
        out = torch.sum(weights[..., None] * sel, dim=1)
        return out.reshape(b, s, d).to(x.dtype)
    e_loc = num_experts // n_shards
    local = ids.long() - shard * e_loc
    mine = (local >= 0) & (local < e_loc)
    sel = y_all[local.clamp(0, e_loc - 1), tok]
    part = torch.sum(torch.where(mine, weights, 0.0)[..., None] * sel, dim=1)
    out = collectives.ordered_sum(part, mesh.get_group(model_axis))
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
    counts = count_ids(sort_key, e_loc + 1)[:e_loc]
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
    counts = count_ids(tok, t + 1)
    rank = (torch.arange(n, device=tok.device)
            - (torch.cumsum(counts, 0) - counts)[tok_o])
    # The drop slot's rows land in a spare row t, left out after: every
    # index has a static shape (no boolean mask), so meta tensors run too.
    keep = tok_o < t
    slot = torch.full((t + 1, k), n, dtype=torch.long, device=tok.device)
    slot[tok_o, torch.where(keep, rank, 0)] = order
    slot = slot[:t]
    padded = torch.cat([contrib, contrib.new_zeros((1, d))])
    out = torch.zeros((t, d), dtype=contrib.dtype, device=contrib.device)
    for j in range(k):
        out = out + take_rows(padded, slot[:, j])
    return out


def expert_rows(w: torch.Tensor, num_experts: int, shard: int,
                num_shards: int, dim: int = 0) -> torch.Tensor:
    """Shard ``shard``'s ``num_experts / num_shards`` contiguous experts of
    an expert weight whose dim ``dim`` runs over all ``num_experts`` (a
    copy, so the whole can be freed); a weight already cut to one shard's
    rows is returned as it is."""
    e_loc = num_experts // num_shards
    if w.shape[dim] == e_loc:
        return w
    if w.shape[dim] != num_experts:
        raise ValueError(f"expert weight of {w.shape[dim]} rows along dim "
                         f"{dim}: neither E={num_experts} nor E/"
                         f"{num_shards}={e_loc} (one shard's experts run "
                         f"over their mesh)")
    return w.narrow(dim, shard * e_loc, e_loc).clone()


def shard_experts(params, mesh, model_axis: str = "model"):
    """This rank's experts of a model's parameters, one MoE block's or
    one :func:`moe_ep` params dict: every dict holding a ``router`` has
    its expert weights (``w_gate_e`` / ``w_up_e`` / ``w_down_e`` in the
    transformer's blocks, ``w_gate`` / ``w_up`` / ``w_down`` in a MoE
    params dict) cut to the rank's contiguous ``E / model`` rows along
    the expert dim (dim 1 of a ``pattern`` block's stacked leaves, as its
    router is (repeats, d, E)).  Other leaves are kept as they are (not
    copied).  A mesh without ``model_axis`` returns ``params``."""
    if mesh is None or model_axis not in (mesh.mesh_dim_names or ()):
        return params
    n_shards = dim_size(mesh, model_axis)
    shard = mesh.get_local_rank(model_axis)

    def cut(node):
        if isinstance(node, (list, tuple)):
            return [cut(v) for v in node]
        if not isinstance(node, dict):
            return node
        if "router" not in node:
            return {k: cut(v) for k, v in node.items()}
        num_experts = node["router"].shape[-1]
        dim = node["router"].dim() - 2
        keys = ([f"{k}_e" for k in EXPERT_LEAVES] if "w_gate_e" in node
                else list(EXPERT_LEAVES))
        return {k: expert_rows(v, num_experts, shard, n_shards, dim)
                if k in keys else v for k, v in node.items()}

    return cut(params)


def moe_ep(x: torch.Tensor, params: dict, k: int, *,
           capacity_factor: float = 1.25, mesh: Optional[object] = None,
           model_axis: str = "model",
           batch_axes: tuple = ("pod", "data")) -> torch.Tensor:
    """Expert-parallel MoE.  x: (B, S, d), the global batch on every rank;
    params as :func:`moe_ref`, whose expert weights may be global (E, …)
    or already this rank's shard (E / model, …; :func:`shard_experts`).

    Without a mesh, or on one without ``model_axis``, one device runs
    every expert (shard 0 of 1).  Otherwise the experts are sharded over
    ``model_axis`` (E must divide) and the tokens over the mesh's
    ``batch_axes`` (this rank takes its contiguous block of rows; a
    batch the batch ranks do not divide, such as batch-1 decode, is
    replicated); the capacity comes from the local tokens.  The ranks'
    partial outputs are gathered over "model" and added in rank order
    (the reference's ``psum``), then gathered over the batch dimensions:
    the global (B, S, d) output on every rank, every rank's the same
    bits."""
    b, s, d = x.shape
    num_experts = params["router"].shape[1]
    if mesh is None or model_axis not in (mesh.mesh_dim_names or ()):
        t = b * s
        c_e = max(int(capacity_factor * t * k / num_experts), 1)
        w = [expert_rows(params[key], num_experts, 0, 1)
             for key in EXPERT_LEAVES]
        out = _moe_local(x.reshape(t, d), params["router"], *w, k=k,
                         num_experts=num_experts, shard_idx=0, num_shards=1,
                         capacity_per_expert=c_e)
        return out.reshape(b, s, d)

    n_shards = dim_size(mesh, model_axis)
    if num_experts % n_shards:
        raise ValueError(f"E={num_experts} % model={n_shards}")
    baxes = [a for a in batch_axes if dim_size(mesh, a) > 1]
    n_batch = 1
    for a in baxes:
        n_batch *= dim_size(mesh, a)
    if b % n_batch:
        # Tiny decode batches cannot be split over the batch ranks:
        # replicate the tokens instead; the experts stay sharded.
        baxes, n_batch = [], 1
    block = 0
    for a in baxes:
        block = block * dim_size(mesh, a) + mesh.get_local_rank(a)
    b_loc = b // n_batch
    t_loc = b_loc * s
    x_loc = x[block * b_loc:(block + 1) * b_loc].reshape(t_loc, d)
    c_e = max(int(capacity_factor * t_loc * k / num_experts), 1)
    shard = mesh.get_local_rank(model_axis)
    w = [expert_rows(params[key], num_experts, shard, n_shards)
         for key in EXPERT_LEAVES]
    part = _moe_local(x_loc, params["router"], *w, k=k,
                      num_experts=num_experts, shard_idx=shard,
                      num_shards=n_shards, capacity_per_expert=c_e)
    out = collectives.ordered_sum(part, mesh.get_group(model_axis))
    # The batch blocks back in row-major order: the last batch dimension
    # first, so each gather concatenates whole blocks of the one before.
    for a in reversed(baxes):
        out = torch.cat(collectives.all_gather(out, mesh.get_group(a)))
    return out.reshape(b, s, d)


def moe_ffn(x: torch.Tensor, params: dict, k: int, *, impl: str = "auto",
            capacity_factor: float = 1.25, mesh: Optional[object] = None,
            batch_axes: tuple = ("pod", "data")) -> torch.Tensor:
    """``impl``: "ref" (:func:`moe_ref`, its experts sharded over a mesh's
    "model" dimension), "ep" (:func:`moe_ep` over ``mesh`` and
    ``batch_axes``) or "auto": "ep" when a mesh is given, else "ref", as
    the reference picks by its active mesh.  ``batch_axes=()``: ``x`` is
    this rank's rows already (the tensor-parallel transformer's)."""
    if impl == "auto":
        impl = "ep" if mesh is not None else "ref"
    if impl == "ref":
        return moe_ref(x, params, k, mesh=mesh)
    return moe_ep(x, params, k, capacity_factor=capacity_factor, mesh=mesh,
                  batch_axes=batch_axes)
