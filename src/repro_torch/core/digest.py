"""DIGEST — full-batch training with periodic stale sync, on one device
(the single-device subset of ``src/repro/core/digest.py``).

One code path covers the three framework families the paper compares by
swapping what the out-of-subgraph halo tables hold:

  mode="digest"       stale reps pulled from the store every N epochs
  mode="partition"    nothing — cross-subgraph edges dropped
  mode="propagation"  fresh reps recomputed and exchanged every epoch

The reference vmaps the M subgraphs inside one jitted program; here they
are a loop on the card, each subgraph's loss differentiated by
``torch.autograd.grad`` and the M gradients stacked and averaged over
dim 0, as ``vmap`` + ``jnp.mean`` do.  The cadence (pull at ``r % N ==
0``, push at ``(r - 1) % N == 0``) is a host ``if``.

:func:`prepare_graph_data` partitions the graph with the port's own copy
of the reference partitioner, so every integer and float array equals the
reference's, and returns them as tensors on ``device``, plus the
transposed in-ELL (``in_pos``) the SpMM backward gathers through.

Later slices of the port (``ROADMAP.md`` §1): ``pull_mode="collective"``
(item 6), the SAT predictor (item 3), fault state and checkpoints
(item 5) and the sampled regime (item 4).  Asking for them raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import halo_exchange
from repro_torch.core.halo_exchange import HaloPrecision
from repro_torch.device import resolve_device
from repro_torch.graph.graph import Graph
from repro_torch.graph.partition import StackedPartitions, build_partitions
from repro_torch.graph.transpose import ell_transpose
from repro_torch.kernels.spmm import STREAM_CHUNK_ROWS
from repro_torch.models.gnn import (GNNConfig, gnn_forward, gnn_specs,
                                    halo_ref, projected_halo_ref)
from repro_torch.nn import init_params, micro_f1, softmax_cross_entropy
from repro_torch.optim import Optimizer, tree_map

Pytree = Any

MODES = ("digest", "partition", "propagation")

_LATER = {
    "collective": "pull_mode='collective' is ported with the multi-GPU "
                  "exchange (ROADMAP.md §1 item 6)",
    "predictor": "the SAT predictor is ported with ROADMAP.md §1 item 3",
    "faults": "fault injection, max_staleness and checkpoints are ported "
              "with ROADMAP.md §1 item 5",
}

# Output-row block of the reference's TPU kernels; the chunk worklists
# are built at this geometry so they equal the reference's.
BLOCK_ROWS = 128


def prepare_graph_data(g: Graph, num_parts: int, method: str = "greedy",
                       seed: int = 0, halo_weight: float = 0.0,
                       stream_chunk_rows: int = None, order: str = "none",
                       device="cuda") -> dict:
    """Build the tensor dict consumed by the training, forward and serving
    paths.

    Same keys and values as the reference (``halo_weight``/``order``/
    ``stream_chunk_rows`` as there), as tensors on ``device``, plus the
    transposed ELLs ``in_pos``/``out_pos`` in ``struct`` and
    ``full_struct`` and the host-side ``_sp`` (partition build),
    ``_graph`` and ``_worklist`` entries.  Raises when ``device`` is CUDA
    and no card is present.
    """
    dev = resolve_device(device)
    chunk_rows = (STREAM_CHUNK_ROWS if stream_chunk_rows is None
                  else stream_chunk_rows)
    sp = build_partitions(g, num_parts, method=method, seed=seed,
                          halo_weight=halo_weight, order=order,
                          order_chunk_rows=chunk_rows)
    full = build_partitions(g, 1, method="random", seed=seed)
    x_global = np.concatenate(
        [g.features, np.zeros((1, g.features.shape[1]), np.float32)], axis=0)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def _struct(s: StackedPartitions) -> tuple:
        wl = s.chunk_worklist(chunk_rows, BLOCK_ROWS)
        # Transposed in- and out-ELLs over the (S+1)-row local table and
        # the (H+1)-row halo slab (sentinels S and H): the table gradient
        # of every differentiated product gathers through them (the
        # out-side one serves GAT, whose layer 0 projects raw halo
        # features by a trained W).
        return {"in_nbr": t(s.in_nbr), "in_wts": t(s.in_wts),
                "out_nbr": t(s.out_nbr), "out_wts": t(s.out_wts),
                "wl_ids": t(wl.ids), "wl_cnt": t(wl.cnt),
                "in_pos": t(ell_transpose(s.in_nbr, s.in_nbr.shape[1] + 1)),
                "out_pos": t(ell_transpose(s.out_nbr, s.halo_size + 1))}, wl

    struct, worklist = _struct(sp)
    full_struct, _ = _struct(full)
    plan = sp.pull_plan()
    # halo_ids with a sentinel column: gathering x_global at these ids
    # gives each subgraph's (H+1)-row halo slab, row H the zero sentinel.
    halo_ids_x = np.concatenate(
        [sp.halo_ids, np.full((sp.num_parts, 1), g.num_nodes, np.int32)],
        axis=1)
    return {
        "x_global": t(x_global),
        "struct": struct,
        "local_ids": t(sp.local_ids),
        "local_valid": t(sp.local_valid),
        "halo_ids": t(sp.halo_ids),
        "halo_valid": t(sp.halo_valid),
        "halo_ids_x": t(halo_ids_x),
        "local_slots": t(sp.local_slots),
        "local_boundary": t(sp.local_boundary),
        "halo_slots": t(sp.halo_slots),
        "store_ids": t(sp.store_ids),
        "sentinel_slots": t(sp.sentinel_slots),
        "pull_send": t(plan.send_offsets),
        "pull_recv": t(plan.recv_positions),
        "labels": t(sp.labels),
        "train_mask": t(sp.train_mask),
        "val_mask": t(sp.val_mask),
        "test_mask": t(sp.test_mask),
        # Full-graph (M=1) view for exact eval and serving.
        "full_struct": full_struct,
        "full_ids": t(full.local_ids),
        "full_valid": t(full.local_valid),
        "full_labels": t(full.labels),
        "full_train_mask": t(full.train_mask),
        "full_val_mask": t(full.val_mask),
        "full_test_mask": t(full.test_mask),
        # Host-side metadata.
        "_sp": sp,
        "_graph": g,
        "_worklist": worklist,
    }


def gat_projected(cfg: GNNConfig) -> bool:
    """True when the epoch runs GAT with the owner-shard projection dedup:
    the pulled cache then holds projected rows (z = W·h̃ per hidden
    layer, flat ``z{ell}``/``z{ell}_scale`` slabs)."""
    return (cfg.model == "gat" and cfg.gat_halo_dedup
            and cfg.num_layers > 1)


def check_worklist_geometry(cfg: GNNConfig, data: dict) -> None:
    """Reject a chunk worklist built at another ``chunk_rows`` than the
    epoch's kernels stream with (a coarser one would silently drop
    referenced slab rows).  No-op when ``_worklist`` was stripped."""
    wl = data.get("_worklist")
    if wl is None:
        return
    want = (cfg.stream_chunk_rows if cfg.stream_chunk_rows is not None
            else STREAM_CHUNK_ROWS)
    if wl.chunk_rows != want:
        raise ValueError(
            f"chunk worklist was built with chunk_rows={wl.chunk_rows} "
            f"but the epoch streams with chunk_rows={want} — pass the "
            f"same value to prepare_graph_data(stream_chunk_rows=...) "
            f"and GNNConfig.stream_chunk_rows (a mismatched worklist "
            f"would silently skip referenced slab rows)")


def empty_halo_struct(cfg: GNNConfig, struct: dict, rows: int = 8
                      ) -> tuple[list, dict]:
    """Per-layer all-zero halo tables + a struct whose out-ELL is remapped
    into them — the "no out-of-subgraph information" view of the M=1
    full-graph forward.  The zero tables contribute exact ±0.0 terms."""
    dev = struct["out_nbr"].device
    tables = [torch.zeros((rows, cfg.in_dim), device=dev)]
    tables += [torch.zeros((rows, cfg.hidden_dim), device=dev)
               for _ in range(cfg.num_layers - 1)]
    struct = dict(struct)
    struct["out_nbr"] = torch.clamp_max(struct["out_nbr"], rows)
    if "out_pos" in struct:
        # Every slot is the sentinel: the transposed out-ELL over the
        # (rows+1)-row padded table lists nothing.
        struct["out_pos"] = torch.full((rows + 1, 1),
                                       struct["out_nbr"].numel(),
                                       dtype=torch.int32, device=dev)
    return tables, struct


def full_graph_forward(cfg: GNNConfig, params: Pytree, data: dict
                       ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Exact (no staleness, no partition) forward; returns
    (logits (N_pad, classes), reps)."""
    x = data["x_global"][data["full_ids"][0].long()]
    struct = {k: v[0] for k, v in data["full_struct"].items()}
    tables, struct = empty_halo_struct(cfg, struct)
    return gnn_forward(cfg, params, x, tables, struct)


def top_layer_reps(cfg: GNNConfig, params: Pytree, data: dict
                   ) -> torch.Tensor:
    """h^(L-1) for every node in the full view's global-id row order
    (N_pad, hidden) — ``reps[-1]`` of :func:`full_graph_forward`, what a
    serving-store refresh pushes."""
    if cfg.num_layers < 2:
        raise ValueError("serving from stored representations needs "
                         "num_layers >= 2 (a 1-layer GNN reads raw "
                         "features; there is no (L-1)-layer row to store)")
    _, reps = full_graph_forward(cfg, params, data)
    return reps[-1]


def evaluate(cfg: GNNConfig, params: Pytree, data: dict) -> dict:
    """Micro-F1 and loss of the full-graph forward on each split."""
    logits, _ = full_graph_forward(cfg, params, data)
    out = {}
    for split in ("train", "val", "test"):
        mask = data[f"full_{split}_mask"][0].float()
        out[f"{split}_f1"] = micro_f1(logits, data["full_labels"][0], mask)
        out[f"{split}_loss"] = softmax_cross_entropy(
            logits, data["full_labels"][0], mask)
    return out


# ---------------------------------------------------------------------------
# Training: Algorithm 1 on one device
# ---------------------------------------------------------------------------

def _leaves(tree: Pytree) -> list:
    """Leaves of a nested dict in sorted-key order (the reference's pytree
    order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _unflatten(tree: Pytree, leaves: list) -> Pytree:
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(tree)


def _detach(table):
    """``stop_gradient`` of a halo table (a tensor or a halo-ref dict)."""
    if isinstance(table, dict):
        return {k: (v.detach() if isinstance(v, torch.Tensor) else v)
                for k, v in table.items()}
    return table.detach()


def project_store_tables(store: dict, params: Pytree, cfg: GNNConfig,
                         precision: HaloPrecision) -> dict:
    """GAT owner-shard projection dedup: ``z{ℓ} = dequant(store[ℓ]) ·
    W_{ℓ+1}`` over the R store rows, once per layer, re-encoded in the
    wire precision as pull-ready single-layer stores ``{"z{ℓ}": {"data":
    (1, R, heads·dh)[, "scale"]}}``.  The rows are stale state: nothing
    here is differentiated.  (The reference's ``pstore``/``gamma``
    belong to the SAT predictor, a later slice.)"""
    out = {}
    with torch.no_grad():
        for ell in range(cfg.num_layers - 1):
            w = params[f"layer_{ell + 1}"]["w"]        # (hidden, heads, dh)
            rows = halo_exchange.dequantize_rows(
                *halo_exchange.layer_table(store, ell))  # (R, hidden)
            z = torch.einsum("rd,dhk->rhk", rows, w)
            z = z.reshape(z.shape[0], -1)               # (R, heads·dh)
            q, qs = halo_exchange.quantize_rows(z, precision)
            zs = {"data": q[None]}
            if qs is not None:
                zs["scale"] = qs[None]
            out[f"z{ell}"] = zs
    return out


def make_subgraph_loss(cfg: GNNConfig) -> Callable:
    """``loss_fn(params, x_local, halo_tables, struct, labels, mask) ->
    (loss, (push_reps, logits))`` of one subgraph; every halo table is
    detached (the reference's ``stop_gradient``)."""
    def loss_fn(params, x_local, halo_tables, struct, labels, mask):
        tables = [_detach(t) for t in halo_tables]
        logits, push = gnn_forward(cfg, params, x_local, tables, struct)
        loss = softmax_cross_entropy(logits, labels, mask)
        reps = (torch.stack(push) if push
                else x_local.new_zeros((0,) + tuple(x_local.shape)))
        return loss, (reps, logits)
    return loss_fn


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    sync_interval: int = 10          # N of Algorithm 1
    mode: str = "digest"
    pull_on_first_epoch: bool = False  # paper pulls only at r % N == 0
    # Wire/storage precision of the HaloExchange store.
    precision: HaloPrecision = HaloPrecision()
    # PULL transport: "gather" (the only one on one device here);
    # "collective" is ROADMAP.md §1 item 6.
    pull_mode: str = "gather"
    # LLCG-style server correction (partition baseline): one extra
    # server-side SGD step per round on a sampled node batch with FULL
    # neighbour information.
    llcg_correction: bool = False
    correction_frac: float = 0.1
    correction_lr: float = 1e-3
    # Later slices: the bounded-staleness watchdog (item 5) and the SAT
    # predictor kind (item 3); anything but the defaults raises.
    max_staleness: Optional[int] = None
    predictor: str = "none"


def _check_settings(settings: TrainSettings) -> None:
    if settings.mode not in MODES:
        raise ValueError(settings.mode)
    if settings.pull_mode not in ("gather", "collective"):
        raise ValueError(settings.pull_mode)
    if settings.pull_mode == "collective":
        raise NotImplementedError(_LATER["collective"])
    if settings.predictor != "none":
        raise NotImplementedError(_LATER["predictor"])
    if settings.max_staleness is not None:
        raise NotImplementedError(_LATER["faults"])


def _digest_pull(cfg: GNNConfig, settings: TrainSettings, state: dict,
                 data: dict, r: int) -> dict:
    """Algorithm-1 PULL (line 5) every ``sync_interval`` epochs: gather
    each subgraph's halo slots from the store into its device-local slab
    (GAT dedup: the store projected once per layer, then gathered)."""
    do_pull = r % settings.sync_interval == 0
    if settings.pull_on_first_epoch:
        do_pull = do_pull or r == 1
    if not do_pull:
        return state["cache"]
    if gat_projected(cfg):
        cache = {}
        for key, zs in project_store_tables(
                state["store"], state["params"], cfg,
                settings.precision).items():
            slab = halo_exchange.pull_slab(zs, data["halo_slots"])
            cache[key] = slab["data"]
            if "scale" in slab:
                cache[f"{key}_scale"] = slab["scale"]
        return cache
    return halo_exchange.pull_slab(state["store"], data["halo_slots"])


def _digest_push(cfg: GNNConfig, settings: TrainSettings, state: dict,
                 data: dict, push_reps: torch.Tensor, r: int) -> tuple:
    """Periodic PUSH (Algorithm 1 lines 9–10; epochs r = 1, N+1, ...) and
    the Theorem-1 staleness probe, measured against the store before the
    push.  Returns (store, push_residual, eps)."""
    store = state["store"]
    residual = state.get("push_residual")
    eps = torch.zeros((max(cfg.num_layers - 1, 1),), dtype=torch.float32,
                      device=push_reps.device)
    if settings.mode != "digest" or cfg.num_layers <= 1:
        return store, residual, eps
    eps = halo_exchange.staleness_error(store, push_reps,
                                        data["local_slots"],
                                        data["local_boundary"])
    if (r - 1) % settings.sync_interval == 0:
        if settings.precision.error_feedback:
            store, residual = halo_exchange.push_ef(
                store, data["local_slots"], data["local_valid"], push_reps,
                residual, data["sentinel_slots"])
        else:
            store = halo_exchange.push(store, data["local_slots"],
                                       data["local_valid"], push_reps,
                                       data["sentinel_slots"])
    return store, residual, eps


def llcg_sample(n: int, frac: float, r: int) -> torch.Tensor:
    """LLCG server batch of round ``r``: each of ``n`` rows drawn with
    probability ``frac`` from a ``torch.Generator`` seeded by (17, r) —
    not the reference's ``jax.random`` bits, which the port does not
    reproduce.  A bool (n,) CPU tensor."""
    gen = torch.Generator().manual_seed(17 * 1_000_003 + int(r))
    return torch.rand((n,), generator=gen) < frac


def _propagation_cache(cfg: GNNConfig, settings: TrainSettings,
                       params: Pytree, data: dict) -> dict:
    """Fresh exchange: exact reps at the current params, gathered down to
    the per-subgraph halo slabs (projected for GAT dedup) and encoded in
    the wire precision."""
    _, reps = full_graph_forward(cfg, params, data)
    ids = torch.clamp(data["halo_ids_x"].long(), 0, reps[0].shape[0] - 1)
    valid = data["halo_valid"]
    hv = torch.cat([valid, valid.new_zeros((valid.shape[0], 1))], dim=1)
    if gat_projected(cfg):
        cache = {}
        for ell in range(cfg.num_layers - 1):
            w = params[f"layer_{ell + 1}"]["w"]
            z = torch.einsum("nd,dhk->nhk", reps[ell], w)
            z = z.reshape(z.shape[0], -1)[ids]              # (M, H+1, w)
            z = torch.where(hv[:, :, None], z,
                            torch.zeros((), device=z.device))
            q, sc = halo_exchange.quantize_rows(z, settings.precision)
            cache[f"z{ell}"] = q[:, None]
            if sc is not None:
                cache[f"z{ell}_scale"] = sc[:, None]
        return cache
    slab = torch.stack([rep[ids] for rep in reps], dim=1)
    slab = torch.where(hv[:, None, :, None], slab,
                       torch.zeros((), device=slab.device))
    q, sc = halo_exchange.quantize_rows(slab, settings.precision)
    return {"data": q} if sc is None else {"data": q, "scale": sc}


def _subgraph_tables(cfg: GNNConfig, m: int, x_halo0: torch.Tensor,
                     cache: dict, struct_m: dict) -> list:
    """Subgraph m's per-layer halo tables: layer 0 its raw-feature slab,
    layers ℓ ≥ 1 its pulled storage-precision slab (projected rows under
    GAT dedup), each with the out-ELL and its chunk worklist."""
    wl = (struct_m.get("wl_ids"), struct_m.get("wl_cnt"))
    nbr, wts = struct_m["out_nbr"], struct_m["out_wts"]
    pos = struct_m.get("out_pos")
    tables = [halo_ref(x_halo0[m], None, nbr, wts, *wl, pos=pos)]
    for ell in range(cfg.num_layers - 1):
        if gat_projected(cfg):
            zsc = cache.get(f"z{ell}_scale")
            tables.append(projected_halo_ref(
                cache[f"z{ell}"][m, 0],
                zsc[m, 0] if zsc is not None else None, nbr, wts, pos))
        else:
            sc = cache.get("scale")
            tables.append(halo_ref(cache["data"][m, ell],
                                   sc[m, ell] if sc is not None else None,
                                   nbr, wts, *wl, pos=pos))
    return tables


def make_epoch_fn(cfg: GNNConfig, opt: Optimizer, settings: TrainSettings,
                  mesh=None) -> Callable:
    """``epoch_fn(state, data) -> (state, metrics)``: one global round r
    of Algorithm 1 over the M subgraphs on one device.  ``mesh`` belongs
    to ``pull_mode="collective"`` (a later slice) and must be None."""
    _check_settings(settings)
    if mesh is not None:
        raise NotImplementedError(_LATER["collective"])
    loss_fn = make_subgraph_loss(cfg)

    def epoch_fn(state: dict, data: dict) -> tuple[dict, dict]:
        r = state["epoch"] + 1            # 1-indexed, as in Algorithm 1
        x_global = data["x_global"]
        struct = data["struct"]
        # Layer-0 halo features as per-subgraph slabs (M, H+1, d), row H
        # the zero sentinel; the partition baseline zeroes the tables.
        x_halo0 = x_global[data["halo_ids_x"].long()]
        if settings.mode == "partition":
            x_halo0 = torch.zeros_like(x_halo0)
        if settings.mode == "propagation" and cfg.num_layers > 1:
            with torch.no_grad():
                cache = _propagation_cache(cfg, settings, state["params"],
                                           data)
        elif settings.mode == "digest":
            cache = _digest_pull(cfg, settings, state, data, r)
        else:
            cache = state["cache"]

        x_local = x_global[data["local_ids"].long()]        # (M, S, d)
        leaves = [p.detach().requires_grad_()
                  for p in _leaves(state["params"])]
        params = _unflatten(state["params"], leaves)
        num_parts = x_local.shape[0]
        losses, reps, logits, grads = [], [], [], []
        for m in range(num_parts):
            struct_m = {k: v[m] for k, v in struct.items()}
            tables = _subgraph_tables(cfg, m, x_halo0, cache, struct_m)
            loss, (rep, lg) = loss_fn(params, x_local[m], tables, struct_m,
                                      data["labels"][m],
                                      data["train_mask"][m])
            grads.append(torch.autograd.grad(loss, leaves,
                                             allow_unused=True))
            losses.append(loss.detach())
            reps.append(rep.detach())
            logits.append(lg.detach())
        # Global AGG (Algorithm 1 line 13): uniform average over subgraphs.
        mean = [torch.stack([torch.zeros_like(p) if g[i] is None else g[i]
                             for g in grads]).mean(dim=0)
                for i, p in enumerate(leaves)]
        mean_grads = _unflatten(state["params"], mean)
        new_params, opt_state = opt.update(mean_grads, state["opt_state"],
                                           state["params"], state["step"])

        if settings.llcg_correction:
            new_params = _llcg_step(cfg, settings, new_params, data, r)

        push_reps = torch.stack(reps)                 # (M, L-1, S, hidden)
        store, residual, eps = _digest_push(cfg, settings, state, data,
                                            push_reps, r)
        train_acc = micro_f1(torch.stack(logits), data["labels"],
                             data["train_mask"].float())
        new_state = {"params": new_params, "opt_state": opt_state,
                     "store": store, "cache": cache, "epoch": r,
                     "step": state["step"] + 1}
        if residual is not None:
            new_state["push_residual"] = residual
        metrics = {"loss": torch.stack(losses).mean(),
                   "train_f1": train_acc, "staleness_eps": eps}
        return new_state, metrics

    return epoch_fn


def _llcg_step(cfg: GNNConfig, settings: TrainSettings, params: Pytree,
               data: dict, r: int) -> Pytree:
    """LLCG server correction: a full-neighbour gradient on a sampled node
    batch, one plain SGD step on the server."""
    mask = data["full_train_mask"][0]
    sample = llcg_sample(mask.shape[0], settings.correction_frac, r)
    corr_mask = (mask & sample.to(mask.device)).float()
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    logits, _ = full_graph_forward(cfg, _unflatten(params, leaves), data)
    loss = softmax_cross_entropy(logits, data["full_labels"][0], corr_mask)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return _unflatten(params, [
        p.detach() - settings.correction_lr * (
            torch.zeros_like(p) if g is None else g)
        for p, g in zip(leaves, grads)])


def init_state(cfg: GNNConfig, opt: Optimizer, data: dict, seed: int = 0,
               precision: HaloPrecision = HaloPrecision(),
               params: Pytree = None) -> dict:
    """Initial training state on ``data``'s device: parameters drawn from
    ``torch.Generator`` seed ``seed`` (or ``params`` as given — parity
    tests pass the reference's), the optimizer state, the zero store and
    the zero pulled cache (projected slabs under GAT dedup)."""
    check_worklist_geometry(cfg, data)
    dev = data["x_global"].device
    if params is None:
        params = init_params(gnn_specs(cfg),
                             torch.Generator().manual_seed(seed), dev)
    num_slots = int(data["store_ids"].shape[0]) - 1
    l1 = max(cfg.num_layers - 1, 1)
    num_parts, s = data["local_ids"].shape
    halo_size = int(data["halo_ids"].shape[1])
    if gat_projected(cfg):
        cache = {}
        for ell in range(l1):
            w_ell = cfg.layer_dims[ell + 1][1]
            cache[f"z{ell}"] = torch.zeros(
                (num_parts, 1, halo_size + 1, w_ell), dtype=precision.dtype,
                device=dev)
            if precision.has_scale:
                cache[f"z{ell}_scale"] = torch.ones(
                    (num_parts, 1, halo_size + 1, 1), dtype=torch.float32,
                    device=dev)
    else:
        cache = halo_exchange.init_slab(num_parts, l1, halo_size,
                                        cfg.hidden_dim, precision, dev)
    state = {
        "params": params,
        "opt_state": opt.init(params),
        "store": halo_exchange.init_store(l1, num_slots, cfg.hidden_dim,
                                          precision, dev),
        "cache": cache,
        "epoch": 0,
        "step": 0,
    }
    if precision.error_feedback:
        state["push_residual"] = torch.zeros(
            (num_parts, l1, s, cfg.hidden_dim), dtype=torch.float32,
            device=dev)
    return state


def digest_train(cfg: GNNConfig, opt: Optimizer, data: dict,
                 settings: TrainSettings, epochs: int,
                 eval_every: int = 10, seed: int = 0,
                 verbose: bool = False, mesh=None, faults=None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 resume: bool = False) -> tuple[dict, dict]:
    """Run training; returns (final_state, history dict of lists), the
    history recorded at every ``eval_every``-th epoch and the last.
    ``mesh``, ``faults`` and checkpoints belong to later slices and
    raise."""
    if mesh is not None or settings.pull_mode == "collective":
        raise NotImplementedError(_LATER["collective"])
    if faults is not None or ckpt_dir is not None or resume:
        raise NotImplementedError(_LATER["faults"])
    state = init_state(cfg, opt, data, seed=seed,
                       precision=settings.precision)
    epoch_fn = make_epoch_fn(cfg, opt, settings)
    hist: dict[str, list] = {"epoch": [], "loss": [], "train_f1": [],
                             "val_f1": [], "test_f1": [], "time": [],
                             "staleness_eps": []}
    t0 = time.perf_counter()
    for e in range(epochs):
        state, m = epoch_fn(state, data)
        if (e + 1) % eval_every == 0 or e == epochs - 1:
            ev = evaluate(cfg, state["params"], data)
            hist["epoch"].append(e + 1)
            hist["loss"].append(float(m["loss"]))
            hist["train_f1"].append(float(m["train_f1"]))
            hist["val_f1"].append(float(ev["val_f1"]))
            hist["test_f1"].append(float(ev["test_f1"]))
            hist["staleness_eps"].append(
                m["staleness_eps"].cpu().numpy().tolist())
            hist["time"].append(time.perf_counter() - t0)
            if verbose:
                print(f"[{settings.mode}] epoch {e+1:4d} "
                      f"loss {float(m['loss']):.4f} "
                      f"val_f1 {float(ev['val_f1']):.4f}")
    return state, hist
