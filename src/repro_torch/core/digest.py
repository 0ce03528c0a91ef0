"""DIGEST — full-batch training with periodic stale sync (the port of
``src/repro/core/digest.py``), on one device or over a mesh of ranks.

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

The SAT predictor (``core/predictor.py``) rides the store: a ``pstore``
of the store's geometry is pushed beside it, pulled into a ``pcache``
slab, and read by the halo kernels' fused epilogue.  Fault state
(``core/faults.py``) gates each part's push with a host-refreshed
``push_ok`` mask, and :func:`digest_train` checkpoints the whole state
and resumes from the newest valid checkpoint (``checkpoint/``).

The sampled regime (:func:`sampled_train`) is a second training regime
over the same store: each step draws a batch from a
:class:`repro_torch.graph.sampler.NeighborSampler` on the host, the
hidden layers aggregate the sampled in-subgraph neighbours fresh and the
rest from each subgraph's own last-step representations (VR-GCN control
variates, ``hist``), and the loss is masked to the batch's seeds.  The
pull, push, faults and checkpoints are the full-batch epoch's.

``pull_mode="collective"`` spreads the M subgraphs over the ranks of a
``torch.distributed`` DeviceMesh (``repro_torch.launch.mesh``), k = M /
ranks each (:func:`check_collective_geometry`): :func:`shard_data`,
:func:`shard_state` and :func:`shard_batch` give each rank its parts and
owner shards, the PULL is ``halo_exchange.collective_pull`` (one
all-to-all a store tensor), the PUSH and the staleness probe are
shard-local, and Algorithm 1 line 13's mean is exact across ranks: each
rank writes its parts' gradients, losses and F1 counts into their rows of
a zero (M, ·) buffer, one ``all_reduce(SUM)`` fills it (every element has
a single nonzero addend), and the mean runs over the M rows in M order,
as on one device.  So a collective epoch computes what the single-process
loop computes, bit for bit on one device type.  The epoch's collectives:
that all-reduce, one ``all_reduce(MAX)`` of the staleness ε and the push
age, and on a pull epoch one all-to-all a store tensor (on pods, the pod
hop's sends beside); :func:`gather_state` (checkpoints) runs outside it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import trace
from repro_torch.checkpoint import checkpoint as ckpt_io
from repro_torch.core import collectives
from repro_torch.core import faults as faults_mod
from repro_torch.core import halo_exchange
from repro_torch.core import predictor as predictor_mod
from repro_torch.core.halo_exchange import HaloPrecision
from repro_torch.core.predictor import PredictorConfig
from repro_torch.device import resolve_device
from repro_torch.graph.graph import Graph
from repro_torch.graph.partition import StackedPartitions, build_partitions
from repro_torch.graph.transpose import ell_transpose
from repro_torch.kernels.spmm import STREAM_CHUNK_ROWS
from repro_torch.models.gnn import (GNNConfig, gnn_forward,
                                    gnn_forward_sampled, gnn_specs,
                                    halo_ref, projected_halo_ref)
from repro_torch.nn import init_params, micro_f1, softmax_cross_entropy
from repro_torch.optim import Optimizer

Pytree = Any

MODES = ("digest", "partition", "propagation")

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


def check_collective_geometry(data: dict, mesh, axis: str = "data") -> int:
    """Fail before any work when the partition count cannot be laid over
    the mesh's exchange dimensions (``halo_exchange.exchange_axes``:
    "data", times "pod" on a pod mesh); returns k = parts a rank.  Only
    shapes are read."""
    num_parts = int(data["local_slots"].shape[0])
    return halo_exchange.shards_per_device(num_parts, mesh, axis,
                                           "pull_mode='collective'")


# The entries of a prepare_graph_data dict every rank holds whole.
_REPLICATED = ("x_global", "store_ids")


def shard_data(data: dict, mesh, axis: str = "data") -> dict:
    """This rank's view of a :func:`prepare_graph_data` dict (the
    placement of the reference's ``subgraph_shardings``): every stacked
    (M, …) tensor, the struct's and the PullPlan's ``pull_send`` (owner
    rows) / ``pull_recv`` (requester rows) cut to the rank's k parts;
    ``x_global``, ``store_ids`` and the ``full_*`` view whole; host-side
    ``_*`` entries kept."""
    sl = halo_exchange.part_slice(int(data["local_slots"].shape[0]), mesh,
                                  axis)
    out = {}
    for key, v in data.items():
        if key.startswith("_") or key in _REPLICATED \
                or key.startswith("full_"):
            out[key] = v
        elif key == "struct":
            out[key] = {kk: vv[sl].clone() for kk, vv in v.items()}
        else:
            out[key] = v[sl].clone()
    return out


def shard_batch(batch: dict, mesh, axis: str = "data") -> dict:
    """This rank's parts of a sampler batch (every array (M, …); numpy or
    tensors), the reference's ``batch_shardings``."""
    sl = halo_exchange.part_slice(len(next(iter(batch.values()))), mesh,
                                  axis)
    return {k: v[sl] for k, v in batch.items()}


# Training-state leaves stacked over the M parts (dim 0); "store" and
# "pstore" are owner-sharded over their rows (dim 1); the rest (params,
# opt_state, epoch, step) every rank holds whole.
_PART_LEAVES = ("cache", "pcache", "push_residual", "predictor", "hist",
                "push_ok", "last_push_round")
_STORE_LEAVES = ("store", "pstore")


def _num_parts(state: dict) -> int:
    return int(_leaves(state["cache"])[0].shape[0])


def shard_state(state: dict, mesh, axis: str = "data") -> dict:
    """This rank's part of a whole training state (:func:`init_state`,
    :func:`init_sampled_state`, or one restored from a checkpoint): its k
    owner shards of the store and pstore, its k parts of every stacked
    leaf, the rest whole."""
    num_parts = _num_parts(state)
    sl = halo_exchange.part_slice(num_parts, mesh, axis)
    out = dict(state)
    for key in _STORE_LEAVES:
        if key in state:
            out[key] = halo_exchange.shard_store(state[key], num_parts,
                                                 mesh, axis)
    for key in _PART_LEAVES:
        if key in state:
            v = state[key]
            out[key] = ({kk: vv[sl].clone() for kk, vv in v.items()}
                        if isinstance(v, dict) else v[sl].clone())
    return out


def gather_state(state: dict, mesh) -> dict:
    """The whole training state from every rank's :func:`shard_state`
    part, one ``all_gather`` a sharded leaf (for checkpoints: run outside
    the epoch, so not in its collective census).  The mesh spans the
    job, rank e holding block e."""
    def whole(v, dim):
        return torch.cat(collectives.all_gather(v.contiguous()), dim=dim)

    out = dict(state)
    for key in _STORE_LEAVES:
        if key in state:
            out[key] = {kk: (whole(vv, 1) if vv.dim() >= 2 else vv)
                        for kk, vv in state[key].items()}
    for key in _PART_LEAVES:
        if key in state:
            v = state[key]
            out[key] = ({kk: whole(vv, 0) for kk, vv in v.items()}
                        if isinstance(v, dict) else whole(v, 0))
    return out


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


def mean_grads_of(grads: list, leaves: list) -> list:
    """The mean over subgraphs of per-subgraph ``torch.autograd.grad``
    tuples (None, an unused leaf, as zeros), stacked over dim 0 as
    ``vmap`` + ``jnp.mean`` do."""
    return [torch.stack([torch.zeros_like(p) if g[i] is None else g[i]
                         for g in grads]).mean(dim=0)
            for i, p in enumerate(leaves)]


def _detach(table):
    """``stop_gradient`` of a halo table (a tensor or a halo-ref dict)."""
    if isinstance(table, dict):
        return {k: (v.detach() if isinstance(v, torch.Tensor) else v)
                for k, v in table.items()}
    return table.detach()


def project_store_tables(store: dict, params: Pytree, cfg: GNNConfig,
                         precision: HaloPrecision, pstore: dict = None,
                         gamma: float = 1.0,
                         shard_rows: Optional[int] = None) -> dict:
    """GAT owner-shard projection dedup: ``z{ℓ} = dequant(store[ℓ]) ·
    W_{ℓ+1}`` over the R store rows, once per layer, re-encoded in the
    wire precision as pull-ready single-layer stores ``{"z{ℓ}": {"data":
    (1, R, heads·dh)[, "scale"]}}``.  The rows are stale state: nothing
    here is differentiated.  With a SAT ``pstore`` the rows are predicted
    before the projection, ``dequant(store) + gamma · dequant(pstore)``
    (exact by linearity of W), so the pulled z slabs keep their shape.
    With ``shard_rows`` each owner shard is projected by its own product,
    so a rank's shards give the bits the whole store gives (a GEMM's
    summation order may follow its row count), and its sentinel row keeps
    scale 1."""
    out = {}
    with torch.no_grad():
        for ell in range(cfg.num_layers - 1):
            w = params[f"layer_{ell + 1}"]["w"]        # (hidden, heads, dh)
            rows = halo_exchange.dequantize_rows(
                *halo_exchange.layer_table(store, ell))  # (R, hidden)
            if pstore is not None:
                rows = rows + _f32(gamma) * halo_exchange.dequantize_rows(
                    *halo_exchange.layer_table(pstore, ell))
            blocks = ([rows] if shard_rows is None
                      else list(torch.split(rows, shard_rows)))
            z = torch.cat([torch.einsum("rd,dhk->rhk", b, w)
                           for b in blocks])
            z = z.reshape(z.shape[0], -1)               # (R, heads·dh)
            q, qs = halo_exchange.quantize_rows(z, precision)
            if shard_rows is not None and qs is not None:
                # Each shard's last row is its owner's zero sentinel: keep
                # the store's convention there (data 0, scale 1), which
                # collective_pull's padding assumes, so the pulled slab
                # is the same by either route.
                qs[shard_rows - 1::shard_rows] = 1.0
            zs = {"data": q[None]}
            if qs is not None:
                zs["scale"] = qs[None]
            out[f"z{ell}"] = zs
    return out


def _f32(x: float) -> torch.Tensor:
    """``x`` as a float32 scalar (the reference's ``jnp.float32(x)``); a
    0-d CPU tensor combines with tensors on any device."""
    return torch.tensor(x, dtype=torch.float32)


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
    # PULL transport: "gather" = the dense gather on one device;
    # "collective" = the mesh epoch (pass the mesh; M must be a multiple of
    # the exchange dimensions, pods x data): all-to-all pulls of only the
    # referenced slots, shard-local pushes and staleness reads, k = M /
    # ranks subgraphs and owner shards a rank.
    pull_mode: str = "gather"
    # LLCG-style server correction (partition baseline): one extra
    # server-side SGD step per round on a sampled node batch with FULL
    # neighbour information.
    llcg_correction: bool = False
    correction_frac: float = 0.1
    correction_lr: float = 1e-3
    # Sampled regime (make_sampled_epoch_fn): "cv" aggregates unsampled
    # neighbours from the last step's representations (VR-GCN control
    # variates); "plain" drops that term — scaled neighbour sampling, the
    # variance baseline.
    sample_estimator: str = "cv"
    # Bounded-staleness watchdog: a part whose last accepted push is
    # >= max_staleness rounds old is pushed on the next round whatever the
    # cadence or the fault mask.  Needs the fault-aware state leaves
    # (faults.attach_fault_state); None disables it.
    max_staleness: Optional[int] = None
    # SAT prediction (core/predictor.py): consumers read dequant(store
    # row) + gamma·dequant(pstore row).  kind="none" adds no state and
    # runs the predictor-free program.
    predictor: PredictorConfig = PredictorConfig()


def _check_settings(settings: TrainSettings, mesh=None) -> None:
    if settings.mode not in MODES:
        raise ValueError(settings.mode)
    if settings.pull_mode not in ("gather", "collective"):
        raise ValueError(settings.pull_mode)
    if settings.pull_mode == "collective":
        if mesh is None:
            raise ValueError("pull_mode='collective' needs the mesh")
        if not dist.is_initialized():
            raise RuntimeError("pull_mode='collective' needs an "
                               "initialised process group "
                               "(repro_torch.launch.mesh)")
    elif mesh is not None:
        raise ValueError("a mesh is for pull_mode='collective'; the "
                         "gather epoch runs every subgraph on one device")
    if settings.predictor.enabled and settings.mode != "digest":
        raise ValueError("the SAT predictor rides the stale store — "
                         f"mode must be 'digest', got {settings.mode!r}")


def _shard_rows(state: dict, data: dict) -> int:
    """Rows of one owner shard: the (rank's) store rows over its parts."""
    return (state["store"]["data"].shape[1]
            // int(data["local_slots"].shape[0]))


def _digest_pull(cfg: GNNConfig, settings: TrainSettings, state: dict,
                 data: dict, r: int, mesh=None
                 ) -> tuple[dict, Optional[dict]]:
    """Algorithm-1 PULL (line 5) every ``sync_interval`` epochs: each
    subgraph's halo slots from the store into its device-local slab, by
    the dense gather or, under ``pull_mode="collective"``, by
    ``collective_pull`` over ``mesh`` (GAT dedup: the store projected
    once per owner shard and layer, then pulled, one exchange a z
    tensor).  Returns ``(cache, pcache)``: the pulled SAT predictor slab
    rides the same routing (None without a predictor, and under GAT
    dedup, where the prediction is folded in before the projection)."""
    do_pull = r % settings.sync_interval == 0
    if settings.pull_on_first_epoch:
        do_pull = do_pull or r == 1
    if not do_pull:
        return state["cache"], state.get("pcache")
    with trace.span("store.pull"):
        if settings.pull_mode == "collective":
            halo_size = int(data["halo_ids"].shape[1])

            def pull_store(zs):
                return halo_exchange.collective_pull(
                    zs, data["pull_send"], data["pull_recv"], halo_size, mesh)
        else:
            def pull_store(zs):
                return halo_exchange.pull_slab(zs, data["halo_slots"])
        pred = settings.predictor.enabled and "pstore" in state
        if gat_projected(cfg):
            cache = {}
            for key, zs in project_store_tables(
                    state["store"], state["params"], cfg, settings.precision,
                    pstore=state["pstore"] if pred else None,
                    gamma=settings.predictor.gamma,
                    shard_rows=_shard_rows(state, data)).items():
                slab = pull_store(zs)
                cache[key] = slab["data"]
                if "scale" in slab:
                    cache[f"{key}_scale"] = slab["scale"]
            return cache, state.get("pcache")
        cache = pull_store(state["store"])
        if pred:
            return cache, pull_store(state["pstore"])
        return cache, None


def _digest_push(cfg: GNNConfig, settings: TrainSettings, state: dict,
                 data: dict, push_reps: torch.Tensor, r: int,
                 mesh=None) -> tuple:
    """Periodic PUSH (Algorithm 1 lines 9–10; epochs r = 1, N+1, ...) and
    the Theorem-1 staleness probe, measured against the store before the
    push.

    With the fault-aware leaves in ``state``, the part mask ``ok`` is the
    cadence AND ``push_ok``, OR the ``max_staleness`` watchdog; a masked
    part's rows go to its sentinel slot in the same push, its EF residual
    stays as it was, and ``last_push_round`` records the parts that
    pushed.  With the SAT predictor the probe reads the predicted rows
    ``dequant(store) + gamma·dequant(pstore)``, and the history advances
    and the pstore is pushed under the same mask as the store.

    Under ``pull_mode="collective"`` every leaf is the rank's part and
    the pushes and the probe are shard-local (``shard_push(_ef)``,
    ``local_staleness_error``): the eps returned is this rank's, whose
    mesh-wide max :func:`_end_round` takes.

    Returns (store, push_residual, eps, last_push_round, pstore,
    predictor_history)."""
    store = state["store"]
    residual = state.get("push_residual")
    last = state.get("last_push_round")
    pstore = state.get("pstore")
    hist = state.get("predictor")
    eps = torch.zeros((max(cfg.num_layers - 1, 1),), dtype=torch.float32,
                      device=push_reps.device)
    if settings.mode != "digest" or cfg.num_layers <= 1:
        return store, residual, eps, last, pstore, hist
    do_push = (r - 1) % settings.sync_interval == 0
    local_valid = data["local_valid"]
    ok = None
    if last is not None:
        ok = state["push_ok"] & do_push                       # (M,)
        if settings.max_staleness is not None:
            ok = ok | ((r - last) >= settings.max_staleness)
        local_valid = local_valid & ok[:, None]
        last = torch.where(ok, torch.full_like(last, r), last)
        # The one host read of a fault-aware epoch: a round in which no
        # part pushes leaves every leaf as it was, so it skips the push.
        do_push = bool(ok.any())
    pred = settings.predictor.enabled and pstore is not None
    slots = data["local_slots"]
    collective = settings.pull_mode == "collective"
    if collective:
        shard_rows = _shard_rows(state, data)

        def push_rows(st, reps):
            return halo_exchange.shard_push(st, slots, local_valid, reps,
                                            shard_rows, mesh)

        def push_ef(st, reps, res):
            return halo_exchange.shard_push_ef(st, slots, local_valid, reps,
                                               res, shard_rows, mesh)
    else:
        def push_rows(st, reps):
            return halo_exchange.push(st, slots, local_valid, reps,
                                      data["sentinel_slots"])

        def push_ef(st, reps, res):
            return halo_exchange.push_ef(st, slots, local_valid, reps, res,
                                         data["sentinel_slots"])
    with trace.span("store.probe"):
        eps_store = store
        if pred:
            eps_store = {"data": halo_exchange.dequantize_rows(
                store["data"], store.get("scale"))
                + _f32(settings.predictor.gamma)
                * halo_exchange.dequantize_rows(pstore["data"],
                                                pstore.get("scale"))}
        if collective:
            eps = halo_exchange.local_staleness_error(
                eps_store, push_reps, slots, data["local_boundary"],
                shard_rows, mesh)
        else:
            eps = halo_exchange.staleness_error(eps_store, push_reps, slots,
                                                data["local_boundary"])
    if not do_push:
        return store, residual, eps, last, pstore, hist
    with trace.span("store.push"):
        if settings.precision.error_feedback:
            new_store, new_residual = push_ef(store, push_reps, residual)
            if ok is not None:
                # A masked part wrote nothing, so its residual must not
                # take this round's rounding error either.
                new_residual = torch.where(ok[:, None, None, None],
                                           new_residual, residual)
        else:
            new_store = push_rows(store, push_reps)
            new_residual = residual
        if pred:
            if ok is None:
                ok = torch.ones(local_valid.shape[:1], dtype=torch.bool,
                                device=local_valid.device)
            # No error feedback on the pstore: deltas do not telescope.
            hist, prows = predictor_mod.update_history(hist, push_reps, ok,
                                                       settings.predictor)
            pstore = push_rows(pstore, prows)
    return new_store, new_residual, eps, last, pstore, hist


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
                     cache: dict, struct_m: dict, pcache: dict = None,
                     gamma: float = 1.0) -> list:
    """Subgraph m's per-layer halo tables: layer 0 its raw-feature slab,
    layers ℓ ≥ 1 its pulled storage-precision slab (projected rows under
    GAT dedup), each with the out-ELL and its chunk worklist; with a
    pulled SAT slab ``pcache`` the kernels read ``dequant(cache) +
    gamma·dequant(pcache)``."""
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
            continue
        pk = {}
        if pcache is not None:
            psc = pcache.get("scale")
            pk = dict(pdata=pcache["data"][m, ell],
                      pscale=psc[m, ell] if psc is not None else None,
                      gamma=gamma)
        sc = cache.get("scale")
        tables.append(halo_ref(cache["data"][m, ell],
                               sc[m, ell] if sc is not None else None,
                               nbr, wts, *wl, pos=pos, **pk))
    return tables


def make_epoch_fn(cfg: GNNConfig, opt: Optimizer, settings: TrainSettings,
                  mesh=None) -> Callable:
    """``epoch_fn(state, data) -> (state, metrics)``: one global round r
    of Algorithm 1 over the M subgraphs.  With ``pull_mode="collective"``
    pass the ``mesh``: ``state`` and ``data`` are then this rank's parts
    (:func:`shard_state`, :func:`shard_data`) and the metrics the
    mesh-wide ones.  Each call is a ``digest.epoch`` span holding its
    phases' spans (``repro_torch.trace``)."""
    _check_settings(settings, mesh)
    loss_fn = make_subgraph_loss(cfg)

    def epoch_fn(state: dict, data: dict) -> tuple[dict, dict]:
        trace.COUNTERS["digest.epochs"] += 1
        with trace.span("digest.epoch"):
            return _epoch(state, data)

    def _epoch(state: dict, data: dict) -> tuple[dict, dict]:
        r = state["epoch"] + 1            # 1-indexed, as in Algorithm 1
        x_global = data["x_global"]
        struct = data["struct"]
        # The layer-0 halo features as per-subgraph slabs (M, H+1, d),
        # row H the zero sentinel (the partition baseline zeroes them);
        # the local rows after the pull, so that they are not held
        # across it (the epoch's peak memory is reached in the pull).
        with trace.span("digest.gather"):
            x_halo0 = x_global[data["halo_ids_x"].long()]
            if settings.mode == "partition":
                x_halo0 = torch.zeros_like(x_halo0)
        pcache = None
        if settings.mode == "propagation" and cfg.num_layers > 1:
            with torch.no_grad():
                cache = _propagation_cache(cfg, settings, state["params"],
                                           data)
        elif settings.mode == "digest":
            cache, pcache = _digest_pull(cfg, settings, state, data, r, mesh)
        else:
            cache = state["cache"]
        with trace.span("digest.gather"):
            x_local = x_global[data["local_ids"].long()]    # (M, S, d)

        def sub_loss(params, m):
            struct_m = {k: v[m] for k, v in struct.items()}
            tables = _subgraph_tables(cfg, m, x_halo0, cache, struct_m,
                                      pcache, settings.predictor.gamma)
            return loss_fn(params, x_local[m], tables, struct_m,
                           data["labels"][m], data["train_mask"][m])

        loss, push_reps, train_acc, mean_grads = _subgraph_grads(
            state["params"], x_local.shape[0], sub_loss, data["labels"],
            data["train_mask"], mesh)
        with trace.span("digest.update"):
            new_params, opt_state = opt.update(
                mean_grads, state["opt_state"], state["params"],
                state["step"])
        if settings.llcg_correction:
            new_params = _llcg_step(cfg, settings, new_params, data, r)
        return _end_round(cfg, settings, state, data, r, new_params,
                          opt_state, cache, pcache, push_reps, loss,
                          train_acc, mesh)

    return epoch_fn


def _subgraph_grads(params: Pytree, num_parts: int, sub_loss: Callable,
                    labels: torch.Tensor, mask: torch.Tensor,
                    mesh=None) -> tuple:
    """Each subgraph's ``sub_loss(params, m) -> (loss, (reps, logits))``
    differentiated by ``torch.autograd.grad`` in turn, and the M
    gradients averaged (Algorithm 1 line 13, as ``vmap`` + ``jnp.mean``
    do).  Returns (mean loss, push reps (M, L-1, S, hidden), train F1
    over ``mask``, mean gradients as a tree like ``params``).  The mean
    (with a mesh, its ``all_reduce`` too) is a ``digest.update`` span;
    the callers' optimizer step is a second one.

    With a ``mesh`` the ``num_parts`` are this rank's k of M: its parts'
    flat gradients, losses and F1 counts (hits, masked rows) go into
    their rows [e·k, (e+1)·k) of a zero (M, ·) buffer, one
    ``all_reduce(SUM)`` fills the others' (exact: one nonzero addend an
    element), and the mean runs over the M rows as on one device."""
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    tree = _unflatten(params, leaves)
    losses, reps, logits, grads = [], [], [], []
    for m in range(num_parts):
        with trace.span("digest.subgraph"):
            with trace.span("gnn.forward"):
                loss, (rep, lg) = sub_loss(tree, m)
            with trace.span("gnn.backward"):
                grads.append(torch.autograd.grad(loss, leaves,
                                                 allow_unused=True))
        losses.append(loss.detach())
        reps.append(rep.detach())
        logits.append(lg.detach())
    logits, reps = torch.stack(logits), torch.stack(reps)
    mask = mask.float()
    if mesh is None:
        loss, f1 = torch.stack(losses).mean(), micro_f1(logits, labels, mask)
        with trace.span("digest.update"):
            mean_grads = _unflatten(params, mean_grads_of(grads, leaves))
        return loss, reps, f1, mean_grads
    sizes = [p.numel() for p in leaves]
    hits = ((torch.argmax(logits, dim=-1) == labels).float()
            * mask).sum(dim=1)
    rows = [torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                       for p, g in zip(leaves, gm)]
                      + [losses[i][None], hits[i][None], mask[i].sum()[None]])
            for i, gm in enumerate(grads)]
    total = num_parts * halo_exchange.exchange_size(mesh)
    sl = halo_exchange.part_slice(total, mesh)
    flat = sum(sizes)
    with trace.span("digest.update"):
        buf = rows[0].new_zeros((total, rows[0].numel()))
        buf[sl] = torch.stack(rows)
        collectives.all_reduce(buf)
        all_grads = [tuple(v.reshape(p.shape) for v, p in zip(
            torch.split(row[:flat], sizes), leaves)) for row in buf]
        mean_grads = _unflatten(params, mean_grads_of(all_grads, leaves))
    n_hits, n_rows = buf[:, flat + 1].sum(), buf[:, flat + 2].sum()
    return (buf[:, flat].contiguous().mean(), reps,
            n_hits / torch.clamp_min(n_rows, 1.0), mean_grads)


def _end_round(cfg: GNNConfig, settings: TrainSettings, state: dict,
               data: dict, r: int, params: Pytree, opt_state: Pytree,
               cache: dict, pcache: Optional[dict], push_reps: torch.Tensor,
               loss: torch.Tensor, train_acc: torch.Tensor,
               mesh=None) -> tuple:
    """The round's PUSH (:func:`_digest_push`) and the new state and
    metrics, shared by the full-batch epoch and the sampled step.  With a
    ``mesh``: one ``all_reduce(MAX)`` of this rank's eps and push age
    gives the mesh-wide ones."""
    store, residual, eps, last, pstore, hist = _digest_push(
        cfg, settings, state, data, push_reps, r, mesh)
    age = (None if last is None
           else faults_mod.measured_staleness(last, r))
    if mesh is not None:
        top = eps if age is None else torch.cat([eps, age.float()[None]])
        collectives.all_reduce(top, dist.ReduceOp.MAX)
        eps = top[:eps.shape[0]]
        if age is not None:
            age = top[-1].to(torch.int32)
    new_state = {"params": params, "opt_state": opt_state,
                 "store": store, "cache": cache, "epoch": r,
                 "step": state["step"] + 1}
    if residual is not None:
        new_state["push_residual"] = residual
    if pstore is not None:
        new_state["pstore"] = pstore
        new_state["predictor"] = hist
    if pcache is not None:
        new_state["pcache"] = pcache
    metrics = {"loss": loss, "train_f1": train_acc, "staleness_eps": eps}
    if last is not None:
        new_state["push_ok"] = state["push_ok"]
        new_state["last_push_round"] = last
        metrics["push_age"] = age
    return new_state, metrics


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
               predictor: PredictorConfig = PredictorConfig(),
               params: Pytree = None) -> dict:
    """Initial training state on ``data``'s device: parameters drawn from
    ``torch.Generator`` seed ``seed`` (or ``params`` as given — parity
    tests pass the reference's), the optimizer state, the zero store and
    the zero pulled cache (projected slabs under GAT dedup).  An enabled
    ``predictor`` adds the ``pstore`` (the store's geometry and
    precision), its ``predictor`` history and, except under GAT dedup,
    the pulled ``pcache`` slab."""
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
    if predictor.enabled and cfg.num_layers > 1:
        state["pstore"] = halo_exchange.init_store(
            l1, num_slots, cfg.hidden_dim, precision, dev)
        state["predictor"] = predictor_mod.init_history(
            num_parts, l1, s, cfg.hidden_dim, dev)
        if not gat_projected(cfg):
            state["pcache"] = halo_exchange.init_slab(
                num_parts, l1, halo_size, cfg.hidden_dim, precision, dev)
    return state


def digest_train(cfg: GNNConfig, opt: Optimizer, data: dict,
                 settings: TrainSettings, epochs: int,
                 eval_every: int = 10, seed: int = 0,
                 verbose: bool = False, mesh=None, faults=None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 resume: bool = False, params: Pytree = None
                 ) -> tuple[dict, dict]:
    """Run training; returns (final_state, history dict of lists), the
    history recorded at every ``eval_every``-th epoch and the last.

    ``faults`` (a :class:`repro_torch.core.faults.FaultConfig` or
    ``FaultSchedule``) masks each part's push through ``push_ok``, and
    ``settings.max_staleness`` bounds the resulting staleness; either
    adds the fault-aware state leaves and ``hist["push_age"]``.  A
    ``None`` or zero-rate schedule leaves the run as without it, bit for
    bit.  ``ckpt_dir`` + ``ckpt_every`` save a checksummed checkpoint of
    the whole state every ``ckpt_every`` epochs; ``resume=True`` restores
    the newest valid one (corrupt or partial ones are skipped) and
    continues to ``epochs``: the epoch is deterministic in its state, so
    a killed and resumed run ends equal to an unbroken one.  ``params``
    replaces the drawn initial parameters (parity tests pass the
    reference's).

    ``pull_mode="collective"`` needs the ``mesh`` and runs on every rank
    of it: ``data`` is the whole :func:`prepare_graph_data` dict (every
    rank builds the same partition), the state is placed with
    :func:`shard_state`, the history is the mesh-wide one on every rank,
    and checkpoints hold whole arrays (:func:`gather_state`; rank 0
    writes), so a sharded run resumes from an unsharded run's checkpoint
    and the other way round."""
    _check_settings(settings, mesh)
    if mesh is not None:
        check_collective_geometry(data, mesh)
    state = init_state(cfg, opt, data, seed=seed,
                       precision=settings.precision,
                       predictor=settings.predictor, params=params)
    epoch_fn = make_epoch_fn(cfg, opt, settings, mesh)
    edata = data if mesh is None else shard_data(data, mesh)
    return _train_loop(cfg, data, settings, state,
                       lambda st, _: epoch_fn(st, edata), epochs, eval_every,
                       f"[{settings.mode}] epoch", verbose, faults, ckpt_dir,
                       ckpt_every, resume, mesh)


def _train_loop(cfg: GNNConfig, data: dict, settings: TrainSettings,
                state: dict, advance: Callable, rounds: int,
                eval_every: int, label: str, verbose: bool, faults,
                ckpt_dir: Optional[str], ckpt_every: int,
                resume: bool, mesh=None) -> tuple[dict, dict]:
    """The loop of :func:`digest_train` and :func:`sampled_train` over
    ``advance(state, t) -> (state, metrics)``, round t + 1: the fault
    leaves and each round's ``push_ok``, resume from the newest valid
    checkpoint, the history every ``eval_every``-th round and the last,
    and a checkpoint every ``ckpt_every`` rounds.  ``state`` is whole;
    with a ``mesh`` it is placed with :func:`shard_state` (restored
    ones too), each ``push_ok`` cut to the rank's parts, and each
    checkpoint gathered whole and written by rank 0; the returned state
    is the rank's part."""
    if resume and ckpt_dir is None:
        raise ValueError("resume=True needs ckpt_dir")
    schedule = faults_mod.check_schedule(faults)
    num_parts = int(data["local_ids"].shape[0])
    fault_aware = schedule is not None or settings.max_staleness is not None
    if fault_aware:
        state = faults_mod.attach_fault_state(state, num_parts)
    place = None if mesh is None else (lambda tree: shard_state(tree, mesh))
    parts = (slice(None) if mesh is None
             else halo_exchange.part_slice(num_parts, mesh))
    start = 0
    step = ckpt_io.latest_step(ckpt_dir) if resume else None
    if step is not None:
        state, _ = ckpt_io.restore_checkpoint(ckpt_dir, state, step=step,
                                              sharding=place)
        start = state["epoch"]
    elif place is not None:
        state = place(state)
    hist: dict[str, list] = {"epoch": [], "loss": [], "train_f1": [],
                             "val_f1": [], "test_f1": [], "time": [],
                             "staleness_eps": []}
    if fault_aware:
        hist["push_age"] = []
    dev = data["x_global"].device
    t0 = time.perf_counter()
    for t in range(start, rounds):
        if fault_aware:
            ok = (schedule.push_ok(t + 1, num_parts) if schedule is not None
                  else np.ones(num_parts, dtype=bool))
            state["push_ok"] = torch.from_numpy(ok[parts]).to(dev)
        state, m = advance(state, t)
        if (t + 1) % eval_every == 0 or t == rounds - 1:
            ev = evaluate(cfg, state["params"], data)
            hist["epoch"].append(t + 1)
            hist["loss"].append(float(m["loss"]))
            hist["train_f1"].append(float(m["train_f1"]))
            hist["val_f1"].append(float(ev["val_f1"]))
            hist["test_f1"].append(float(ev["test_f1"]))
            hist["staleness_eps"].append(
                m["staleness_eps"].cpu().numpy().tolist())
            hist["time"].append(time.perf_counter() - t0)
            if fault_aware:
                hist["push_age"].append(int(m["push_age"]))
            if verbose:
                print(f"{label} {t+1:4d} loss {float(m['loss']):.4f} "
                      f"val_f1 {float(ev['val_f1']):.4f}")
        if ckpt_dir and ckpt_every and (t + 1) % ckpt_every == 0:
            save_state(ckpt_dir, t + 1, state, mesh)
    return state, hist


def save_state(ckpt_dir: str, step: int, state: dict, mesh=None) -> None:
    """Checkpoint ``state`` whole: on a mesh every rank joins the gather,
    rank 0 writes, and no rank goes on before the files are in place."""
    if mesh is None:
        ckpt_io.save_checkpoint(ckpt_dir, step, state)
        return
    whole = gather_state(state, mesh)
    if dist.get_rank() == 0:
        ckpt_io.save_checkpoint(ckpt_dir, step, whole)
    collectives.barrier()


# ---------------------------------------------------------------------------
# Mini-batch sampled training (stale-store control variates)
# ---------------------------------------------------------------------------

def make_sampled_epoch_fn(cfg: GNNConfig, opt: Optimizer,
                          settings: TrainSettings, mesh=None) -> Callable:
    """``step_fn(state, data, batch) -> (state, metrics)``: one sampled
    step over the M subgraphs on one device — the mini-batch regime over
    the same stale store.

    ``batch`` is one :class:`repro_torch.graph.sampler.NeighborSampler`
    draw as tensors on the data's device (``seed_mask``/``edge_scale``/
    ``edge_keep``).  In-subgraph sampled neighbours aggregate fresh,
    their complement reads the control-variate history ``state["hist"]``
    (each subgraph's own rows from the last step), out-of-subgraph rows
    the pulled slab (refreshed by :func:`_digest_pull` every
    ``sync_interval`` steps), and the loss is masked to the seeds.  Pull,
    push, faults and the staleness probe are the full-batch epoch's.

    ``settings.sample_estimator``: "cv" (VR-GCN) or "plain" — plain
    neighbour sampling is the CV estimator against an all-zero history,
    so it is fed zeros.  With ``pull_mode="collective"`` pass the
    ``mesh``; ``state``, ``data`` and ``batch`` are then this rank's
    parts (:func:`shard_state`, :func:`shard_data`, :func:`shard_batch`).
    """
    if settings.mode != "digest":
        raise ValueError("sampled training rides the stale store — "
                         f"mode must be 'digest', got {settings.mode!r}")
    _check_settings(settings, mesh)
    if settings.sample_estimator not in ("cv", "plain"):
        raise ValueError(f"sample_estimator must be 'cv' or 'plain', "
                         f"got {settings.sample_estimator!r}")
    n_hidden = cfg.num_layers - 1

    def step_fn(state: dict, data: dict, batch: dict) -> tuple[dict, dict]:
        r = state["epoch"] + 1
        x_global = data["x_global"]
        struct = data["struct"]
        x_halo0 = x_global[data["halo_ids_x"].long()]
        cache, pcache = _digest_pull(cfg, settings, state, data, r, mesh)
        x_local = x_global[data["local_ids"].long()]
        hist = state["hist"]
        if settings.sample_estimator == "plain":
            hist = torch.zeros_like(hist)

        def sub_loss(params, m):
            struct_m = {k: v[m] for k, v in struct.items()}
            tables = [_detach(t) for t in _subgraph_tables(
                cfg, m, x_halo0, cache, struct_m, pcache,
                settings.predictor.gamma)]
            samp = {"edge_scale": batch["edge_scale"][m],
                    "edge_keep": batch["edge_keep"][m]}
            logits, push = gnn_forward_sampled(
                cfg, params, x_local[m], tables,
                [hist[m, i].detach() for i in range(n_hidden)], struct_m,
                samp)
            loss = softmax_cross_entropy(logits, data["labels"][m],
                                         batch["seed_mask"][m])
            reps = (torch.stack(push) if push
                    else x_local.new_zeros((0,) + tuple(x_local.shape[1:])))
            return loss, (reps, logits)

        loss, push_reps, train_acc, mean_grads = _subgraph_grads(
            state["params"], x_local.shape[0], sub_loss, data["labels"],
            batch["seed_mask"], mesh)
        with trace.span("digest.update"):
            params, opt_state = opt.update(mean_grads, state["opt_state"],
                                           state["params"], state["step"])
        new_state, metrics = _end_round(cfg, settings, state, data, r,
                                        params, opt_state, cache, pcache,
                                        push_reps, loss, train_acc, mesh)
        # The history refreshes every step (every local row's
        # representation is computed anyway), so the in-subgraph
        # baseline is one step stale; the halo side keeps the store's
        # sync_interval staleness.
        new_state["hist"] = push_reps if n_hidden > 0 else state["hist"]
        return new_state, metrics

    return step_fn


def init_sampled_state(cfg: GNNConfig, opt: Optimizer, data: dict,
                       seed: int = 0,
                       precision: HaloPrecision = HaloPrecision(),
                       predictor: PredictorConfig = PredictorConfig(),
                       params: Pytree = None) -> dict:
    """:func:`init_state` plus the control-variate history ``hist`` (M,
    L-1, S, hidden) fp32, zeros like the store (the in-ELL's padding
    entries point at the zero sentinel and weigh 0 anyway)."""
    state = init_state(cfg, opt, data, seed=seed, precision=precision,
                       predictor=predictor, params=params)
    num_parts, s = data["local_ids"].shape
    state["hist"] = torch.zeros(
        (num_parts, cfg.num_layers - 1, s, cfg.hidden_dim),
        dtype=torch.float32, device=data["x_global"].device)
    return state


def batch_tensors(batch: dict, device) -> dict:
    """A sampler batch (numpy) as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def sampled_advance(step_fn: Callable, sampler, data: dict,
                    mesh=None) -> Callable:
    """``advance(state, t) -> (state, metrics)``: ``step_fn`` (from
    :func:`make_sampled_epoch_fn`) on ``sampler.sample(t)``, uploaded to
    ``data``'s device — with a ``mesh`` only this rank's parts of the
    draw (every rank draws all M from the same seed)."""
    dev = data["x_global"].device

    def draw(t):
        batch = sampler.sample(t)
        return batch if mesh is None else shard_batch(batch, mesh)

    return lambda state, t: step_fn(state, data,
                                    batch_tensors(draw(t), dev))


def sampled_train(cfg: GNNConfig, opt: Optimizer, data: dict, sampler,
                  settings: TrainSettings, steps: int, eval_every: int = 10,
                  seed: int = 0, verbose: bool = False, mesh=None,
                  faults=None, ckpt_dir: Optional[str] = None,
                  ckpt_every: int = 0, resume: bool = False,
                  params: Pytree = None) -> tuple[dict, dict]:
    """Run mini-batch sampled training; returns (final_state, history).

    ``sampler`` is a :class:`repro_torch.graph.sampler.NeighborSampler`;
    step t consumes ``sampler.sample(t)``.  ``faults``, ``ckpt_dir``/
    ``ckpt_every``/``resume`` and ``params`` behave as in
    :func:`digest_train`: the batches and the fault schedule are pure
    functions of the step, so a resumed run replays the same ones and
    ends equal to an unbroken run.  ``mesh`` as in :func:`digest_train`
    (the sampler draws all M parts on every rank; each keeps its own)."""
    _check_settings(settings, mesh)
    if mesh is not None:
        check_collective_geometry(data, mesh)
    state = init_sampled_state(cfg, opt, data, seed=seed,
                               precision=settings.precision,
                               predictor=settings.predictor, params=params)
    step_fn = make_sampled_epoch_fn(cfg, opt, settings, mesh)
    edata = data if mesh is None else shard_data(data, mesh)
    return _train_loop(
        cfg, data, settings, state,
        sampled_advance(step_fn, sampler, edata, mesh),
        steps, eval_every, f"[sampled/{settings.sample_estimator}] step",
        verbose, faults, ckpt_dir, ckpt_every, resume, mesh)
