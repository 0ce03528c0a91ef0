"""HaloExchange — the stale-representation store, owner-sharded and
precision-aware (the port of ``src/repro/core/halo_exchange.py``: the
store, its pull and push, error feedback and the staleness probe, on one
device and over a ``torch.distributed`` mesh).

A store is a plain dict of tensors:

    {"data": (L-1, R, hidden) <storage dtype>}        fp32 / bf16
    {"data": int8 ..., "scale": (L-1, R, 1) float32}  int8

with ``R = M · shard_rows`` slot rows, shard m holding the rows owned by
part m and the last row of every shard a zero sentinel.  int8 uses
symmetric per-row quantisation, ``scale = max|row| / 127``,
``q = round(row / scale)``, formula for formula as the reference
(``src/repro/core/halo_exchange.py``), so int8 codes match it bit for bit
on equal input.

PULL (Algorithm 1 line 5) is :func:`pull_slab`: each subgraph's halo rows
gathered into a device-local slab ``(M, L-1, H+1, hidden)`` in storage
precision, row H the zero sentinel.  PUSH (lines 9-10) is :func:`push`, or
:func:`push_ef` with the pusher's rounding residual carried forward; a
DIGEST-A worker pushes its own shard alone (:func:`owner_push`,
:func:`owner_push_ef`).
Theorem 1's per-layer staleness is :func:`staleness_error`.  Every pull
and push adds the bytes it writes to ``repro_torch.trace.COUNTERS``
(``store.pull_bytes``, ``store.push_bytes``).

The mesh forms (``pull_mode="collective"``): the M parts lie over the
ranks of a ``("data",)`` or ``("pod", "data")`` DeviceMesh
(``repro_torch.launch.mesh``), rank e = p·data + d holding parts and owner
shards ``[e·k, (e+1)·k)`` (:func:`part_slice`), its store the
``(L-1, k·shard_rows, hidden)`` block of its shards.
:func:`collective_pull` routes the rows each requester's halo references
by the :class:`~repro_torch.graph.partition.PullPlan` with one
``all_to_all`` a store tensor (on pods: an intra-pod all-to-all, then
one point-to-point exchange over the pod axis, each row crossing pods
once), gathers and scatters only, so its slab equals
:func:`pull_slab`'s rows bit for bit.  :func:`shard_push` /
:func:`shard_push_ef` scatter into the rank's own shards and
communicate nothing; :func:`shard_staleness_error` reads them and
all-reduces the (L-1,) max.  Every collective goes through
``core.collectives``, which counts it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

import torch.distributed as dist

from repro_torch import trace
from repro_torch.core import collectives
from repro_torch.device import resolve_device
from repro_torch.graph.partition import parts_per_device
from repro_torch.kernels._build import nbytes
from repro_torch.launch.mesh import refuse_model_dim

PRECISIONS = ("fp32", "bf16", "int8")

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
_VALUE_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


@dataclasses.dataclass(frozen=True)
class HaloPrecision:
    """Wire/storage precision of the halo slab (one knob for both)."""

    storage: str = "fp32"          # fp32 | bf16 | int8
    # Accumulate the per-row quantisation residual at the pusher
    # (push_ef) so repeated pushes stay unbiased.  Only meaningful for
    # lossy storage (int8 / bf16); a no-op for fp32.
    error_feedback: bool = False

    def __post_init__(self):
        if self.storage not in PRECISIONS:
            raise ValueError(f"storage {self.storage!r} not in {PRECISIONS}")

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.storage]

    @property
    def has_scale(self) -> bool:
        return self.storage == "int8"

    def row_bytes(self, hidden: int) -> int:
        """Bytes to store/ship one node-layer row of width ``hidden``."""
        extra = 4 if self.has_scale else 0       # one fp32 scale per row
        return hidden * _VALUE_BYTES[self.storage] + extra


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Static shape/precision metadata of a compact store (accounting)."""

    num_hidden_layers: int          # L-1
    num_slots: int                  # |boundary| (excl. sentinels/padding)
    hidden: int
    precision: HaloPrecision = HaloPrecision()
    # Owner-sharded layout: R = store_rows slab rows over num_shards
    # devices.  Defaults describe the unsharded (single-sentinel) layout.
    store_rows: Optional[int] = None
    num_shards: int = 1

    @classmethod
    def from_partitions(cls, sp, hidden: int, num_layers: int,
                        precision: HaloPrecision = HaloPrecision()
                        ) -> "HaloSpec":
        return cls(num_hidden_layers=max(num_layers - 1, 1),
                   num_slots=sp.num_boundary, hidden=hidden,
                   precision=precision, store_rows=sp.store_rows,
                   num_shards=sp.num_parts)

    def _rows(self) -> int:
        return (self.store_rows if self.store_rows is not None
                else self.num_slots + 1)

    def init(self, device="cuda") -> dict:
        return init_store(self.num_hidden_layers, self._rows() - 1,
                          self.hidden, self.precision, device)

    def store_nbytes(self) -> int:
        """Total bytes of the slab (incl. sentinel/padding rows)."""
        return (self.num_hidden_layers * self._rows()
                * self.precision.row_bytes(self.hidden))

    def shard_nbytes(self) -> int:
        """Per-device resident bytes under the owner-sharded layout."""
        return self.store_nbytes() // self.num_shards

    def dense_nbytes(self, num_nodes: int) -> int:
        """What a dense fp32 ``(L-1, N+1, hidden)`` store costs."""
        return self.num_hidden_layers * (num_nodes + 1) * self.hidden * 4

    def replicated_pull_nbytes(self) -> int:
        """Wire bytes per sync to replicate the compact (|boundary|+1)-row
        slab on every one of the M devices."""
        return ((self.num_shards - 1) * self.num_hidden_layers
                * (self.num_slots + 1)
                * self.precision.row_bytes(self.hidden))

    def comm_bytes(self, pull_rows: int, push_rows: int) -> dict:
        """Per-sync §3.3 byte counts under the configured wire precision
        (pull_rows = sum_m |halo(G_m)|, push_rows = sum_m |boundary ∩
        V_m|)."""
        rb = self.precision.row_bytes(self.hidden)
        pull = int(pull_rows) * self.num_hidden_layers * rb
        push = int(push_rows) * self.num_hidden_layers * rb
        return {"pull_bytes": pull, "push_bytes": push,
                "total_bytes": pull + push}

    def collective_pull_nbytes(self, plan_max_rows: int) -> int:
        """Wire bytes of one :func:`collective_pull`: the all-to-all pads
        every (owner, requester) pair to the plan's width K, so M·M·K
        rows a hidden layer."""
        return (self.num_shards * self.num_shards * int(plan_max_rows)
                * self.num_hidden_layers
                * self.precision.row_bytes(self.hidden))


def precision_of(store: dict) -> HaloPrecision:
    if "scale" in store:
        return HaloPrecision("int8")
    if store["data"].dtype == torch.bfloat16:
        return HaloPrecision("bf16")
    return HaloPrecision("fp32")


# ---------------------------------------------------------------------------
# Quantisation
# ---------------------------------------------------------------------------

def quantize_rows(x: torch.Tensor, precision: HaloPrecision
                  ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Encode fp32 rows (..., hidden) into (data, scale-or-None)."""
    if precision.storage == "fp32":
        return x.float(), None
    if precision.storage == "bf16":
        return x.to(torch.bfloat16), None
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    # torch.round rounds half to even, as jnp.round does.
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    return q, scale.float()


def dequantize_rows(data: torch.Tensor, scale: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    out = data.float()
    return out if scale is None else out * scale


# ---------------------------------------------------------------------------
# The store operations (compact-slot indexed)
# ---------------------------------------------------------------------------

def _count_pull(slab: dict) -> None:
    """``trace.COUNTERS``: the bytes of the slab a pull wrote."""
    trace.COUNTERS["store.pull_bytes"] += nbytes(*slab.values())


def _count_push(store: dict, rows: int) -> None:
    """``trace.COUNTERS``: the bytes of a push writing ``rows`` rows of
    each layer of ``store`` (data and scale)."""
    row = sum(t.shape[-1] * t.element_size() for t in store.values())
    trace.COUNTERS["store.push_bytes"] += store["data"].shape[0] * rows * row


def init_store(num_hidden_layers: int, num_slots: int, hidden: int,
               precision: HaloPrecision = HaloPrecision(),
               device="cuda") -> dict:
    """Zero slab; (L-1, num_slots+1, hidden).  For the owner-sharded
    layout pass ``num_slots = store_rows - 1`` (sentinel rows included)."""
    dev = resolve_device(device)
    store = {"data": torch.zeros((num_hidden_layers, num_slots + 1, hidden),
                                 dtype=precision.dtype, device=dev)}
    if precision.has_scale:
        store["scale"] = torch.ones((num_hidden_layers, num_slots + 1, 1),
                                    dtype=torch.float32, device=dev)
    return store


def init_slab(num_parts: int, num_hidden_layers: int, halo_size: int,
              hidden: int, precision: HaloPrecision = HaloPrecision(),
              device="cuda") -> dict:
    """Zero per-subgraph halo slab — the device-local pull target:
    {"data": (M, L-1, H+1, hidden)} with the zero sentinel row at H."""
    dev = resolve_device(device)
    slab = {"data": torch.zeros(
        (num_parts, num_hidden_layers, halo_size + 1, hidden),
        dtype=precision.dtype, device=dev)}
    if precision.has_scale:
        slab["scale"] = torch.ones(
            (num_parts, num_hidden_layers, halo_size + 1, 1),
            dtype=torch.float32, device=dev)
    return slab


def layer_table(store: dict, ell: int
                ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(data, scale) slab of hidden layer ``ell`` — feeds the fused
    kernel."""
    return store["data"][ell], (store["scale"][ell] if "scale" in store
                                else None)


def pull(store: dict, slots: torch.Tensor) -> torch.Tensor:
    """Gather + dequantise stale halo tables (Algorithm 1 line 5).

    slots: (M, H) compact slot ids (sentinel rows at padding).
    Returns (M, L-1, H, hidden) float32."""
    idx = slots.long()
    out = store["data"][:, idx, :].float()             # (L-1, M, H, h)
    if "scale" in store:
        out = out * store["scale"][:, idx, :]
    return out.transpose(0, 1)


def pull_slab(store: dict, halo_slots: torch.Tensor) -> dict:
    """PULL, dense-gather form: each subgraph's halo rows gathered into a
    device-local slab in storage precision, {"data": (M, L-1, H+1,
    hidden)[, "scale"]}, slab row H the zero sentinel (scale 1)."""
    idx = halo_slots.long()
    data = store["data"][:, idx, :].transpose(0, 1)    # (M, L-1, H, h)
    pad = data.new_zeros(data.shape[:2] + (1,) + data.shape[3:])
    out = {"data": torch.cat([data, pad], dim=2).contiguous()}
    if "scale" in store:
        sc = store["scale"][:, idx, :].transpose(0, 1)
        one = sc.new_ones(sc.shape[:2] + (1,) + sc.shape[3:])
        out["scale"] = torch.cat([sc, one], dim=2).contiguous()
    _count_pull(out)
    return out


def push(store: dict, local_slots: torch.Tensor, local_valid: torch.Tensor,
         reps: torch.Tensor, sentinels: Optional[torch.Tensor] = None,
         inplace: bool = False) -> dict:
    """Quantise + scatter fresh local rows (Algorithm 1 lines 9–10).

    local_slots: (M, S) slot ids — part m's *own* sentinel row for rows
      that are not stored (every write stays inside the owner shard).
    local_valid: (M, S) bool; reps: (M, L-1, S, hidden) fp32.
    sentinels: (M,) per-part sentinel slots (re-zeroed after the scatter);
      defaults to the single last row for the unsharded layout.
    inplace: write into the store's own tensors (the counterpart of XLA
      buffer donation) instead of copies; the returned dict then holds
      the very tensors of ``store``.
    """
    data = store["data"]
    l1, rows, hidden = data.shape
    if sentinels is None:
        sentinels = torch.tensor([rows - 1], dtype=torch.int32)
    sentinels = sentinels.to(device=data.device, dtype=torch.long)
    sentinels = sentinels.reshape(-1)
    m, s = local_slots.shape
    per_part = sentinels if sentinels.numel() == m else sentinels[:1]
    fallback = per_part.reshape(-1, 1).expand(m, s)
    ids = torch.where(local_valid, local_slots.long(), fallback).reshape(-1)
    vals = torch.where(local_valid[:, None, :, None], reps,
                       torch.zeros((), dtype=reps.dtype, device=reps.device))
    q, scale = quantize_rows(vals, precision_of(store))
    q = q.transpose(0, 1).reshape(l1, m * s, hidden)
    new_data = data if inplace else data.clone()
    new_data[:, ids, :] = q
    new_data[:, sentinels, :] = 0
    new = {"data": new_data}
    if scale is not None:
        scale = scale.transpose(0, 1).reshape(l1, m * s, 1)
        new_scale = store["scale"] if inplace else store["scale"].clone()
        new_scale[:, ids, :] = scale
        new_scale[:, sentinels, :] = 1.0
        new["scale"] = new_scale
    _count_push(store, ids.numel() + sentinels.numel())
    return new


def _ef_residual(compensated: torch.Tensor, valid_mask: torch.Tensor,
                 precision: HaloPrecision) -> torch.Tensor:
    """New rounding residual of an error-feedback push: what the wire
    format lost of the (masked) compensated rows; invalid rows give 0."""
    masked = torch.where(valid_mask, compensated,
                         torch.zeros((), dtype=compensated.dtype,
                                     device=compensated.device))
    q, scale = quantize_rows(masked, precision)
    return masked - dequantize_rows(q, scale)


def push_ef(store: dict, local_slots: torch.Tensor,
            local_valid: torch.Tensor, reps: torch.Tensor,
            residual: torch.Tensor,
            sentinels: Optional[torch.Tensor] = None
            ) -> tuple[dict, torch.Tensor]:
    """Error-feedback PUSH: quantise ``reps + residual`` and carry the new
    rounding residual forward at the pusher.  ``residual`` has the shape
    of ``reps``; returns (new_store, new_residual)."""
    compensated = reps + residual
    new_store = push(store, local_slots, local_valid, compensated,
                     sentinels)
    return new_store, _ef_residual(compensated,
                                   local_valid[:, None, :, None],
                                   precision_of(store))


def owner_push(store: dict, owner: int, local_slots: torch.Tensor,
               local_valid: torch.Tensor, reps: torch.Tensor,
               shard_rows: int) -> dict:
    """Single-part PUSH that only ever touches the owner's shard (the
    DIGEST-A worker's push): quantise ``reps``, scatter them at
    owner-local offsets ``local_slots - owner·shard_rows`` into the
    ``shard_rows`` rows of shard ``owner`` (a row with ``~local_valid``
    goes to offset ``shard_rows - 1``), then reset that shard's last row
    (data 0, scale 1).

    local_slots: (S,) global store slots of this part's local rows (its
    own sentinel at non-boundary rows); local_valid: (S,) bool; reps:
    (L-1, S, hidden) fp32.  The shard is written in the store's own
    tensors (one shard a push, so no copy of the whole slab), no row
    outside it changes, and the returned dict holds the very tensors of
    ``store``.
    """
    data = store["data"]
    start = int(owner) * shard_rows
    off = torch.where(local_valid, local_slots.long() - start,
                      shard_rows - 1)
    vals = torch.where(local_valid[None, :, None], reps,
                       torch.zeros((), dtype=reps.dtype, device=reps.device))
    q, scale = quantize_rows(vals, precision_of(store))
    shard = data[:, start:start + shard_rows]
    shard[:, off, :] = q
    shard[:, -1, :] = 0
    if scale is not None:
        sshard = store["scale"][:, start:start + shard_rows]
        sshard[:, off, :] = scale
        sshard[:, -1, :] = 1.0
    _count_push(store, off.numel() + 1)
    return store


def owner_push_ef(store: dict, owner: int, local_slots: torch.Tensor,
                  local_valid: torch.Tensor, reps: torch.Tensor,
                  residual: torch.Tensor, shard_rows: int
                  ) -> tuple[dict, torch.Tensor]:
    """Error-feedback form of :func:`owner_push` (see :func:`push_ef`),
    in place as it is: returns (store, new_residual)."""
    compensated = reps + residual
    new_store = owner_push(store, owner, local_slots, local_valid,
                           compensated, shard_rows)
    return new_store, _ef_residual(compensated, local_valid[None, :, None],
                                   precision_of(store))


def staleness_error(store: dict, fresh: torch.Tensor,
                    local_slots: torch.Tensor,
                    served: torch.Tensor) -> torch.Tensor:
    """ε^(ℓ) = max_v ‖h_v^(ℓ) − h̃_v^(ℓ)‖₂ over *served* (boundary) rows.

    fresh: (M, L-1, S, hidden) this epoch's representations; served:
    (M, S) bool (``StackedPartitions.local_boundary``).  Returns (L-1,)."""
    stale = pull(store, local_slots)                   # (M, L-1, S, h)
    diff = torch.linalg.vector_norm(fresh - stale, dim=-1)
    diff = torch.where(served[:, None, :], diff,
                       torch.zeros((), dtype=diff.dtype, device=diff.device))
    return torch.amax(diff, dim=(0, 2))


# ---------------------------------------------------------------------------
# The mesh forms (pull_mode="collective")
# ---------------------------------------------------------------------------

def exchange_axes(mesh, axis: str = "data") -> tuple:
    """Mesh dimensions M is laid over: ``("pod", axis)`` on a mesh with a
    "pod" dimension (rank (p, d) owns combined block e = p·data + d),
    else ``(axis,)``."""
    names = mesh.mesh_dim_names or ()
    return ("pod", axis) if "pod" in names else (axis,)


def _dim_size(mesh, name: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(name)])


def exchange_size(mesh, axis: str = "data") -> int:
    """Ranks along the exchange dimensions (pods · data)."""
    num = 1
    for a in exchange_axes(mesh, axis):
        num *= _dim_size(mesh, a)
    return num


def _combined_index(mesh, axis: str = "data") -> int:
    """This rank's combined block index e = p·data + d (the data index
    on a single-pod mesh)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not on the mesh")
    names = mesh.mesh_dim_names
    e = coord[names.index(axis)]
    if "pod" in names:
        e += coord[names.index("pod")] * _dim_size(mesh, axis)
    return int(e)


def shards_per_device(num_parts: int, mesh, axis: str = "data",
                      what: str = "collective halo exchange") -> int:
    """k = num_parts / (pods · data): owner shards (and subgraphs) a rank
    holds; raises the spelled-out ValueError of
    :func:`repro_torch.graph.partition.parts_per_device` when M is not a
    multiple of the exchange dimensions, and for a ``"model"`` dimension
    above 1 (the rank would no longer be the block index)."""
    refuse_model_dim(mesh, what)
    return parts_per_device(num_parts, exchange_size(mesh, axis), what)


def part_slice(num_parts: int, mesh, axis: str = "data") -> slice:
    """This rank's parts ``[e·k, (e+1)·k)`` of the M stacked ones."""
    k = shards_per_device(num_parts, mesh, axis)
    e = _combined_index(mesh, axis)
    return slice(e * k, (e + 1) * k)


def shard_parts(tree: dict, mesh, axis: str = "data") -> dict:
    """This rank's k parts (dim 0) of every tensor of a dict of stacked
    (M, …) tensors (copies)."""
    sl = part_slice(int(next(iter(tree.values())).shape[0]), mesh, axis)
    return {k: v[sl].clone() for k, v in tree.items()}


def shard_store(store: dict, num_parts: int, mesh,
                axis: str = "data") -> dict:
    """This rank's k owner shards of a whole ``(L-1, R, w)`` store (each
    leaf's rows ``[e·k·shard_rows, (e+1)·k·shard_rows)``; a 0-d leaf such
    as serving's ``version`` stays whole).  Copies, so the whole store
    can be freed."""
    sl = part_slice(num_parts, mesh, axis)
    out = {}
    for key, v in store.items():
        if v.dim() < 2:
            out[key] = v
            continue
        rows = v.shape[1] // num_parts
        out[key] = v[:, sl.start * rows:sl.stop * rows].clone()
    return out


def _pod_exchange(got: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Stage 2 of a pod pull: ``got`` (p_r, d_o, b, a, …) holds the rows
    this rank's pod owns, keyed by the requester's pod p_r; one
    point-to-point round over the pod dimension (a send to and a receive
    from each other pod, (p ± s) mod pods) returns (p_o, d_o, b, a, …):
    the rows pod p_o owns that are destined for this rank."""
    pods = _dim_size(mesh, "pod")
    names = mesh.mesh_dim_names
    my = mesh.get_coordinate()[names.index("pod")]
    group = mesh.get_group("pod")
    out = got.new_empty(got.shape)                 # contiguous
    out[my] = got[my]
    sends, recvs = [], []
    for s in range(1, pods):
        dst, src = (my + s) % pods, (my - s) % pods
        sends.append((got[dst].contiguous(),
                      dist.get_global_rank(group, dst)))
        recvs.append((out[src], dist.get_global_rank(group, src)))
    collectives.exchange(sends, recvs, group)
    return out


def collective_pull(store: dict, send_offsets: torch.Tensor,
                    recv_positions: torch.Tensor, halo_size: int,
                    mesh, axis: str = "data") -> dict:
    """Collective PULL: the mesh form of :func:`pull_slab`, shipping only
    the rows each requester's halo references.

    store: this rank's k owner shards ``{"data": (L-1, k·shard_rows, w)
    [, "scale"]}``; send_offsets / recv_positions: this rank's (k, M, K)
    rows of ``PullPlan.send_offsets`` (its owners) and
    ``PullPlan.recv_positions`` (its requesters).  Each rank gathers from
    its shards the rows its owners ship to every requester, and one
    ``all_to_all`` a store tensor routes them, the layers batched inside
    (on a pod mesh: over "data", then :func:`_pod_exchange` over "pod");
    each requester scatters its rows into its ``(L-1, H+1, w)`` slab,
    pad 0 (scale 1).  Returns ``{"data": (k, L-1, H+1, w)[, "scale"]}``,
    this rank's parts of :func:`pull_slab`'s slab, bit for bit.  Raises
    ValueError when M is not a multiple of the exchange dimensions."""
    k, num_parts, width_k = send_offsets.shape
    if shards_per_device(num_parts, mesh, axis, "collective_pull") != k:
        raise ValueError(f"collective_pull: {k} plan rows on this rank, "
                         f"expected M / ranks for M = {num_parts}")
    l1, rows_local, _ = store["data"].shape
    shard_rows = rows_local // k
    num_data = _dim_size(mesh, axis)
    pods = _dim_size(mesh, "pod") if len(exchange_axes(mesh, axis)) == 2 \
        else 1
    dev = store["data"].device
    base = (torch.arange(k, device=dev) * shard_rows)[:, None, None]
    # Rows in send order (d_r, p_r, b, a, K): the requester m = (p_r·data
    # + d_r)·k + b of owner a's row, first by the requester's data
    # coordinate (the all-to-all's destination).
    idx = (send_offsets.long() + base).reshape(k, pods, num_data, k,
                                               width_k)
    idx = idx.permute(2, 1, 3, 0, 4).reshape(-1)
    pos = recv_positions.long().reshape(k, num_parts * width_k)
    parts = torch.arange(k, device=dev)[:, None].expand_as(pos)
    out = {}
    for key, pad in (("data", 0), ("scale", 1.0)):
        if key not in store:
            continue
        table = store[key]
        width = table.shape[-1]
        rows = table.transpose(0, 1)[idx]              # (n, L-1, w)
        got = torch.empty_like(rows)
        collectives.all_to_all_single(got, rows, mesh.get_group(axis))
        # got[d_o, p_r, b, a]: what data-peer d_o of this pod ships
        # toward (pod p_r, this data column).
        got = got.view(num_data, pods, k, k, width_k, l1, width)
        got = got.transpose(0, 1)                      # (p_r, d_o, …)
        if pods > 1:
            got = _pod_exchange(got, mesh, axis)       # (p_o, d_o, …)
        # Owner j = (p_o·data + d_o)·k + a, in the (M, K) order of
        # recv_positions[b].
        vals = got.permute(2, 0, 1, 3, 4, 5, 6).reshape(
            k, num_parts * width_k, l1, width)
        slab = table.new_full((k, l1, halo_size + 1, width), pad)
        # Duplicate positions occur only at the sentinel row H, where
        # every routed row is an owner sentinel (data 0, scale 1).
        slab[parts, :, pos] = vals
        out[key] = slab
    _count_pull(out)
    return out


def shard_push(store: dict, local_slots: torch.Tensor,
               local_valid: torch.Tensor, reps: torch.Tensor,
               shard_rows: int, mesh, axis: str = "data",
               inplace: bool = False) -> dict:
    """Shard-local PUSH: :func:`push` for this rank's k parts into its own
    k shards, at owner-local offsets ``slot - e·k·shard_rows`` (a row with
    ``~local_valid`` goes to its part's sentinel, re-zeroed after).  No
    communication; ``store`` is the rank's ``(L-1, k·shard_rows, w)``
    block, local_slots / local_valid (k, S), reps (k, L-1, S, w).
    ``inplace`` as for :func:`push`."""
    k = local_slots.shape[0]
    e = _combined_index(mesh, axis)
    data = store["data"]
    l1, _, hidden = data.shape
    dev = data.device
    sent = (torch.arange(k, device=dev) + 1) * shard_rows - 1
    off = torch.where(local_valid, local_slots.long() - e * k * shard_rows,
                      sent[:, None]).reshape(-1)
    vals = torch.where(local_valid[:, None, :, None], reps,
                       torch.zeros((), dtype=reps.dtype, device=reps.device))
    q, scale = quantize_rows(vals, precision_of(store))
    new_data = data if inplace else data.clone()
    new_data[:, off, :] = q.transpose(0, 1).reshape(l1, -1, hidden)
    new_data[:, sent, :] = 0
    new = {"data": new_data}
    if scale is not None:
        new_scale = store["scale"] if inplace else store["scale"].clone()
        new_scale[:, off, :] = scale.transpose(0, 1).reshape(l1, -1, 1)
        new_scale[:, sent, :] = 1.0
        new["scale"] = new_scale
    _count_push(store, off.numel() + sent.numel())
    return new


def shard_push_ef(store: dict, local_slots: torch.Tensor,
                  local_valid: torch.Tensor, reps: torch.Tensor,
                  residual: torch.Tensor, shard_rows: int, mesh,
                  axis: str = "data") -> tuple[dict, torch.Tensor]:
    """Error-feedback form of :func:`shard_push` (see :func:`push_ef`);
    the residual is the rank's own (k, …) block."""
    compensated = reps + residual
    new_store = shard_push(store, local_slots, local_valid, compensated,
                           shard_rows, mesh, axis)
    return new_store, _ef_residual(compensated,
                                   local_valid[:, None, :, None],
                                   precision_of(store))


def local_staleness_error(store: dict, fresh: torch.Tensor,
                          local_slots: torch.Tensor, served: torch.Tensor,
                          shard_rows: int, mesh,
                          axis: str = "data") -> torch.Tensor:
    """:func:`staleness_error` over this rank's k parts alone, read from
    its own shards: the (L-1,) max before the mesh-wide one."""
    k, s = local_slots.shape
    e = _combined_index(mesh, axis)
    off = (local_slots.long() - e * k * shard_rows).reshape(-1)
    l1 = store["data"].shape[0]
    stale = store["data"][:, off, :].float()
    if "scale" in store:
        stale = stale * store["scale"][:, off, :]
    stale = stale.reshape(l1, k, s, -1).transpose(0, 1)
    diff = torch.linalg.vector_norm(fresh - stale, dim=-1)
    diff = torch.where(served[:, None, :], diff,
                       torch.zeros((), dtype=diff.dtype, device=diff.device))
    return torch.amax(diff, dim=(0, 2))


def shard_staleness_error(store: dict, fresh: torch.Tensor,
                          local_slots: torch.Tensor, served: torch.Tensor,
                          shard_rows: int, mesh,
                          axis: str = "data") -> torch.Tensor:
    """:func:`staleness_error` with owner-local reads: each rank's
    :func:`local_staleness_error`, then one ``all_reduce(MAX)`` of the
    (L-1,) vector over the mesh.  Equal to the single-device value (max
    is order-free; the reads do no arithmetic)."""
    eps = local_staleness_error(store, fresh, local_slots, served,
                                shard_rows, mesh, axis)
    return collectives.all_reduce(eps, dist.ReduceOp.MAX)
