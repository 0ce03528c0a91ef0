"""HaloExchange — the stale-representation store, owner-sharded and
precision-aware (the single-device subset of the reference module: the
store, its pull and push, error feedback and the staleness probe; the
collective forms are later work).

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
:func:`push_ef` with the pusher's rounding residual carried forward.
Theorem 1's per-layer staleness is :func:`staleness_error`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device

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
