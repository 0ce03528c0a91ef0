"""HaloExchange — the stale-representation store, owner-sharded and
precision-aware (the single-device subset the serving slice needs).

A store is a plain dict of tensors:

    {"data": (L-1, R, hidden) <storage dtype>}        fp32 / bf16
    {"data": int8 ..., "scale": (L-1, R, 1) float32}  int8

with ``R = M · shard_rows`` slot rows, shard m holding the rows owned by
part m and the last row of every shard a zero sentinel.  int8 uses
symmetric per-row quantisation, ``scale = max|row| / 127``,
``q = round(row / scale)``, formula for formula as the reference
(``src/repro/core/halo_exchange.py``), so int8 codes match it bit for bit
on equal input.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device

PRECISIONS = ("fp32", "bf16", "int8")

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


@dataclasses.dataclass(frozen=True)
class HaloPrecision:
    """Wire/storage precision of the halo slab (one knob for both)."""

    storage: str = "fp32"          # fp32 | bf16 | int8

    def __post_init__(self):
        if self.storage not in PRECISIONS:
            raise ValueError(f"storage {self.storage!r} not in {PRECISIONS}")

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.storage]

    @property
    def has_scale(self) -> bool:
        return self.storage == "int8"


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


def layer_table(store: dict, ell: int
                ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(data, scale) slab of hidden layer ``ell`` — feeds the fused
    kernel."""
    return store["data"][ell], (store["scale"][ell] if "scale" in store
                                else None)


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
