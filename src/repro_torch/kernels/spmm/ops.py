"""Public entry points for neighbour aggregation.

``backend`` keeps the reference package's vocabulary:

  * ``"auto"`` — the kernels, through the selection ladder below.  Each
    kernel wrapper launches its CUDA kernel on CUDA tensors
    and runs its plain PyTorch version on CPU tensors.
  * ``"jnp"`` — the gather-form oracles of :mod:`.ref`.
  * ``"pallas_stream"`` — force the streamed kernel (K3).
  * ``"pallas_skip"`` — force the chunk-skipping streamed kernel (K4).

``halo_spmm`` picks between the kernels exactly as the reference does
(:func:`select_halo_kernel`), so the same shapes select the same kernel and
therefore the same summation order:

  * **resident** (K2, or K1 for an unscaled slab without a predictor) —
    the slab's 128-wide feature stripe fits ``resident_max_bytes``
    (default :data:`RESIDENT_STRIPE_MAX_BYTES`);
  * **stream** (K3) — above that budget;
  * **skip** (K4) — above the budget with a chunk worklist whose measured
    ``occupancy`` is at most ``skip_occupancy_max``.

The budget was set by the TPU's VMEM.  On the H100 every slab of this size
sits in L2 and both kernels gather from global memory; the ladder is kept
so that the port sums in the reference's order at every shape.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.spmm.halo_pull import (STREAM_CHUNK_ROWS,
                                                halo_spmm_cuda,
                                                halo_spmm_skip_cuda,
                                                halo_spmm_stream_cuda)
from repro_torch.kernels.spmm.ref import halo_spmm_ref, spmm_ref
from repro_torch.kernels.spmm.spmm import spmm_cuda

# Feature-stripe width of the reference's TPU tiling; it enters only the
# stripe formula of the selection ladder.
BLOCK_F = 128
# Largest slab stripe the resident kernel is selected for (the reference
# package's VMEM budget).
RESIDENT_STRIPE_MAX_BYTES = 4 * 1024 * 1024
# Highest (row_block x chunk) occupancy at which the chunk-skipping stream
# is selected over the dense stream.
SKIP_OCCUPANCY_MAX = 0.5

BACKENDS = ("auto", "jnp", "pallas_stream", "pallas_skip")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")


def spmm(nbr: torch.Tensor, wts: torch.Tensor, table: torch.Tensor,
         backend: str = "auto", pos: torch.Tensor = None) -> torch.Tensor:
    """Neighbour aggregation out[i] = sum_k wts[i,k] * table[nbr[i,k]],
    differentiable in ``wts`` and ``table``; ``pos`` is the optional
    transposed ELL of ``nbr`` the table gradient gathers through (see
    :func:`repro_torch.kernels.spmm.spmm.spmm_cuda`)."""
    _check_backend(backend)
    if backend == "jnp":
        return spmm_ref(nbr, wts, table)
    return spmm_cuda(nbr, wts, table, pos)


def halo_gather(nbr: torch.Tensor, data: torch.Tensor,
                scale: torch.Tensor = None) -> torch.Tensor:
    """Gather + dequantise individual slab rows: out[..., :] =
    dequant(data[nbr[...]]).  The non-reducing read of the serving path
    (GAT's attention scores, the hot-row cache's rows); a plain op, as in
    the reference, not a kernel."""
    nbr = nbr.long()
    rows = data[nbr].float()
    if scale is not None:
        rows = rows * scale[nbr]
    return rows


def select_halo_kernel(data: torch.Tensor, scale: torch.Tensor = None,
                       pdata: torch.Tensor = None,
                       pscale: torch.Tensor = None, *,
                       backend: str = "auto", has_worklist: bool = False,
                       resident_max_bytes: int = None,
                       occupancy: float = None,
                       skip_occupancy_max: float = None) -> str:
    """``"resident"``, ``"stream"`` or ``"skip"``: the reference ladder
    (``src/repro/kernels/spmm/ops.py::halo_spmm``) as a pure function of
    the slab shapes, dtypes and the static knobs."""
    _check_backend(backend)
    force_stream = backend == "pallas_stream"
    force_skip = backend == "pallas_skip"
    if force_skip and not has_worklist:
        raise ValueError(f"backend={backend!r} needs the (wl_ids, wl_cnt)"
                         " chunk worklist")
    stream = force_stream or force_skip
    if not stream:
        if resident_max_bytes is None:
            resident_max_bytes = RESIDENT_STRIPE_MAX_BYTES
        stripe = data.shape[0] * (min(BLOCK_F, data.shape[1])
                                  * data.element_size()
                                  + (4 if scale is not None else 0))
        if pdata is not None:
            stripe += data.shape[0] * (min(BLOCK_F, pdata.shape[1])
                                       * pdata.element_size()
                                       + (4 if pscale is not None else 0))
        stream = stripe > resident_max_bytes
    skip = force_skip
    if stream and not force_stream and not force_skip and has_worklist:
        if skip_occupancy_max is None:
            skip_occupancy_max = SKIP_OCCUPANCY_MAX
        skip = occupancy is not None and occupancy <= skip_occupancy_max
    if skip:
        return "skip"
    return "stream" if stream else "resident"


def halo_spmm(nbr: torch.Tensor, wts: torch.Tensor, data: torch.Tensor,
              scale: torch.Tensor = None, wl_ids: torch.Tensor = None,
              wl_cnt: torch.Tensor = None, pdata: torch.Tensor = None,
              pscale: torch.Tensor = None, gamma: float = 1.0,
              backend: str = "auto", resident_max_bytes: int = None,
              chunk_rows: int = None, occupancy: float = None,
              skip_occupancy_max: float = None) -> torch.Tensor:
    """Fused halo pull+aggregate against a store slab:
    out[i] = sum_k wts[i,k] * dequant(data[nbr[i,k]]), with the optional
    SAT predictor epilogue ``+ gamma * dequant(pdata[...])``.

    ``wl_ids``/``wl_cnt`` (the chunk worklist, read by K4) and
    ``occupancy`` feed the selection.  ``chunk_rows`` defaults to
    :data:`STREAM_CHUNK_ROWS`.
    """
    _check_backend(backend)
    if backend == "jnp":
        return halo_spmm_ref(nbr, wts, data, scale, pdata, pscale, gamma)
    kind = select_halo_kernel(
        data, scale, pdata, pscale, backend=backend,
        has_worklist=wl_ids is not None and wl_cnt is not None,
        resident_max_bytes=resident_max_bytes, occupancy=occupancy,
        skip_occupancy_max=skip_occupancy_max)
    if chunk_rows is None:
        chunk_rows = STREAM_CHUNK_ROWS
    if kind == "skip":
        return halo_spmm_skip_cuda(nbr, wts, data, scale, wl_ids, wl_cnt,
                                   pdata, pscale, gamma, chunk_rows)
    if kind == "stream":
        return halo_spmm_stream_cuda(nbr, wts, data, scale, pdata, pscale,
                                     gamma, chunk_rows)
    return halo_spmm_cuda(nbr, wts, data, scale, pdata, pscale, gamma)
