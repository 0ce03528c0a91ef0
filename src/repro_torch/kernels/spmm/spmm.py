"""K1: the ELL SpMM, ``out[i] = sum_k wts[i, k] * table[nbr[i, k]]``.

The GNN neighbour-aggregation hotspot (the P_in·H / P_out·H̃ product of
DIGEST's Eq. 5).  :func:`spmm_cuda` launches the hand-written kernel
``csrc/spmm.cu`` on CUDA tensors and runs :func:`spmm_plain`, the same
arithmetic in plain PyTorch, on CPU tensors.  There is no fallback: a CUDA
tensor launches the kernel or raises.

Replaces the TPU kernel ``src/repro/kernels/spmm/spmm.py::spmm_pallas``.
The TPU tiling (128-row and 128-column padding) is gone: the CUDA kernel
masks its own ragged edges.  The source note in ``csrc/spmm.cu`` says what
bounds the kernel on the card and what its design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_TABLE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def spmm_plain(nbr: torch.Tensor, wts: torch.Tensor,
               table: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: an fp32 accumulator
    updated for k = 0 .. deg-1 in order (the TPU kernel's fori_loop)."""
    rows, deg = nbr.shape
    idx = nbr.long()   # int64 indices: torch's int32 gathers are slow
    acc = torch.zeros((rows, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for k in range(deg):
        acc = acc + (wts[:, k, None].float()
                     * table.index_select(0, idx[:, k]).float())
    return acc


def check_ell(nbr: torch.Tensor, wts: torch.Tensor,
              table: torch.Tensor, dtypes=_TABLE_DTYPES) -> None:
    """Device, dtype, shape and contiguity checks shared by the ELL kernel
    wrappers."""
    if nbr.dim() != 2 or wts.shape != nbr.shape:
        raise ValueError(f"nbr {tuple(nbr.shape)} and wts "
                         f"{tuple(wts.shape)} must be equal (rows, deg)")
    if table.dim() != 2:
        raise ValueError(f"table must be (n_tab, feat), got "
                         f"{tuple(table.shape)}")
    if nbr.dtype != torch.int32 or wts.dtype != torch.float32:
        raise TypeError(f"nbr must be int32 and wts float32, got "
                        f"{nbr.dtype} / {wts.dtype}")
    if table.dtype not in dtypes:
        raise TypeError(f"table dtype {table.dtype} not in {dtypes}")
    if not (nbr.device == wts.device == table.device):
        raise ValueError(f"nbr/wts/table on different devices: "
                         f"{nbr.device} / {wts.device} / {table.device}")
    if not (nbr.is_contiguous() and wts.is_contiguous()
            and table.is_contiguous()):
        raise ValueError("nbr, wts and table must be contiguous")
    for n in (*nbr.shape, *table.shape):
        if n >= 2 ** 31:
            raise ValueError(f"dimension {n} does not fit the kernel's int")


def spmm_cuda(nbr: torch.Tensor, wts: torch.Tensor,
              table: torch.Tensor) -> torch.Tensor:
    """ELL SpMM through the CUDA kernel (plain version on CPU tensors).

    Args:
      nbr:   (rows, deg) int32 row ids into ``table``; padding slots point
             at the zero sentinel row.  Every id must be < n_tab: the kernel
             does not check.
      wts:   (rows, deg) float32, 0 at padding slots.
      table: (n_tab, feat) float32, bfloat16 or int8, sentinel row included.
    Returns:
      (rows, feat) float32.
    """
    check_ell(nbr, wts, table)
    if table.device.type == "cpu":
        return spmm_plain(nbr, wts, table)
    if table.device.type != "cuda":
        raise ValueError(f"spmm_cuda: unsupported device {table.device}")
    rows, deg = nbr.shape
    feat = table.shape[1]
    out = torch.empty((rows, feat), dtype=torch.float32,
                      device=table.device)
    if out.numel() == 0:
        return out
    fn = _build.kernel_fn("spmm", "spmm_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(_build.ptr(nbr), _build.ptr(wts), _build.ptr(table),
                  _build.DTYPE_CODES[str(table.dtype).split(".")[-1]],
                  _build.ptr(out), rows, deg, feat,
                  ctypes.c_void_p(stream))
    _build.check(code, "spmm", "spmm_launch")
    _build.LAUNCHES["spmm"] += 1
    return out
