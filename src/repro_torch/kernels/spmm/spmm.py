"""K1: the ELL SpMM, ``out[i] = sum_k wts[i, k] * table[nbr[i, k]]``, and
its two backward kernels.

The GNN neighbour-aggregation hotspot (the P_in·H / P_out·H̃ product of
DIGEST's Eq. 5).  :func:`spmm_cuda` launches the hand-written kernel
``csrc/spmm.cu`` on CUDA tensors and runs :func:`spmm_plain`, the same
arithmetic in plain PyTorch, on CPU tensors.  There is no fallback: a CUDA
tensor launches the kernel or raises.

When ``wts`` or ``table`` requires grad, the product runs inside
:class:`SpmmFunction`, whose backward launches ``csrc/spmm_bwd.cu``:
:func:`spmm_bwd_table` (the table gradient, gathered through the
host-built transposed ELL of :mod:`repro_torch.graph.transpose`) and
:func:`spmm_bwd_wts` (the weight gradient, GAT's attention), each only
when its input asks for it.  On CPU tensors the same Function runs with
the backwards' plain versions, so the CPU tests check the Function's own
arithmetic, not autograd of :func:`spmm_plain`.

Replaces the TPU kernel ``src/repro/kernels/spmm/spmm.py::spmm_pallas``;
the backwards replace JAX's autodiff of ``ref.py::spmm_ref``.  The TPU
tiling (128-row and 128-column padding) is gone: the CUDA kernels mask
their own ragged edges.  The source notes in ``csrc/spmm.cu`` and
``csrc/spmm_bwd.cu`` say what bounds each kernel on the card and what its
design does about it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.graph.transpose import ell_transpose
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
    if wts is None:          # a backward that reads no weights
        wts = torch.empty(nbr.shape, dtype=torch.float32, device=nbr.device)
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


def _device_of(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: unsupported device {t.device}")


def rows_read(nbr: torch.Tensor, table: torch.Tensor) -> int:
    """Bytes of the ``table`` rows an ELL ``nbr`` reads, for a dry count:
    a row per slot, at most every row of the table (the distinct rows
    referenced depend on the data)."""
    return (min(nbr.numel(), table.shape[0]) * table[0].numel()
            * table.element_size())


def _spmm_forward(nbr: torch.Tensor, wts: torch.Tensor,
                  table: torch.Tensor) -> torch.Tensor:
    """K1 on CUDA tensors, its plain version on CPU tensors, its dry
    count on meta tensors."""
    _device_of(table, "spmm_cuda")
    if table.device.type == "cpu":
        return spmm_plain(nbr, wts, table)
    rows, deg = nbr.shape
    n_tab, feat = table.shape
    out = torch.empty((rows, feat), dtype=torch.float32,
                      device=table.device)
    if out.numel() == 0:
        return out
    if table.is_meta:
        _build.dry_launch("spmm", 2 * nbr.numel() * feat,
                          _build.nbytes(nbr, wts, out)
                          + rows_read(nbr, table), "slots")
        return out
    fn = _build.kernel_fn("spmm", "spmm_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])
    code = _build.launch(fn, table, _build.ptr(nbr), _build.ptr(wts),
                         _build.ptr(table), _build.dtype_code(table.dtype),
                         _build.ptr(out), rows, deg, n_tab, feat)
    _build.check(code, "spmm", "spmm_launch")
    _build.LAUNCHES["spmm"] += 1
    return out


# ---------------------------------------------------------------------------
# Backward kernels
# ---------------------------------------------------------------------------

def spmm_bwd_table_plain(pos: torch.Tensor, wts: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """The table gradient's arithmetic in plain PyTorch: for every table
    row, an fp32 accumulator over its transposed-ELL positions in
    ascending order; padding positions (``rows * deg``) add an exact 0."""
    rows, deg = wts.shape
    w_ext = torch.cat([wts.reshape(-1).float(),
                       wts.new_zeros(1, dtype=torch.float32)])
    g_ext = torch.cat([g.float(), g.new_zeros((1, g.shape[1]),
                                              dtype=torch.float32)])
    p = pos.long()
    acc = torch.zeros((pos.shape[0], g.shape[1]), dtype=torch.float32,
                      device=g.device)
    for t in range(pos.shape[1]):
        col = p[:, t]
        acc = acc + (w_ext.index_select(0, col)[:, None]
                     * g_ext.index_select(0, torch.div(
                         col, deg, rounding_mode="floor")))
    return acc


def spmm_bwd_wts_plain(nbr: torch.Tensor, g: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """The weight gradient's arithmetic in plain PyTorch: per (row, slot),
    an fp32 accumulator over the features in ascending order.  Every slot
    is computed from its own gathered row, so the sentinel slots of a row
    all hold ``<g[i], table[-1]>``: the kernel computes that value once a
    row and writes it to each of them."""
    rows, deg = nbr.shape
    gathered = table.index_select(0, nbr.long().reshape(-1)).float()
    gathered = gathered.reshape(rows, deg, table.shape[1])
    acc = torch.zeros((rows, deg), dtype=torch.float32, device=g.device)
    for f in range(table.shape[1]):
        acc = acc + g[:, f, None].float() * gathered[:, :, f]
    return acc


def _check_grad_out(g: torch.Tensor, rows: int, feat: int,
                    device) -> None:
    if (g.dim() != 2 or g.shape[0] != rows
            or (feat >= 0 and g.shape[1] != feat)
            or g.dtype != torch.float32
            or g.device != device or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous ({rows}, {feat}) float32 "
                         f"tensor on {device}, got {tuple(g.shape)} "
                         f"{g.dtype} on {g.device}")


def spmm_bwd_table(pos: torch.Tensor, wts: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """``dtable[j] = sum_{(i,k): nbr[i,k]=j} wts[i,k] * g[i]`` through the
    transposed ELL ``pos`` (n_tab, t_deg) of :func:`ell_transpose`; the
    kernel ``csrc/spmm_bwd.cu`` on CUDA tensors, the plain version on CPU
    tensors, the dry count on meta tensors.  Returns (n_tab, feat)
    float32; the sentinel row is 0."""
    rows, deg = wts.shape
    n_tab, t_deg = pos.shape
    if pos.dtype != torch.int32 or wts.dtype != torch.float32:
        raise TypeError(f"pos must be int32 and wts float32, got "
                        f"{pos.dtype} / {wts.dtype}")
    if not (pos.is_contiguous() and wts.is_contiguous()):
        raise ValueError("pos and wts must be contiguous")
    if pos.device != wts.device:
        raise ValueError(f"pos/wts on different devices: {pos.device} / "
                         f"{wts.device}")
    _check_grad_out(g, rows, -1, wts.device)
    if rows * deg >= 2 ** 31 or n_tab * t_deg >= 2 ** 31:
        raise ValueError("ELL too large for the kernel's int positions")
    _device_of(g, "spmm_bwd_table")
    if g.device.type == "cpu":
        return spmm_bwd_table_plain(pos, wts, g)
    feat = g.shape[1]
    out = torch.empty((n_tab, feat), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    if g.is_meta:
        _build.dry_launch("spmm_bwd_table", 2 * wts.numel() * feat,
                          _build.nbytes(pos, wts, g, out), "slots")
        return out
    fn = _build.kernel_fn("spmm_bwd", "spmm_bwd_table_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])
    code = _build.launch(fn, g, _build.ptr(pos), _build.ptr(wts),
                         _build.ptr(g), _build.ptr(out), n_tab, t_deg, deg,
                         rows * deg, feat)
    _build.check(code, "spmm_bwd", "spmm_bwd_table_launch")
    _build.LAUNCHES["spmm_bwd_table"] += 1
    return out


def spmm_bwd_wts(nbr: torch.Tensor, g: torch.Tensor,
                 table: torch.Tensor) -> torch.Tensor:
    """``dwts[i, k] = <g[i], table[nbr[i, k]]>``; the kernel
    ``csrc/spmm_bwd.cu`` on CUDA tensors, the plain version on CPU
    tensors, the dry count on meta tensors.  Slots on the sentinel row
    (``n_tab - 1``) share one value a row, equal to each slot's own for
    any sentinel contents.  Returns (rows, deg) float32."""
    check_ell(nbr, None, table)
    rows, deg = nbr.shape
    feat = table.shape[1]
    _check_grad_out(g, rows, feat, table.device)
    _device_of(table, "spmm_bwd_wts")
    if table.device.type == "cpu":
        return spmm_bwd_wts_plain(nbr, g, table)
    out = torch.empty((rows, deg), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    if table.is_meta:
        _build.dry_launch("spmm_bwd_wts", 2 * nbr.numel() * feat,
                          _build.nbytes(nbr, g, out)
                          + rows_read(nbr, table), "slots")
        return out
    fn = _build.kernel_fn("spmm_bwd", "spmm_bwd_wts_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])
    code = _build.launch(fn, table, _build.ptr(nbr), _build.ptr(g),
                         _build.ptr(table), _build.dtype_code(table.dtype),
                         _build.ptr(out), rows, deg, table.shape[0], feat)
    _build.check(code, "spmm_bwd", "spmm_bwd_wts_launch")
    _build.LAUNCHES["spmm_bwd_wts"] += 1
    return out


def transpose_of(nbr: torch.Tensor, n_tab: int) -> torch.Tensor:
    """The transposed ELL of ``nbr`` built on the host now, for callers
    whose struct carries none (it costs a copy of ``nbr`` to the host)."""
    pos = ell_transpose(nbr.detach().cpu().numpy(), n_tab)
    return torch.from_numpy(np.ascontiguousarray(pos)).to(nbr.device)


class SpmmFunction(torch.autograd.Function):
    """K1 with its backward kernels: ``dtable`` by
    :func:`spmm_bwd_table`, ``dwts`` by :func:`spmm_bwd_wts`, each only
    when ``ctx.needs_input_grad`` asks.  ``pos`` is the transposed ELL of
    ``nbr`` over ``table``'s rows (built on demand when None)."""

    @staticmethod
    def forward(ctx, nbr, wts, table, pos):
        ctx.save_for_backward(nbr, wts, table, pos)
        return _spmm_forward(nbr, wts, table)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        nbr, wts, table, pos = ctx.saved_tensors
        g = g.float().contiguous()
        dwts = dtable = None
        if ctx.needs_input_grad[1]:
            dwts = spmm_bwd_wts(nbr, g, table)
        if ctx.needs_input_grad[2]:
            if pos is None:
                pos = transpose_of(nbr, table.shape[0])
            dtable = spmm_bwd_table(pos, wts, g).to(table.dtype)
        return None, dwts, dtable, None


def spmm_cuda(nbr: torch.Tensor, wts: torch.Tensor, table: torch.Tensor,
              pos: torch.Tensor = None) -> torch.Tensor:
    """ELL SpMM through the CUDA kernel (plain version on CPU tensors),
    differentiable in ``wts`` and ``table``.

    Args:
      nbr:   (rows, deg) int32 row ids into ``table``; padding slots point
             at the zero sentinel row (the last).  Every id must be
             < n_tab: the kernel does not check.
      wts:   (rows, deg) float32, 0 at padding slots.  The kernel skips
             every slot with weight 0 on the sentinel row, which changes
             the sum only by the sign of a zero while that row is finite.
      table: (n_tab, feat) float32, bfloat16 or int8, sentinel row
             included; as a constant of the layout the sentinel row gets
             no gradient.
      pos:   optional (n_tab, t_deg) int32 transposed ELL of ``nbr``
             (:func:`repro_torch.graph.transpose.ell_transpose`) for the
             table gradient; built on the host when needed and absent.
    Returns:
      (rows, feat) float32.
    """
    check_ell(nbr, wts, table)
    if pos is not None and (pos.shape[0] != table.shape[0]
                            or pos.device != table.device):
        raise ValueError(f"transposed ELL {tuple(pos.shape)} on "
                         f"{pos.device} does not cover the "
                         f"{table.shape[0]}-row table on {table.device}")
    if torch.is_grad_enabled() and (wts.requires_grad
                                    or table.requires_grad):
        return SpmmFunction.apply(nbr, wts, table, pos)
    return _spmm_forward(nbr, wts, table)
