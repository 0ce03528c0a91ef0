"""K2 and K3: fused halo pull + dequantise + aggregate over a store slab.

    out[i] = sum_k wts[i, k] * dequant(data[nbr[i, k]])

where ``data`` is a HaloExchange store layer in fp32, bf16, or int8 with
per-row fp32 scales, and ``nbr`` holds slot ids into it (sentinel: a zero
row).  With a SAT predictor slab (``pdata``/``pscale``, same layout) each
gathered row is ``dequant(data[s]) + gamma * dequant(pdata[s])``, fused
into the same loop.

* :func:`halo_spmm_cuda` (K2) replaces the TPU kernel
  ``src/repro/kernels/spmm/halo_pull.py::halo_spmm_pallas``.  Unscaled
  slabs without a predictor are exactly the ELL SpMM and go to K1, as on
  the TPU.
* :func:`halo_spmm_stream_cuda` (K3) replaces
  ``halo_pull.py::halo_spmm_stream_pallas``: the same sum, accumulated
  per ``chunk_rows``-row slab chunk and added chunk by chunk in ascending
  order.  With one chunk covering the slab it equals K2.

Both launch ``csrc/halo_pull.cu`` on CUDA tensors and run their plain
PyTorch versions (:func:`halo_spmm_plain`, :func:`halo_spmm_stream_plain`)
on CPU tensors; a CUDA tensor launches the kernel or raises.  The source
note in ``csrc/halo_pull.cu`` says what bounds them on the card and how
the masking of out-of-chunk edges differs from the TPU kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmm.spmm import check_ell, spmm_cuda

# Slab rows per chunk of the streamed kernel, as on the TPU: the chunk
# geometry decides the summation order, so both packages keep one value.
STREAM_CHUNK_ROWS = 512


def _plain_terms(acc, idx, w, data, scale, pdata, pscale, gamma):
    ws = w if scale is None else w * scale[:, 0].index_select(0, idx)
    acc = acc + ws[:, None] * data.index_select(0, idx).float()
    if pdata is not None:
        wp = w * torch.tensor(gamma, dtype=torch.float32)
        if pscale is not None:
            wp = wp * pscale[:, 0].index_select(0, idx)
        acc = acc + wp[:, None] * pdata.index_select(0, idx).float()
    return acc


def halo_spmm_plain(nbr, wts, data, scale=None, pdata=None, pscale=None,
                    gamma: float = 1.0) -> torch.Tensor:
    """K2's arithmetic in plain PyTorch: one fp32 accumulator over k in
    order, scale folded into the edge weight."""
    idx = nbr.long()   # int64 indices: torch's int32 gathers are slow
    acc = torch.zeros((nbr.shape[0], data.shape[1]), dtype=torch.float32,
                      device=data.device)
    for k in range(nbr.shape[1]):
        acc = _plain_terms(acc, idx[:, k], wts[:, k].float(), data, scale,
                           pdata, pscale, gamma)
    return acc


def halo_spmm_stream_plain(nbr, wts, data, scale=None, pdata=None,
                           pscale=None, gamma: float = 1.0,
                           chunk_rows: int = STREAM_CHUNK_ROWS
                           ) -> torch.Tensor:
    """K3's arithmetic in plain PyTorch: per chunk, an fp32 partial over k
    in order with out-of-chunk edges weighted 0, added to the output in
    ascending chunk order."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows {chunk_rows} < 1")
    out = torch.zeros((nbr.shape[0], data.shape[1]), dtype=torch.float32,
                      device=data.device)
    n_chunks = max(-(-data.shape[0] // chunk_rows), 1)
    for c in range(n_chunks):
        lo = c * chunk_rows
        hit = (nbr >= lo) & (nbr < lo + chunk_rows)
        out = out + halo_spmm_plain(nbr, wts * hit, data, scale, pdata,
                                    pscale, gamma)
    return out


def _check_slab(nbr, wts, data, scale, pdata, pscale) -> None:
    check_ell(nbr, wts, data)
    n_tab = data.shape[0]
    for name, s in (("scale", scale), ("pscale", pscale)):
        if s is None:
            continue
        if (s.shape != (n_tab, 1) or s.dtype != torch.float32
                or s.device != data.device or not s.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({n_tab}, 1) "
                             f"float32 tensor on {data.device}, got "
                             f"{tuple(s.shape)} {s.dtype} on {s.device}")
    if pdata is not None and (
            pdata.shape != data.shape or pdata.dtype != data.dtype
            or pdata.device != data.device or not pdata.is_contiguous()):
        raise ValueError("pdata must be contiguous with data's shape, "
                         "dtype and device")


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int]


def _launch(symbol, counter, nbr, wts, data, scale, pdata, pscale, gamma,
            extra=(), extra_types=()):
    if data.device.type != "cuda":
        raise ValueError(f"{symbol}: unsupported device {data.device}")
    rows, deg = nbr.shape
    n_tab, feat = data.shape
    out = torch.empty((rows, feat), dtype=torch.float32,
                      device=data.device)
    if out.numel() == 0:
        return out
    fn = _build.kernel_fn("halo_pull", symbol,
                          _ARGTYPES + list(extra_types) + [ctypes.c_void_p])
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(_build.ptr(nbr), _build.ptr(wts), _build.ptr(data),
                  _build.DTYPE_CODES[str(data.dtype).split(".")[-1]],
                  _build.ptr(scale), _build.ptr(pdata), _build.ptr(pscale),
                  float(gamma), _build.ptr(out), rows, deg, n_tab, feat,
                  *extra, ctypes.c_void_p(stream))
    _build.check(code, "halo_pull", symbol)
    _build.LAUNCHES[counter] += 1
    return out


def halo_spmm_cuda(nbr, wts, data, scale=None, pdata=None, pscale=None,
                   gamma: float = 1.0) -> torch.Tensor:
    """K2: fused pull + dequantise + aggregate over the whole slab.

    Args:
      nbr:   (rows, deg) int32 slot ids (< data.shape[0]; not checked).
      wts:   (rows, deg) float32, 0 at padding slots.
      data:  (n_tab, feat) slab incl. sentinel row (fp32, bf16 or int8).
      scale: optional (n_tab, 1) fp32 per-row dequant scales.
      pdata/pscale: optional predictor slab in the same layout; gathered
        rows become dequant(data) + gamma * dequant(pdata).
    Returns:
      (rows, feat) float32.
    """
    if scale is None and pdata is None:
        # Unscaled fp32/bf16 slabs are exactly the ELL SpMM: one kernel.
        return spmm_cuda(nbr, wts, data)
    _check_slab(nbr, wts, data, scale, pdata, pscale)
    if data.device.type == "cpu":
        return halo_spmm_plain(nbr, wts, data, scale, pdata, pscale, gamma)
    return _launch("halo_spmm_resident_launch", "halo_spmm", nbr, wts, data,
                   scale, pdata, pscale, gamma)


def halo_spmm_stream_cuda(nbr, wts, data, scale=None, pdata=None,
                          pscale=None, gamma: float = 1.0,
                          chunk_rows: int = STREAM_CHUNK_ROWS
                          ) -> torch.Tensor:
    """K3: K2's contract, summed chunk by chunk over ``chunk_rows``-row
    slab chunks (the last one ragged) in ascending order."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows {chunk_rows} < 1")
    _check_slab(nbr, wts, data, scale, pdata, pscale)
    if data.device.type == "cpu":
        return halo_spmm_stream_plain(nbr, wts, data, scale, pdata, pscale,
                                      gamma, chunk_rows)
    return _launch("halo_spmm_stream_launch", "halo_spmm_stream", nbr, wts,
                   data, scale, pdata, pscale, gamma, (int(chunk_rows),),
                   (ctypes.c_int,))
