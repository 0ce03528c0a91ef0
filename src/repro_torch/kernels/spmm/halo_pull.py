"""K2, K3 and K4: fused halo pull + dequantise + aggregate over a store
slab.

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
  :func:`halo_spmm_stream_walk_cuda` runs K3 on the body it takes for
  rows too long for its edge list, at any degree.
* :func:`halo_spmm_skip_cuda` (K4) replaces
  ``halo_pull.py::halo_spmm_skip_pallas``: K3 taking, for each 128-row
  block of output rows, only the chunks on that block's worklist
  (``wl_ids``/``wl_cnt`` of ``ChunkWorklist``).  Equal to K3, bit for bit,
  at equal ``chunk_rows``.

All launch ``csrc/halo_pull.cu`` on CUDA tensors and run their plain
PyTorch versions (:func:`halo_spmm_plain`, :func:`halo_spmm_stream_plain`,
:func:`halo_spmm_skip_plain`) on CPU tensors; a CUDA tensor launches the
kernel or raises.  They have no backward: the slab is stale state and the
weights are constants on every path that reaches them (DIGEST detaches
its halo tables), so each raises on an input that requires grad rather
than return a result cut off from autograd.  The source note in
``csrc/halo_pull.cu`` says what bounds them on the card and how the
masking of out-of-chunk edges differs from the TPU kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmm.spmm import check_ell, spmm_cuda

# Slab rows per chunk of the streamed kernel, as on the TPU: the chunk
# geometry decides the summation order, so both packages keep one value.
STREAM_CHUNK_ROWS = 512
# Output rows per worklist row block of K4 (the reference's BLOCK_ROWS).
SKIP_BLOCK_ROWS = 128


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


def _visited(nbr, wl_ids, wl_cnt, n_chunks):
    """(n_blocks, n_chunks) bool: chunk c is on row block b's worklist."""
    n_blocks, max_chunks = wl_ids.shape
    t = torch.arange(max_chunks, device=wl_ids.device)
    live = t[None, :] < wl_cnt[:, None].long()
    vis = torch.zeros((n_blocks, n_chunks + 1), dtype=torch.bool,
                      device=wl_ids.device)
    # Padding steps write into a spare column that is then dropped.
    col = torch.where(live, wl_ids.long(), n_chunks)
    vis.scatter_(1, col, True)
    return vis[:, :n_chunks], torch.where(live, wl_ids,
                                          torch.full_like(wl_ids, -1))


def halo_spmm_skip_plain(nbr, wts, data, scale=None, wl_ids=None,
                         wl_cnt=None, pdata=None, pscale=None,
                         gamma: float = 1.0,
                         chunk_rows: int = STREAM_CHUNK_ROWS,
                         count_visits: bool = False):
    """K4's arithmetic in plain PyTorch: K3's chunk partials, in ascending
    chunk order, with each row taking only the chunks on its 128-row
    block's worklist."""
    n_chunks = _check_worklist(nbr, data, wl_ids, wl_cnt, chunk_rows)
    vis, visits = _visited(nbr, wl_ids, wl_cnt, n_chunks)
    rows = nbr.shape[0]
    block_of = torch.div(torch.arange(rows, device=nbr.device),
                         SKIP_BLOCK_ROWS, rounding_mode="floor")
    out = torch.zeros((rows, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    for c in range(n_chunks):
        lo = c * chunk_rows
        hit = ((nbr >= lo) & (nbr < lo + chunk_rows)
               & vis[block_of, c][:, None])
        out = out + halo_spmm_plain(nbr, wts * hit, data, scale, pdata,
                                    pscale, gamma)
    return (out, visits) if count_visits else out


def _check_worklist(nbr, data, wl_ids, wl_cnt, chunk_rows) -> int:
    """The reference's geometry guards (``halo_spmm_skip_pallas``) at the
    port's unpadded row count; returns the slab's chunk count."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows {chunk_rows} < 1")
    if wl_ids is None or wl_cnt is None:
        raise ValueError("halo_spmm_skip needs the (wl_ids, wl_cnt) "
                         "worklist; build it with "
                         "repro_torch.graph.partition.build_chunk_worklist")
    rows = nbr.shape[0]
    n_tab = data.shape[0]
    want_blocks = max(-(-rows // SKIP_BLOCK_ROWS), 1)
    n_chunks = max(-(-n_tab // chunk_rows), 1)
    if (wl_ids.dim() != 2 or wl_ids.shape[0] != want_blocks
            or tuple(wl_cnt.shape) != (want_blocks,)):
        raise ValueError(
            f"worklist geometry mismatch: wl_ids {tuple(wl_ids.shape)} / "
            f"wl_cnt {tuple(wl_cnt.shape)} vs {want_blocks} row blocks of "
            f"{SKIP_BLOCK_ROWS} rows — rebuild the worklist with "
            f"block_rows={SKIP_BLOCK_ROWS}")
    max_chunks = wl_ids.shape[1]
    if max_chunks > n_chunks:
        raise ValueError(
            f"worklist chunk-geometry mismatch: wl_ids lists up to "
            f"{max_chunks} chunks per block but a {n_tab}-row slab at "
            f"chunk_rows={chunk_rows} has only {n_chunks} — rebuild the "
            f"worklist with this chunk_rows")
    for name, t in (("wl_ids", wl_ids), ("wl_cnt", wl_cnt)):
        if (t.dtype != torch.int32 or t.device != data.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{data.device}, got {t.dtype} on {t.device}")
    return n_chunks


def _no_backward(what: str, *tensors) -> None:
    _build.no_backward(what, *tensors, hint=(
        "its slab, scales and weights must not require grad (detach them, "
        "as DIGEST detaches its halo tables)"))


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
    code = _build.launch(fn, data, _build.ptr(nbr), _build.ptr(wts),
                         _build.ptr(data), _build.dtype_code(data.dtype),
                         _build.ptr(scale), _build.ptr(pdata),
                         _build.ptr(pscale), float(gamma), _build.ptr(out),
                         rows, deg, n_tab, feat, *extra)
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
    _no_backward("halo_spmm_cuda (K2)", wts, data, scale, pdata, pscale)
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
    return _stream("halo_spmm_stream_launch", nbr, wts, data, scale, pdata,
                   pscale, gamma, chunk_rows)


def halo_spmm_stream_walk_cuda(nbr, wts, data, scale=None, pdata=None,
                               pscale=None, gamma: float = 1.0,
                               chunk_rows: int = STREAM_CHUNK_ROWS
                               ) -> torch.Tensor:
    """K3 on its chunk-walk body at any degree: the body K3 takes for rows
    too long for its shared-memory edge list, here forced so that it can
    be held against the plain version and timed at every shape.  K3's
    contract and launch count; equal to K3 bit for bit."""
    return _stream("halo_spmm_stream_walk_launch", nbr, wts, data, scale,
                   pdata, pscale, gamma, chunk_rows)


def _stream(symbol, nbr, wts, data, scale, pdata, pscale, gamma,
            chunk_rows):
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows {chunk_rows} < 1")
    _check_slab(nbr, wts, data, scale, pdata, pscale)
    _no_backward("halo_spmm_stream_cuda (K3)", wts, data, scale, pdata,
                 pscale)
    if data.device.type == "cpu":
        return halo_spmm_stream_plain(nbr, wts, data, scale, pdata, pscale,
                                      gamma, chunk_rows)
    return _launch(symbol, "halo_spmm_stream", nbr, wts, data, scale, pdata,
                   pscale, gamma, (int(chunk_rows),), (ctypes.c_int,))


def halo_spmm_skip_cuda(nbr, wts, data, scale=None, wl_ids=None,
                        wl_cnt=None, pdata=None, pscale=None,
                        gamma: float = 1.0,
                        chunk_rows: int = STREAM_CHUNK_ROWS,
                        count_visits: bool = False):
    """K4: K3's contract plus the chunk worklist of
    ``repro_torch.graph.partition.build_chunk_worklist`` (same
    ``chunk_rows``, 128-row blocks over the unpadded rows):

      wl_ids: (ceil(rows/128), max_chunks) int32 ascending chunk ids per
        row block (entries past ``wl_cnt`` are ignored).
      wl_cnt: (ceil(rows/128),) int32 valid prefix length per block.

    Raises the reference's geometry ``ValueError``s (missing worklist,
    block-count mismatch, ``max_chunks > n_chunks``).  With
    ``count_visits`` also returns the (n_blocks, max_chunks) int32 chunk
    visited at each worklist step, -1 past ``wl_cnt``."""
    _check_slab(nbr, wts, data, scale, pdata, pscale)
    _check_worklist(nbr, data, wl_ids, wl_cnt, chunk_rows)
    _no_backward("halo_spmm_skip_cuda (K4)", wts, data, scale, pdata,
                 pscale)
    if data.device.type == "cpu":
        return halo_spmm_skip_plain(nbr, wts, data, scale, wl_ids, wl_cnt,
                                    pdata, pscale, gamma, chunk_rows,
                                    count_visits)
    visits = None
    if count_visits:
        visits = torch.full(tuple(wl_ids.shape), -1, dtype=torch.int32,
                            device=data.device)
    out = _launch("halo_spmm_skip_launch", "halo_spmm_skip", nbr, wts, data,
                  scale, pdata, pscale, gamma,
                  (int(chunk_rows), _build.ptr(wl_ids), _build.ptr(wl_cnt),
                   int(wl_ids.shape[1]), _build.ptr(visits)),
                  (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p))
    return (out, visits) if count_visits else out
