"""K5: the fused GAT edge-softmax partial over one padded ELL adjacency.

For each row ``i``: ``e[i,k] = LeakyReLU_0.2(s_dst[i] + s_src[nbr[i,k]])``
(masked to -1e30 where ``valid`` is false) and the unnormalised
online-softmax partial ``(acc (rows, feat), m (rows,), l (rows,))`` over
``z``'s gathered rows, which :func:`.ref.merge_partials` merges across
DIGEST's in- and out-of-subgraph edge sets.  :func:`gat_edge_partial_cuda`
launches the hand-written kernel ``csrc/gat_edge.cu`` on CUDA tensors and
runs :func:`gat_edge_partial_plain`, the kernel's arithmetic in its two
phases (every slot's running max, alpha and p at once; then the ordered
l / acc chain) in plain PyTorch, on CPU tensors.  There is no fallback: a
CUDA tensor launches the kernel or raises.

Replaces the TPU kernel
``src/repro/kernels/gat_edge/gat_edge.py::gat_edge_partial_pallas``
(body ``_gat_kernel``).  The reference's 128-row and 128-feature
divisibility guard was a TPU tiling limit: the kernel masks its own
ragged edges.  As in the reference, a row whose leading slots are
invalid carries ``l = 1`` per such slot until its first valid edge resets
it (``alpha = exp(-1e30 - e) = 0``); a row with no valid edge ends with
``m = -1e30``, which the merge weighs by 0 beside any valid partial.  A
NaN score at a valid slot makes ``m`` (and ``l``) NaN from there on, as
``jnp.maximum`` does in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
LEAKY_SLOPE = 0.2


def _check(nbr, valid, s_dst, s_src, z) -> None:
    if nbr.dim() != 2 or valid.shape != nbr.shape:
        raise ValueError(f"nbr {tuple(nbr.shape)} and valid "
                         f"{tuple(valid.shape)} must be equal (rows, deg)")
    if z.dim() != 2 or s_src.shape != (z.shape[0],):
        raise ValueError(f"z {tuple(z.shape)} must be (n_tab, feat) and "
                         f"s_src {tuple(s_src.shape)} (n_tab,)")
    if s_dst.shape != (nbr.shape[0],):
        raise ValueError(f"s_dst {tuple(s_dst.shape)} must be (rows,)")
    if nbr.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"nbr must be int32 and valid bool, got "
                        f"{nbr.dtype} / {valid.dtype}")
    for name, t in (("s_dst", s_dst), ("s_src", s_src), ("z", z)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    tensors = (nbr, valid, s_dst, s_src, z)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("nbr/valid/s_dst/s_src/z on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if nbr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {nbr.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("nbr, valid, s_dst, s_src and z must be contiguous")
    for n in (*nbr.shape, *z.shape):
        if n >= 2 ** 31:
            raise ValueError(f"dimension {n} does not fit the kernel's int")


def gat_edge_partial_plain(nbr: torch.Tensor, valid: torch.Tensor,
                           s_dst: torch.Tensor, s_src: torch.Tensor,
                           z: torch.Tensor) -> tuple:
    """The kernel's arithmetic in plain PyTorch, in its two phases.

    Phase A, every slot at once: the masked scores ``e``, their running
    max ``m_k = max(-1e30, e_0 .. e_k)`` (``torch.cummax``, which carries
    NaN as ``torch.maximum`` does), ``alpha_k = exp(m_{k-1} - m_k)`` and
    ``p_k = exp(e_k - m_k)``.  Phase B, k = 0 .. deg-1 in order: ``l =
    alpha_k * l + p_k`` and ``acc = acc * alpha_k + p_k * z[nbr_k]``.  Max
    is exact, so the values are those of the TPU kernel's online loop
    (m, l and acc updated together each step), bit for bit."""
    rows, deg = nbr.shape
    idx = nbr.long()   # int64 indices: torch's int32 gathers are slow
    neg = torch.full((rows, 1), NEG_INF, device=z.device)
    l = torch.zeros((rows,), device=z.device)
    acc = torch.zeros((rows, z.shape[1]), device=z.device)
    if deg == 0:
        return acc, neg[:, 0], l
    e = s_dst[:, None] + s_src[idx]
    e = torch.where(e >= 0, e, LEAKY_SLOPE * e)
    e = torch.where(valid, e, NEG_INF)
    m = torch.maximum(torch.cummax(e, dim=1).values, neg)
    m_prev = torch.cat([neg, m[:, :-1]], dim=1)
    alpha = torch.exp(m_prev - m)
    p = torch.exp(e - m)
    for k in range(deg):
        l = alpha[:, k] * l + p[:, k]
        acc = (acc * alpha[:, k, None]
               + p[:, k, None] * z.index_select(0, idx[:, k]))
    return acc, m[:, -1].contiguous(), l


def gat_edge_partial_cuda(nbr: torch.Tensor, valid: torch.Tensor,
                          s_dst: torch.Tensor, s_src: torch.Tensor,
                          z: torch.Tensor) -> tuple:
    """Fused partial-softmax aggregation through the CUDA kernel (plain
    version on CPU tensors).

    Args:
      nbr:   (rows, deg) int32 ids into z / s_src (sentinel allowed).
             Every id must be < n_tab: the kernel does not check.
      valid: (rows, deg) bool edge mask.
      s_dst: (rows,) float32 destination scores.
      s_src: (n_tab,) float32 source-score table (incl. sentinel row).
      z:     (n_tab, feat) float32 value table (incl. sentinel row).
    Returns:
      (acc (rows, feat), m (rows,), l (rows,)), all float32.
    The kernel has no backward: scores or values that require grad under
    grad mode raise, on every device.
    """
    _check(nbr, valid, s_dst, s_src, z)
    _build.no_backward("gat_edge_partial_cuda (K5)", s_dst, s_src, z,
                       hint=("as the reference's Pallas kernel, it is a "
                             "forward only; differentiate through "
                             "gat_aggregate's jnp backend"))
    if z.device.type == "cpu":
        return gat_edge_partial_plain(nbr, valid, s_dst, s_src, z)
    rows, deg = nbr.shape
    feat = z.shape[1]
    acc = torch.empty((rows, feat), dtype=torch.float32, device=z.device)
    m = torch.empty((rows,), dtype=torch.float32, device=z.device)
    l = torch.empty((rows,), dtype=torch.float32, device=z.device)
    if rows == 0:
        return acc, m, l
    fn = _build.kernel_fn("gat_edge", "gat_edge_partial_launch", [
        *([ctypes.c_void_p] * 8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    code = _build.launch(fn, z, _build.ptr(nbr), _build.ptr(valid),
                         _build.ptr(s_dst), _build.ptr(s_src), _build.ptr(z),
                         _build.ptr(acc), _build.ptr(m), _build.ptr(l), rows,
                         deg, feat)
    _build.check(code, "gat_edge", "gat_edge_partial_launch")
    _build.LAUNCHES["gat_edge_partial"] += 1
    return acc, m, l
