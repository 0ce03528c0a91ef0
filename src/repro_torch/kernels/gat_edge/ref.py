"""Pure-torch oracle for the fused GAT edge-softmax partial (mirrors the
reference's ``src/repro/kernels/gat_edge/ref.py``)."""
from __future__ import annotations

import torch

NEG_INF = -1e30
LEAKY_SLOPE = 0.2


def gat_edge_partial_ref(nbr: torch.Tensor, valid: torch.Tensor,
                         s_dst: torch.Tensor, s_src: torch.Tensor,
                         z: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense oracle.  Shapes as in
    :func:`repro_torch.kernels.gat_edge.gat_edge_partial_cuda`."""
    idx = nbr.long()
    sv = s_src.float()[idx]                                 # (rows, deg)
    e = s_dst.float()[:, None] + sv
    e = torch.where(e >= 0, e, LEAKY_SLOPE * e)
    e = torch.where(valid, e, NEG_INF)
    m = e.amax(dim=1)                                       # (rows,)
    p = torch.exp(e - m[:, None]) * valid                   # (rows, deg)
    l = p.sum(dim=1)
    rows = z.float()[idx]                                   # (rows, deg, f)
    acc = torch.einsum("rd,rdf->rf", p, rows)
    return acc, m, l


def merge_partials(parts: list) -> torch.Tensor:
    """Merge online-softmax partials ``(acc, m, l)`` from several edge
    sets (e.g. DIGEST's in-subgraph + stale out-of-subgraph) and
    normalise."""
    acc, m, l = parts[0]
    for acc2, m2, l2 in parts[1:]:
        m_new = torch.maximum(m, m2)
        c1 = torch.exp(m - m_new)
        c2 = torch.exp(m2 - m_new)
        acc = c1[:, None] * acc + c2[:, None] * acc2
        l = c1 * l + c2 * l2
        m = m_new
    return acc / torch.clamp_min(l, 1e-16)[:, None]
