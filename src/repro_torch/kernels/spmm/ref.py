"""Plain PyTorch oracles of the ELL SpMM, the fused halo pull and its
chunk-skipping form, in the vectorised gather form of the reference
package's jnp oracles.  They are differentiated by autograd (the gather's
backward), the oracle of the port's SpMM backward kernels."""
from __future__ import annotations

import torch


def spmm_ref(nbr: torch.Tensor, wts: torch.Tensor,
             table: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_k wts[i,k] * table[nbr[i,k]] — vectorised gather form."""
    gathered = table[nbr.long()].float()            # (rows, deg, feat)
    return torch.sum(wts.float()[..., None] * gathered, dim=1)


def halo_spmm_ref(nbr: torch.Tensor, wts: torch.Tensor, data: torch.Tensor,
                  scale: torch.Tensor = None, pdata: torch.Tensor = None,
                  pscale: torch.Tensor = None,
                  gamma: float = 1.0) -> torch.Tensor:
    """Fused pull+aggregate oracle: SpMM against a (possibly quantised)
    slab with per-row dequant scales folded into the weights.  With a
    predictor slab (``pdata``/``pscale``, same layout as ``data``/
    ``scale``) each gathered row is ``dequant(data[s]) + gamma *
    dequant(pdata[s])``."""
    nbr = nbr.long()
    w = wts.float()
    ws = w if scale is None else w * scale[:, 0][nbr]
    out = torch.sum(ws[..., None] * data[nbr].float(), dim=1)
    if pdata is not None:
        wp = w * torch.tensor(gamma, dtype=torch.float32)
        if pscale is not None:
            wp = wp * pscale[:, 0][nbr]
        out = out + torch.sum(wp[..., None] * pdata[nbr].float(), dim=1)
    return out


def halo_spmm_skip_ref(nbr: torch.Tensor, wts: torch.Tensor,
                       data: torch.Tensor, scale: torch.Tensor, wl_ids,
                       wl_cnt, chunk_rows: int, block_rows: int = 128,
                       pdata: torch.Tensor = None,
                       pscale: torch.Tensor = None,
                       gamma: float = 1.0) -> torch.Tensor:
    """Worklist-masked oracle of the chunk-skipping kernel: only the
    contributions whose slab row falls in a chunk on its row block's
    worklist.  Equals :func:`halo_spmm_ref` iff the worklist covers every
    referenced slot, and diverges on a truncated one."""
    ids = torch.as_tensor(wl_ids).long().cpu()
    cnt = torch.as_tensor(wl_cnt).long().cpu()
    n_blocks = ids.shape[0]
    n_chunks = max(-(-data.shape[0] // chunk_rows), 1)
    visited = torch.zeros((n_blocks, n_chunks), dtype=torch.bool)
    for i in range(n_blocks):
        visited[i, ids[i, :cnt[i]]] = True
    visited = visited.to(nbr.device)
    nbr = nbr.long()
    rows = nbr.shape[0]
    block_of = torch.clamp_max(
        torch.arange(rows, device=nbr.device) // block_rows, n_blocks - 1)
    in_visited = visited[block_of[:, None], nbr // chunk_rows]
    w = wts.float() * in_visited.float()
    ws = w if scale is None else w * scale[:, 0][nbr]
    out = torch.sum(ws[..., None] * data[nbr].float(), dim=1)
    if pdata is not None:
        wp = w * torch.tensor(gamma, dtype=torch.float32)
        if pscale is not None:
            wp = wp * pscale[:, 0][nbr]
        out = out + torch.sum(wp[..., None] * pdata[nbr].float(), dim=1)
    return out
