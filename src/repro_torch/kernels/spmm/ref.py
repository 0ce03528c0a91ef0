"""Plain PyTorch oracles of the ELL SpMM and the fused halo pull, in the
vectorised gather form of the reference package's jnp oracles."""
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
