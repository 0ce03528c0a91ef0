"""GNN models (GCN / GraphSAGE / GAT) in DIGEST's split-aggregation form.

Every layer implements Eq. 4/5 of the paper: the aggregation over
neighbours is split into an **in-subgraph** ELL product (fresh
representations) and an **out-of-subgraph** product against whatever halo
table the caller supplies.  A halo table is either a plain ``(H, d)``
tensor (aggregated through ``struct["out_nbr"]`` with a zero sentinel row
appended at H) or a **halo ref** dict ``{"data", "scale", "nbr", "wts"}``:
a shared slab in storage precision plus the ELL indices into it, read
through the fused pull+aggregate kernel
(:func:`repro_torch.kernels.spmm.halo_spmm`).

The functions take parameters as the reference's nested dict
(``params["layer_{l}"]["w"]``, ...); :class:`GNN` holds the same tensors as
an ``nn.Module`` whose state_dict keys are ``layer_{l}.w`` and so on.
Autograd runs through the layers as written: the in-subgraph products are
:func:`repro_torch.kernels.spmm.spmm`, whose backward kernels gather the
table gradient through the struct's transposed in-ELL (``in_pos``).

Shapes (single subgraph):
  x_local   (S, d)      padded local node features/reps
  in_nbr    (S, Din)    local slot ids, sentinel == S
  out_nbr   (S, Dout)   halo slot ids, sentinel == H
  ref[nbr]  (S, Dout)   slab row ids, sentinel == ref["data"].shape[0]-1
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.spmm import halo_spmm, spmm
from repro_torch.kernels.spmm.spmm import transpose_of
from repro_torch.nn import ParamSpec, dense, init_params

Pytree = Any


def halo_ref(data: torch.Tensor, scale: Optional[torch.Tensor],
             nbr: torch.Tensor, wts: torch.Tensor,
             wl_ids: Optional[torch.Tensor] = None,
             wl_cnt: Optional[torch.Tensor] = None,
             pdata: Optional[torch.Tensor] = None,
             pscale: Optional[torch.Tensor] = None,
             gamma: float = 1.0, pos: Optional[torch.Tensor] = None
             ) -> dict:
    """Bundle a shared halo slab (with sentinel zero row last) + indices.

    ``wl_ids``/``wl_cnt`` optionally carry the (row_block x chunk)
    worklist of this adjacency against the slab; ``pdata``/``pscale``/
    ``gamma`` the SAT predictor slab in the data slab's layout (the
    aggregation then reads ``dequant(data) + gamma * dequant(pdata)``);
    ``pos`` the transposed ELL of ``nbr`` for a GAT halo table that is
    differentiated (layer 0's projection of raw halo features, or every
    layer's under ``gat_halo_dedup=False``; built on demand when
    absent)."""
    ref = {"data": data, "nbr": nbr, "wts": wts}
    if pos is not None:
        ref["pos"] = pos
    if scale is not None:
        ref["scale"] = scale
    if wl_ids is not None and wl_cnt is not None:
        ref["wl_ids"] = wl_ids
        ref["wl_cnt"] = wl_cnt
    if pdata is not None:
        ref["pdata"] = pdata
        ref["gamma"] = float(gamma)
        if pscale is not None:
            ref["pscale"] = pscale
    return ref


def projected_halo_ref(zdata: torch.Tensor, zscale: Optional[torch.Tensor],
                       nbr: torch.Tensor, wts: torch.Tensor,
                       pos: Optional[torch.Tensor] = None) -> dict:
    """Bundle a *pre-projected* GAT halo table: rows are ``W·h̃`` (flat
    ``heads·head_dim`` wide, sentinel zero row last), so the layer skips
    its slab projection (``pos``: the transposed ELL of ``nbr``, which
    the attention scores' gradient gathers through)."""
    ref = {"zdata": zdata, "nbr": nbr, "wts": wts}
    if pos is not None:
        ref["pos"] = pos
    if zscale is not None:
        ref["zscale"] = zscale
    return ref


def _as_halo_ref(table, struct: dict) -> dict:
    """Normalise a plain (H, d) table to the halo-ref form, picking up the
    adjacency's chunk worklist when the struct dict carries one."""
    if isinstance(table, dict):
        return table
    return halo_ref(_pad_sentinel(table), None,
                    struct["out_nbr"], struct["out_wts"],
                    struct.get("wl_ids"), struct.get("wl_cnt"),
                    pos=struct.get("out_pos"))


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    model: str = "gcn"            # gcn | sage | gat
    num_layers: int = 3
    in_dim: int = 64
    hidden_dim: int = 128
    num_classes: int = 8
    heads: int = 4                # GAT only
    normalize: bool = True        # Algorithm 1 line 11 (L2 per node)
    residual: bool = False
    # Aggregation backend (see repro_torch.kernels.spmm.ops): "auto" runs
    # the kernels — CUDA on the card, their plain versions on the CPU.
    backend: str = "auto"
    # -- halo_spmm selection knobs (None keeps the kernel defaults) -------
    stream_chunk_rows: Optional[int] = None    # STREAM_CHUNK_ROWS
    resident_max_bytes: Optional[int] = None   # RESIDENT_STRIPE_MAX_BYTES
    skip_occupancy_max: Optional[float] = None  # SKIP_OCCUPANCY_MAX
    # Measured chunk-worklist occupancy; None disables the skip stream.
    halo_occupancy: Optional[float] = None
    # GAT: project each owner shard's stale halo rows once per layer at
    # pull time and ship projected rows (True, the dedup path) instead of
    # re-projecting every subgraph's (H+1, d) slab every epoch (False).
    gat_halo_dedup: bool = True

    @property
    def layer_dims(self) -> list[tuple[int, int]]:
        dims = []
        for ell in range(self.num_layers):
            din = self.in_dim if ell == 0 else self.hidden_dim
            dout = (self.num_classes if ell == self.num_layers - 1
                    else self.hidden_dim)
            dims.append((din, dout))
        return dims


def _pad_sentinel(x: torch.Tensor) -> torch.Tensor:
    """Append the zero sentinel row the ELL kernels gather for padding."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], dim=0)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def gnn_specs(cfg: GNNConfig) -> Pytree:
    specs: dict[str, Any] = {}
    for ell, (din, dout) in enumerate(cfg.layer_dims):
        layer: dict[str, Any] = {}
        if cfg.model == "gcn":
            layer["w"] = ParamSpec((din, dout), ("embed", "embed_out"))
            layer["b"] = ParamSpec((dout,), ("embed_out",), init="zeros")
        elif cfg.model == "sage":
            layer["w_self"] = ParamSpec((din, dout), ("embed", "embed_out"))
            layer["w_nbr"] = ParamSpec((din, dout), ("embed", "embed_out"))
            layer["b"] = ParamSpec((dout,), ("embed_out",), init="zeros")
        elif cfg.model == "gat":
            heads = cfg.heads if ell < cfg.num_layers - 1 else 1
            if dout % heads:
                raise ValueError(f"layer {ell}: dout {dout} % heads {heads}")
            dh = dout // heads
            layer["w"] = ParamSpec((din, heads, dh),
                                   ("embed", "heads", "head_dim"),
                                   fan_in_dims=(0,))
            layer["a_src"] = ParamSpec((heads, dh), ("heads", "head_dim"),
                                       init="normal")
            layer["a_dst"] = ParamSpec((heads, dh), ("heads", "head_dim"),
                                       init="normal")
            layer["b"] = ParamSpec((dout,), ("embed_out",), init="zeros")
        else:
            raise ValueError(cfg.model)
        specs[f"layer_{ell}"] = layer
    return specs


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _halo_agg(cfg, ref: dict, wts: torch.Tensor) -> torch.Tensor:
    """Out-of-subgraph fused pull+aggregate with the config's selection
    knobs threaded into repro_torch.kernels.spmm.ops.halo_spmm."""
    return halo_spmm(ref["nbr"], wts, ref["data"], ref.get("scale"),
                     wl_ids=ref.get("wl_ids"), wl_cnt=ref.get("wl_cnt"),
                     pdata=ref.get("pdata"), pscale=ref.get("pscale"),
                     gamma=ref.get("gamma", 1.0), backend=cfg.backend,
                     resident_max_bytes=cfg.resident_max_bytes,
                     chunk_rows=cfg.stream_chunk_rows,
                     occupancy=cfg.halo_occupancy,
                     skip_occupancy_max=cfg.skip_occupancy_max)


def _gcn_layer(cfg, p, x_local, x_halo, struct) -> torch.Tensor:
    ref = _as_halo_ref(x_halo, struct)
    agg = spmm(struct["in_nbr"], struct["in_wts"], _pad_sentinel(x_local),
               backend=cfg.backend, pos=struct.get("in_pos"))
    agg = agg + _halo_agg(cfg, ref, ref["wts"])
    return dense(agg, p["w"], p["b"])


def _sage_layer(cfg, p, x_local, x_halo, struct) -> torch.Tensor:
    # Mean aggregator: row-normalise the (GCN) weights to a mean.
    ref = _as_halo_ref(x_halo, struct)
    in_w, out_w = struct["in_wts"], ref["wts"]
    denom = (torch.sum(in_w, dim=1, keepdim=True)
             + torch.sum(out_w, dim=1, keepdim=True))
    denom = torch.clamp_min(denom, 1e-12)
    agg = spmm(struct["in_nbr"], in_w / denom, _pad_sentinel(x_local),
               backend=cfg.backend, pos=struct.get("in_pos"))
    agg = agg + _halo_agg(cfg, ref, out_w / denom)
    return dense(x_local, p["w_self"]) + dense(agg, p["w_nbr"]) + p["b"]


def _multihead_spmm(nbr, att, z_pad, backend, pos=None):
    """(S, D, heads) attention × (T, heads, dh) tables → (S, heads·dh):
    one K1 launch per head, each head's weights and table made
    contiguous (``pos``: the transposed ELL of ``nbr``, shared by the
    heads)."""
    out = torch.stack([spmm(nbr, att[:, :, h].contiguous(),
                            z_pad[:, h, :].contiguous(), backend=backend,
                            pos=pos)
                       for h in range(att.shape[2])], dim=1)
    return out.reshape(out.shape[0], -1)


class _RowGather(torch.autograd.Function):
    """``table[nbr]`` whose backward sums each table row's gradient over
    the ELL positions listed by the transposed ELL ``pos``, in ascending
    order, instead of autograd's scatter-add: that one serialises every
    duplicate of an index, and the padding of an ELL points all of its
    slots at the one sentinel row (a (5256, 56) in-ELL gives the
    sentinel some 190k of them).  The sentinel row gets no gradient, as
    in the SpMM backward; its gathered values are masked out of GAT's
    scores."""

    @staticmethod
    def forward(ctx, nbr, table, pos):
        ctx.save_for_backward(pos)
        ctx.table_shape = table.shape
        return table[nbr.long()]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        pos, = ctx.saved_tensors
        flat = g.reshape(-1, *g.shape[2:])
        flat = torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])])
        return None, flat[pos.long()].sum(dim=1), None


def _gather_rows(nbr, table, pos, backend):
    """``table[nbr]`` for GAT's attention scores; differentiated through
    the transposed ELL (built on the host when the struct has none) except
    on the oracle backend, which keeps autograd's own indexing."""
    if (backend == "jnp" or not torch.is_grad_enabled()
            or not table.requires_grad):
        return table[nbr.long()]
    if pos is None:
        pos = transpose_of(nbr, table.shape[0])
    return _RowGather.apply(nbr, table, pos)


def _gat_layer(cfg, p, x_local, x_halo, struct) -> torch.Tensor:
    S = x_local.shape[0]
    ref = _as_halo_ref(x_halo, struct)
    heads, dh = p["a_src"].shape
    z_loc = torch.einsum("sd,dhk->shk", x_local, p["w"])  # (S, heads, dh)
    if "zdata" in ref:
        # Pre-projected halo table (projected_halo_ref): rows are W·h̃.
        z_out = ref["zdata"].float()
        if "zscale" in ref:
            z_out = z_out * ref["zscale"]
        T = z_out.shape[0]                        # slab rows incl. sentinel
        z_out = z_out.reshape(T, heads, dh)
    else:
        x_out = ref["data"].float()
        if "scale" in ref:
            x_out = x_out * ref["scale"]
        if "pdata" in ref:
            # SAT prediction before projection — exact by linearity of W.
            p_out = ref["pdata"].float()
            if "pscale" in ref:
                p_out = p_out * ref["pscale"]
            x_out = x_out + torch.tensor(ref["gamma"],
                                         dtype=torch.float32) * p_out
        T = x_out.shape[0]                        # slab rows incl. sentinel
        z_out = torch.einsum("sd,dhk->shk", x_out, p["w"])

    s_dst = torch.einsum("shk,hk->sh", z_loc, p["a_dst"])    # (S, heads)
    src_loc = torch.einsum("shk,hk->sh", z_loc, p["a_src"])  # (S, heads)
    src_out = torch.einsum("shk,hk->sh", z_out, p["a_src"])  # (T, heads)

    def _scores(nbr, src_table, n_cols, pos):
        s_src = _gather_rows(nbr, src_table, pos, cfg.backend)  # (S,D,h)
        e = F.leaky_relu(s_dst[:, None, :] + s_src, 0.2)
        valid = (nbr < n_cols)[..., None]
        return torch.where(valid, e, -1e30), valid

    e_in, v_in = _scores(struct["in_nbr"], _pad_sentinel(src_loc), S,
                         struct.get("in_pos"))
    e_out, v_out = _scores(ref["nbr"], src_out, T - 1, ref.get("pos"))

    # The softmax shift is a constant of the gradient, as the reference's
    # stop_gradient makes it.
    m = torch.maximum(e_in.amax(dim=1), e_out.amax(dim=1)).detach()
    p_in = torch.exp(e_in - m[:, None, :]) * v_in
    p_out = torch.exp(e_out - m[:, None, :]) * v_out
    denom = p_in.sum(dim=1) + p_out.sum(dim=1) + 1e-16
    a_in = p_in / denom[:, None, :]                         # (S, Din, heads)
    a_out = p_out / denom[:, None, :]

    out = _multihead_spmm(struct["in_nbr"], a_in, _pad_sentinel(z_loc),
                          cfg.backend, struct.get("in_pos"))
    out = out + _multihead_spmm(ref["nbr"], a_out, z_out, cfg.backend,
                                ref.get("pos"))
    return out + p["b"]


_LAYERS = {"gcn": _gcn_layer, "sage": _sage_layer, "gat": _gat_layer}


def gnn_layer(cfg: GNNConfig, layer_params: Pytree,
              x_local: torch.Tensor, x_halo, struct: dict) -> torch.Tensor:
    """Run ONE split-aggregation layer (``layer_params`` is one
    ``params[f"layer_{ell}"]`` dict; x_halo a plain table or a halo ref)."""
    return _LAYERS[cfg.model](cfg, layer_params, x_local, x_halo, struct)


# ---------------------------------------------------------------------------
# Full forward (single subgraph)
# ---------------------------------------------------------------------------

def gnn_forward(cfg: GNNConfig, params: Pytree, x_local: torch.Tensor,
                halo_tables: list, struct: dict
                ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Run the L-layer GNN on one subgraph.

    Returns (logits (S, num_classes), reps) where reps[ℓ] is the
    layer-(ℓ+1) input representation this subgraph would *push* to the
    stale store (post-activation, post-normalisation, ℓ = 0..L-2).
    """
    layer_fn = _LAYERS[cfg.model]
    h = x_local
    push: list[torch.Tensor] = []
    for ell in range(cfg.num_layers):
        out = layer_fn(cfg, params[f"layer_{ell}"], h, halo_tables[ell],
                       struct)
        h = _finish_layer(cfg, out, h, ell, push)
    return h, push


def _finish_layer(cfg: GNNConfig, out: torch.Tensor, h: torch.Tensor,
                  ell: int, push: list) -> torch.Tensor:
    """Post-layer tail: relu + Algorithm-1 line-11 normalise (+ optional
    residual) on hidden layers, recording the layer's PUSH
    representation."""
    if ell < cfg.num_layers - 1:
        out = torch.relu(out)
        if cfg.normalize:   # Algorithm 1 line 11
            out = out / torch.clamp_min(
                torch.linalg.vector_norm(out, dim=-1, keepdim=True), 1e-12)
        if cfg.residual and out.shape == h.shape:
            out = out + h
        push.append(out)
    return out


class GNN(nn.Module):
    """A GNNConfig's parameters as an ``nn.Module``: one ``ParameterDict``
    per layer, so state_dict keys are the reference pytree's
    (``layer_{l}.w``, ``w_self``, ``w_nbr``, ``a_src``, ``a_dst``, ``b``).
    The parameters do not require grad: training differentiates the
    functional API over a plain tensor dict (``core/digest.py``)."""

    def __init__(self, cfg: GNNConfig, params: Pytree):
        super().__init__()
        self.cfg = cfg
        for name in sorted(params):
            self.add_module(name, nn.ParameterDict({
                k: nn.Parameter(v, requires_grad=False)
                for k, v in params[name].items()}))

    @classmethod
    def init(cls, cfg: GNNConfig, generator: torch.Generator,
             device="cuda") -> "GNN":
        return cls(cfg, init_params(gnn_specs(cfg), generator, device))

    def tree(self) -> Pytree:
        """The parameters as the nested dict the functional API takes."""
        return {name: dict(layer.items())
                for name, layer in self.named_children()}

    def forward(self, x_local, halo_tables, struct):
        return gnn_forward(self.cfg, self.tree(), x_local, halo_tables,
                           struct)
