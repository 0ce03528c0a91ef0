"""DIGEST's Algorithm 1 on one device, in plain PyTorch.

The graph's nodes are cut into M subgraphs by ``assign``.  In epoch r
each subgraph computes its nodes' representations layer by layer: an
edge from a node of the same subgraph carries that node's fresh
representation, an edge from another subgraph carries the stale one
held in the pulled cache (layer 0: the raw features, which are exact).
The loss of a subgraph is the mean cross entropy over its training
nodes; the gradient of each subgraph's loss is taken with the cache as a
constant, and Adam steps on the mean of the M gradients.  Every N epochs
(r % N == 0, before the forward) the cache is pulled from the store;
after the forward of epochs r = 1, N + 1, 2N + 1, ... every node's
hidden representations are pushed into the store.

The two models of ``configs/digest_{gcn,gat}.py``:

* GCN: ``h' = (P_in h + P_out h~) W + b`` with ``P = D^-1/2 (A + I)
  D^-1/2`` split by the subgraph of the source node.
* GAT: per head, ``z = h W``; an edge (v <- u) scores
  ``leaky_relu(a_dst . z_v + a_src . z_u, 0.2)``, softmax over all of
  v's edges (shift by the detached max, ``+ 1e-16`` in the
  denominator), and ``h'_v`` is the weighted sum of the sources' z, the
  heads concatenated, plus b.  A stale source's z is its stale row
  projected by the layer's W when it was pulled (the owner-shard
  projection); at layer 0 a halo source's z is its raw feature row times
  the current W.

Hidden layers end in relu and a per-node L2 normalisation (Algorithm 1
line 11); their outputs are what a push stores.

``Variant`` puts the reference in the program's place for the control
and the planted faults: TF32 products (operands rounded to TF32's
10-bit mantissa, the arithmetic of a float32 product with TF32 on),
half of the subgraphs left out of the gradient mean, or the pull left
out.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class Variant:
    tf32: bool = False
    half_batch: bool = False
    no_pull: bool = False


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to the nearest TF32 value (10 explicit
    mantissa bits, ties to even)."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``a @ b`` with TF32 operands, forward and backward (as a float32
    product runs, and its gradient products, with TF32 on)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).T, round_tf32(a).T @ g


class _Ops:
    """The products of a variant: float32, or with TF32 operands."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def mm(self, a, b):
        return _TF32Product.apply(a, b) if self.tf32 else a @ b

    def dot(self, z, a):
        """(n, heads, dh) . (heads, dh) -> (n, heads); under TF32 the
        operands are rounded forward and the gradient passes straight."""
        if self.tf32:
            z = z + (round_tf32(z.detach()) - z.detach())
            a = a + (round_tf32(a.detach()) - a.detach())
        return (z * a).sum(-1)


def build_parts(adj: dict, assign: np.ndarray, num_parts: int,
                labels: np.ndarray, train: np.ndarray, device) -> list:
    """Each subgraph's nodes (ascending global ids), its in-subgraph edges
    (local destination, local source, weight), its cross edges (local
    destination, global source, weight, index into its halo list), its
    halo list, and its labels and training mask."""
    part_of = torch.from_numpy(np.asarray(assign, np.int64)).to(device)
    rows, cols, wts = adj["rows"], adj["cols"], adj["wts"]
    lab = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
    tr = torch.from_numpy(np.asarray(train, bool)).to(device)
    g2l = torch.full_like(part_of, -1)
    parts = []
    for m in range(num_parts):
        nodes = torch.nonzero(part_of == m).squeeze(1)
        g2l[nodes] = torch.arange(len(nodes), device=device)
        sel = part_of[rows] == m
        r, c, w = rows[sel], cols[sel], wts[sel]
        inside = part_of[c] == m
        halo, x_h = torch.unique(c[~inside], return_inverse=True)
        parts.append({
            "nodes": nodes, "in_dst": g2l[r[inside]],
            "in_src": g2l[c[inside]], "in_w": w[inside],
            "x_dst": g2l[r[~inside]], "x_src": c[~inside],
            "x_w": w[~inside], "halo": halo, "x_h": x_h,
            "labels": lab[nodes], "train": tr[nodes].float()})
    return parts


def _agg(n: int, dst: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
    return msgs.new_zeros((n,) + tuple(msgs.shape[1:])).index_add(
        0, dst, msgs)


def _gcn_layer(ops, p, h, table, part):
    """``table``: the (N, d) rows the cross edges read (raw features at
    layer 0, the pulled cache above)."""
    n = h.shape[0]
    agg = (_agg(n, part["in_dst"], part["in_w"][:, None] * h[part["in_src"]])
           + _agg(n, part["x_dst"],
                  part["x_w"][:, None] * table[part["x_src"]]))
    return ops.mm(agg, p["w"]) + p["b"]


def _gat_layer(ops, p, h, zh, part):
    """``zh``: the (|halo|, heads, dh) projected rows of the subgraph's
    halo (a function of the current W at layer 0, constants above)."""
    n = h.shape[0]
    din, heads, dh = p["w"].shape
    z = ops.mm(h, p["w"].reshape(din, heads * dh)).reshape(n, heads, dh)
    s_dst = ops.dot(z, p["a_dst"])
    s_loc = ops.dot(z, p["a_src"])
    s_h = ops.dot(zh, p["a_src"])
    i_d, i_s, x_d, x_h = (part["in_dst"], part["in_src"], part["x_dst"],
                          part["x_h"])
    e_in = F.leaky_relu(s_dst[i_d] + s_loc[i_s], 0.2)
    e_x = F.leaky_relu(s_dst[x_d] + s_h[x_h], 0.2)
    with torch.no_grad():
        mx = torch.full((n, heads), -torch.inf, device=h.device)
        mx.scatter_reduce_(0, i_d[:, None].expand(-1, heads), e_in, "amax")
        mx.scatter_reduce_(0, x_d[:, None].expand(-1, heads), e_x, "amax")
    p_in = torch.exp(e_in - mx[i_d])
    p_x = torch.exp(e_x - mx[x_d])
    den = _agg(n, i_d, p_in) + _agg(n, x_d, p_x) + 1e-16
    out = (_agg(n, i_d, (p_in / den[i_d])[..., None] * z[i_s])
           + _agg(n, x_d, (p_x / den[x_d])[..., None] * zh[x_h]))
    return out.reshape(n, heads * dh) + p["b"]


def _finish(out: torch.Tensor) -> torch.Tensor:
    out = torch.relu(out)
    return out / torch.clamp_min(
        torch.linalg.vector_norm(out, dim=-1, keepdim=True), 1e-12)


def subgraph_loss(model: str, ops, params: dict, x: torch.Tensor,
                  cache: list, part: dict) -> tuple:
    """(loss, [hidden representations of the subgraph's nodes])."""
    num_layers = len(params)
    h = x[part["nodes"]]
    reps = []
    for ell in range(num_layers):
        p = params[f"layer_{ell}"]
        if model == "gcn":
            out = _gcn_layer(ops, p, h, x if ell == 0 else cache[ell - 1],
                             part)
        else:
            din, heads, dh = p["w"].shape
            if ell == 0:
                zh = ops.mm(x[part["halo"]], p["w"].reshape(din, -1))
            else:
                zh = cache[ell - 1][part["halo"]]
            out = _gat_layer(ops, p, h, zh.reshape(-1, heads, dh), part)
        if ell < num_layers - 1:
            out = _finish(out)
            reps.append(out.detach())
        h = out
    nll = torch.logsumexp(h, -1) - h.gather(
        1, part["labels"][:, None])[:, 0]
    mask = part["train"]
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0), reps


def _pull(model: str, ops, params: dict, store: list) -> list:
    if model == "gcn":
        return [s.clone() for s in store]
    with torch.no_grad():
        return [ops.mm(s, params[f"layer_{ell + 1}"]["w"].reshape(
            s.shape[1], -1)) for ell, s in enumerate(store)]


def train(model: str, parts: list, x: torch.Tensor, params0: dict,
          hidden: int, lr: float, sync_interval: int, steps: int,
          variant: Variant = Variant()) -> dict:
    """Algorithm 1 for ``steps`` epochs from ``params0`` (a nested dict
    ``layer_{l}`` -> leaves).  Returns ``{"losses": [float] (each epoch's
    mean subgraph loss), "grad1": {leaf: tensor} (the first epoch's mean
    gradient), "params": {leaf: tensor} (after the last epoch)}``, leaves
    named ``layer_{l}.{name}``."""
    ops = _Ops(variant.tf32)
    names = [f"{lay}.{k}" for lay in sorted(params0)
             for k in sorted(params0[lay])]
    params = {lay: {k: v.detach().clone() for k, v in leaves.items()}
              for lay, leaves in params0.items()}
    flat = lambda tree: [tree[n.split(".")[0]][n.split(".")[1]]  # noqa
                         for n in names]
    mom = [torch.zeros_like(p) for p in flat(params)]
    vel = [torch.zeros_like(p) for p in flat(params)]
    n_nodes = x.shape[0]
    num_hidden = len(params0) - 1
    store = [x.new_zeros((n_nodes, hidden)) for _ in range(num_hidden)]
    cache = _pull(model, ops, params, store)
    used = parts[:len(parts) // 2] if variant.half_batch else parts
    losses, grad1 = [], None
    for r in range(1, steps + 1):
        if r % sync_interval == 0 and not variant.no_pull:
            cache = _pull(model, ops, params, store)
        leaves = [p.detach().requires_grad_() for p in flat(params)]
        tree = {}
        for n, leaf in zip(names, leaves):
            lay, k = n.split(".")
            tree.setdefault(lay, {})[k] = leaf
        total = [torch.zeros_like(p) for p in leaves]
        loss_sum = 0.0
        new_reps = [s.clone() for s in store]
        for part in parts:
            loss, reps = subgraph_loss(model, ops, tree, x, cache, part)
            if any(part is u for u in used):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                total = [t if g is None else t + g
                         for t, g in zip(total, grads)]
            loss_sum += float(loss.detach())
            for ell, rep in enumerate(reps):
                new_reps[ell][part["nodes"]] = rep
        mean = [t / len(used) for t in total]
        if r == 1:
            grad1 = dict(zip(names, mean))
        bc1, bc2 = 1.0 - ADAM_B1 ** r, 1.0 - ADAM_B2 ** r
        new = []
        for i, (p, g) in enumerate(zip(flat(params), mean)):
            mom[i] = ADAM_B1 * mom[i] + (1 - ADAM_B1) * g
            vel[i] = ADAM_B2 * vel[i] + (1 - ADAM_B2) * g * g
            new.append(p - lr * (mom[i] / bc1)
                       / (torch.sqrt(vel[i] / bc2) + ADAM_EPS))
        for n, p in zip(names, new):
            lay, k = n.split(".")
            params[lay][k] = p
        if (r - 1) % sync_interval == 0:
            store = new_reps
        losses.append(loss_sum / len(parts))
    return {"losses": losses, "grad1": grad1,
            "params": dict(zip(names, flat(params)))}
