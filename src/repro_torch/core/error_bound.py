"""Theorem-1 instrumentation: the measured staleness gradient error against
its bound (the port of ``src/repro/core/error_bound.py``).

‖∇L − ∇L*‖₂ ≤ (τ/M) Σ_{ℓ=1}^{L-1} ε^(ℓ) r₁^{L-ℓ} r₂^{L-ℓ} Σ_m Δ(G_m)^{L-ℓ}

with the reference's constant estimates: r₁ = 1 (normalised
aggregation), r₂ = max_ℓ ‖W^(ℓ)‖₂ (ReLU is 1-Lipschitz) and τ = ‖W^(L)‖₂.
Quantised storage adds ε_quant^(ℓ): scale/2·√d for int8 (half a code a
value), ‖h‖₂·2⁻⁸ for bf16 (half an ulp of 8 significand bits), 0 for
fp32; ``bound_with_quant`` is the bound with ε + ε_quant.

Both gradients are the mean of the M subgraphs' gradients, each
differentiated by ``torch.autograd.grad`` through the same per-subgraph
loss as the training epoch, with the halo tables as dense fp32 tables.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import halo_exchange
from repro_torch.core.digest import (_f32, _leaves, _unflatten,
                                     full_graph_forward, make_subgraph_loss,
                                     mean_grads_of)
from repro_torch.models.gnn import GNNConfig

Pytree = Any


def _tree_norm(leaves: list) -> float:
    return float(torch.sqrt(sum(torch.sum(torch.square(leaf))
                                for leaf in leaves)))


def _grads(cfg: GNNConfig, params: Pytree, data: dict,
           halo_cache: torch.Tensor) -> Pytree:
    """Mean over the subgraphs of the loss gradient with the given halo
    tables (``halo_cache``: (M, L-1, H, hidden) fp32)."""
    loss_fn = make_subgraph_loss(cfg)
    x_global = data["x_global"]
    x_local = x_global[data["local_ids"].long()]
    x_halo0 = x_global[data["halo_ids"].long()]
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    p = _unflatten(params, leaves)
    grads = []
    for m in range(x_local.shape[0]):
        struct_m = {k: v[m] for k, v in data["struct"].items()}
        tables = [x_halo0[m]] + [halo_cache[m, i]
                                 for i in range(cfg.num_layers - 1)]
        loss, _ = loss_fn(p, x_local[m], tables, struct_m,
                          data["labels"][m], data["train_mask"][m])
        grads.append(torch.autograd.grad(loss, leaves, allow_unused=True))
    return _unflatten(params, mean_grads_of(grads, leaves))


def fresh_halo_cache(cfg: GNNConfig, params: Pytree, data: dict
                     ) -> torch.Tensor:
    """Exact halo tables at the current params (the ∇L* side):
    (M, L-1, H, hidden)."""
    with torch.no_grad():
        _, reps = full_graph_forward(cfg, params, data)
    fresh = torch.stack([torch.cat([r, r.new_zeros((1, r.shape[-1]))])
                         for r in reps])
    return fresh[:, data["halo_ids"].long(), :].transpose(0, 1)


def quantization_eps(store: dict, data: dict) -> np.ndarray:
    """Per-layer ε_quant^(ℓ) of the store's precision over the rows some
    subgraph pulls (padding slots hold init values that would inflate the
    max): int8 the largest served scale/2·√d, bf16 the largest served row
    norm · 2⁻⁸, fp32 zeros."""
    precision = halo_exchange.precision_of(store)
    l1 = store["data"].shape[0]
    hv = data["halo_valid"]                                   # (M, H)
    slots = data["halo_slots"].long()
    if precision.storage == "int8":
        d = store["data"].shape[-1]
        sc = store["scale"][:, slots, 0]                      # (L-1, M, H)
        sc = torch.where(hv[None], sc, sc.new_zeros(()))
        return (torch.amax(sc, dim=(1, 2)).cpu().numpy() / 2.0
                * np.sqrt(d))
    if precision.storage == "bf16":
        rows = store["data"][:, slots, :].float()
        norms = torch.linalg.vector_norm(rows, dim=-1)        # (L-1, M, H)
        norms = torch.where(hv[None], norms, norms.new_zeros(()))
        return torch.amax(norms, dim=(1, 2)).cpu().numpy() * 2.0 ** -8
    return np.zeros((l1,), np.float64)


def measure_error_and_bound(cfg: GNNConfig, params: Pytree, data: dict,
                            store: dict, pstore: dict = None,
                            gamma: float = 1.0) -> dict:
    """The DIGEST gradient (stale halo rows from ``store``) against the
    exact one (fresh rows), the Theorem-1 bound and its quantisation-
    corrected form.

    With a SAT ``pstore`` the stale side is the predicted rows
    ``dequant(store) + gamma·dequant(pstore)``, so ε and the gradient
    error are the staleness the predictor leaves; ``eps_raw`` and
    ``eps_raw_mean`` then give the ε of the same store without the
    prediction."""
    stale_cache = halo_exchange.pull(store, data["halo_slots"])
    hv = data["halo_valid"][:, None, :]                    # (M, 1, H)
    n_valid = torch.clamp_min(torch.sum(hv), 1)
    zero = stale_cache.new_zeros(())
    fresh_cache = fresh_halo_cache(cfg, params, data)
    eps_raw = eps_raw_mean = None
    if pstore is not None:
        diff_raw = torch.linalg.vector_norm(fresh_cache - stale_cache,
                                            dim=-1)
        eps_raw = torch.amax(diff_raw, dim=(0, 2)).cpu().numpy()
        eps_raw_mean = (torch.sum(torch.where(hv, diff_raw, zero),
                                  dim=(0, 2)) / n_valid).cpu().numpy()
        stale_cache = stale_cache + _f32(gamma) * halo_exchange.pull(
            pstore, data["halo_slots"])

    g_stale = _grads(cfg, params, data, stale_cache)
    g_fresh = _grads(cfg, params, data, fresh_cache)
    err = _tree_norm([a - b for a, b in zip(_leaves(g_stale),
                                            _leaves(g_fresh))])

    # ε^(ℓ): max over the halo rows of the representation difference; the
    # valid-row mean rides along (a max is a single row's draw).
    diff = torch.linalg.vector_norm(fresh_cache - stale_cache, dim=-1)
    eps = torch.amax(diff, dim=(0, 2)).cpu().numpy()          # (L-1,)
    eps_mean = (torch.sum(torch.where(hv, diff, zero), dim=(0, 2))
                / n_valid).cpu().numpy()
    eps_quant = quantization_eps(store, data)                 # (L-1,)

    # Lipschitz-constant estimates.
    L = cfg.num_layers
    w_norms = []
    for ell in range(L):
        p = params[f"layer_{ell}"]
        w = (p["w"] if "w" in p else p["w_nbr"]).detach().cpu().numpy()
        w_norms.append(float(np.linalg.norm(w.reshape(w.shape[0], -1), 2)))
    r1 = 1.0
    r2 = max(w_norms)
    tau = w_norms[-1]

    # Δ(G_m): the largest per-node degree (in + out) of each subgraph.
    struct = data["struct"]
    deg = (torch.sum(struct["in_wts"] > 0, dim=-1)
           + torch.sum(struct["out_wts"] > 0, dim=-1))        # (M, S)
    delta_m = torch.amax(deg, dim=-1).cpu().numpy().astype(np.float64)
    M = delta_m.shape[0]

    def _bound(eps_arr: np.ndarray) -> float:
        eps_arr = np.asarray(eps_arr, np.float64)
        total = 0.0
        for ell in range(1, L):       # ℓ = 1..L-1
            power = L - ell
            total += (eps_arr[ell - 1] * (r1 * r2) ** power
                      * np.sum(delta_m ** power))
        return float(total * tau / M)

    out = {"err_measured": float(err), "bound": _bound(eps),
           "bound_with_quant": _bound(eps + eps_quant),
           "eps": eps.tolist(), "eps_mean": eps_mean.tolist(),
           "eps_quant": eps_quant.tolist(),
           "storage": halo_exchange.precision_of(store).storage,
           "r2": r2, "tau": tau,
           "delta_max": float(delta_m.max()),
           "grad_norm_fresh": _tree_norm(_leaves(g_fresh))}
    if eps_raw is not None:
        out["eps_raw"] = eps_raw.tolist()
        out["eps_raw_mean"] = eps_raw_mean.tolist()
    return out
