"""Train/serve steps for the LM architectures, with DIGEST-style periodic
parameter synchronization across pods (the port of
``src/repro/train/trainer.py``).

DIGEST generalized: within a pod, gradients all-reduce every step; across
pods, parameters are synchronized only every N steps over the slow
inter-pod link (the paper's periodic stale sync).  ``sync_mode``:

  "every_step" — baseline data parallelism (no divergence);
  "digest"     — periodic parameter sync (the paper's method), in one of
                 two forms (``pod_impl``):

* ``"vmap"``: every pod's parameters in one tree with a leading
  ``(n_pod, ...)`` dim.  One device loops over the pods, each stepping
  its own copies (local SGD) on its slice of the batch, as the GNN port
  loops its M subgraphs; the reference ``vmap``s one pod's step.  At
  ``(step + 1) % N == 0`` the copies become their float32 mean.
* ``"shard_map"``: one rank a pod over the ``"pod"`` dimension of a
  :func:`repro_torch.launch.mesh.make_mesh` ``DeviceMesh``, passed to
  :func:`make_train_step` (the port has no ``axis_rules`` context); the
  parameters carry no pod dim.  Each step averages the loss and its
  parts over the pods; a sync step gathers every pod's copies and takes
  the same mean.  Every collective goes through
  :mod:`repro_torch.core.collectives`, so the census counts it.  A
  ``"data"`` dimension above 1 raises: inside a pod the reference relies
  on GSPMD's layout, which the port would replace by gradient
  all-reduces of its own (ROADMAP.md §1 item 8g).

The pod mean is a float32 sum in pod order divided by the pod count, in
both forms, so they agree bit for bit.  The state is ``{"params",
"opt_state", "step"}``, the reference's tree; ``step`` is a 0-d int32
host tensor (the checkpoint's layout; reading it never waits for the
card).  Gradients come from ``torch.autograd.grad`` of one pod's loss.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core import collectives
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (ArchConfig, arch_specs,
                                            aux_moe_loss, decode_step,
                                            forward)
from repro_torch.nn import ParamSpec, init_params, softmax_cross_entropy
from repro_torch.optim import (Optimizer, clip_by_global_norm,
                               make_optimizer, tree_leaves, tree_map,
                               warmup_cosine_schedule)

Pytree = Any
METRIC_PARTS = ("loss", "ce", "aux")


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    sync_mode: str = "every_step"        # every_step | digest
    sync_interval: int = 10              # N (pod-sync period, digest mode)
    n_pod: int = 1
    # "vmap": per-pod parameter copies with an explicit leading dim, one
    #   device looping over the pods.
    # "shard_map": one rank a pod over a DeviceMesh's "pod" dimension.
    pod_impl: str = "vmap"
    grad_clip: float = 1.0
    aux_loss_weight: float = 0.01
    total_steps: int = 10_000
    warmup_steps: int = 200


def make_arch_optimizer(cfg: ArchConfig, settings: TrainSettings
                        ) -> Optimizer:
    sched = warmup_cosine_schedule(cfg.learning_rate,
                                   settings.warmup_steps,
                                   settings.total_steps)
    if cfg.optimizer == "adafactor":
        return make_optimizer("adafactor", sched)
    if cfg.optimizer == "adamw":
        return make_optimizer("adamw", sched, weight_decay=0.01)
    return make_optimizer(cfg.optimizer, sched)


def _stacked_pods(settings: TrainSettings) -> bool:
    return (settings.sync_mode == "digest" and settings.n_pod > 1
            and settings.pod_impl == "vmap")


def _stack(tree: Pytree, n: int) -> Pytree:
    """Each leaf repeated ``n`` times along a new leading dim (copies)."""
    return tree_map(lambda p: p[None].expand((n,) + p.shape).contiguous(),
                    tree)


def _state(cfg: ArchConfig, settings: TrainSettings, params: Pytree) -> dict:
    opt = make_arch_optimizer(cfg, settings)
    opt_state = opt.init(params)
    if _stacked_pods(settings):
        params = _stack(params, settings.n_pod)
        opt_state = _stack(opt_state, settings.n_pod)
    return {"params": params, "opt_state": opt_state,
            "step": torch.zeros((), dtype=torch.int32)}


def init_train_state(cfg: ArchConfig, settings: TrainSettings,
                     seed: int = 0, device="cuda") -> dict:
    """Parameters from ``torch.Generator().manual_seed(seed)`` (drawn on
    the host: the same values on every device), the optimizer's state
    and ``step`` 0; in the stacked-pod form every leaf carries a leading
    ``n_pod`` dim of equal copies."""
    params = init_params(arch_specs(cfg), torch.Generator().manual_seed(seed),
                         resolve_device(device))
    return _state(cfg, settings, params)


def _meta_params(specs: Pytree) -> Pytree:
    """``init_params``' tree on the meta device: shapes and dtypes only."""
    if isinstance(specs, ParamSpec):
        return torch.empty(specs.shape, dtype=specs.dtype, device="meta")
    if isinstance(specs, (list, tuple)):
        return [_meta_params(s) for s in specs]
    return {k: _meta_params(specs[k]) for k in sorted(specs)}


def abstract_train_state(cfg: ArchConfig, settings: TrainSettings) -> dict:
    """:func:`init_train_state`'s tree on the ``meta`` device (no
    allocation); ``step`` stays a host tensor."""
    return _state(cfg, settings, _meta_params(arch_specs(cfg)))


def _loss_fn(cfg: ArchConfig, settings: TrainSettings, params: Pytree,
             batch: dict) -> tuple[torch.Tensor, dict]:
    logits = forward(cfg, params, batch["tokens"], batch.get("vision"))
    ce = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
    del logits
    loss = ce
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    if cfg.num_experts:
        aux = aux_moe_loss(cfg, params, batch["tokens"])
        loss = loss + settings.aux_loss_weight * aux
    return loss, {"ce": ce, "aux": aux}


def loss_and_grads(cfg: ArchConfig, settings: TrainSettings,
                   params: Pytree, batch: dict) -> tuple:
    """``(loss, parts, grads)`` of one pod's batch; ``grads`` has the
    tree of ``params`` and each leaf's dtype."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = _rebuild(params, it)
    with torch.enable_grad():
        loss, parts = _loss_fn(cfg, settings, live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            _rebuild(params, iter(grads)))


def _rebuild(tree: Pytree, leaves) -> Pytree:
    """``tree``'s structure over ``leaves`` (taken in pytree order)."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def _pod_mean(copies) -> torch.Tensor:
    """Float32 mean of equal-shape tensors: summed in pod order, then
    divided by their count."""
    acc = copies[0].float()
    for c in copies[1:]:
        acc = acc + c.float()
    return acc / len(copies)


def _pod_divergence(params: Pytree) -> torch.Tensor:
    """Mean L2 distance of pod copies from their mean (diagnostic).  The
    mean is taken in float64, so equal copies give exactly 0 at any pod
    count."""
    total = 0
    for p in tree_leaves(params):
        mu = p.double().mean(dim=0, keepdim=True).float()
        total = total + torch.sum(torch.square(p.float() - mu))
    return torch.sqrt(total)


def make_train_step(cfg: ArchConfig, settings: TrainSettings,
                    mesh: Optional[Any] = None
                    ) -> Callable[[dict, dict], tuple[dict, dict]]:
    """``train_step(state, batch) -> (state, metrics)`` in the form
    ``settings`` names (module docstring); ``mesh`` is the
    ``DeviceMesh`` of ``pod_impl="shard_map"``.  Metrics are 0-d tensors
    on the batch's device: ``loss``, ``ce``, ``aux`` (the pods' means)
    and, in the stacked form, ``pod_divergence``."""
    opt = make_arch_optimizer(cfg, settings)

    def one_pod_step(params, opt_state, batch, step):
        loss, parts, grads = loss_and_grads(cfg, settings, params, batch)
        if settings.grad_clip:
            grads = clip_by_global_norm(grads, settings.grad_clip)
        with torch.no_grad():
            new_params, new_opt = opt.update(grads, opt_state, params, step)
        return new_params, new_opt, loss, parts

    if settings.sync_mode != "digest" or settings.n_pod <= 1:
        def train_step(state, batch):
            step = int(state["step"])
            params, opt_state, loss, parts = one_pod_step(
                state["params"], state["opt_state"], batch, step)
            return {"params": params, "opt_state": opt_state,
                    "step": state["step"] + 1}, {"loss": loss, **parts}
        return train_step

    if settings.pod_impl == "shard_map":
        return _make_pod_mesh_step(settings, mesh, one_pod_step)

    n_pod = settings.n_pod

    def train_step(state, batch):
        step = int(state["step"])
        new_params = tree_map(torch.empty_like, state["params"])
        new_opt = tree_map(torch.empty_like, state["opt_state"])
        metrics = []
        for i in range(n_pod):
            # Pod i's parameters (own allocations, as a rank of the mesh
            # form holds them: a product's kernel may follow alignment),
            # its optimizer state and its slice of the batch.
            _, new_o, loss, parts = out = one_pod_step(
                tree_map(lambda x: x[i].clone(), state["params"]),
                tree_map(lambda x: x[i], state["opt_state"]),
                {k: _pod_slice(v, i, n_pod) for k, v in batch.items()},
                step)
            tree_map(lambda dst, src: dst[i].copy_(src), new_params, out[0])
            tree_map(lambda dst, src: dst[i].copy_(src), new_opt, new_o)
            metrics.append(torch.stack([loss, parts["ce"], parts["aux"]]))
            del out, new_o
        # Periodic cross-pod parameter synchronization (DIGEST).
        if (step + 1) % settings.sync_interval == 0:
            tree_map(lambda p: p.copy_(_pod_mean(list(p)).to(p.dtype)
                                       .expand_as(p)), new_params)
        mean = _pod_mean(metrics)
        out = dict(zip(METRIC_PARTS, mean.unbind()))
        out["pod_divergence"] = _pod_divergence(new_params)
        return {"params": new_params, "opt_state": new_opt,
                "step": state["step"] + 1}, out

    return train_step


def _pod_slice(x: torch.Tensor, pod: int, n_pod: int) -> torch.Tensor:
    """Pod ``pod``'s rows of a global batch tensor (``(B, ...)`` split
    into ``n_pod`` equal blocks, as the reference's reshape)."""
    rows = x.shape[0] // n_pod
    return x[pod * rows:(pod + 1) * rows]


def _make_pod_mesh_step(settings: TrainSettings, mesh,
                        one_pod_step) -> Callable:
    """Form (c): this rank is one pod of ``mesh``'s "pod" dimension."""
    if mesh is None or "pod" not in (mesh.mesh_dim_names or ()):
        raise ValueError("pod_impl='shard_map' needs a mesh with a "
                         "'pod' axis active via axis_rules(...)")
    names = mesh.mesh_dim_names
    if "data" in names and mesh.size(names.index("data")) > 1:
        raise NotImplementedError(
            "pod_impl='shard_map' with a 'data' dimension above 1 (data "
            "parallelism inside a pod: gradient all-reduces over 'data') "
            "is not ported yet: ROADMAP.md §1 item 8g")
    n_pod = mesh.size(names.index("pod"))
    if n_pod != settings.n_pod:
        raise ValueError(f"mesh has {n_pod} pods, settings.n_pod is "
                         f"{settings.n_pod}")
    group = mesh.get_group("pod")
    pod = mesh.get_local_rank("pod")

    def train_step(state, batch):
        step = int(state["step"])
        params, opt_state, loss, parts = one_pod_step(
            state["params"], state["opt_state"],
            {k: _pod_slice(v, pod, n_pod) for k, v in batch.items()}, step)
        if (step + 1) % settings.sync_interval == 0:
            leaves = tree_leaves(params)
            flat = torch.cat([p.detach().float().reshape(-1)
                              for p in leaves])
            mean = _pod_mean(collectives.all_gather(flat, group))
            synced, at = [], 0
            for p in leaves:
                synced.append(mean[at:at + p.numel()].reshape(p.shape)
                              .to(p.dtype).clone())
                at += p.numel()
            params = _rebuild(params, iter(synced))
        local = torch.stack([loss, parts["ce"], parts["aux"]])
        mean = _pod_mean(collectives.all_gather(local, group))
        return ({"params": params, "opt_state": opt_state,
                 "step": state["step"] + 1},
                dict(zip(METRIC_PARTS, mean.unbind())))

    return train_step


def make_serve_step(cfg: ArchConfig, long: bool = False) -> Callable:
    """serve_step(params, cache, tokens) → (logits, cache)."""
    def serve_step(params, cache, tokens):
        return decode_step(cfg, params, cache, tokens, long=long)
    return serve_step
