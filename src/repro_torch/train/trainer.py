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
  :mod:`repro_torch.core.collectives`, so the census counts it.

Data parallelism (the reference's GSPMD split of a pod's batch): with a
mesh, the pod form splits each pod's batch over "data", and the
``every_step`` baseline splits the batch over every batch dimension
("pod" and "data") of its mesh.  A rank takes its contiguous block of
rows and differentiates its share of the pod batch's loss: its masked
CE sum over the pod's mask count (one small all-reduce before the
backward), and the MoE aux loss with the per-expert dispatch counts
gathered over the ranks (``E · f_e / T_pod`` a local token).  The
gradients, with the loss and its parts, are gathered over the data
ranks and added in rank order every step, before the clip, so every
data rank steps on the same bits.

Tensor parallelism and FSDP: the trainer places parameters by the
reference trainer's rules, ``axis_rules(mesh, {"embed": "data"})``
(``sharding.TRAIN_RULES``).  Over a mesh whose "model" dimension is
above 1, or whose "data" dimension is (FSDP), each rank holds its blocks
of the parameters and of the optimizer state (``distributed.sharding``,
placed like their parameters) and runs ``forward`` on its rows, under
the same rules with "batch" cut no further (:data:`FORWARD_RULES`): the
row-parallel sums, the column gathers and the FSDP gathers differentiate
through ``core.collectives``, the loss is the vocab-parallel masked CE
over its logit block (``nn.layers.vocab_parallel_nll``), and the global
norm and Adafactor take whole-leaf statistics (``optim``'s ``groups``).
A leaf cut over "data" has its gradient summed over "data" by its
gather's backward, then over the split's other dimension ("pod", in the
``every_step`` form) with the other leaves' sums.  A mesh with nothing
cut and no batch dimension above 1 gives the single-device step exactly.

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
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import dim_size
from repro_torch.models.transformer import (ArchConfig, arch_specs,
                                            aux_moe_loss, aux_moe_stats,
                                            decode_step, forward,
                                            vocab_block)
from repro_torch.nn import abstract_params, init_params
from repro_torch.nn.layers import token_nll, vocab_parallel_nll
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


def make_arch_optimizer(cfg: ArchConfig, settings: TrainSettings,
                        groups: Pytree = None) -> Optimizer:
    """``groups``: a sharded model's ``distributed.leaf_groups`` (the
    whole-leaf statistics of Adafactor)."""
    sched = warmup_cosine_schedule(cfg.learning_rate,
                                   settings.warmup_steps,
                                   settings.total_steps)
    if cfg.optimizer == "adafactor":
        return make_optimizer("adafactor", sched, groups=groups)
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
                     seed: int = 0, device="cuda", mesh=None) -> dict:
    """Parameters from ``torch.Generator().manual_seed(seed)`` (drawn on
    the host: the same values on every device), the optimizer's state
    and ``step`` 0; in the stacked-pod form every leaf carries a leading
    ``n_pod`` dim of equal copies.  Over a ``mesh`` that cuts the
    parameters (:func:`make_train_step`'s), this rank's blocks of the
    same numbers (``sharding.init_sharded``) and of the optimizer's
    state."""
    gen = torch.Generator().manual_seed(seed)
    if _cuts(cfg, mesh) is not None:
        params = sharding.init_sharded(arch_specs(cfg), gen, mesh,
                                       sharding.TRAIN_RULES, device)
    else:
        params = init_params(arch_specs(cfg), gen, resolve_device(device))
    return _state(cfg, settings, params)


# ``forward``'s rules in a sharded step: the trainer's, with "batch" cut
# no further (the rows are this rank's already, the split's).
FORWARD_RULES = dict(sharding.TRAIN_RULES, batch=None)


def _cuts(cfg: ArchConfig, mesh) -> Optional[Pytree]:
    """``distributed.leaf_groups`` of the parameters over ``mesh`` under the
    trainer's rules; None where the mesh cuts no leaf."""
    if mesh is None:
        return None
    groups = sharding.leaf_groups(arch_specs(cfg), mesh, sharding.TRAIN_RULES)
    if all(n is None for lg in tree_leaves(groups) for n in lg.names):
        return None
    return groups


def abstract_train_state(cfg: ArchConfig, settings: TrainSettings) -> dict:
    """:func:`init_train_state`'s tree on the ``meta`` device (no
    allocation); ``step`` stays a host tensor."""
    return _state(cfg, settings, abstract_params(arch_specs(cfg)))


class _DataSplit:
    """A batch split over the mesh dimensions ``axes`` (sizes above 1, in
    mesh order): this rank's block of rows and the ordered sums over its
    ranks."""

    def __init__(self, mesh, axes: list):
        self.axes = list(axes)
        self.groups = [mesh.get_group(a) for a in axes]
        sizes = [dim_size(mesh, a) for a in axes]
        self.n = 1
        self.block = 0
        for a, n in zip(axes, sizes):
            self.n *= n
            self.block = self.block * n + mesh.get_local_rank(a)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % self.n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over {self.n} data-parallel ranks")
        return _pod_slice(x, self.block, self.n)

    def count(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum of a small exact count over the ranks."""
        for g in reversed(self.groups):
            collectives.all_reduce(t, group=g)
        return t

    def sum(self, t: torch.Tensor,
            late: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Float32 sum of every rank's ``t``, in rank order: over the last
        dimension first, then the one before; every rank gets the same
        bits.  ``late``: float32 values summed over "data" already (the
        gradients of leaves cut over "data"), appended to ``t`` once it is
        summed over "data" and summed with it over the other
        dimensions."""
        for a, g in zip(reversed(self.axes), reversed(self.groups)):
            t = collectives.ordered_sum(t, g, torch.float32)
            if a == "data" and late is not None:
                t, late = torch.cat([t, late]), None
        return t if late is None else torch.cat([t, late])


def _nll(cfg: ArchConfig, logits: torch.Tensor, labels: torch.Tensor,
         mesh) -> torch.Tensor:
    """Each position's NLL: over the vocabulary blocks where the logits
    are this rank's block (``nn.layers.vocab_parallel_nll``)."""
    if mesh is not None:
        v0, n = vocab_block(cfg, mesh, FORWARD_RULES)
        if n < cfg.vocab_size:
            return vocab_parallel_nll(logits, labels, v0,
                                      mesh.get_group("model"))
    return token_nll(logits, labels)


def _ce_share(nll: torch.Tensor, mask: Optional[torch.Tensor],
              split: Optional[_DataSplit]) -> torch.Tensor:
    """This rank's share of the pod batch's masked-mean CE: its masked
    sum over the pod's mask count (the whole mean without a split, as
    ``nn.softmax_cross_entropy``)."""
    if split is None and mask is None:
        return torch.mean(nll)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    count = torch.sum(mask)
    if split is not None:
        count = split.count(count.detach())
    return torch.sum(nll * mask) / torch.clamp_min(count, 1.0)


def _aux_share(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
               split: _DataSplit, mesh=None,
               rules: Optional[dict] = None) -> torch.Tensor:
    """This rank's share of the pod batch's load-balance loss
    ``E · Σ_e f_e · p_e`` (a block mean): the dispatch counts and
    probability sums are gathered over the ranks (detached), and the
    local probability sum carries the gradient, ``E · f_e / T_pod`` a
    local token.  The shares add up to the pod's loss."""
    stats = aux_moe_stats(cfg, params, tokens, mesh, rules)
    e = cfg.num_experts
    total = split.sum(torch.cat([torch.cat([c, p.detach()])
                                 for c, p in stats]))
    t_pod = tokens.numel() * split.n
    share = torch.zeros((), device=total.device)
    for i, (_, p) in enumerate(stats):
        f = total[2 * e * i:2 * e * i + e] / t_pod
        share = share + e * torch.sum(f * (p / t_pod))
    return share / max(len(stats), 1)


def _loss_fn(cfg: ArchConfig, settings: TrainSettings, params: Pytree,
             batch: dict, split: Optional[_DataSplit] = None,
             mesh=None) -> tuple[torch.Tensor, dict]:
    rules = None if mesh is None else FORWARD_RULES
    logits = forward(cfg, params, batch["tokens"], batch.get("vision"),
                     mesh=mesh, rules=rules)
    ce = _ce_share(_nll(cfg, logits, batch["labels"], mesh),
                   batch.get("mask"), split)
    del logits
    loss = ce
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    if cfg.num_experts:
        aux = (aux_moe_loss(cfg, params, batch["tokens"], mesh=mesh,
                            rules=rules) if split is None
               else _aux_share(cfg, params, batch["tokens"], split, mesh,
                               rules))
        loss = loss + settings.aux_loss_weight * aux
    return loss, {"ce": ce, "aux": aux}


def loss_and_grads(cfg: ArchConfig, settings: TrainSettings,
                   params: Pytree, batch: dict,
                   split: Optional[_DataSplit] = None, mesh=None) -> tuple:
    """``(loss, parts, grads)`` of one pod's batch; ``grads`` has the
    tree of ``params`` and each leaf's dtype.  With ``split`` (a
    data-parallel step), ``batch`` is this rank's rows and the three are
    its shares of the split's batch, to be summed over the ranks
    (:func:`_sum_shares`).  ``mesh``: ``params`` are this rank's blocks
    over it (module docstring)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = _rebuild(params, it)
    with torch.enable_grad():
        loss, parts = _loss_fn(cfg, settings, live, batch, split, mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            _rebuild(params, iter(grads)))


def _sum_shares(split: _DataSplit, loss, parts, grads,
                summed: Optional[list] = None) -> tuple:
    """The split batch's loss, parts and gradients: every rank's shares,
    flattened into one float32 buffer, gathered and added in rank order.
    ``summed``: a flag a leaf (pytree order) whose gradient is summed over
    "data" already (cut over "data": its gather's backward added it),
    then added over the split's other dimensions only."""
    leaves = tree_leaves(grads)
    summed = summed or [False] * len(leaves)
    flat = torch.cat([g.float().reshape(-1)
                      for g, done in zip(leaves, summed) if not done]
                     + [torch.stack([loss, parts["ce"], parts["aux"]])])
    late = [g.float().reshape(-1) for g, done in zip(leaves, summed) if done]
    total = split.sum(flat, torch.cat(late) if late else None)
    at, rest = flat.numel(), flat.numel()
    del flat, late
    out, mine = [], 0
    for g, done in zip(leaves, summed):
        if done:
            out.append(total[rest:rest + g.numel()].reshape(g.shape)
                       .to(g.dtype))
            rest += g.numel()
        else:
            out.append(total[mine:mine + g.numel()].reshape(g.shape)
                       .to(g.dtype))
            mine += g.numel()
    loss, ce, aux = total[at - 3:at].unbind()
    return loss, {"ce": ce, "aux": aux}, _rebuild(grads, iter(out))


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
    return collectives.sum_in_order(copies, torch.float32) / len(copies)


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
    ``settings`` names (module docstring).  ``mesh``: the ``DeviceMesh``
    of ``pod_impl="shard_map"`` (one rank a pod over "pod", each pod's
    batch split over "data"), or of the data-parallel single-pod step
    (the batch split over "pod" and "data"); either may have a "model"
    dimension (tensor parallelism); the stacked pod form takes none.
    Where the mesh cuts parameters (the reference trainer's rules,
    ``{"embed": "data"}``: FSDP over a "data" dimension above 1),
    ``state`` holds this rank's blocks (:func:`init_train_state` with the
    same mesh).  ``batch`` is
    the global batch on every rank.  Metrics are 0-d tensors on the
    batch's device: ``loss``, ``ce``, ``aux`` (the pod batches', then the
    pods' means) and, in the stacked form, ``pod_divergence``."""
    groups = _cuts(cfg, mesh)
    sharded = None if groups is None else mesh
    summed = (None if groups is None
              else [lg.cut_by("data") for lg in tree_leaves(groups)])
    opt = make_arch_optimizer(cfg, settings, groups)
    pods = settings.sync_mode == "digest" and settings.n_pod > 1
    if mesh is not None and pods and settings.pod_impl != "shard_map":
        raise ValueError("the stacked pod form (pod_impl='vmap') runs on "
                         "one device and takes no mesh; a mesh takes "
                         "pod_impl='shard_map'")
    axes = [a for a in (("data",) if pods else ("pod", "data"))
            if mesh is not None and dim_size(mesh, a) > 1]
    split = _DataSplit(mesh, axes) if axes else None

    def one_pod_step(params, opt_state, batch, step):
        if split is not None:
            batch = {k: split.rows(v) for k, v in batch.items()}
        loss, parts, grads = loss_and_grads(cfg, settings, params, batch,
                                            split, sharded)
        if split is not None:
            loss, parts, grads = _sum_shares(split, loss, parts, grads,
                                             summed)
        if settings.grad_clip:
            grads = clip_by_global_norm(grads, settings.grad_clip, groups)
        with torch.no_grad():
            new_params, new_opt = opt.update(grads, opt_state, params, step)
        return new_params, new_opt, loss, parts

    if not pods:
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
    """Form (c): this rank is one pod of ``mesh``'s "pod" dimension (and
    one data block of its pod, ``one_pod_step``'s split)."""
    if mesh is None or "pod" not in (mesh.mesh_dim_names or ()):
        raise ValueError("pod_impl='shard_map' needs a mesh with a "
                         "'pod' axis active via axis_rules(...)")
    n_pod = dim_size(mesh, "pod")
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


def make_serve_step(cfg: ArchConfig, long: bool = False, mesh=None,
                    rules: Optional[dict] = None) -> Callable:
    """serve_step(params, cache, tokens) → (logits, cache); ``mesh`` and
    ``rules`` as ``decode_step``'s (tensor parallelism over "model")."""
    def serve_step(params, cache, tokens):
        return decode_step(cfg, params, cache, tokens, long=long, mesh=mesh,
                           rules=rules)
    return serve_step
