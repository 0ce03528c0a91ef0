"""Optimizers over a parameter tree: SGD, Adam(W) and Adafactor, with the
warmup-cosine schedule and global-norm clipping, formula for formula as
the reference's (``src/repro/optim/optimizers.py``).

An optimizer is a pair of functions wrapped in :class:`Optimizer`:
``init(params) -> state`` and
``update(grads, state, params, step) -> (new_params, new_state)``, over
the nested dicts and lists of tensors the functional model API takes
(the LM's ``pattern`` and ``tail`` are lists).  ``step`` is the
host-side int count of updates taken so far.

Adam keeps the reference's arithmetic: ``t = step + 1`` and the bias
corrections ``1 - b ** t`` in float32, then ``mh / (sqrt(vh) + eps)``.
``torch.optim.Adam`` places ``eps`` after another rounding, so it is not
used.  The bias corrections, Adafactor's ``beta`` and the learning rate
are computed on the host, once per step, as float32 scalars; each enters
the device's arithmetic as a 0-d tensor filled there with that value (a
fill, not a copy from host memory, so the host never waits for the
card).  Clipping keeps the global norm on the device: no host sync.

Adafactor exists because the trillion-parameter assigned architecture
(kimi-k2) cannot hold Adam's 8 bytes/param of momenta; factored second
moments cost O(rows+cols).

A sharded model (``train.make_train_step`` over a mesh) holds each
parameter as this rank's block: ``groups`` (``distributed.leaf_groups``'
tree, one ``LeafGroups`` a leaf) names the process group cutting each
dim.  The global norm and Adafactor's row / column means, their mean and
the update's RMS are then the whole leaf's: each rank's float32 sum over
its block, added over exactly the groups that cut the dims summed, in
rank order (``core.collectives.ordered_sum``), over the whole count.
Every rank of a group gets the same bits.  AdamW is elementwise and
takes no groups.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Union

import torch

Pytree = Any
Schedule = Callable[[int], torch.Tensor]


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int,
                           final_frac: float = 0.1) -> Schedule:
    """Linear warmup to ``peak_lr``, then a cosine decay to
    ``final_frac · peak_lr``: a float32 host scalar, computed in the
    reference's order."""
    def fn(step):
        step = torch.tensor(step, dtype=torch.float32)
        peak = torch.tensor(peak_lr, dtype=torch.float32)
        warm = peak * (step + 1.0) / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (final_frac + (1 - final_frac) * 0.5
                      * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


# ---------------------------------------------------------------------------
# Optimizer container, trees, clipping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Pytree], Pytree]
    update: Callable[[Pytree, Pytree, Pytree, int], tuple[Pytree, Pytree]]


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts, lists and tuples of equal
    structure (a list or tuple maps to a list)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree: Pytree) -> list:
    """Leaves in the reference's pytree order: dict keys sorted, lists in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 host scalar as a 0-d tensor on ``like``'s device."""
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def _whole_sum(t: torch.Tensor, groups: list) -> torch.Tensor:
    """A rank's float32 partial sum ``t`` added over each process group in
    ``groups`` in turn, in rank order."""
    # Imported here: repro_torch.core imports this package.
    from repro_torch.core import collectives
    for g in groups:
        t = collectives.ordered_sum(t, g, torch.float32)
    return t


def _global_norm(tree: Pytree, groups: Pytree = None) -> torch.Tensor:
    """sqrt of the sum, over the leaves in pytree order, of each leaf's
    float32 sum of squares; with ``groups``, each leaf's over the whole
    leaf: the blocks' sums, stacked, are added over each mesh dimension
    that cuts any leaf (one gather each), and a leaf takes the sum of the
    dimensions that cut it."""
    sums = [torch.sum(torch.square(leaf.float()))
            for leaf in tree_leaves(tree)]
    if groups is not None:
        cuts = tree_leaves(groups)
        own = torch.stack(sums)
        names = sorted({a for c in cuts for a in c.names if a})
        for name in names:
            group = next(g for c in cuts for a, g in zip(c.names, c.groups)
                         if a == name)
            added = _whole_sum(own, [group])
            mask = torch.tensor([c.cut_by(name) for c in cuts],
                                device=own.device)
            own = torch.where(mask, added, own)
        sums = list(own.unbind())
    total = 0
    for s in sums:
        total = total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: Pytree, max_norm: float,
                        groups: Pytree = None) -> Pytree:
    """``g · min(1, max_norm / (norm + 1e-12))`` for every leaf, in its
    dtype; the norm and the scale stay on the device.  ``groups``: a
    sharded model's (module docstring)."""
    norm = _global_norm(grads, groups)
    scale = torch.clamp_max(max_norm / (norm + 1e-12), 1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)


# ---------------------------------------------------------------------------
# SGD (+ momentum)
# ---------------------------------------------------------------------------

def sgd(lr: Union[float, Schedule], momentum: float = 0.0) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params, step):
        lr_t = sched(step)
        if momentum == 0.0:
            new_params = tree_map(
                lambda p, g: (p - _scalar(lr_t, p) * g.to(p.dtype)
                              ).to(p.dtype), params, grads)
            return new_params, state
        new_m = tree_map(lambda m, g: momentum * m + g, state, grads)
        new_params = tree_map(
            lambda p, m: (p - _scalar(lr_t, p) * m).to(p.dtype), params,
            new_m)
        return new_params, new_m

    return Optimizer("sgd", init, update)


# ---------------------------------------------------------------------------
# Adam / AdamW
# ---------------------------------------------------------------------------

def adamw(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        t = torch.tensor(step, dtype=torch.float32) + 1.0
        lr_t = sched(step)
        bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t
        new_m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                         state["m"], grads)
        new_v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
            g.float()), state["v"], grads)

        def upd(p, m, v):
            mh = m / _scalar(bc1, m)
            vh = v / _scalar(bc2, v)
            delta = mh / (torch.sqrt(vh) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            return (p.float() - _scalar(lr_t, p) * delta).to(p.dtype)

        new_params = tree_map(upd, params, new_m, new_v)
        return new_params, {"m": new_m, "v": new_v}

    return Optimizer("adamw", init, update)


def adam(lr: Union[float, Schedule], **kw) -> Optimizer:
    return adamw(lr, weight_decay=0.0, **kw)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no first moment)
# ---------------------------------------------------------------------------

def _map_params(fn, params, *others):
    """``fn(p, *others' subtrees at p)`` over the leaves of ``params``:
    the other trees may hold a subtree (Adafactor's ``{"row", "col"}``)
    where ``params`` holds a tensor."""
    if isinstance(params, dict):
        return {k: _map_params(fn, params[k], *(o[k] for o in others))
                for k in params}
    if isinstance(params, (list, tuple)):
        return [_map_params(fn, *xs) for xs in zip(params, *others)]
    return fn(params, *others)


def _mean(t: torch.Tensor, dim: int, cut, keepdim: bool = False
          ) -> torch.Tensor:
    """``torch.mean(t, dim)`` of the whole leaf, ``t`` a rank's block and
    ``cut`` the leaf's :class:`LeafGroups` (None: whole) indexed like
    ``t``'s dims."""
    if cut is None or cut.names[dim] is None:
        return torch.mean(t, dim=dim, keepdim=keepdim)
    total = _whole_sum(torch.sum(t, dim=dim, keepdim=keepdim),
                       cut.over([dim]))
    return total / (t.shape[dim] * cut.counts[dim])


def adafactor(lr: Union[float, Schedule], decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              groups: Pytree = None) -> Optimizer:
    """A leaf of two or more dims keeps ``row`` (the mean over its last
    dim) and ``col`` (over its second-to-last), its leading dims
    (``repeats``, experts) kept; a 1-D leaf keeps a full ``v``.  The
    update's RMS clip is one reduction a leaf.  ``groups``: a sharded
    model's (module docstring)."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def leaf(p):
            zeros = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                              device=p.device)
            if _factored(p):
                return {"row": zeros(p.shape[:-1]),
                        "col": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}
        return tree_map(leaf, params)

    def update(grads, state, params, step):
        t = torch.tensor(step, dtype=torch.float32) + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = sched(step)

        def leaf(p, g, s, cut=None):
            b = _scalar(beta, p)
            g = g.float()
            g2 = torch.square(g) + eps
            if _factored(p):
                n = p.ndim
                row = b * s["row"] + (1 - b) * _mean(g2, n - 1, cut)
                col = b * s["col"] + (1 - b) * _mean(g2, n - 2, cut)
                row_mean = _mean(row, n - 2, cut, keepdim=True)
                vhat = (row[..., :, None]
                        / torch.clamp_min(row_mean[..., None], eps)
                        * col[..., None, :])
                upd = g * torch.rsqrt(torch.clamp_min(vhat, eps))
                new_s = {"row": row, "col": col}
            else:
                v = b * s["v"] + (1 - b) * g2
                upd = g * torch.rsqrt(torch.clamp_min(v, eps))
                new_s = {"v": v}
            # Update clipping (RMS of update <= clip_threshold).
            if cut is None or not cut.over():
                ms = torch.mean(torch.square(upd))
            else:
                ms = (_whole_sum(torch.sum(torch.square(upd)), cut.over())
                      / (upd.numel() * math.prod(cut.counts)))
            rms = torch.sqrt(ms + 1e-30)
            upd = upd / torch.clamp_min(rms / clip_threshold, 1.0)
            return ((p.float() - _scalar(lr_t, p) * upd).to(p.dtype),
                    new_s)

        out = (_map_params(leaf, params, grads, state) if groups is None
               else _map_params(leaf, params, grads, state, groups))
        return (_map_params(lambda p, o: o[0], params, out),
                _map_params(lambda p, o: o[1], params, out))

    return Optimizer("adafactor", init, update)


REGISTRY = {"sgd": sgd, "adam": adam, "adamw": adamw, "adafactor": adafactor}


def make_optimizer(name: str, lr: Union[float, Schedule], **kw) -> Optimizer:
    return REGISTRY[name](lr, **kw)
