"""Optimizers over a parameter dict: SGD and Adam(W), formula for formula
as the reference's (``src/repro/optim/optimizers.py``).

An optimizer is a pair of functions wrapped in :class:`Optimizer`:
``init(params) -> state`` and
``update(grads, state, params, step) -> (new_params, new_state)``, over
the nested dict of tensors the functional model API takes.  ``step`` is
the host-side int count of updates taken so far.

Adam keeps the reference's arithmetic: ``t = step + 1`` and the bias
corrections ``1 - b ** t`` in float32, then ``mh / (sqrt(vh) + eps)``.
``torch.optim.Adam`` places ``eps`` after another rounding, so it is not
used.  The bias corrections and the learning rate are computed on the
host, once per step, as float32 scalars.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch

Pytree = Any
Schedule = Callable[[int], torch.Tensor]


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Pytree], Pytree]
    update: Callable[[Pytree, Pytree, Pytree, int], tuple[Pytree, Pytree]]


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of equal structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 host scalar moved to ``like``'s device."""
    return x.to(device=like.device, dtype=torch.float32)


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
