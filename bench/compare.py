"""The numbers that decide ``correct`` for a training cell.

Both sides start from the same parameters and follow the same first
epochs.  Three numbers, each against its limit:

* ``loss_gap``: the largest relative gap between the two sides' losses
  over those epochs.
* ``grad_gap``: the first epoch's mean gradient (the program's as its
  Adam state holds it after one step, ``m / (1 - b1)``), by the worst
  leaf: ``| |g_prog| - |g_ref| |`` over the larger of the reference
  leaf's norm and the median leaf's.
* ``step_gap``: the same for each leaf's change from the start to the
  end of those epochs.
* ``grad_diff``: the first epoch's mean gradient again, by the worst
  leaf, as the norm of the two sides' difference, ``|g_prog - g_ref|``,
  over the same denominator.  A gap of norms moves with the rounding
  errors' projection on the gradient alone, which TF32's errors, spread
  in every direction, barely have; their whole size shows here.

A leaf whose reference gradient is under a thousandth of the median
leaf's moves by round-off alone under Adam; it is left out of both
norms' numbers by that rule on the reference's gradient.
"""
from __future__ import annotations

import math
import statistics

import torch

NOUGHT = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "step_gap", "grad_diff")


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def _worst(prog: dict, ref: dict, keep: list) -> tuple:
    """(the worst leaf's gap, that leaf)."""
    med = statistics.median(ref[k] for k in keep)
    return max((abs(prog[k] - ref[k]) / max(ref[k], med), k) for k in keep)


def numbers(prog: dict, ref: dict, params0: dict) -> dict:
    """``prog`` and ``ref`` as :func:`bench.reference.digest.train`
    returns them (leaf-keyed ``grad1`` and ``params``, ``losses``);
    ``params0`` the leaf-keyed start."""
    losses = [abs(p - r) / abs(r) for p, r in
              zip(prog["losses"], ref["losses"], strict=True)]
    g_ref, g_prog = _norms(ref["grad1"]), _norms(prog["grad1"])
    med = statistics.median(g_ref.values())
    keep = sorted(k for k, v in g_ref.items() if v >= NOUGHT * med)

    def change(params):
        return _norms({k: params[k].double() - params0[k].double()
                       for k in keep})

    grad_gap, grad_leaf = _worst(g_prog, g_ref, keep)
    diff = _norms({k: prog["grad1"][k].double() - ref["grad1"][k].double()
                   for k in keep})
    grad_diff, diff_leaf = max((diff[k] / max(g_ref[k], med), k)
                               for k in keep)
    step_gap, step_leaf = _worst(change(prog["params"]),
                                 change(ref["params"]), keep)
    return {"loss_gap": max(losses), "grad_gap": grad_gap,
            "step_gap": step_gap, "grad_diff": grad_diff,
            "loss_step": 1 + losses.index(max(losses)),
            "grad_leaf": grad_leaf, "step_leaf": step_leaf,
            "diff_leaf": diff_leaf,
            "leaves_compared": len(keep), "leaves": len(g_ref)}


def verdict(nums: dict, limits: dict) -> bool:
    """True when every number is finite and within its limit."""
    return all(math.isfinite(nums[k]) and nums[k] <= lim
               for k, lim in limits.items())
