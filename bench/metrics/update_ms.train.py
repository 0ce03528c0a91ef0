"""update_ms.train: device ms an epoch of the ops launched in the
program's ``digest.update`` span: the mean of the M gradients
(Algorithm 1 line 13, ``digest.mean_grads_of``) and Adam's update
(``optim/optimizers.py``).  ``bench/phases.py`` charges each op of the
traced periods to the innermost span that launched it; this is the
span's own share over the traced epochs."""
from bench import phases


def read(ctx: dict):
    return phases.span_ms(ctx, ("digest.update",))
