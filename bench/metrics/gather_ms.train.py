"""gather_ms.train: device ms an epoch of the ops launched in the
program's ``digest.gather`` span: ``make_epoch_fn``'s layer-0 halo and
local feature gathers from ``x_global``.  ``bench/phases.py`` charges
each op of the traced periods to the innermost span that launched it;
this is the span's own share over the traced epochs."""
from bench import phases


def read(ctx: dict):
    return phases.span_ms(ctx, ("digest.gather",))
