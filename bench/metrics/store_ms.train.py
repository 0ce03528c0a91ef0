"""store_ms.train: device ms an epoch of the ops launched in the
program's ``store.pull``, ``store.probe`` and ``store.push`` spans: on
the rounds that pull, the slab pull (GAT: the store's projection and the
z slabs' pulls); on every round, the staleness probe; on the rounds that
push, the push.  ``bench/phases.py`` charges each op of the traced
periods to the innermost span that launched it; these are the spans'
shares over the traced epochs (whole sync periods: one pull and one
push each)."""
from bench import phases


def read(ctx: dict):
    return phases.span_ms(ctx, ("store.pull", "store.probe", "store.push"))
