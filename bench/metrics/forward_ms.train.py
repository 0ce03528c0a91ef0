"""forward_ms.train: device ms an epoch of the ops launched in the
program's ``gnn.forward`` spans: each subgraph's halo tables,
``gnn_forward`` and its loss (M a round).  ``bench/phases.py`` charges
each op of the traced periods to the innermost span that launched it;
this is the spans' own share over the traced epochs."""
from bench import phases


def read(ctx: dict):
    return phases.span_ms(ctx, ("gnn.forward",))
