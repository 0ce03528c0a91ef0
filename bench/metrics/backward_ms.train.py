"""backward_ms.train: device ms an epoch of the ops launched in the
program's ``gnn.backward`` spans: each subgraph's
``torch.autograd.grad`` (M a round).  Autograd's device thread launches
them while the caller waits in the span, so they fall in it by the
host clock (``bench/phases.py``); the spans' own share over the traced
epochs."""
from bench import phases


def read(ctx: dict):
    return phases.span_ms(ctx, ("gnn.backward",))
