"""store_mb.train: the bytes the stale store moves an epoch, in 10^6
bytes: the slabs its pulls write and the rows its pushes write, sentinel
rows and scales included (the program's counters ``store.pull_bytes``
and ``store.push_bytes`` of ``repro_torch.trace``, made on the host
from the shapes of the tensors written), over its ``digest.epochs``.

The counters are read as they stand at the end of the run: its warm-up
and window are whole sync periods, one pull and one push each, so the
bytes an epoch are those of the traced periods.  None without a trace,
and with a program that keeps no such counters."""


def read(ctx: dict):
    if not ctx.get("trace"):
        return None
    try:
        from repro_torch.trace import COUNTERS
    except ImportError:
        return None
    epochs = COUNTERS.get("digest.epochs", 0)
    if not epochs:
        return None
    return (COUNTERS.get("store.pull_bytes", 0)
            + COUNTERS.get("store.push_bytes", 0)) / epochs / 1e6
