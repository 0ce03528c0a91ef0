"""device_idle_pct.train: the share of an untraced epoch in which no
device op runs, 100 x (1 - busy / epoch): busy, the union of the device
ops' intervals in the traced periods (``bench/profiling.py``) over their
epochs; epoch, the untraced part of the window's wall time over its
epochs, as ``mfu.train`` takes it.  The traced span's own idle share
would carry the profiler's cost on the host, which records every host op
and slows the dispatch it measures."""


def read(ctx: dict):
    tr, epoch_s = ctx.get("trace"), ctx.get("untraced_epoch_s")
    if not tr or not tr["device"] or not epoch_s:
        return None
    busy_s = tr["busy_ns"] / 1e9 / ctx["profiled_epochs"]
    return 100.0 * (1.0 - busy_s / epoch_s)
