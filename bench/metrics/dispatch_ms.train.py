"""dispatch_ms.train: the host's time to dispatch one training epoch.

The host clock around each ``epoch_fn`` call of the untraced part of a
``--trace 1`` window, with no synchronise, averaged over those epochs.
Where the device keeps up it is the host's own work an epoch (Python,
autograd, launches); where the launch queue is full it includes the
wait for room in it.
"""
import statistics


def read(ctx: dict):
    times = ctx.get("dispatch_s")
    return 1e3 * statistics.fmean(times) if times else None
