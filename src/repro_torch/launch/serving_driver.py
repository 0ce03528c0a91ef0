"""Serving-loop driver: batching, warmup, latency capture.

``step_fn(carry, item) -> (carry, out)`` is the only contract; this module
owns timing — it waits for every CUDA device holding a tensor the step
returned (``torch.cuda.synchronize``) before it stops the clock, since
PyTorch returns before the card finishes — and the stats: p50/p99 latency
over the steady-state calls (the first ``warmup`` calls are excluded) and
items/sec throughput.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.device import synchronize


@dataclasses.dataclass
class ServeStats:
    """Latency capture of one serving loop."""

    latencies_s: list           # per-call wall-clock seconds, in order
    warmup: int = 0             # leading calls excluded from percentiles
    items_per_call: int = 1     # batch size, for the throughput number

    @property
    def steady(self) -> list:
        tail = self.latencies_s[self.warmup:]
        return tail if tail else self.latencies_s

    @property
    def total_s(self) -> float:
        return float(sum(self.latencies_s))

    def percentile_ms(self, q: float) -> float:
        return float(np.percentile(np.asarray(self.steady), q) * 1e3)

    @property
    def p50_ms(self) -> float:
        return self.percentile_ms(50)

    @property
    def p99_ms(self) -> float:
        return self.percentile_ms(99)

    @property
    def mean_ms(self) -> float:
        return float(np.mean(np.asarray(self.steady)) * 1e3)

    @property
    def per_sec(self) -> float:
        """Steady-state items (queries) per second."""
        denom = max(float(sum(self.steady)), 1e-12)
        return self.items_per_call * len(self.steady) / denom

    def summary(self) -> dict:
        return {"calls": len(self.latencies_s), "warmup": self.warmup,
                "items_per_call": self.items_per_call,
                "p50_ms": self.p50_ms, "p99_ms": self.p99_ms,
                "mean_ms": self.mean_ms, "per_sec": self.per_sec}


def run_serve_loop(step_fn: Callable[[Any, Any], tuple],
                   items: Iterable, carry: Any = None, warmup: int = 0,
                   items_per_call: int = 1,
                   ) -> tuple[Any, list, ServeStats]:
    """Drive ``step_fn`` over ``items``, timing every call.

    Each call is waited for before the clock stops.  Returns (final carry,
    [out per call], ServeStats); the first ``warmup`` calls stay in the
    latency list but are excluded from the percentile/throughput stats.
    """
    latencies, outs = [], []
    for item in items:
        t0 = time.perf_counter()
        carry, out = step_fn(carry, item)
        synchronize((carry, out))
        latencies.append(time.perf_counter() - t0)
        outs.append(out)
    warmup = min(warmup, max(len(latencies) - 1, 0))
    return carry, outs, ServeStats(latencies, warmup=warmup,
                                   items_per_call=items_per_call)


def profile_serve_loop(step_fn: Callable[[Any, Any], tuple],
                       items: Iterable, carry: Any = None,
                       top: int = 8) -> dict:
    """Trace ``step_fn`` over ``items`` with ``torch.profiler`` on the
    card: the loop's wall time, the device's busy time (the sum of the
    device ops' self times — one stream, so they do not overlap) and its
    share of the wall time, and the ``top`` device ops by time.  The
    profiler's own overhead inflates the wall time, so take latencies from
    :func:`run_serve_loop` and only the split from here."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = None
        for item in items:
            carry, out = step_fn(carry, item)
        synchronize((carry, out))
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side entries only (kernels, copies): the CPU-side aten op that
    # launched a kernel reports that kernel's time again.
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in ops) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "top": [{"op": e.key, "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in ops[:top]]}
