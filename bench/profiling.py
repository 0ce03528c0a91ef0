"""Reading a ``torch.profiler`` trace of the window.

The traced span is a ``record_function`` range around whole sync
periods that ends in ``torch.cuda.synchronize()``; every device op (a
kernel, copy or fill) inside it counts.  The device is busy while any
device op runs (the union of their intervals: one stream, but counted
as a union all the same), idle otherwise, as in
``repro_torch/launch/serving_driver.py::profile_serve_loop`` whose sums
this copies.  Events are read raw from ``kineto_results``:
``key_averages`` parses every CPU op first, which is slow over tens of
thousands of launches.
"""
from __future__ import annotations

import bisect
import re

import torch


def summarize(prof, span_name: str) -> dict:
    """``{"span": (start_ns, end_ns), "device": [(name, start, end)],
    "host": [(name, start, end)]}`` of the events inside the span named
    ``span_name`` (device events clipped to it)."""
    host, device, span = [], [], None
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if e.name() == span_name:
            # The range shows on the device's timeline too (a user
            # annotation), where it is no op.
            if not on_device:
                span = item[1:]
        elif on_device:
            if not e.is_user_annotation():
                device.append(item)
        else:
            host.append(item)
    if span is None:
        raise RuntimeError(f"no {span_name!r} range in the trace")
    lo, hi = span
    device = sorted(((n, max(s, lo), min(t, hi)) for n, s, t in device
                     if t > lo and s < hi), key=lambda d: d[1])
    host = [h for h in host if h[2] > lo and h[1] < hi]
    return {"span": span, "device": device, "host": host}


def busy_ns(tr: dict) -> int:
    """The union of the device ops' intervals inside the span."""
    total, end = 0, None
    for _, s, t in tr["device"]:
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total


def window_ns(tr: dict) -> int:
    return tr["span"][1] - tr["span"][0]


def kernel_ns(tr: dict, patterns) -> int:
    """Summed device time of the ops whose name matches a pattern."""
    rx = re.compile("|".join(patterns))
    return sum(t - s for n, s, t in tr["device"] if rx.search(n))


def top_ops(tr: dict, k: int = 10) -> list:
    """The ``k`` device ops that took most time: [[name, seconds]]."""
    by: dict[str, int] = {}
    for n, s, t in tr["device"]:
        by[n] = by.get(n, 0) + t - s
    ranked = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[n[:200], ns / 1e9] for n, ns in ranked]


def _gaps(tr: dict) -> list:
    lo, hi = tr["span"]
    gaps, end = [], lo
    for _, s, t in tr["device"]:
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def idle_gaps(tr: dict, k: int = 10) -> list:
    """The ``k`` longest idle gaps, each named by what the host was doing
    at its middle: the innermost host op there, after the innermost one
    that is not a CUDA runtime call when they differ ("aten::x >
    cudaMemcpyAsync").  [[label, seconds]]."""
    host = sorted(tr["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    out = []
    for a, b in sorted(_gaps(tr), key=lambda g: g[0] - g[1])[:k]:
        mid = (a + b) // 2
        cover = [h for h in host[:bisect.bisect_right(starts, mid)]
                 if h[2] >= mid]
        cover.sort(key=lambda h: h[2] - h[1])
        label = "host: python"
        if cover:
            ops = [h[0] for h in cover if not h[0].startswith("cuda")]
            label = ops[0] if ops else cover[0][0]
            if cover[0][0] != label:
                label = f"{label} > {cover[0][0]}"
        out.append([label[:200], (b - a) / 1e9])
    return out
