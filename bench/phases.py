"""The traced periods' device time and idle time by the program's spans.

The program names the phases of its epoch with ``record_function``
ranges (``repro_torch/trace.py``: :data:`SPANS`), all entered on the
thread that calls ``epoch_fn``; :func:`bench.profiling.summarize` keeps
them among the host events, on the clock of the device ops.

A device op is charged to the innermost span whose host interval holds
the runtime call that launched it (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ...), or to :data:`OUTSIDE`.  Autograd's device
thread launches the backward while the caller blocks in
``torch.autograd.grad``, so by the host clock those launches fall in
``gnn.backward``.  The trace that ``summarize`` keeps pairs no op with
its launch, so the pairing is the stream's order: every op of the
epoch runs on one stream, which runs them in the order they were
launched, so the k-th launch starts the k-th op; where the launches
and ops differ in number, nothing is charged.  An op is charged its
share of the union of the ops' intervals (what it adds to
``busy_ns``), so the charges add up to ``busy_ns``.  An idle gap (the
gaps of ``profiling._gaps``) is charged to the innermost span holding
its midpoint, so those add up to the window less ``busy_ns``.

From the root of a checkout, ``python3 -m bench.phases --workload
<cell> --seed <n> --seconds <s>`` makes one ``--trace 1`` run of the
cell (``harness.run_cell``), prints its result line's metrics and, per
span and epoch, the device ms, the idle ms charged, the host ms (the
span's own, its children's taken out) and the device ops; and checks
the stream-order pairing against the profiler's correlation ids, which
pair each op with its launch.
"""
from __future__ import annotations

from bench import profiling

SPANS = ("digest.epoch", "digest.gather", "store.pull", "digest.subgraph",
         "gnn.forward", "gnn.backward", "digest.update", "store.probe",
         "store.push")
OUTSIDE = "outside"
# Runtime and driver calls that put an op on a stream.
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
            "cuMemcpy", "cuMemset")


def spans(tr: dict) -> list:
    """The program's spans among the host events, by start."""
    return sorted((h for h in tr["host"] if h[0] in SPANS),
                  key=lambda h: (h[1], -h[2]))


def launches(tr: dict) -> list:
    """Start times of the runtime calls that launch the device ops, in
    launch order."""
    return sorted(s for n, s, _ in tr["host"] if n.startswith(LAUNCHES))


def innermost(spans_: list, points: list) -> list:
    """For each of the sorted ``points``, the name of the innermost of the
    nested ``spans_`` holding it (start <= t < end), else ``OUTSIDE``."""
    out, open_, i = [], [], 0
    for t in points:
        while i < len(spans_) and spans_[i][1] <= t:
            while open_ and open_[-1][2] <= spans_[i][1]:
                open_.pop()
            open_.append(spans_[i])
            i += 1
        while open_ and open_[-1][2] <= t:
            open_.pop()
        out.append(open_[-1][0] if open_ else OUTSIDE)
    return out


def pair(tr: dict) -> list | None:
    """Each device op's launch time, in the order of ``tr["device"]``:
    the k-th launch for the k-th op; None unless there are as many
    launches as ops, since a lost launch or op record would shift every
    charge after it to another span.  The pairing reads no clock: an op
    can show a start a few µs before its launch's (the two clocks are
    aligned, not one), and still takes its launch."""
    times = launches(tr)
    return times if len(times) == len(tr["device"]) else None


def union_shares(device: list) -> list:
    """What each op (sorted by start) adds to the union of the ops'
    intervals."""
    out, end = [], None
    for _, s, t in device:
        lo = s if end is None else max(s, end)
        out.append(max(0, t - lo))
        end = t if end is None else max(end, t)
    return out


def busy_by_span(tr: dict, launched: list = None) -> dict | None:
    """Device ns of the traced periods by the span that launched each op
    (``launched``: the ops' launch times, :func:`pair`'s by default), and
    the ops so charged: ``{name: [ns, ops]}``.  The ns add up to
    :func:`bench.profiling.busy_ns`.  None where :func:`pair` cannot
    pair the ops."""
    launched = pair(tr) if launched is None else launched
    if launched is None:
        return None
    order = sorted(range(len(launched)), key=launched.__getitem__)
    names = innermost(spans(tr), [launched[i] for i in order])
    shares = union_shares(tr["device"])
    out: dict = {}
    for i, name in zip(order, names):
        rec = out.setdefault(name, [0, 0])
        rec[0] += shares[i]
        rec[1] += 1
    return out


def idle_by_span(tr: dict) -> dict:
    """Idle ns of the traced periods by the span holding each gap's
    midpoint; they add up to the window less the busy time."""
    gaps = sorted(profiling._gaps(tr))
    names = innermost(spans(tr), [(a + b) // 2 for a, b in gaps])
    out: dict = {}
    for (a, b), name in zip(gaps, names):
        out[name] = out.get(name, 0) + b - a
    return out


def host_by_span(tr: dict) -> dict:
    """Each span's own host ns (its children's taken out) and calls:
    ``{name: [ns, calls]}``; ``OUTSIDE`` is the window less the
    outermost spans."""
    sps = spans(tr)
    own = [t - s for _, s, t in sps]
    outside = tr["span"][1] - tr["span"][0]
    stack: list = []
    for i, (_, s, t) in enumerate(sps):
        while stack and sps[stack[-1]][2] <= s:
            stack.pop()
        if stack:
            own[stack[-1]] -= t - s
        else:
            outside -= t - s
        stack.append(i)
    out: dict = {}
    for (name, _, _), ns in zip(sps, own):
        rec = out.setdefault(name, [0, 0])
        rec[0] += ns
        rec[1] += 1
    out[OUTSIDE] = [outside, 0]
    return out


def charged(tr: dict) -> dict | None:
    """:func:`busy_by_span` of ``tr``, worked out once a trace (kept in
    it under ``"by_span"``); None where the trace holds no
    ``digest.epoch`` span (a program without the spans) or its launches
    and ops do not pair one to one."""
    if "by_span" not in tr:
        tr["by_span"] = (busy_by_span(tr) if any(
            h[0] == "digest.epoch" for h in tr["host"]) else None)
    return tr["by_span"]


def span_ms(ctx: dict, names) -> float | None:
    """Device ms an epoch of the traced periods charged to the spans
    ``names`` (their own ops, not their children's)."""
    tr = ctx.get("trace")
    if not tr or not tr.get("device"):
        return None
    by = charged(tr)
    if by is None:
        return None
    ns = sum(by.get(n, [0])[0] for n in names)
    return ns / 1e6 / ctx["profiled_epochs"]


def table(tr: dict, epochs: int, launched: list = None) -> list:
    """Rows ``[span, device ms, idle ms, host ms, device ops]`` an epoch,
    in :data:`SPANS` order, then ``OUTSIDE`` and the total; the device
    columns 0 where the ops cannot be paired with their launches."""
    busy = busy_by_span(tr, launched) or {}
    idle = idle_by_span(tr)
    host = host_by_span(tr)
    rows = []
    for name in SPANS + (OUTSIDE,):
        b, n = busy.get(name, [0, 0])
        rows.append([name, b / 1e6 / epochs,
                     idle.get(name, 0) / 1e6 / epochs,
                     host.get(name, [0])[0] / 1e6 / epochs, n / epochs])
    rows.append(["total"] + [sum(r[i] for r in rows)
                             for i in (1, 2, 3, 4)])
    return rows


def correlated(prof, tr: dict) -> list:
    """Each op of ``tr["device"]``'s launch time by the profiler's
    correlation ids (None where no launch carries its id)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    launch_at, op_id = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                op_id[(e.name(), e.start_ns())] = e.correlation_id()
        elif e.name().startswith(LAUNCHES):
            launch_at[e.correlation_id()] = e.start_ns()
    lo = tr["span"][0]
    out = []
    for n, s, _ in tr["device"]:
        cid = op_id.get((n, s)) if s > lo else None
        out.append(launch_at.get(cid))
    return out


def main(argv=None) -> int:
    import argparse
    import collections
    import json
    import math
    import sys
    from pathlib import Path

    import torch

    sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src")]
    from bench import harness, spec
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--num-nodes", type=int, default=None,
                    help="a smaller graph than the configuration's, as "
                         "the card tests run the cells")
    args = ap.parse_args(argv)
    cell = spec.resolve(args.workload)
    if args.num_nodes:
        cell["config"] = {**cell["config"], "num_nodes": args.num_nodes}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    kept = {}
    summarize = profiling.summarize

    def keep(prof, span_name):
        tr = summarize(prof, span_name)
        kept["tr"], kept["truth"] = tr, correlated(prof, tr)
        return tr

    profiling.summarize = keep
    try:
        res = harness.run_cell(cell, args.seed, args.seconds, True, "cuda")
    finally:
        profiling.summarize = summarize
    tr, truth = kept["tr"], kept["truth"]
    n = cell["traffic"]["sync_interval"]
    epochs = n * max(2, math.ceil(harness.TRACED_EPOCHS_MIN / n))
    fifo = pair(tr) or []
    found = [t for t in truth if t is not None]
    lead = min((d[1] - t for d, t in zip(tr["device"], truth)
                if t is not None), default=None)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": res["correct"], "metrics": res["metrics"],
                      "busy_s": res["busy_s"], "window_s": res["window_s"],
                      "traced_epochs": epochs}))
    calls = collections.Counter(h[0] for h in tr["host"]
                                if h[0].startswith("cu"))
    print("runtime calls:", json.dumps(calls.most_common()))
    print(f"device ops {len(tr['device'])}, launches {len(launches(tr))}, "
          f"correlated {len(found)}, stream order == correlation "
          f"{sum(a == b for a, b in zip(fifo, truth))}, least op start "
          f"less its launch {lead} ns")
    exact = [t if t is not None else fifo[k] if fifo else d[1]
             for k, (t, d) in enumerate(zip(truth, tr["device"]))]
    for what, rows in (("stream order", table(tr, epochs)),
                       ("correlation ids", table(tr, epochs, exact))):
        print(f"by span ({what}), an epoch: span | device ms | idle ms | "
              f"host ms | device ops")
        for r in rows:
            print(f"  {r[0]} | {r[1]:.3f} | {r[2]:.3f} | {r[3]:.3f} | "
                  f"{r[4]:.1f}")
    print(f"busy ms an epoch {tr['busy_ns'] / 1e6 / epochs:.3f}, window "
          f"ms an epoch {tr['window_ns'] / 1e6 / epochs:.3f}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
