"""Run one cell of ``BENCHMARK.json`` on this machine's NVIDIA card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result as one JSON object: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics and the trace's
breakdown.  The numbers that decide ``correct`` are printed beside their
limits as the last lines of standard error and under ``compared``, the
line's last key.  Exits non-zero with no result where there is no card
(or fewer than the cell asks for), where the program is missing, or
where JAX or the JAX package was loaded.  The kernel libraries are
built, at the first run in a checkout, into its ``build/kernels``.
"""
import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _process_start() -> float:
    """``time.perf_counter()``'s reading at the start of this process
    (its start time from ``/proc``; the first import where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - started / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_IMPORT
    return time.perf_counter() - max(age, 0.0)


def main(argv=None) -> int:
    t_start = _process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from bench import harness, spec
    cell = spec.resolve(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"bench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"bench: the program (repro_torch) is missing: {e}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)

    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    units = {m["name"]: m["unit"] for m in
             (cell["per_layer"] if args.trace else cell["end_to_end"])}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"],
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in res["metrics"].items() if k in units},
            "device": device}
    if args.trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
        line["breakdown"] = res["breakdown"]
    line["window"] = {"epochs": res["epochs"],
                      "seconds": res["seconds_window"],
                      "setup_s": res["setup_s"]}
    line["worst"] = res["worst"]
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in res["compared"].items()}
    for k, (v, lim) in res["compared"].items():
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
