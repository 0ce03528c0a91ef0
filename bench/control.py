"""Readings of the control and of the planted faults of a cell.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it draws the cell's graph and parameters as a run does,
works out the compared epochs with the plain reference, and then with
the reference put in the program's place under each variant:

* ``tf32``: every product with TF32 operands, the precision below the
  configuration's float32 (the control);
* ``half_batch``: half of the subgraphs left out of the gradient mean;
* ``no_pull``: the pull left out (the exchange of stale representations).

and prints each variant's compared numbers against the clean reference
as one JSON line, then the least reading of each number over the seeds.
A state left unchanged reads 1 on ``step_gap`` by the measure itself and
is not run.  The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {"tf32": {"tf32": True}, "half_batch": {"half_batch": True},
            "no_pull": {"no_pull": True}}


def readings(cell: dict, seed: int, variants, device) -> dict:
    """{variant: compare.numbers(variant run, clean run)} at one seed."""
    from bench import compare, graphgen, harness
    from bench.reference.digest import Variant
    config, traffic = cell["config"], cell["traffic"]
    graph = graphgen.generate(config, seed)
    params0 = harness.draw_params(config, seed, device)
    parts, x, _ = harness.reference_setup(config, graph, device)
    clean = harness.reference_run(config, traffic, parts, x, params0)
    flat0 = harness._flat(params0)
    return {v: compare.numbers(
        harness.reference_run(config, traffic, parts, x, params0,
                              Variant(**VARIANTS[v])), clean, flat0)
            for v in variants}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench import compare, spec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.resolve(args.workload)
    least: dict = {}
    for seed in args.seeds:
        t = time.perf_counter()
        for v, nums in readings(cell, seed, args.variants,
                                args.device).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": v, **nums,
                              "fails": not compare.verdict(
                                  nums, cell["limits"]),
                              "seconds": time.perf_counter() - t}),
                  flush=True)
            for k in compare.NUMBERS:
                key = f"{v}.{k}"
                least[key] = min(least.get(key, float("inf")), nums[k])
    print(json.dumps({"workload": args.workload, "least": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
