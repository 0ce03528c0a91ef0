#!/usr/bin/env python
"""Run the port's dry-run matrix (10 archs x 4 shapes x 2 meshes) with
``repro_torch.launch.dryrun``, each case in its own process under a time
limit, on the CPU (no card, nothing allocated):

  PYTHONPATH=src python scripts/torch_run_dryruns.py [--jobs 4] \\
      [--timeout 1800] [--archs qwen3-0.6b,...] [--out-dir .]

Records go to ``dryrun-single.jsonl`` (16 x 16) and ``dryrun-multi.jsonl``
(2 x 16 x 16), each case's exit code and seconds to
``dryrun-status.jsonl`` (-9: it passed its time limit); the cases that
failed are printed at the end.  ``scripts/torch_roofline_report.py``
turns the records into the roofline table.
"""
import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

ARCHS = ["qwen3-0.6b", "musicgen-large", "phi3-mini-3.8b", "xlstm-1.3b",
         "minitron-8b", "recurrentgemma-9b", "llama-3.2-vision-11b",
         "deepseek-coder-33b", "llama4-scout-17b-a16e", "kimi-k2-1t-a32b"]
SHAPES = ["decode_32k", "long_500k", "prefill_32k", "train_4k"]


def run_case(arch, shape, multi, out, timeout):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape,
           "--multi-pod", "multi" if multi else "single", "--out", out]
    t0 = time.time()
    try:
        rc = subprocess.call(cmd, env=ENV, timeout=timeout,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    except subprocess.TimeoutExpired:
        rc = -9
    return {"arch": arch, "shape": shape,
            "mesh": "2x16x16" if multi else "16x16", "rc": rc,
            "seconds": round(time.time() - t0, 1)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=2,
                    help="cases run at once")
    ap.add_argument("--timeout", type=float, default=1800,
                    help="seconds a case")
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--out-dir", default=ROOT)
    args = ap.parse_args()
    outs = {m: os.path.join(args.out_dir, f"dryrun-{m}.jsonl")
            for m in ("single", "multi")}
    status = os.path.join(args.out_dir, "dryrun-status.jsonl")
    cases = [(a, s, m) for m in (False, True)
             for a in args.archs.split(",") for s in SHAPES]
    failures = []
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        futs = [pool.submit(run_case, a, s, m,
                            outs["multi" if m else "single"], args.timeout)
                for a, s, m in cases]
        for fut in concurrent.futures.as_completed(futs):
            res = fut.result()
            print(f"{res['arch']:26s} {res['shape']:12s} {res['mesh']:8s} "
                  f"rc={res['rc']} {res['seconds']:7.1f}s", flush=True)
            with open(status, "a") as f:
                f.write(json.dumps(res) + "\n")
            if res["rc"] != 0:
                failures.append(res)
    print("FAILURES:", json.dumps(failures))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
