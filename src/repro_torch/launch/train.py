#!/usr/bin/env python
"""LM training launcher (the port of ``src/repro/launch/train.py``): the
synthetic LM pipeline through :func:`repro_torch.train.make_train_step`,
with DIGEST pod sync (the stacked form), checkpoint resume and save.
Runs on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 20 --batch 4 --seq 1024

``--device cpu --smoke`` runs the reduced config on the CPU.
``--production-mesh`` (the reference's TPU fleet mesh) is not ported.
:func:`main` returns each step's seconds (host clock, from the end of
the step before: the batch's draw and upload, the step, its loss read
back, so the card has finished it, and the log line; they sum to the
loop's wall time) and its loss.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_arch, get_smoke_arch
from repro_torch.data import make_lm_pipeline
from repro_torch.device import resolve_device
from repro_torch.optim import tree_leaves
from repro_torch.train import TrainSettings, init_train_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--sync-mode", default="every_step",
                    choices=["every_step", "digest"])
    ap.add_argument("--n-pod", type=int, default=1)
    ap.add_argument("--sync-interval", type=int, default=10)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's TPU fleet mesh (not ported)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh builds the reference's (16,16)/(2,16,16) TPU "
            "v5e mesh, whose constants are not ported (ROADMAP.md §1, "
            "'Not ported')")
    dev = resolve_device(args.device)

    cfg = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 512))
    settings = TrainSettings(sync_mode=args.sync_mode, n_pod=args.n_pod,
                             sync_interval=args.sync_interval,
                             total_steps=args.steps,
                             warmup_steps=max(args.steps // 20, 2))

    state = init_train_state(cfg, settings, device=dev)
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start = restore_checkpoint(args.ckpt_dir, state)
        print(f"resumed from step {start}")
    step_fn = make_train_step(cfg, settings)
    data = make_lm_pipeline(cfg.vocab_size, args.batch, args.seq,
                            device=dev)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params:,} device={dev} "
          f"sync={args.sync_mode}/{args.sync_interval}")
    times, losses = [], []
    t0 = time.perf_counter()
    t_step = t0
    for i in range(args.steps):
        b = next(data)
        state, m = step_fn(state, {"tokens": b.tokens, "labels": b.labels,
                                   "mask": b.mask})
        losses.append(float(m["loss"]))
        if (i + 1) % args.log_every == 0:
            print(f"step {int(state['step']):5d} "
                  f"loss={losses[-1]:.4f} "
                  f"{(time.perf_counter()-t0)/(i+1):.3f}s/step",
                  flush=True)
        t = time.perf_counter()
        times.append(t - t_step)
        t_step = t
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, int(state["step"]), state)
        print(f"saved {args.ckpt_dir}")
    return {"step_s": times, "losses": losses, "state": state,
            "params": n_params}


if __name__ == "__main__":
    main()
