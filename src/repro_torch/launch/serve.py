#!/usr/bin/env python
"""LM serving launcher (PyTorch port): batched KV-cache decode of a dense
architecture, optionally the DIGEST stale-KV long-context mode.  Runs on
the card by default:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --batch 4 --gen 32 [--long]

``--device cpu --smoke`` runs the reduced config on the CPU.  Weights are
random, drawn from ``torch.Generator`` seed 0, and the first tokens from
seed 1; each step feeds back its argmax token.  Prints ms/token over all
steps and the steady-state p50/p99 step latency.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_arch, get_smoke_arch
from repro_torch.device import resolve_device
from repro_torch.launch.serving_driver import run_serve_loop
from repro_torch.models.transformer import ArchConfig, arch_specs, init_cache
from repro_torch.nn import init_params
from repro_torch.train import make_serve_step


def long_config(cfg: ArchConfig) -> ArchConfig:
    """The stale-KV settings ``--long`` serves with (the reference's)."""
    return dataclasses.replace(cfg, long_window=32, long_ratio=8)


def serve(cfg: ArchConfig, params, batch: int, max_seq: int, gen: int,
          long: bool = False, device="cuda") -> tuple:
    """Decode ``gen`` tokens for ``batch`` sequences from an empty cache
    of ``max_seq`` positions, under ``torch.inference_mode``.  Returns
    (ServeStats, [logits (B, 1, vocab) per step], final cache)."""
    dev = resolve_device(device)
    step = make_serve_step(cfg, long=long)
    toks = torch.randint(0, cfg.vocab_size, (batch, 1),
                         generator=torch.Generator().manual_seed(1))

    def step_fn(carry, _):
        cache, toks = carry
        logits, cache = step(params, cache, toks)
        return (cache, torch.argmax(logits[:, -1:], dim=-1)), logits

    with torch.inference_mode():
        cache = init_cache(cfg, batch, max_seq, long=long, device=dev)
        (cache, _), outs, stats = run_serve_loop(
            step_fn, range(gen), carry=(cache, toks.to(dev)), warmup=1,
            items_per_call=batch)
    return stats, outs, cache


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--long", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    if args.long:
        cfg = long_config(cfg)
    params = init_params(arch_specs(cfg), torch.Generator().manual_seed(0),
                         dev)
    stats, _, _ = serve(cfg, params, args.batch, args.max_seq, args.gen,
                        long=args.long, device=dev)
    print(f"arch={cfg.name} long={args.long} batch={args.batch}: "
          f"{stats.total_s / args.gen * 1e3:.1f} ms/token "
          f"(steady p50 {stats.p50_ms:.1f} / p99 {stats.p99_ms:.1f} ms) "
          f"on {dev}")
    return stats


if __name__ == "__main__":
    main()
