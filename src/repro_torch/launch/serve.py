#!/usr/bin/env python
"""LM serving launcher (PyTorch port): batched decode of any of the ten
architectures (KV caches, ``swa`` rings, recurrent states), optionally the
DIGEST stale-KV long-context mode.  Runs on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --batch 4 --gen 32 [--long]

``--device cpu --smoke`` runs the reduced config on the CPU.  Weights are
random, drawn on the device by a ``torch.Generator`` there, seed 0 (the
ten-billion-parameter models would take minutes on the host); the first
tokens come from seed 1 and, for a VLM, the (B, num_patches, vision_dim)
patch embeddings its cache is filled from (``precompute_vision_cache``)
from seed 2.  Each step feeds back its argmax token.  Prints ms/token
over all steps and the steady-state p50/p99 step latency.

Tensor parallelism (the reference's sharding rules,
``distributed.sharding``): under ``torchrun`` (``env://``) with
``--dist-backend``, the ranks form a ("data", "model") mesh of
``--data-axis`` x ``--model-axis``; each rank draws the weights leaf by
leaf and keeps its blocks (``sharding.init_sharded``: the single
process's numbers), holds its block of the cache, and takes the next
token from the vocab-parallel argmax (``transformer.vocab_argmax``).
Each rank prints its ms/token and the bytes of weights it holds:

  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch qwen3-0.6b --model-axis 2 --dist-backend gloo
"""
from __future__ import annotations

import argparse
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch, get_smoke_arch
from repro_torch.device import resolve_device
from repro_torch.distributed import init_sharded
from repro_torch.launch.mesh import (BACKENDS, close_distributed,
                                     init_distributed)
from repro_torch.launch.serving_driver import run_serve_loop
from repro_torch.models.transformer import (ArchConfig, arch_specs,
                                            init_cache,
                                            precompute_vision_cache,
                                            vocab_argmax)
from repro_torch.nn import init_params
from repro_torch.train import make_serve_step


def long_config(cfg: ArchConfig) -> ArchConfig:
    """The stale-KV settings ``--long`` serves with (the reference's)."""
    return dataclasses.replace(cfg, long_window=32, long_ratio=8)


def serve(cfg: ArchConfig, params, batch: int, max_seq: int, gen: int,
          long: bool = False, device="cuda", mesh=None,
          rules=None) -> tuple:
    """Decode ``gen`` tokens for ``batch`` sequences from an empty cache
    of ``max_seq`` positions (a VLM's ``xattn`` entries filled from the
    seed-2 vision draw), under ``torch.inference_mode``.  ``mesh``,
    ``rules``: tensor parallelism as ``decode_step``'s (``params`` whole
    or this rank's blocks; the cache and the logits this rank's).
    Returns (ServeStats, [logits per step], final cache)."""
    dev = resolve_device(device)
    step = make_serve_step(cfg, long=long, mesh=mesh, rules=rules)
    toks = torch.randint(0, cfg.vocab_size, (batch, 1),
                         generator=torch.Generator().manual_seed(1))

    def step_fn(carry, _):
        cache, toks = carry
        logits, cache = step(params, cache, toks)
        return (cache, vocab_argmax(cfg, logits[:, -1:], batch, mesh,
                                    rules)), logits

    with torch.inference_mode():
        cache = init_cache(cfg, batch, max_seq, long=long, device=dev,
                           mesh=mesh, rules=rules)
        if cfg.vision_dim:
            vis = torch.randn((batch, cfg.num_patches, cfg.vision_dim),
                              generator=torch.Generator().manual_seed(2))
            cache = precompute_vision_cache(cfg, params, cache, vis.to(dev),
                                            mesh=mesh, rules=rules)
        (cache, _), outs, stats = run_serve_loop(
            step_fn, range(gen), carry=(cache, toks.to(dev)), warmup=1,
            items_per_call=batch)
    return stats, outs, cache


def tensor_bytes(tree) -> int:
    """Bytes of a tree's tensors."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


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
    ap.add_argument("--data-axis", type=int, default=1,
                    help="mesh 'data' size (the batch is split over it)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="mesh 'model' size (tensor parallelism)")
    ap.add_argument("--dist-backend", default=None, choices=BACKENDS,
                    help="join the torchrun job over this backend")
    args = ap.parse_args(argv)

    cfg = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    if args.long:
        cfg = long_config(cfg)
    mesh, where = None, ""
    if args.dist_backend is not None:
        mesh, dev = init_distributed(args.dist_backend, args.device,
                                     data=args.data_axis,
                                     model=args.model_axis)
        where = (f" rank {dist.get_rank()} of data {args.data_axis} x "
                 f"model {args.model_axis}")
        params = init_sharded(arch_specs(cfg),
                              torch.Generator(device=dev).manual_seed(0),
                              mesh, device=dev)
    elif args.data_axis * args.model_axis > 1:
        ap.error("--data-axis / --model-axis need --dist-backend")
    else:
        dev = resolve_device(args.device)
        params = init_params(arch_specs(cfg),
                             torch.Generator(device=dev).manual_seed(0), dev)
    stats, _, _ = serve(cfg, params, args.batch, args.max_seq, args.gen,
                        long=args.long, device=dev, mesh=mesh)
    print(f"arch={cfg.name} long={args.long} batch={args.batch}{where}: "
          f"{stats.total_s / args.gen * 1e3:.1f} ms/token "
          f"(steady p50 {stats.p50_ms:.1f} / p99 {stats.p99_ms:.1f} ms), "
          f"{tensor_bytes(params)} bytes of weights on {dev}", flush=True)
    if mesh is not None:
        mesh = None
        close_distributed()
    return stats


if __name__ == "__main__":
    main()
