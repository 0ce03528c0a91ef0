#!/usr/bin/env python
"""Online GNN embedding-serving launcher (PyTorch port).

Builds and partitions the graph, refreshes the all-node owner-sharded
serving store from the top-layer representations, then drives a Zipf
query stream through the batched query engine
(``repro_torch.core.serving``) behind the hot-row cache, reporting p50/p99
latency, queries/sec and cache hit-rate.  Runs on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.serve_gnn \
      --dataset products-sim --scale 1.0 --parts 8 --layers 3 \
      --hidden 128 --storage int8 --cache-rows 2048

``--device cpu`` runs the kernels' plain PyTorch versions instead.
``--profile`` traces the query loop once more with ``torch.profiler`` and
prints the device's busy share of it and its top ops.
Weights are random, drawn from ``torch.Generator`` seed 0: serving cost is
independent of training state.

``--sharded`` also times the sharded engine
(``serving.serve_query_sharded``) over the ranks ``torchrun`` starts,
each holding ``--parts`` / ranks owner shards (``--dist-backend nccl`` or
``gloo``); rank 0 prints:

  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve_gnn \
      --device cpu --sharded --dist-backend gloo --scale 0.1
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import serving
from repro_torch.core.digest import prepare_graph_data, top_layer_reps
from repro_torch.device import resolve_device
from repro_torch.core.halo_exchange import part_slice
from repro_torch.graph import make_dataset
from repro_torch.launch.mesh import (BACKENDS, close_distributed,
                                     init_distributed)
from repro_torch.launch.serving_driver import (profile_serve_loop,
                                               run_serve_loop)
from repro_torch.models.gnn import GNN, GNNConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="flickr-sim")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--model", default="gcn",
                    choices=("gcn", "sage", "gat"))
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--batches", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--skew", type=float, default=1.1,
                    help="Zipf exponent of the query stream")
    ap.add_argument("--cache-rows", type=int, default=0,
                    help="hot-row cache capacity (0 disables)")
    ap.add_argument("--cache-ways", type=int, default=4)
    ap.add_argument("--storage", default="fp32",
                    choices=("fp32", "bf16", "int8"))
    ap.add_argument("--refreshes", type=int, default=1,
                    help="store refreshes to run (in place)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--sharded", action="store_true",
                    help="also time the sharded engine over the torchrun "
                         "ranks (needs --dist-backend)")
    ap.add_argument("--dist-backend", default=None, choices=BACKENDS,
                    help="torch.distributed backend of --sharded")
    ap.add_argument("--profile", action="store_true",
                    help="after the timed loop, trace it once more with "
                         "torch.profiler (card only) and print the "
                         "device's busy share and top ops as JSON")
    args = ap.parse_args(argv)
    mesh = None
    if args.sharded:
        if args.dist_backend is None:
            ap.error("--sharded needs --dist-backend")
        mesh, dev = init_distributed(args.dist_backend, args.device)
    else:
        dev = resolve_device(args.device)
    if args.profile and dev.type != "cuda":
        ap.error("--profile traces the card; it needs --device cuda")
    try:
        return _serve(args, dev, mesh)
    finally:
        if mesh is not None:
            mesh = None
            close_distributed()


def _serve(args, dev, mesh):
    rank0 = mesh is None or dist.get_rank() == 0

    def log(*a, **kw):
        if rank0:
            print(*a, **kw)

    g = make_dataset(args.dataset, scale=args.scale, seed=0)
    data = prepare_graph_data(g, args.parts, seed=0, device=dev)
    cfg = GNNConfig(model=args.model, num_layers=args.layers,
                    in_dim=g.features.shape[1], hidden_dim=args.hidden,
                    num_classes=int(g.labels.max()) + 1)
    params = GNN.init(cfg, torch.Generator().manual_seed(0), dev).tree()

    plan = serving.build_serve_plan(data)
    scfg = serving.ServeConfig(batch_size=args.batch,
                               cache_rows=args.cache_rows,
                               cache_ways=args.cache_ways,
                               storage=args.storage)
    store = serving.init_serve_store(plan, cfg.hidden_dim, scfg.precision,
                                     dev)
    refresh = serving.make_refresh_fn()
    rdata = plan.refresh_data(dev)
    reps = top_layer_reps(cfg, params, data)
    for _ in range(max(args.refreshes, 1)):
        store = refresh(store, reps, rdata)
    log(f"store: {plan.store_rows} slots x{cfg.hidden_dim} "
        f"({args.storage}), {args.parts} shards, "
        f"version {int(store['version'])}")

    # Zipf traffic, hubs hottest (popularity rank = descending degree).
    hot = np.argsort(-g.degrees()).astype(np.int32)
    queries = serving.zipf_queries(g.num_nodes, args.batch, args.batches,
                                   args.skew, seed=1, hot_ids=hot)
    qdata = plan.query_data(dev)
    cache = serving.init_cache(scfg, cfg.num_classes, dev)

    def step(cache, q):
        logits, cache = serving.serve_query(
            cfg, scfg, params, store, cache, qdata,
            torch.from_numpy(q).to(dev))
        return cache, logits

    with torch.inference_mode():
        cache, _, stats = run_serve_loop(step, queries, carry=cache,
                                         warmup=args.warmup,
                                         items_per_call=args.batch)
    log(f"query[{args.model}] batch={args.batch} skew={args.skew}: "
        f"p50 {stats.p50_ms:.2f} ms  p99 {stats.p99_ms:.2f} ms  "
        f"{stats.per_sec:,.0f} q/s  "
        f"cache hit-rate {serving.hit_rate(cache):.3f} "
        f"({args.cache_rows} rows, {args.cache_ways}-way) on {dev}")
    if args.profile:
        with torch.inference_mode():
            split = profile_serve_loop(step, queries, carry=cache)
        log("profile: " + json.dumps(split))
    if mesh is not None:
        lstore, sdata = serving.place_serving(
            store, plan.sharded_data(data), mesh)
        mine = part_slice(args.parts, mesh)
        rng = np.random.default_rng(2)
        rows = rng.integers(0, plan.part_rows,
                            (args.batches, args.parts, args.batch))

        def sstep(carry, q_rows):
            out = serving.serve_query_sharded(
                cfg, scfg, mesh, plan.halo_size, params, lstore, sdata,
                torch.from_numpy(q_rows[mine]).to(dev))
            return carry, out

        with torch.inference_mode():
            _, _, sstats = run_serve_loop(
                sstep, rows, warmup=args.warmup,
                items_per_call=args.parts * args.batch)
        log(f"sharded[{dist.get_world_size()} ranks] "
            f"{args.parts}x{args.batch} rows/call: "
            f"p50 {sstats.p50_ms:.2f} ms  p99 {sstats.p99_ms:.2f} ms  "
            f"{sstats.per_sec:,.0f} q/s")
    return stats, cache


if __name__ == "__main__":
    main()
