#!/usr/bin/env python
"""Single-device DIGEST GNN training launcher (PyTorch port).

The port of ``repro.launch.train_gnn`` for one card: the M subgraphs are
batched on the device (``repro_torch.core.digest.make_epoch_fn``), PULL
is the dense gather.  Runs on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.train_gnn \
      --dataset papers-sim --scale 1.0 --parts 8 --order rcm \
      --stream-chunk-rows 256 --hidden 128 --epochs 40

``--device cpu`` runs the kernels' plain PyTorch versions instead.
``--profile N`` traces N more epochs with ``torch.profiler`` and prints
the device's busy share of them and the top device ops.
Weights are drawn from ``torch.Generator`` seed 0.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.core import (HaloPrecision, HaloSpec, TrainSettings,
                              evaluate, init_state, make_epoch_fn,
                              prepare_graph_data)
from repro_torch.device import resolve_device, synchronize
from repro_torch.graph import make_dataset
from repro_torch.launch.serving_driver import profile_serve_loop
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim import adam


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="flickr-sim")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--model", default="gcn", choices=("gcn", "sage", "gat"))
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--hidden", type=int, default=64,
                    help="hidden width (the paper's GCN config: 128)")
    ap.add_argument("--interval", type=int, default=10)
    ap.add_argument("--precision", default="fp32",
                    choices=("fp32", "bf16", "int8"),
                    help="HaloExchange wire/storage precision")
    ap.add_argument("--error-feedback", action="store_true",
                    help="accumulate int8/bf16 rounding residual at the "
                         "pusher (unbiased repeated pushes)")
    ap.add_argument("--pull", default="gather",
                    choices=("gather", "collective"),
                    help="PULL transport; one device runs 'gather' "
                         "('collective' is the multi-GPU exchange, not "
                         "ported yet, and raises)")
    ap.add_argument("--halo-weight", type=float, default=0.0,
                    help="boundary-aware partitioning: weight of the "
                         "marginal-new-halo-rows term in the greedy "
                         "streaming score (0 = classic edge-cut LDG)")
    ap.add_argument("--order", default="none", choices=("none", "rcm"),
                    help="local-row layout: 'rcm' reorders each part's "
                         "rows by reverse Cuthill-McKee so 128-row blocks "
                         "reference clustered slab chunks (lower worklist "
                         "occupancy, same math)")
    ap.add_argument("--stream-chunk-rows", type=int, default=None,
                    help="slab rows per streamed halo_spmm chunk (also "
                         "the worklist geometry)")
    ap.add_argument("--resident-max-bytes", type=int, default=None,
                    help="stripe size above which halo_spmm streams the "
                         "slab (default RESIDENT_STRIPE_MAX_BYTES)")
    ap.add_argument("--skip-occupancy-max", type=float, default=None,
                    help="highest worklist occupancy at which the "
                         "chunk-skipping stream (K4) is selected")
    ap.add_argument("--no-gat-dedup", action="store_true",
                    help="disable the GAT owner-shard projection dedup "
                         "(per-subgraph halo projection)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace N more epochs with torch.profiler (card "
                         "only) and print the device's busy share")
    args = ap.parse_args(argv)
    if args.profile and args.device == "cpu":
        ap.error("--profile measures the card; it needs a CUDA device")
    dev = resolve_device(args.device)

    g = make_dataset(args.dataset, scale=args.scale)
    t_part = time.perf_counter()
    data = prepare_graph_data(g, args.parts, halo_weight=args.halo_weight,
                              stream_chunk_rows=args.stream_chunk_rows,
                              order=args.order, device=dev)
    t_part = time.perf_counter() - t_part
    print(f"partition: {args.parts} parts, order={args.order}, "
          f"halo_weight={args.halo_weight} built in {t_part:.2f}s "
          f"({g.num_nodes} nodes, {len(g.indices) // 2} edges)")
    cfg = GNNConfig(model=args.model, num_layers=3,
                    in_dim=g.features.shape[1], hidden_dim=args.hidden,
                    num_classes=int(g.labels.max()) + 1,
                    stream_chunk_rows=args.stream_chunk_rows,
                    resident_max_bytes=args.resident_max_bytes,
                    skip_occupancy_max=args.skip_occupancy_max,
                    halo_occupancy=data["_worklist"].occupancy,
                    gat_halo_dedup=not args.no_gat_dedup)
    opt = adam(5e-3)
    settings = TrainSettings(
        sync_interval=args.interval, mode="digest", pull_mode=args.pull,
        precision=HaloPrecision(args.precision,
                                error_feedback=args.error_feedback))
    epoch_fn = make_epoch_fn(cfg, opt, settings)
    state = init_state(cfg, opt, data, precision=settings.precision)
    t0 = time.perf_counter()
    m = {"loss": float("nan")}
    for _ in range(args.epochs):
        state, m = epoch_fn(state, data)
    synchronize(state)
    elapsed = time.perf_counter() - t0
    ev = evaluate(cfg, state["params"], data)
    sp = data["_sp"]
    spec = HaloSpec.from_partitions(sp, cfg.hidden_dim, cfg.num_layers,
                                    settings.precision)
    sync = spec.comm_bytes(sp.pull_rows(), sp.push_rows())
    wl = data["_worklist"]
    print(f"device={dev} epochs={args.epochs} "
          f"loss={float(m['loss']):.4f} val_f1={float(ev['val_f1']):.4f} "
          f"test_f1={float(ev['test_f1']):.4f} "
          f"({elapsed / max(args.epochs, 1):.3f}s/epoch)")
    print(f"halo worklist: {wl.visited_chunks}/{wl.total_pairs} "
          f"(row-block x chunk) pairs occupied "
          f"({100 * wl.occupancy:.1f}%; chunk_rows={wl.chunk_rows})")
    print(f"store: {spec.store_nbytes()/1e6:.2f} MB total, "
          f"{spec.shard_nbytes()/1e6:.2f} MB/shard; pull/sync: "
          f"sharded {sync['pull_bytes']/1e6:.2f} MB vs replicated "
          f"{spec.replicated_pull_nbytes()/1e6:.2f} MB")
    if args.profile:
        split = profile_serve_loop(lambda st, _: epoch_fn(st, data),
                                   range(args.profile), carry=state)
        print(json.dumps({"profile_epochs": args.profile, **split}))


if __name__ == "__main__":
    main()
