"""GNN dry run (the port of ``src/repro/launch/dryrun_gnn.py``): DIGEST's
own workload (Algorithm 1) as one rank of the production group runs it,
over ``meta`` tensors, with its census and H100 roofline terms
(``launch.dryrun``).  Nothing is allocated and no card is needed.

The graph is the reference's abstract one (:func:`abstract_gnn_case`:
its geometry, no host partition build), under the port's data keys.
``--pull collective`` runs the mesh epoch (``core.digest.make_epoch_fn``
with ``pull_mode="collective"``) on this rank's k parts
(``--parts-per-device``) and owner shards: the ragged all-to-all pull
over "data" and, on two pods (``--multi-pod`` / ``--pods``), the
point-to-point hop over "pod", shard-local pushes.  The stand-in group
has the production mesh's ``256 · pods`` ranks, laid out as ("pod",
"data") = (pods, 256): the port's GNN paths make every rank a block and
refuse a "model" dimension, where the reference repeats the epoch over
its 16-wide "model" axis, so here M = k · 256 · pods.  ``--pull gather``
runs the single-device epoch over the same M parts (one card, no group).

The epoch is round 1 with ``pull_on_first_epoch``, so it pulls and
pushes.  The collective epoch must carry zero ``all_gather``s
(``launch.census_check``)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun_gnn --multi-pod \\
      --pull collective [--precision int8 --parts-per-device 2] \\
      [--predictor ema] --out census-multipod.jsonl
  PYTHONPATH=src python -m repro_torch.launch.census_check \\
      census-multipod.jsonl --records 3
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch.core import (HaloPrecision, PredictorConfig, TrainSettings,
                              init_state, make_epoch_fn)
from repro_torch.core.digest import shard_data, shard_state
from repro_torch.launch.dryrun import measure
from repro_torch.launch.mesh import POD_SHAPE, dry_group, make_mesh
from repro_torch.models.gnn import GNNConfig, gnn_specs
from repro_torch.nn import abstract_params
from repro_torch.optim import adam


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_gnn_case(num_nodes: int, num_parts: int, feat: int,
                      hidden: int, classes: int, deg_in: int, deg_out: int,
                      halo_frac: float, boundary_frac: float = 0.5,
                      chunk_rows: int = 512):
    """Meta stand-ins of a :func:`core.digest.prepare_graph_data` dict of
    a partitioned graph, at the reference's geometry (no host build: the
    partitioner would dominate; the shapes are what the epoch needs).
    ``boundary_frac`` models |boundary| / N (the compact store holds only
    those rows).  The port's own keys: the transposed ELLs ``in_pos`` /
    ``out_pos`` of the struct, whose widths are data-dependent (a row's
    most references), taken as the ELL's degree (every row referenced
    ``deg`` times); the worklist at its widest (every chunk occupied).
    Returns ``(data, S, H, rows, slots)``."""
    S = num_nodes // num_parts
    H = int(S * halo_frac)
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    rows = ((num_nodes + 1 + num_parts - 1) // num_parts) * num_parts
    shard_rows = ((int(num_nodes * boundary_frac) // num_parts + 1 + 7)
                  // 8) * 8
    slots = num_parts * shard_rows
    K = max((H + num_parts - 1) // num_parts, 1)
    n_blocks = max(-(-S // 128), 1)
    n_chunks = max(-(-(H + 1) // chunk_rows), 1)
    M = num_parts
    data = {
        "x_global": _meta((rows, feat), f32),
        "struct": {"in_nbr": _meta((M, S, deg_in), i32),
                   "in_wts": _meta((M, S, deg_in), f32),
                   "out_nbr": _meta((M, S, deg_out), i32),
                   "out_wts": _meta((M, S, deg_out), f32),
                   "wl_ids": _meta((M, n_blocks, n_chunks), i32),
                   "wl_cnt": _meta((M, n_blocks), i32),
                   "in_pos": _meta((M, S + 1, deg_in), i32),
                   "out_pos": _meta((M, H + 1, deg_out), i32)},
        "local_ids": _meta((M, S), i32),
        "local_valid": _meta((M, S), b8),
        "halo_ids": _meta((M, H), i32),
        "halo_valid": _meta((M, H), b8),
        "halo_ids_x": _meta((M, H + 1), i32),
        "local_slots": _meta((M, S), i32),
        "local_boundary": _meta((M, S), b8),
        "halo_slots": _meta((M, H), i32),
        "store_ids": _meta((slots,), i32),
        "sentinel_slots": _meta((M,), i32),
        "pull_send": _meta((M, M, K), i32),
        "pull_recv": _meta((M, M, K), i32),
        "labels": _meta((M, S), i32),
        "train_mask": _meta((M, S), b8),
        "val_mask": _meta((M, S), b8),
        "test_mask": _meta((M, S), b8),
        # full-graph view (eval only; not used by the epoch fn)
        "full_struct": {"in_nbr": _meta((1, 8, 1), i32),
                        "in_wts": _meta((1, 8, 1), f32),
                        "out_nbr": _meta((1, 8, 1), i32),
                        "out_wts": _meta((1, 8, 1), f32),
                        "wl_ids": _meta((1, 1, 1), i32),
                        "wl_cnt": _meta((1, 1), i32),
                        "in_pos": _meta((1, 9, 1), i32),
                        "out_pos": _meta((1, 9, 1), i32)},
        "full_ids": _meta((1, 8), i32),
        "full_valid": _meta((1, 8), b8),
        "full_labels": _meta((1, 8), i32),
        "full_train_mask": _meta((1, 8), b8),
        "full_val_mask": _meta((1, 8), b8),
        "full_test_mask": _meta((1, 8), b8),
    }
    return data, S, H, rows, slots


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--nodes", type=int, default=1_048_576)
    ap.add_argument("--feat", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--deg", type=int, default=16)
    ap.add_argument("--precision", default="fp32",
                    choices=("fp32", "bf16", "int8"))
    ap.add_argument("--pull", default="gather",
                    choices=("gather", "collective"),
                    help="collective = the mesh epoch (all-to-all pull, "
                         "the pod hop with --multi-pod / --pods, "
                         "shard-local pushes); gather = the one-card "
                         "epoch over the same parts")
    ap.add_argument("--pods", type=int, default=None,
                    help="pods of the production mesh (default: 2 with "
                         "--multi-pod, else 1); 256 ranks a pod")
    ap.add_argument("--parts-per-device", type=int, default=1,
                    help="k subgraphs / owner shards a rank (M = k x "
                         "ranks)")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "jnp", "pallas_stream", "pallas_skip"),
                    help="aggregation backend: 'auto' counts the kernels "
                         "the card runs (K1-K4), 'jnp' the plain oracles")
    ap.add_argument("--stream-chunk-rows", type=int, default=512,
                    help="slab rows per streamed chunk (also the abstract "
                         "worklist geometry)")
    ap.add_argument("--resident-max-bytes", type=int, default=None,
                    help="stripe budget above which halo_spmm streams "
                         "(default: the kernels' RESIDENT_STRIPE_MAX_BYTES)")
    ap.add_argument("--skip-occupancy-max", type=float, default=None,
                    help="occupancy threshold of the chunk-skipping stream "
                         "(default: the kernels' SKIP_OCCUPANCY_MAX)")
    ap.add_argument("--halo-occupancy", type=float, default=None,
                    help="assumed (row-block x chunk) occupancy of the "
                         "abstract worklist; at or below the threshold "
                         "the ladder selects the skip stream (K4)")
    ap.add_argument("--order", default=None, choices=("none", "rcm"),
                    help="modelled local-row layout: sets the default "
                         "--halo-occupancy (none=0.85, rcm=0.40, the "
                         "reference's measured regimes)")
    ap.add_argument("--predictor", default="none",
                    choices=("none", "delta", "ema"),
                    help="SAT predictor: its pstore rides the store's "
                         "exchange (one all_to_all more a store tensor)")
    ap.add_argument("--predictor-gamma", type=float, default=1.0)
    ap.add_argument("--predictor-beta", type=float, default=0.5)
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the stand-in group this process is")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.halo_occupancy is None and args.order is not None:
        args.halo_occupancy = {"none": 0.85, "rcm": 0.40}[args.order]
    if args.pods is None:
        args.pods = 2 if args.multi_pod else 1
    if args.pods < 1 or (args.multi_pod and args.pods < 2):
        raise ValueError(f"pods={args.pods} contradicts multi_pod="
                         f"{args.multi_pod}")
    return args


def gnn_case(args) -> dict:
    """The epoch's record for parsed :func:`parse_args` flags."""
    data_axis = POD_SHAPE[0] * POD_SHAPE[1]
    world = data_axis * args.pods
    num_parts = args.parts_per_device * world
    cfg = GNNConfig(model="gcn", num_layers=3, in_dim=args.feat,
                    hidden_dim=args.hidden, num_classes=64,
                    backend=args.backend,
                    stream_chunk_rows=args.stream_chunk_rows,
                    resident_max_bytes=args.resident_max_bytes,
                    skip_occupancy_max=args.skip_occupancy_max,
                    halo_occupancy=args.halo_occupancy)
    opt = adam(5e-3)
    pcfg = PredictorConfig(kind=args.predictor, gamma=args.predictor_gamma,
                           beta=args.predictor_beta)
    settings = TrainSettings(sync_interval=10, mode="digest",
                             pull_mode=args.pull,
                             precision=HaloPrecision(args.precision),
                             predictor=pcfg, pull_on_first_epoch=True)
    data, S, H, rows, slots = abstract_gnn_case(
        args.nodes, num_parts, args.feat, args.hidden, 64, args.deg,
        args.deg // 2, halo_frac=1.0, chunk_rows=args.stream_chunk_rows)
    state = init_state(cfg, opt, data, precision=settings.precision,
                       predictor=pcfg, params=abstract_params(gnn_specs(cfg)))

    def run_epoch(mesh):
        epoch_fn = make_epoch_fn(cfg, opt, settings, mesh)
        st = state if mesh is None else shard_state(state, mesh)
        dt = data if mesh is None else shard_data(data, mesh)
        return measure(lambda: epoch_fn(st, dt), (st, dt), st["params"])

    if args.pull == "collective":
        with dry_group(world, args.rank):
            mesh = make_mesh(data_axis, args.pods)
            try:
                rec = run_epoch(mesh)
            finally:
                del mesh
        exchange = {"pod": args.pods, "data": data_axis} if args.pods > 1 \
            else {"data": data_axis}
    else:
        rec = run_epoch(None)
        exchange = {}
    mesh_name = "x".join(str(n) for n in
                         ((args.pods,) if args.pods > 1 else ()) + POD_SHAPE)
    if args.pull != "collective":
        mesh_name = "1"
    return {
        "case": "digest_gnn_epoch", "mesh": mesh_name,
        "chips": world if args.pull == "collective" else 1,
        "exchange_mesh": exchange, "rank": args.rank,
        "nodes": args.nodes, "parts": num_parts, "S": S, "H": H,
        "hidden": args.hidden, "precision": args.precision,
        "pull_mode": args.pull, "parts_per_device": args.parts_per_device,
        "store_slots": slots, "shard_rows": slots // num_parts,
        "stream_chunk_rows": args.stream_chunk_rows,
        "halo_occupancy": args.halo_occupancy, "order": args.order,
        "predictor": args.predictor, "backend": args.backend,
        "round": 1, "pull": True, "push": True,
        **rec,
        "collective_inter_pod_bytes": rec["inter_pod_bytes"],
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    out = gnn_case(args)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
