#!/usr/bin/env python
"""DIGEST GNN training launcher (PyTorch port of ``repro.launch.train_gnn``).

By default the M subgraphs run on one card
(``repro_torch.core.digest.make_epoch_fn``) and PULL is the dense gather.
Runs on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.train_gnn \
      --dataset papers-sim --scale 1.0 --parts 8 --order rcm \
      --stream-chunk-rows 256 --hidden 128 --epochs 40

``--device cpu`` runs the kernels' plain PyTorch versions instead.
``--profile N`` traces N more epochs with ``torch.profiler`` and prints
the device's busy share of them, the top device ops and the program's
spans (``repro_torch.trace``).
Weights are drawn from ``torch.Generator`` seed 0.

``--predictor delta|ema`` turns on SAT prediction, the ``--fault-*``
rates and ``--max-staleness`` the fault schedule and its watchdog, and
``--ckpt-dir``/``--ckpt-every``/``--resume`` checkpoints and resume:

  PYTHONPATH=src python -m repro_torch.launch.train_gnn --device cpu \
      --scale 0.1 --parts 4 --epochs 8 --predictor ema \
      --fault-drop-rate 0.4 --max-staleness 4 \
      --ckpt-dir /tmp/ck --ckpt-every 3      # then: --epochs 12 --resume

``--sampling`` trains mini-batches instead (``--fanout`` neighbours a
row, ``--batch-seeds`` seeds a part, ``--estimator cv|plain``), with the
same faults, checkpoints and final lines; ``--epochs`` then counts steps.

``--pull collective`` spreads the M subgraphs over the ranks ``torchrun``
starts, k = M / ranks each, on a ("data",) mesh of ``--data-axis`` ranks,
or ("pod", "data") with ``--pods`` > 1, over ``--dist-backend nccl``
(one card a rank) or ``gloo`` (ranks may share a card, or run on the
CPU); every rank builds the same partition, and rank 0 prints:

  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train_gnn \
      --device cpu --pull collective --data-axis 2 --dist-backend gloo \
      --scale 0.1 --parts 4 --epochs 4
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint
from repro_torch.core import (HaloPrecision, HaloSpec, PredictorConfig,
                              TrainSettings, check_collective_geometry,
                              evaluate, faults, gather_state,
                              init_sampled_state, init_state, make_epoch_fn,
                              make_sampled_epoch_fn, prepare_graph_data,
                              shard_data, shard_state)
from repro_torch.core.digest import sampled_advance, save_state
from repro_torch.core.halo_exchange import part_slice
from repro_torch.device import resolve_device, synchronize
from repro_torch.graph import build_sampler, make_dataset
from repro_torch.launch.mesh import (BACKENDS, close_distributed,
                                     init_distributed)
from repro_torch.launch.serving_driver import profile_serve_loop
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim import adam


def _push_ok(schedule, rnd: int, num_parts: int, dev, parts=slice(None)):
    ok = (schedule.push_ok(rnd, num_parts) if schedule is not None
          else np.ones(num_parts, dtype=bool))
    return torch.from_numpy(ok[parts]).to(dev)


def _maybe_resume(args, log) -> int:
    """Epoch to start from: the newest valid checkpoint's, or 0."""
    if not args.resume:
        return 0
    step = checkpoint.latest_step(args.ckpt_dir)
    if step is None:
        log(f"resume: no valid checkpoint in {args.ckpt_dir}, "
            f"starting fresh")
        return 0
    return int(step)


def _restore(args, state, place, log):
    state, step = checkpoint.restore_checkpoint(args.ckpt_dir, state,
                                                sharding=place)
    log(f"resume: restored step {step} from {args.ckpt_dir}")
    return state, step


def _maybe_ckpt(args, step: int, state, mesh) -> None:
    if args.ckpt_dir and args.ckpt_every and step % args.ckpt_every == 0:
        save_state(args.ckpt_dir, step, state, mesh)


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
                    help="PULL transport: 'gather' runs every subgraph on "
                         "one device; 'collective' spreads them over the "
                         "torchrun ranks (all-to-all pulls of the "
                         "referenced rows, shard-local pushes); needs "
                         "--parts to be a multiple of pods x data-axis")
    ap.add_argument("--data-axis", type=int, default=None,
                    help="mesh data-axis size (default: ranks / pods)")
    ap.add_argument("--pods", type=int, default=1,
                    help="mesh pod-axis size; > 1 builds the ('pod', "
                         "'data') mesh, whose pull is an intra-pod "
                         "all-to-all then one exchange between pods")
    ap.add_argument("--dist-backend", default=None, choices=BACKENDS,
                    help="torch.distributed backend of --pull collective: "
                         "nccl (one card a rank) or gloo (host memory; "
                         "ranks may share a card or run on the CPU)")
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
    ap.add_argument("--sampling", action="store_true",
                    help="mini-batch sampled training: fanout-bounded "
                         "neighbour sampling with control variates (the "
                         "unsampled neighbours read the last step's "
                         "representations, the halo the stale store); "
                         "--epochs then counts optimizer steps")
    ap.add_argument("--fanout", type=int, default=5,
                    help="sampled in-neighbours a row (rows with deg <= "
                         "fanout aggregate exactly)")
    ap.add_argument("--batch-seeds", type=int, default=512,
                    help="training seed rows a subgraph a step")
    ap.add_argument("--estimator", default="cv", choices=("cv", "plain"),
                    help="'cv' = VR-GCN control variates over the "
                         "history; 'plain' = scaled sampling alone (the "
                         "variance baseline)")
    ap.add_argument("--predictor", default="none",
                    choices=("none", "delta", "ema"),
                    help="SAT prediction: serve dequant(store) + "
                         "gamma*dequant(pstore), the pstore carrying each "
                         "row's last-sync delta ('delta') or its beta-EMA "
                         "('ema'); 'none' runs the predictor-free program")
    ap.add_argument("--predictor-gamma", type=float, default=1.0,
                    help="pull-time coefficient gamma (1.0 with 'delta' = "
                         "linear extrapolation)")
    ap.add_argument("--predictor-beta", type=float, default=0.5,
                    help="EMA weight of the newest delta")
    ap.add_argument("--fault-crash-rate", type=float, default=0.0,
                    help="per-(round, part) probability that the part's "
                         "worker crashes (its pushes are lost for "
                         "crash_rounds rounds; the store keeps its last "
                         "good rows)")
    ap.add_argument("--fault-drop-rate", type=float, default=0.0,
                    help="probability that a part's push is dropped")
    ap.add_argument("--fault-corrupt-rate", type=float, default=0.0,
                    help="probability that a push is corrupted in flight "
                         "and rejected by its CRC (acts as a drop)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault schedule (each decision is a "
                         "function of (seed, class, round, part))")
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="watchdog: force the push of a part whose last "
                         "accepted push is this many rounds old")
    ap.add_argument("--ckpt-dir", default=None,
                    help="directory for checksummed checkpoints of the "
                         "whole training state")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N epochs (0 = never)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest valid checkpoint of "
                         "--ckpt-dir (corrupt or partial ones are skipped) "
                         "and continue to --epochs")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace N more epochs with torch.profiler (card "
                         "only) and print the device's busy share")
    args = ap.parse_args(argv)
    if args.profile and args.device == "cpu":
        ap.error("--profile measures the card; it needs a CUDA device")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")
    mesh = None
    if args.pull == "collective":
        if args.dist_backend is None:
            ap.error("--pull collective needs --dist-backend")
        mesh, dev = init_distributed(args.dist_backend, args.device,
                                     data=args.data_axis, pod=args.pods)
    else:
        dev = resolve_device(args.device)
    try:
        _train(args, dev, mesh)
    finally:
        if mesh is not None:
            mesh = None
            close_distributed()


def _train(args, dev, mesh) -> None:
    rank0 = mesh is None or dist.get_rank() == 0

    def log(*a, **kw):
        if rank0:
            print(*a, **kw)

    g = make_dataset(args.dataset, scale=args.scale)
    t_part = time.perf_counter()
    data = prepare_graph_data(g, args.parts, halo_weight=args.halo_weight,
                              stream_chunk_rows=args.stream_chunk_rows,
                              order=args.order, device=dev)
    t_part = time.perf_counter() - t_part
    log(f"partition: {args.parts} parts, order={args.order}, "
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
    predictor = PredictorConfig(kind=args.predictor,
                                gamma=args.predictor_gamma,
                                beta=args.predictor_beta)
    settings = TrainSettings(
        sync_interval=args.interval, mode="digest", pull_mode=args.pull,
        precision=HaloPrecision(args.precision,
                                error_feedback=args.error_feedback),
        max_staleness=args.max_staleness, predictor=predictor,
        sample_estimator=args.estimator)
    if predictor.enabled:
        log(f"predictor: kind={predictor.kind} gamma={predictor.gamma} "
            f"beta={predictor.beta}")
    schedule = faults.check_schedule(faults.FaultConfig(
        seed=args.fault_seed, crash_rate=args.fault_crash_rate,
        drop_push_rate=args.fault_drop_rate,
        corrupt_rate=args.fault_corrupt_rate))
    fault_aware = schedule is not None or args.max_staleness is not None
    if schedule is not None:
        log(f"faults: crash={args.fault_crash_rate} "
            f"drop={args.fault_drop_rate} "
            f"corrupt={args.fault_corrupt_rate} seed={args.fault_seed} "
            f"max_staleness={args.max_staleness}")
    edata, parts, place = data, slice(None), None
    if mesh is not None:
        ppd = check_collective_geometry(data, mesh)
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        log(f"collective mode: {ppd} subgraph(s)/owner shard(s) per "
            f"device over mesh {shape} ({args.dist_backend}, {dev})")
        edata = shard_data(data, mesh)
        parts = part_slice(args.parts, mesh)

        def place(tree):
            return shard_state(tree, mesh)
    if args.sampling:
        sampler = build_sampler(data, args.fanout, args.batch_seeds)
        log(f"sampling: fanout={args.fanout} (max in-degree "
            f"{sampler.max_in_degree}), batch_seeds={args.batch_seeds}, "
            f"estimator={args.estimator}")
        advance = sampled_advance(
            make_sampled_epoch_fn(cfg, opt, settings, mesh), sampler, edata,
            mesh)
        state = init_sampled_state(cfg, opt, data,
                                   precision=settings.precision,
                                   predictor=predictor)
    else:
        epoch_fn = make_epoch_fn(cfg, opt, settings, mesh)

        def advance(st, _):
            return epoch_fn(st, edata)

        state = init_state(cfg, opt, data, precision=settings.precision,
                           predictor=predictor)
    if fault_aware:
        state = faults.attach_fault_state(state, args.parts)
    start = _maybe_resume(args, log)
    if start:
        state, _ = _restore(args, state, place, log)
    elif place is not None:
        state = place(state)
    t0 = time.perf_counter()
    m = {"loss": float("nan")}
    for e in range(start, args.epochs):
        if fault_aware:
            state["push_ok"] = _push_ok(schedule, e + 1, args.parts, dev,
                                        parts)
        state, m = advance(state, e)
        _maybe_ckpt(args, e + 1, state, mesh)
    synchronize(state)
    elapsed = time.perf_counter() - t0
    if fault_aware:
        last = (state if mesh is None
                else gather_state(state, mesh))["last_push_round"]
        age = state["epoch"] - last.cpu().numpy()
        log(f"fault staleness: max push age {int(age.max())} round(s) "
            f"(bound {args.max_staleness})")
    ev = evaluate(cfg, state["params"], data)
    sp = data["_sp"]
    spec = HaloSpec.from_partitions(sp, cfg.hidden_dim, cfg.num_layers,
                                    settings.precision)
    sync = spec.comm_bytes(sp.pull_rows(), sp.push_rows())
    wl = data["_worklist"]
    where = (f"device={dev}" if mesh is None else
             f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    log(f"{where} epochs={args.epochs} "
        f"loss={float(m['loss']):.4f} val_f1={float(ev['val_f1']):.4f} "
        f"test_f1={float(ev['test_f1']):.4f} "
        f"({elapsed / max(args.epochs - start, 1):.3f}s/epoch)")
    log(f"halo worklist: {wl.visited_chunks}/{wl.total_pairs} "
        f"(row-block x chunk) pairs occupied "
        f"({100 * wl.occupancy:.1f}%; chunk_rows={wl.chunk_rows})")
    log(f"store: {spec.store_nbytes()/1e6:.2f} MB total, "
        f"{spec.shard_nbytes()/1e6:.2f} MB/shard; pull/sync: "
        f"sharded {sync['pull_bytes']/1e6:.2f} MB vs replicated "
        f"{spec.replicated_pull_nbytes()/1e6:.2f} MB")
    if mesh is not None:
        wire = spec.collective_pull_nbytes(int(data["pull_send"].shape[2]))
        log(f"collective pull: {wire/1e6:.2f} MB on the wire a pull "
            f"(M x M x K padded rows)")
    if args.profile:
        split = profile_serve_loop(
            advance, range(args.epochs, args.epochs + args.profile),
            carry=state)
        log(json.dumps({"profile_epochs": args.profile, **split}))


if __name__ == "__main__":
    main()
