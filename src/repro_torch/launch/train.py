#!/usr/bin/env python
"""LM training launcher (the port of ``src/repro/launch/train.py``): the
synthetic LM pipeline through :func:`repro_torch.train.make_train_step`,
with DIGEST pod sync, checkpoint resume and save.  Runs on the card by
default:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 20 --batch 4 --seq 1024

``--device cpu --smoke`` runs the reduced config on the CPU.
``--production-mesh`` trains over the reference's production mesh
(``launch.mesh.make_production_mesh``): a torchrun job of 256 ranks,
(16, 16) over ("data", "model"), or of 512 with ``--sync-mode digest
--n-pod 2``, (2, 16, 16) over ("pod", "data", "model"); any other world
size raises ValueError.

Over a mesh (the reference trains under ``axis_rules(mesh, {"embed":
"data"})``): under ``torchrun`` (``env://``) with ``--dist-backend``, the
ranks form a ("pod", "data", "model") mesh of ``--pod-axis`` x
``--data-axis`` x ``--model-axis``.  Each rank holds its blocks of the
train state (tensor parallelism over "model", the FSDP rule over
"data"), draws the single process's numbers (``sharding.init_sharded``)
and steps on its rows of every batch; ``--pod-axis`` above 1 is the
DIGEST pod form (``--sync-mode digest --n-pod`` the pod count, one pod a
"pod" block).  Each rank prints the bytes of parameters and of train
state it holds.  A checkpoint holds the whole state in the reference's
layout, gathered in rank order and written by rank 0 (pod 0's copy in
the pod form); a restore cuts it again, so a checkpoint written over a
mesh restores on one process and the other way round:

  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3-0.6b --data-axis 2 --model-axis 2 --dist-backend gloo

:func:`main` returns each step's seconds (host clock, from the end of
the step before: the batch's draw and upload, the step, its loss read
back, so the card has finished it, and the log line; they sum to the
loop's wall time) and its loss.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch.distributed as dist

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_arch, get_smoke_arch
from repro_torch.core import collectives
from repro_torch.data import make_lm_pipeline
from repro_torch.device import resolve_device
from repro_torch.distributed import (TRAIN_RULES, gather_whole, map_placed,
                                     mesh_sizes, placements, shard_params,
                                     train_state_specs)
from repro_torch.launch.mesh import (BACKENDS, close_distributed,
                                     init_distributed)
from repro_torch.launch.serve import tensor_bytes
from repro_torch.models.transformer import arch_specs
from repro_torch.nn import param_count
from repro_torch.train import TrainSettings, init_train_state, make_train_step


def state_specs(cfg) -> dict:
    """The whole train state's ParamSpec tree (its placement over a
    mesh)."""
    return train_state_specs(arch_specs(cfg), cfg.optimizer)


def whole_template(cfg, state: dict, mesh) -> dict:
    """Empty tensors of the whole state's shapes, on this rank's state's
    dtypes and devices: a checkpoint's restore template over a mesh."""
    return map_placed(lambda t, shape, pl: t.new_empty(shape), state,
                      placements(state_specs(cfg), mesh_sizes(mesh),
                                 TRAIN_RULES))


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
                    help="the reference's production mesh: 256 ranks "
                         "(16 x 16), 512 with --n-pod 2 (2 x 16 x 16); "
                         "needs --dist-backend")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--pod-axis", type=int, default=1,
                    help="mesh 'pod' size (the DIGEST pod form)")
    ap.add_argument("--data-axis", type=int, default=1,
                    help="mesh 'data' size (the batch and, by the FSDP "
                         "rule, the embed dims are split over it)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="mesh 'model' size (tensor parallelism)")
    ap.add_argument("--dist-backend", default=None, choices=BACKENDS,
                    help="join the torchrun job over this backend")
    args = ap.parse_args(argv)
    if args.production_mesh:
        if args.dist_backend is None:
            ap.error("--production-mesh needs --dist-backend (a torchrun "
                     "job of 256 ranks a pod)")
        if args.pod_axis * args.data_axis * args.model_axis > 1:
            ap.error("--production-mesh sets the mesh: leave --pod-axis / "
                     "--data-axis / --model-axis at 1")
        args.pod_axis = 2 if args.n_pod > 1 else 1
    if args.dist_backend is None and (
            args.pod_axis * args.data_axis * args.model_axis > 1):
        ap.error("--pod-axis / --data-axis / --model-axis need "
                 "--dist-backend")
    if args.pod_axis > 1 and (args.sync_mode != "digest"
                              or args.n_pod != args.pod_axis):
        ap.error("--pod-axis P is the digest pod form: --sync-mode digest "
                 "--n-pod P")
    mesh = None
    if args.dist_backend is not None:
        mesh, dev = init_distributed(args.dist_backend, args.device,
                                     data=args.data_axis, pod=args.pod_axis,
                                     model=args.model_axis,
                                     production=args.production_mesh)
    else:
        dev = resolve_device(args.device)
    try:
        return _train(args, dev, mesh)
    finally:
        if mesh is not None:
            mesh = None
            close_distributed()


def _train(args, dev, mesh) -> dict:
    cfg = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 512))
    settings = TrainSettings(
        sync_mode=args.sync_mode, n_pod=args.n_pod,
        sync_interval=args.sync_interval, total_steps=args.steps,
        warmup_steps=max(args.steps // 20, 2),
        pod_impl="shard_map" if args.pod_axis > 1 else "vmap")
    rank0 = mesh is None or dist.get_rank() == 0

    def log(*a, **kw):
        if rank0:
            print(*a, **kw)

    state = init_train_state(cfg, settings, device=dev, mesh=mesh)
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        if mesh is None:
            state, start = restore_checkpoint(args.ckpt_dir, state)
        else:
            state, start = restore_checkpoint(
                args.ckpt_dir, whole_template(cfg, state, mesh),
                sharding=lambda t: shard_params(t, state_specs(cfg), mesh,
                                                TRAIN_RULES))
        log(f"resumed from step {start}")
    step_fn = make_train_step(cfg, settings, mesh)
    data = make_lm_pipeline(cfg.vocab_size, args.batch, args.seq,
                            device=dev)
    n_params = param_count(arch_specs(cfg))
    where = "" if mesh is None else f" mesh={mesh_sizes(mesh)}"
    log(f"arch={cfg.name} params={n_params:,} device={dev}{where} "
        f"sync={args.sync_mode}/{args.sync_interval}")
    if mesh is not None:
        print(f"rank {dist.get_rank()}: {tensor_bytes(state['params'])} "
              f"bytes of params, {tensor_bytes(state)} bytes of train "
              f"state", flush=True)
    times, losses = [], []
    t0 = time.perf_counter()
    t_step = t0
    for i in range(args.steps):
        b = next(data)
        state, m = step_fn(state, {"tokens": b.tokens, "labels": b.labels,
                                   "mask": b.mask})
        losses.append(float(m["loss"]))
        if (i + 1) % args.log_every == 0:
            log(f"step {int(state['step']):5d} "
                f"loss={losses[-1]:.4f} "
                f"{(time.perf_counter()-t0)/(i+1):.3f}s/step", flush=True)
        t = time.perf_counter()
        times.append(t - t_step)
        t_step = t
    if args.ckpt_dir:
        whole = (state if mesh is None else
                 gather_whole(state, state_specs(cfg), mesh, TRAIN_RULES))
        if rank0:
            save_checkpoint(args.ckpt_dir, int(state["step"]), whole)
        del whole
        if mesh is not None:
            collectives.barrier()
        log(f"saved {args.ckpt_dir}")
    return {"step_s": times, "losses": losses, "state": state,
            "params": n_params}


if __name__ == "__main__":
    main()
