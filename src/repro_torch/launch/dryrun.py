"""The dry run (the port of ``src/repro/launch/dryrun.py``): one rank of
the production mesh runs the program it runs on the card, once, over
``meta`` tensors, and its per-card roofline terms for an NVIDIA H100 SXM5
come out of what the run dispatched.  Nothing is allocated and no card is
needed.

The reference lowers each case on 512 forced host devices and reads
XLA's cost and memory analyses and the HLO text.  Here the process is
rank ``--rank`` of a stand-in group of ``256 · pods`` ranks
(``launch.mesh.dry_group``), its state the rank's blocks of the
parameters, optimizer state and caches (``distributed.sharding``'s
placements) as meta tensors, and one pass counts, under a dispatch mode
(:class:`DryCounter`):

* ``flops_by_dtype``: ``torch.utils.flop_counter``'s formulas (matrix
  products, convolutions, attention) by the op's input dtype, plus the
  hand-written kernels' own counts (``kernels._build.DRY``: each
  wrapper's meta branch counts its kernel in the place of the launch).
  Elementwise work is not counted.
* ``hbm_bytes``: each device op that is not a view reads its tensor
  inputs and writes its outputs once (eager PyTorch launches each op on
  its own, so this is the traffic the card moves), plus the kernels'.
* ``device_ops``: those ops plus the kernel calls.
* ``mem_argument_bytes`` (the rank's state and batch) and
  ``mem_peak_bytes``: the largest live total of device storage over the
  step, storages counted from their creation to their release.
* the collective census of ``core.collectives``: calls and result bytes
  by op, and the bytes within a host of ``CARDS_PER_HOST`` cards, across
  hosts and across pods.

Eager code runs every layer, so one pass gives the true counts
(``cost_basis`` "eager"; the reference needs a second, unrolled
lowering).  The terms, from published peaks (``launch.mesh``): compute
``Σ_dtype flops / peak`` (fp32 products at the TF32 rate when
``torch.backends.cuda.matmul.allow_tf32`` is set, the kernels' fp32 FMAs
at the fp32 rate), memory ``hbm_bytes / HBM_BW``, collective
``intra_host / NVLINK_BW + inter_host / NET_BW``.  They are predictions
for one card, not measurements.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape all --multi-pod both [--out dryrun-qwen3.jsonl]

Cases: ``train`` is ``make_train_step`` over the production mesh (the
DIGEST pod form over "pod" with ``--sync-mode digest`` and two pods, at
its sync step; ``every_step`` data parallelism otherwise), ``prefill``
``forward`` through K6 (``attn_backend="kernel"``), ``decode`` / ``long``
``make_serve_step``.  The trainer places by ``sharding.TRAIN_RULES``
(FSDP) and takes no rules; serving places by ``--rules`` over
``sharding.DEFAULT_RULES`` (the port's decode has no FSDP form).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
import weakref
from typing import Any, Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ALIASES, ARCH_IDS, get_arch
from repro_torch.core import collectives
from repro_torch.distributed import sharding
from repro_torch.kernels import _build
from repro_torch.launch.mesh import (HBM_BW, NET_BW, NVLINK_BW, PEAK_FLOPS,
                                     dry_group, make_production_mesh)
from repro_torch.launch.specs import (SHAPES, abstract_from_specs,
                                      input_specs, serve_state_specs,
                                      shape_of, train_state_specs)
from repro_torch.models.transformer import arch_specs, forward
from repro_torch.train.trainer import (TrainSettings, make_serve_step,
                                       make_train_step)

Pytree = Any
aten = torch.ops.aten

# Ops that allocate without moving a byte.
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten.detach.default,
               aten.lift_fresh.default}


class DryCounter(TorchDispatchMode):
    """Counts what a run dispatches on ``device`` (module docstring):
    FLOPs by dtype, HBM bytes, device ops, and the live device storage
    (``peak``: its largest total, beside the storages registered by
    :meth:`hold`, the arguments)."""

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device = device
        self.flops: dict = {}
        self.hbm_bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._seen: set = set()

    def hold(self, tree: Pytree) -> int:
        """Register ``tree``'s device tensors as present before the run;
        returns their bytes (each storage once)."""
        total = 0
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor) and t.device.type == self.device:
                st = t.untyped_storage()
                if id(st) not in self._seen:
                    self._seen.add(id(st))
                    total += st.nbytes()
        return total

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out                        # collectives: their census
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not any(t.device.type == self.device for t in ins + outs):
            return out
        for t in outs:
            if t.device.type == self.device:
                self._track(t)
        if func.is_view or func in _NO_TRAFFIC:
            return out
        self.ops += 1
        self.hbm_bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            dtype = str(ins[0].dtype).split(".")[-1] if ins else "float32"
            self.flops[dtype] = (self.flops.get(dtype, 0)
                                 + int(count(*args, **kwargs, out_val=out)))
        return out


def compute_term(flops: dict, kernel_flops: dict, tf32: bool) -> float:
    """Seconds at the published peaks: products of the op counts at their
    dtype's rate (fp32 at TF32's when ``tf32``), the kernels' at their
    arithmetic's own (their fp32 is plain FMA)."""
    def rate(dtype, tensor_cores):
        if dtype == "float32" and tensor_cores and tf32:
            return PEAK_FLOPS["tf32"]
        return PEAK_FLOPS.get(dtype, PEAK_FLOPS["float32"])
    return (sum(n / rate(d, True) for d, n in flops.items())
            + sum(n / rate(d, False) for d, n in kernel_flops.items()))


def measure(run: Callable[[], Any], args: Pytree,
            params: Optional[Pytree] = None) -> dict:
    """Run ``run()`` (over the meta tensors of ``args``) once under a
    :class:`DryCounter` with the collective census and the kernels' dry
    ledger cleared first; returns the counts and the three terms."""
    collectives.reset_collectives()
    _build.reset_dry()
    counter = DryCounter("meta")
    arg_bytes = counter.hold(args)
    t0 = time.perf_counter()
    with counter:
        out = run()
    t_dry = time.perf_counter() - t0
    del out
    kernels = {k: dict(v) for k, v in _build.DRY.items()}
    kflops: dict = {}
    for rec in kernels.values():
        for d, n in rec["flops_by_dtype"].items():
            kflops[d] = kflops.get(d, 0) + n
    flops = dict(counter.flops)
    for d, n in kflops.items():
        flops[d] = flops.get(d, 0) + n
    hbm = counter.hbm_bytes + sum(r["bytes"] for r in kernels.values())
    spans = dict(collectives.COLLECTIVE_SPANS)
    per_op = dict(collectives.COLLECTIVE_BYTES)
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    rec = {
        "cost_basis": "eager",
        "flops": sum(flops.values()),
        "flops_by_dtype": flops,
        "elementwise_flops": "not counted",
        "hbm_bytes": hbm,
        "device_ops": counter.ops + sum(r["calls"]
                                        for r in kernels.values()),
        "kernels": kernels,
        "mem_argument_bytes": arg_bytes,
        "mem_peak_bytes": arg_bytes + counter.peak,
        "collective_per_op": per_op,
        "collective_counts": dict(collectives.COLLECTIVES),
        "collective_bytes": sum(per_op.values()),
        "intra_host_bytes": spans.get("intra_host", 0),
        "inter_host_bytes": spans.get("inter_host", 0),
        "inter_pod_bytes": spans.get("inter_pod", 0),
        "tf32": tf32,
        "compute_term_s": compute_term(counter.flops, kflops, tf32),
        "memory_term_s": hbm / HBM_BW,
        "collective_term_s": (spans.get("intra_host", 0) / NVLINK_BW
                              + spans.get("inter_host", 0) / NET_BW),
        "t_dry_s": round(t_dry, 2),
    }
    if params is not None:
        rec["mem_param_bytes"] = DryCounter().hold(params)
    return rec


def _pod_local(state: Pytree) -> Pytree:
    """A rank's blocks of a "pod_stack" state (1 a rank along the leading
    dim) as the mesh pod form holds them: that dim dropped."""
    if isinstance(state, dict):
        return {k: _pod_local(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_pod_local(v) for v in state]
    return state[0]


def train_settings(pods: int, sync_mode: str = "digest") -> TrainSettings:
    """A train case's settings: the DIGEST pod form over ``pods`` > 1
    pods (one rank a pod, ``pod_impl="shard_map"``) under ``sync_mode``
    "digest", else ``every_step``; interval 10 of 10 000 steps."""
    digest = sync_mode == "digest" and pods > 1
    return TrainSettings(sync_mode="digest" if digest else "every_step",
                         n_pod=pods if digest else 1, sync_interval=10,
                         pod_impl="shard_map", total_steps=10_000)


def lm_case(cfg, shape, mesh, rules: Optional[dict] = None,
            sync_mode: str = "digest") -> dict:
    """One LM case over ``mesh`` (None: one device): ``shape`` a name of
    :data:`SHAPES` or such a dict; its :func:`measure` record."""
    kind = shape_of(shape)["kind"]
    pods = sharding.mesh_sizes(mesh).get("pod", 1)
    batch = abstract_from_specs(input_specs(cfg, shape))
    if kind == "train":
        if rules:
            raise ValueError(f"train cases place by sharding.TRAIN_RULES "
                             f"({sharding.TRAIN_RULES}); the port's trainer "
                             f"takes no rules, got {rules}")
        settings = train_settings(pods, sync_mode)
        digest = settings.sync_mode == "digest"
        step_fn = make_train_step(cfg, settings, mesh)
        state = abstract_from_specs(
            train_state_specs(cfg, settings.n_pod, digest), mesh,
            sharding.TRAIN_RULES)
        if digest:
            for key in ("params", "opt_state"):
                state[key] = _pod_local(state[key])
        # The digest form at its sync step (the pods' parameters
        # gathered and averaged); every_step at step 0.
        step = settings.sync_interval - 1 if digest else 0
        state["step"] = torch.tensor(step, dtype=torch.int32)
        out = measure(lambda: step_fn(state, batch), (state, batch),
                      state["params"])
        out.update(sync_mode=settings.sync_mode, step=step)
        return out
    cfg = dataclasses.replace(cfg, attn_backend="kernel")
    if kind == "prefill":
        params = abstract_from_specs(arch_specs(cfg), mesh, rules)

        def run():
            with torch.no_grad():
                return forward(cfg, params, batch["tokens"],
                               batch.get("vision"), mesh=mesh, rules=rules)
        return measure(run, (params, batch), params)
    state = abstract_from_specs(serve_state_specs(cfg, shape), mesh, rules)
    serve = make_serve_step(cfg, long=kind == "decode_long", mesh=mesh,
                            rules=rules)

    def run():
        with torch.no_grad():
            return serve(state["params"], state["cache"], batch["tokens"])
    return measure(run, (state, batch), state["params"])


def dryrun_case(arch: str, shape_name: str, multi_pod: bool,
                rules_override: Optional[dict] = None,
                sync_mode: str = "digest",
                cfg_overrides: Optional[dict] = None,
                rank: int = 0) -> dict:
    """One (arch × shape × mesh) case as rank ``rank`` of the production
    mesh's stand-in group; its record."""
    cfg = get_arch(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    pods = 2 if multi_pod else 1
    world = 256 * pods
    with dry_group(world, rank):
        mesh = make_production_mesh(multi_pod=multi_pod)
        try:
            rec = lm_case(cfg, shape_name, mesh, rules_override or None,
                          sync_mode)
        finally:
            del mesh
    return {"arch": cfg.name, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16", "chips": world,
            "rank": rank, **rec}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all",
                    choices=list(SHAPES) + ["all"])
    ap.add_argument("--multi-pod", dest="multi_pod", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--sync-mode", default="digest",
                    choices=["digest", "every_step"])
    ap.add_argument("--rules", default="{}",
                    help='JSON overrides of the serving rules, e.g. '
                         '{"heads":null} (train cases take none)')
    ap.add_argument("--cfg", default="{}",
                    help='JSON ArchConfig overrides, e.g. '
                         '{"remat":false,"param_dtype":"bfloat16"}')
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the stand-in group this process is")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--subprocess-each", action="store_true",
                    help="isolate every case in its own process")
    args = ap.parse_args(argv)

    archs = ([ALIASES.get(args.arch, args.arch)] if args.arch != "all"
             else ARCH_IDS)
    shapes = [args.shape] if args.shape != "all" else list(SHAPES)
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]
    rules_override = json.loads(args.rules)
    cfg_overrides = {k: (tuple(v) if isinstance(v, list) else v)
                     for k, v in json.loads(args.cfg).items()}

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                if args.subprocess_each:
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape,
                           "--multi-pod", "multi" if mp else "single",
                           "--sync-mode", args.sync_mode,
                           "--rules", args.rules, "--cfg", args.cfg,
                           "--rank", str(args.rank)]
                    if args.out:
                        cmd += ["--out", args.out]
                    failures += subprocess.call(cmd) != 0
                    continue
                try:
                    res = dryrun_case(arch, shape, mp,
                                      rules_override=rules_override,
                                      sync_mode=args.sync_mode,
                                      cfg_overrides=cfg_overrides,
                                      rank=args.rank)
                    res["rules_override"] = rules_override
                    res["cfg_overrides"] = cfg_overrides
                    line = json.dumps(res)
                    print(line, flush=True)
                    if args.out:
                        with open(args.out, "a") as f:
                            f.write(line + "\n")
                except Exception:
                    failures += 1
                    print(f"FAILED {arch} {shape} multi_pod={mp}",
                          file=sys.stderr)
                    traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
