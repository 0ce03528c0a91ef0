"""Spawned ranks for the port's mesh tests (``tests/test_torch_collective.py``,
``tests/test_torch_serving.py``, ``tests/test_torch_checkpoint.py``,
``tests/test_torch_dryrun.py`` and others); this module holds their jobs
and no test of its own.

:func:`spawn` starts ``world`` ranks with ``torch.multiprocessing`` (the
``spawn`` method), joins them into a ``gloo`` process group through a
file store and runs one job on each; a rank that raises fails the spawn.
Each job runs its port-against-port checks inside the ranks (the
collective path against the single-process path computed in the same
rank) and returns what the calling test holds against the reference.
This module imports no JAX, so the ranks start quickly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# The training graph: flickr-sim at scale 0.15 (seed 1), 4 parts, 3
# layers of width 16 (2 GAT heads), interval 2 (pushes at r = 1, 3, 5,
# pulls at r = 2, 4, 6), 6 epochs, adam(5e-3).
PARTS = 4
EPOCHS = 6
SAMPLED_STEPS = 4
FANOUT = 3
SEEDS = 64
LR = 5e-3
FAULTS = dict(seed=3, drop_push_rate=0.4)
MAX_STALENESS = 3


def spawn(job: str, world: int, **kw) -> list:
    """Run ``job`` (a function of this module, ``job(mesh_world, **kw)``)
    on ``world`` gloo ranks; returns each rank's result."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(job, world, tmp, kw), nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _rank(rank: int, job: str, world: int, tmp: str, kw: dict) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank)
    try:
        out = globals()[job](world, **kw)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy() if isinstance(tree, torch.Tensor) \
        else tree


def _capture(base):
    """``base`` that also keeps its last update's mean gradient."""
    from repro_torch.optim import Optimizer

    def init(p):
        return {"opt": base.init(p), "grads": p}

    def update(g, s, p, step):
        new_p, new_s = base.update(g, s["opt"], p, step)
        return new_p, {"opt": new_s, "grads": g}

    return Optimizer("capture", init, update)


def train_graph():
    from repro_torch.core import digest
    from repro_torch.graph import make_dataset
    g = make_dataset("flickr-sim", scale=0.15, seed=1)
    return g, digest.prepare_graph_data(g, PARTS, seed=0, device="cpu")


def train_cfg(g, model: str):
    from repro_torch.models.gnn import GNNConfig
    return GNNConfig(model=model, num_layers=3, in_dim=g.features.shape[1],
                     hidden_dim=16, num_classes=int(g.labels.max()) + 1,
                     heads=2)


def train_settings(storage="fp32", ef=False, predictor="none", **kw):
    from repro_torch.core.digest import TrainSettings
    from repro_torch.core.halo_exchange import HaloPrecision
    from repro_torch.core.predictor import PredictorConfig
    return TrainSettings(sync_interval=2,
                         precision=HaloPrecision(storage, ef),
                         predictor=PredictorConfig(predictor), **kw)


# Collective training runs held against the single-process run: name →
# (model, settings keywords, sampled).
RUNS = {
    "gcn_fp32": ("gcn", dict(storage="fp32"), False),
    "gcn_int8": ("gcn", dict(storage="int8"), False),
    "gat_int8": ("gat", dict(storage="int8"), False),
    "gcn_sampled": ("gcn", dict(storage="fp32"), True),
    "partition_llcg": ("gcn", dict(mode="partition", llcg_correction=True,
                                   correction_frac=0.5,
                                   correction_lr=0.05), False),
    "propagation_bf16": ("gcn", dict(storage="bf16", mode="propagation"),
                         False),
}


def _run(mesh, data, cfg, settings, params, sampled: bool) -> dict:
    """The single-process run and the collective run from the same
    parameters, epoch by epoch: metrics and the whole final state equal
    (``torch.equal``); returns the collective run's trajectory, epoch-1
    gradients, whole final state and each epoch's collective census."""
    from repro_torch.core import collectives, digest
    from repro_torch.graph import build_sampler
    from repro_torch.optim import adam

    opt = _capture(adam(LR))
    csettings = dataclasses.replace(settings, pull_mode="collective")
    sdata = digest.shard_data(data, mesh)
    if sampled:
        sampler = build_sampler(data, FANOUT, SEEDS, seed=0)
        state = digest.init_sampled_state(cfg, opt, data,
                                          precision=settings.precision,
                                          params=params)
        one = digest.sampled_advance(
            digest.make_sampled_epoch_fn(cfg, opt, settings), sampler, data)
        many = digest.sampled_advance(
            digest.make_sampled_epoch_fn(cfg, opt, csettings, mesh),
            sampler, sdata, mesh)
        rounds = SAMPLED_STEPS
    else:
        state = digest.init_state(cfg, opt, data,
                                  precision=settings.precision,
                                  params=params)
        fn = digest.make_epoch_fn(cfg, opt, settings)
        cfn = digest.make_epoch_fn(cfg, opt, csettings, mesh)

        def one(st, _):
            return fn(st, data)

        def many(st, _):
            return cfn(st, sdata)
        rounds = EPOCHS
    cstate = digest.shard_state(state, mesh)
    traj, census, grads = [], [], None
    for t in range(rounds):
        state, m = one(state, t)
        collectives.reset_collectives()
        cstate, cm = many(cstate, t)
        census.append(dict(collectives.COLLECTIVES))
        for key in m:
            assert torch.equal(m[key], cm[key]), (t, key, m[key], cm[key])
        traj.append((float(cm["loss"]), float(cm["train_f1"]),
                     cm["staleness_eps"].numpy()))
        if t == 0:
            grads = [g.numpy() for g in leaves(cstate["opt_state"]["grads"])]
    whole = digest.gather_state(cstate, mesh)
    assert tree_equal(whole, state)
    return {"traj": traj, "grads": grads, "census": census,
            "store": numpy_tree(whole["store"])}


def train_job(world: int, params: dict) -> dict:
    """Every RUNS entry, then ``digest_train`` with the ema predictor,
    drop faults and the watchdog, on a ("data",) mesh of ``world``
    ranks.  ``params``: the reference's initial parameters (numpy) by
    model."""
    from repro_torch.core import digest
    from repro_torch.core.faults import FaultConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn import params_from_numpy
    from repro_torch.optim import adam

    mesh = make_mesh(world)
    g, data = train_graph()
    out = {}
    for name, (model, skw, sampled) in RUNS.items():
        out[name] = _run(mesh, data, train_cfg(g, model),
                         train_settings(**skw),
                         params_from_numpy(params[model], "cpu"), sampled)
    cfg = train_cfg(g, "gcn")
    settings = train_settings(predictor="ema", max_staleness=MAX_STALENESS)
    runs = []
    for m in (None, mesh):
        s = settings if m is None else dataclasses.replace(
            settings, pull_mode="collective")
        runs.append(digest.digest_train(
            cfg, adam(LR), data, s, EPOCHS, eval_every=1, mesh=m,
            faults=FaultConfig(**FAULTS),
            params=params_from_numpy(params["gcn"], "cpu")))
    (state, hist), (cstate, chist) = runs
    hist.pop("time")
    chist.pop("time")
    assert hist == chist, (hist, chist)
    assert tree_equal(digest.gather_state(cstate, mesh), state)
    out["gcn_ema_faults"] = {"hist": chist,
                             "store": numpy_tree(state["store"])}
    return out


def exchange_job(world: int, ref_npz: str) -> dict:
    """On 4 ranks, a ("data",) mesh and a ("pod", "data") = 2 x 2 mesh:
    collective_pull == pull_slab, shard_push(_ef) == push(_ef) and
    shard_staleness_error == staleness_error, bit for bit, at k = 1 and 2
    for fp32, bf16 and int8 stores, with each pull's census; the k = 1
    pull of the reference's pushed stores (``ref_npz``) equal to the
    reference's collective_pull; the geometry error for M = 6; and 2
    GCN int8 epochs on the pod mesh equal to the single-process run."""
    from repro_torch.core import collectives, digest
    from repro_torch.core import halo_exchange as hx
    from repro_torch.graph import build_partitions, make_dataset
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adam

    meshes = {"data": make_mesh(world), "pod": make_mesh(world // 2, 2)}
    g = make_dataset("flickr-sim", scale=0.12, seed=5)
    l1, hid = 2, 8
    out = {"census": {}}
    ref = dict(np.load(ref_npz))
    for num_parts in (4, 8):
        sp = build_partitions(g, num_parts)
        rng = np.random.default_rng(0)
        reps = torch.from_numpy(rng.normal(
            size=(num_parts, l1, sp.part_size, hid)).astype(np.float32))
        res = torch.from_numpy(rng.normal(
            size=reps.shape).astype(np.float32)) * 0.01
        slots = torch.from_numpy(sp.local_slots)
        valid = torch.from_numpy(sp.local_valid)
        sent = torch.from_numpy(sp.sentinel_slots)
        served = torch.from_numpy(sp.local_boundary)
        plan = sp.pull_plan()
        halo_slots = torch.from_numpy(sp.halo_slots)
        for mname, mesh in meshes.items():
            sl = hx.part_slice(num_parts, mesh)
            send = torch.from_numpy(plan.send_offsets[sl])
            recv = torch.from_numpy(plan.recv_positions[sl])
            for storage in ("fp32", "bf16", "int8"):
                prec = hx.HaloPrecision(storage)
                base = hx.init_store(l1, sp.store_rows - 1, hid, prec, "cpu")
                store = hx.push(base, slots, valid, reps, sent)
                local = hx.shard_store(store, num_parts, mesh)
                collectives.reset_collectives()
                got = hx.collective_pull(local, send, recv, sp.halo_size,
                                         mesh)
                out["census"][(num_parts, mname, storage)] = dict(
                    collectives.COLLECTIVES)
                want = hx.pull_slab(store, halo_slots)
                assert sorted(got) == sorted(want)
                for key in want:
                    assert torch.equal(got[key], want[key][sl]), key
                mine = hx.shard_push(hx.shard_store(base, num_parts, mesh),
                                     slots[sl], valid[sl], reps[sl],
                                     sp.shard_rows, mesh)
                assert tree_equal(mine, local)
                ef, r1 = hx.push_ef(base, slots, valid, reps, res, sent)
                mine, r2 = hx.shard_push_ef(
                    hx.shard_store(base, num_parts, mesh), slots[sl],
                    valid[sl], reps[sl], res[sl], sp.shard_rows, mesh)
                assert tree_equal(mine, hx.shard_store(ef, num_parts, mesh))
                assert torch.equal(r2, r1[sl])
                fresh = reps * 1.25
                assert torch.equal(
                    hx.shard_staleness_error(local, fresh[sl], slots[sl],
                                             served[sl], sp.shard_rows,
                                             mesh),
                    hx.staleness_error(store, fresh, slots, served))
                if num_parts == 4 and mname == "data" \
                        and storage != "bf16":
                    # The reference's pushed store, pulled by the port.
                    jstore = {k: torch.from_numpy(ref[f"{storage}/store/{k}"])
                              for k in want}
                    jgot = hx.collective_pull(
                        hx.shard_store(jstore, num_parts, mesh), send, recv,
                        sp.halo_size, mesh)
                    for key in jgot:
                        assert np.array_equal(
                            jgot[key].numpy(),
                            ref[f"{storage}/slab/{key}"][sl]), key
    try:
        digest.check_collective_geometry(
            {"local_slots": torch.zeros((6, 1))}, meshes["data"])
    except ValueError as err:
        out["geometry_error"] = str(err)
    # (pod, data) training: 2 epochs, GCN int8, from drawn parameters.
    gt, data = train_graph()
    cfg = train_cfg(gt, "gcn")
    settings = train_settings("int8")
    opt = adam(LR)
    state = digest.init_state(cfg, opt, data, precision=settings.precision)
    cstate = digest.shard_state(state, meshes["pod"])
    fn = digest.make_epoch_fn(cfg, opt, settings)
    cfn = digest.make_epoch_fn(
        cfg, opt, dataclasses.replace(settings, pull_mode="collective"),
        meshes["pod"])
    sdata = digest.shard_data(data, meshes["pod"])
    for _ in range(2):
        state, m = fn(state, data)
        cstate, cm = cfn(cstate, sdata)
        assert all(torch.equal(m[k], cm[k]) for k in m)
    assert tree_equal(digest.gather_state(cstate, meshes["pod"]), state)
    return out


def serve_job(world: int, params: dict, reps: dict) -> dict:
    """The sharded serving engine on ``world`` ranks over the flickr-sim
    setup of ``tests/test_torch_serving.py``: the mesh refresh equal to
    the single refresh bit for bit, and each rank's served logits'
    largest error against ``full_graph_forward``, with the census of a
    query batch.  ``params`` / ``reps``: the reference's by model."""
    from repro_torch.core import collectives, serving
    from repro_torch.core import halo_exchange as hx
    from repro_torch.core.digest import full_graph_forward, prepare_graph_data
    from repro_torch.graph import make_dataset
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.nn import params_from_numpy

    mesh = make_mesh(world)
    g = make_dataset("flickr-sim", scale=0.1, seed=2)
    data = prepare_graph_data(g, PARTS, seed=0, device="cpu")
    plan = serving.build_serve_plan(data)
    sl = hx.part_slice(PARTS, mesh)
    batch = 16
    q_rows = np.full((PARTS, batch), plan.part_rows, np.int32)
    for m in range(PARTS):
        v = np.where(plan.local_valid[m])[0][:batch]
        q_rows[m, :len(v)] = v
    out = {}
    for model, storage in (("gcn", "fp32"), ("sage", "int8"),
                           ("gat", "bf16")):
        cfg = GNNConfig(model=model, num_layers=2,
                        in_dim=g.features.shape[1], hidden_dim=32,
                        num_classes=int(g.labels.max()) + 1)
        p = params_from_numpy(params[model], "cpu")
        scfg = serving.ServeConfig(batch_size=batch, storage=storage)
        top = torch.from_numpy(reps[model])
        store = serving.init_serve_store(plan, cfg.hidden_dim,
                                         scfg.precision, "cpu")
        single = serving.make_refresh_fn(donate=False)(
            store, top, plan.refresh_data("cpu"))
        lstore, sdata = serving.place_serving(store, plan.sharded_data(data),
                                              mesh)
        rdata = hx.shard_parts(plan.refresh_data("cpu"), mesh)
        sharded = serving.make_refresh_fn(mesh, plan.serve_rows)(
            lstore, top, rdata)
        assert tree_equal(sharded, hx.shard_store(single, PARTS, mesh))
        collectives.reset_collectives()
        logits = serving.serve_query_sharded(
            cfg, scfg, mesh, plan.halo_size, p, sharded, sdata,
            torch.from_numpy(q_rows[sl]))
        census = dict(collectives.COLLECTIVES)
        ref = full_graph_forward(cfg, p, data)[0]
        err = 0.0
        for i, m in enumerate(range(sl.start, sl.stop)):
            v = np.where(plan.local_valid[m])[0][:batch]
            gids = torch.from_numpy(plan.local_ids[m][v]).long()
            err = max(err, float((logits[i, :len(v)] - ref[gids]).abs().max()))
        out[(model, storage)] = {"err": err, "census": census,
                                 "shape": tuple(logits.shape)}
    return out


def checkpoint_job(world: int, ckpt_dir: str) -> dict:
    """A collective GCN int8 run with error feedback, the ema predictor
    and drop faults checkpointed every 2 epochs to 4; its checkpoint
    restored whole and with ``sharding=``; resumed to 6 and run unbroken
    to 6, collective and single-process."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core import digest
    from repro_torch.core.faults import FaultConfig, attach_fault_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adam

    mesh = make_mesh(world)
    g, data = train_graph()
    cfg = train_cfg(g, "gcn")
    base = train_settings("int8", ef=True, predictor="ema",
                          max_staleness=MAX_STALENESS)
    coll = dataclasses.replace(base, pull_mode="collective")

    def train(settings, epochs, m, **kw):
        return digest.digest_train(cfg, adam(LR), data, settings, epochs,
                                   eval_every=1, mesh=m,
                                   faults=FaultConfig(**FAULTS), **kw)

    four, _ = train(coll, 4, mesh, ckpt_dir=ckpt_dir, ckpt_every=2)
    single4, _ = train(base, 4, None)
    template = attach_fault_state(
        digest.init_state(cfg, adam(LR), data, precision=base.precision,
                          predictor=base.predictor), PARTS)
    whole, step = restore_checkpoint(ckpt_dir, template)
    placed, _ = restore_checkpoint(
        ckpt_dir, template, sharding=lambda t: digest.shard_state(t, mesh))
    resumed, _ = train(coll, 6, mesh, ckpt_dir=ckpt_dir, ckpt_every=2,
                       resume=True)
    unbroken, _ = train(coll, 6, mesh)
    single6, _ = train(base, 6, None)
    return {"step": step,
            "whole_is_single": tree_equal(whole, single4),
            "placed_is_rank_state": tree_equal(placed, four),
            "resumed_is_unbroken": tree_equal(resumed, unbroken),
            "resumed_is_single": tree_equal(
                digest.gather_state(resumed, mesh), single6)}


def _lm_state_close(ref, got) -> float:
    """The largest |got - ref| of a leaf over the leaf's max |ref|."""
    from repro_torch.optim import tree_leaves
    return max(float((y - x).abs().max()) / max(float(x.abs().max()), 1e-30)
               for x, y in zip(tree_leaves(ref), tree_leaves(got)))


def _pod_data_run(cfg, stacked, pods, batches, mesh, pod: int) -> dict:
    """The pod form on a ("pod", "data") mesh with "data" above 1 (FSDP
    inside each pod, the trainer's rules) against the stacked form: the
    step-1 gradient of this rank's pod (the clip's input, gathered whole)
    against the pod batch's, each step's metrics, this pod's whole params
    after every step, and the census."""
    from repro_torch.core import collectives
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train import trainer

    n_pod = stacked.n_pod
    sb = init_train_state(cfg, stacked, device="cpu")
    sc = init_train_state(cfg, pods, device="cpu", mesh=mesh)
    fb, fc = make_train_step(cfg, stacked), make_train_step(cfg, pods, mesh)
    pod_batch = {k: trainer._pod_slice(v, pod, n_pod)
                 for k, v in batches[0].items()}
    want = trainer.loss_and_grads(cfg, pods, whole_params(sc["params"], cfg,
                                                          mesh), pod_batch)
    out = {"loss_rel": [], "params_err": [], "census": []}
    for i, b in enumerate(batches):
        sb, mb = fb(sb, b)
        collectives.reset_collectives()
        with clip_inputs() as grads:
            sc, mc = fc(sc, b)
        out["census"].append(dict(collectives.COLLECTIVES))
        if i == 0:
            out["grad_err"] = _lm_state_close(
                want[2], whole_params(grads[0], cfg, mesh))
        out["loss_rel"].append(max(
            abs(float(mc[k]) - float(mb[k])) / max(abs(float(mb[k])), 1e-30)
            for k in ("loss", "ce", "aux")))
        out["params_err"].append(_lm_state_close(
            [x[pod] for x in leaves_of(sb["params"])],
            whole_params(sc["params"], cfg, mesh)))
    out["params"] = [x.numpy() for x in
                     leaves_of(whole_params(sc["params"], cfg, mesh))]
    return out


def whole_params(tree, cfg, mesh):
    """``tree`` (the params' tree of this rank's blocks under the
    trainer's rules) gathered whole."""
    from repro_torch.distributed import TRAIN_RULES, gather_whole
    from repro_torch.models.transformer import arch_specs
    return gather_whole(tree, arch_specs(cfg), mesh, TRAIN_RULES)


@contextlib.contextmanager
def clip_inputs():
    """The gradients the trainer hands ``clip_by_global_norm`` inside the
    ``with`` block (a step's summed gradients, this rank's blocks)."""
    from repro_torch.train import trainer
    grads, clip = [], trainer.clip_by_global_norm

    def recorded(g, *a):
        grads.append(g)
        return clip(g, *a)

    trainer.clip_by_global_norm = recorded
    try:
        yield grads
    finally:
        trainer.clip_by_global_norm = clip


def leaves_of(tree) -> list:
    from repro_torch.optim import tree_leaves
    return tree_leaves(tree)


def lm_pod_job(world: int, steps: int, interval: int) -> dict:
    """The LM trainer's pod form (``pod_impl="shard_map"``, one rank a pod
    of a ("pod", "data") = world x 1 mesh) against its stacked form
    (``"vmap"``, all pods in this rank), qwen3-0.6b SMOKE at vocab 64,
    batch 2 a pod x 16: every step's loss, ce and aux, and this pod's
    params and optimizer state after every step, bit for bit; the census
    of every step; the refusals of meshes the form cannot take; and at
    world 4 the (pod 2, data 2) form (:func:`_pod_data_run`), for
    qwen3-0.6b and llama4-scout (the aux loss) SMOKE."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.core import collectives
    from repro_torch.data import make_lm_pipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import tree_leaves
    from repro_torch.train import (TrainSettings, init_train_state,
                                   make_train_step)

    cfg = dataclasses.replace(get_smoke_arch("qwen3-0.6b"), vocab_size=64)
    stacked = TrainSettings(sync_mode="digest", n_pod=world,
                            sync_interval=interval, total_steps=40,
                            warmup_steps=2)
    pods = dataclasses.replace(stacked, pod_impl="shard_map")
    it = make_lm_pipeline(64, 2 * world, 16, seed=1, device="cpu")
    batches = [{"tokens": b.tokens, "labels": b.labels, "mask": b.mask}
               for b in (next(it) for _ in range(steps))]
    mesh = make_mesh(1, world)
    pod = mesh.get_local_rank("pod")
    sb = init_train_state(cfg, stacked, device="cpu")
    sc = init_train_state(cfg, pods, device="cpu")
    fb, fc = make_train_step(cfg, stacked), make_train_step(cfg, pods, mesh)
    equal, census, divergence = [], [], []
    for b in batches:
        sb, mb = fb(sb, b)
        collectives.reset_collectives()
        sc, mc = fc(sc, b)
        census.append(dict(collectives.COLLECTIVES))
        divergence.append(float(mb["pod_divergence"]))
        equal.append(
            all(torch.equal(mb[k], mc[k]) for k in ("loss", "ce", "aux"))
            and all(torch.equal(x[pod], y) for key in ("params", "opt_state")
                    for x, y in zip(tree_leaves(sb[key]),
                                    tree_leaves(sc[key])))
            and int(sb["step"]) == int(sc["step"]))
    refusals = {}
    for label, mesh_fn, st in (
            ("none", lambda: None, pods),
            ("data only", lambda: make_mesh(world), pods),
            ("stacked form", lambda: make_mesh(1, world), stacked)):
        try:
            make_train_step(cfg, st, mesh_fn())
            refusals[label] = None
        except ValueError as e:
            refusals[label] = str(e)
    out = {"pod": pod, "equal": equal, "census": census,
           "divergence": divergence, "refusals": refusals}
    if world == 4:
        mesh = make_mesh(2, 2)
        pod = mesh.get_local_rank("pod")
        two = dict(n_pod=2, sync_interval=interval)
        for arch in ("qwen3-0.6b", "llama4-scout-17b-a16e"):
            c = dataclasses.replace(get_smoke_arch(arch), vocab_size=64)
            out[f"data2 {arch}"] = _pod_data_run(
                c, dataclasses.replace(stacked, **two),
                dataclasses.replace(pods, **two), batches, mesh, pod)
        out["data2 pod"] = pod
    return out


def lm_reference_job(world: int, ref_npz: str, interval: int) -> dict:
    """The (pod 2, data 2) pod form (FSDP inside each pod) from the
    reference's initial params (``ref_npz``, written by its
    ``_make_pod_shard_map_step`` run on the same mesh): each step's
    metrics and the whole params after the last step."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.distributed import (TRAIN_RULES, shard_params,
                                         train_state_specs)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import arch_specs
    from repro_torch.nn import abstract_params
    from repro_torch.train import TrainSettings, make_train_step
    from repro_torch.train.trainer import _rebuild, _state

    ref = np.load(ref_npz)
    cfg = dataclasses.replace(get_smoke_arch("qwen3-0.6b"), vocab_size=64)
    settings = TrainSettings(sync_mode="digest", n_pod=2,
                             pod_impl="shard_map", sync_interval=interval,
                             total_steps=40, warmup_steps=2)
    n = len([k for k in ref.files if k.startswith("init")])
    params = _rebuild(abstract_params(arch_specs(cfg)),
                      iter(torch.from_numpy(ref[f"init{i}"])
                           for i in range(n)))
    mesh = make_mesh(2, 2)
    state = shard_params(_state(cfg, settings, params),
                         train_state_specs(arch_specs(cfg), cfg.optimizer),
                         mesh, TRAIN_RULES)
    step = make_train_step(cfg, settings, mesh)
    metrics = []
    for i in range(len([k for k in ref.files if k.startswith("tokens")])):
        state, m = step(state, {k: torch.from_numpy(ref[f"{k}{i}"])
                                for k in ("tokens", "labels", "mask")})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": [x.numpy() for x in
                       leaves_of(whole_params(state["params"], cfg, mesh))]}


def lm_dp_job(world: int, steps: int) -> dict:
    """The ``every_step`` baseline against the single process on the same
    global batches, under the trainer's rules (FSDP over "data"): on a
    ("data",) = 2 mesh at world 2 and a ("pod", "data") = 2 x 2 mesh at
    world 4 (the batch split over both, each FSDP block held in both
    pods), for qwen3-0.6b (vocab 64) and llama4-scout (the aux loss)
    SMOKE, under a mask whose counts differ between the ranks' rows: the
    step-1 gradient (the clip's input, gathered whole) against the
    batch's, each step's metrics, the whole params after step 1 and
    after the last step, and the census.  A mesh with no batch
    dimension above 1 gives the single-device step bit for bit."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.core import collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import (TrainSettings, init_train_state,
                                   make_train_step)
    from repro_torch.train import trainer

    settings = TrainSettings(total_steps=20, warmup_steps=2)
    mesh = make_mesh(2, pod=world // 2)
    rng = np.random.default_rng(5)
    out = {}
    for arch in ("qwen3-0.6b", "llama4-scout-17b-a16e"):
        cfg = dataclasses.replace(get_smoke_arch(arch), vocab_size=64)
        batches = []
        for _ in range(steps):
            toks = rng.integers(0, 64, (2 * world, 17))
            mask = np.ones((2 * world, 16), np.float32)
            mask[:2, 5:] = 0.0               # rank 0's rows: fewer tokens
            batches.append({"tokens": torch.from_numpy(toks[:, :-1]),
                            "labels": torch.from_numpy(toks[:, 1:]),
                            "mask": torch.from_numpy(mask)})
        single = init_train_state(cfg, settings, device="cpu")
        dp = init_train_state(cfg, settings, device="cpu", mesh=mesh)
        want = trainer.loss_and_grads(cfg, settings, single["params"],
                                      batches[0])
        res = {"loss_rel": [], "params_err": [], "census": []}
        f1, f2 = make_train_step(cfg, settings), make_train_step(
            cfg, settings, mesh)
        for i, b in enumerate(batches):
            single, m1 = f1(single, b)
            collectives.reset_collectives()
            with clip_inputs() as grads:
                dp, m2 = f2(dp, b)
            res["census"].append(dict(collectives.COLLECTIVES))
            if i == 0:
                res["grad_err"] = _lm_state_close(
                    want[2], whole_params(grads[0], cfg, mesh))
            res["loss_rel"].append(max(
                abs(float(m2[k]) - float(m1[k]))
                / max(abs(float(m1[k])), 1e-30) for k in ("loss", "ce",
                                                          "aux")))
            res["params_err"].append(_lm_state_close(
                single["params"], whole_params(dp["params"], cfg, mesh)))
        res["params"] = [x.numpy() for x in
                         leaves_of(whole_params(dp["params"], cfg, mesh))]
        out[arch] = res
    # A mesh whose batch dimensions are all 1: the single-device step.
    cfg = dataclasses.replace(get_smoke_arch("qwen3-0.6b"), vocab_size=64)
    one = make_mesh(1, pod=world)["data"]
    a = init_train_state(cfg, settings, device="cpu")
    b = init_train_state(cfg, settings, device="cpu")
    for batch in batches[:2]:
        a, ma = make_train_step(cfg, settings)(a, batch)
        b, mb = make_train_step(cfg, settings, one)(b, batch)
    out["data 1 is single"] = all(
        torch.equal(x, y) for x, y in zip(leaves_of([a, ma]),
                                          leaves_of([b, mb])))
    return out


# The expert-parallel MoE: moe_ep over "model" (with and without batch
# dimensions), each case (mesh, batch, k) of
# tests/test_torch_moe.py::MOE_CASES on the inputs its fixture writes.

def moe_meshes() -> dict:
    """The three 4-rank meshes of the MoE cases: ("model",) = 4 (a mesh
    with no batch dimension), ("data", "model") = 2 x 2 and ("pod",
    "data", "model") = 2 x 1 x 2."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_mesh
    return {"model4": init_device_mesh("cpu", (4,),
                                       mesh_dim_names=("model",)),
            "data2_model2": make_mesh(2, model=2),
            "pod2_model2": make_mesh(1, pod=2, model=2)}


def _batch_blocks(mesh, b: int) -> int:
    """The batch blocks moe_ep splits a batch of ``b`` rows into."""
    from repro_torch.launch.mesh import dim_size
    n = dim_size(mesh, "pod") * dim_size(mesh, "data")
    return n if b % n == 0 else 1


def moe_job(world: int, inputs: str, cases: list, cf: float) -> dict:
    """Each case's moe_ep over its mesh (the global output, on every
    rank), bit for bit against the single-device moe_ep applied to each
    batch block (the same capacity), with global and with sharded
    (``shard_experts``) weights; ``moe_ffn(impl="auto", mesh=...)``; the
    census of a call; the refusals (E not a multiple of "model"; a
    "model" dimension on the GNN exchange and the LM trainer); scout and
    kimi SMOKE forward and decode with a mesh under the expert-parallel
    rules against the single process."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.core import collectives, halo_exchange
    from repro_torch.models import moe
    from repro_torch.models.transformer import (arch_specs, decode_step,
                                                forward, init_cache)
    from repro_torch.nn import init_params
    from repro_torch.train import TrainSettings, make_train_step

    data = np.load(inputs)
    meshes = moe_meshes()
    out = {"cases": {}, "refusals": {}}
    for name, b, k in cases:
        mesh = meshes[name]
        key = f"{name}/B{b}/k{k}"
        x = torch.from_numpy(data[f"x{b}"])
        p = {w: torch.from_numpy(data[w]) for w in
             ("router", "w_gate", "w_up", "w_down")}
        collectives.reset_collectives()
        y = moe.moe_ep(x, p, k, capacity_factor=cf, mesh=mesh)
        census = dict(collectives.COLLECTIVES)
        n = _batch_blocks(mesh, b)
        single = torch.cat([moe.moe_ep(blk, p, k, capacity_factor=cf)
                            for blk in x.chunk(n)])
        sharded = moe.moe_ep(x, moe.shard_experts(p, mesh), k,
                             capacity_factor=cf, mesh=mesh)
        auto = moe.moe_ffn(x, p, k, capacity_factor=cf, mesh=mesh)
        out["cases"][key] = {
            "y": y.numpy(), "census": census, "blocks": n,
            "single": torch.equal(y, single),
            "sharded": torch.equal(y, sharded),
            "auto_is_ep": torch.equal(auto, y),
            "shard_rows": moe.shard_experts(p, mesh)["w_gate"].shape[0]}
    bad = {"router": torch.zeros(16, 6), "w_gate": torch.zeros(6, 16, 8),
           "w_up": torch.zeros(6, 16, 8), "w_down": torch.zeros(6, 8, 16)}
    tries = {
        "E % model": lambda: moe.moe_ep(torch.zeros(4, 2, 16), bad, 1,
                                        mesh=meshes["model4"]),
        "gnn part_slice": lambda: halo_exchange.part_slice(
            8, meshes["data2_model2"]),
        "trainer": lambda: make_train_step(
            get_smoke_arch("qwen3-0.6b"), TrainSettings(),
            meshes["data2_model2"])}
    for label, fn in tries.items():
        try:
            fn()
            out["refusals"][label] = None
        except ValueError as e:
            out["refusals"][label] = str(e)
    # The transformer with a mesh under the expert-parallel rules (every
    # dense leaf whole): scout (top-1) and kimi (top-2) SMOKE, moe_impl
    # "ep", against the single process.
    from repro_torch.distributed import EXPERT_PARALLEL_RULES as ep
    out["models"] = {}
    for arch in ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b"):
        cfg = dataclasses.replace(get_smoke_arch(arch), moe_impl="ep")
        params = init_params(arch_specs(cfg), torch.Generator().manual_seed(0),
                             "cpu")
        mine = moe.shard_experts(params, meshes["model4"])
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (2, 12)))
        res = {}
        with torch.no_grad():
            for label, mesh, p, b in (
                    ("model4", meshes["model4"], params, 2),
                    ("model4 sharded", meshes["model4"], mine, 2),
                    ("data2_model2 B1", meshes["data2_model2"], params, 1)):
                t = toks[:b]
                same = torch.equal(forward(cfg, p, t, mesh=mesh, rules=ep),
                                   forward(cfg, params, t))
                caches = [init_cache(cfg, b, 8, device="cpu")
                          for _ in range(2)]
                for s in range(6):
                    a, caches[0] = decode_step(cfg, p, caches[0],
                                               t[:, s:s + 1], mesh=mesh,
                                               rules=ep)
                    w, caches[1] = decode_step(cfg, params, caches[1],
                                               t[:, s:s + 1])
                    same = same and torch.equal(a, w)
                res[label] = same
        out["models"][arch] = res
    return out


# Tensor-parallel LM serving (tests/test_torch_sharding.py): the SMOKE
# configs over three meshes of 4 ranks, each rank's logit blocks and the
# checks made inside the ranks.

def tp_meshes() -> dict:
    """"1x2": ("replica", "model") = 2 x 2, two independent 1 x 2 meshes
    side by side (no rule names "replica", so the batch is whole in each);
    "2x2": ("data", "model") = 2 x 2; "1x4": ("data", "model") = 1 x 4."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_mesh
    return {"1x2": init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("replica", "model")),
            "2x2": make_mesh(2, model=2), "1x4": make_mesh(1, model=4)}


def tp_long(cfg):
    """The stale-KV settings of the tensor-parallel decode checks: a
    window of 4 and a ratio of 2, so 8 steps push and attend to the far
    field."""
    return dataclasses.replace(cfg, long_window=4, long_ratio=2)


def _digest(t) -> str:
    import hashlib
    return hashlib.sha1(t.detach().contiguous().view(torch.uint8)
                        .numpy().tobytes()).hexdigest()


def tp_job(world: int, inputs: str, steps: int) -> dict:
    """Each SMOKE config's ``forward`` and ``steps`` decode steps (full and
    ``long``) over every mesh of :func:`tp_meshes`, on parameters
    sharded by ``sharding.shard_params``: this rank's logit blocks, their
    largest difference from the port's single process (computed here),
    the census of a forward, a digest of every ordered sum's output (the
    ranks of a "model" group must agree bit for bit), the parameter
    bytes against the single process's, and the vocab-parallel argmax
    against ``torch.argmax`` of the gathered logits (ties and NaNs
    included); the refusals of the tensor-parallel path."""
    import pickle

    from repro_torch.configs import get_smoke_arch
    from repro_torch.core import collectives
    from repro_torch.distributed import sharding
    from repro_torch.launch.serve import tensor_bytes
    from repro_torch.models import transformer as tt
    from repro_torch.nn import params_from_numpy

    with open(inputs, "rb") as f:
        data = pickle.load(f)
    meshes = tp_meshes()
    sums = []
    inner = collectives.ordered_sum

    def recorded(tensor, group=None, acc_dtype=None):
        out = inner(tensor, group, acc_dtype)
        sums.append(_digest(out))
        return out

    collectives.ordered_sum = recorded
    out = {"rank": dist.get_rank(), "archs": {}}
    try:
        for arch, entry in data.items():
            cfg = get_smoke_arch(arch)
            params = params_from_numpy(entry["params"], "cpu")
            toks = torch.from_numpy(entry["tokens"])
            vis = (None if entry["vision"] is None
                   else torch.from_numpy(entry["vision"]))
            b = toks.shape[0]
            res = {}
            with torch.no_grad():
                single = {"forward": tt.forward(cfg, params, toks, vis)}
                for long in (False, True):
                    c = tp_long(cfg) if long else cfg
                    cache = tt.init_cache(c, b, 2 * steps, long=long,
                                          device="cpu")
                    if vis is not None:
                        tt.precompute_vision_cache(c, params, cache, vis)
                    logs = []
                    for s in range(steps):
                        lg, cache = tt.decode_step(
                            c, params, cache, toks[:, s:s + 1], long=long)
                        logs.append(lg)
                    single["long" if long else "full"] = torch.stack(logs)
                for name, mesh in meshes.items():
                    specs = tt.arch_specs(cfg)
                    mine = sharding.shard_params(params, specs, mesh)
                    r0, rows = tt.batch_rows(b, mesh)
                    v0, cols = tt.vocab_block(cfg, mesh)
                    got = {}
                    collectives.reset_collectives()
                    sums.clear()
                    got["forward"] = tt.forward(cfg, mine, toks, vis,
                                                mesh=mesh)
                    census = dict(collectives.COLLECTIVES)
                    digests = list(sums)
                    for long in (False, True):
                        c = tp_long(cfg) if long else cfg
                        cache = tt.init_cache(c, b, 2 * steps, long=long,
                                              device="cpu", mesh=mesh)
                        if vis is not None:
                            tt.precompute_vision_cache(c, mine, cache, vis,
                                                       mesh=mesh)
                        logs = []
                        for s in range(steps):
                            lg, cache = tt.decode_step(
                                c, mine, cache, toks[:, s:s + 1],
                                long=long, mesh=mesh)
                            logs.append(lg)
                        got["long" if long else "full"] = torch.stack(logs)
                    err = {}
                    for key, val in got.items():
                        want = single[key]
                        want = (want[r0:r0 + rows] if key == "forward" else
                                want[:, r0:r0 + rows])[..., v0:v0 + cols]
                        err[key] = float((val - want).abs().max()
                                         / single[key].abs().max())
                    # The argmax of the last decode logits, and of logits
                    # with ties across and inside the blocks and a NaN.
                    last = got["full"][-1]
                    ties = torch.zeros((b, 1, cfg.vocab_size))
                    ties[0, 0, [3, cfg.vocab_size - 2]] = 7.0
                    ties[1, 0, [cfg.vocab_size // 2 + 1,
                                cfg.vocab_size - 1]] = 7.0
                    ties[2, 0, cfg.vocab_size - 5] = float("nan")
                    ties[3] = -float("inf")
                    argmax_ok = True
                    for whole in (tt.gather_logits(cfg, last, b, mesh),
                                  ties):
                        block = whole[r0:r0 + rows, ..., v0:v0 + cols]
                        argmax_ok &= torch.equal(
                            tt.vocab_argmax(cfg, block, b, mesh),
                            torch.argmax(whole, dim=-1))
                    bytes_ok = _tp_bytes_ok(mine, specs, mesh)
                    res[name] = {
                        "rows": (r0, rows), "cols": (v0, cols),
                        "model_rank": mesh.get_local_rank("model"),
                        "blocks": {k: v.numpy() for k, v in got.items()},
                        "single_err": err, "census": census,
                        "digests": digests, "argmax_ok": argmax_ok,
                        "bytes_ok": bytes_ok,
                        "bytes": tensor_bytes(mine),
                        "single_bytes": tensor_bytes(params)}
            out["archs"][arch] = res
    finally:
        collectives.ordered_sum = inner
    out["refusals"] = _tp_refusals(meshes)
    out["init_sharded"] = _tp_init_sharded(meshes)
    out["row_bf16"] = _tp_row_bf16(meshes)
    return out


def _tp_row_bf16(meshes) -> dict:
    """A bf16 row-parallel product over each mesh's "model" group
    (``transformer._row``: fp32 partials, one rounding) against the whole
    product in fp32 rounded once to bf16, as one device takes it: the
    largest difference in bf16 ulps of the whole product, and the same
    with each rank's partial rounded to bf16 before the fp32 sum."""
    from repro_torch.core import collectives
    from repro_torch.models import transformer as tt
    from repro_torch.nn import dense
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((32, 256), generator=gen).bfloat16()
    w = torch.randn((256, 64), generator=gen)
    once = (x.float() @ w.bfloat16().float()).bfloat16()
    mag = once.abs()
    ulp = (mag.view(torch.int16) + 1).view(torch.bfloat16).float() \
        - mag.float()

    def ulps(t):
        return float(((t.float() - once.float()).abs() / ulp).max())

    out = {}
    for name, mesh in meshes.items():
        tp = tt._Shards(mesh, None, {"w_down": "mlp"})
        n = 256 // mesh.size(mesh.mesh_dim_names.index("model"))
        sl = slice(tp.rank * n, (tp.rank + 1) * n)
        got = tt._row(tp, "w_down", dense, x[:, sl], w[sl])
        rounded = collectives.ordered_sum(dense(x[:, sl], w[sl].bfloat16()),
                                          tp.group, torch.float32)
        out[name] = {"dtype": str(got.dtype), "ulps": ulps(got),
                     "ulps_bf16_partials": ulps(rounded)}
    return out


def _tp_init_sharded(meshes) -> dict:
    """``sharding.init_sharded`` against ``shard_params`` of the whole
    ``init_params`` draw (the same generator seed), bit for bit, on each
    mesh (llama4-scout's SMOKE config: its experts and whole router)."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.distributed import init_sharded, shard_params
    from repro_torch.models import transformer as tt
    from repro_torch.nn import init_params
    cfg = get_smoke_arch("llama4-scout-17b-a16e")
    specs = tt.arch_specs(cfg)
    whole = init_params(specs, torch.Generator().manual_seed(5), "cpu")
    out = {}
    for name, mesh in meshes.items():
        want = shard_params(whole, specs, mesh)
        got = init_sharded(specs, torch.Generator().manual_seed(5), mesh,
                           device="cpu")
        out[name] = {
            "equal": _tree_equal_lists(got, want),
            "router_whole": tuple(got["pattern"][0]["router"].shape)
            == tuple(whole["pattern"][0]["router"].shape),
            "expert_rows": got["pattern"][0]["w_gate_e"].shape[1]}
    return out


def _tree_equal_lists(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal_lists(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_tree_equal_lists(x, y)
                                        for x, y in zip(a, b))
    return torch.equal(a, b) and a.is_contiguous()


def _tp_bytes_ok(mine, specs, mesh) -> bool:
    """Every leaf this rank holds is the whole leaf's numel over the
    product of its placed dimensions' sizes (the whole where none is
    placed)."""
    from repro_torch.distributed import sharding
    sizes = sharding.mesh_sizes(mesh)
    places = sharding.placements(specs, sizes)
    ok = []
    sharding.map_placed(
        lambda t, shape, pl: ok.append(
            t.numel() * math.prod(math.prod(sizes[a] for a in
                                            sharding.entry_names(e))
                                  for e in pl) == math.prod(shape)),
        mine, places)
    return all(ok)


def _tp_refusals(meshes) -> dict:
    """The tensor-parallel path's ValueErrors: the FSDP rule (parameters
    over "data") in serving (a decode step), and query heads that read
    parts of several whole KV heads (6 heads over 3 KV heads on a 2-way
    "model", a prefill)."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.models import transformer as tt
    from repro_torch.nn import init_params
    out = {}
    cfg = get_smoke_arch("qwen3-0.6b")
    odd = dataclasses.replace(cfg, num_heads=6, num_kv_heads=3, head_dim=16)
    toks = torch.zeros((4, 4), dtype=torch.long)

    def decode(c, params, mesh, rules):
        cache = tt.init_cache(c, 4, 8, device="cpu", mesh=mesh, rules=rules)
        tt.decode_step(c, params, cache, toks[:, :1], mesh=mesh, rules=rules)

    def prefill(c, params, mesh, rules):
        tt.forward(c, params, toks, mesh=mesh, rules=rules)

    for label, run, c, mesh, rules in (
            ("fsdp", decode, cfg, meshes["2x2"], {"embed": "data"}),
            ("kv heads", prefill, odd, meshes["1x2"], None)):
        params = init_params(tt.arch_specs(c),
                             torch.Generator().manual_seed(0), "cpu")
        try:
            with torch.no_grad():
                run(c, params, mesh, rules)
            out[label] = None
        except ValueError as e:
            out[label] = str(e)
    return out


# The trainer's tensor parallelism and FSDP (tests/test_torch_tp_train.py):
# each SMOKE config on ("replica", "model") = 2 x 2 (two 1 x 2 meshes side
# by side) and ("data", "model") = 2 x 2 under the reference trainer's
# rules {"embed": "data"}; the digest pod form on (pod 2, data 2, model 2).

def tp_train_meshes() -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_mesh
    return {"1x2": init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("replica", "model")),
            "2x2": make_mesh(2, model=2)}


def _whole_state(cfg, settings, params_np) -> dict:
    """The train state of the reference's parameters (numpy), whole: the
    optimizer's zeros and step 0."""
    from repro_torch.nn import params_from_numpy
    from repro_torch.train import trainer
    params = params_from_numpy(params_np, "cpu")
    opt = trainer.make_arch_optimizer(cfg, settings)
    return {"params": params, "opt_state": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _tp_run(cfg, settings, whole, batches, mesh) -> dict:
    """``make_train_step`` over ``mesh`` from ``whole`` cut to this rank:
    the step-1 gradient (the clip's input) gathered whole, each step's
    metrics and census, and a digest of every leaf of the whole params
    after the last step (every rank of the mesh must hold the same
    bits); rank 0 also returns the whole gradient and params."""
    from repro_torch.core import collectives
    from repro_torch.distributed import (TRAIN_RULES, gather_whole,
                                         shard_params, train_state_specs)
    from repro_torch.models.transformer import arch_specs
    from repro_torch.train import make_train_step

    specs = train_state_specs(arch_specs(cfg), cfg.optimizer)
    state = shard_params(whole, specs, mesh, TRAIN_RULES)
    step = make_train_step(cfg, settings, mesh)
    metrics, census = [], []
    with clip_inputs() as grads:
        for b in batches:
            collectives.reset_collectives()
            state, m = step(state, b)
            census.append(dict(collectives.COLLECTIVES))
            metrics.append({k: float(v) for k, v in m.items()})
    grad1 = gather_whole(grads[0], arch_specs(cfg), mesh, TRAIN_RULES)
    final = gather_whole(state, specs, mesh, TRAIN_RULES)
    out = {"metrics": metrics, "census": census, "final": final,
           "digests": [_digest(x) for x in leaves_of(final["params"])]}
    if dist.get_rank() == 0:
        out["grad1"] = [g.numpy() for g in leaves_of(grad1)]
        out["params"] = [p.numpy() for p in leaves_of(final["params"])]
    return out


def tp_train_job(world: int, inputs: str) -> dict:
    """Each config of ``inputs`` (parameters, overrides and batches) over
    both :func:`tp_train_meshes` (:func:`_tp_run`); then the whole-leaf
    statistics on cut leaves (:func:`_tp_units`) and a kill and resume
    across meshes (:func:`_tp_resume`) on the 2 x 2 mesh."""
    import pickle

    from repro_torch.configs import get_smoke_arch
    from repro_torch.train import TrainSettings

    with open(inputs, "rb") as f:
        data = pickle.load(f)
    meshes = tp_train_meshes()
    settings = TrainSettings(total_steps=20, warmup_steps=2)
    out = {"rank": dist.get_rank(), "archs": {}}
    for arch, entry in data.items():
        cfg = dataclasses.replace(get_smoke_arch(arch), **entry["over"])
        whole = _whole_state(cfg, settings, entry["params"])
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in entry["batches"]]
        out["archs"][arch] = {name: _tp_run(cfg, settings, whole, batches,
                                            mesh)
                              for name, mesh in meshes.items()}
    out["units"] = _tp_units(meshes["2x2"])
    entry = data["deepseek_coder_33b"]
    cfg = dataclasses.replace(get_smoke_arch("deepseek_coder_33b"),
                              **entry["over"])
    out["resume"] = _tp_resume(
        cfg, settings, _whole_state(cfg, settings, entry["params"]),
        [{k: torch.from_numpy(v) for k, v in b.items()}
         for b in entry["batches"]], meshes["2x2"],
        out["archs"]["deepseek_coder_33b"]["2x2"]["final"],
        os.path.dirname(inputs))
    for runs in out["archs"].values():
        for run in runs.values():
            del run["final"]
    return out


def _tp_units(mesh) -> dict:
    """On a ("data", "model") mesh, against the whole tensors on one
    rank: the vocab-parallel NLL and its gradient block, the global norm
    of leaves cut over "data", "model" and both, and one Adafactor update
    of such leaves; the largest relative difference of each."""
    from repro_torch.distributed import LeafGroups
    from repro_torch.nn.layers import token_nll, vocab_parallel_nll
    from repro_torch.optim import adafactor
    from repro_torch.optim.optimizers import _global_norm

    gen = torch.Generator().manual_seed(7)
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    dg, mg = mesh.get_group("data"), mesh.get_group("model")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    out = {}
    logits = torch.randn((3, 5, 64), generator=gen) * 4
    labels = torch.randint(0, 64, (3, 5), generator=gen)
    whole = logits.clone().requires_grad_(True)
    want = token_nll(whole, labels)
    want.sum().backward()
    block = logits[..., 32 * m:32 * (m + 1)].clone().requires_grad_(True)
    got = vocab_parallel_nll(block, labels, 32 * m, mg)
    got.sum().backward()
    out["nll"] = rel(got.detach(), want.detach())
    out["nll_grad"] = rel(block.grad, whole.grad[..., 32 * m:32 * (m + 1)])
    # Leaves (8, 6) cut: rows over "data", cols over "model", both, none.
    cuts = {"d": ("data", None), "m": (None, "model"),
            "dm": ("data", "model"), "w": (None, None)}
    wholes = {k: torch.randn((8, 6), generator=gen) for k in cuts}
    params = {k: torch.randn((8, 6), generator=gen) for k in cuts}

    def block_of(t, names):
        if names[0]:
            t = t[4 * d:4 * (d + 1)]
        if names[1]:
            t = t[:, 3 * m:3 * (m + 1)]
        return t.contiguous()

    groups = {k: LeafGroups(names, tuple({"data": dg, "model": mg}.get(n)
                                         for n in names),
                            tuple(2 if n else 1 for n in names))
              for k, names in cuts.items()}
    grads = {k: block_of(v, cuts[k]) for k, v in wholes.items()}
    out["norm"] = rel(_global_norm(grads, groups), _global_norm(wholes))
    opt_whole, opt_cut = adafactor(1e-2), adafactor(1e-2, groups=groups)
    pw, _ = opt_whole.update(wholes, opt_whole.init(params), params, 0)
    local = {k: block_of(v, cuts[k]) for k, v in params.items()}
    pc, _ = opt_cut.update(grads, opt_cut.init(local), local, 0)
    out["adafactor"] = max(rel(pc[k], block_of(pw[k], cuts[k]))
                           for k in cuts)
    return out


def _tp_resume(cfg, settings, whole, batches, mesh, straight,
               tmp: str) -> dict:
    """Kill and resume across meshes, through the launcher's checkpoint
    path: ``straight`` (the whole state after every batch on ``mesh``
    without a stop, :func:`_tp_run`'s) against 2 steps, the whole state
    gathered and written by rank 0, restored on one process (rank 0
    alone, ``init_train_state``'s template) and written again, then
    restored over the mesh (cut again) and stepped on; the resumed
    state, gathered, bit for bit, and the one process's restore against
    the gathered state."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core import collectives
    from repro_torch.distributed import (TRAIN_RULES, gather_whole,
                                         shard_params)
    from repro_torch.launch.train import state_specs, whole_template
    from repro_torch.train import init_train_state, make_train_step

    specs = state_specs(cfg)
    step = make_train_step(cfg, settings, mesh)
    state = shard_params(whole, specs, mesh, TRAIN_RULES)
    for b in batches[:2]:
        state, _ = step(state, b)
    a, b_dir = os.path.join(tmp, "ckpt_mesh"), os.path.join(tmp, "ckpt_one")
    gathered = gather_whole(state, specs, mesh, TRAIN_RULES)
    if dist.get_rank() == 0:
        save_checkpoint(a, 2, gathered)
        one, at = restore_checkpoint(
            a, init_train_state(cfg, settings, device="cpu"))
        one_equal = _bits_equal(one, gathered) and at == 2
        save_checkpoint(b_dir, 2, one)
    collectives.barrier()
    resumed, at = restore_checkpoint(
        b_dir, whole_template(cfg, state, mesh),
        sharding=lambda t: shard_params(t, specs, mesh, TRAIN_RULES))
    for b in batches[2:]:
        resumed, _ = step(resumed, b)
    out = {"equal": _bits_equal(gather_whole(resumed, specs, mesh,
                                             TRAIN_RULES), straight)
           and at == 2}
    if dist.get_rank() == 0:
        out["one_equal"] = one_equal
    return out


def _bits_equal(a, b) -> bool:
    la, lb = leaves_of(a), leaves_of(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def tp_pod_job(world: int, inputs: str) -> dict:
    """The digest pod form (``pod_impl="shard_map"``, interval 5) of
    qwen3-0.6b SMOKE at 4 heads / 2 KV heads over (pod 2, data 2, model 2)
    from ``inputs``' parameters: each step's metrics and census, and this
    pod's whole params after the last step (its pod's rank 0 returns
    them)."""
    import pickle

    from repro_torch.configs import get_smoke_arch
    from repro_torch.core import collectives
    from repro_torch.distributed import (TRAIN_RULES, gather_whole,
                                         shard_params, train_state_specs)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import arch_specs
    from repro_torch.train import TrainSettings, make_train_step

    with open(inputs, "rb") as f:
        entry = pickle.load(f)
    cfg = dataclasses.replace(get_smoke_arch("qwen3_0_6b"), num_heads=4,
                              num_kv_heads=2)
    settings = TrainSettings(sync_mode="digest", n_pod=2,
                             pod_impl="shard_map", sync_interval=5,
                             total_steps=20, warmup_steps=2)
    mesh = make_mesh(2, pod=2, model=2)
    specs = train_state_specs(arch_specs(cfg), cfg.optimizer)
    state = shard_params(_whole_state(cfg, settings, entry["params"]), specs,
                         mesh, TRAIN_RULES)
    step = make_train_step(cfg, settings, mesh)
    metrics, census = [], []
    for b in entry["batches"]:
        collectives.reset_collectives()
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        census.append(dict(collectives.COLLECTIVES))
        metrics.append({k: float(v) for k, v in m.items()})
    final = gather_whole(state["params"], arch_specs(cfg), mesh, TRAIN_RULES)
    out = {"pod": mesh.get_local_rank("pod"), "metrics": metrics,
           "census": census,
           "digests": [_digest(x) for x in leaves_of(final)]}
    if dist.get_rank() % 4 == 0:
        out["params"] = [p.numpy() for p in leaves_of(final)]
    return out


def dry_census_job(world: int) -> dict:
    """The dry run's port-against-port cases (``tests/torch_dry_cases.py``)
    run for real on this rank: qwen3-0.6b SMOKE's train step, prefill and
    decode step over ("data", "model") = 2 x 2 and the collective GCN
    epoch over ("pod", "data") = 2 x 2; each case's census over one call
    (calls and result bytes by op, the bytes by span), which
    ``tests/test_torch_dryrun.py`` holds the dry run's against."""
    import torch_dry_cases as cases
    from repro_torch.core import collectives
    from repro_torch.launch.mesh import make_mesh

    def census(run) -> tuple:
        collectives.reset_collectives()
        run()
        return (dict(collectives.COLLECTIVES),
                dict(collectives.COLLECTIVE_BYTES),
                dict(collectives.COLLECTIVE_SPANS))

    mesh = make_mesh(2, 1, "cpu", 2)
    out = {kind: census(cases.lm_real(kind, mesh))
           for kind in cases.LM_SHAPES}
    out["gnn"] = census(cases.gnn_run(make_mesh(2, 2), meta=False)[0])
    return out
