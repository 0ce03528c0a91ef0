"""Spawned ranks for the port's mesh tests (``tests/test_torch_collective.py``,
``tests/test_torch_serving.py``, ``tests/test_torch_checkpoint.py``); this
module holds their jobs and no test of its own.

:func:`spawn` starts ``world`` ranks with ``torch.multiprocessing`` (the
``spawn`` method), joins them into a ``gloo`` process group through a
file store and runs one job on each; a rank that raises fails the spawn.
Each job runs its port-against-port checks inside the ranks (the
collective path against the single-process path computed in the same
rank) and returns what the calling test holds against the reference.
This module imports no JAX, so the ranks start quickly.
"""
from __future__ import annotations

import dataclasses
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


def lm_pod_job(world: int, steps: int, interval: int) -> dict:
    """The LM trainer's pod form (``pod_impl="shard_map"``, one rank a pod
    of a ("pod", "data") = world x 1 mesh) against its stacked form
    (``"vmap"``, all pods in this rank), qwen3-0.6b SMOKE at vocab 64,
    batch 2 a pod x 16: every step's loss, ce and aux, and this pod's
    params and optimizer state after every step, bit for bit; the census
    of every step; and the refusals of meshes the form cannot take."""
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
    for label, mesh_fn in (("none", lambda: None),
                           ("data only", lambda: make_mesh(world)),
                           ("data 2", lambda: make_mesh(2, world // 2))):
        if label == "data 2" and world < 4:
            continue
        try:
            make_train_step(cfg, pods, mesh_fn())
            refusals[label] = None
        except (ValueError, NotImplementedError) as e:
            refusals[label] = (type(e).__name__, str(e))
    return {"pod": pod, "equal": equal, "census": census,
            "divergence": divergence, "refusals": refusals}
