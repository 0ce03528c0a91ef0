"""DIGEST-A — asynchronous, non-blocking distributed GNN training, on one
device (the port of ``src/repro/core/async_engine.py``).

The paper's async mode removes the global round barrier: each subgraph
worker fetches the current server parameters, trains locally against its
own (possibly stale) halo cache, and pushes its update whenever it
finishes; the server applies each update at once (bounded-delay async
SGD, Theorem 3).

As in the reference, DIGEST-A is an **event-driven simulator** over the
per-subgraph gradient of the synchronous path: a heap of (finish_time,
worker) events, per-worker compute-time models (with the paper's §5.2
straggler, one worker slowed by a uniform 8–10 s delay), a simulated
clock, and delayed parameter snapshots.  The event order comes from
``np.random.default_rng(settings.seed)`` with the reference's draws in
the reference's order, so it equals the reference's event for event.

Each worker's gradient is ``torch.autograd.grad`` of
:func:`repro_torch.core.digest.make_subgraph_loss` over the parameter
leaves; its halo tables are a private fp32 cache, plain ``(H, d)`` tables
that the layers read through the chunk-worklist ladder (K4 at papers-sim
rcm/256), whatever the store's precision.  The store itself is
owner-sharded and written one shard at a time, in place
(:func:`repro_torch.core.halo_exchange.owner_push`): the loop rebinds the
store after every push and every pull copies, so nothing holds the old
rows.  Parameter snapshots keep references to the parameter tensors;
the optimizer is functional, so a snapshot is never written after it is
taken.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt_io
from repro_torch.core import faults as faults_mod
from repro_torch.core import halo_exchange
from repro_torch.core import predictor as predictor_mod
from repro_torch.core.digest import (_f32, _leaves, _unflatten,
                                     check_worklist_geometry, evaluate,
                                     make_subgraph_loss)
from repro_torch.core.predictor import PredictorConfig
from repro_torch.models.gnn import GNNConfig, gnn_specs
from repro_torch.nn import init_params
from repro_torch.optim import Optimizer

Pytree = Any


@dataclasses.dataclass(frozen=True)
class AsyncSettings:
    sync_interval: int = 10                  # N, counted in worker rounds
    base_round_time: float = 1.0             # sim seconds per worker round
    worker_speed_jitter: float = 0.15        # lognormal jitter of speeds
    straggler: Optional[int] = None          # worker index to slow down
    straggler_delay: tuple[float, float] = (8.0, 10.0)  # paper §5.2
    precision: halo_exchange.HaloPrecision = halo_exchange.HaloPrecision()
    seed: int = 0
    # Round-0 push of every worker's initial representations.  Pulls run
    # at r % N == 0 and pushes at (r-1) % N == 0, so without it a fast
    # worker's first pull at r = N can read never-pushed all-zero rows of
    # a shard whose owner (the straggler, say) has not finished round 1.
    # False keeps the cold store (the probe's positive control).
    warm_start: bool = True
    # Deterministic fault injection (repro_torch.core.faults.FaultConfig):
    # crashes with restart after crash_rounds round-times, dropped pushes
    # with retry and backoff, delayed pulls (the worker keeps its cache)
    # and corrupted pushes the receiver's CRC rejects.  None, or a
    # zero-rate config, leaves the run as without it, bit for bit.
    faults: Optional[faults_mod.FaultConfig] = None
    # Bounded-staleness watchdog in SERVER STEPS: when a valid halo slot
    # a pull is about to read is >= max_staleness steps old, its owner's
    # latest representations are pushed first (a blocking resync).  None
    # disables it.
    max_staleness: Optional[int] = None
    # SAT prediction (repro_torch.core.predictor): every ACCEPTED push
    # advances the owner's history and writes its delta rows into a
    # second store-shaped pstore; pulls read dequant(store) +
    # gamma·dequant(pstore).  kind="none" leaves the run bit for bit the
    # predictor-free one.
    predictor: PredictorConfig = PredictorConfig()


def _host(x) -> np.ndarray:
    """``x`` (a tensor on any device, or an array) as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def store_geometry(data: dict) -> tuple[int, int]:
    """(num_slots, shard_rows) of the owner-sharded store of a prepared
    data dict, audited against the per-shard sentinel layout.

    The store has R = M·shard_rows rows, slot = owner·shard_rows + rank,
    each shard's last row its zero sentinel (``sentinel_slots[m] =
    (m+1)·shard_rows − 1``); ``init_store`` takes ``num_slots = R − 1``
    and its appended global sentinel, row R−1, is shard M−1's sentinel,
    so the async store has the synchronous epoch's layout
    (:func:`repro_torch.core.digest.init_state`).  Raises if the data
    dict's slot views break the layout."""
    total_rows = int(data["store_ids"].shape[0])
    num_parts = int(data["local_slots"].shape[0])
    sentinels = _host(data["sentinel_slots"])
    shard_rows = int(sentinels[0]) + 1
    expect = (np.arange(num_parts) + 1) * shard_rows - 1
    if (total_rows != num_parts * shard_rows
            or not np.array_equal(sentinels, expect)):
        raise ValueError(
            f"owner-sharded store layout violated: {total_rows} rows, "
            f"{num_parts} parts, sentinel_slots={sentinels.tolist()} "
            f"(want (m+1)*shard_rows-1 with shard_rows={shard_rows})")
    return total_rows - 1, shard_rows


def digest_a_train(cfg: GNNConfig, opt: Optimizer, data: dict,
                   settings: AsyncSettings, total_rounds: int,
                   eval_every_rounds: int = 20, seed: int = 0,
                   ckpt_dir: Optional[str] = None,
                   ckpt_every_rounds: int = 0, resume: bool = False,
                   params: Pytree = None) -> tuple[dict, dict]:
    """Run DIGEST-A on ``data``'s device; returns (final_state, history).

    ``history["sim_time"]`` is the simulated wall clock (the paper's
    Figure 7 x-axis).  At each eval tick ``loss`` is the mean of every
    worker's latest round loss and ``delay`` the max staleness over the
    workers; ``round_loss``/``round_worker`` log every completed round,
    ``cold_rows`` the running count of all-zero (never-pushed) valid halo
    rows consumed by pulls (0 under the warm start) and ``pull_age`` the
    running max age, in server steps since the owner's last accepted
    push, over the valid halo slots pulls have read.

    Faults (``settings.faults``; every decision replayable, see
    :mod:`repro_torch.core.faults`): a *crashed* worker skips its round
    and restarts ``crash_rounds`` round-times later, re-fetching the
    parameters and re-pulling its halo; a *dropped* or *corrupted and
    rejected* push leaves the store at its last good rows, and the
    worker retries on later rounds with exponential backoff, sending the
    then-current representations; a *delayed* pull keeps the worker's
    cache and is retried next round.  ``settings.max_staleness`` arms the
    watchdog of :class:`AsyncSettings`.  The final counters are
    ``state["fault_counters"]``.

    ``ckpt_dir`` + ``ckpt_every_rounds`` write a checksummed checkpoint of
    the whole simulator state (parameters, optimizer state, store,
    per-worker caches, snapshots and residuals, the event heap, the age
    table, the fault bookkeeping, the RNG cursor) every N completed
    rounds, in the reference's layout; ``resume=True`` restores the
    newest valid one and continues, equal bit for bit to the unbroken
    run.  ``params`` replaces the initial draw from ``torch.Generator``
    seed ``seed`` (parity tests pass the reference's).
    """
    check_worklist_geometry(cfg, data)
    dev = data["x_global"].device
    rng = np.random.default_rng(settings.seed)
    M = int(data["halo_ids"].shape[0])
    H = int(data["halo_ids"].shape[1])
    S = int(data["local_ids"].shape[1])
    L1 = max(cfg.num_layers - 1, 1)
    hidden = cfg.hidden_dim
    schedule = faults_mod.check_schedule(settings.faults)
    fcfg = settings.faults or faults_mod.FaultConfig()
    ef = settings.precision.error_feedback

    if params is None:
        params = init_params(gnn_specs(cfg),
                             torch.Generator().manual_seed(seed), dev)
    opt_state = opt.init(params)
    num_slots, shard_rows = store_geometry(data)
    store = halo_exchange.init_store(L1, num_slots, hidden,
                                     settings.precision, dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    halo_cache = [zeros(L1, H, hidden) for _ in range(M)]
    push_residual = [zeros(L1, S, hidden) for _ in range(M)]

    # Each worker's inputs, gathered on the device once.
    x_local_all = data["x_global"][data["local_ids"].long()]
    x_halo_all = data["x_global"][data["halo_ids"].long()]
    structs = [{k: v[m] for k, v in data["struct"].items()}
               for m in range(M)]
    local_slots, local_valid = data["local_slots"], data["local_valid"]

    loss_fn = make_subgraph_loss(cfg)

    def worker_grad(p, m):
        """Worker m's loss, gradient (a tree like ``p``) and push rows at
        the parameters ``p``, against its own halo cache."""
        leaves = [x.detach().requires_grad_() for x in _leaves(p)]
        tables = [x_halo_all[m]] + [halo_cache[m][i]
                                    for i in range(cfg.num_layers - 1)]
        loss, (push, _) = loss_fn(_unflatten(p, leaves), x_local_all[m],
                                  tables, structs[m], data["labels"][m],
                                  data["train_mask"][m])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        return loss.detach(), _unflatten(p, grads), push.detach()

    def push_rows(store, m, reps, residual):
        """Worker m's rows into its own shard, in place."""
        if ef:
            return halo_exchange.owner_push_ef(
                store, m, local_slots[m], local_valid[m], reps, residual,
                shard_rows)
        return halo_exchange.owner_push(store, m, local_slots[m],
                                        local_valid[m], reps,
                                        shard_rows), residual

    # SAT predictor state: a store-shaped pstore and a history per worker
    # (leading axis 1, update_history's part axis), advanced on every
    # ACCEPTED push, so it is a pure function of the accepted pushes.
    pcfg = settings.predictor
    pred = pcfg.enabled and cfg.num_layers > 1
    pstore = (halo_exchange.init_store(L1, num_slots, hidden,
                                       settings.precision, dev)
              if pred else None)
    phist = ([predictor_mod.init_history(1, L1, S, hidden, dev)
              for _ in range(M)] if pred else None)
    accepted = torch.ones((1,), dtype=torch.bool, device=dev)

    def apply_accepted_push(m: int, reps):
        """History transition + pstore push of one accepted push of
        worker m: warm start, cadence pushes, retries and forced resyncs
        all come here, and only accepted ones."""
        nonlocal pstore
        phist[m], prows = predictor_mod.update_history(
            phist[m], reps[None], accepted, pcfg)
        pstore = halo_exchange.owner_push(pstore, m, local_slots[m],
                                          local_valid[m], prows[0],
                                          shard_rows)

    # Host slot views for the per-slot age table and the fault paths.
    ls_np, lv_np = _host(local_slots), _host(local_valid)
    hs_np, hv_np = _host(data["halo_slots"]), _host(data["halo_valid"])
    halo_slots = [data["halo_slots"][m][None] for m in range(M)]
    # Server step of the last ACCEPTED push that wrote each store row.
    last_push_step = np.zeros(num_slots + 1, np.int64)
    # The latest representations each worker computed (what a forced
    # resync pushes) and whether any exist yet.
    last_reps = [zeros(L1, S, hidden) for _ in range(M)]
    has_reps = np.zeros(M, bool)
    push_failed = np.zeros(M, bool)
    retry_at = np.zeros(M, np.int64)       # worker round of the next retry
    fail_count = np.zeros(M, np.int64)
    pull_pending = np.zeros(M, bool)       # delayed pull: retry next round
    restarting = np.zeros(M, bool)         # crashed: re-fetch on wake
    counters = {"crashes": 0, "dropped_pushes": 0, "rejected_pushes": 0,
                "retried_pushes": 0, "delayed_pulls": 0,
                "forced_resyncs": 0}
    pull_age_max = 0

    # A resumed run restores a store that already holds later rows, so it
    # skips the warm start.
    resume_step = (ckpt_io.latest_step(ckpt_dir)
                   if (resume and ckpt_dir) else None)

    if settings.warm_start and cfg.num_layers > 1 and resume_step is None:
        # Round-0 PUSH of the representations at the initial parameters:
        # the bits each worker's own round-1 push writes, so no pull ever
        # reads a never-pushed row, straggler or not.
        for m in range(M):
            _, _, push0 = worker_grad(params, m)
            store, push_residual[m] = push_rows(store, m, push0,
                                                push_residual[m])
            if pred:
                apply_accepted_push(m, push0)
            last_reps[m] = push0
            has_reps[m] = True
            last_push_step[ls_np[m][lv_np[m]]] = 0

    # Per-worker speed model.
    speeds = np.exp(rng.normal(0, settings.worker_speed_jitter, size=M))

    def round_time(m: int) -> float:
        t = settings.base_round_time * speeds[m]
        if settings.straggler is not None and m == settings.straggler:
            t += rng.uniform(*settings.straggler_delay)
        return t

    heap = [(round_time(m), m) for m in range(M)]
    heapq.heapify(heap)
    worker_round = np.zeros(M, np.int64)
    step = 0
    hist = {"round": [], "sim_time": [], "loss": [], "val_f1": [],
            "test_f1": [], "delay": [], "round_worker": [],
            "round_loss": [], "cold_rows": [], "pull_age": []}
    snapshot_step = np.zeros(M, np.int64)  # server step of each fetch
    params_snapshots: list = [params] * M
    rounds_done = 0
    # Per-worker trackers behind the eval ticks' mean loss / max delay.
    last_loss = np.full(M, np.nan)
    last_delay = np.zeros(M, np.int64)
    cold_rows = 0

    def ckpt_tree():
        """The whole simulator state as one tree, in the reference's
        layout.  The heap holds one event per worker, so it round-trips
        as two (M,) arrays; heapify of the same multiset pops in the same
        (time, worker) order."""
        hsort = sorted(heap)
        extra = {"pstore": pstore, "phist": phist} if pred else {}
        return {
            "params": params, "opt_state": opt_state, "store": store,
            "step": step, **extra,
            "halo_cache": halo_cache, "push_residual": push_residual,
            "snapshots": params_snapshots,
            "worker_round": worker_round, "snapshot_step": snapshot_step,
            "last_loss": last_loss, "last_delay": last_delay,
            "heap_t": np.asarray([t for t, _ in hsort], np.float64),
            "heap_m": np.asarray([w for _, w in hsort], np.int64),
            "last_push_step": last_push_step,
            "last_reps": torch.stack(last_reps), "has_reps": has_reps,
            "push_failed": push_failed, "retry_at": retry_at,
            "fail_count": fail_count, "pull_pending": pull_pending,
            "restarting": restarting,
        }

    if resume_step is not None:
        tree, _ = ckpt_io.restore_checkpoint(ckpt_dir, ckpt_tree(),
                                             step=resume_step)
        meta = ckpt_io.read_manifest(ckpt_dir, resume_step)["meta"]
        params, opt_state, store = (tree["params"], tree["opt_state"],
                                    tree["store"])
        step = int(tree["step"])
        if pred:
            pstore = tree["pstore"]
            phist = list(tree["phist"])
        halo_cache = list(tree["halo_cache"])
        push_residual = list(tree["push_residual"])
        params_snapshots = list(tree["snapshots"])
        worker_round = tree["worker_round"]
        snapshot_step = tree["snapshot_step"]
        last_loss, last_delay = tree["last_loss"], tree["last_delay"]
        heap = [(float(t), int(w))
                for t, w in zip(tree["heap_t"], tree["heap_m"])]
        heapq.heapify(heap)
        last_push_step = tree["last_push_step"]
        last_reps = list(torch.unbind(tree["last_reps"]))
        has_reps = tree["has_reps"]
        push_failed, retry_at = tree["push_failed"], tree["retry_at"]
        fail_count = tree["fail_count"]
        pull_pending, restarting = (tree["pull_pending"],
                                    tree["restarting"])
        rng.bit_generator.state = meta["rng_state"]
        rounds_done = int(meta["rounds_done"])
        cold_rows = int(meta["cold_rows"])
        counters = dict(meta["counters"])
        pull_age_max = int(meta["pull_age_max"])
        hist = {k: list(v) for k, v in meta["hist"].items()}

    def accept_push(store, m, r, reps, residual):
        """One wire transfer of worker m's rows at its round r, subject to
        the drop / corrupt schedule; the receiver CRC-checks the payload
        and rejects a corrupted one (a drop plus a ``rejected_pushes``
        count).  Returns (store, residual, accepted)."""
        if schedule is not None:
            if schedule.drops_push(r, m):
                counters["dropped_pushes"] += 1
                return store, residual, False
            if schedule.corrupts_push(r, m):
                wire = reps.cpu().numpy()
                sent = faults_mod.corrupt_rows(wire, fcfg.seed, r, m)
                if (faults_mod.wire_crc32(sent)
                        != faults_mod.wire_crc32(wire)):
                    counters["rejected_pushes"] += 1
                    return store, residual, False
        store, residual = push_rows(store, m, reps, residual)
        if pred:
            apply_accepted_push(m, reps)
        last_push_step[ls_np[m][lv_np[m]]] = step
        return store, residual, True

    while rounds_done < total_rounds:
        now, m = heapq.heappop(heap)
        if restarting[m]:
            # A crashed worker coming back re-fetches the parameters and
            # re-pulls its halo before its next round: a restart is a
            # resync, not a resumption of lost in-flight state.
            params_snapshots[m] = params
            snapshot_step[m] = step
            pull_pending[m] = True
            restarting[m] = False
        if schedule is not None and schedule.crashes(worker_round[m] + 1, m):
            # Down instead of running this round: the round's work is lost
            # (the counter advances, so the restart asks a fresh round of
            # the schedule) and the worker restarts crash_rounds
            # round-times later, at its base speed, drawing nothing.
            counters["crashes"] += 1
            worker_round[m] += 1
            restarting[m] = True
            down = fcfg.crash_rounds * settings.base_round_time * speeds[m]
            heapq.heappush(heap, (now + down, m))
            continue
        worker_round[m] += 1
        r = worker_round[m]

        # Periodic PULL from the store into the worker's private fp32
        # cache.  A delayed pull keeps the cache and retries next round;
        # the age table measures how stale the rows read are, and the
        # watchdog pushes overdue owners first.
        if r % settings.sync_interval == 0 or pull_pending[m]:
            if schedule is not None and schedule.delays_pull(r, m):
                counters["delayed_pulls"] += 1
                pull_pending[m] = True
            else:
                pull_pending[m] = False
                if cfg.num_layers > 1:
                    hs, hv = hs_np[m], hv_np[m]
                    ages = step - last_push_step[hs]
                    if settings.max_staleness is not None:
                        over = hv & (ages >= settings.max_staleness)
                        if over.any():
                            # Blocking resync of the overdue owners.
                            for o in np.unique(hs[over] // shard_rows):
                                o = int(o)
                                if not has_reps[o]:
                                    continue
                                store, push_residual[o] = push_rows(
                                    store, o, last_reps[o], push_residual[o])
                                if pred:
                                    apply_accepted_push(o, last_reps[o])
                                last_push_step[ls_np[o][lv_np[o]]] = step
                                push_failed[o] = False
                                fail_count[o] = 0
                                counters["forced_resyncs"] += 1
                            ages = step - last_push_step[hs]
                    if hv.any():
                        pull_age_max = max(pull_age_max,
                                           int(ages[hv].max()))
                pulled = halo_exchange.pull(store, halo_slots[m])[0]
                if pred:
                    # SAT: serve the predicted rows.  A never-pushed slot
                    # is zero in both stores, so the probe below still
                    # sees exact zeros.
                    pulled = pulled + _f32(pcfg.gamma) * halo_exchange.pull(
                        pstore, halo_slots[m])[0]
                # Cold-store probe: a valid halo row that is all-zero in
                # every layer was never pushed (a pushed row is a
                # normalised representation of a real forward).
                zero_rows = ((pulled.abs().amax(dim=(0, 2)) == 0)
                             & data["halo_valid"][m])
                cold_rows += int(zero_rows.sum())
                halo_cache[m] = pulled

        loss, grads, push = worker_grad(params_snapshots[m], m)
        delay = step - int(snapshot_step[m])
        last_loss[m] = float(loss)
        last_delay[m] = delay
        hist["round_worker"].append(m)
        hist["round_loss"].append(float(last_loss[m]))
        # The server applies the update at once (async, non-blocking).
        params, opt_state = opt.update(grads, opt_state, params, step)
        step += 1

        # Periodic PUSH of the fresh representations, with retry and
        # backoff on wire failures: a failed push marks the worker, and
        # later rounds re-send the then-current rows, each attempt again
        # subject to the schedule.
        if cfg.num_layers > 1:
            last_reps[m] = push
            has_reps[m] = True
            if (r - 1) % settings.sync_interval == 0:
                store, push_residual[m], ok = accept_push(
                    store, m, r, push, push_residual[m])
                if ok:
                    push_failed[m] = False
                    fail_count[m] = 0
                else:
                    push_failed[m] = True
                    fail_count[m] += 1
                    retry_at[m] = r + fcfg.retry_backoff
            elif push_failed[m] and r >= retry_at[m]:
                store, push_residual[m], ok = accept_push(
                    store, m, r, push, push_residual[m])
                if ok:
                    counters["retried_pushes"] += 1
                    push_failed[m] = False
                    fail_count[m] = 0
                else:
                    fail_count[m] += 1
                    backoff = min(
                        fcfg.retry_backoff * 2 ** (int(fail_count[m]) - 1),
                        fcfg.retry_backoff_cap)
                    retry_at[m] = r + backoff

        # Fetch the fresh parameters, schedule the next round.
        params_snapshots[m] = params
        snapshot_step[m] = step
        heapq.heappush(heap, (now + round_time(m), m))
        rounds_done += 1

        if rounds_done % eval_every_rounds == 0 or \
                rounds_done == total_rounds:
            ev = evaluate(cfg, params, data)
            seen = ~np.isnan(last_loss)
            hist["round"].append(rounds_done)
            hist["sim_time"].append(float(now))
            hist["loss"].append(float(last_loss[seen].mean()))
            hist["val_f1"].append(float(ev["val_f1"]))
            hist["test_f1"].append(float(ev["test_f1"]))
            hist["delay"].append(int(last_delay.max()))
            hist["cold_rows"].append(cold_rows)
            hist["pull_age"].append(pull_age_max)

        if (ckpt_dir and ckpt_every_rounds
                and rounds_done % ckpt_every_rounds == 0
                and rounds_done < total_rounds):
            meta = {"rng_state": rng.bit_generator.state,
                    "rounds_done": rounds_done, "cold_rows": cold_rows,
                    "counters": counters, "pull_age_max": pull_age_max,
                    "hist": hist}
            ckpt_io.save_checkpoint(ckpt_dir, rounds_done, ckpt_tree(),
                                    meta=meta)

    state = {"params": params, "opt_state": opt_state, "store": store,
             "step": step, "fault_counters": counters,
             "pull_age_max": pull_age_max}
    if pred:
        state["pstore"] = pstore
    return state, hist


def sync_time_per_round(settings: AsyncSettings, M: int,
                        n_rounds: int = 200) -> float:
    """Expected per-round time of *synchronous* DIGEST under the same speed
    model (the barrier waits for the slowest worker, the straggler
    included)."""
    rng = np.random.default_rng(settings.seed)
    speeds = np.exp(rng.normal(0, settings.worker_speed_jitter, size=M))
    total = 0.0
    for _ in range(n_rounds):
        times = settings.base_round_time * speeds
        if settings.straggler is not None:
            times = times.copy()
            times[settings.straggler] += rng.uniform(
                *settings.straggler_delay)
        total += times.max()
    return total / n_rounds
