"""One run of one cell: set-up, the timed window, the comparison.

Set-up draws the graph and the parameters from the seed, hands them to
the program (``repro_torch``: ``from_edges``, ``prepare_graph_data``,
``init_state``, ``make_epoch_fn``) and drives that same training state
through whole sync periods that cover the compared epochs: max(3, N)
epochs, so that an N = 10 cell's comparison reaches its first pull.  The
window calls ``epoch_fn(state, data)`` back to back over whole periods
until ``seconds`` have passed; each epoch's metrics stay on the device
until it has closed.  With ``trace`` the first periods of the window are
profiled (at least two and at least 20 epochs) and the rest timed untraced
call by call.  Then the program's state is freed, and the plain
reference (``bench/reference``) works out the partition and the compared
epochs again from the same inputs.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import torch

from bench import compare, graphgen, profiling, spec
from bench.reference import digest as ref_digest
from bench.reference import partition as ref_partition

SPAN = "bench.traced_periods"
TRACED_EPOCHS_MIN = 20
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _log(what: str, since: float) -> float:
    now = time.perf_counter()
    print(f"bench: {what} {now - since:.2f} s", file=sys.stderr, flush=True)
    return now


def compared_steps(sync_interval: int) -> int:
    return max(3, sync_interval)


def warm_epochs(sync_interval: int) -> int:
    """Whole sync periods covering the compared epochs."""
    return sync_interval * math.ceil(compared_steps(sync_interval)
                                     / sync_interval)


def draw_params(config: dict, seed: int, device) -> dict:
    """The initial parameters in the program's layout (``layer_{l}`` ->
    ``w``, ``b``; GAT also ``a_src``, ``a_dst``), drawn on ``device`` in
    one call: ``w`` N(0, 1 / d_in), attention vectors N(0, 0.02^2),
    biases 0."""
    gen = torch.Generator(device=device).manual_seed(
        int(seed) & (2 ** 64 - 1))
    shapes = []
    for ell, (d_in, heads, dh) in enumerate(spec.layer_dims(config)):
        w = (d_in, heads, dh) if config["model"] == "gat" \
            else (d_in, heads * dh)
        shapes.append((ell, "w", w, 1.0 / math.sqrt(d_in)))
        if config["model"] == "gat":
            shapes += [(ell, "a_dst", (heads, dh), 0.02),
                       (ell, "a_src", (heads, dh), 0.02)]
    draw = torch.randn(sum(math.prod(s) for _, _, s, _ in shapes),
                       generator=gen, device=device)
    params, at = {}, 0
    for ell, name, shape, std in shapes:
        size = math.prod(shape)
        params.setdefault(f"layer_{ell}", {})[name] = \
            draw[at:at + size].reshape(shape) * std
        at += size
    for ell, (_, heads, dh) in enumerate(spec.layer_dims(config)):
        params[f"layer_{ell}"]["b"] = torch.zeros(heads * dh, device=device)
    return params


def _flat(tree: dict) -> dict:
    return {f"{lay}.{k}": v for lay in sorted(tree)
            for k, v in sorted(tree[lay].items())}


def _clone(tree: dict) -> dict:
    return {lay: {k: v.clone() for k, v in leaves.items()}
            for lay, leaves in tree.items()}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Program:
    """The system under test, set up for one cell."""

    def __init__(self, config: dict, traffic: dict, graph: dict,
                 params: dict, device):
        from repro_torch.core import digest
        from repro_torch.core.halo_exchange import HaloPrecision
        from repro_torch.graph.graph import from_edges
        from repro_torch.models.gnn import GNNConfig
        from repro_torch.optim import adam

        g = from_edges(graph["num_nodes"], graph["edges"],
                       graph["features"], graph["labels"],
                       masks=(graph["train"], graph["val"], graph["test"]))
        self.data = digest.prepare_graph_data(
            g, config["num_parts"], method=config["partitioner"],
            device=device)
        gr = config["graph"]
        # As the training launcher builds it (launch/train_gnn.py).
        cfg = GNNConfig(
            model=config["model"], num_layers=config["num_layers"],
            in_dim=gr["feature_dim"], hidden_dim=config["hidden_dim"],
            num_classes=gr["num_classes"], heads=config["heads"],
            halo_occupancy=self.data["_worklist"].occupancy,
            gat_halo_dedup=config.get("gat_halo_dedup", True))
        opt = adam(config["learning_rate"])
        precision = HaloPrecision(traffic["store_precision"])
        self.state = digest.init_state(cfg, opt, self.data,
                                       precision=precision,
                                       params=_clone(params))
        self.epoch_fn = digest.make_epoch_fn(
            cfg, opt, digest.TrainSettings(
                sync_interval=traffic["sync_interval"], mode="digest",
                precision=precision))

    def epoch(self):
        self.state, metrics = self.epoch_fn(self.state, self.data)
        return metrics

    def grad1(self) -> dict:
        """The first epoch's mean gradient, from Adam's first moment after
        one step (m = (1 - b1) g)."""
        return {k: v / (1 - ref_digest.ADAM_B1) for k, v in
                _flat(self.state["opt_state"]["m"]).items()}


def _window(prog: Program, sync_interval: int, seconds: float, trace: bool,
            device) -> dict:
    losses, out = [], {}

    def periods(count, times=None):
        for _ in range(count * sync_interval):
            t = time.perf_counter()
            losses.append(prog.epoch()["loss"])
            if times is not None:
                times.append(time.perf_counter() - t)

    t0 = time.perf_counter()
    if trace:
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        n_traced = max(2, math.ceil(TRACED_EPOCHS_MIN / sync_interval))
        with profile(activities=acts) as prof:
            with record_function(SPAN):
                periods(n_traced)
                _sync(device)
            traced_s = time.perf_counter() - t0
        out["traced_epochs"] = n_traced * sync_interval
        out["prof"] = prof
        # The untraced rest of the window starts once the profiler has
        # stopped: its teardown is no epoch's time.
        t1 = time.perf_counter()
        times = []
        while True:
            periods(1, times)
            if time.perf_counter() - t1 >= seconds - traced_s:
                break
        _sync(device)
        out["dispatch_s"] = times
        out["untraced_epoch_s"] = (time.perf_counter() - t1) / len(times)
    else:
        while True:
            periods(1)
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
    out["wall_s"] = time.perf_counter() - t0
    out["losses"] = torch.stack(losses).float().cpu()
    return out


def reference_setup(config: dict, graph: dict, device) -> tuple:
    """The reference's own adjacency, partition and subgraphs, the
    features on ``device``, and the partition's counts that the work
    models of ``bench/metrics`` read."""
    adj = ref_partition.adjacency(graph["num_nodes"], graph["edges"],
                                  device)
    assign = ref_partition.greedy_partition(adj["indptr"], adj["indices"],
                                            config["num_parts"])
    parts = ref_digest.build_parts(adj, assign, config["num_parts"],
                                   graph["labels"], graph["train"], device)
    return (parts, torch.from_numpy(graph["features"]).to(device),
            partition_stats(parts))


def partition_stats(parts: list) -> dict:
    """The counts the work models read: each subgraph's nodes, live
    in-subgraph slots (self loops included), live cross slots and
    distinct halo rows, and the store's rows (the union of the halos)."""
    return {"parts": [{"nodes": len(p["nodes"]),
                       "in_edges": len(p["in_dst"]),
                       "cross_edges": len(p["x_dst"]),
                       "halo": len(p["halo"])} for p in parts],
            "boundary": int(torch.unique(torch.cat(
                [p["halo"] for p in parts])).numel())}


def reference_run(config: dict, traffic: dict, parts: list,
                  x: torch.Tensor, params0: dict,
                  variant=ref_digest.Variant()) -> dict:
    """The compared epochs, worked out by the reference (``variant``: in
    the program's place, the control or a planted fault)."""
    n = traffic["sync_interval"]
    return ref_digest.train(config["model"], parts, x, params0,
                            config["hidden_dim"], config["learning_rate"],
                            n, compared_steps(n), variant)


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX
    package (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def warm_up(cell: dict, seed: int, device) -> tuple:
    """Set-up: the graph and parameters from ``seed``, the program built
    on them and driven through its warm-up periods.  Returns (program,
    the compared epochs' record, graph, parameters); the record's losses
    are still on the device."""
    config, traffic = cell["config"], cell["traffic"]
    n = traffic["sync_interval"]
    t = time.perf_counter()
    graph = graphgen.generate(config, seed)
    params0 = draw_params(config, seed, device)
    t = _log("graph and parameters drawn in", t)
    prog = Program(config, traffic, graph, params0, device)
    t = _log("program set up in", t)
    steps = compared_steps(n)
    rec = {"losses": []}
    for r in range(1, warm_epochs(n) + 1):
        loss = prog.epoch()["loss"]
        if r <= steps:
            rec["losses"].append(loss)
        if r == 1:
            rec["grad1"] = {k: v.clone() for k, v in prog.grad1().items()}
        if r == steps:
            rec["params"] = {k: v.clone()
                             for k, v in _flat(prog.state["params"]).items()}
    _sync(device)
    _log(f"{warm_epochs(n)} warm-up epochs in", t)
    return prog, rec, graph, params0


def judge(cell: dict, rec: dict, graph: dict, params0: dict,
          device) -> tuple:
    """The reference's run of the compared epochs and the numbers that
    decide ``correct`` (run once the program's state is freed).  Returns
    (numbers, the partition's counts)."""
    t = time.perf_counter()
    rec = {**rec, "losses": [float(v) for v in
                             torch.stack(rec["losses"]).cpu()]}
    parts, x, stats = reference_setup(cell["config"], graph, device)
    ref = reference_run(cell["config"], cell["traffic"], parts, x, params0)
    _log("reference in", t)
    return compare.numbers(rec, ref, _flat(params0)), stats


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = None) -> dict:
    """One run of ``cell`` (:func:`bench.spec.resolve`).  Returns the
    result line's fields plus ``"compared"`` (number -> [value, limit])
    and, with ``trace``, the per-layer readings."""
    t_start = time.perf_counter() if t_start is None else t_start
    config, traffic = cell["config"], cell["traffic"]
    n = traffic["sync_interval"]
    prog, rec, graph, params0 = warm_up(cell, seed, device)
    setup_s = time.perf_counter() - t_start

    win = _window(prog, n, seconds, trace, device)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    epochs = len(win["losses"])
    failed = int((~torch.isfinite(win["losses"])).sum())
    prof = win.pop("prof", None)
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    _log(f"window of {epochs} epochs closed;", t_start + setup_s)
    nums, stats = judge(cell, rec, graph, params0, device)
    correct = compare.verdict(nums, cell["limits"]) and failed == 0

    result = {"correct": correct, "attempted": epochs, "failed": failed,
              "seconds_window": win["wall_s"], "epochs": epochs,
              "memory_peak_bytes": peak, "setup_s": setup_s,
              "compared": {k: [nums[k], lim]
                           for k, lim in cell["limits"].items()},
              "worst": {k: v for k, v in nums.items()
                        if k not in cell["limits"]}}
    if not trace:
        result["metrics"] = {
            "epoch_ms": 1e3 * win["wall_s"] / epochs,
            "peak_mem_gib": peak / 2 ** 30,
            "setup_s": setup_s}
        return result
    tr = profiling.summarize(prof, SPAN)
    del prof
    tr["busy_ns"] = profiling.busy_ns(tr)
    tr["window_ns"] = profiling.window_ns(tr)
    ctx = {"config": config, "traffic": traffic, "stats": stats,
           "trace": tr, "profiled_epochs": win["traced_epochs"],
           "dispatch_s": win["dispatch_s"],
           "untraced_epoch_s": win["untraced_epoch_s"]}
    readings = {}
    for m in cell["per_layer"]:
        value = spec.metric_module(m["name"]).read(ctx)
        if value is not None:
            readings[m["name"]] = value
    result["metrics"] = readings
    result["busy_s"] = tr["busy_ns"] / 1e9
    result["window_s"] = tr["window_ns"] / 1e9
    result["breakdown"] = {"device_ops": profiling.top_ops(tr),
                           "idle_gaps": profiling.idle_gaps(tr)}
    return result
