"""halo_spmm_roofline.train: the share of their roofline that the
halo kernels of ``repro_torch/kernels/spmm/halo_pull.py`` reach in a
training epoch: K2/K3 (``halo_list_kernel``, ``halo_walk_kernel``) and
K4 (``halo_skip_kernel``), the products of every GCN layer over the
subgraph's pulled halo slab (layer 0: its raw-feature slab).

Bounds as in ``spmm_roofline.train``: 2 FLOPs a live cross edge and
feature; bytes for each live slot's index and weight, each distinct halo
row once and each output row once.  GAT's halo products run in K1 and
are counted there; a GAT cell launches none of these kernels, and the
metric's ``workloads`` in ``BENCHMARK.json`` name the GCN cells alone.
"""
from bench import peaks, spec

KERNELS = (r"\bhalo_list_kernel\b", r"\bhalo_walk_kernel\b",
           r"\bhalo_skip_kernel\b")


def work(config: dict, stats: dict) -> list:
    """(flops, bytes) of each halo product an epoch (GCN)."""
    ops = []
    for p in stats["parts"]:
        n, ex, h = p["nodes"], p["cross_edges"], p["halo"]
        for d_in, _, _ in spec.layer_dims(config):
            ops.append((2 * ex * d_in, 8 * ex + 4 * (h + n) * d_in))
    return ops


def read(ctx: dict):
    tr = ctx.get("trace")
    if not tr:
        return None
    ops = work(ctx["config"], ctx["stats"])
    from bench.profiling import kernel_ns
    ns = kernel_ns(tr, KERNELS)
    if ns <= 0:
        return None
    per_epoch_s = ns / 1e9 / ctx["profiled_epochs"]
    return 100.0 * peaks.bound_s(ops) / per_epoch_s
