"""spmm_roofline.train: the share of their roofline that the ELL SpMM
kernels of ``repro_torch/kernels/spmm/spmm.py`` reach in a training
epoch: K1 (``spmm_kernel``), the table gradient (``bwd_table_kernel``)
and the weight gradient (``bwd_wts_kernel``).

Sum of the bounds of the work they do an epoch over their summed device
time an epoch in the traced span.  A bound is max(bytes / HBM rate,
FLOPs / float32 rate) (``bench/peaks.py``); FLOPs are 2 a live slot and
feature, bytes count each live slot's index and weight once, each table
row the live slots need once and each output row once (padding slots and
rows not at all).  The work is the algorithm's, not the launches': a
product that a later change splits or merges counts the same.

GCN: the in-subgraph product of every layer, and its table gradient at
the layers whose input depends on the parameters (1 and up).  The halo
product is K3/K4's (``halo_spmm_roofline.train``).
GAT: per layer, over in-subgraph and halo edges alike, the per-head
product, its weight gradient, the table gradient of the score gather
(unit weights, one column a head), and the products' table gradient
where the table is differentiated (in-subgraph always; halo at layer 0,
whose halo rows are raw features times the current W).
"""
from bench import peaks, spec

KERNELS = (r"\bspmm_kernel\b", r"\bbwd_table_kernel\b",
           r"\bbwd_wts_kernel\b")


def work(config: dict, stats: dict) -> list:
    """(flops, bytes) of each product an epoch."""
    ops = []
    dims = spec.layer_dims(config)
    for p in stats["parts"]:
        n, ei, ex, h = p["nodes"], p["in_edges"], p["cross_edges"], p["halo"]
        for ell, (d_in, heads, dh) in enumerate(dims):
            if config["model"] == "gcn":
                fwd = (2 * ei * d_in, 8 * ei + 2 * 4 * n * d_in)
                ops.append(fwd)
                if ell >= 1:
                    ops.append(fwd)
                continue
            hd = heads * dh
            slots_in = 4 * ei + 4 * ei * heads      # index + a weight a head
            slots_x = 4 * ex + 4 * ex * heads
            ops += [(2 * ei * hd, slots_in + 2 * 4 * n * hd),
                    (2 * ei * hd, slots_in + 2 * 4 * n * hd),
                    (2 * ei * hd, slots_in + 2 * 4 * n * hd),
                    (2 * ei * heads, slots_in + 4 * n * heads),
                    (2 * ex * hd, slots_x + 4 * (n + h) * hd),
                    (2 * ex * hd, slots_x + 4 * (n + h) * hd),
                    (2 * ex * heads, slots_x + 4 * h * heads)]
            if ell == 0:
                ops.append((2 * ex * hd, slots_x + 4 * (n + h) * hd))
    return ops


def read(ctx: dict):
    tr = ctx.get("trace")
    if not tr:
        return None
    from bench.profiling import kernel_ns
    ns = kernel_ns(tr, KERNELS)
    if ns <= 0:
        return None
    per_epoch_s = ns / 1e9 / ctx["profiled_epochs"]
    return 100.0 * peaks.bound_s(work(ctx["config"], ctx["stats"])) \
        / per_epoch_s
