"""mfu.train: the whole training epoch's share of the card's float32
peak: model FLOPs an epoch over (untraced epoch time x 67 TFLOP/s).

The untraced epoch time is the wall time of the untraced part of a
``--trace 1`` window, ending in a synchronise, over its epochs.  Model
FLOPs count each product once, with no recompute, and no elementwise
work (activations, normalisation, softmax, Adam):

* dense products: forward, the weight gradient, and the input gradient
  where the input depends on the parameters (layers 1 and up);
* aggregations: 2 FLOPs a live edge and feature forward; backward the
  table gradient where the table is differentiated and, for GAT, the
  weight (attention) gradient;
* GAT: its attention scores (a dot product a node and head, forward and
  two backward), the layer-0 projection of each subgraph's halo rows
  (forward and weight gradient), and the pull's projection of the store
  (every hidden layer, once each sync period).
"""
from bench import peaks, spec


def model_flops(config: dict, stats: dict, sync_interval: int) -> float:
    total = 0.0
    dims = spec.layer_dims(config)
    gat = config["model"] == "gat"
    for p in stats["parts"]:
        n, ei, ex, h = p["nodes"], p["in_edges"], p["cross_edges"], p["halo"]
        for ell, (d_in, heads, dh) in enumerate(dims):
            hd = heads * dh
            dense = 2 * n * d_in * hd
            total += dense * (3 if ell >= 1 else 2)
            agg = 2 * (ei + ex) * hd if gat else 2 * (ei + ex) * d_in
            total += agg
            if not gat:
                total += 2 * ei * d_in if ell >= 1 else 0
                continue
            total += agg                                   # weights' grad
            total += 2 * ei * hd + (2 * ex * hd if ell == 0 else 0)
            total += 3 * 2 * (2 * n + h) * hd              # scores
            if ell == 0:
                total += 2 * 2 * h * d_in * hd              # halo proj.
    if gat:
        hidden = config["hidden_dim"]
        for d_in, heads, dh in dims[1:]:
            total += 2 * stats["boundary"] * hidden * heads * dh \
                / sync_interval
    return total


def read(ctx: dict):
    epoch_s = ctx.get("untraced_epoch_s")
    if not epoch_s:
        return None
    flops = model_flops(ctx["config"], ctx["stats"],
                        ctx["traffic"]["sync_interval"])
    return 100.0 * flops / (epoch_s * peaks.FP32_FLOPS)
