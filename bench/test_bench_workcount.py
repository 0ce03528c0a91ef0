"""The work models of the roofline and MFU readers against counts made
by hand on a six-node graph cut in two, and the trace arithmetic on a
hand-made trace."""
import numpy as np
import torch

from bench import harness, peaks, profiling, spec
from bench.reference import digest, partition

# 0-1-2-3-4-5 plus 0-2; parts {0, 1, 2} and {3, 4, 5}.
EDGES = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [0, 2]])
ASSIGN = np.array([0, 0, 0, 1, 1, 1])
GCN = {"model": "gcn", "num_layers": 3, "hidden_dim": 4, "heads": 1,
       "graph": {"feature_dim": 5, "num_classes": 3}}


def _stats():
    adj = partition.adjacency(6, EDGES, "cpu")
    parts = digest.build_parts(adj, ASSIGN, 2, np.zeros(6, np.int64),
                               np.ones(6, bool), "cpu")
    return harness.partition_stats(parts)


def test_partition_counts():
    # Part 0: 0 <- {0, 1, 2}, 1 <- {0, 1, 2}, 2 <- {0, 1, 2} inside,
    # 2 <- 3 across; part 1: 3 <- {3, 4}, 4 <- {3, 4, 5}, 5 <- {4, 5}
    # inside, 3 <- 2 across.
    assert _stats() == {"parts": [
        {"nodes": 3, "in_edges": 9, "cross_edges": 1, "halo": 1},
        {"nodes": 3, "in_edges": 7, "cross_edges": 1, "halo": 1}],
        "boundary": 2}


def test_gcn_spmm_work():
    ops = spec.metric_module("spmm_roofline.train").work(GCN, _stats())
    # Per part and layer: 2 FLOPs a slot and feature; 8 bytes a slot,
    # the part's rows read once and written once; layers 1 and 2 twice
    # (the table gradient).  Part 0: 90 + 4 x 72; part 1: 70 + 4 x 56.
    assert sum(f for f, _ in ops) == 90 + 4 * 72 + 70 + 4 * 56
    assert sum(b for _, b in ops) == (72 + 120) + 4 * (72 + 96) \
        + (56 + 120) + 4 * (56 + 96)


def test_gcn_halo_work():
    ops = spec.metric_module("halo_spmm_roofline.train").work(GCN,
                                                              _stats())
    # Each part: one cross slot, one halo row, three output rows.
    assert sum(f for f, _ in ops) == 2 * (10 + 8 + 8)
    assert sum(b for _, b in ops) == 2 * ((8 + 80) + 2 * (8 + 64))


def test_gcn_model_flops():
    mfu = spec.metric_module("mfu.train")
    # Dense: 2 n d_in d_out, x2 at layer 0, x3 above; aggregation:
    # 2 (in + cross) d_in, plus 2 in d_in (table gradient) above.
    part0 = 240 + 100 + 288 + 152 + 216 + 152
    part1 = 240 + 80 + 288 + 120 + 216 + 120
    assert mfu.model_flops(GCN, _stats(), 10) == part0 + part1


def test_bound_takes_the_larger_term():
    assert peaks.bound_s([(67e12, 1.0), (0.0, 3.35e12)]) == 2.0


def test_trace_arithmetic():
    tr = {"span": (0, 100),
          "device": [("void spmm_kernel<float, 4>", 10, 30),
                     ("elementwise", 20, 40),
                     ("void spmm_kernel<float, 4>", 60, 70)],
          "host": [("aten::mm", 0, 50), ("cudaLaunchKernel", 44, 48),
                   ("aten::item", 65, 100),
                   ("cudaMemcpyAsync", 80, 95)]}
    assert profiling.busy_ns(tr) == 40
    assert profiling.window_ns(tr) == 100
    assert profiling.kernel_ns(tr, [r"\bspmm_kernel\b"]) == 30
    assert profiling.idle_gaps(tr, 2) == [
        ["aten::item > cudaMemcpyAsync", 30e-9], ["aten::mm", 20e-9]]
    assert profiling.top_ops(tr, 1) == [["void spmm_kernel<float, 4>",
                                         30e-9]]
    # 40 ns busy over 2 traced epochs, against 25 ns an untraced epoch.
    ctx = {"trace": {**tr, "busy_ns": 40, "window_ns": 100},
           "profiled_epochs": 2, "untraced_epoch_s": 25e-9}
    assert abs(spec.metric_module("device_idle_pct.train").read(ctx)
               - 20.0) < 1e-9


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -1.0 - 2 ** -10 - 2 ** -12])
    assert digest.round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9,
                                             -1.0 - 2 ** -10]
