#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card and
check it.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each ending the run with a non-zero exit on failure:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions;
2. build the CUDA kernels from ``src/repro_torch/csrc``: each source's
   ``nvcc`` seconds, and ptxas's register and spill lines of the kernels
   redesigned for Hopper (the warp-per-row bodies of K1, K2, K3, K4 and
   the table gradient, K6's bf16 wgmma body);
3. every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (products-sim, scale 1.0, 8 parts: K1 on
   the full-graph ELL at widths 100 and 128 and on a bf16 or fp32 query
   batch, K2/K3 on a 256-query batch over the 12616-row serving store with
   the store's own scales; the batch's real edges and distinct chunks a
   row are printed), within atol = rtol = 1e-5, K3 == K2 (K1 for an
   unscaled slab) exactly when one chunk covers the slab, and K3's chunk
   walk (``walk_ms``, the body it takes for rows too long for its edge
   list) == K3; each
   timed (``ms``: device time per call, 20 calls queued behind a spin
   kernel between two CUDA events; ``kernel_ms``: the median of 20 single
   calls between CUDA events, host launch gap included) beside its plain
   version, its byte/operation bound and one PyTorch library call
   (``torch.sparse.mm`` on the CSR form of the ELL) as a yardstick;
4. the serving main path (under ``torch.inference_mode``): the paper's
   GCN config (products-sim, 3 layers, hidden
   128, 8 parts, random weights from ``torch.Generator`` seed 0), for an
   int8, a bf16 and an fp32 serving store: top-layer representations, two
   in-place store refreshes, then 64 Zipf batches of 256 queries behind a
   2048-row 4-way hot-row cache, and 8 more batches traced with
   ``torch.profiler`` (device ms a batch, busy share, top device ops).
   The refresh forward's h^(L-1) is held
   against a forward through the gather-form oracles, and the first and
   last batches' logits against the top layer recomputed from the store's
   own (dequantised) rows, all within 1e-5; the launch counters must show
   K1 in the refresh forward and K2 (int8), K1 (bf16) or K3 (fp32) in the
   queries;
5. SAGE and GAT (same sizes, int8 store): one refresh and 8 batches each,
   with the same check;
6. the training kernels at the training path's shapes (papers-sim, scale
   1.0, 8 parts, rcm order, 256-row chunks; subgraph 0): K4 on the out-ELL
   (5256 x 64) over a (14289, 128) fp32, bf16 and int8 slab with its
   worklist, held against its plain version within 1e-5, equal to K3 bit
   for bit (K3 and its walk timed there too: ``k3_ms``, ``k3_walk_ms``),
   and visiting exactly its worklist; K1 on the in-ELL (5256 x 56, its
   real edges a row printed) over a (5257, 128) fp32 table and GAT's
   per-head (5257, 32) one, and on the out-ELL over the (14289, 128) bf16
   slab; ``spmm_bwd_table`` on the in-ELL into the (5257, 128) and
   (5257, 32) tables (its live positions a row printed) and
   ``spmm_bwd_wts`` at GAT's per-head shape (over a (5257, 32) table),
   both also held against autograd of the gather oracle; timed as in
   phase 3, beside ``torch.sparse.mm`` on the CSR (K1, K4) or transposed
   CSR (table gradient) and ``torch.sparse.sampled_addmm`` (weight
   gradient);
7. the training main path: full-batch DIGEST (Algorithm 1, N = 10, Adam
   5e-3) of the paper's GCN widths (``repro_torch.configs.digest_gcn``,
   3 x 128) on that partition, random weights from ``torch.Generator``
   seed 0: 12 epochs with an fp32 store (pull at r = 10, pushes at r = 1
   and 11), 3 each with int8 and bf16 stores, 2 each of SAGE and GAT
   (fp32).  Each run is held against the same run through the gather-form
   oracles (``backend="jnp"``, differentiated by autograd on the card):
   epoch 1's per-leaf gradients within 1e-5 of each leaf's max |g| (or,
   where a leaf misses that, within twice the oracle's own change when
   the input features are scaled by one ulp: a (Leaky)ReLU input within
   an ulp of its kink takes either slope, which GAT's near-zero attention
   logits make common), and
   the fp32 GCN's (loss, train F1) trajectory within 1e-4 over all 12
   epochs.  K4 must launch exactly 2 layers x 8 subgraphs per fp32 epoch,
   K2 in the int8 epochs, the table-gradient kernel 16 times per bf16
   epoch and the weight-gradient kernel in GAT's.  Epoch times (host
   clock around an epoch ending in a synchronize), val/test F1 and K1's
   launches per epoch by (rows, deg, feat, dtype) are printed;
8. K6 (flash attention) at the LM slice's shape (B 4, S 1024, H 16 over
   KV 8, D 128, causal; and non-causal at S 512), in bf16 and fp32, on
   (B, H, S, D) views of (B, S, H, D) tensors, against its plain
   version: fp32 within 2e-5, bf16 within 2e-5 plus one bf16 ulp of the
   output; K5 (GAT edge softmax) at GAT's per-head shape on subgraph 0
   of the training partition (in-ELL 5256 x 56 over 5257 x 32, out-ELL
   5256 x 64 over 14289 x 32) within 1e-4 on acc and 1e-5 on m and l;
   timed as in phase 3, beside ``scaled_dot_product_attention`` for K6
   (no PyTorch call computes K5), bounded by the bf16 tensor-core or
   fp32 rate or the bytes;
9. LM prefill: qwen3-0.6b at its published widths (28 layers, random
   weights from ``torch.Generator`` seed 0), ``forward`` on 4 x 1024
   seeded tokens with the kernel backend — K6 exactly 28 times and no
   other kernel — against the dense-oracle backend on the same weights:
   in bf16 within twice the oracle's own change when every input
   embedding moves by one bf16 ulp (error, sensitivity and their ratio
   printed), and with fp32 activations within 1e-4 of max |logit|;
   timed, and one more forward traced with ``torch.profiler``;
10. LM decode serving (``launch/serve.py``'s loop): batch 4, a 1056-slot
    cache, 32 tokens, for the full cache and the stale-KV ``long`` cache
    (window 32, ratio 8), ms/token and p50/p99, 8 steps of each traced;
    teacher-forced ``decode_step`` over the first 128 prompt positions
    against the prefill logits within 2e-2 of max |logit| in bf16 and in
    fp32 (each error's ratio to that bar is printed); ``long`` equal to
    the full cache within 1e-4 while t < 32, in fp32;
11. ``gat_aggregate`` on the card (K5, twice per head) on subgraph 0 with
    layer 1 of a GAT at the training widths (4 heads x 32), against its
    plain version and, head by head, the port's own ``_gat_layer`` less
    its bias, within 1e-5 of max |out|; K5 must launch 8 times.

Each path's launch counters are set to 0 just before it and read just
after; the oracle runs launch nothing.  The last lines are the card's
``nvidia-smi`` line, one JSON object ``{"kernels": [...]}`` (each
kernel's launches on its paths, its worst error, its bar and the times
of its main-path variant; K3's also its chunk walk's and its times at
the training shape) and ``{"ok": true, "device": {...}}``.  Without
a card, or outside a checkout, it exits non-zero and prints no result.
TF32 is off throughout (fp32 products run in full fp32).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, the fp32 rate outside the
# tensor cores (the kernels' FMAs are plain fp32) and the dense bf16
# tensor-core rate (the bound of bf16 attention's work).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TOL = 1e-5
# The LM slice's bars: K6 in fp32 at the reference's flash bar
# (tests/test_kernels_attention.py), in bf16 that bar plus one bf16 ulp
# (bf16_bar); K5 at the reference's (tests/test_kernels_gat_edge.py);
# prefill through K6 against the dense oracle in fp32, decode against
# prefill and long against full at the reference's decode bars
# (tests/test_decode_consistency.py).
K6_FP32_TOL = 2e-5
K5_STAT_TOL = 1e-5
K5_ACC_TOL = 1e-4
LM_FP32_TOL = 1e-4
# The bf16 prefill through K6 against the bf16 dense oracle.  Both compute
# attention in fp32 and round its output to bf16 once, in different
# orders, so each layer's attention output may differ by about one bf16
# ulp, and the 28 layers after carry that on.  The oracle's own change
# when every input embedding moves by one bf16 ulp (the same rounding,
# injected once at the input) measures how far such a difference travels;
# the K6 path is held within LM_BF16_SENS_FACTOR times that, relative to
# max |logit|, the rule GAT's gradients follow (PERF.md section 2).
LM_BF16_SENS_FACTOR = 2.0
DECODE_TOL = 2e-2
LONG_TOL = 1e-4
# The LM slice's shapes: qwen3-0.6b prefill of 4 x 1024 tokens, decode of
# 32 tokens into a 1056-position cache, teacher forcing over 128.
LM_BATCH = 4
LM_SEQ = 1024
LM_MAX_SEQ = 1056
LM_GEN = 32
LM_TEACHER = 128
BATCH = 256
BATCHES = 64
TRACED = 8          # query batches traced after the timed loop
ZIPF_SKEW = 1.1

# name: (title, source, the TPU kernel it replaces, the variant whose
# times the summary line carries).  The backward kernels replace no
# Pallas kernel: the reference autodiffs its jnp oracle.
KERNELS = {
    "spmm": ("K1 ELL SpMM", "src/repro_torch/csrc/spmm.cu",
             "src/repro/kernels/spmm/spmm.py:49", "full float32 w128"),
    "halo_spmm": ("K2 fused halo pull (resident)",
                  "src/repro_torch/csrc/halo_pull.cu",
                  "src/repro/kernels/spmm/halo_pull.py:128", "int8"),
    "halo_spmm_stream": ("K3 fused halo pull (stream)",
                         "src/repro_torch/csrc/halo_pull.cu",
                         "src/repro/kernels/spmm/halo_pull.py:251", "fp32"),
    "halo_spmm_skip": ("K4 fused halo pull (chunk-skipping stream)",
                       "src/repro_torch/csrc/halo_pull.cu",
                       "src/repro/kernels/spmm/halo_pull.py:365", "fp32"),
    "spmm_bwd_table": ("SpMM backward, table gradient (transposed ELL)",
                       "src/repro_torch/csrc/spmm_bwd.cu",
                       "src/repro/kernels/spmm/ref.py:8 (autodiff of "
                       "spmm_ref; no Pallas kernel)", "in-ELL w128"),
    "spmm_bwd_wts": ("SpMM backward, weight gradient (GAT attention)",
                     "src/repro_torch/csrc/spmm_bwd.cu",
                     "src/repro/kernels/spmm/ref.py:8 (autodiff of "
                     "spmm_ref; no Pallas kernel)", "in-ELL head w32"),
    "gat_edge_partial": ("K5 GAT edge-softmax partial",
                         "src/repro_torch/csrc/gat_edge.cu",
                         "src/repro/kernels/gat_edge/gat_edge.py:72",
                         "out-ELL head w32"),
    "flash_attention": ("K6 flash attention (LM prefill)",
                        "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/"
                        "flash_attention.py:76", "bf16 causal S1024"),
}
# Each kernel's bar against its plain version (measure's ``allowed``).
TOLERANCES = {
    "spmm": "atol = rtol = 1e-5", "halo_spmm": "atol = rtol = 1e-5",
    "halo_spmm_stream": "atol = rtol = 1e-5",
    "halo_spmm_skip": "atol = rtol = 1e-5",
    "spmm_bwd_table": "atol = rtol = 1e-5",
    "spmm_bwd_wts": "atol = rtol = 1e-5",
    "gat_edge_partial": "acc atol = rtol = 1e-4; m, l 1e-5",
    "flash_attention": "fp32 atol = rtol = 2e-5; bf16 2e-5 + one bf16 "
                       "ulp of the output",
}
SERVING_KERNELS = ("spmm", "halo_spmm", "halo_spmm_stream")
TRAINING_KERNELS = ("spmm", "halo_spmm", "halo_spmm_skip", "spmm_bwd_table",
                    "spmm_bwd_wts")
# The path each later kernel runs on, beside serving and training.
PATH_OF = {"flash_attention": "prefill", "gat_edge_partial": "gat_aggregate"}
# The training configuration: the paper's GCN widths on papers-sim, whose
# rcm / 256-row-chunk partition has worklist occupancy 0.475, so the fp32
# store's hidden layers select K4.
TRAIN_PARTS = 8
TRAIN_CHUNK_ROWS = 256
TRAIN_EPOCHS = 12
TRAJ_TOL = 1e-4


# Kernels redesigned for Hopper, by source: ptxas's register and spill
# lines of their instantiations are printed after the build.
REDESIGNED = {"halo_pull": ("halo_list_kernel", "halo_walk_kernel",
                            "halo_skip_kernel"),
              "flash_attention": ("flash_attention_wgmma",),
              "spmm": ("spmm_kernel",), "spmm_bwd": ("bwd_table_kernel",)}

# K1's launches by (rows, deg, feat, dtype), tallied by tally_k1_shapes.
K1_SHAPES = collections.Counter()


def tally_k1_shapes() -> None:
    """Make K1's launching function also tally each launch's (rows, deg,
    feat, table dtype) in K1_SHAPES, beside the wrapper's own count."""
    import importlib

    k1 = importlib.import_module("repro_torch.kernels.spmm.spmm")
    inner = k1._spmm_forward

    def counted(nbr, wts, table):
        if table.device.type == "cuda" and nbr.shape[0] * table.shape[1]:
            K1_SHAPES[(int(nbr.shape[0]), int(nbr.shape[1]),
                       int(table.shape[1]),
                       str(table.dtype).split(".")[-1])] += 1
        return inner(nbr, wts, table)

    k1._spmm_forward = counted


def ptxas_lines(log: str, kernel: str) -> list:
    """ptxas's ``-v`` lines (entry, stack/spills, registers) of every
    instantiation of ``kernel`` in a build log."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep and ("Compiling entry" in line or "spill" in line
                     or "Used" in line):
            lines.append(line.strip())
    return lines


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def event_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call of ``fn`` between two CUDA events
    (``reps`` calls after ``warmup``).  For a short kernel this includes
    the host's launch gap after the first event."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Milliseconds of device time per call of ``fn``: ``reps`` calls are
    enqueued behind a spin kernel (``torch.cuda._sleep``), so the two CUDA
    events around them time the card running them back to back, not the
    host's launch gaps (as long as a 20-60 us kernel through the Python
    wrapper).  The spin is lengthened until it outlasts the enqueueing."""
    for _ in range(warmup):
        fn()
    cycles = 10_000_000
    while True:
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        covered = not a.query()       # the spin outlasted the enqueueing
        b.synchronize()
        if covered:
            return a.elapsed_time(b) / reps
        cycles *= 4
        check(cycles <= 10 ** 10, "cannot enqueue faster than the card runs")


def measure(torch, records, name, variant, shape, got, want, run, plain,
            bound_, library, lib_want, allowed=None, lib_tol=1e-4):
    """Hold a kernel's output ``got`` against its plain version's
    ``want``: elementwise within ``allowed(want)`` (default atol = rtol =
    TOL, as ``allclose``); check that the library yardstick computes the
    same function (``lib_want``, within ``lib_tol``); time all three and
    append the record.  ``library`` None: no PyTorch call computes it."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if allowed is None:
        def allowed(w):
            return TOL + TOL * w.float().abs()
    ratio = float((diff / allowed(want)).max())
    check(ratio <= 1, f"{name} [{variant}] disagrees with its plain version: "
          f"max |err| {err:.3e}, {ratio:.3f} of its bar")
    times = {"ms": device_ms(torch, run),
             "kernel_ms": event_ms(torch, run),
             "plain_ms": event_ms(torch, plain, reps=5, warmup=1),
             "library_ms": None}
    if library is not None:
        lib = library()
        check(torch.allclose(lib.float(), lib_want.float(), atol=lib_tol,
                             rtol=lib_tol),
              f"library yardstick of {name} [{variant}] computes another "
              "function")
        times["library_ms"] = device_ms(torch, library)
    check(all(isinstance(t, float) and t > 0 for t in times.values()
              if t is not None),
          f"{name} [{variant}]: a timing is missing: {times}")
    records.append({"name": name, "variant": variant, "shape": shape,
                    "max_abs_err": err, "bar_ratio": ratio,
                    "bound_ms": bound_[0], "bound_by": bound_[1], **times})


def roofline(nbytes: float, flops: float,
             flops_per_s: float = FP32_FLOPS_PER_S) -> tuple:
    """(least ms, "bytes" or "operations") on an H100 SXM."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound(torch, nbr, wts, slabs, scales, feat):
    """Least time for the work on an H100 SXM: the larger of the bytes
    that must move (nbr and wts read once, each referenced slab row and
    scale read once, the fp32 output written once) over the HBM rate and
    the FMAs of the nonzero-weight edges over the fp32 rate."""
    rows_ref = int(torch.unique(nbr).numel())
    nbytes = (nbr.numel() * 4 + wts.numel() * 4 + nbr.shape[0] * feat * 4
              + sum(rows_ref * feat * s.element_size() for s in slabs)
              + sum(rows_ref * 4 for s in scales if s is not None))
    flops = 2 * int((wts != 0).sum()) * feat * len(slabs)
    return roofline(nbytes, flops)


def csr_of(torch, nbr, wts, n_tab):
    """The ELL as a CSR matrix (nonzero weights only, duplicates summed)
    — the input of the library yardstick."""
    rows, deg = nbr.shape
    keep = wts != 0
    r = torch.arange(rows, device=nbr.device)[:, None].expand(rows, deg)
    idx = torch.stack([r[keep], nbr[keep].long()])
    with warnings.catch_warnings():      # "sparse CSR is in beta" notices
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(idx, wts[keep], (rows, n_tab))
        return coo.coalesce().to_sparse_csr()


def kernel_phase(torch, dev, data, plan, queries):
    """Phase 3: each kernel against its plain version at the main path's
    shapes; returns one record per (kernel, variant)."""
    from repro_torch.core.halo_exchange import (HaloPrecision,
                                                dequantize_rows,
                                                quantize_rows)
    from repro_torch.kernels.spmm import (STREAM_CHUNK_ROWS, halo_spmm_cuda,
                                          halo_spmm_plain,
                                          halo_spmm_stream_cuda,
                                          halo_spmm_stream_plain,
                                          halo_spmm_stream_walk_cuda,
                                          spmm_cuda, spmm_plain)
    gen = torch.Generator().manual_seed(1)

    def randn(rows, feat):
        t = torch.randn((rows, feat), generator=gen)
        t[-1] = 0                                  # zero sentinel row
        return t.to(dev)

    records = []

    def record(name, variant, got, want, run, plain, nbr, wts, slabs,
               scales, lib_table):
        feat = got.shape[1]
        csr = csr_of(torch, nbr, wts, lib_table.shape[0])
        measure(torch, records, name, variant,
                list(nbr.shape) + [int(lib_table.shape[0]), feat], got,
                want, run, plain, bound(torch, nbr, wts, slabs, scales, feat),
                lambda: torch.sparse.mm(csr, lib_table), want)

    # K1 on the full-graph in-ELL (the refresh forward's aggregation): at
    # the layer-0 width (the 100 input features) and the hidden width.
    nbr = data["full_struct"]["in_nbr"][0]
    wts = data["full_struct"]["in_wts"][0]
    for dtype, width in ((torch.float32, 128), (torch.bfloat16, 128),
                         (torch.float32, 100)):
        tab = randn(nbr.shape[0] + 1, width).to(dtype)
        record("spmm", f"full {str(dtype).split('.')[-1]} w{width}",
               spmm_cuda(nbr, wts, tab), spmm_plain(nbr, wts, tab),
               lambda: spmm_cuda(nbr, wts, tab),
               lambda: spmm_plain(nbr, wts, tab), nbr, wts, [tab], [None],
               tab.float())

    # K2 / K3 on one query batch against the serving store's slab, with
    # the scales the store holds (none for bf16 and fp32): there K2's
    # wrapper hands the unscaled slab to K1, as the bf16 queries do.
    qdata = plan.query_data(dev)
    q = torch.from_numpy(queries[0]).to(dev).long()
    qnbr = qdata["serve_map"][qdata["nbr"][q].long()]
    qwts = qdata["wts"][q]
    # What K2's and K3's work depends on: the real (nonzero-weight) edges
    # of a query row and the distinct slab chunks its ELL slots read.
    chunks = torch.sort(torch.div(qnbr, STREAM_CHUNK_ROWS,
                                  rounding_mode="floor"), dim=1).values
    distinct = 1 + (chunks[:, 1:] != chunks[:, :-1]).sum(1)
    print(f"K2/K3 input: query batch {tuple(qnbr.shape)} over "
          f"{plan.store_rows} store rows, "
          f"{float((qwts != 0).sum(1).float().mean()):.3f} real edges a row, "
          f"{float(distinct.float().mean()):.3f} distinct "
          f"{STREAM_CHUNK_ROWS}-row chunks a row (of "
          f"{-(-plan.store_rows // STREAM_CHUNK_ROWS)})", flush=True)
    slab = randn(plan.store_rows, 128)
    pslab = randn(plan.store_rows, 128)
    gamma = 0.5
    for storage in ("int8", "bf16", "fp32"):
        prec = HaloPrecision(storage)
        data_, scale = quantize_rows(slab, prec)
        for pred in (False, True):
            pdata = pscale = None
            if pred:
                pdata, pscale = quantize_rows(pslab, prec)
            args = (qnbr, qwts, data_, scale, pdata, pscale, gamma)
            deq = dequantize_rows(data_, scale)
            if pred:
                deq = deq + gamma * dequantize_rows(pdata, pscale)
            variant = storage + ("+gamma" if pred else "")
            slabs = [data_] + ([pdata] if pred else [])
            scl = [scale, pscale]
            k2 = halo_spmm_cuda(*args)
            if scale is None and pdata is None:
                record("spmm", f"query {storage}", k2,
                       spmm_plain(qnbr, qwts, data_),
                       lambda: spmm_cuda(qnbr, qwts, data_),
                       lambda: spmm_plain(qnbr, qwts, data_), qnbr, qwts,
                       slabs, scl, deq)
            else:
                record("halo_spmm", variant, k2, halo_spmm_plain(*args),
                       lambda: halo_spmm_cuda(*args),
                       lambda: halo_spmm_plain(*args), qnbr, qwts, slabs,
                       scl, deq)
            k3 = halo_spmm_stream_cuda(*args)
            check(torch.allclose(k3, k2, atol=TOL, rtol=TOL),
                  f"K3 [{variant}] disagrees with K2")
            one = halo_spmm_stream_cuda(*args, chunk_rows=plan.store_rows)
            check(torch.equal(one, k2),
                  f"K3 over one chunk [{variant}] is not equal to K2 (K1 "
                  "for an unscaled slab)")
            record("halo_spmm_stream", variant, k3,
                   halo_spmm_stream_plain(*args),
                   lambda: halo_spmm_stream_cuda(*args),
                   lambda: halo_spmm_stream_plain(*args), qnbr, qwts, slabs,
                   scl, deq)
            # K3's other body, the chunk walk, on the same call.
            check(torch.equal(halo_spmm_stream_walk_cuda(*args), k3),
                  f"K3's chunk walk [{variant}] is not equal to K3")
            records[-1]["walk_ms"] = device_ms(
                torch, lambda: halo_spmm_stream_walk_cuda(*args))
    return records


def serve_path(torch, dev, cfg, params, data, plan, storage, refreshes,
               queries, hot_label):
    """One main-path run: reps, store, refreshes, Zipf batches, then the
    parity checks.  Returns its summary with the launches per phase."""
    from repro_torch.core import serving
    from repro_torch.core.digest import empty_halo_struct, top_layer_reps
    from repro_torch.core.halo_exchange import (HaloPrecision,
                                                dequantize_rows,
                                                layer_table)
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.launch.serving_driver import (profile_serve_loop,
                                                   run_serve_loop)
    from repro_torch.models.gnn import gnn_layer

    n = plan.num_nodes
    c0 = dict(LAUNCHES)
    t0 = time.perf_counter()
    reps = top_layer_reps(cfg, params, data)
    store = serving.init_serve_store(plan, cfg.hidden_dim,
                                     HaloPrecision(storage), dev)
    refresh = serving.make_refresh_fn()
    rdata = plan.refresh_data(dev)
    for _ in range(refreshes):
        store = refresh(store, reps, rdata)
    torch.cuda.synchronize()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    c1 = dict(LAUNCHES)

    scfg = serving.ServeConfig(batch_size=BATCH, cache_rows=2048,
                               cache_ways=4, storage=storage)
    qdata = plan.query_data(dev)

    def step(cache, q):
        logits, cache = serving.serve_query(
            cfg, scfg, params, store, cache, qdata,
            torch.from_numpy(q).to(dev))
        return cache, logits

    cache, outs, stats = run_serve_loop(
        step, queries, carry=serving.init_cache(scfg, cfg.num_classes, dev),
        warmup=4, items_per_call=BATCH)
    # Where a batch's device time goes: TRACED more batches, traced.
    trace = profile_serve_loop(step, queries[:TRACED], carry=cache, top=4)
    c2 = dict(LAUNCHES)

    # References, through the gather-form oracles (backend "jnp"), which
    # launch no kernel and share no code with the kernels they check:
    # (1) the refresh forward's h^(L-1) — every K1 launch of the forward,
    # GAT's per-head ones included, feeds it; (2) the top layer over the
    # store's own (dequantised) rows in the full view — for fp32 the rows
    # of full_graph_forward's top layer — held against the first batch
    # (all cache misses) and the last (mostly hits).
    label = f"{cfg.model}/{storage}"
    oracle = dataclasses.replace(cfg, backend="jnp")
    want_reps = top_layer_reps(oracle, params, data)
    reps_err = float((reps - want_reps).abs().max())
    check(torch.allclose(reps, want_reps, atol=TOL, rtol=TOL),
          f"{label}: refresh forward's h^(L-1) differs from the oracle "
          f"forward: max |err| {reps_err:.3e}")
    deq = dequantize_rows(*layer_table(serving.store_bare(store), 0))
    x = torch.zeros_like(reps)
    x[:n] = deq[torch.from_numpy(plan.serve_map[:n]).to(dev).long()]
    if storage == "fp32":
        check(torch.equal(x[:n], reps[:n]), "fp32 store rows != reps")
    struct = {k: v[0] for k, v in data["full_struct"].items()}
    tables, struct = empty_halo_struct(cfg, struct)
    top = params[f"layer_{cfg.num_layers - 1}"]
    ref = gnn_layer(oracle, top, x, tables[-1], struct)
    err = 0.0
    for which, got, q in (("first", outs[0], queries[0]),
                          ("last", outs[-1], queries[-1])):
        want = ref[torch.from_numpy(q).to(dev).long()]
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{label}: served logits of the {which} batch malformed")
        e = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=TOL, rtol=TOL),
              f"{label}: served logits of the {which} batch differ from the "
              f"full-graph top layer: max |err| {e:.3e}")
        err = max(err, e)
    return {"path": label, "model": cfg.model, "storage": storage,
            "layers": cfg.num_layers, "hidden": cfg.hidden_dim,
            "refreshes": refreshes, "batches": len(queries),
            "batch": BATCH, "zipf_skew": ZIPF_SKEW, "hot": hot_label,
            "refresh_ms": refresh_ms, "p50_ms": stats.p50_ms,
            "p99_ms": stats.p99_ms, "per_sec": stats.per_sec,
            "hit_rate": serving.hit_rate(cache), "max_abs_err": err,
            "device_ms_per_batch": trace["device_ms"] / TRACED,
            "busy_share": trace["busy_share"], "device_top": trace["top"],
            "reps_max_abs_err": reps_err,
            "launches_refresh": {k: c1[k] - c0[k] for k in c0},
            "launches_queries": {k: c2[k] - c1[k] for k in c0}}


def run(torch, dev) -> tuple:
    """Phases 3-5 on the card ``dev``; returns the kernels' records and
    the launches of the serving main path."""
    import numpy as np

    from repro_torch.core import serving
    from repro_torch.core.digest import prepare_graph_data, top_layer_reps
    from repro_torch.graph import make_dataset
    from repro_torch.kernels import _build
    from repro_torch.models.gnn import GNN, GNNConfig

    t0 = time.perf_counter()
    g = make_dataset("products-sim", scale=1.0, seed=0)
    data = prepare_graph_data(g, 8, seed=0, device=dev)
    plan = serving.build_serve_plan(data)
    print(f"graph: products-sim scale 1.0: {g.num_nodes} nodes, "
          f"{len(g.indices)} ELL entries, full in-ELL "
          f"{tuple(data['full_struct']['in_nbr'].shape[1:])}, store "
          f"{plan.store_rows} rows, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    hot = np.argsort(-g.degrees()).astype(np.int32)
    queries = serving.zipf_queries(g.num_nodes, BATCH, BATCHES, ZIPF_SKEW,
                                   seed=1, hot_ids=hot)

    records = kernel_phase(torch, dev, data, plan, queries)
    print(json.dumps({"kernel_variants": records}), flush=True)

    def model(name):
        cfg = GNNConfig(model=name, num_layers=3,
                        in_dim=g.features.shape[1], hidden_dim=128,
                        num_classes=int(g.labels.max()) + 1, heads=4)
        return cfg, GNN.init(cfg, torch.Generator().manual_seed(0),
                             dev).tree()

    cfg, params = model("gcn")
    top_layer_reps(cfg, params, data)       # warm up cuBLAS and the caches
    _build.reset_launches()
    expect = {"int8": "halo_spmm", "bf16": "spmm",
              "fp32": "halo_spmm_stream"}
    for storage in ("int8", "bf16", "fp32"):
        res = serve_path(torch, dev, cfg, params, data, plan, storage, 2,
                         queries, "descending degree")
        print(json.dumps(res), flush=True)
        check(res["launches_refresh"]["spmm"] > 0,
              f"{res['path']}: K1 not launched in the refresh forward")
        check(res["launches_queries"][expect[storage]] == BATCHES + TRACED,
              f"{res['path']}: {expect[storage]} launched "
              f"{res['launches_queries'][expect[storage]]} times in "
              f"{BATCHES + TRACED} batches")
    main_launches = dict(_build.LAUNCHES)
    check(all(main_launches[k] > 0 for k in SERVING_KERNELS),
          f"a kernel of the serving path never launched: {main_launches}")

    for name in ("sage", "gat"):
        cfg, params = model(name)
        res = serve_path(torch, dev, cfg, params, data, plan, "int8", 1,
                         queries[:8], "descending degree")
        print(json.dumps(res), flush=True)
        check(res["launches_refresh"]["spmm"] > 0,
              f"{res['path']}: K1 not launched in the refresh forward")

    return records, main_launches


def training_kernel_phase(torch, dev, data):
    """K4 and the SpMM backward kernels against their plain versions at
    the training path's shapes (subgraph 0 of papers-sim, 8 parts, rcm,
    256-row chunks), K4 == K3 bit for bit; returns one record per
    (kernel, variant)."""
    from repro_torch.core.halo_exchange import (HaloPrecision,
                                                dequantize_rows,
                                                quantize_rows)
    from repro_torch.kernels.spmm import (halo_spmm_skip_cuda,
                                          halo_spmm_skip_plain,
                                          halo_spmm_stream_cuda,
                                          halo_spmm_stream_walk_cuda,
                                          spmm_bwd_table,
                                          spmm_bwd_table_plain, spmm_bwd_wts,
                                          spmm_bwd_wts_plain, spmm_cuda,
                                          spmm_plain, spmm_ref)
    gen = torch.Generator().manual_seed(2)
    records = []
    st = {k: v[0] for k, v in data["struct"].items()}
    nbr, wts = st["out_nbr"], st["out_wts"]
    ids, cnt = st["wl_ids"], st["wl_cnt"]
    n_tab = int(data["halo_ids"].shape[1]) + 1
    # What K4's work depends on: the real (nonzero-weight) edges of an
    # out-ELL row and the chunks on its row block's worklist.
    print(f"K4 input: out-ELL {tuple(nbr.shape)}, "
          f"{float((wts != 0).sum(1).float().mean()):.3f} real edges a row, "
          f"{float(cnt.float().mean()):.3f} worklist chunks a row block",
          flush=True)
    slab = torch.randn((n_tab, 128), generator=gen)
    slab[-1] = 0
    slab = slab.to(dev)
    for storage in ("fp32", "bf16", "int8"):
        sdata, scale = quantize_rows(slab, HaloPrecision(storage))
        args = (nbr, wts, sdata, scale, ids, cnt)
        kw = {"chunk_rows": TRAIN_CHUNK_ROWS}
        k4, visits = halo_spmm_skip_cuda(*args, count_visits=True, **kw)
        k3 = halo_spmm_stream_cuda(nbr, wts, sdata, scale, **kw)
        check(torch.equal(k4, k3),
              f"K4 [{storage}] is not equal to K3 at chunk_rows "
              f"{TRAIN_CHUNK_ROWS}")
        check(torch.equal(halo_spmm_stream_walk_cuda(nbr, wts, sdata, scale,
                                                     **kw), k3),
              f"K3's chunk walk [{storage}] is not equal to K3")
        t = torch.arange(ids.shape[1], device=dev)[None, :]
        check(torch.equal(visits, torch.where(t < cnt[:, None], ids, -1)),
              f"K4 [{storage}] did not visit exactly its worklist")
        deq = dequantize_rows(sdata, scale)
        csr = csr_of(torch, nbr, wts, n_tab)
        measure(torch, records, "halo_spmm_skip", storage,
                list(nbr.shape) + [n_tab, 128], k4,
                halo_spmm_skip_plain(*args, **kw),
                lambda: halo_spmm_skip_cuda(*args, **kw),
                lambda: halo_spmm_skip_plain(*args, **kw),
                bound(torch, nbr, wts, [sdata], [scale], 128),
                lambda: torch.sparse.mm(csr, deq), k4)
        # K3 and its chunk walk on the same call: what skipping the
        # worklist's empty chunks saves.
        records[-1]["k3_ms"] = device_ms(
            torch, lambda: halo_spmm_stream_cuda(nbr, wts, sdata, scale,
                                                 **kw))
        records[-1]["k3_walk_ms"] = device_ms(
            torch, lambda: halo_spmm_stream_walk_cuda(nbr, wts, sdata, scale,
                                                      **kw))

    # K1 at the training shapes: the in-subgraph product (in-ELL over the
    # local table, fp32; GAT's per-head w32 tables), and the out-ELL over
    # the halo slab of the bf16 store, which the ladder hands to K1.
    n_in, n_out = st["in_nbr"].shape[0] + 1, n_tab
    in_real = (st["in_wts"] != 0).sum(1).float()
    print(f"K1 input: in-ELL {tuple(st['in_nbr'].shape)}, "
          f"{float(in_real.mean()):.3f} real edges a row (max "
          f"{int(in_real.max())}), out-ELL "
          f"{float((wts != 0).sum(1).float().mean()):.3f}", flush=True)
    for side, dtype, width, n_rows in (("in", torch.float32, 128, n_in),
                                       ("in", torch.float32, 32, n_in),
                                       ("out", torch.bfloat16, 128, n_out)):
        knbr, kwts = st[f"{side}_nbr"], st[f"{side}_wts"]
        tab = torch.randn((n_rows, width), generator=gen)
        tab[-1] = 0
        tab = tab.to(dev, dtype)
        csr = csr_of(torch, knbr, kwts, n_rows)
        measure(torch, records, "spmm",
                f"train {side}-ELL {str(dtype).split('.')[-1]} w{width}",
                list(knbr.shape) + [n_rows, width],
                spmm_cuda(knbr, kwts, tab), spmm_plain(knbr, kwts, tab),
                lambda: spmm_cuda(knbr, kwts, tab),
                lambda: spmm_plain(knbr, kwts, tab),
                bound(torch, knbr, kwts, [tab], [None], width),
                lambda: torch.sparse.mm(csr, tab.float()),
                spmm_plain(knbr, kwts, tab))

    # Table gradient of an in-subgraph product: in-ELL (5256 x 56) into
    # the (5257, 128) local table (and GAT's per-head (5257, 32) ones),
    # through the transposed in-ELL.
    nbr, wts, pos = st["in_nbr"], st["in_wts"], st["in_pos"]
    rows, deg = nbr.shape
    keep = (wts != 0) & (nbr < rows)
    r = torch.arange(rows, device=dev)[:, None].expand(rows, deg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        csr_t = torch.sparse_coo_tensor(
            torch.stack([nbr[keep].long(), r[keep]]), wts[keep],
            (rows + 1, rows)).coalesce().to_sparse_csr()
    live = int((pos < rows * deg).sum())
    print(f"table-gradient input: transposed in-ELL {tuple(pos.shape)}, "
          f"{live / pos.shape[0]:.3f} live positions a row", flush=True)
    for width in (128, 32):
        g = torch.randn((rows, width), generator=gen).to(dev)
        got = spmm_bwd_table(pos, wts, g)
        tab = torch.zeros((rows + 1, width), device=dev, requires_grad=True)
        with torch.enable_grad():
            spmm_ref(nbr, wts, tab).backward(g)
        oracle = tab.grad.clone()
        oracle[-1] = 0                     # the sentinel gets no gradient
        check(torch.allclose(got, oracle, atol=TOL, rtol=TOL),
              f"spmm_bwd_table [w{width}] disagrees with autograd of the "
              "gather oracle")
        measure(torch, records, "spmm_bwd_table", f"in-ELL w{width}",
                [rows, deg, rows + 1, width], got,
                spmm_bwd_table_plain(pos, wts, g),
                lambda: spmm_bwd_table(pos, wts, g),
                lambda: spmm_bwd_table_plain(pos, wts, g),
                roofline(pos.numel() * 4 + wts.numel() * 4 + g.numel() * 4
                         + (rows + 1) * width * 4, 2 * live * width),
                lambda: torch.sparse.mm(csr_t, g), got)

    # Weight gradient at GAT's per-head shape: the same in-ELL over a
    # (5257, 32) head table.
    head = torch.randn((rows + 1, 32), generator=gen)
    head[-1] = 0
    head = head.to(dev)
    g = torch.randn((rows, 32), generator=gen).to(dev)
    got = spmm_bwd_wts(nbr, g, head)
    w = wts.clone().requires_grad_()
    with torch.enable_grad():
        spmm_ref(nbr, w, head).backward(g)
    check(torch.allclose(got, w.grad, atol=TOL, rtol=TOL),
          "spmm_bwd_wts disagrees with autograd of the gather oracle")
    csr = csr_of(torch, nbr, wts, rows + 1)
    dense = torch.zeros((rows, rows + 1), device=dev)
    dense[r[keep], nbr[keep].long()] = got[keep]
    referenced = int(torch.unique(nbr).numel())

    def library():
        return torch.sparse.sampled_addmm(csr, g, head.t(), beta=0.0)

    lib = library()
    lib_vals = lib.values()
    crow, col = lib.crow_indices(), lib.col_indices()
    lib_rows = torch.repeat_interleave(
        torch.arange(rows, device=dev), crow[1:] - crow[:-1])
    check(torch.allclose(lib_vals, dense[lib_rows, col], atol=1e-4,
                         rtol=1e-4),
          "library yardstick of spmm_bwd_wts computes another function")
    measure(torch, records, "spmm_bwd_wts", "in-ELL head w32",
            [rows, deg, rows + 1, 32], got, spmm_bwd_wts_plain(nbr, g, head),
            lambda: spmm_bwd_wts(nbr, g, head),
            lambda: spmm_bwd_wts_plain(nbr, g, head),
            roofline(nbr.numel() * 4 + g.numel() * 4 + referenced * 32 * 4
                     + rows * deg * 4, 2 * rows * deg * 32),
            lambda: library().values(), lib_vals)
    return records


def capture(opt):
    """``opt`` that also keeps the mean gradient of its last update in
    its state, so a run's gradients can be held leaf by leaf against
    another run's."""
    from repro_torch.optim import Optimizer

    def init(params):
        return {"opt": opt.init(params), "grads": None}

    def update(grads, state, params, step):
        new_params, new_state = opt.update(grads, state["opt"], params,
                                           step)
        return new_params, {"opt": new_state, "grads": grads}

    return Optimizer(opt.name, init, update)


def train_run(torch, cfg, data, storage, params, epochs, lr):
    """``epochs`` epochs of DIGEST from ``params``: the per-epoch (loss,
    train F1, eps), epoch 1's per-leaf mean gradients, the epoch times
    (host clock around an epoch that ends in a synchronize) and the final
    state."""
    from repro_torch.core.digest import (TrainSettings, _leaves, init_state,
                                         make_epoch_fn)
    from repro_torch.core.halo_exchange import HaloPrecision
    from repro_torch.optim import adam

    settings = TrainSettings(sync_interval=10, mode="digest",
                             precision=HaloPrecision(storage))
    opt = capture(adam(lr))
    state = init_state(cfg, opt, data, precision=settings.precision,
                       params=params)
    epoch_fn = make_epoch_fn(cfg, opt, settings)
    traj, times, grads = [], [], None
    for e in range(epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = epoch_fn(state, data)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        traj.append((float(m["loss"]), float(m["train_f1"]),
                     m["staleness_eps"].tolist()))
        if e == 0:
            grads = [g.clone() for g in _leaves(state["opt_state"]["grads"])]
    return traj, grads, times, state


def train_path(torch, cfg, data, storage, params, epochs, lr, kernel,
               expect_per_epoch):
    """One training main-path run and its check against the same run
    through the gather-form oracles (``backend="jnp"``, autograd on the
    card): epoch 1's per-leaf gradients within TOL of each leaf's max
    |g| (or twice the oracle's own one-ulp sensitivity, where larger),
    and, when the run is the long one, the (loss, train F1) trajectory
    within TRAJ_TOL.  Returns its summary."""
    from repro_torch.core.digest import evaluate
    from repro_torch.kernels._build import LAUNCHES

    label = f"train {cfg.model}/{storage}"
    c0, k1_0 = dict(LAUNCHES), collections.Counter(K1_SHAPES)
    traj, grads, times, state = train_run(torch, cfg, data, storage, params,
                                          epochs, lr)
    c1 = dict(LAUNCHES)
    launches = {k: c1[k] - c0[k] for k in c0}
    k1_shapes = K1_SHAPES - k1_0
    check(sum(k1_shapes.values()) == launches["spmm"],
          f"{label}: K1's shape tally {dict(k1_shapes)} does not add up to "
          f"its {launches['spmm']} launches")
    if expect_per_epoch is not None:
        check(launches[kernel] == expect_per_epoch * epochs,
              f"{label}: {kernel} launched {launches[kernel]} times in "
              f"{epochs} epochs, expected {expect_per_epoch * epochs}")
    check(launches[kernel] > 0, f"{label}: {kernel} never launched")
    oracle = dataclasses.replace(cfg, backend="jnp")
    o_epochs = epochs if storage == "fp32" and cfg.model == "gcn" else 1
    o_traj, o_grads, _, _ = train_run(torch, oracle, data, storage, params,
                                      o_epochs, lr)
    check(sum(LAUNCHES.values()) == sum(c1.values()),
          f"{label}: the oracle run launched a kernel")
    rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
           for a, b in zip(grads, o_grads)]
    check(all(bool(torch.isfinite(a).all()) for a in grads),
          f"{label}: epoch-1 gradients not finite")
    floor = [0.0] * len(rel)
    if max(rel) > TOL:
        # The gradient is piecewise smooth: a (Leaky)ReLU input within an
        # ulp of its kink takes either slope, so two fp32 summation orders
        # can differ by a whole term.  Measure how far the oracle itself
        # moves when the input features are scaled by one ulp, and allow
        # twice that where it exceeds TOL.
        for eps in (2.0 ** -23, 2.0 ** -22):
            moved = dict(data, x_global=data["x_global"] * (1 + eps))
            _, p_grads, _, _ = train_run(torch, oracle, moved, storage,
                                         params, 1, lr)
            floor = [max(f, float((p - b).abs().max())
                         / max(float(b.abs().max()), 1e-30))
                     for f, p, b in zip(floor, p_grads, o_grads)]
    for i, (r, f) in enumerate(zip(rel, floor)):
        check(r <= max(TOL, 2 * f),
              f"{label}: epoch-1 gradient of leaf {i} differs from the "
              f"oracle's by {r:.3e} of its max |g| (bar {TOL}, the "
              f"oracle's own one-ulp sensitivity {f:.3e})")
    grad_err = max(rel)
    traj_err = 0.0
    for e, (a, b) in enumerate(zip(traj, o_traj)):
        d = max(abs(a[0] - b[0]), abs(a[1] - b[1]))
        check(d <= TRAJ_TOL, f"{label}: epoch {e + 1} (loss, train F1) "
              f"{a[:2]} differs from the oracle's {b[:2]}")
        traj_err = max(traj_err, d)
    check(all(math.isfinite(t[0]) for t in traj), f"{label}: loss not finite")
    ev = evaluate(cfg, state["params"], data)
    later = times[1:] if len(times) > 1 else times
    return {"path": label, "model": cfg.model, "storage": storage,
            "epochs": epochs, "epoch_ms_median": statistics.median(later),
            "epoch_ms": times, "loss": [t[0] for t in traj],
            "train_f1": [t[1] for t in traj],
            "staleness_eps": [t[2] for t in traj],
            "val_f1": float(ev["val_f1"]), "test_f1": float(ev["test_f1"]),
            "grad_rel_err": grad_err, "grad_rel_err_by_leaf": rel,
            "oracle_ulp_sensitivity_by_leaf": floor,
            "oracle_epochs": o_epochs,
            "traj_max_err": traj_err, "launches": launches,
            "spmm_per_epoch_by_shape": {
                f"{r}x{d} w{f} {dt}": n / epochs
                for (r, d, f, dt), n in sorted(k1_shapes.items())}}


def training(torch, dev) -> tuple:
    """Phases 6-7: the training kernels at the training shapes, then the
    training main path; returns the records and the path's launches."""
    from repro_torch.configs import digest_gcn
    from repro_torch.core.digest import prepare_graph_data
    from repro_torch.graph import make_dataset
    from repro_torch.kernels import _build
    from repro_torch.models.gnn import GNN, GNNConfig

    t0 = time.perf_counter()
    g = make_dataset("papers-sim", scale=1.0, seed=0)
    data = prepare_graph_data(g, TRAIN_PARTS, seed=0, order="rcm",
                              stream_chunk_rows=TRAIN_CHUNK_ROWS, device=dev)
    wl = data["_worklist"]
    print(f"graph: papers-sim scale 1.0: {g.num_nodes} nodes, "
          f"{TRAIN_PARTS} parts rcm, S={data['local_ids'].shape[1]}, "
          f"H={data['halo_ids'].shape[1]}, worklist occupancy "
          f"{wl.occupancy:.4f} (max_chunks {wl.max_chunks} of "
          f"{wl.n_chunks}), built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    with torch.no_grad():
        records = training_kernel_phase(torch, dev, data)
    print(json.dumps({"kernel_variants": records}), flush=True)

    exp = digest_gcn.CONFIG

    def model(name):
        cfg = GNNConfig(model=name, num_layers=exp.num_layers,
                        in_dim=g.features.shape[1],
                        hidden_dim=exp.hidden_dim,
                        num_classes=int(g.labels.max()) + 1,
                        heads=4 if name == "gat" else exp.heads,
                        stream_chunk_rows=TRAIN_CHUNK_ROWS,
                        halo_occupancy=wl.occupancy)
        return cfg, GNN.init(cfg, torch.Generator().manual_seed(0),
                             dev).tree()

    layers = exp.num_layers - 1            # hidden layers reading the store
    runs = (("gcn", "fp32", TRAIN_EPOCHS, "halo_spmm_skip",
             layers * TRAIN_PARTS),
            ("gcn", "int8", 3, "halo_spmm", layers * TRAIN_PARTS),
            ("gcn", "bf16", 3, "spmm_bwd_table", layers * TRAIN_PARTS),
            ("sage", "fp32", 2, "halo_spmm_skip", layers * TRAIN_PARTS),
            ("gat", "fp32", 2, "spmm_bwd_wts", None))
    _build.reset_launches()
    results = []
    for name, storage, epochs, kernel, per_epoch in runs:
        cfg, params = model(name)
        res = train_path(torch, cfg, data, storage, params, epochs,
                         exp.learning_rate, kernel, per_epoch)
        print(json.dumps(res), flush=True)
        results.append(res)
    launches = dict(_build.LAUNCHES)
    check(all(launches[k] > 0 for k in TRAINING_KERNELS),
          f"a kernel of the training path never launched: {launches}")
    return records, launches, data


# ---------------------------------------------------------------------------
# Phases 8-11: the LM slice (K6) and GAT's split aggregation (K5)
# ---------------------------------------------------------------------------

def bf16_bar(w):
    """K6's bf16 bar: both sides compute in fp32 and round once to bf16,
    so they may differ by the fp32 bar plus one bf16 ulp of the output
    (2^-7 of its binade)."""
    import torch
    e = torch.floor(torch.log2(w.float().abs().clamp_min(2.0 ** -126)))
    return K6_FP32_TOL + torch.exp2(e - 7)


def lm_kernel_phase(torch, dev, data):
    """Phase 8: K6 at the LM slice's shape and K5 at GAT's per-head shape
    on the training partition, each against its plain version and timed;
    returns one record per (kernel, variant)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    from repro_torch.kernels.gat_edge import (gat_edge_partial_cuda,
                                              gat_edge_partial_plain)
    gen = torch.Generator().manual_seed(3)
    records = []
    b, h, kv, d = LM_BATCH, 16, 8, 128
    for dtype, causal, s in ((torch.bfloat16, True, LM_SEQ),
                             (torch.float32, True, LM_SEQ),
                             (torch.bfloat16, False, 512),
                             (torch.float32, False, 512)):
        # The main path's layout: (B, H, S, D) views of (B, S, H, D).
        q = torch.randn((b, s, h, d), generator=gen).to(dev, dtype)
        k = torch.randn((b, s, kv, d), generator=gen).to(dev, dtype)
        v = torch.randn((b, s, kv, d), generator=gen).to(dev, dtype)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        got = flash_attention_cuda(qt, kt, vt, causal)
        want = flash_attention_plain(qt, kt, vt, causal)
        bf16 = dtype == torch.bfloat16
        pairs = s * (s + 1) // 2 if causal else s * s
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        measure(torch, records, "flash_attention",
                f"{'bf16' if bf16 else 'fp32'} "
                f"{'causal' if causal else 'non-causal'} S{s}",
                [b, s, h, kv, d], got, want,
                lambda: flash_attention_cuda(qt, kt, vt, causal),
                lambda: flash_attention_plain(qt, kt, vt, causal),
                roofline(nbytes, 4 * b * h * d * pairs,
                         BF16_FLOPS_PER_S if bf16 else FP32_FLOPS_PER_S),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True),
                want, allowed=bf16_bar if bf16 else
                (lambda w: K6_FP32_TOL + K6_FP32_TOL * w.float().abs()),
                lib_tol=3e-2 if bf16 else 1e-4)

    # K5 at GAT's per-head shape (4 heads x 32) on subgraph 0: the in-ELL
    # over the local table and the out-ELL over the halo table.
    st = {k_: v_[0] for k_, v_ in data["struct"].items()}
    rows = st["in_nbr"].shape[0]
    n_halo = int(data["halo_ids"].shape[1])
    s_dst = torch.randn((rows,), generator=gen).to(dev)
    for side, nbr, n_cols in (("in", st["in_nbr"], rows),
                              ("out", st["out_nbr"], n_halo)):
        s_src = torch.randn((n_cols + 1,), generator=gen)
        z = torch.randn((n_cols + 1, 32), generator=gen)
        s_src[-1], z[-1] = 0, 0
        s_src, z = s_src.to(dev), z.to(dev)
        valid = nbr < n_cols
        args = (nbr, valid, s_dst, s_src, z)
        got, want = gat_edge_partial_cuda(*args), gat_edge_partial_plain(*args)
        for name, g_, w_ in (("m", got[1], want[1]), ("l", got[2], want[2])):
            check(torch.allclose(g_, w_, atol=K5_STAT_TOL, rtol=K5_STAT_TOL),
                  f"K5 [{side}]: {name} disagrees with its plain version: "
                  f"max |err| {float((g_ - w_).abs().max()):.3e}")
        n_valid = int(valid.sum())
        ref_rows = int(torch.unique(nbr).numel())
        nbytes = (nbr.numel() * 5 + rows * 4 + ref_rows * 4 * (1 + 32)
                  + rows * 32 * 4 + 2 * rows * 4)
        measure(torch, records, "gat_edge_partial", f"{side}-ELL head w32",
                list(nbr.shape) + [n_cols + 1, 32], got[0], want[0],
                lambda: gat_edge_partial_cuda(*args),
                lambda: gat_edge_partial_plain(*args),
                roofline(nbytes, n_valid * (3 * 32 + 6)), None, None,
                allowed=lambda w: K5_ACC_TOL + K5_ACC_TOL * w.abs())
    return records


def lm_prefill(torch, dev) -> dict:
    """Phase 9: qwen3-0.6b at its published widths, random weights from
    ``torch.Generator`` seed 0, ``forward`` on B x S tokens through the
    kernel backend (K6 in every layer) against the same weights through
    the dense oracle, in bf16 and fp32 activations."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch.serving_driver import profile_serve_loop
    from repro_torch.models.transformer import arch_specs, forward
    from repro_torch.nn import init_params

    cfg = dataclasses.replace(get_arch("qwen3-0.6b"), attn_backend="kernel")
    t0 = time.perf_counter()
    params = init_params(arch_specs(cfg), torch.Generator().manual_seed(0),
                         dev)
    n_params = sum(t.numel() for t in _tree_leaves(params))
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                           generator=torch.Generator().manual_seed(1)
                           ).to(dev)
    print(f"lm: {cfg.name} {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} kv, "
          f"head_dim {cfg.hd}, vocab {cfg.vocab_size}: {n_params} params, "
          f"made in {time.perf_counter() - t0:.2f} s", flush=True)

    def run(c, label, p=params):
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        out = forward(c, p, tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = dict(_build.LAUNCHES)
        check(out.shape == (LM_BATCH, LM_SEQ, cfg.vocab_size)
              and bool(torch.isfinite(out).all()),
              f"prefill [{label}]: logits malformed")
        want_k6 = cfg.num_layers if c.attn_backend == "kernel" else 0
        check(launches["flash_attention"] == want_k6
              and sum(launches.values()) == want_k6,
              f"prefill [{label}]: launches {launches}, expected K6 "
              f"{want_k6} times and nothing else")
        return out, ms, launches

    with torch.inference_mode():
        run(cfg, "warm-up")
        logits, ms, launches = run(cfg, "bf16 kernel")
        _, ms2, _ = run(cfg, "bf16 kernel")
        dense_cfg = dataclasses.replace(cfg, attn_backend="dense")
        dense, dense_ms, _ = run(dense_cfg, "bf16 dense")
        scale = float(dense.abs().max())
        bf16_rel = float((logits - dense).abs().max()) / scale
        # The oracle's one-ulp sensitivity: every input embedding one bf16
        # ulp larger in magnitude (the bf16 bit pattern plus one), the
        # bf16 forward's own rounding of the fp32 table otherwise kept.
        emb = params["embed"].to(torch.bfloat16)
        bumped = (emb.view(torch.int16) + 1).view(torch.bfloat16).float()
        moved, _, _ = run(dense_cfg, "bf16 dense, embeddings + 1 ulp",
                          dict(params, embed=bumped))
        del emb, bumped
        bf16_sens = float((moved - dense).abs().max()) / scale
        del dense, moved
        bf16_ratio = bf16_rel / max(bf16_sens, 1e-30)
        print(f"prefill bf16: K6 path vs dense oracle {bf16_rel:.4e} of max "
              f"|logit|; the oracle's one-ulp sensitivity {bf16_sens:.4e}; "
              f"error / sensitivity {bf16_ratio:.3f} (bar "
              f"{LM_BF16_SENS_FACTOR})", flush=True)
        check(bf16_rel <= LM_BF16_SENS_FACTOR * bf16_sens,
              f"bf16 prefill through K6 differs from the dense oracle by "
              f"{bf16_rel:.3e} of max |logit|, more than "
              f"{LM_BF16_SENS_FACTOR} x the oracle's own one-ulp "
              f"sensitivity {bf16_sens:.3e}")
        c32 = dataclasses.replace(cfg, dtype="float32")
        l32, ms32, _ = run(c32, "fp32 kernel")
        d32, _, _ = run(dataclasses.replace(c32, attn_backend="dense"),
                        "fp32 dense")
        fp32_rel = float((l32 - d32).abs().max()) / float(d32.abs().max())
        check(fp32_rel <= LM_FP32_TOL,
              f"fp32 prefill through K6 differs from the dense oracle by "
              f"{fp32_rel:.3e} of max |logit| (bar {LM_FP32_TOL})")
        logits32 = l32[:, :LM_TEACHER].clone()
        del l32, d32
        # Where a prefill's device time goes (one more bf16 forward,
        # traced; the launch counts above were read before it).
        prof = profile_serve_loop(
            lambda c, _: (c, forward(cfg, params, tokens)), range(1), top=6)
    res = {"path": "lm prefill", "arch": cfg.name, "batch": LM_BATCH,
           "seq": LM_SEQ, "params": n_params, "prefill_ms": ms,
           "prefill_ms_again": ms2, "dense_prefill_ms": dense_ms,
           "fp32_prefill_ms": ms32,
           "tokens_per_s": LM_BATCH * LM_SEQ / (min(ms, ms2) / 1e3),
           "bf16_rel_err_vs_dense": bf16_rel,
           "bf16_oracle_ulp_sensitivity": bf16_sens,
           "bf16_err_over_sensitivity": bf16_ratio,
           "fp32_rel_err_vs_dense": fp32_rel, "launches": launches,
           "profile": prof}
    print(json.dumps(res), flush=True)
    return {"cfg": cfg, "params": params, "tokens": tokens,
            "logits": logits[:, :LM_TEACHER].clone(), "logits32": logits32,
            "launches": launches}


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def lm_decode(torch, dev, pre) -> dict:
    """Phase 10: the serve loop (full and ``long`` caches), teacher-forced
    decode against the prefill logits, and ``long`` against the full
    cache inside the window in fp32."""
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import long_config, serve
    from repro_torch.launch.serving_driver import profile_serve_loop
    from repro_torch.models.transformer import decode_step, init_cache
    from repro_torch.train import make_serve_step

    cfg, params, tokens = pre["cfg"], pre["params"], pre["tokens"]
    out = {"path": "lm decode", "arch": cfg.name, "batch": LM_BATCH,
           "max_seq": LM_MAX_SEQ, "gen": LM_GEN}
    _build.reset_launches()
    for long in (False, True):
        c = long_config(cfg) if long else cfg
        stats, outs, _ = serve(c, params, LM_BATCH, LM_MAX_SEQ, LM_GEN,
                               long=long, device=dev)
        check(all(o.shape == (LM_BATCH, 1, cfg.vocab_size)
                  and bool(torch.isfinite(o).all()) for o in outs),
              f"serve [long={long}]: logits malformed")
        key = "long" if long else "full"
        out[key] = {"ms_per_token": stats.total_s / LM_GEN * 1e3,
                    "p50_ms": stats.p50_ms, "p99_ms": stats.p99_ms,
                    "tokens_per_s": stats.per_sec}
        print(f"serve {cfg.name} long={long} batch={LM_BATCH}: "
              f"{out[key]['ms_per_token']:.3f} ms/token (steady p50 "
              f"{stats.p50_ms:.3f} / p99 {stats.p99_ms:.3f} ms)", flush=True)
    out["launches"] = dict(_build.LAUNCHES)

    with torch.inference_mode():
        # Where a decode step's time goes: 8 steps of each cache, traced.
        for long in (False, True):
            c = long_config(cfg) if long else cfg
            step = make_serve_step(c, long=long)

            def traced(carry, _):
                cache, toks = carry
                logits, cache = step(params, cache, toks)
                return (cache, torch.argmax(logits, dim=-1)), logits

            out["long" if long else "full"]["profile"] = profile_serve_loop(
                traced, range(8), top=6,
                carry=(init_cache(c, LM_BATCH, LM_MAX_SEQ, long=long,
                                  device=dev), tokens[:, :1]))

        # Teacher forcing: decode over the prompts' first positions
        # against the prefill's logits, in bf16 (the served dtype) and in
        # fp32 (the reference's own test runs fp32 activations).
        for key, c, ref in (
                ("bf16", cfg, pre["logits"]),
                ("fp32", dataclasses.replace(cfg, dtype="float32"),
                 pre["logits32"])):
            cache = init_cache(c, LM_BATCH, LM_MAX_SEQ, device=dev)
            steps = []
            for t in range(LM_TEACHER):
                lg, cache = decode_step(c, params, cache, tokens[:, t:t + 1])
                steps.append(lg)
            dec = torch.cat(steps, dim=1)
            rel = float((dec - ref).abs().max()) / float(ref.abs().max())
            check(rel < DECODE_TOL, f"teacher-forced {key} decode differs "
                  f"from the prefill logits by {rel:.3e} of max |logit| "
                  f"(bar {DECODE_TOL})")
            out[f"decode_vs_prefill_rel_err_{key}"] = rel
            out[f"decode_vs_prefill_bar_ratio_{key}"] = rel / DECODE_TOL
            del cache, steps, dec

        c32 = dataclasses.replace(long_config(cfg), dtype="float32")
        cf = init_cache(c32, LM_BATCH, LM_MAX_SEQ, device=dev)
        cl = init_cache(c32, LM_BATCH, LM_MAX_SEQ, long=True, device=dev)
        worst = 0.0
        for t in range(c32.long_window):
            lf, cf = decode_step(c32, params, cf, tokens[:, t:t + 1])
            ll, cl = decode_step(c32, params, cl, tokens[:, t:t + 1],
                                 long=True)
            check(torch.allclose(ll, lf, atol=LONG_TOL, rtol=LONG_TOL),
                  f"long decode differs from the full cache at t={t}: max "
                  f"|err| {float((ll - lf).abs().max()):.3e}")
            worst = max(worst, float((ll - lf).abs().max()))
        out["long_vs_full_max_abs_err"] = worst
    print(json.dumps(out), flush=True)
    return out


def gat_heads_by_k5(torch, p, x_local, x_halo, struct, partial=None):
    """The GAT layer's aggregation through ``gat_aggregate``, one call per
    head, with the layer's ``s_dst``, padded ``src_loc``/``src_out`` and
    ``z_loc``/``z_out`` (models/gnn.py::_gat_layer) as K5's inputs;
    ``partial`` replaces K5 (its plain version, for the check)."""
    from repro_torch.kernels.gat_edge import gat_aggregate, merge_partials

    def pad(x):
        return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])

    S, H = x_local.shape[0], x_halo.shape[0]
    z_loc = pad(torch.einsum("sd,dhk->shk", x_local, p["w"]))
    z_out = torch.einsum("sd,dhk->shk", pad(x_halo), p["w"])
    s_dst = torch.einsum("shk,hk->sh", z_loc[:S], p["a_dst"])
    src_loc = torch.einsum("shk,hk->sh", z_loc, p["a_src"])
    src_out = torch.einsum("shk,hk->sh", z_out, p["a_src"])
    in_nbr, out_nbr = struct["in_nbr"], struct["out_nbr"]
    heads = []
    for h in range(p["a_src"].shape[0]):
        args = (in_nbr, in_nbr < S, out_nbr, out_nbr < H,
                s_dst[:, h].contiguous(), src_loc[:, h].contiguous(),
                src_out[:, h].contiguous(), z_loc[:, h].contiguous(),
                z_out[:, h].contiguous())
        if partial is None:
            heads.append(gat_aggregate(*args))
        else:
            heads.append(merge_partials([partial(*args[0:2], args[4],
                                                 args[5], args[7]),
                                         partial(*args[2:4], args[4],
                                                 args[6], args[8])]))
    return torch.stack(heads, dim=1)


def gat_path(torch, dev, data) -> dict:
    """Phase 11: ``gat_aggregate`` on the card (K5 twice per head) on
    subgraph 0 of the training partition, layer 1 of the GAT at the
    training widths, against its plain version and, head by head, the
    port's own ``_gat_layer`` less its bias."""
    from repro_torch.configs import digest_gcn
    from repro_torch.kernels import _build
    from repro_torch.kernels.gat_edge import gat_edge_partial_plain
    from repro_torch.models.gnn import GNN, GNNConfig, gnn_layer

    exp = digest_gcn.CONFIG
    cfg = GNNConfig(model="gat", num_layers=exp.num_layers,
                    in_dim=int(data["x_global"].shape[1]),
                    hidden_dim=exp.hidden_dim, num_classes=8, heads=4)
    p = GNN.init(cfg, torch.Generator().manual_seed(0), dev).tree()["layer_1"]
    st = {k: v[0] for k, v in data["struct"].items()}
    gen = torch.Generator().manual_seed(4)
    S, H = st["in_nbr"].shape[0], int(data["halo_ids"].shape[1])
    x_local = torch.randn((S, exp.hidden_dim), generator=gen).to(dev)
    x_halo = torch.randn((H, exp.hidden_dim), generator=gen).to(dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        _build.reset_launches()
        got = gat_heads_by_k5(torch, p, x_local, x_halo, st)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        check(launches["gat_edge_partial"] == 2 * cfg.heads,
              f"gat_aggregate: K5 launched {launches['gat_edge_partial']} "
              f"times for {cfg.heads} heads")
        plain = gat_heads_by_k5(torch, p, x_local, x_halo, st,
                                partial=gat_edge_partial_plain)
        layer = gnn_layer(cfg, p, x_local, x_halo, st) - p["b"]
        layer = layer.reshape(got.shape)
    scale = float(layer.abs().max())
    errs = {"vs_plain": float((got - plain).abs().max()) / scale,
            "vs_gat_layer": float((got - layer).abs().max()) / scale}
    check(bool(torch.isfinite(got).all()), "gat_aggregate: not finite")
    for what, e in errs.items():
        check(e <= TOL, f"gat_aggregate {what}: {e:.3e} of max |out| "
              f"(bar {TOL})")
    res = {"path": "gat_aggregate", "rows": S, "halo": H,
           "heads": cfg.heads, "head_dim": exp.hidden_dim // cfg.heads,
           "rel_err": errs, "launches": launches}
    print(json.dumps(res), flush=True)
    return res


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it "
             "from the root of a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}",
          flush=True)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    print(json.dumps({"nvcc_seconds": {
        f"{name}.cu": info["seconds"] for name, info in built.items()}}),
        flush=True)
    for name, names in REDESIGNED.items():
        for kernel in names:
            if name in built:
                print(f"--- ptxas, {name}.cu::{kernel}\n"
                      + "\n".join(ptxas_lines(built[name]["log"], kernel)),
                      flush=True)

    dev = torch.device("cuda", 0)
    tally_k1_shapes()
    t0 = time.perf_counter()
    with torch.inference_mode():
        serve_records, serve_launches = run(torch, dev)
    t_serve = time.perf_counter() - t0
    train_records, train_launches, data = training(torch, dev)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0 - t_serve
    with torch.no_grad():
        lm_records = lm_kernel_phase(torch, dev, data)
    print(json.dumps({"kernel_variants": lm_records}), flush=True)
    pre = lm_prefill(torch, dev)
    lm_decode(torch, dev, pre)
    path_launches = {"prefill": pre["launches"],
                     "gat_aggregate": gat_path(torch, dev, data)["launches"]}
    del pre
    torch.cuda.synchronize()
    print(f"phases: serving {t_serve:.1f} s, training {t_train:.1f} s, "
          f"LM and GAT {time.perf_counter() - t0 - t_serve - t_train:.1f} s",
          flush=True)
    records = serve_records + train_records + lm_records
    kernels = []
    for name, (title, source, replaces, variant) in KERNELS.items():
        mine = [r for r in records if r["name"] == name]
        rec = next(r for r in mine if r["variant"] == variant)
        launches = {"serving": serve_launches[name] if name
                    in SERVING_KERNELS else 0,
                    "training": train_launches[name] if name
                    in TRAINING_KERNELS else 0}
        if name in PATH_OF:
            launches[PATH_OF[name]] = path_launches[PATH_OF[name]][name]
        kernels.append({
            "name": name, "title": title, "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "tolerance": TOLERANCES[name],
            "max_err_over_bar": max(r["bar_ratio"] for r in mine),
            "ms": rec["ms"], "kernel_ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "variant": rec["variant"], "shape": rec["shape"]})
        if name in ("spmm", "spmm_bwd_table"):
            # Its device times at every main-path shape (phases 3 and 6).
            kernels[-1]["ms_by_variant"] = {r["variant"]: r["ms"]
                                            for r in mine}
        if name == "halo_spmm_stream":
            # K3 at the training shape (phase 6, fp32) beside its serving
            # shape, and its chunk walk at both.
            train = next(r for r in train_records
                         if r["name"] == "halo_spmm_skip"
                         and r["variant"] == "fp32")
            kernels[-1].update(walk_ms=rec["walk_ms"],
                               train_ms=train["k3_ms"],
                               train_walk_ms=train["k3_walk_ms"])
        check(kernels[-1]["launches"] > 0, f"{name} never launched")
        check(kernels[-1]["max_err_over_bar"] <= 1,
              f"{name} error above its bar ({TOLERANCES[name]})")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
