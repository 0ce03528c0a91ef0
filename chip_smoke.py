#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card and
check it.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each ending the run with a non-zero exit on failure:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions;
2. build the CUDA kernels from ``src/repro_torch/csrc``: each source's
   ``nvcc`` seconds, and ptxas's register and spill lines of the kernels
   redesigned for Hopper (the warp-per-row bodies of K1, K2, K3, K4, K5
   and both SpMM gradients, K6's bf16 wgmma and fp32 bodies);
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
   ``spmm_bwd_wts`` at every shape GAT's training gives it (the in-ELL
   over a (5257, w) and the out-ELL over a (14289, w) head table, w 32
   and 8; its dot products a row printed; two launches bit for bit
   equal), both also held against autograd of the gather oracle; and
   the SAT epilogue there, as the ladder selects it once the slab carries
   a predictor: K4 over fp32 and bf16 pdata, K2 over int8 pdata and
   pscale, its bound counting the pdata bytes; timed as in
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
   clock around an epoch ending in a synchronize), val/test F1, and K1's and
   the weight gradient's launches per epoch by (rows, deg, feat, dtype)
   are printed;
8. K6 (flash attention) at the LM slice's shape (B 4, S 1024, H 16 over
   KV 8, D 128, causal; and non-causal at S 512), at kimi-k2's attention
   widths (H 64 over KV 8, D 112, the same four), at llama4-scout's
   (H 40 over KV 8, D 128: five query heads a KV head; causal), at
   llama-3.2-vision's (32 / 8) and at a tensor-parallel rank's heads
   (phase 20; causal): qwen3's 8 / 4, the VLM's 16 / 4 (also at B 1, its
   tensor-parallel prefill's batch), deepseek's 28 / 4 and 14 / 2 (seven
   query heads a KV head) and phi3's 16 / 16 at D 96, in bf16
   and fp32, on (B, H, S, D) views of (B, S, H, D) tensors, against its
   plain version: fp32 within 2e-5, bf16 within 2e-5 plus one bf16 ulp
   of the output; K5 (GAT edge softmax) at GAT's per-head shape on subgraph 0
   of the training partition (in-ELL 5256 x 56 over 5257 x 32, out-ELL
   5256 x 64 over 14289 x 32) and at the reference's test shape ((128, 8)
   over (65, 128)): m equal to its plain version's bit for bit, l within
   1e-5 and acc within 1e-4, two launches equal bit for bit (whether acc
   and l are bit-exact too is printed, not required); timed as in phase
   3, beside ``scaled_dot_product_attention`` for K6 (no PyTorch call
   computes K5), bounded by the bf16 tensor-core or fp32 rate or the
   bytes;
9. LM prefill: qwen3-0.6b at its published widths (28 layers, random
   weights from ``torch.Generator`` seed 0), ``forward`` on 4 x 1024
   seeded tokens with the kernel backend — K6 exactly 28 times and no
   other kernel — against the dense-oracle backend on the same weights:
   in bf16 within twice the oracle's own change when every input
   embedding moves by one bf16 ulp (error, sensitivity and their ratio
   printed), and with fp32 activations within 1e-4 of max |logit|;
   timed, and one more forward of each traced with ``torch.profiler``
   (K6's device time and share in the fp32 one);
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
    its bias, within 1e-5 of max |out|; K5 must launch 8 times;
12. (run right after phase 7, on its partition and GCN) the SAT
    predictor, faults and resume, all at interval 2 with
    ``PredictorConfig("ema", 1.0, 0.5)``: fp32 (12 epochs), int8 (8) and
    bf16 (3) stores against the oracle as in phase 7, the final
    coefficient (nonzero) and dequantised pstore within 1e-4 (int8 plus
    one scale step), the kernel the ladder selects with the pdata slab
    (K4, K2, K4: the bf16 store leaves K1) launched 16 times an epoch,
    every launch with pdata (and pscale); gamma = 0 equal to the
    predictor-free run and a zero-rate schedule under the watchdog equal
    to the run with no fault state, bit for bit; faults (crash, drop,
    corrupt) under watchdog 6 finite, the push age above the clean run's
    and below 6; killed after 4 epochs and resumed to 8 equal to the
    unbroken run bit for bit (the checkpoint's bytes and its save and
    restore seconds on the host's disk printed); the Theorem-1 error
    bound of the fp32 run through the kernels within 1e-4 relative of
    the oracles'; the epoch median beside phase 7's;
13. (run right after phase 12, on phase 7's partition and GCN, interval
    2) sampled mini-batch training with control variates: (a) at full
    coverage (fanout >= max in-degree, every train row a seed) GCN and
    SAGE equal the full-batch run over 3 steps bit for bit (params,
    store, cache, optimizer state, losses), GAT within 1e-6 (whether
    bitwise is printed); (b) at fanout 5 and 512 seeds, ``cv`` and
    ``plain`` with the fp32 store and ``cv`` with int8 against the oracle
    runs as in phase 7 over 6 steps, and GAT ``cv`` over 2 steps under
    the one-ulp rule, each run's launches a step (K1 by shape, K4/K2, the
    two SpMM gradients) equal to the counts read off the code
    (``step_launches``: a hidden layer's in-ELL K1 twice, the table
    gradient once); (c) a random history changes no bit of a
    full-coverage step; (d) over 8 draws at fanout 2 the CV update's
    squared error to the exact update is below plain sampling's (SGD);
    (e) drop 0.5 under watchdog 6, killed after 4 steps and resumed to 8,
    equal to the unbroken run bit for bit, push age below 6.  Printed:
    the step's median (host clock, its draw and upload included) beside
    the full-batch epoch's at interval 2 and phase 7's, the draw alone,
    the batch's upload bytes, 3 steps and 3 phase-7 epochs traced (device
    ms, busy share), and ``epoch_time_model`` / ``epoch_comm_bytes``
    with the H100 constants (analytic) beside the traced epoch;
14. (run right after phase 13, on phase 7's partition and GCN) DIGEST-A,
    the asynchronous trainer, at interval 2 with worker 0 the straggler:
    (a) 96 rounds with an fp32 and an int8 store (the oracle's int8 run
    24, held against the first 24), and 4 of GAT (no warm start), each
    against the same run through the oracles as in phase 7 (round 1's
    per-leaf gradients, ``round_loss`` and the eval ticks' loss and F1s;
    GAT under the one-ulp rule) with the event order, delays, cold rows
    and pull ages equal, the straggler's delay >= 8 and no cold row, and
    each run's launches a worker gradient (K1 by shape, the ladder's K4
    over the worker's fp32 cache whatever the store, the table gradient,
    GAT's weight gradient) equal to the counts read off the code
    (``round_launches``), evaluation's taken out; (b) an inert
    ``PredictorConfig("none", ...)``, gamma = 0 and a zero-rate schedule
    under an unreachable watchdog bit for bit against the plain run; (c)
    crash, drop, corrupt and delay under watchdog 6 with the ema
    predictor: every counter above 0, finite, pull age <= 6; (d) killed
    after 40 rounds and resumed to 96, equal to (c) bit for bit.
    Printed: the round's median (host clock, synchronised) beside phase
    7's epoch and an eighth of it, the device time a round and busy
    share (a traced 16-round run less a traced 8-round run), and the
    simulated time a round against ``sync_time_per_round``.
15. (run right after phase 14, on phase 7's partition and GCN) the
    multi-GPU exchange on the one card: (a) one rank over NCCL in this
    process, phase 7's settings: the collective epoch equal to the
    gather epoch (metrics every epoch, params, store) with the NCCL
    census; (b)-(e) on 2 and 4 gloo ranks sharing the card
    (``torch.multiprocessing``, the kernels built here first, each rank
    loading them), each held against this process's single-process runs:
    (b) GCN at interval 2, fp32 and int8 stores, 10 epochs: metrics,
    state and every rank's pulled slab equal, the ranks' kernel launches
    summed equal to the single process's, the census of each epoch as
    read off the code; (c) on 4 ranks, the ("pod", "data") = 2 x 2 mesh,
    2 int8 epochs equal, its slab equal to the single-pod collective's;
    (d) on 2 ranks, GAT with the projected pull, 4 epochs equal; (e)
    sharded serving on phase 4's graph and GCN for fp32, bf16 and int8
    stores: the mesh refresh equal to the single refresh, a batch's
    logits within the reference's bars of ``full_graph_forward``, one
    all-to-all a store tensor a batch, and the p50 of 16 batches of 256
    rows a part.  Printed: the pull and push epochs' medians (host
    clock, every rank synchronised, a barrier on each side) beside the
    single process's and phase 7's, the sharded p50s and each pull's
    wire bytes against the replicated slab's.  W ranks on one card
    measure contention, not scaling.
16. MoE serving: llama4-scout at its published widths cut to 2 layers
    (25.9 GB of fp32 weights drawn on the card from a CUDA
    ``torch.Generator``, seed 0), ``forward`` on phase 9's 4 x 1024
    tokens with the kernel backend: (a) with the dropless ``moe_ref``
    (``moe_impl="auto"``) K6 exactly twice and no other kernel, against
    the dense-oracle backend under phase 9's bars (bf16: twice the
    oracle's one-ulp sensitivity; fp32: 1e-4 of max |logit|), the
    (token, layer) top-k sets that differ between the two runs printed
    with their router-logit gaps, a token moved by a tie (gap under
    1e-5 of the router logits' scale) left out of the bars and counted;
    (b) the capacity path (``moe_impl="ep"``) at capacity 16 (dropless)
    within 1e-4 of (a) in fp32, and at the config's 1.25 its dropped
    assignments a layer, a correlation with (a) above 0.9 and two runs
    bit for bit, in bf16; (c) decode as phase 10 (full and ``long``
    caches, ms/token, p50/p99; teacher-forced ``decode_step`` within
    2e-2 of max |logit| of (a)'s logits in bf16 and fp32); (d) one
    prefill and 8 decode steps traced (K6's device share, top ops).
17. LM training (``repro_torch.train``, the synthetic LM pipeline,
    ``launch/train.py``); no hand-written kernel lies on this path (K6
    has no backward: training takes the chunked attention), so every
    launch counter must stay 0 across the phase.  (a) card against CPU
    at the SMOKE widths in fp32, the same parameters (CPU generator,
    seed 0) and pipeline batches: qwen3-0.6b and llama4-scout under
    AdamW and Adafactor, and scout through ``moe_ep``: the step-1 loss
    within 1e-6 relative, per-leaf gradients within 1e-5 of the leaf's
    max |g|, a 10-step loss trajectory within 1e-4, and the card's run
    twice bit for bit; the backward ops that gather (the embedding's
    ``index_put_``, CE's ``scatter_add_``) three times each at the main
    path's shapes, bit for bit, timed; (b) the main path: qwen3-0.6b at
    its published widths (fp32 weights, bf16 activations, chunked
    attention, remat on, AdamW under warmup-cosine) through
    ``launch.train.main``, 20 steps of 4 x 1024 tokens, the launch
    counters set to 0 just before it: the median step (steps 2-20, host
    clock from the end of the step before, the batch's draw included,
    each step's loss read back), tokens/s (steps 2-20's tokens over
    their wall time),
    ``torch.cuda.max_memory_allocated``, the first and last 5 losses
    (the last 5's mean below the first 5's), and one more step traced
    (device time, busy share, top ops); (c) DIGEST pod sync at full
    width, the stacked form from two copies of (b)'s parameters, 2
    pods, interval 4, 8 steps:
    ``pod_divergence`` exactly 0 after steps 4 and 8, above 0 after 2
    and 6; (d) resume at smoke width: 5 steps against 3, save, restore,
    2, bit for bit; (e) the pod form (``pod_impl="shard_map"``) on 2
    gloo ranks sharing the card at smoke width against the stacked form
    computed in each rank: metrics, params and optimizer state bit for
    bit every step, one ``all_gather`` a step and one more at a sync.
18. The last three architectures: recurrentgemma-9b (``rec`` + ``swa``),
    xlstm-1.3b (``mlstm`` + ``slstm``) and llama-3.2-vision-11b
    (``xattn`` and the vision cache; K6 at 32 / 8 heads).  (a) card
    against CPU at the SMOKE widths in fp32, the same parameters (CPU
    generator, seed 0, ``xattn`` gates set to 0.5): prefill logits within
    1e-5 of max |logit|, 96 teacher-forced decode steps (recurrentgemma's
    64-row ``swa`` ring wraps) with each step's logits and every cache
    state within 1e-5 of their max, decode within 2e-2 of the prefill,
    ``long`` == full bit for bit for the two families without attention
    blocks, one train step's loss within 1e-6 and gradients within 1e-5
    of a leaf's max (the VLM's batch carries its vision input); (b)-(d)
    each model at its published widths and depth, one at a time, fp32
    weights drawn on the card (seed 0), bf16 activations: prefill of
    4 x 1024 tokens (recurrentgemma also 1 x 4096, past its window), the
    median of 2 after a warm-up, tokens/s, the wall by block kind (each
    block between two synchronisations: the sLSTM loop's share), one
    traced prefill (device time, busy share, op classes, top ops), peak
    memory, served decode (``launch.serve.serve``, batch 4, 32 tokens;
    the VLM's cache filled by ``precompute_vision_cache``; 4 more steps
    traced) and 64
    teacher-forced steps at batch 1 against the prefill, fp32 within
    2e-2 of max |logit| or, where larger, twice the fp32 prefill's own
    one-ulp sensitivity (embeddings, then every parameter, one ulp up:
    xlstm's 48 layers amplify rounding past 2e-2), bf16 within 2e-2 or
    twice the bf16 prefill's one-ulp sensitivity (every input embedding
    one bf16 ulp up, phase 9's rule); the VLM (vision (4, 1601, 1280)
    from seed 2) through K6 (32 launches a prefill) against the chunked
    oracle in bf16 at twice its one-ulp sensitivity and the dense one in
    fp32 at 1e-4.  No kernel but K6 launches in the phase.
19. The mesh forms, on gloo ranks sharing card 0 (three groups spawned
    together at the phase's start): (a) 4 ranks at the SMOKE widths in
    fp32: the expert-parallel ``moe_ep`` of llama4-scout's and kimi-k2's
    MoE blocks over ("data", "model") = 2 x 2 and 1 x 4 meshes and a
    replicated batch of 1, against the single-device ``moe_ep`` of each
    batch block on the CPU (1e-5) and the card (1e-4), the census of a
    call; the LM trainer's (pod 2, data 2) form (data parallelism inside
    each pod) against the stacked form for qwen3-0.6b and llama4-scout
    (its aux loss): the step-1 gradient within 1e-5 of a leaf's max, 8
    steps' metrics within 1e-4, the census of every step, the two data
    ranks of a pod holding the same bits; (b) llama4-scout at its
    published widths, 2 layers, ``moe_impl="ep"`` over a 1 x 2 ("data",
    "model") mesh, 8 of the 16 experts a rank (each drawn leaf by leaf
    from the single process's CUDA generator): bf16 prefills of 4 x 1024
    through K6 at capacities 16 and 1.25, 32 teacher-forced decode steps
    at batch 4 in bf16 and fp32, against this process's single run on the
    same weights (bit for bit, or within 1e-4 over the tokens no route
    tie moved, in bf16 within twice its own one-ulp change), ms a prefill
    and a token, the census (one ``all_gather`` a MoE call), the bytes
    gathered and peak memory a rank; (c) qwen3-0.6b at its published
    widths, the ``every_step`` baseline over ("data",) = 2, 4 steps of 4 x
    1024 tokens against the single process on the same batches: losses
    within 1e-4, the step-1 gradient within 1e-5 of a leaf's max, step ms,
    the gradient gather's bytes and ms, peak memory a rank.  Only K6
    launches, twice a prefill on each rank of (b).
20. Tensor-parallel LM serving (``repro_torch.distributed.sharding``
    applied in ``forward`` / ``decode_step`` over a "model" dimension),
    on gloo ranks sharing card 0 (4 and 2, spawned together at the
    phase's start): (a) the ten SMOKE configs in fp32 over 1 x 2, 2 x 2
    and 1 x 4 meshes, forward and 8 teacher-forced decode steps (full
    and ``long``; every ``long`` decode of the phase at a window of 4 and
    2 rows a slot, so that it reads the far field's slot sums), each
    rank's logit blocks within 1e-5 of max |logit|
    of the card's single process, a forward's census only
    ``all_gather``s; (b) qwen3-0.6b, (c) llama-3.2-vision-11b at full
    depth (batch 1, vision (1, 1601, 1280)) and (d) deepseek-coder-33b
    cut to 2 of its 62 layers (over model = 2 and 4), each at its
    published widths over ("data", "model") = 1 x m, against its single
    process run first in this process and freed: a bf16 prefill of
    4 x 1024 tokens (the VLM 1 x 1024) through K6 on each rank's heads
    (8 / 4, 16 / 4, 28 / 4 and 14 / 2; qwen3 also fp32), 32 bf16
    decode steps of a full cache (qwen3 also ``long``), 64 logit rows
    (the VLM's decode 16) held at 1e-5 in fp32 and max(2e-2, twice the
    single
    process's one-ulp change) in bf16, ms a prefill and a token, the
    bytes and ms gathered, a rank's weight bytes and peak memory beside
    the single process's; deepseek's full-depth bytes a rank at m = 1,
    2, 4 and 8 from the placement (nothing allocated).  Only K6
    launches, once an attention block a prefill on each rank.

21. Sharded LM training (the trainer's tensor parallelism and FSDP over
    gloo ranks sharing card 0; the constants' comment).
22. The dry run (``repro_torch.launch.dryrun``, meta tensors, nothing
    allocated): (a) qwen3-0.6b's bf16 prefill of 4 x 1024 tokens through
    K6, dry at world 1 and then for real on the card: the dry ledger's K6
    calls equal the real launches (28), and the predicted peak memory
    lies within 10% of ``torch.cuda.max_memory_allocated`` over the run;
    the predicted H100 terms (data-sheet peaks) beside the measured wall
    ms; (b) the GNN dry run's three CI records at 2 x 16 x 16 (fp32; int8
    at 2 parts a rank; the ema predictor), run as processes of their own
    from the phase's start, gated by ``census_check --records 3``.

Each path's launch counters are set to 0 just before it and read just
after; the oracle runs launch nothing.  The last lines are the card's
``nvidia-smi`` line, one JSON object ``{"kernels": [...]}`` (each
kernel's launches on its paths (phase 12's as "sat training", phase
13's as "sampled training", phase 14's as "async training", phase 15's
as "collective training" and "sharded serving", summed over its ranks,
phase 17's as "lm training", 0 for every kernel, phase 18's VLM
prefills as "vlm prefill" and "vlm fp32 prefill", phase 19's as "moe ep
mesh prefill", summed over (b)'s ranks, each rank's beside it, phase
20's as "tp prefill" and "tp fp32 prefill", summed over its ranks,
phase 22's real prefill as "dry run prefill"),
its
worst error, its bar and the times of its main-path variant; K3's also
its chunk walk's and its times at the training shape; K6 one entry a
body, the fp32 body's launches those of the fp32 prefills, qwen3's,
the MoE one's and the VLM's) and
``{"ok": true, "device": {...}}``.  Without a card, or outside a
checkout, it exits non-zero and prints no result.
TF32 is off throughout (fp32 products run in full fp32).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
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
# K6's shapes in phase 8, each (variant suffix, B, H, KV, D, runs): the LM
# slice's (qwen3-0.6b), kimi-k2's attention widths (head dim 112),
# llama4-scout's (five query heads a KV head: the bf16 body's
# one-warpgroup blocks) and llama-3.2-vision's (four).  "all": bf16 and
# fp32, causal at LM_SEQ and non-causal at 512; "causal": the causal pair
# only.
K6_SHAPES = (("", LM_BATCH, 16, 8, 128, "all"),
             (" H64/KV8 D112", LM_BATCH, 64, 8, 112, "all"),
             (" H40/KV8 D128", LM_BATCH, 40, 8, 128, "causal"),
             (" H32/KV8 D128", LM_BATCH, 32, 8, 128, "causal"),
             # A rank's heads under tensor parallelism (phase 20): qwen3,
             # the VLM (at the batch of 1 its prefill gives K6 too) and
             # deepseek (rep 7: one warpgroup a block) over model = 2,
             # deepseek over 4, phi3 over 2.
             (" H8/KV4 D128", LM_BATCH, 8, 4, 128, "causal"),
             (" H16/KV4 D128", LM_BATCH, 16, 4, 128, "causal"),
             (" B1 H16/KV4 D128", 1, 16, 4, 128, "causal"),
             (" H28/KV4 D128", LM_BATCH, 28, 4, 128, "causal"),
             (" H14/KV2 D128", LM_BATCH, 14, 2, 128, "causal"),
             (" H16/KV16 D96", LM_BATCH, 16, 16, 96, "causal"))
TRACE_ATTEMPTS = 3  # traces of the fp32 prefill, for a dropped record
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
    "flash_attention": ("K6 flash attention (LM prefill), bf16 body",
                        "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/"
                        "flash_attention.py:76", "bf16 causal S1024"),
    "flash_attention_fp32": ("K6 flash attention (LM prefill), fp32 body",
                             "src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention/"
                             "flash_attention.py:76", "fp32 causal S1024"),
}
# Entries of KERNELS that report one body of another entry's kernel: its
# records carry that kernel's name and its launches are the wrapper's
# count over the path that runs only this body (the fp32 prefill).
BODY_OF = {"flash_attention_fp32": "flash_attention"}
# Each kernel's bar against its plain version (measure's ``allowed``).
TOLERANCES = {
    "spmm": "atol = rtol = 1e-5", "halo_spmm": "atol = rtol = 1e-5",
    "halo_spmm_stream": "atol = rtol = 1e-5",
    "halo_spmm_skip": "atol = rtol = 1e-5",
    "spmm_bwd_table": "atol = rtol = 1e-5",
    "spmm_bwd_wts": "atol = rtol = 1e-5",
    "gat_edge_partial": "acc atol = rtol = 1e-4; l 1e-5; m bit for bit",
    "flash_attention": "fp32 atol = rtol = 2e-5; bf16 2e-5 + one bf16 "
                       "ulp of the output",
    "flash_attention_fp32": "atol = rtol = 2e-5",
}
SERVING_KERNELS = ("spmm", "halo_spmm", "halo_spmm_stream")
TRAINING_KERNELS = ("spmm", "halo_spmm", "halo_spmm_skip", "spmm_bwd_table",
                    "spmm_bwd_wts")
# The paths each later kernel runs on, beside serving and training.
PATH_OF = {"flash_attention": ("prefill", "moe prefill", "vlm prefill",
                               "moe ep mesh prefill", "tp prefill",
                               "dry run prefill"),
           "flash_attention_fp32": ("fp32 prefill", "moe fp32 prefill",
                                    "vlm fp32 prefill", "tp fp32 prefill"),
           "gat_edge_partial": ("gat_aggregate",)}
# The training configuration: the paper's GCN widths on papers-sim, whose
# rcm / 256-row-chunk partition has worklist occupancy 0.475, so the fp32
# store's hidden layers select K4.
TRAIN_PARTS = 8
TRAIN_CHUNK_ROWS = 256
TRAIN_EPOCHS = 12
TRAJ_TOL = 1e-4
# Phase 12's bars: the final SAT coefficient and dequantised pstore rows
# of a kernel run against the oracle run (absolute; the rows are
# coefficient x delta of unit-norm representations, |row| < 2), and the
# Theorem-1 quantities through the kernels against the oracles (relative).
SAT_STATE_TOL = 1e-4
BOUND_TOL = 1e-4
# Phase 13: the sampler of the launcher's defaults (train_gnn --fanout 5
# --batch-seeds 512), steps against the oracle, the full-coverage steps,
# the draws of the variance check and the steps traced.
SAMPLE_FANOUT = 5
SAMPLE_SEEDS = 512
SAMPLE_STEPS = 6
SAMPLE_COVER_STEPS = 3
SAMPLE_VARIANCE_DRAWS = 8
SAMPLE_TRACED = 3
# Phase 14: DIGEST-A on phase 7's partition and GCN at interval 2, worker
# 0 the straggler: the rounds of each run, the int8 run's rounds through
# the oracle (a prefix of the kernel run's: the oracle's gather backward
# takes ~0.4 s a round), the round a killed run last checkpointed, the
# eval cadence, GAT's rounds and the rounds traced.
ASYNC_ROUNDS = 96
ASYNC_INT8_ORACLE_ROUNDS = 24
ASYNC_KILL = 40
ASYNC_EVAL = 24
ASYNC_GAT_ROUNDS = 4
ASYNC_TRACED = 8
# Phase 15: the multi-GPU exchange on one card.  W ranks share the card
# over gloo (NCCL refuses two ranks on one card), so its times measure W
# processes contending for one H100, not scaling.  Collective training on
# phase 7's partition and GCN at interval 2 (pulls at r = 2, 4, ...) for
# DIST_EPOCHS epochs (GAT DIST_GAT_EPOCHS, W = 2 only); sharded serving on
# phase 4's graph and GCN, 8 parts, SERVE_DIST_BATCHES batches of 256 rows
# a part, held to full_graph_forward at the reference's bars
# (tests/test_serving.py: fp32 2e-6, int8 5e-3) and bf16 at int8's (its
# rounding, 2^-9 of a value, is finer than int8's 1/254 of a row's max).
DIST_WORLDS = (2, 4)
DIST_EPOCHS = 10
DIST_INTERVAL = 2
DIST_GAT_EPOCHS = 4
SERVE_PARTS = 8
SERVE_DIST_BATCHES = 16
SERVE_DIST_TOL = {"fp32": 2e-6, "bf16": 5e-3, "int8": 5e-3}
# Phase 16: MoE serving.  llama4-scout at its published widths, its depth
# cut to MOE_LAYERS (25.9 GB of fp32 weights; kimi-k2's experts alone
# take 67.6 GB a layer), at the LM slice's prefill and decode shapes.
# The capacity path at a factor that drops nothing (16 = E: an expert
# may take every token) is held to moe_ref at the reference's bar
# (tests/test_moe.py:23), and at the config's factor by its correlation
# with moe_ref (tests/test_moe.py:34).  A top-k set that differs between
# two runs where the router logits that decide it lie within MOE_TIE of
# their scale is a tie, not a fault: its token's logits are left out of
# the bars and counted.
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_LAYERS = 2
MOE_DROPLESS_CF = 16.0
MOE_EP_TOL = 1e-4
MOE_MIN_CORR = 0.9
MOE_TIE = 1e-5
MOE_TRACED = 8
# Phase 17: LM training.  (a) card against CPU at the SMOKE widths in
# fp32, for each (arch, optimizer, moe_impl) of LM_PARITY (None: the
# config's own), LM_SMOKE_STEPS steps of LM_SMOKE_BATCH x LM_SMOKE_SEQ
# pipeline tokens: the step-1 loss within LM_LOSS_TOL relative, per-leaf
# gradients within TOL of the leaf's max |g|, the trajectory within
# TRAJ_TOL; (b) qwen3-0.6b at its published widths through the launcher,
# LM_TRAIN_STEPS steps of the LM slice's 4 x 1024 tokens; (c) the stacked
# pod form (2 pods, interval LM_POD_INTERVAL) at full width for
# LM_POD_STEPS steps; (e) the pod form on LM_POD_WORLD gloo ranks.
LM_TRAIN_ARCH = "qwen3-0.6b"
LM_TRAIN_STEPS = 20
LM_PARITY = (("qwen3-0.6b", None, None), ("qwen3-0.6b", "adafactor", None),
             ("llama4-scout-17b-a16e", None, None),
             ("llama4-scout-17b-a16e", "adafactor", None),
             ("llama4-scout-17b-a16e", None, "ep"))
LM_SMOKE_STEPS = 10
LM_SMOKE_BATCH = 4
LM_SMOKE_SEQ = 64
LM_LOSS_TOL = 1e-6
LM_POD_INTERVAL = 4
LM_POD_STEPS = 8
LM_POD_WORLD = 2
# Phase 18: the last three architectures.  (a) card against CPU at the
# SMOKE widths in fp32, from the same CPU-generator parameters, over
# NEW_SMOKE_BATCH x NEW_SMOKE_STEPS tokens (recurrentgemma's SMOKE window
# is 64: its decode ring wraps); (b)-(d) each model at its published
# widths and depth, one at a time, its weights drawn on the card:
# prefills of LM_BATCH x LM_SEQ (and 1 x NEW_LONG_SEQ where a "swa"
# block's 2048-row window is to be passed), NEW_PREFILL_RUNS timed after
# a warm-up, LM_GEN served tokens, NEW_TEACHER teacher-forced decode
# steps at batch 1.  An "xattn" gate is zero at init (tanh(0): the
# cross-attention adds nothing), so every one is set to XATTN_GATE.
NEW_ARCHS = ("recurrentgemma-9b", "xlstm-1.3b", "llama-3.2-vision-11b")
NEW_SMOKE_BATCH = 2
NEW_SMOKE_STEPS = 96
NEW_LONG_SEQ = 4096
NEW_PREFILL_RUNS = 2
NEW_TEACHER = 64
NEW_TRACED = 4         # decode steps traced after the served ones
XATTN_GATE = 0.5

# Phase 19: the mesh forms, on gloo ranks sharing card 0 (contention, not
# scaling).  (a) MESH_SMOKE_WORLD ranks at the SMOKE widths in fp32: the
# expert-parallel moe_ep of llama4-scout's and kimi-k2's SMOKE MoE blocks
# on LM_SMOKE_BATCH x MESH_MOE_SEQ tokens over ("data", "model") = 2 x 2
# and 1 x 4 meshes and a replicated batch of 1, against the single-device
# moe_ep of each batch block (the same capacity) on the CPU at TOL and on
# the card at MOE_EP_TOL; the trainer's (pod 2, data 2) form, FSDP inside
# each pod (the trainer's rules), against the stacked form (LM_POD_STEPS
# steps at interval LM_POD_INTERVAL): the step-1 gradient (gathered
# whole) within TOL of a leaf's max, the metrics within TRAJ_TOL, the
# census (MESH_FSDP).  (b)
# llama4-scout at its published widths, MOE_LAYERS layers, moe_impl "ep",
# on a 1 x 2 ("data", "model") mesh (8 of the 16 experts a rank): bf16
# prefills through K6 at MOE_DROPLESS_CF and the config's factor and
# MESH_DECODE teacher-forced decode steps in bf16 and fp32, against the
# single process on the same CUDA-generator weights (run here before the
# ranks draw theirs): the MoE blocks' outputs, the logits at
# MESH_LOGIT_ROWS seeded rows (decode: at MESH_LOGIT_ROWS seeded
# vocabulary ids), bit for bit or within MOE_EP_TOL of their max over the
# tokens no route tie moved, in bf16 within LM_BF16_SENS_FACTOR times the
# single process's own one-ulp change where larger (ep_compare).  (c)
# qwen3-0.6b at its published widths, depth cut to MESH_DP_LAYERS of its
# 28 layers (phase 21 (b) trains it at full depth over data 2 x model
# 2; the cut keeps the script inside its time limit), the every_step
# baseline on ("data",) = 2 under the trainer's rules (FSDP over
# "data"; the blocks drawn leaf by leaf), MESH_DP_STEPS steps of the LM
# slice's LM_BATCH x LM_SEQ tokens against the single process: the
# losses within TRAJ_TOL, the step-1 gradient (gathered whole) within TOL
# of a leaf's max or twice its own bf16 one-ulp change where larger
# (mesh_dp_job; the params after step 1 printed: Adam's first step
# amplifies rounding, params_diff), the same census every step.
MESH_SMOKE_WORLD = 4
MESH_MOE_SEQ = 64
MESH_EP_WORLD = 2
MESH_DECODE = 32
MESH_LOGIT_ROWS = 64
MESH_DP_WORLD = 2
MESH_DP_STEPS = 4
MESH_DP_LAYERS = 14
# (a)'s FSDP over "data" = 2 at the SMOKE widths, a step: the gathers of
# the forward and its recomputation (the aux loss's embedding table too)
# and one reduce-scatter (all_to_all) a leaf cut over "data".
MESH_FSDP = {LM_TRAIN_ARCH: (40, 21), MOE_ARCH: (53, 28)}

# Phase 20: tensor-parallel LM serving (the reference's sharding rules,
# repro_torch.distributed.sharding), on gloo ranks sharing card 0
# (contention, not scaling; NCCL refuses two ranks on one card), two
# groups spawned together at the phase's start (TP_GROUPS: group, its
# world, its jobs in order).  (a) 4 ranks: every SMOKE config in fp32,
# TP_SMOKE_BATCH x TP_SMOKE_SEQ tokens, forward and TP_SMOKE_STEPS
# teacher-forced decode steps (full and long) over ("replica", "model")
# = 2 x 2 (two 1 x 2 meshes), ("data", "model") = 2 x 2 and 1 x 4, each
# rank's logit blocks within TOL of max |logit| of the card's single
# process, a forward's census only all_gathers.  (b) qwen3-0.6b, (c)
# llama-3.2-vision-11b at full depth (batch 1 bounds gloo's host
# traffic; vision (1, 1601, 1280) from seed 2, gates open) and (d)
# deepseek-coder-33b cut to TP_DEEPSEEK_LAYERS layers (over model = 2
# and 4), each at its published widths over ("data", "model") = 1 x m:
# the single process first in this process (weights from a CUDA
# generator, seed 0; its TP_ROWS seeded prefill logit rows and every
# TP_DECODE_HELD-th decode step's rows kept on the host, its bf16
# one-ulp change), freed before the ranks draw theirs leaf by leaf
# (sharding.init_sharded); a warm-up and a timed bf16 prefill of
# TP_BATCH x TP_SEQ tokens through K6 on each rank's heads (qwen3 also
# fp32), TP_DECODE teacher-forced bf16 decode steps of a full cache
# (qwen3 also long); each rank's vocabulary block of the rows
# within TOL in fp32 and max(DECODE_TOL, LM_BF16_SENS_FACTOR x the
# single process's one-ulp change) in bf16 (phase 9's rule).
TP_GROUPS = {"four": (4, ("a", "d4")), "two": (2, ("b", "c", "d2"))}
TP_SMOKE_BATCH = 4
TP_SMOKE_SEQ = 16
TP_SMOKE_STEPS = 8
TP_QWEN = "qwen3-0.6b"
TP_VLM = "llama-3.2-vision-11b"
TP_DEEPSEEK = "deepseek-coder-33b"
TP_DEEPSEEK_LAYERS = 2
TP_BATCH = {TP_QWEN: 4, TP_VLM: 1, TP_DEEPSEEK: 4}
TP_SEQ = 1024
TP_ROWS = 64
TP_DECODE = 32
TP_DECODE_HELD = 2
# The ``long`` decodes' stale-KV settings (the CPU tests'): a window of 4
# and 2 rows a slot, so that 8 and 32 steps read the far field's slot
# sums, which are cut over KV heads.
TP_LONG = {"long_window": 4, "long_ratio": 2}

# Phase 21: the LM trainer's tensor parallelism and FSDP (the reference
# trainer's rules {"embed": "data"}, TRAIN_RULES), on gloo ranks sharing
# card 0, two groups spawned together at the phase's start as phase 20's
# (TT_GROUPS).  (a) 4 ranks: every SMOKE config in fp32 (gates open),
# TT_SMOKE_STEPS steps of TT_SMOKE_BATCH x TT_SMOKE_SEQ tokens under an
# uneven mask over ("replica", "model") = 2 x 2 (two 1 x 2 meshes),
# ("data", "model") = 2 x 2 (FSDP) and the digest shard_map form over
# (pod 2, model 2) at interval TT_POD_INTERVAL, each against the card's
# single process (the stacked form for the pods; a config's single runs
# on one rank, the configs dealt round the ranks, shared through files):
# the step-1 loss within LM_LOSS_TOL, each leaf of the step-1 gradient
# (gathered whole) within TOL of its max |g|, every step's loss, ce and
# aux within LM_FP32_TOL; the census only all_gathers (and, where "data"
# splits the batch, the mask count's all_reduce and the FSDP backward's
# all_to_alls), the same on every rank.  (b) qwen3-0.6b at its published
# widths over model = 2 and over (data 2, model 2), (c)
# deepseek-coder-33b cut to TT_DEEPSEEK_LAYERS layers (Adafactor, its
# published optimizer) over model = 2, both with fp32 activations (the
# bars are fp32's): the single process first in this process, beside (a)
# (weights from a CUDA generator, seed 0; its metrics and step-1
# gradient kept on the host), freed before the ranks draw theirs leaf by
# leaf (sharding.init_sharded); TT_STEPS[name] steps of TT_BATCH x
# TT_SEQ tokens (bounding gloo's host traffic): (b) over 2 ranks and (c)
# beside (a), (b) over 4 ranks alone at the end; the same bars, each
# rank's block of the gradient against the single process's; each
# rank's step ms, bytes gathered and their ms, train-state bytes and
# peak memory.  The 2-rank group first takes two SMOKE steps ("w"), so
# that its first timed step does not carry the process's first use of
# the card.  No kernel launches on this path.
TT_GROUPS = {"four": (4, ("a", "b4")), "two": (2, ("w", "b2", "c2"))}
TT_SMOKE_STEPS = 4
TT_SMOKE_BATCH = 4
TT_SMOKE_SEQ = 16
TT_POD_INTERVAL = 2
TT_QWEN = "qwen3-0.6b"
TT_DEEPSEEK = "deepseek-coder-33b"
TT_DEEPSEEK_LAYERS = 2
TT_BATCH = 2
TT_SEQ = 1024
TT_STEPS = {TT_QWEN: 4, TT_DEEPSEEK: 2}

# Phase 22: the dry run (repro_torch.launch.dryrun, meta tensors, nothing
# allocated).  (a) qwen3-0.6b's bf16 prefill of LM_BATCH x LM_SEQ int32
# tokens through K6 (phase 9's) dry at world 1, then for real on the
# card (weights from a CUDA generator, seed 0; a warm-up, then the run
# measured): the dry ledger's K6 calls equal the launches counted in the
# real run, and the dry run's predicted peak (mem_peak_bytes, its state
# and batch included) lies within DRY_PEAK_TOL of the card's
# max_memory_allocated over the run less what was allocated before the
# weights; the dry run's H100 roofline terms (data-sheet peaks: a
# prediction) printed beside the real run's wall ms.  (b) the GNN dry
# run's three CI records at 2 x 16 x 16 (DRY_GNN_RECORDS: fp32, int8 at 2
# parts a rank, the ema predictor), each its own process started at the
# phase's start, gated by census_check --records 3 (zero all_gathers, the
# all_to_all pull and the pod hop's sends).
DRY_PEAK_TOL = 0.10
DRY_GNN_RECORDS = ([], ["--precision", "int8", "--parts-per-device", "2"],
                   ["--predictor", "ema"])
DRY_GNN_TIMEOUT = 300

# Kernels redesigned for Hopper, by source: ptxas's register and spill
# lines of their instantiations are printed after the build.
REDESIGNED = {"halo_pull": ("halo_list_kernel", "halo_walk_kernel",
                            "halo_skip_kernel"),
              "flash_attention": ("flash_attention_wgmma",
                                  "flash_attention_f32"),
              "spmm": ("spmm_kernel",),
              "spmm_bwd": ("bwd_table_kernel", "bwd_wts_kernel"),
              "gat_edge": ("gat_edge_kernel",)}

# K1's and the weight gradient's launches by (rows, deg, feat, dtype), and
# K2/K3/K4's by (kernel, slab dtype, scale, pdata, pscale), tallied by
# tally_shapes.
K1_SHAPES = collections.Counter()
WTS_SHAPES = collections.Counter()
HALO_LAUNCHES = collections.Counter()


def tally_shapes() -> None:
    """Make K1's launching function and the weight gradient's wrapper (as
    the SpMM's backward calls it) also tally each launch's (rows, deg,
    feat, table dtype) in K1_SHAPES and WTS_SHAPES, and the halo kernels'
    launching function each launch's (counter, slab dtype, and whether it
    carried scale, pdata and pscale) in HALO_LAUNCHES, beside the
    wrappers' own counts."""
    import importlib

    k1 = importlib.import_module("repro_torch.kernels.spmm.spmm")
    halo = importlib.import_module("repro_torch.kernels.spmm.halo_pull")
    launch = halo._launch

    def halo_counted(symbol, counter, nbr, wts, data, scale, pdata, pscale,
                     *rest, **kw):
        out = launch(symbol, counter, nbr, wts, data, scale, pdata, pscale,
                     *rest, **kw)
        if out.numel():
            HALO_LAUNCHES[(counter, str(data.dtype).split(".")[-1],
                           scale is not None, pdata is not None,
                           pscale is not None)] += 1
        return out

    halo._launch = halo_counted

    def counted(inner, tally, out_cols):
        # out_cols: the output's columns, so that an empty output (which
        # the wrapper does not launch for) is not tallied.
        def fn(nbr, x, table):
            if (table.device.type == "cuda"
                    and nbr.shape[0] * out_cols(nbr, table)):
                tally[(int(nbr.shape[0]), int(nbr.shape[1]),
                       int(table.shape[1]),
                       str(table.dtype).split(".")[-1])] += 1
            return inner(nbr, x, table)
        return fn

    k1._spmm_forward = counted(k1._spmm_forward, K1_SHAPES,
                               lambda nbr, table: table.shape[1])
    k1.spmm_bwd_wts = counted(k1.spmm_bwd_wts, WTS_SHAPES,
                              lambda nbr, table: nbr.shape[1])


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
    from repro_torch.kernels.spmm import (halo_spmm_cuda, halo_spmm_plain,
                                          halo_spmm_skip_cuda,
                                          halo_spmm_skip_plain,
                                          halo_spmm_stream_cuda,
                                          halo_spmm_stream_walk_cuda,
                                          spmm_bwd_table,
                                          spmm_bwd_table_plain, spmm_bwd_wts,
                                          spmm_bwd_wts_plain, spmm_cuda,
                                          spmm_plain, spmm_ref)
    from repro_torch.kernels.spmm.ops import select_halo_kernel
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

    # The SAT epilogue at the training shape, as the ladder selects it once
    # the slab carries a predictor (phase 12): K4 over fp32 and bf16 pdata
    # (the bf16 store's stripe passes the resident budget with it) and K2
    # over int8 pdata and pscale.  The bound counts the pdata and pscale
    # bytes; the library yardstick is handed the predicted table.
    pslab = 0.1 * torch.randn((n_tab, 128),
                              generator=torch.Generator().manual_seed(5))
    pslab[-1] = 0
    pslab = pslab.to(dev)
    gamma = 0.5
    occupancy = data["_worklist"].occupancy
    for storage in ("fp32", "bf16", "int8"):
        prec = HaloPrecision(storage)
        sdata, scale = quantize_rows(slab, prec)
        pdata, pscale = quantize_rows(pslab, prec)
        kind = select_halo_kernel(sdata, scale, pdata, pscale,
                                  has_worklist=True, occupancy=occupancy)
        want_kind = "resident" if storage == "int8" else "skip"
        check(kind == want_kind, f"the ladder selects {kind} for the "
              f"{storage} slab with pdata, expected {want_kind}")
        predicted = (dequantize_rows(sdata, scale)
                     + gamma * dequantize_rows(pdata, pscale))
        if kind == "skip":
            args = (nbr, wts, sdata, scale, ids, cnt)
            kw = dict(pdata=pdata, pscale=pscale, gamma=gamma,
                      chunk_rows=TRAIN_CHUNK_ROWS)
            name, variant = "halo_spmm_skip", f"{storage}+gamma"

            def run(args=args, kw=kw):
                return halo_spmm_skip_cuda(*args, **kw)

            def plain(args=args, kw=kw):
                return halo_spmm_skip_plain(*args, **kw)

            check(torch.equal(run(), halo_spmm_stream_cuda(
                nbr, wts, sdata, scale, pdata, pscale, gamma,
                chunk_rows=TRAIN_CHUNK_ROWS)),
                f"K4 [{variant}] is not equal to K3")
        else:
            args = (nbr, wts, sdata, scale, pdata, pscale, gamma)
            name, variant = "halo_spmm", f"train {storage}+gamma"

            def run(args=args):
                return halo_spmm_cuda(*args)

            def plain(args=args):
                return halo_spmm_plain(*args)

        got = run()
        check(torch.equal(got, run()), f"{name} [{variant}]: two launches "
              "differ")
        csr = csr_of(torch, nbr, wts, n_tab)
        measure(torch, records, name, variant,
                list(nbr.shape) + [n_tab, 128], got, plain(), run, plain,
                bound(torch, nbr, wts, [sdata, pdata], [scale, pscale], 128),
                lambda csr=csr, t=predicted: torch.sparse.mm(csr, t), got)

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

    # Weight gradient at every shape GAT's training gives it: the in-ELL
    # over the local head table and the out-ELL over the halo head table,
    # at the hidden layers' per-head width 32 and the output layer's 8.
    for side, n_rows in (("in", rows + 1), ("out", n_tab)):
        knbr, kwts = st[f"{side}_nbr"], st[f"{side}_wts"]
        krows, kdeg = knbr.shape
        kr = torch.arange(krows, device=dev)[:, None].expand(krows, kdeg)
        kkeep = kwts != 0
        csr = csr_of(torch, knbr, kwts, n_rows)
        referenced = int(torch.unique(knbr).numel())
        sent = knbr == n_rows - 1
        # The dot products the data needs: each non-sentinel slot, and the
        # sentinel row once a row that has one.
        dots = int((~sent).sum()) + int(sent.any(1).sum())
        print(f"weight-gradient input: {side}-ELL {tuple(knbr.shape)} over "
              f"{n_rows} rows, {dots / krows:.3f} dot products a row",
              flush=True)
        for width in (32, 8):
            head = torch.randn((n_rows, width), generator=gen)
            head[-1] = 0
            head = head.to(dev)
            g = torch.randn((krows, width), generator=gen).to(dev)
            got = spmm_bwd_wts(knbr, g, head)
            variant = (f"{side}-ELL head w{width}" if width == 32
                       else f"{side}-ELL w{width}")
            check(torch.equal(got, spmm_bwd_wts(knbr, g, head)),
                  f"spmm_bwd_wts [{variant}]: two launches differ")
            w = kwts.clone().requires_grad_()
            with torch.enable_grad():
                spmm_ref(knbr, w, head).backward(g)
            check(torch.allclose(got, w.grad, atol=TOL, rtol=TOL),
                  f"spmm_bwd_wts [{variant}] disagrees with autograd of the "
                  "gather oracle")
            dense = torch.zeros((krows, n_rows), device=dev)
            dense[kr[kkeep], knbr[kkeep].long()] = got[kkeep]

            def library():
                return torch.sparse.sampled_addmm(csr, g, head.t(), beta=0.0)

            lib = library()
            lib_vals = lib.values()
            crow, col = lib.crow_indices(), lib.col_indices()
            lib_rows = torch.repeat_interleave(
                torch.arange(krows, device=dev), crow[1:] - crow[:-1])
            check(torch.allclose(lib_vals, dense[lib_rows, col], atol=1e-4,
                                 rtol=1e-4),
                  f"library yardstick of spmm_bwd_wts [{variant}] computes "
                  "another function")
            del dense
            measure(torch, records, "spmm_bwd_wts", variant,
                    [krows, kdeg, n_rows, width], got,
                    spmm_bwd_wts_plain(knbr, g, head),
                    lambda: spmm_bwd_wts(knbr, g, head),
                    lambda: spmm_bwd_wts_plain(knbr, g, head),
                    roofline(knbr.numel() * 4 + g.numel() * 4
                             + referenced * width * 4 + krows * kdeg * 4,
                             2 * dots * width),
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


def train_settings(storage, **kw):
    """Phase 7's settings (interval 10, the ``storage`` store), or
    ``kw``'s changes of them."""
    from repro_torch.core.digest import TrainSettings
    from repro_torch.core.halo_exchange import HaloPrecision

    return TrainSettings(**{"sync_interval": 10, "mode": "digest",
                            "precision": HaloPrecision(storage), **kw})


def train_run(torch, cfg, data, settings, params, epochs, lr,
              sampler=None):
    """``epochs`` epochs of DIGEST from ``params`` (with a ``sampler``:
    sampled steps, step t on ``sampler.sample(t)``): the per-epoch (loss,
    train F1, eps), epoch 1's per-leaf mean gradients, the epoch times
    (host clock around an epoch that ends in a synchronize; a sampled
    step's includes its draw and upload) and the final state."""
    from repro_torch.core.digest import (_leaves, init_sampled_state,
                                         init_state, make_epoch_fn,
                                         make_sampled_epoch_fn,
                                         sampled_advance)
    from repro_torch.optim import adam

    opt = capture(adam(lr))
    init = init_state if sampler is None else init_sampled_state
    state = init(cfg, opt, data, precision=settings.precision,
                 predictor=settings.predictor, params=params)
    if sampler is None:
        epoch_fn = make_epoch_fn(cfg, opt, settings)

        def advance(st, _):
            return epoch_fn(st, data)
    else:
        advance = sampled_advance(make_sampled_epoch_fn(cfg, opt, settings),
                                  sampler, data)
    traj, times, grads = [], [], None
    for e in range(epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = advance(state, e)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        traj.append((float(m["loss"]), float(m["train_f1"]),
                     m["staleness_eps"].tolist()))
        if e == 0:
            grads = [g.clone() for g in _leaves(state["opt_state"]["grads"])]
    return traj, grads, times, state


def train_path(torch, cfg, data, storage, params, epochs, lr, kernel,
               expect_per_epoch, settings=None, oracle_epochs=None,
               sampler=None):
    """One training main-path run and its check against the same run
    through the gather-form oracles (``backend="jnp"``, autograd on the
    card): epoch 1's per-leaf gradients within TOL of each leaf's max
    |g| (or twice the oracle's own one-ulp sensitivity, where larger),
    and the (loss, train F1) trajectory within TRAJ_TOL over the
    ``oracle_epochs`` the oracle runs (by default all of the fp32 GCN's,
    else 1).  ``settings`` defaults to phase 7's; a ``sampler`` makes
    both runs sampled steps on its batches.  Returns its summary and the
    two final states."""
    from repro_torch.core.digest import evaluate
    from repro_torch.kernels._build import LAUNCHES

    if settings is None:
        settings = train_settings(storage)
    label = f"train {cfg.model}/{storage}"
    if settings.predictor.enabled:
        label += f" {settings.predictor.kind} predictor"
    if sampler is not None:
        label += f" sampled {settings.sample_estimator}"
    c0, k1_0 = dict(LAUNCHES), collections.Counter(K1_SHAPES)
    w_0 = collections.Counter(WTS_SHAPES)
    traj, grads, times, state = train_run(torch, cfg, data, settings, params,
                                          epochs, lr, sampler)
    c1 = dict(LAUNCHES)
    launches = {k: c1[k] - c0[k] for k in c0}
    k1_shapes, w_shapes = K1_SHAPES - k1_0, WTS_SHAPES - w_0
    check(sum(k1_shapes.values()) == launches["spmm"],
          f"{label}: K1's shape tally {dict(k1_shapes)} does not add up to "
          f"its {launches['spmm']} launches")
    check(sum(w_shapes.values()) == launches["spmm_bwd_wts"],
          f"{label}: the weight gradient's shape tally {dict(w_shapes)} "
          f"does not add up to its {launches['spmm_bwd_wts']} launches")
    if expect_per_epoch is not None:
        check(launches[kernel] == expect_per_epoch * epochs,
              f"{label}: {kernel} launched {launches[kernel]} times in "
              f"{epochs} epochs, expected {expect_per_epoch * epochs}")
    check(launches[kernel] > 0, f"{label}: {kernel} never launched")
    oracle = dataclasses.replace(cfg, backend="jnp")
    o_epochs = oracle_epochs or (
        epochs if storage == "fp32" and cfg.model == "gcn" else 1)
    o_traj, o_grads, _, o_state = train_run(torch, oracle, data, settings,
                                            params, o_epochs, lr, sampler)
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
            _, p_grads, _, _ = train_run(torch, oracle, moved, settings,
                                         params, 1, lr, sampler)
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
    res = {"path": label, "model": cfg.model, "storage": storage,
           "epochs": epochs, "sync_interval": settings.sync_interval,
           "epoch_ms_median": statistics.median(later),
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
               for (r, d, f, dt), n in sorted(k1_shapes.items())},
           "spmm_bwd_wts_per_epoch_by_shape": {
               f"{r}x{d} w{f} {dt}": n / epochs
               for (r, d, f, dt), n in sorted(w_shapes.items())}}
    return res, state, o_state


def train_model(torch, dev, data, name):
    """The paper's widths (``configs/digest_gcn.py``) on the training
    partition, random weights from ``torch.Generator`` seed 0."""
    from repro_torch.configs import digest_gcn
    from repro_torch.models.gnn import GNN, GNNConfig

    exp, g = digest_gcn.CONFIG, data["_graph"]
    cfg = GNNConfig(model=name, num_layers=exp.num_layers,
                    in_dim=g.features.shape[1], hidden_dim=exp.hidden_dim,
                    num_classes=int(g.labels.max()) + 1,
                    heads=4 if name == "gat" else exp.heads,
                    stream_chunk_rows=TRAIN_CHUNK_ROWS,
                    halo_occupancy=data["_worklist"].occupancy)
    return cfg, GNN.init(cfg, torch.Generator().manual_seed(0), dev).tree()


def training(torch, dev) -> tuple:
    """Phases 6-7: the training kernels at the training shapes, then the
    training main path; returns the records, the path's launches, the
    training data and the fp32 GCN run's median epoch ms."""
    from repro_torch.configs import digest_gcn
    from repro_torch.core.digest import prepare_graph_data
    from repro_torch.graph import make_dataset
    from repro_torch.kernels import _build

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
        cfg, params = train_model(torch, dev, data, name)
        res, _, _ = train_path(torch, cfg, data, storage, params, epochs,
                               exp.learning_rate, kernel, per_epoch)
        print(json.dumps(res), flush=True)
        results.append(res)
    launches = dict(_build.LAUNCHES)
    check(all(launches[k] > 0 for k in TRAINING_KERNELS),
          f"a kernel of the training path never launched: {launches}")
    return records, launches, data, results[0]["epoch_ms_median"]


def _tree_equal(torch, a, b) -> bool:
    """Every leaf of two nested dicts equal, bit for bit."""
    from repro_torch.core.digest import _leaves
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def sat_training(torch, dev, data, raw_epoch_ms, smi) -> dict:
    """Phase 12: the SAT predictor, faults, the watchdog, checkpoints and
    resume on phase 7's partition and GCN, all at interval 2 (pushes at
    r = 1, 3, ...; pulls at r = 2, 4, ...), each kernel run held against
    the oracle or against another kernel run.  Returns the path's
    summary with its launches."""
    import shutil
    import tempfile

    from repro_torch import checkpoint
    from repro_torch.configs import digest_gcn
    from repro_torch.core import (FaultConfig, PredictorConfig,
                                  measure_error_and_bound)
    from repro_torch.core.digest import _leaves, digest_train
    from repro_torch.core.halo_exchange import (dequantize_rows,
                                                init_slab, layer_table)
    from repro_torch.kernels import _build
    from repro_torch.kernels.spmm.ops import select_halo_kernel
    from repro_torch.optim import adam

    lr = digest_gcn.CONFIG.learning_rate
    cfg, params = train_model(torch, dev, data, "gcn")
    parts = int(data["local_ids"].shape[0])
    halo = int(data["halo_ids"].shape[1])
    layers = cfg.num_layers - 1
    ema = PredictorConfig("ema", gamma=1.0, beta=0.5)
    out = {"path": "sat training", "model": "gcn", "sync_interval": 2,
           "predictor": dataclasses.asdict(ema)}

    def sat(storage, **kw):
        return train_settings(storage, **{"sync_interval": 2,
                                          "predictor": ema, **kw})

    def slab_kernel(storage, pred):
        """What the ladder selects for a hidden layer's halo slab."""
        sl = init_slab(1, 1, halo, cfg.hidden_dim, sat(storage).precision,
                       "cpu")
        d, sc = layer_table({k: v[0] for k, v in sl.items()}, 0)
        return select_halo_kernel(
            d, sc, d if pred else None, sc if pred else None,
            has_worklist=True, occupancy=cfg.halo_occupancy)

    def pred_launches(before, kernel, dtype):
        """Launches of ``kernel`` over a ``dtype`` slab since ``before``:
        (with pdata, without it, with pdata but no pscale on a scaled
        slab)."""
        d = HALO_LAUNCHES - before
        mine = {k: n for k, n in d.items() if k[:2] == (kernel, dtype)}
        return (sum(n for k, n in mine.items() if k[3]),
                sum(n for k, n in mine.items() if not k[3]),
                sum(n for k, n in mine.items() if k[2] and k[3] and not k[4]))

    torch.cuda.synchronize()
    _build.reset_launches()
    t_phase = time.perf_counter()

    # 1-3: the predictor on each store, against the oracle; the ladder's
    # choice with the pdata slab and every launch of it carrying pdata.
    runs = {}
    for storage, epochs, o_epochs in (("fp32", TRAIN_EPOCHS, TRAIN_EPOCHS),
                                      ("int8", 8, 8), ("bf16", 3, 1)):
        kind = {"skip": "halo_spmm_skip",
                "resident": "halo_spmm"}[slab_kernel(storage, True)]
        dtype = {"fp32": "float32", "int8": "int8",
                 "bf16": "bfloat16"}[storage]
        h0, k1_0 = collections.Counter(HALO_LAUNCHES), collections.Counter(
            K1_SHAPES)
        res, state, o_state = train_path(
            torch, cfg, data, storage, params, epochs, lr, kind,
            layers * parts, settings=sat(storage), oracle_epochs=o_epochs)
        with_p, without_p, no_pscale = pred_launches(h0, kind, dtype)
        check(with_p == layers * parts * epochs and without_p == 0
              and no_pscale == 0,
              f"{res['path']}: {kind} over {dtype} launched {with_p} times "
              f"with pdata, {without_p} without it and {no_pscale} without "
              f"pscale; expected {layers * parts * epochs}, 0 and 0")
        res["selected"] = kind
        res["selected_without_pdata"] = slab_kernel(storage, False)
        res["pdata_launches"] = with_p
        if storage == "bf16":
            # Without a predictor the unscaled bf16 slab is resident and
            # goes to K1; with the pdata slab it passes the budget: K4.
            out_k1 = sum(n for (r, d, f, dt), n in (K1_SHAPES - k1_0).items()
                         if (r, d, f, dt) == (
                             int(data["struct"]["out_nbr"].shape[1]),
                             int(data["struct"]["out_nbr"].shape[2]),
                             cfg.hidden_dim, "bfloat16"))
            check(res["selected_without_pdata"] == "resident"
                  and kind == "halo_spmm_skip" and out_k1 == 0,
                  f"{res['path']}: expected the switch from K1 to K4, got "
                  f"{res['selected_without_pdata']} -> {kind} with {out_k1} "
                  "K1 launches over the bf16 halo slab")
        hist, o_hist = state["predictor"], o_state["predictor"]
        if o_epochs == epochs:
            coef_err = float((hist["coef"] - o_hist["coef"]).abs().max())
            rows = dequantize_rows(state["pstore"]["data"],
                                   state["pstore"].get("scale"))
            o_rows = dequantize_rows(o_state["pstore"]["data"],
                                     o_state["pstore"].get("scale"))
            pstore_err = float((rows - o_rows).abs().max())
            # int8: one code of the row's scale beside the fp32 bar.
            step = (float(state["pstore"]["scale"].max())
                    if storage == "int8" else 0.0)
            check(coef_err <= SAT_STATE_TOL
                  and pstore_err <= SAT_STATE_TOL + step,
                  f"{res['path']}: final coef / pstore differ from the "
                  f"oracle's by {coef_err:.3e} / {pstore_err:.3e} (bar "
                  f"{SAT_STATE_TOL} + {step:.3e})")
            check(float(hist["coef"].abs().max()) > 0,
                  f"{res['path']}: the coefficient never left 0, so the "
                  "epilogue added nothing")
            res.update(coef=hist["coef"].tolist(), coef_max_err=coef_err,
                       pstore_max_err=pstore_err,
                       pstore_max_abs=float(rows.abs().max()))
        print(json.dumps(res), flush=True)
        runs[storage] = (res, state)
        del o_state

    # 4: gamma = 0 adds exactly nothing: the predictor-free run's bits.
    kw = dict(eval_every=1, params=params)
    base, base_h = digest_train(cfg, adam(lr), data, train_settings(
        "fp32", sync_interval=2), 6, **kw)
    g0, g0_h = digest_train(cfg, adam(lr), data, sat(
        "fp32", predictor=PredictorConfig("ema", gamma=0.0)), 6, **kw)
    for key in ("params", "store", "cache", "opt_state"):
        check(_tree_equal(torch, base[key], g0[key]),
              f"gamma = 0: {key} differs from the predictor-free run")
    check(base_h["loss"] == g0_h["loss"],
          "gamma = 0: the losses differ from the predictor-free run")
    check(int(g0["predictor"]["count"].min()) > 0,
          "gamma = 0: the history never advanced")
    del base, g0

    # 5: faults and the watchdog, against the fault-aware run without
    # faults, which in turn equals the run with no fault state.
    faults = FaultConfig(seed=1, crash_rate=0.1, crash_rounds=2,
                         drop_push_rate=0.5, corrupt_rate=0.1)
    clean, clean_h = digest_train(cfg, adam(lr), data,
                                  sat("fp32", max_staleness=10 ** 6),
                                  TRAIN_EPOCHS, faults=FaultConfig(seed=1),
                                  **kw)
    same = ("params", "store", "cache", "pstore", "predictor", "pcache")
    check(_tree_equal(torch, {k: clean[k] for k in same},
                      {k: runs["fp32"][1][k] for k in same})
          and clean_h["loss"] == runs["fp32"][0]["loss"],
          "a zero-rate schedule with the watchdog armed differs from the "
          "run with no fault state (run 1)")
    faulty, faulty_h = digest_train(cfg, adam(lr), data,
                                    sat("fp32", max_staleness=6), 10,
                                    faults=faults, **kw)
    check(all(math.isfinite(x) for x in faulty_h["loss"])
          and all(bool(torch.isfinite(p).all())
                  for p in _leaves(faulty["params"])),
          "faulty run: loss or params not finite")
    check(max(faulty_h["push_age"]) < 6,
          f"faulty run: push age {faulty_h['push_age']} reaches the "
          "watchdog bound 6")
    check(max(faulty_h["push_age"]) > max(clean_h["push_age"][:10]),
          "faulty run: the push age did not rise above the clean run's")
    check(faulty_h["loss"] != clean_h["loss"][:10],
          "faulty run: the faults changed nothing")
    out.update(clean_push_age=clean_h["push_age"],
               faulty_push_age=faulty_h["push_age"],
               faulty_loss=faulty_h["loss"])
    del clean, faulty

    # 6: kill and resume, bit for bit, through a checkpoint on the host's
    # disk (the times below are that disk's, not the card's).
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ck = dict(faults=faults, ckpt_every=4, **kw)
        full, _ = digest_train(cfg, adam(lr), data,
                               sat("fp32", max_staleness=6), 8,
                               ckpt_dir=f"{tmp}/a", **ck)
        digest_train(cfg, adam(lr), data, sat("fp32", max_staleness=6), 4,
                     ckpt_dir=f"{tmp}/b", **ck)
        resumed, _ = digest_train(cfg, adam(lr), data,
                                  sat("fp32", max_staleness=6), 8,
                                  ckpt_dir=f"{tmp}/b", resume=True, **ck)
        check(set(full) == set(resumed) and _tree_equal(torch, full,
                                                        resumed),
              "kill and resume: the resumed run differs from the unbroken "
              "one")
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(f"{tmp}/c", 8, resumed)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again, _ = checkpoint.restore_checkpoint(f"{tmp}/c", resumed)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(_tree_equal(torch, again, resumed),
              "checkpoint: the restored state differs")
        nbytes = sum(p.stat().st_size for p in Path(f"{tmp}/c").iterdir())
        out["checkpoint"] = {"bytes": nbytes, "save_s": save_s,
                             "restore_s": restore_s, "on": "host disk"}
        print(f"checkpoint (host disk): {nbytes} bytes, save "
              f"{save_s:.3f} s, restore {restore_s:.3f} s", flush=True)
        del full, resumed, again
    finally:
        shutil.rmtree(tmp)

    # 7: the Theorem-1 quantities of run 1's final state with its pstore,
    # through the kernels and through the oracles.
    state = runs["fp32"][1]
    oracle = dataclasses.replace(cfg, backend="jnp")
    c0 = sum(_build.LAUNCHES.values())
    bound_k = measure_error_and_bound(cfg, state["params"], data,
                                      state["store"], state["pstore"],
                                      ema.gamma)
    c1 = sum(_build.LAUNCHES.values())
    bound_o = measure_error_and_bound(oracle, state["params"], data,
                                      state["store"], state["pstore"],
                                      ema.gamma)
    check(c1 > c0 and sum(_build.LAUNCHES.values()) == c1,
          "error bound: the kernel run launched nothing or the oracle "
          "launched a kernel")
    worst = 0.0
    for key in ("err_measured", "bound", "eps", "eps_mean", "eps_raw_mean"):
        got = [bound_k[key]] if isinstance(bound_k[key], float) \
            else bound_k[key]
        want = [bound_o[key]] if isinstance(bound_o[key], float) \
            else bound_o[key]
        for a, b in zip(got, want):
            rel = abs(a - b) / max(abs(b), 1e-30)
            check(rel <= BOUND_TOL, f"error bound: {key} {got} differs from "
                  f"the oracle's {want} by {rel:.3e} relative")
            worst = max(worst, rel)
    out["error_bound"] = {k: bound_k[k] for k in (
        "err_measured", "bound", "bound_with_quant", "eps", "eps_mean",
        "eps_raw", "eps_raw_mean")}
    out["error_bound_max_rel_err"] = worst
    print(f"error bound: eps_mean {bound_k['eps_mean']} beside eps_raw_mean "
          f"{bound_k['eps_raw_mean']}; err_measured "
          f"{bound_k['err_measured']:.6g} beside bound "
          f"{bound_k['bound']:.6g}", flush=True)

    torch.cuda.synchronize()
    out["launches"] = dict(_build.LAUNCHES)
    out["seconds"] = time.perf_counter() - t_phase
    sat_ms = runs["fp32"][0]["epoch_ms_median"]
    out.update(epoch_ms_median=sat_ms, raw_epoch_ms_median=raw_epoch_ms)
    print(f"epoch (untraced median, {smi}): fp32 store with the ema "
          f"predictor, interval 2 {sat_ms:.2f} ms; without it, interval 10 "
          f"(phase 7) {raw_epoch_ms:.2f} ms", flush=True)
    print(json.dumps(out), flush=True)
    return out


def step_launches(cfg, data, precision, sampled: bool,
                  dedup: bool = True) -> dict:
    """The launches one training step makes, read off the code
    (``models/gnn.py``, the ladder of ``kernels/spmm/ops.py``): K1 by
    (rows, deg, feat, dtype), the halo kernels by name, and the two SpMM
    gradients.

    GCN / SAGE: layer 0 runs K1 on the in-ELL over the raw features and
    the ladder's kernel over the fp32 feature slab; each hidden layer K1
    on the in-ELL over the fresh rows — and, sampled, once more over the
    history — and the ladder's kernel over the ``precision`` store's slab
    (an unscaled resident slab is K1's).  Only the fresh rows' table is
    differentiated: one table gradient a hidden layer.  GAT: K1 a head
    on each ELL and layer, each with its attention's weight gradient;
    table gradients a head for the in-ELL tables and layer 0's projected
    halo, and one for each score gather of a differentiated table (both
    sides, every layer: the dedup's pulled rows are detached, but their
    scores carry ``a_src``).  Without the dedup (``dedup=False``: plain
    halo tables, as DIGEST-A's worker caches are) every layer projects
    its halo table by the trained W, so every layer's out-ELL tables
    take a table gradient a head.  Per subgraph, times the parts."""
    import torch

    from repro_torch.kernels.spmm.ops import select_halo_kernel

    parts, rows, din = (int(n) for n in data["struct"]["in_nbr"].shape)
    dout = int(data["struct"]["out_nbr"].shape[2])
    halo_rows = int(data["halo_ids"].shape[1]) + 1
    n_hidden = cfg.num_layers - 1
    k1, halo = collections.Counter(), collections.Counter()
    if cfg.model == "gat":
        heads = [cfg.heads] * n_hidden + [1]
        for ell, h in enumerate(heads):
            w = cfg.layer_dims[ell][1] // h
            k1[(rows, din, w, "float32")] += parts * h
            k1[(rows, dout, w, "float32")] += parts * h
        return {"k1": k1, "halo": halo, "wts": sum(k1.values()),
                "table": parts * (sum(heads)
                                  + (heads[0] if dedup else sum(heads))
                                  + 2 * cfg.num_layers)}

    def slab(n, feat, dtype, scaled):
        kind = select_halo_kernel(
            torch.empty((halo_rows, feat), dtype=dtype, device="meta"),
            torch.empty((halo_rows, 1), device="meta") if scaled else None,
            has_worklist=True, resident_max_bytes=cfg.resident_max_bytes,
            occupancy=cfg.halo_occupancy,
            skip_occupancy_max=cfg.skip_occupancy_max)
        if kind == "resident" and not scaled:
            k1[(rows, dout, feat, str(dtype).split(".")[-1])] += n
        else:
            halo[{"resident": "halo_spmm", "stream": "halo_spmm_stream",
                  "skip": "halo_spmm_skip"}[kind]] += n

    k1[(rows, din, cfg.in_dim, "float32")] += parts
    slab(parts, cfg.in_dim, torch.float32, False)
    k1[(rows, din, cfg.hidden_dim, "float32")] += (
        parts * n_hidden * (2 if sampled else 1))
    slab(parts * n_hidden, cfg.hidden_dim, precision.dtype,
         precision.has_scale)
    return {"k1": k1, "halo": halo, "wts": 0, "table": parts * n_hidden}


def check_step_launches(res, cfg, data, precision, steps) -> dict:
    """Hold a sampled run's launches (``train_path``'s summary) to
    :func:`step_launches`; returns the derived counts, a sampled step's
    and a full-batch epoch's, for the record."""
    def flat(d):
        return {**{f"K1 {r}x{dg} w{f} {dt}": n
                   for (r, dg, f, dt), n in sorted(d["k1"].items())},
                **dict(d["halo"]), "spmm_bwd_table": d["table"],
                "spmm_bwd_wts": d["wts"]}

    want = step_launches(cfg, data, precision, True)
    got = res["launches"]
    got_k1 = {f"K1 {k}": n for k, n in res["spmm_per_epoch_by_shape"].items()}
    want_k1 = {k: n for k, n in flat(want).items() if k.startswith("K1")}
    check(got_k1 == want_k1, f"{res['path']}: K1 launched {got_k1} a step, "
          f"expected {want_k1} from the code")
    for name in ("halo_spmm", "halo_spmm_stream", "halo_spmm_skip"):
        check(got[name] == want["halo"][name] * steps,
              f"{res['path']}: {name} launched {got[name]} times in {steps} "
              f"steps, expected {want['halo'][name] * steps} from the code")
    for name, key in (("spmm_bwd_table", "table"), ("spmm_bwd_wts", "wts")):
        check(got[name] == want[key] * steps,
              f"{res['path']}: {name} launched {got[name]} times in {steps} "
              f"steps, expected {want[key] * steps} from the code")
    return {"sampled_per_step": flat(want), "full_batch_per_epoch": flat(
        step_launches(cfg, data, precision, False))}


def sampled_training(torch, dev, data, raw_epoch_ms, smi) -> dict:
    """Phase 13: sampled mini-batch DIGEST (control variates) on phase
    7's partition and GCN at interval 2: (a) full coverage equals the
    full-batch run, (b) sampled runs against the oracle runs, (c) a
    random history changes nothing at full coverage, (d) the CV update's
    error below plain sampling's, (e) faults with kill and resume; the
    launches held to the counts read off the code, the step time, the
    device split and the analytic communication model.  Returns the
    path's summary with its launches."""
    import shutil
    import tempfile

    from repro_torch.configs import digest_gcn
    from repro_torch.core import FaultConfig, comm_model
    from repro_torch.core.digest import (_leaves, batch_tensors,
                                         digest_train, init_sampled_state,
                                         init_state, make_epoch_fn,
                                         make_sampled_epoch_fn,
                                         sampled_advance, sampled_train)
    from repro_torch.graph import build_sampler
    from repro_torch.kernels import _build
    from repro_torch.launch.serving_driver import profile_serve_loop
    from repro_torch.models.gnn import gnn_specs
    from repro_torch.nn import param_count
    from repro_torch.optim import adam, sgd

    lr = digest_gcn.CONFIG.learning_rate
    torch.cuda.synchronize()
    _build.reset_launches()
    t_phase = time.perf_counter()
    sampler = build_sampler(data, SAMPLE_FANOUT, SAMPLE_SEEDS)
    cover = build_sampler(data, max(sampler.max_in_degree, 1), 1 << 30)
    out = {"path": "sampled training", "model": "gcn", "sync_interval": 2,
           "fanout": SAMPLE_FANOUT, "batch_seeds": SAMPLE_SEEDS,
           "max_in_degree": sampler.max_in_degree}

    def settings(storage="fp32", **kw):
        return train_settings(storage, **{"sync_interval": 2, **kw})

    # (a) Full coverage (fanout >= max in-degree, every train row a seed)
    # equals the full-batch run.  The full-batch runs' launches are not
    # the sampled path's: they are taken out of its counts below.
    out["full_coverage"] = {}
    not_sampled = collections.Counter()
    for name in ("gcn", "sage", "gat"):
        cfg, params = train_model(torch, dev, data, name)
        kw = dict(eval_every=1, params=params)
        c0 = collections.Counter(_build.LAUNCHES)
        full, full_h = digest_train(cfg, adam(lr), data, settings(),
                                    SAMPLE_COVER_STEPS, **kw)
        torch.cuda.synchronize()
        not_sampled.update(collections.Counter(_build.LAUNCHES) - c0)
        samp, samp_h = sampled_train(cfg, adam(lr), data, cover, settings(),
                                     SAMPLE_COVER_STEPS, **kw)
        keys = ("params", "store", "cache", "opt_state")
        bitwise = (all(_tree_equal(torch, full[k], samp[k]) for k in keys)
                   and full_h["loss"] == samp_h["loss"])
        err = max(float((a - b).abs().max()) for k in keys
                  for a, b in zip(_leaves(full[k]), _leaves(samp[k]))
                  if isinstance(a, torch.Tensor) and a.numel())
        if name == "gat":
            check(all(torch.allclose(a.float(), b.float(), rtol=1e-6,
                                     atol=1e-6)
                      for k in keys for a, b in zip(_leaves(full[k]),
                                                    _leaves(samp[k]))
                      if isinstance(a, torch.Tensor)),
                  f"full coverage, gat: {err:.3e} from the full-batch run "
                  "(bar 1e-6)")
        else:
            check(bitwise, f"full coverage, {name}: the sampled run differs "
                  f"from the full-batch run (max |diff| {err:.3e})")
        out["full_coverage"][name] = {"bitwise": bitwise, "max_abs_diff": err}
        print(f"full coverage == full batch, {name}, {SAMPLE_COVER_STEPS} "
              f"steps: bitwise {bitwise}, max |diff| {err:.3e}", flush=True)
        del full, samp

    # (b) Against the oracle: fanout 5, 512 seeds.
    runs = {}
    for name, storage, estimator, steps in (
            ("gcn", "fp32", "cv", SAMPLE_STEPS),
            ("gcn", "fp32", "plain", SAMPLE_STEPS),
            ("gcn", "int8", "cv", SAMPLE_STEPS), ("gat", "fp32", "cv", 2)):
        cfg, params = train_model(torch, dev, data, name)
        sset = settings(storage, sample_estimator=estimator)
        want = step_launches(cfg, data, sset.precision, True)
        res, _, _ = train_path(
            torch, cfg, data, storage, params, steps, lr, "spmm_bwd_table",
            want["table"], settings=sset, oracle_epochs=steps,
            sampler=sampler)
        res["halo_kernels"] = dict(want["halo"])
        res["derived_launches"] = check_step_launches(
            res, cfg, data, sset.precision, steps)
        print(json.dumps(res), flush=True)
        runs[(name, storage, estimator)] = res
    cfg, params = train_model(torch, dev, data, "gcn")

    # (c) One step from a random history equals one from the zero history
    # at full coverage.
    opt = adam(lr)
    step = make_sampled_epoch_fn(cfg, opt, settings())
    state = init_sampled_state(cfg, opt, data, params=params)
    batch = batch_tensors(cover.sample(0), dev)
    s1, m1 = step(state, data, batch)
    noisy = dict(state, hist=torch.randn(
        state["hist"].shape, generator=torch.Generator().manual_seed(3)
    ).to(dev))
    s2, m2 = step(noisy, data, batch)
    check(all(_tree_equal(torch, s1[k], s2[k])
              for k in ("params", "store", "hist"))
          and torch.equal(m1["loss"], m2["loss"]),
          "random history: one full-coverage step differs from the step "
          "from the zero history")
    del s1, s2, noisy

    # (d) The CV update's MSE to the exact update below plain sampling's,
    # SGD so that the update is the gradient.
    opt = sgd(0.1)
    warm, _ = sampled_train(cfg, opt, data, cover, settings(), 6,
                            eval_every=6, params=params)
    step_cv = make_sampled_epoch_fn(cfg, opt, settings())
    step_plain = make_sampled_epoch_fn(
        cfg, opt, settings(sample_estimator="plain"))
    exact = _leaves(step_cv(warm, data, batch_tensors(cover.full_batch(),
                                                      dev))[0]["params"])

    def mse(st):
        return sum(float(((a - b) ** 2).sum())
                   for a, b in zip(_leaves(st["params"]), exact))

    narrow = build_sampler(data, 2, 1 << 30, seed=11)
    err_cv = err_plain = 0.0
    for t in range(SAMPLE_VARIANCE_DRAWS):
        b = batch_tensors(narrow.sample(t), dev)
        err_cv += mse(step_cv(warm, data, b)[0])
        err_plain += mse(step_plain(warm, data, b)[0])
    check(err_cv < err_plain, f"variance: the CV update's squared error "
          f"{err_cv:.6g} is not below plain sampling's {err_plain:.6g}")
    out["variance"] = {"draws": SAMPLE_VARIANCE_DRAWS, "fanout": 2,
                       "cv_sq_err": err_cv, "plain_sq_err": err_plain}
    print(f"variance over {SAMPLE_VARIANCE_DRAWS} draws at fanout 2: CV "
          f"{err_cv:.6g} against plain {err_plain:.6g}", flush=True)
    del warm

    # (e) Faults under the watchdog, killed after 4 steps and resumed to 8.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sampled_")
    try:
        ck = dict(faults=FaultConfig(seed=1, drop_push_rate=0.5),
                  ckpt_every=4, eval_every=1, params=params)
        sset = settings(max_staleness=6)
        full, full_h = sampled_train(cfg, adam(lr), data, sampler, sset, 8,
                                     ckpt_dir=f"{tmp}/a", **ck)
        sampled_train(cfg, adam(lr), data, sampler, sset, 4,
                      ckpt_dir=f"{tmp}/b", **ck)
        resumed, res_h = sampled_train(cfg, adam(lr), data, sampler, sset, 8,
                                       ckpt_dir=f"{tmp}/b", resume=True,
                                       **ck)
        check(set(full) == set(resumed) and _tree_equal(torch, full, resumed)
              and res_h["loss"] == full_h["loss"][4:],
              "sampled kill and resume: the resumed run differs from the "
              "unbroken one")
        check(max(full_h["push_age"]) < 6 and max(full_h["push_age"]) > 1,
              f"sampled faults: push age {full_h['push_age']} not within "
              "(1, 6)")
        out["faulty_push_age"] = full_h["push_age"]
        del full, resumed
    finally:
        shutil.rmtree(tmp)

    torch.cuda.synchronize()
    out["launches"] = {k: n - not_sampled[k]
                       for k, n in _build.LAUNCHES.items()}
    out["full_batch_launches_left_out"] = dict(not_sampled)
    check(all(out["launches"][k] > 0 for k in TRAINING_KERNELS),
          f"a kernel of the sampled path never launched: {out['launches']}")
    out["runs"] = {" ".join(k): {x: r[x] for x in (
        "grad_rel_err", "traj_max_err", "loss", "train_f1",
        "epoch_ms_median", "derived_launches")} for k, r in runs.items()}

    # Times: the sampled step (host clock, its draw and upload included)
    # beside the full-batch epoch at the same interval, the draw alone,
    # the batch's bytes; then the device split of each, traced.
    _, _, full_times, _ = train_run(torch, cfg, data, settings(), params,
                                    SAMPLE_STEPS, lr)
    step_ms = runs[("gcn", "fp32", "cv")]["epoch_ms_median"]
    full_ms = statistics.median(full_times[1:])
    draws, hosts = [], []
    for t in range(SAMPLE_STEPS):
        t0 = time.perf_counter()
        hosts.append(sampler.sample(t))
        draws.append((time.perf_counter() - t0) * 1e3)
    h2d = sum(a.nbytes for a in hosts[0].values())
    opt = adam(lr)
    st = init_sampled_state(cfg, opt, data, params=params)
    fn = make_sampled_epoch_fn(cfg, opt, settings())
    no_draw = []
    for host in hosts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = fn(st, data, batch_tensors(host, dev))
        torch.cuda.synchronize()
        no_draw.append((time.perf_counter() - t0) * 1e3)
    no_draw_ms = statistics.median(no_draw[1:])
    del st
    splits = {}
    for kind in ("sampled", "full batch"):
        opt = adam(lr)
        if kind == "sampled":
            st = init_sampled_state(cfg, opt, data, params=params)
            one = sampled_advance(make_sampled_epoch_fn(cfg, opt, settings()),
                                  sampler, data)
        else:
            st = init_state(cfg, opt, data, params=params)
            fn = make_epoch_fn(cfg, opt, train_settings("fp32"))

            def one(c, t, fn=fn):
                return fn(c, data)
        st, _ = one(st, 0)
        split = profile_serve_loop(one, range(1, 1 + SAMPLE_TRACED),
                                   carry=st)
        splits[kind] = {"device_ms_per_step": split["device_ms"]
                        / SAMPLE_TRACED, "busy_share": split["busy_share"],
                        "top": split["top"][:5]}
    out.update(step_ms_median=step_ms, step_ms=runs[("gcn", "fp32", "cv")][
        "epoch_ms"], full_batch_epoch_ms_median=full_ms,
        phase7_epoch_ms_median=raw_epoch_ms, draw_ms=draws,
        step_without_draw_ms=no_draw, step_without_draw_ms_median=no_draw_ms,
        batch_h2d_bytes=h2d, traced=splits)
    print(f"sampled step (untraced median, {smi}): {step_ms:.2f} ms with "
          f"its draw and upload, {no_draw_ms:.2f} ms with its upload alone; "
          f"the draw {statistics.median(draws):.2f} ms on the host; "
          f"full-batch epoch at interval 2 {full_ms:.2f} ms; phase 7's "
          f"epoch (interval 10) {raw_epoch_ms:.2f} ms; batch upload {h2d} "
          "bytes", flush=True)
    print(f"traced ({SAMPLE_TRACED} each): sampled step "
          f"{splits['sampled']['device_ms_per_step']:.3f} ms of device time, "
          f"busy {splits['sampled']['busy_share']:.3f}; full-batch epoch "
          f"(phase 7's settings) "
          f"{splits['full batch']['device_ms_per_step']:.3f} ms, busy "
          f"{splits['full batch']['busy_share']:.3f}", flush=True)

    # The analytic model (datasheet H100 constants, not a measurement).
    sp, g = data["_sp"], data["_graph"]
    pc = param_count(gnn_specs(cfg))
    consts = comm_model.CommConstants()
    model = {}
    for mode in ("partition", "digest", "propagation"):
        model[mode] = comm_model.epoch_time_model(
            mode, sp, g, pc, cfg.hidden_dim, cfg.num_layers, cfg.in_dim, 10,
            consts)
    for storage in ("fp32", "int8"):
        wire = comm_model.epoch_comm_bytes(
            "digest", sp, g, pc, cfg.hidden_dim, cfg.num_layers, 10, consts,
            halo_precision=train_settings(storage).precision)
        model[f"digest {storage} wire"] = {"bytes": wire}
    model = {k: {kk: float(vv) for kk, vv in v.items()}
             for k, v in model.items()}
    out["comm_model"] = {"analytic": True, "constants": dataclasses.asdict(
        consts), "param_count": pc, "sync_interval": 10, "modes": model}
    print(f"comm model (analytic, H100 datasheet constants, interval 10): "
          + "; ".join(f"{k} {v['bytes'] / 1e6:.3f} MB"
                      + (f", {v['t_epoch'] * 1e3:.5f} ms an epoch"
                         if "t_epoch" in v else "")
                      for k, v in model.items())
          + f"; beside phase 7's measured device time an epoch "
          f"{splits['full batch']['device_ms_per_step']:.3f} ms", flush=True)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps(out), flush=True)
    return out


def async_settings(storage="fp32", **kw):
    """Phase 14's settings (interval 2, worker 0 the straggler, the
    ``storage`` store), or ``kw``'s changes of them."""
    from repro_torch.core import AsyncSettings
    from repro_torch.core.halo_exchange import HaloPrecision

    return AsyncSettings(**{"sync_interval": 2, "straggler": 0, "seed": 0,
                            "precision": HaloPrecision(storage), **kw})


def recording(opt, grads: list, stamps: list = None):
    """``opt`` that also copies the gradient leaves of its first update
    into ``grads`` (round 1's) and, with ``stamps``, reads the host clock
    after a synchronize at every update: DIGEST-A updates once a round,
    so the stamps are a round apart."""
    import torch

    from repro_torch.core.digest import _leaves
    from repro_torch.optim import Optimizer

    def update(g, state, params, step):
        if stamps is not None:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        if not grads:
            grads.extend(x.clone() for x in _leaves(g))
        return opt.update(g, state, params, step)

    return Optimizer(opt.name, opt.init, update)


def round_launches(cfg, data) -> dict:
    """The launches of one DIGEST-A worker gradient, read off the code
    (``core/async_engine.py``): one subgraph's share of a full-batch step
    (:func:`step_launches`) whose halo tables are the worker's plain fp32
    cache, so the ladder picks its fp32 kernel whatever the store's
    precision, and GAT projects every layer's table (no dedup).  The
    pulls, pushes and the SAT sum are PyTorch gathers, scatters and adds:
    none of the port's kernels."""
    from repro_torch.core.halo_exchange import HaloPrecision

    parts = int(data["local_ids"].shape[0])
    full = step_launches(cfg, data, HaloPrecision("fp32"), False,
                         dedup=False)

    def one(n):
        check(n % parts == 0, f"{n} launches do not split over {parts} "
              "subgraphs")
        return n // parts

    return {"k1": collections.Counter({k: one(n)
                                       for k, n in full["k1"].items()}),
            "halo": collections.Counter({k: one(n)
                                         for k, n in full["halo"].items()}),
            "table": one(full["table"]), "wts": one(full["wts"])}


def async_path(torch, cfg, data, settings, params, rounds, lr, label,
               stamps=None, oracle_rounds=None) -> tuple:
    """One DIGEST-A run through the kernels, held against the same run
    through the gather-form oracles (``backend="jnp"``) as phase 7 holds
    an epoch: round 1's per-leaf gradients within TOL of each leaf's max
    |g| (or twice the oracle's own one-ulp sensitivity, where larger),
    ``round_loss``, the eval ticks' loss and F1s within TRAJ_TOL, and the
    event order, delays, cold rows, pull ages and simulated times equal.
    The oracle runs ``oracle_rounds`` (default all, else a multiple of
    ASYNC_EVAL): a shorter run's rounds and ticks are the first ones of
    the longer run's, so it is held against that prefix.
    Its launches, evaluation's taken out (one ``evaluate`` counted, times
    the ticks), must equal :func:`round_launches` times its worker
    gradients (the rounds and the warm start's one a worker).  Returns
    its summary, final state and history."""
    from repro_torch.core import digest_a_train
    from repro_torch.core.digest import evaluate
    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.optim import adam

    def run(c, d, grads, n, stamps=None):
        return digest_a_train(c, recording(adam(lr), grads, stamps), d,
                              settings, n, eval_every_rounds=ASYNC_EVAL,
                              params=params)

    torch.cuda.synchronize()
    c0, k1_0 = dict(LAUNCHES), collections.Counter(K1_SHAPES)
    grads = []
    t0 = time.perf_counter()
    state, hist = run(cfg, data, grads, rounds, stamps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    got = {k: LAUNCHES[k] - c0[k] for k in c0}
    k1_got = K1_SHAPES - k1_0
    c1, k1_1 = dict(LAUNCHES), collections.Counter(K1_SHAPES)
    evaluate(cfg, state["params"], data)
    torch.cuda.synchronize()
    ev = {k: LAUNCHES[k] - c1[k] for k in c1}
    ev_k1 = K1_SHAPES - k1_1
    ticks = len(hist["round"])
    parts = int(data["local_ids"].shape[0])
    calls = rounds + (parts if settings.warm_start and cfg.num_layers > 1
                      else 0)
    want = round_launches(cfg, data)
    path = {k: got[k] - ticks * ev[k] for k in got}
    path_k1 = {f"{r}x{d} w{f} {dt}": k1_got[(r, d, f, dt)]
               - ticks * ev_k1[(r, d, f, dt)]
               for (r, d, f, dt) in set(k1_got) | set(ev_k1)}
    want_k1 = {f"{r}x{d} w{f} {dt}": n * calls
               for (r, d, f, dt), n in want["k1"].items()}
    check({k: n for k, n in path_k1.items() if n} == want_k1,
          f"{label}: K1 launched {path_k1} besides evaluation, expected "
          f"{want_k1} from the code ({calls} worker gradients)")
    for name in ("halo_spmm", "halo_spmm_stream", "halo_spmm_skip"):
        check(path[name] == want["halo"][name] * calls,
              f"{label}: {name} launched {path[name]} times besides "
              f"evaluation, expected {want['halo'][name] * calls}")
    for name, key in (("spmm_bwd_table", "table"), ("spmm_bwd_wts", "wts")):
        check(path[name] == want[key] * calls,
              f"{label}: {name} launched {path[name]} times, expected "
              f"{want[key] * calls} from the code")

    oracle = dataclasses.replace(cfg, backend="jnp")
    o_rounds = oracle_rounds or rounds
    o_grads = []
    t0 = time.perf_counter()
    _, o_hist = run(oracle, data, o_grads, o_rounds)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    check(sum(LAUNCHES.values()) == sum(c1.values()) + sum(ev.values()),
          f"{label}: the oracle run launched a kernel")
    rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
           for a, b in zip(grads, o_grads)]
    check(len(grads) == len(o_grads) > 0
          and all(bool(torch.isfinite(a).all()) for a in grads),
          f"{label}: round-1 gradients missing or not finite")
    floor = [0.0] * len(rel)
    if max(rel) > TOL:
        # Phase 7's rule: the oracle's own change under a one-ulp scaling
        # of the input features.
        for eps in (2.0 ** -23, 2.0 ** -22):
            p_grads = []
            run(oracle, dict(data, x_global=data["x_global"] * (1 + eps)),
                p_grads, 1)
            floor = [max(f, float((p - b).abs().max())
                         / max(float(b.abs().max()), 1e-30))
                     for f, p, b in zip(floor, p_grads, o_grads)]
    for i, (r, f) in enumerate(zip(rel, floor)):
        check(r <= max(TOL, 2 * f),
              f"{label}: round-1 gradient of leaf {i} differs from the "
              f"oracle's by {r:.3e} of its max |g| (bar {TOL}, the "
              f"oracle's own one-ulp sensitivity {f:.3e})")
    o_ticks = len(o_hist["round"])

    def prefix(key):
        return hist[key][:o_rounds if key.startswith("round_")
                         else o_ticks]

    for key in ("round_worker", "delay", "cold_rows", "pull_age", "round",
                "sim_time"):
        check(prefix(key) == o_hist[key],
              f"{label}: {key} {prefix(key)} differs from the oracle run's "
              f"{o_hist[key]}")
    traj_err = 0.0
    for key in ("round_loss", "loss", "val_f1", "test_f1"):
        check(len(prefix(key)) == len(o_hist[key]),
              f"{label}: the oracle's {key} does not align")
        for i, (a, b) in enumerate(zip(prefix(key), o_hist[key])):
            check(abs(a - b) <= TRAJ_TOL, f"{label}: {key}[{i}] {a} "
                  f"differs from the oracle's {b}")
            traj_err = max(traj_err, abs(a - b))
    check(all(math.isfinite(x) for x in hist["round_loss"]),
          f"{label}: loss not finite")
    res = {"path": label, "model": cfg.model,
           "storage": settings.precision.storage, "rounds": rounds,
           "oracle_rounds": o_rounds, "warm_start": settings.warm_start,
           "grad_rel_err": max(rel), "grad_rel_err_by_leaf": rel,
           "oracle_ulp_sensitivity_by_leaf": floor,
           "traj_max_err": traj_err, "val_f1": hist["val_f1"],
           "delay": hist["delay"], "cold_rows": hist["cold_rows"],
           "pull_age": hist["pull_age"], "worker_gradients": calls,
           "eval_ticks": ticks, "launches": got, "eval_launches": ev,
           "seconds": run_s, "oracle_seconds": oracle_s,
           "derived_per_round": {
               **{f"K1 {k}": n for k, n in sorted(
                   (f"{r}x{d} w{f} {dt}", n)
                   for (r, d, f, dt), n in want["k1"].items())},
               **dict(want["halo"]), "spmm_bwd_table": want["table"],
               "spmm_bwd_wts": want["wts"]}}
    return res, state, hist


def async_training(torch, dev, data, raw_epoch_ms, smi) -> dict:
    """Phase 14: DIGEST-A (the asynchronous trainer) on phase 7's
    partition and GCN at interval 2, worker 0 the straggler: (a) fp32 and
    int8 stores and GAT against the oracle runs, the launches a round held
    to the code; (b) an inert predictor, gamma = 0 and a zero-rate
    schedule bit for bit against the plain run; (c) every fault class
    under watchdog 6 with the SAT predictor; (d) killed after
    ASYNC_KILL rounds and resumed, bit for bit; then the round's time,
    its device split and the simulated time a round against the
    synchronous barrier's.  Returns the path's summary with its
    launches."""
    import shutil
    import tempfile

    from repro_torch.configs import digest_gcn
    from repro_torch.core import (FaultConfig, PredictorConfig,
                                  digest_a_train, sync_time_per_round)
    from repro_torch.core.digest import _leaves
    from repro_torch.kernels import _build
    from repro_torch.launch.serving_driver import profile_serve_loop
    from repro_torch.optim import adam

    lr = digest_gcn.CONFIG.learning_rate
    parts = int(data["local_ids"].shape[0])
    torch.cuda.synchronize()
    _build.reset_launches()
    t_phase = time.perf_counter()
    out = {"path": "async training", "model": "gcn", "sync_interval": 2,
           "straggler": 0, "rounds": ASYNC_ROUNDS, "section_seconds": {}}
    t_lap = [t_phase]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["section_seconds"][name] = now - t_lap[0]
        t_lap[0] = now

    # (a) Against the oracle; the fp32 run's rounds are timed.
    cfg, params = train_model(torch, dev, data, "gcn")
    stamps = []
    res, base, base_h = async_path(torch, cfg, data, async_settings(),
                                   params, ASYNC_ROUNDS, lr,
                                   "async gcn/fp32", stamps)
    check(base_h["delay"][-1] >= 8, f"async: the straggler's delay "
          f"{base_h['delay']} never reached 8 server steps")
    check(base_h["cold_rows"][-1] == 0,
          f"async: pulls read {base_h['cold_rows']} never-pushed rows")
    print(json.dumps(res), flush=True)
    runs = {"gcn fp32": res}
    lap("a gcn fp32")
    res, _, _ = async_path(torch, cfg, data, async_settings("int8"), params,
                           ASYNC_ROUNDS, lr, "async gcn/int8",
                           oracle_rounds=ASYNC_INT8_ORACLE_ROUNDS)
    print(json.dumps(res), flush=True)
    runs["gcn int8"] = res
    lap("a gcn int8")
    # GAT without the warm start: its 8 gradients would take the oracle
    # (autograd's serialised scatter-add over the ELL padding) ~13 s.
    gcfg, gparams = train_model(torch, dev, data, "gat")
    res, _, _ = async_path(torch, gcfg, data,
                           async_settings(warm_start=False), gparams,
                           ASYNC_GAT_ROUNDS, lr, "async gat/fp32")
    print(json.dumps(res), flush=True)
    runs["gat fp32"] = res
    lap("a gat fp32")

    def plain(settings, rounds=ASYNC_ROUNDS, **kw):
        return digest_a_train(cfg, adam(lr), data, settings, rounds,
                              eval_every_rounds=ASYNC_EVAL, params=params,
                              **kw)

    # (b) Bit for bit against the plain run of (a).
    none, none_h = plain(async_settings(
        predictor=PredictorConfig("none", gamma=0.5, beta=0.3)))
    check(_tree_equal(torch, base, none) and none_h == base_h,
          "async: PredictorConfig('none', ...) differs from no predictor")
    g0, g0_h = plain(async_settings(
        predictor=PredictorConfig("ema", gamma=0.0)))
    check("pstore" in g0 and _tree_equal(torch, base["params"],
                                         g0["params"])
          and g0_h["round_loss"] == base_h["round_loss"]
          and g0_h["round_worker"] == base_h["round_worker"],
          "async: gamma = 0 differs from the predictor-free run")
    quiet, quiet_h = plain(async_settings(faults=FaultConfig(seed=1),
                                          max_staleness=10 ** 6))
    check(_tree_equal(torch, base, quiet) and quiet_h == base_h,
          "async: a zero-rate schedule under an unreachable watchdog "
          "differs from the run with neither")
    del none, g0, quiet
    lap("b")

    # (c) Every fault class under watchdog 6, with the SAT predictor.
    faults = FaultConfig(seed=1, crash_rate=0.1, crash_rounds=2,
                         drop_push_rate=0.3, delay_pull_rate=0.2,
                         corrupt_rate=0.1)
    fset = async_settings(faults=faults, max_staleness=6,
                          predictor=PredictorConfig("ema", 1.0, 0.5))
    faulty, faulty_h = plain(fset)
    counters = faulty["fault_counters"]
    check(all(n > 0 for n in counters.values()),
          f"async faults: a fault class never fired: {counters}")
    check(all(math.isfinite(x) for x in faulty_h["round_loss"])
          and all(bool(torch.isfinite(p).all())
                  for p in _leaves(faulty["params"])),
          "async faults: loss or params not finite")
    check(faulty["pull_age_max"] <= 6, f"async faults: pull age "
          f"{faulty['pull_age_max']} above the watchdog bound 6")
    out.update(fault_counters=counters,
               faulty_pull_age_max=faulty["pull_age_max"],
               clean_pull_age_max=base["pull_age_max"])
    lap("c")

    # (d) Killed after ASYNC_KILL rounds (a checkpoint at ASYNC_KILL, one
    # round lost) and resumed to ASYNC_ROUNDS, against (c).
    tmp = tempfile.mkdtemp(prefix="chip_smoke_async_")
    try:
        plain(fset, ASYNC_KILL + 1, ckpt_dir=tmp,
              ckpt_every_rounds=ASYNC_KILL)
        resumed, res_h = plain(fset, ckpt_dir=tmp, resume=True)
        check(set(resumed) == set(faulty)
              and _tree_equal(torch, faulty, resumed) and res_h == faulty_h,
              "async kill and resume: the resumed run differs from the "
              "unbroken one")
        nbytes = sum(p.stat().st_size for p in Path(tmp).iterdir())
        out["checkpoint_bytes"] = nbytes
        del resumed
    finally:
        shutil.rmtree(tmp)
    del faulty
    lap("d")

    torch.cuda.synchronize()
    out["launches"] = dict(_build.LAUNCHES)
    for name in ("spmm", "halo_spmm_skip", "spmm_bwd_table", "spmm_bwd_wts"):
        check(out["launches"][name] > 0,
              f"async: {name} never launched: {out['launches']}")
    out["runs"] = runs

    # Times: a round on the host clock (the stamps of (a)'s fp32 run, one
    # a round after a synchronize), then the device split of rounds
    # ASYNC_TRACED+1 .. 2·ASYNC_TRACED, traced: a run of twice as many
    # rounds less a run of ASYNC_TRACED (each with its warm start and one
    # evaluation).
    round_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    med = statistics.median(round_ms)

    def traced(n):
        def one(c, _):
            h = digest_a_train(cfg, adam(lr), data, async_settings(), n,
                               eval_every_rounds=n, params=params)[1]
            torch.cuda.synchronize()
            return c, h
        return profile_serve_loop(one, [0])

    short, long_ = traced(ASYNC_TRACED), traced(2 * ASYNC_TRACED)
    dev_ms = (long_["device_ms"] - short["device_ms"]) / ASYNC_TRACED
    busy = ((long_["device_ms"] - short["device_ms"])
            / (long_["wall_ms"] - short["wall_ms"]))
    lap("traced")
    sim = base_h["sim_time"][-1] / base_h["round"][-1]
    sync = sync_time_per_round(async_settings(), parts)
    out.update(round_ms_median=med, round_ms=round_ms,
               phase7_epoch_ms_median=raw_epoch_ms,
               phase7_epoch_ms_eighth=raw_epoch_ms / parts,
               traced={"rounds": ASYNC_TRACED, "device_ms_per_round": dev_ms,
                       "busy_share": busy, "short": short, "long": long_},
               sim_time_per_round=sim, sync_time_per_round=sync)
    print(f"async round (untraced median, synchronised, {smi}): "
          f"{med:.2f} ms; phase 7's epoch {raw_epoch_ms:.2f} ms, an eighth "
          f"{raw_epoch_ms / parts:.2f} ms", flush=True)
    print(f"traced ({ASYNC_TRACED} rounds by difference): {dev_ms:.3f} ms "
          f"of device time a round, busy {busy:.3f}", flush=True)
    print("phase 14 sections (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["section_seconds"].items()),
        flush=True)
    print(f"simulated time a round: async {sim:.4f} s against the "
          f"synchronous barrier's {sync:.4f} s ({sync / sim:.2f}x)",
          flush=True)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 15: the multi-GPU exchange (collective training, sharded serving)
# ---------------------------------------------------------------------------

def dist_run(torch, cfg, data, settings, params, epochs, mesh=None) -> dict:
    """``epochs`` DIGEST epochs from ``params`` on one process (``mesh``
    None: the gather epoch) or on this rank of ``mesh`` (collective: data
    and state placed with ``shard_data`` / ``shard_state``).  Per epoch:
    the metrics, the collective census (counted from just before the
    epoch to just after it) and the host-clock time around an epoch that
    ends in a synchronize (on a mesh, with a barrier on each side);
    beside them the kernel launches of the run and the final state (the
    rank's part)."""
    from repro_torch.configs import digest_gcn
    from repro_torch.core import collectives, digest
    from repro_torch.kernels import _build
    from repro_torch.optim import adam

    opt = adam(digest_gcn.CONFIG.learning_rate)
    state = digest.init_state(cfg, opt, data, precision=settings.precision,
                              params=params)
    fn = digest.make_epoch_fn(cfg, opt, settings, mesh)
    edata = data
    if mesh is not None:
        state = digest.shard_state(state, mesh)
        edata = digest.shard_data(data, mesh)

    def fence():
        torch.cuda.synchronize()
        if mesh is not None:
            collectives.barrier()

    metrics, census, times = [], [], []
    l0 = dict(_build.LAUNCHES)
    for _ in range(epochs):
        fence()
        t0 = time.perf_counter()
        collectives.reset_collectives()
        state, m = fn(state, edata)
        census.append(dict(collectives.COLLECTIVES))
        fence()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: v.detach().cpu() for k, v in m.items()})
    return {"metrics": metrics, "census": census, "times": times,
            "launches": {k: _build.LAUNCHES[k] - l0[k] for k in l0},
            "state": state}


def split_ms(times: list) -> dict:
    """Medians of an interval-2 run's epochs 2..n: the pull epochs (r
    even) and the push epochs (r odd), apart, since a pull moves the
    slab and a push does not."""
    return {"pull_epoch_ms_median": statistics.median(times[1::2]),
            "push_epoch_ms_median": statistics.median(times[2::2])}


def _cpu_tree(torch, tree):
    if isinstance(tree, dict):
        return {k: _cpu_tree(torch, v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def _dev_tree(torch, tree, dev):
    if isinstance(tree, dict):
        return {k: _dev_tree(torch, v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_dev_tree(torch, v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _metrics_equal(torch, a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


def _pull_census(storage: str, model: str = "gcn", pods: int = 1) -> dict:
    """A pull epoch's census read off the code: one all-to-all a store
    tensor (GAT: a projected z tensor a hidden layer), on pods one send
    and one receive a tensor a peer pod, and 2 all-reduces (the
    gradient/metric buffer, the eps/age max)."""
    from repro_torch.configs import digest_gcn
    tensors = 2 if storage == "int8" else 1
    if model == "gat":
        tensors *= digest_gcn.CONFIG.num_layers - 1
    out = {"all_to_all": tensors, "all_reduce": 2}
    if pods > 1:
        out.update(send=tensors * (pods - 1), recv=tensors * (pods - 1))
    return out


def _check_census(label: str, census: list, pull: dict) -> None:
    for e, c in enumerate(census):
        want = pull if (e + 1) % DIST_INTERVAL == 0 else {"all_reduce": 2}
        check(c == want, f"{label}: epoch {e + 1}'s collectives {c}, "
              f"expected {want}")


def serve_model(torch, dev, g):
    """Phase 4's GCN (3 x 128, random weights from seed 0)."""
    from repro_torch.models.gnn import GNN, GNNConfig
    cfg = GNNConfig(model="gcn", num_layers=3, in_dim=g.features.shape[1],
                    hidden_dim=128, num_classes=int(g.labels.max()) + 1,
                    heads=4)
    return cfg, GNN.init(cfg, torch.Generator().manual_seed(0), dev).tree()


def dist_rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank of phase 15's (b)-(e), all ranks sharing card 0;
    writes its report to ``tmp``.  A failed check exits the rank
    non-zero, which fails the spawn and the script."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/gloo{world}",
                            world_size=world, rank=rank)
    try:
        out = _dist_rank_work(torch, dev, world, rank, tmp)
        torch.save(out, f"{tmp}/w{world}-r{rank}.pt")
    finally:
        dist.destroy_process_group()


def _dist_rank_work(torch, dev, world: int, rank: int, tmp: str) -> dict:
    import numpy as np

    from repro_torch.core import collectives, digest, serving
    from repro_torch.core import halo_exchange as hx
    from repro_torch.core.digest import (full_graph_forward, gather_state,
                                         prepare_graph_data, top_layer_reps)
    from repro_torch.graph import make_dataset
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh

    ref = torch.load(f"{tmp}/ref.pt", weights_only=False)
    mesh = make_mesh(world)
    g = make_dataset("papers-sim", scale=1.0, seed=0)
    data = prepare_graph_data(g, TRAIN_PARTS, seed=0, order="rcm",
                              stream_chunk_rows=TRAIN_CHUNK_ROWS, device=dev)
    sl = hx.part_slice(TRAIN_PARTS, mesh)
    halo = int(data["halo_ids"].shape[1])
    out = {"rank": rank, "train": {}, "serve": {}}

    def held(label, res, key, pods=1, model="gcn"):
        """The run's metrics and whole state against the reference's,
        its census, and its final pulled slab against pull_slab's."""
        want = ref[key]
        whole = gather_state(res["state"], mesh)
        check(_metrics_equal(torch, res["metrics"], want["metrics"]),
              f"{label}: metrics differ from the single-process run")
        check(_tree_equal(torch, whole, _dev_tree(torch, want["state"], dev)),
              f"{label}: state differs from the single-process run")
        storage = res["storage"]
        _check_census(label, res["census"], _pull_census(storage, model,
                                                         pods))
        if model == "gcn":
            edata = digest.shard_data(data, mesh)
            slab = hx.collective_pull(res["state"]["store"],
                                      edata["pull_send"], edata["pull_recv"],
                                      halo, res["mesh"])
            full = hx.pull_slab(whole["store"], data["halo_slots"])
            check(all(torch.equal(slab[k], full[k][sl]) for k in full),
                  f"{label}: the collective slab differs from pull_slab's")
            res["slab"] = slab
        return {"times": res["times"], "launches": res["launches"],
                "census_pull": res["census"][DIST_INTERVAL - 1]}

    for storage in ("fp32", "int8"):
        cfg, params = train_model(torch, dev, data, "gcn")
        settings = train_settings(storage, sync_interval=DIST_INTERVAL,
                                  pull_mode="collective")
        res = dist_run(torch, cfg, data, settings, params, DIST_EPOCHS, mesh)
        res.update(storage=storage, mesh=mesh)
        out["train"][f"gcn/{storage}"] = held(
            f"W={world} gcn/{storage}", res, f"gcn/{storage}")
        if storage == "int8" and world == 4:
            # (c) the (pod, data) = 2 x 2 mesh: 2 epochs, slabs equal to
            # the single-pod collective's and pull_slab's.
            pods = make_mesh(2, 2)
            pres = dist_run(torch, cfg, data, settings, params, 2, pods)
            pres.update(storage=storage, mesh=pods)
            out["train"]["gcn/int8 pods"] = held(
                "pods 2x2 gcn/int8", pres, "gcn/int8@2", pods=2)
            flat = dist_run(torch, cfg, data, settings, params, 2, mesh)
            edata = digest.shard_data(data, mesh)
            flat_slab = hx.collective_pull(flat["state"]["store"],
                                           edata["pull_send"],
                                           edata["pull_recv"], halo, mesh)
            check(all(torch.equal(pres["slab"][k], flat_slab[k])
                      for k in flat_slab),
                  "pods 2x2: the slab differs from the single-pod one")
    if world == 2:
        cfg, params = train_model(torch, dev, data, "gat")
        settings = train_settings("fp32", sync_interval=DIST_INTERVAL,
                                  pull_mode="collective")
        res = dist_run(torch, cfg, data, settings, params, DIST_GAT_EPOCHS,
                       mesh)
        res.update(storage="fp32", mesh=mesh)
        out["train"]["gat/fp32"] = held(f"W={world} gat/fp32", res,
                                        "gat/fp32", model="gat")
    del data

    # (e) sharded serving on phase 4's graph and GCN.
    gs = make_dataset("products-sim", scale=1.0, seed=0)
    sdata_all = prepare_graph_data(gs, SERVE_PARTS, seed=0, device=dev)
    plan = serving.build_serve_plan(sdata_all)
    ssl = hx.part_slice(SERVE_PARTS, mesh)
    cfg, params = serve_model(torch, dev, gs)
    rng = np.random.default_rng(2)
    first = np.full((SERVE_PARTS, BATCH), plan.part_rows, np.int32)
    for m in range(SERVE_PARTS):
        v = np.where(plan.local_valid[m])[0][:BATCH]
        first[m, :len(v)] = v
    rows = rng.integers(0, plan.part_rows,
                        (SERVE_DIST_BATCHES, SERVE_PARTS, BATCH))
    with torch.inference_mode():
        reps = top_layer_reps(cfg, params, sdata_all)
        want = full_graph_forward(cfg, params, sdata_all)[0]
        for storage in ("fp32", "bf16", "int8"):
            scfg = serving.ServeConfig(batch_size=BATCH, storage=storage)
            store0 = serving.init_serve_store(plan, cfg.hidden_dim,
                                              scfg.precision, dev)
            single = serving.make_refresh_fn(donate=False)(
                store0, reps, plan.refresh_data(dev))
            lstore, sdata = serving.place_serving(
                store0, plan.sharded_data(sdata_all), mesh)
            rdata = hx.shard_parts(plan.refresh_data(dev), mesh)
            store = serving.make_refresh_fn(mesh, plan.serve_rows)(
                lstore, reps, rdata)
            check(_tree_equal(torch, store,
                              hx.shard_store(single, SERVE_PARTS, mesh)),
                  f"W={world} serve/{storage}: the sharded refresh differs "
                  f"from the single refresh")

            def query(q):
                return serving.serve_query_sharded(
                    cfg, scfg, mesh, plan.halo_size, params, store, sdata,
                    torch.from_numpy(q[ssl]).to(dev))

            _build.reset_launches()
            collectives.reset_collectives()
            logits = query(first)
            census = dict(collectives.COLLECTIVES)
            check(census == {"all_to_all": 2 if storage == "int8" else 1},
                  f"W={world} serve/{storage}: a batch's collectives "
                  f"{census}")
            err = 0.0
            for i, m in enumerate(range(ssl.start, ssl.stop)):
                v = np.where(plan.local_valid[m])[0][:BATCH]
                gids = torch.from_numpy(plan.local_ids[m][v]).long().to(dev)
                err = max(err, float((logits[i, :len(v)]
                                      - want[gids]).abs().max()))
            check(err <= SERVE_DIST_TOL[storage],
                  f"W={world} serve/{storage}: logits {err:.3e} from "
                  f"full_graph_forward (bar {SERVE_DIST_TOL[storage]})")
            times = []
            for q in rows:
                torch.cuda.synchronize()
                collectives.barrier()
                t0 = time.perf_counter()
                query(q)
                torch.cuda.synchronize()
                collectives.barrier()
                times.append((time.perf_counter() - t0) * 1e3)
            out["serve"][storage] = {
                "err": err, "census": census, "times": times,
                "launches": dict(_build.LAUNCHES)}
    return out


def distributed(torch, dev, data, raw_epoch_ms, smi) -> dict:
    """Phase 15: the multi-GPU exchange on one card.  (a) one rank over
    NCCL in this process: the collective epoch of phase 7's settings
    equal to the gather epoch (metrics every epoch, the final state),
    with the NCCL census; then the single-process references of (b)-(d)
    in this process, and (b)-(e) on 2 and 4 gloo ranks sharing the card
    (``dist_rank``).  Returns the path's summary with its launches."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.core import collectives
    from repro_torch.core.halo_exchange import HaloSpec
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    out = {"phase": 15}
    coll = collections.Counter()        # collective-path kernel launches
    with tempfile.TemporaryDirectory() as tmp:
        # (a) W = 1 over NCCL.
        cfg, params = train_model(torch, dev, data, "gcn")
        base = train_settings("fp32")
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl",
                                world_size=1, rank=0, device_id=dev)
        try:
            mesh = make_mesh(1, 1, "cuda")
            one = dist_run(torch, cfg, data, base, params, TRAIN_EPOCHS)
            many = dist_run(torch, cfg, data, dataclasses.replace(
                base, pull_mode="collective"), params, TRAIN_EPOCHS, mesh)
        finally:
            dist.destroy_process_group()
        check(_metrics_equal(torch, one["metrics"], many["metrics"]),
              "(a) NCCL W=1: metrics differ from the gather epoch")
        check(_tree_equal(torch, one["state"], many["state"]),
              "(a) NCCL W=1: state differs from the gather epoch")
        check(one["launches"] == many["launches"],
              f"(a) NCCL W=1: launches {many['launches']} against the "
              f"gather epoch's {one['launches']}")
        pulls = [c for e, c in enumerate(many["census"])
                 if (e + 1) % base.sync_interval == 0]
        check(pulls and all(c == _pull_census("fp32") for c in pulls)
              and all(c == {"all_reduce": 2} for e, c in
                      enumerate(many["census"])
                      if (e + 1) % base.sync_interval),
              f"(a) NCCL W=1: census {many['census']}")
        coll.update(many["launches"])
        out["a_nccl_w1"] = {
            "epochs": TRAIN_EPOCHS, "equal": True,
            "census_pull_epoch": pulls[0],
            "epoch_ms_median": statistics.median(many["times"][1:]),
            "gather_epoch_ms_median": statistics.median(one["times"][1:])}
        print(f"phase 15 (a) NCCL W=1: {TRAIN_EPOCHS} collective epochs "
              f"== gather epochs (metrics, params, store); pull-epoch "
              f"census {pulls[0]}; epoch {out['a_nccl_w1']['epoch_ms_median']:.2f}"
              f" ms against gather {out['a_nccl_w1']['gather_epoch_ms_median']:.2f}"
              f" ms", flush=True)
        del one, many

        # The single-process references of (b)-(d).
        ref, ref_launch = {}, {}
        for key, model, storage, epochs in (
                ("gcn/fp32", "gcn", "fp32", DIST_EPOCHS),
                ("gcn/int8", "gcn", "int8", DIST_EPOCHS),
                ("gcn/int8@2", "gcn", "int8", 2),
                ("gat/fp32", "gat", "fp32", DIST_GAT_EPOCHS)):
            cfg, params = train_model(torch, dev, data, model)
            res = dist_run(torch, cfg, data, train_settings(
                storage, sync_interval=DIST_INTERVAL), params, epochs)
            ref[key] = {"metrics": res["metrics"],
                        "state": _cpu_tree(torch, res["state"])}
            ref_launch[key] = res["launches"]
            if key == "gcn/fp32":
                out["gather_interval2"] = split_ms(res["times"])
        torch.save(ref, f"{tmp}/ref.pt")
        del ref
        torch.cuda.synchronize()
        _build.build()              # the ranks load these libraries
        for world in DIST_WORLDS:
            t0 = time.perf_counter()
            mp.spawn(dist_rank, args=(world, tmp), nprocs=world, join=True)
            ranks = [torch.load(f"{tmp}/w{world}-r{r}.pt", weights_only=False)
                     for r in range(world)]
            summary = {"seconds": time.perf_counter() - t0}
            for key in ranks[0]["train"]:
                summed = collections.Counter()
                for r in ranks:
                    summed.update(r["train"][key]["launches"])
                want = ref_launch[key.replace(" pods", "@2")]
                check({k: summed[k] for k in want} == want,
                      f"W={world} {key}: launches summed over ranks "
                      f"{dict(summed)} against the single process's {want}")
                coll.update(summed)
                times = ranks[0]["train"][key]["times"]
                summary[key] = {
                    "launches_summed": dict(summed),
                    "census_pull_epoch": ranks[0]["train"][key]["census_pull"],
                    "epoch_ms": times}
                if len(times) > 2:
                    summary[key].update(split_ms(times))
            for storage, res in ranks[0]["serve"].items():
                summed = collections.Counter()
                for r in ranks:
                    summed.update(r["serve"][storage]["launches"])
                summary[f"serve/{storage}"] = {
                    "p50_ms": statistics.median(res["times"][1:]),
                    "max_abs_err": max(r["serve"][storage]["err"]
                                       for r in ranks),
                    "bar": SERVE_DIST_TOL[storage],
                    "census": res["census"], "launches": dict(summed)}
                out.setdefault("serve_launches", collections.Counter()
                               ).update(summed)
            out[f"w{world}"] = summary
            gcn, ref2 = summary["gcn/fp32"], out["gather_interval2"]
            print(f"phase 15 W={world} gloo ranks on one card ({smi}): "
                  f"gcn fp32/int8 {DIST_EPOCHS} epochs, "
                  + ("pods 2x2 2 epochs, " if world == 4 else
                     f"gat {DIST_GAT_EPOCHS} epochs, ")
                  + f"== the single process (metrics, state, slabs, summed "
                  f"launches); gcn fp32 epoch medians, pull "
                  f"{gcn['pull_epoch_ms_median']:.2f} ms and push "
                  f"{gcn['push_epoch_ms_median']:.2f} ms (one process at "
                  f"interval 2: {ref2['pull_epoch_ms_median']:.2f} and "
                  f"{ref2['push_epoch_ms_median']:.2f} ms; phase 7 "
                  f"{raw_epoch_ms:.2f} ms); sharded serving p50 "
                  + ", ".join(f"{s} {summary[f'serve/{s}']['p50_ms']:.2f} ms"
                              for s in ("fp32", "bf16", "int8")),
                  flush=True)
        sp = data["_sp"]
        for storage in ("fp32", "int8"):
            spec = HaloSpec.from_partitions(
                sp, 128, 3, train_settings(storage).precision)
            out[f"wire_bytes/{storage}"] = {
                "collective_pull": spec.collective_pull_nbytes(
                    int(data["pull_send"].shape[2])),
                "replicated_pull": spec.replicated_pull_nbytes(),
                "ragged_ideal": spec.comm_bytes(sp.pull_rows(),
                                                sp.push_rows())["pull_bytes"]}
        print("phase 15 pull wire bytes: " + json.dumps(
            {k: v for k, v in out.items() if k.startswith("wire")}),
            flush=True)
    out["launches"] = {k: coll.get(k, 0) for k in _build.LAUNCHES}
    out["serve_launches"] = {k: out.get("serve_launches", {}).get(k, 0)
                             for k in _build.LAUNCHES}
    collectives.reset_collectives()
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps(out), flush=True)
    return out


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


def k5_inputs(torch, dev, data, gen) -> list:
    """K5's inputs at the shapes it is held and timed at: GAT's per-head
    width 32 on subgraph 0 of the training partition (the in-ELL over the
    local table, the out-ELL over the halo table, valid where the id is
    not the sentinel), and the reference's own test shape, (128, 8) over a
    (65, 128) table (tests/test_kernels_gat_edge.py), where it is
    launch-bound.  Random scores and tables from ``gen``, the sentinel row
    zero.  Returns ``[(side, (nbr, valid, s_dst, s_src, z))]``."""
    st = {k_: v_[0] for k_, v_ in data["struct"].items()}
    rows = st["in_nbr"].shape[0]
    ref_nbr = torch.randint(0, 65, (128, 8), generator=gen,
                            dtype=torch.int32).to(dev)
    out = []
    for side, nbr, n_cols, width in (
            ("in", st["in_nbr"], rows, 32),
            ("out", st["out_nbr"], int(data["halo_ids"].shape[1]), 32),
            ("ref", ref_nbr, 64, 128)):
        s_dst = torch.randn((nbr.shape[0],), generator=gen)
        s_src = torch.randn((n_cols + 1,), generator=gen)
        z = torch.randn((n_cols + 1, width), generator=gen)
        s_src[-1], z[-1] = 0, 0
        out.append((side, (nbr, nbr < n_cols, s_dst.to(dev), s_src.to(dev),
                           z.to(dev))))
    return out


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
    bf, f32 = torch.bfloat16, torch.float32
    every = ((bf, True, LM_SEQ), (f32, True, LM_SEQ), (bf, False, 512),
             (f32, False, 512))
    cases = [(suffix, b, h, kv, d, dtype, causal, s)
             for suffix, b, h, kv, d, runs in K6_SHAPES
             for dtype, causal, s in (every if runs == "all" else every[:2])]
    for suffix, b, h, kv, d, dtype, causal, s in cases:
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
                f"{'causal' if causal else 'non-causal'} S{s}{suffix}",
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

    for side, args in k5_inputs(torch, dev, data, gen):
        nbr, n_cols, width = args[0], args[3].shape[0] - 1, args[4].shape[1]
        n_rows = nbr.shape[0]
        got, want = gat_edge_partial_cuda(*args), gat_edge_partial_plain(*args)
        # m is a max of identically computed values: equal bit for bit.
        check(torch.equal(got[1], want[1]),
              f"K5 [{side}]: m differs from its plain version: max |err| "
              f"{float((got[1] - want[1]).abs().max()):.3e}")
        check(torch.allclose(got[2], want[2], atol=K5_STAT_TOL,
                             rtol=K5_STAT_TOL),
              f"K5 [{side}]: l disagrees with its plain version: max |err| "
              f"{float((got[2] - want[2]).abs().max()):.3e}")
        again = gat_edge_partial_cuda(*args)
        check(all(torch.equal(a_, g_) for a_, g_ in zip(again, got)),
              f"K5 [{side}]: two launches differ")
        # Reported, not required: whether acc and l are the plain
        # version's bits too.
        print(json.dumps({"k5_bitwise": side, "acc": torch.equal(
            got[0], want[0]), "l": torch.equal(got[2], want[2])}),
            flush=True)
        n_slots = nbr.numel()
        ref_rows = int(torch.unique(nbr).numel())
        nbytes = (n_slots * 5 + n_rows * 4 + ref_rows * 4 * (1 + width)
                  + n_rows * width * 4 + 2 * n_rows * 4)
        # Every slot is taken (no slot may be skipped): per slot the score
        # (add, multiply), two subtractions and two exps, l's multiply
        # and add, and three operations a feature.
        variant = (f"{side}-ELL head w{width}" if side != "ref"
                   else f"reference shape w{width}")
        measure(torch, records, "gat_edge_partial", variant,
                list(nbr.shape) + [n_cols + 1, width], got[0], want[0],
                lambda: gat_edge_partial_cuda(*args),
                lambda: gat_edge_partial_plain(*args),
                roofline(nbytes, n_slots * (3 * width + 8)), None, None,
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
        l32, ms32, launches32 = run(c32, "fp32 kernel")
        d32, dense32_ms, _ = run(dataclasses.replace(c32,
                                                     attn_backend="dense"),
                                 "fp32 dense")
        fp32_rel = float((l32 - d32).abs().max()) / float(d32.abs().max())
        check(fp32_rel <= LM_FP32_TOL,
              f"fp32 prefill through K6 differs from the dense oracle by "
              f"{fp32_rel:.3e} of max |logit| (bar {LM_FP32_TOL})")
        logits32 = l32[:, :LM_TEACHER].clone()
        del l32, d32
        # Where a prefill's device time goes (one more bf16 and one more
        # fp32 forward, traced; the launch counts above were read before),
        # and K6's share of the fp32 one.
        prof = profile_serve_loop(
            lambda c, _: (c, forward(cfg, params, tokens)), range(1), top=6)
        # The profiler has been seen to drop one kernel record of such a
        # trace (27 K6 records of 28 launches, once in several runs): a
        # trace whose K6 records fall short of the launches the wrapper
        # counted during it is taken again, at most TRACE_ATTEMPTS times.
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            n0 = _build.LAUNCHES["flash_attention"]
            prof32 = profile_serve_loop(
                lambda c, _: (c, forward(c32, params, tokens)), range(1),
                top=200)
            launched = _build.LAUNCHES["flash_attention"] - n0
            k6_32 = [e for e in prof32["top"]
                     if "flash_attention" in e["op"]]
            traced = sum(e["calls"] for e in k6_32)
            check(launched == cfg.num_layers,
                  f"fp32 prefill: {launched} K6 launches, expected "
                  f"{cfg.num_layers}")
            if traced == launched:
                break
            print(f"fp32 prefill trace {attempt}: {traced} K6 records of "
                  f"{launched} launches; tracing again", flush=True)
        check(traced == cfg.num_layers,
              f"fp32 prefill trace: K6 ops {k6_32}, expected "
              f"{cfg.num_layers} calls in any of {TRACE_ATTEMPTS} traces")
        prof32["trace_attempts"] = attempt
        prof32["k6_device_ms"] = sum(e["device_ms"] for e in k6_32)
        prof32["k6_share"] = prof32["k6_device_ms"] / prof32["device_ms"]
        prof32["top"] = prof32["top"][:6]
        print(f"prefill fp32: {ms32:.2f} ms wall, traced device "
              f"{prof32['device_ms']:.2f} ms, K6 {prof32['k6_device_ms']:.3f} "
              f"ms ({100 * prof32['k6_share']:.1f}%)", flush=True)
    res = {"path": "lm prefill", "arch": cfg.name, "batch": LM_BATCH,
           "seq": LM_SEQ, "params": n_params, "prefill_ms": ms,
           "prefill_ms_again": ms2, "dense_prefill_ms": dense_ms,
           "fp32_prefill_ms": ms32, "fp32_dense_prefill_ms": dense32_ms,
           "tokens_per_s": LM_BATCH * LM_SEQ / (min(ms, ms2) / 1e3),
           "bf16_rel_err_vs_dense": bf16_rel,
           "bf16_oracle_ulp_sensitivity": bf16_sens,
           "bf16_err_over_sensitivity": bf16_ratio,
           "fp32_rel_err_vs_dense": fp32_rel, "launches": launches,
           "fp32_launches": launches32, "profile": prof,
           "fp32_profile": prof32}
    print(json.dumps(res), flush=True)
    return {"cfg": cfg, "params": params, "tokens": tokens,
            "logits": logits[:, :LM_TEACHER].clone(), "logits32": logits32,
            "launches": launches, "fp32_launches": launches32}


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


# ---------------------------------------------------------------------------
# Phase 16: MoE serving (llama4-scout at its published widths, depth cut)
# ---------------------------------------------------------------------------

def record_routes() -> list:
    """Make the MoE router (``repro_torch.models.moe._route``, which
    ``moe_ref`` and the capacity path call once a layer) also append each
    call's (top-k ids, router logits) to the returned list; the caller
    clears it before a run.  A second call returns the first one's
    list."""
    from repro_torch.models import moe
    if hasattr(moe._route, "log"):          # recorded already
        return moe._route.log
    log = []
    route = moe._route

    def recorded(x, w, k):
        out = route(x, w, k)
        log.append((out[1], out[2]))
        return out

    recorded.log = log
    moe._route = recorded
    return log


def route_diff(torch, got: list, want: list, batch: int) -> dict:
    """The (token, layer) routes whose top-k sets differ between two runs
    (per layer: ``(ids (N, k), logits (N, E))``, tokens in (sequence,
    position) order over ``batch`` sequences), each with the gap in
    ``want``'s router logits that decides its set (the k-th largest less
    the (k+1)-th) over the layer's max |logit|.  A flip moves its token
    and, through causal attention, every later token of its sequence
    from the next layer on.  Returns ``flips`` (layer, token, gap), the
    (N,) masks of the tokens moved by ties (gaps under MOE_TIE) and by
    any flip (``ties``, ``moved``), and per layer the ``noise``: the
    largest change of a router logit between the runs over the tokens
    no flip moved, on the gaps' scale.  A flip at a gap up to twice the
    noise (a difference of two logits) is what the runs' own rounding
    can do."""
    n, layers = got[0][0].shape[0], len(got)
    ties = torch.zeros((batch, n // batch), dtype=torch.bool,
                       device=got[0][0].device)
    moved = torch.zeros_like(ties)
    flips = []
    for layer, ((ids, _), (ids_w, logits)) in enumerate(zip(got, want)):
        k = ids.shape[1]
        differ = (ids.sort(dim=1).values
                  != ids_w.sort(dim=1).values).any(dim=1)
        top = logits.topk(k + 1, dim=1).values
        gap = (top[:, k - 1] - top[:, k]) / logits.abs().max()
        flips += [{"layer": layer, "token": t, "gap": float(gap[t])}
                  for t in differ.nonzero()[:, 0].tolist()]
        for mask, where in ((moved, differ), (ties, differ & (gap < MOE_TIE))):
            where = where.reshape(batch, -1)
            if layer < layers - 1:
                where = where.int().cummax(dim=1).values.bool()
            mask |= where
    ties, moved = ties.reshape(-1), moved.reshape(-1)
    noise = [float(torch.where(moved[:, None], 0.0, (lg - lw).abs()).max()
                   / lw.abs().max())
             for (_, lg), (_, lw) in zip(got, want)]
    return {"flips": flips, "ties": ties, "moved": moved, "noise": noise}


def rows_rel_err(got, want, skip) -> float:
    """max |got - want| over the rows (tokens) not in ``skip``, over max
    |want|."""
    import torch
    diff = (got.float() - want.float()).abs().amax(dim=-1).reshape(-1)
    return float(torch.where(skip, 0.0, diff).max()) / float(
        want.abs().max())


def op_class(name: str) -> str:
    """A device op's class, by its kernel name: matrix products (cuBLAS's
    ``nvjet`` kernels among them), copies and casts, reductions, or other
    elementwise work."""
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "matrix products"
    if "copy" in low or "memcpy" in low or "memset" in low:
        return "copies and casts"
    if "reduce" in low or "softmax" in low or "scan" in low:
        return "reductions"
    return "elementwise and other"


def top_ops(prof: dict) -> list:
    """(op name cut to 48 characters, device ms) of a trace's top ops."""
    return [(e["op"][:48], round(e["device_ms"], 3)) for e in prof["top"]]


def correlation(torch, a, b) -> float:
    """Pearson correlation of two tensors' elements, summed in fp64."""
    a = a.double().reshape(-1) - a.double().mean()
    b = b.double().reshape(-1) - b.double().mean()
    return float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum()))


def decode_routes(log: list, layers: int, batch: int) -> list:
    """Per layer, the routes of a teacher-forced decode (one router call a
    layer a step, step-major) in prefill's token order (b, t)."""
    import torch
    out = []
    for layer in range(layers):
        calls = log[layer::layers]
        out.append(tuple(torch.stack([c[i] for c in calls], 1).reshape(
            batch * len(calls), -1) for i in (0, 1)))
    return out


def moe_serving(torch, dev, smi) -> dict:
    """Phase 16: llama4-scout at its published widths, MOE_LAYERS layers,
    weights drawn on the card (a CUDA ``torch.Generator``, seed 0):
    prefill through K6 against the dense oracle, the capacity path
    against ``moe_ref``, decode, and traces."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import long_config, serve
    from repro_torch.launch.serving_driver import profile_serve_loop
    from repro_torch.models.transformer import (arch_specs, decode_step,
                                                forward, init_cache)
    from repro_torch.nn import init_params, param_bytes, param_count
    from repro_torch.train import make_serve_step

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_arch(MOE_ARCH), num_layers=MOE_LAYERS,
                              attn_backend="kernel")
    specs = arch_specs(cfg)
    n_params, n_bytes = param_count(specs), param_bytes(specs)
    print(f"moe: {cfg.name} cut to {cfg.num_layers} layers of "
          f"{get_arch(MOE_ARCH).num_layers}, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv, head_dim "
          f"{cfg.hd}, {cfg.num_experts} experts top-{cfg.experts_per_token} "
          f"+ shared, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n_params} "
          f"params, {n_bytes / 1e9:.2f} GB ({cfg.param_dtype})", flush=True)
    t0 = time.perf_counter()
    params = init_params(specs, torch.Generator(device=dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                           generator=torch.Generator().manual_seed(1)
                           ).to(dev)
    log = record_routes()
    n_tok = LM_BATCH * LM_SEQ

    def run(c, label, p=params):
        torch.cuda.synchronize()
        _build.reset_launches()
        log.clear()
        t = time.perf_counter()
        out = forward(c, p, tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = dict(_build.LAUNCHES)
        check(out.shape == (LM_BATCH, LM_SEQ, cfg.vocab_size)
              and bool(torch.isfinite(out).all()),
              f"moe prefill [{label}]: logits malformed")
        want_k6 = cfg.num_layers if c.attn_backend == "kernel" else 0
        check(launches["flash_attention"] == want_k6
              and sum(launches.values()) == want_k6,
              f"moe prefill [{label}]: launches {launches}, expected K6 "
              f"{want_k6} times and nothing else")
        check(len(log) == cfg.num_layers,
              f"moe prefill [{label}]: {len(log)} router calls")
        return out, ms, launches, list(log)

    def flips_of(label, got, want):
        d = route_diff(torch, got, want, LM_BATCH)
        n = len(got[0][0]) * cfg.num_layers
        print(f"moe routes [{label}]: {len(d['flips'])} of {n} (token, "
              f"layer) top-{cfg.experts_per_token} sets differ, moving "
              f"{int(d['moved'].sum())} tokens, {int(d['ties'].sum())} by "
              f"a tie (gap < {MOE_TIE} of the router logits' scale); gaps "
              f"{sorted(f['gap'] for f in d['flips'])[:8]}; router-logit "
              f"noise a layer {d['noise']}", flush=True)
        return {"flips": len(d["flips"]), "tie_tokens": int(d["ties"].sum()),
                "moved_tokens": int(d["moved"].sum()),
                "gaps": [f["gap"] for f in d["flips"]],
                "noise": d["noise"]}, d

    out = {"path": "moe serving", "arch": cfg.name, "layers": cfg.num_layers,
           "batch": LM_BATCH, "seq": LM_SEQ, "params": n_params,
           "param_bytes": n_bytes, "init_s": init_s}
    with torch.inference_mode():
        # (a) prefill through K6 (moe_impl "auto": the dropless moe_ref)
        # against the dense oracle, bf16 then fp32 activations.
        run(cfg, "warm-up")
        logits, ms, launches, r_k6 = run(cfg, "bf16 kernel")
        _, ms2, _, _ = run(cfg, "bf16 kernel")
        dense_cfg = dataclasses.replace(cfg, attn_backend="dense")
        dense, dense_ms, _, r_dense = run(dense_cfg, "bf16 dense")
        out["routes_bf16"], d = flips_of("bf16 K6 vs dense", r_k6, r_dense)
        ties = d["ties"]
        bf16_rel = rows_rel_err(logits, dense, ties)
        # Reported: the error over the tokens whose routes agree.
        out["bf16_rel_err_vs_dense_same_routes"] = rows_rel_err(
            logits, dense, d["moved"])
        emb = params["embed"].to(torch.bfloat16)
        bumped = (emb.view(torch.int16) + 1).view(torch.bfloat16).float()
        del emb
        moved, _, _, _ = run(dense_cfg, "bf16 dense, embeddings + 1 ulp",
                             dict(params, embed=bumped))
        del bumped
        bf16_sens = rows_rel_err(moved, dense, torch.zeros_like(ties))
        del moved, dense
        ratio = bf16_rel / max(bf16_sens, 1e-30)
        print(f"moe prefill bf16: K6 path vs dense oracle {bf16_rel:.4e} of "
              f"max |logit| ({int(ties.sum())} tie tokens left out; "
              f"{out['bf16_rel_err_vs_dense_same_routes']:.4e} over the "
              f"tokens whose routes agree); the oracle's one-ulp "
              f"sensitivity {bf16_sens:.4e}; ratio {ratio:.3f} (bar "
              f"{LM_BF16_SENS_FACTOR})", flush=True)
        check(bf16_rel <= LM_BF16_SENS_FACTOR * bf16_sens,
              f"moe bf16 prefill through K6 differs from the dense oracle "
              f"by {bf16_rel:.3e} of max |logit|, more than "
              f"{LM_BF16_SENS_FACTOR} x its one-ulp sensitivity "
              f"{bf16_sens:.3e}")
        c32 = dataclasses.replace(cfg, dtype="float32")
        l32, ms32, launches32, r32 = run(c32, "fp32 kernel")
        d32, dense32_ms, _, r32_dense = run(
            dataclasses.replace(c32, attn_backend="dense"), "fp32 dense")
        out["routes_fp32"], d = flips_of("fp32 K6 vs dense", r32, r32_dense)
        fp32_rel = rows_rel_err(l32, d32, d["ties"])
        del d32
        print(f"moe prefill fp32: K6 path vs dense oracle {fp32_rel:.4e} of "
              f"max |logit| (bar {LM_FP32_TOL})", flush=True)
        check(fp32_rel <= LM_FP32_TOL,
              f"moe fp32 prefill through K6 differs from the dense oracle "
              f"by {fp32_rel:.3e} of max |logit| (bar {LM_FP32_TOL})")
        out.update(prefill_ms=ms, prefill_ms_again=ms2,
                   dense_prefill_ms=dense_ms, fp32_prefill_ms=ms32,
                   fp32_dense_prefill_ms=dense32_ms,
                   tokens_per_s=n_tok / (min(ms, ms2) / 1e3),
                   bf16_rel_err_vs_dense=bf16_rel,
                   bf16_oracle_ulp_sensitivity=bf16_sens,
                   bf16_err_over_sensitivity=ratio,
                   fp32_rel_err_vs_dense=fp32_rel, launches=launches,
                   fp32_launches=launches32)

        # (b) the capacity path: at a factor that drops nothing against
        # moe_ref (fp32), at the config's factor its drops, its
        # correlation with moe_ref and two runs bit for bit (bf16).
        ep16 = dataclasses.replace(c32, moe_impl="ep",
                                   moe_capacity_factor=MOE_DROPLESS_CF)
        l_ep, ep16_ms, _, r_ep = run(ep16, "fp32 ep, dropless")
        out["routes_ep_dropless"], d = flips_of(
            "fp32 ep dropless vs moe_ref", r_ep, r32)
        ep_rel = rows_rel_err(l_ep, l32, d["ties"])
        del l_ep
        check(ep_rel <= MOE_EP_TOL,
              f"moe_ep at capacity {MOE_DROPLESS_CF} differs from moe_ref "
              f"by {ep_rel:.3e} of max |logit| (bar {MOE_EP_TOL})")
        logits32 = l32[:, :LM_TEACHER].clone()
        r32_teacher = [tuple(x.reshape(LM_BATCH, LM_SEQ, -1)[:, :LM_TEACHER]
                             .reshape(LM_BATCH * LM_TEACHER, -1) for x in r)
                       for r in r32]
        del l32
        ep = dataclasses.replace(cfg, moe_impl="ep")
        l_a, ep_ms, _, r_a = run(ep, "bf16 ep")
        l_b, ep_ms2, _, _ = run(ep, "bf16 ep")
        check(torch.equal(l_a, l_b), "moe_ep: two runs differ")
        del l_b
        c_e = max(int(cfg.moe_capacity_factor * n_tok
                      * cfg.experts_per_token / cfg.num_experts), 1)
        dropped = [int(torch.clamp_min(torch.bincount(
            ids.reshape(-1).long(), minlength=cfg.num_experts) - c_e,
            0).sum()) for ids, _ in r_a]
        corr = correlation(torch, l_a, logits)
        del l_a
        print(f"moe ep: capacity {MOE_DROPLESS_CF} vs moe_ref (fp32) "
              f"{ep_rel:.4e} of max |logit| (bar {MOE_EP_TOL}); capacity "
              f"{cfg.moe_capacity_factor} ({c_e} rows an expert) drops "
              f"{dropped} of {n_tok * cfg.experts_per_token} assignments a "
              f"layer, correlation with moe_ref {corr:.5f} (bar "
              f"{MOE_MIN_CORR}); two runs bit for bit; bf16 prefill "
              f"{min(ep_ms, ep_ms2):.2f} ms against moe_ref's "
              f"{min(ms, ms2):.2f}, fp32 dropless {ep16_ms:.2f}", flush=True)
        check(corr > MOE_MIN_CORR,
              f"moe_ep at capacity {cfg.moe_capacity_factor}: correlation "
              f"{corr:.4f} with moe_ref (bar {MOE_MIN_CORR})")
        out.update(ep_dropless_rel_err=ep_rel, ep_dropless_ms=ep16_ms,
                   ep_ms=min(ep_ms, ep_ms2), ep_capacity_rows=c_e,
                   ep_dropped=dropped, ep_corr=corr)
        logits = logits[:, :LM_TEACHER].clone()
        r_teacher = [tuple(x.reshape(LM_BATCH, LM_SEQ, -1)[:, :LM_TEACHER]
                           .reshape(LM_BATCH * LM_TEACHER, -1) for x in r)
                     for r in r_k6]

        # (d) where a prefill's device time goes (one more bf16 forward,
        # traced; its launches counted above).
        prof = profile_serve_loop(
            lambda c, _: (c, forward(cfg, params, tokens)), range(1),
            top=200)
        k6 = [e for e in prof["top"] if "flash_attention" in e["op"]]
        prof["k6_device_ms"] = sum(e["device_ms"] for e in k6)
        prof["k6_share"] = prof["k6_device_ms"] / prof["device_ms"]
        prof["top"] = prof["top"][:6]
        out["prefill_profile"] = prof
        print(f"moe prefill bf16 traced: device {prof['device_ms']:.2f} ms, "
              f"K6 {prof['k6_device_ms']:.3f} ms "
              f"({100 * prof['k6_share']:.2f}%), busy "
              f"{100 * prof['busy_share']:.1f}%; top {top_ops(prof)}",
              flush=True)

    # (c) decode: the serve loop (full and long caches), 8 steps traced,
    # and teacher forcing against the prefill (moe_ref) logits.
    _build.reset_launches()
    for long in (False, True):
        c = long_config(cfg) if long else cfg
        stats, outs, _ = serve(c, params, LM_BATCH, LM_MAX_SEQ, LM_GEN,
                               long=long, device=dev)
        check(all(o.shape == (LM_BATCH, 1, cfg.vocab_size)
                  and bool(torch.isfinite(o).all()) for o in outs),
              f"moe serve [long={long}]: logits malformed")
        key = "long" if long else "full"
        out[key] = {"ms_per_token": stats.total_s / LM_GEN * 1e3,
                    "p50_ms": stats.p50_ms, "p99_ms": stats.p99_ms,
                    "tokens_per_s": stats.per_sec}
        print(f"moe serve {cfg.name} long={long} batch={LM_BATCH}: "
              f"{out[key]['ms_per_token']:.3f} ms/token (steady p50 "
              f"{stats.p50_ms:.3f} / p99 {stats.p99_ms:.3f} ms)", flush=True)
    out["decode_launches"] = dict(_build.LAUNCHES)
    with torch.inference_mode():
        step = make_serve_step(cfg)

        def traced(carry, _):
            cache, toks = carry
            lg, cache = step(params, cache, toks)
            return (cache, torch.argmax(lg, dim=-1)), lg

        dprof = profile_serve_loop(
            traced, range(MOE_TRACED), top=6,
            carry=(init_cache(cfg, LM_BATCH, LM_MAX_SEQ, device=dev),
                   tokens[:, :1]))
        out["full"]["profile"] = dprof
        print(f"moe decode traced ({MOE_TRACED} steps): device "
              f"{dprof['device_ms']:.2f} ms, busy "
              f"{100 * dprof['busy_share']:.1f}%; top {top_ops(dprof)}",
              flush=True)
        for key, c, ref, r_ref in (
                ("bf16", cfg, logits, r_teacher),
                ("fp32", c32, logits32, r32_teacher)):
            cache = init_cache(c, LM_BATCH, LM_MAX_SEQ, device=dev)
            log.clear()
            steps = []
            for t in range(LM_TEACHER):
                lg, cache = decode_step(c, params, cache, tokens[:, t:t + 1])
                steps.append(lg)
            dec = torch.cat(steps, dim=1)
            # A flipped token takes another expert's output from there on
            # (top-1 here: its logits move by tens of percent of max
            # |logit|, and the later tokens of its sequence see it), so
            # the tokens a flip moved are left out of the bar and
            # counted, and each flip must be a tie or within what the
            # two paths' rounding does to the router logits.
            out[f"routes_decode_{key}"], d = flips_of(
                f"{key} decode vs prefill",
                decode_routes(log, cfg.num_layers, LM_BATCH), r_ref)
            wild = [f for f in d["flips"] if f["gap"] >= MOE_TIE
                    and f["gap"] > 2 * d["noise"][f["layer"]]]
            check(not wild, f"moe {key} decode: routes flipped beyond the "
                  f"router-logit noise {d['noise']}: {wild}")
            rel = rows_rel_err(dec, ref, d["moved"])
            check(rel < DECODE_TOL, f"moe teacher-forced {key} decode "
                  f"differs from the prefill logits by {rel:.3e} of max "
                  f"|logit| (bar {DECODE_TOL})")
            out[f"decode_vs_prefill_rel_err_{key}"] = rel
            out[f"decode_vs_prefill_bar_ratio_{key}"] = rel / DECODE_TOL
            out[f"decode_moved_tokens_{key}"] = int(d["moved"].sum())
            if bool(d["moved"].any()):
                out[f"decode_moved_rel_err_{key}"] = rows_rel_err(
                    dec, ref, ~d["moved"])
            del cache, steps, dec
    out["seconds"] = time.perf_counter() - t_phase
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    print(f"moe serving ({smi}): " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 17: LM training
# ---------------------------------------------------------------------------

def lm_rank(rank: int, world: int, tmp: str, device: str) -> None:
    """One gloo rank of phase 17 (e), all ranks sharing ``device`` (card
    0): the pod form (one rank a pod) against the stacked form computed
    in this rank, at smoke width; writes its report to ``tmp``."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(2)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/lm{world}",
                            world_size=world, rank=rank)
    try:
        from repro_torch.configs import get_smoke_arch
        from repro_torch.core import collectives
        from repro_torch.data import make_lm_pipeline
        from repro_torch.kernels import _build
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.optim import tree_leaves
        from repro_torch.train import (TrainSettings, init_train_state,
                                       make_train_step)

        cfg = get_smoke_arch(LM_TRAIN_ARCH)
        stacked = TrainSettings(sync_mode="digest", n_pod=world,
                                sync_interval=LM_POD_INTERVAL,
                                total_steps=LM_SMOKE_STEPS, warmup_steps=2)
        pods = dataclasses.replace(stacked, pod_impl="shard_map")
        it = make_lm_pipeline(cfg.vocab_size, LM_SMOKE_BATCH, LM_SMOKE_SEQ,
                              seed=3, device=dev)
        mesh = make_mesh(1, world)
        pod = mesh.get_local_rank("pod")
        sb = init_train_state(cfg, stacked, device=dev)
        sc = init_train_state(cfg, pods, device=dev)
        fb, fc = make_train_step(cfg, stacked), make_train_step(cfg, pods,
                                                                 mesh)
        _build.reset_launches()
        equal, census = [], []
        for _ in range(LM_POD_STEPS):
            b = next(it)
            b = {"tokens": b.tokens, "labels": b.labels, "mask": b.mask}
            sb, mb = fb(sb, b)
            collectives.reset_collectives()
            sc, mc = fc(sc, b)
            census.append(dict(collectives.COLLECTIVES))
            equal.append(
                all(torch.equal(mb[k], mc[k]) for k in ("loss", "ce", "aux"))
                and all(torch.equal(x[pod], y)
                        for key in ("params", "opt_state")
                        for x, y in zip(tree_leaves(sb[key]),
                                        tree_leaves(sc[key]))))
        torch.save({"pod": pod, "equal": equal, "census": census,
                    "loss": [float(mc["loss"])],
                    "launches": dict(_build.LAUNCHES)},
                   f"{tmp}/lm-r{rank}.pt")
    finally:
        dist.destroy_process_group()


def _lm_batches(torch, cfg, n, batch, seq, seed, dev):
    from repro_torch.data import make_lm_pipeline
    it = make_lm_pipeline(cfg.vocab_size, batch, seq, seed=seed, device=dev)
    out = []
    for _ in range(n):
        b = next(it)
        out.append({"tokens": b.tokens, "labels": b.labels, "mask": b.mask})
    return out


def _lm_run(torch, cfg, settings, batches, dev, state=None):
    """(state, [metric dicts of floats]) of ``len(batches)`` steps."""
    from repro_torch.train import init_train_state, make_train_step
    if state is None:
        state = init_train_state(cfg, settings, device=dev)
    step = make_train_step(cfg, settings)
    metrics = []
    for b in batches:
        state, m = step(state, {k: v.to(dev) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _lm_equal(torch, a, b) -> bool:
    from repro_torch.optim import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(la, lb))


def lm_training(torch, dev, smi) -> dict:
    """Phase 17: the LM trainer (module docstring).  Returns the phase's
    summary with its kernel launches (all 0: no hand-written kernel lies
    on this path)."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.checkpoint import (restore_checkpoint,
                                        save_checkpoint)
    from repro_torch.configs import get_arch, get_smoke_arch
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.serving_driver import profile_serve_loop
    from repro_torch.optim import tree_leaves
    from repro_torch.train import (TrainSettings, init_train_state,
                                   make_train_step)
    from repro_torch.train.trainer import _state, loss_and_grads

    t_phase = time.perf_counter()
    out = {"phase": 17}
    _build.reset_launches()
    sections = {}
    # (e)'s ranks start first and run beside (a), whose checks are
    # numerical: their start-up (~10 s a process) overlaps (a)'s work.
    tmp_e = tempfile.mkdtemp()
    ranks_e = mp.start_processes(lm_rank, args=(LM_POD_WORLD, tmp_e,
                                                str(dev)),
                                 nprocs=LM_POD_WORLD, join=False,
                                 start_method="spawn")

    # (a) Card against CPU at smoke width, fp32; the card's run twice.
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    parity = {}
    for name, opt, impl in LM_PARITY:
        over = {"optimizer": opt} if opt else {}
        if impl:
            over["moe_impl"] = impl
        cfg = dataclasses.replace(get_smoke_arch(name), **over)
        settings = TrainSettings(total_steps=LM_SMOKE_STEPS, warmup_steps=2)
        batches = _lm_batches(torch, cfg, LM_SMOKE_STEPS, LM_SMOKE_BATCH,
                              LM_SMOKE_SEQ, 0, cpu)
        label = f"{name}/{cfg.optimizer}/{cfg.moe_impl}"
        got, want = (loss_and_grads(
            cfg, settings, init_train_state(cfg, settings, device=d)[
                "params"], {k: v.to(d) for k, v in batches[0].items()})
            for d in (dev, cpu))
        loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        grad_err = max(
            float((g.cpu() - w).abs().max()) / max(float(w.abs().max()),
                                                   1e-30)
            for g, w in zip(tree_leaves(got[2]), tree_leaves(want[2])))
        del got, want
        s_dev, m_dev = _lm_run(torch, cfg, settings, batches, dev)
        s_again, m_again = _lm_run(torch, cfg, settings, batches, dev)
        _, m_cpu = _lm_run(torch, cfg, settings, batches, cpu)
        traj = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(m_dev, m_cpu))
        again = _lm_equal(torch, s_dev, s_again) and m_dev == m_again
        parity[label] = {"step1_loss_rel": loss_rel,
                         "grad_err_over_leaf_max": grad_err,
                         "trajectory_rel": traj,
                         "card_runs_bitwise": again,
                         "loss_first_last": [m_dev[0]["loss"],
                                             m_dev[-1]["loss"]]}
        check(loss_rel <= LM_LOSS_TOL, f"(a) {label}: step-1 loss differs "
              f"from the CPU's by {loss_rel:.3e} (bar {LM_LOSS_TOL})")
        check(grad_err <= TOL, f"(a) {label}: gradients differ from the "
              f"CPU's by {grad_err:.3e} of a leaf's max (bar {TOL})")
        check(traj <= TRAJ_TOL, f"(a) {label}: {LM_SMOKE_STEPS}-step loss "
              f"trajectory differs from the CPU's by {traj:.3e} (bar "
              f"{TRAJ_TOL})")
        check(again, f"(a) {label}: two runs on the card differ")
        del s_dev, s_again
    out["a_card_vs_cpu"] = parity
    print("phase 17 (a) card vs CPU, smoke widths, fp32: " + json.dumps(
        parity), flush=True)
    sections["a"] = time.perf_counter() - t0

    # (e) The pod form on gloo ranks sharing the card: their reports.
    t0 = time.perf_counter()
    while not ranks_e.join():
        pass
    ranks = [torch.load(f"{tmp_e}/lm-r{r}.pt", weights_only=False)
             for r in range(LM_POD_WORLD)]
    shutil.rmtree(tmp_e)
    want = [{"all_gather": 2 if (s + 1) % LM_POD_INTERVAL == 0 else 1}
            for s in range(LM_POD_STEPS)]
    for r in ranks:
        check(all(r["equal"]), f"(e) rank pod {r['pod']}: pod form differs "
              f"from the stacked form at steps {r['equal']}")
        check(r["census"] == want, f"(e) census {r['census']}")
        check(not any(r["launches"].values()),
              f"(e) kernels launched in a rank: {r['launches']}")
    out["e_pod_form"] = {"world": LM_POD_WORLD, "equal": True,
                         "census": want}
    sections["e (after a)"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    # The backward ops that gather or scatter, at the main path's shapes:
    # each gradient three times, bit for bit.
    cfg = get_arch(LM_TRAIN_ARCH)
    g = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                           generator=g, device=dev)
    table = torch.randn(cfg.vocab_size, cfg.d_model, generator=g,
                        device=dev)
    up = torch.randn(LM_BATCH, LM_SEQ, cfg.d_model, generator=g, device=dev)
    logits = torch.randn(LM_BATCH, LM_SEQ, cfg.vocab_size, generator=g,
                         device=dev)

    def embed_grad():
        from repro_torch.nn import take_rows
        t = table.detach().requires_grad_(True)
        return torch.autograd.grad(
            (take_rows(t, tokens.long()) * up).sum(), t)[0]

    def ce_grad():
        from repro_torch.nn import softmax_cross_entropy
        lg = logits.detach().requires_grad_(True)
        return torch.autograd.grad(softmax_cross_entropy(lg, tokens), lg)[0]

    determinism = {}
    for op, fn in (("embedding gather backward (nn.take_rows: index_put_ "
                    "accumulate on CUDA)", embed_grad),
                   ("cross-entropy gather backward (scatter_add_)", ce_grad)):
        runs = [fn() for _ in range(3)]
        determinism[op] = {
            "bitwise": all(torch.equal(runs[0], r) for r in runs[1:]),
            "ms": event_ms(torch, fn, reps=5, warmup=1)}
        del runs
        check(determinism[op]["bitwise"], f"(a) {op} differs run to run")
    del table, up, logits
    out["a_determinism"] = determinism
    print("phase 17 (a) backward ops at the main path's shapes, three runs "
          "each: " + json.dumps(determinism), flush=True)
    sections["a, gather backward ops"] = time.perf_counter() - t0

    # (b) The main path at full width through the launcher.
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # The phase's launches so far; the main path's own from 0.
    before_b = dict(_build.LAUNCHES)
    _build.reset_launches()
    res = launch_train.main([
        "--arch", LM_TRAIN_ARCH, "--steps", str(LM_TRAIN_STEPS), "--batch",
        str(LM_BATCH), "--seq", str(LM_SEQ), "--log-every", "5",
        "--device", str(dev)])
    out["main_path_launches"] = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(not any(out["main_path_launches"].values()), f"(b) kernels "
          f"launched in LM training: {out['main_path_launches']}")
    losses = res["losses"]
    # Each step from the end of the one before, the batch's draw
    # included: steps 2-20 sum to their window's wall time.
    step_ms = [s * 1e3 for s in res["step_s"]]
    med = statistics.median(step_ms[1:])
    tokens_per_s = (LM_BATCH * LM_SEQ * (LM_TRAIN_STEPS - 1)
                    / (sum(step_ms[1:]) / 1e3))
    check(all(math.isfinite(x) for x in losses), f"(b) losses {losses}")
    check(statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
          f"(b) the loss did not fall: {losses}")
    cfg = get_arch(LM_TRAIN_ARCH)
    out["b_main_path"] = {
        "arch": cfg.name, "params": res["params"], "layers": cfg.num_layers,
        "batch": LM_BATCH, "seq": LM_SEQ, "steps": LM_TRAIN_STEPS,
        "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
        "attn_backend": cfg.attn_backend, "remat": cfg.remat,
        "optimizer": cfg.optimizer, "step_ms": step_ms,
        "step_ms_median_2_on": med,
        "tokens_per_s_2_on": tokens_per_s,
        "tokens_per_s_all_steps": (LM_BATCH * LM_SEQ * LM_TRAIN_STEPS
                                   / (sum(step_ms) / 1e3)),
        "peak_memory_bytes": peak, "losses_first5": losses[:5],
        "losses_last5": losses[-5:]}
    # One more step traced: its device time, busy share and top ops.
    settings = TrainSettings(total_steps=LM_TRAIN_STEPS,
                             warmup_steps=max(LM_TRAIN_STEPS // 20, 2))
    step = make_train_step(cfg, settings)
    batch = _lm_batches(torch, cfg, 1, LM_BATCH, LM_SEQ, 5, dev)[0]
    state = res.pop("state")
    trained = state["params"]
    del res
    prof = profile_serve_loop(lambda s, b: step(s, b), [batch], carry=state,
                              top=1000)
    del state
    by_class = collections.Counter()
    for e in prof["top"]:
        by_class[op_class(e["op"])] += e["device_ms"]
    prof["top"] = prof["top"][:10]
    out["b_main_path"]["trace"] = {
        "wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
        "busy_share": prof["busy_share"],
        "device_over_untraced_step": prof["device_ms"] / med,
        "device_ms_by_class": dict(by_class.most_common()),
        "top": prof["top"]}
    print(f"phase 17 (b) {cfg.name} training at full width ({smi}): "
          + json.dumps(out["b_main_path"]), flush=True)
    print(f"phase 17 (b): step {med:.2f} ms (median of steps 2-"
          f"{LM_TRAIN_STEPS}, data included), {tokens_per_s:.0f} tokens/s "
          f"(steps 2-{LM_TRAIN_STEPS}' tokens over their wall time), peak {peak / 1e9:.2f} GB; traced step "
          f"{prof['device_ms']:.2f} ms of device time, busy "
          f"{100 * prof['busy_share']:.1f}% of the traced wall, "
          f"{100 * prof['device_ms'] / med:.1f}% of the untraced step; by "
          f"class {dict(by_class.most_common())}; top {top_ops(prof)}",
          flush=True)
    sections["b"] = time.perf_counter() - t0

    # (c) Pod sync at full width: the stacked form, 2 pods.
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    settings = TrainSettings(sync_mode="digest", n_pod=2,
                             sync_interval=LM_POD_INTERVAL,
                             total_steps=LM_POD_STEPS, warmup_steps=2)
    batches = _lm_batches(torch, cfg, LM_POD_STEPS, LM_BATCH, LM_SEQ, 6, dev)
    # Two equal copies of (b)'s trained parameters and a fresh optimizer
    # state, as init_train_state stacks its draw: (c) needs full-width
    # parameters, and the host's draw takes seconds.
    state = _state(cfg, settings, trained)
    del trained
    step = make_train_step(cfg, settings)
    div, pod_ms = [], []
    for b in batches:
        t = time.perf_counter()
        state, m = step(state, b)
        div.append(float(m["pod_divergence"]))
        pod_ms.append((time.perf_counter() - t) * 1e3)
    del state
    synced = [div[s - 1] for s in range(LM_POD_INTERVAL, LM_POD_STEPS + 1,
                                        LM_POD_INTERVAL)]
    check(all(d == 0.0 for d in synced) and div[1] > 0.0 and div[5] > 0.0,
          f"(c) pod divergence {div}")
    out["c_pod_sync"] = {"n_pod": 2, "interval": LM_POD_INTERVAL,
                         "pod_divergence": div, "step_ms": pod_ms}
    print("phase 17 (c) pod sync at full width: " + json.dumps(
        out["c_pod_sync"]), flush=True)
    sections["c"] = time.perf_counter() - t0

    # (d) Resume at smoke width, bit for bit.
    t0 = time.perf_counter()
    cfg = get_smoke_arch(LM_TRAIN_ARCH)
    settings = TrainSettings(total_steps=LM_SMOKE_STEPS, warmup_steps=2)
    batches = _lm_batches(torch, cfg, 5, LM_SMOKE_BATCH, LM_SMOKE_SEQ, 1,
                          dev)
    whole, _ = _lm_run(torch, cfg, settings, batches, dev)
    part, _ = _lm_run(torch, cfg, settings, batches[:3], dev)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, 3, part)
        template = init_train_state(cfg, settings, seed=9, device=dev)
        part, start = restore_checkpoint(tmp, template)
    resumed, _ = _lm_run(torch, cfg, settings, batches[3:], dev, part)
    check(start == 3 and _lm_equal(torch, resumed, whole),
          "(d) resumed run differs from the unbroken one")
    out["d_resume_bitwise"] = True
    sections["d"] = time.perf_counter() - t0

    out["launches"] = {k: before_b.get(k, 0) + v
                       for k, v in _build.LAUNCHES.items()}
    check(not any(out["launches"].values()),
          f"phase 17 launched kernels: {out['launches']}")
    out["sections_s"] = sections
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 17 (d) resume bit for bit; (e) {LM_POD_WORLD} gloo ranks "
          f"on the card: pod form == stacked form bit for bit, census "
          f"{out['e_pod_form']['census']}; sections (s) "
          + json.dumps(sections)
          + f"; kernels launched {out['launches']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 18: the last three architectures (recurrentgemma, xLSTM, the VLM)
# ---------------------------------------------------------------------------

def open_gates(params):
    """Every ``xattn`` gate set to XATTN_GATE, in place."""
    for block in [*params["pattern"], *params["tail"]]:
        if "gate" in block:
            block["gate"].fill_(XATTN_GATE)
    return params


def scale_rel(got, want) -> float:
    """max |got - want| over max |want| (on the CPU)."""
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def ulp_sensitivity(torch, fwd, params, ref) -> float:
    """The model's own fp32 rounding sensitivity: the largest change of
    ``fwd()``'s logits, over max |``ref``|, when the embeddings, and then
    every parameter, move by one ulp (the fp32 bit pattern plus one, in
    place, and back after the call)."""
    scale = float(ref.abs().max())
    worst = 0.0
    for leaves in ([params["embed"]], _tree_leaves(params)):
        for t in leaves:
            t.view(torch.int32).add_(1)
        try:
            moved = fwd()
        finally:
            for t in leaves:
                t.view(torch.int32).sub_(1)
        worst = max(worst, float((moved - ref).abs().max()) / scale)
    return worst


def has_attention(cfg) -> bool:
    return any(k in ("attn", "moe") for k in (*cfg.pattern, *cfg.tail))


def new_archs_smoke(torch, dev) -> dict:
    """Phase 18 (a): each new family's SMOKE config on the card against the
    CPU, fp32, the same parameters (CPU generator, seed 0, gates open):
    prefill logits, NEW_SMOKE_STEPS teacher-forced decode steps (logits
    and every cache state after every step), decode against prefill,
    ``long`` against full bit for bit where no attention block is, and
    one train step's loss and gradients."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.launch.serve import long_config
    from repro_torch.models.transformer import (arch_specs, decode_step,
                                                forward, init_cache,
                                                precompute_vision_cache)
    from repro_torch.nn import init_params
    from repro_torch.optim import tree_leaves
    from repro_torch.train import TrainSettings, make_train_step
    from repro_torch.train.trainer import _state, loss_and_grads

    cpu = torch.device("cpu")
    b, s = NEW_SMOKE_BATCH, NEW_SMOKE_STEPS
    out = {}
    for name in NEW_ARCHS:
        t_fam = time.perf_counter()
        cfg = get_smoke_arch(name)
        host = open_gates(init_params(arch_specs(cfg),
                                      torch.Generator().manual_seed(0), cpu))
        on = {cpu: host, dev: _dev_tree(torch, host, dev)}
        tokens = torch.randint(0, cfg.vocab_size, (b, s + 1),
                               generator=torch.Generator().manual_seed(1))
        vis = None
        if cfg.vision_dim:
            vis = torch.randn((b, cfg.num_patches, cfg.vision_dim),
                              generator=torch.Generator().manual_seed(2))

        def at(d, t):
            return None if t is None else t.to(d)

        res = {}
        with torch.inference_mode():
            pre = {d: forward(cfg, on[d], tokens[:, :s].to(d), at(d, vis))
                   for d in (dev, cpu)}
            res["prefill_rel"] = scale_rel(pre[dev], pre[cpu])
            caches = {}
            for d in (dev, cpu):
                caches[d] = init_cache(cfg, b, s, device=d)
                if vis is not None:
                    precompute_vision_cache(cfg, on[d], caches[d], vis.to(d))
            step_rel = state_rel = 0.0
            steps = []
            for t in range(s):
                lg = {}
                for d in (dev, cpu):
                    lg[d], caches[d] = decode_step(cfg, on[d], caches[d],
                                                   tokens[:, t:t + 1].to(d))
                steps.append(lg[dev])
                step_rel = max(step_rel, scale_rel(lg[dev], lg[cpu]))
                state_rel = max(state_rel, max(
                    scale_rel(g, w) for g, w in zip(_tree_leaves(caches[dev]),
                                                    _tree_leaves(caches[cpu]))))
            res.update(decode_step_rel=step_rel, state_rel=state_rel,
                       decode_vs_prefill_rel=scale_rel(torch.cat(steps, 1),
                                                       pre[dev]))
            if not has_attention(cfg):
                lc = long_config(cfg)
                cf = init_cache(lc, b, s, device=dev)
                cl = init_cache(lc, b, s, long=True, device=dev)
                same = True
                for t in range(s):
                    tok = tokens[:, t:t + 1].to(dev)
                    lf, cf = decode_step(lc, on[dev], cf, tok)
                    ll, cl = decode_step(lc, on[dev], cl, tok, long=True)
                    same = same and torch.equal(lf, ll)
                res["long_equals_full"] = same and all(
                    torch.equal(x, y) for x, y in zip(_tree_leaves(cf),
                                                      _tree_leaves(cl)))
        settings = TrainSettings(total_steps=10, warmup_steps=2)
        batch = {"tokens": tokens[:, :s], "labels": tokens[:, 1:],
                 "mask": torch.ones((b, s))}
        if vis is not None:
            batch["vision"] = vis
        got, want = (loss_and_grads(cfg, settings, on[d],
                                    {k: v.to(d) for k, v in batch.items()})
                     for d in (dev, cpu))
        res["loss_rel"] = abs(float(got[0]) - float(want[0])) / abs(
            float(want[0]))
        res["grad_err_over_leaf_max"] = max(
            scale_rel(g, w) for g, w in zip(tree_leaves(got[2]),
                                            tree_leaves(want[2])))
        _, metrics = make_train_step(cfg, settings)(
            _state(cfg, settings, on[dev]),
            {k: v.to(dev) for k, v in batch.items()})
        res["train_step_loss"] = float(metrics["loss"])
        res["train_step_loss_rel"] = abs(res["train_step_loss"]
                                         - float(got[0])) / abs(float(got[0]))
        del got, want, on, host, caches, pre
        res["seconds"] = time.perf_counter() - t_fam
        out[name] = res
        check(res["prefill_rel"] <= TOL, f"(a) {name}: card prefill differs "
              f"from the CPU's by {res['prefill_rel']:.3e} (bar {TOL})")
        check(step_rel <= TOL, f"(a) {name}: card decode logits differ from "
              f"the CPU's by {step_rel:.3e} (bar {TOL})")
        check(state_rel <= TOL, f"(a) {name}: card decode states differ "
              f"from the CPU's by {state_rel:.3e} of a leaf's max (bar "
              f"{TOL})")
        check(res["decode_vs_prefill_rel"] < DECODE_TOL,
              f"(a) {name}: teacher-forced decode differs from the prefill "
              f"by {res['decode_vs_prefill_rel']:.3e} (bar {DECODE_TOL})")
        check(res.get("long_equals_full", True),
              f"(a) {name}: long decode differs from full decode")
        check(res["loss_rel"] <= LM_LOSS_TOL, f"(a) {name}: card loss "
              f"differs from the CPU's by {res['loss_rel']:.3e} (bar "
              f"{LM_LOSS_TOL})")
        check(res["grad_err_over_leaf_max"] <= TOL, f"(a) {name}: card "
              f"gradients differ from the CPU's by "
              f"{res['grad_err_over_leaf_max']:.3e} of a leaf's max (bar "
              f"{TOL})")
        check(math.isfinite(res["train_step_loss"])
              and res["train_step_loss_rel"] <= LM_LOSS_TOL,
              f"(a) {name}: the train step's loss {res['train_step_loss']} "
              f"differs from loss_and_grads' by "
              f"{res['train_step_loss_rel']:.3e} (bar {LM_LOSS_TOL})")
    print("phase 18 (a) card vs CPU, smoke widths, fp32: " + json.dumps(out),
          flush=True)
    return out


def device_trace(torch, fn, top: int = 6) -> dict:
    """One call of ``fn`` traced by ``profile_serve_loop``: its split, the
    device ops' count, their device ms by op class, K6's ms and records,
    and the ``top`` ops by device time."""
    from repro_torch.launch.serving_driver import profile_serve_loop

    def step(carry, _):
        fn()
        torch.cuda.synchronize()
        return carry, None

    prof = profile_serve_loop(step, range(1), top=None)
    classes = collections.Counter()
    for e in prof["top"]:
        classes[op_class(e["op"])] += e["device_ms"]
    k6 = [e for e in prof["top"] if "flash_attention" in e["op"]]
    prof.update(launches=sum(e["calls"] for e in prof["top"]),
                device_ms_by_class=dict(classes),
                k6_device_ms=sum(e["device_ms"] for e in k6),
                k6_calls=sum(e["calls"] for e in k6), top=prof["top"][:top])
    return prof


def block_wall_ms(torch, run) -> dict:
    """Wall ms by block kind over one call of ``run``, each block between
    two synchronisations (the model's block table wrapped for the call)."""
    from repro_torch.models import transformer as tm
    saved = dict(tm._FWD)
    wall = collections.Counter()

    def timed(kind, fn):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            wall[kind] += (time.perf_counter() - t) * 1e3
            return out
        return call

    tm._FWD.update({k: timed(k, f) for k, f in saved.items()})
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
    finally:
        tm._FWD.clear()
        tm._FWD.update(saved)
    return {"total_ms": total, "by_kind_ms": dict(wall),
            "share": {k: v / total for k, v in wall.items()}}


def new_arch_full(torch, dev, name, smi) -> dict:
    """Phase 18 (b)-(d): one new architecture at its published widths and
    depth, weights drawn on the card (a CUDA ``torch.Generator``, seed 0;
    ``xattn`` gates open): prefill times, the blocks' wall shares, a
    traced prefill, peak memory, served decode, teacher-forced decode
    against the prefill in fp32 (held) and bf16 (printed); for the VLM,
    K6 against the chunked oracle in bf16 and the dense one in fp32."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import (arch_specs, decode_step,
                                                forward, init_cache,
                                                precompute_vision_cache)
    from repro_torch.nn import init_params, param_bytes, param_count

    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(name)
    vlm = bool(cfg.vision_dim)
    if vlm:
        cfg = dataclasses.replace(cfg, attn_backend="kernel")
    n_k6 = sum(cfg.repeats * (k in ("attn", "moe")) for k in cfg.pattern) \
        + sum(k in ("attn", "moe") for k in cfg.tail)
    specs = arch_specs(cfg)
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "params": param_count(specs), "param_bytes": param_bytes(specs)}
    t0 = time.perf_counter()
    params = open_gates(init_params(
        specs, torch.Generator(device=dev).manual_seed(0), dev))
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    print(f"phase 18: {cfg.name} at its published widths, "
          f"{cfg.num_layers} layers {cfg.pattern} x {cfg.repeats} + "
          f"{cfg.tail}, d_model {cfg.d_model}, vocab {cfg.vocab_size}: "
          f"{out['params']} params, {out['param_bytes'] / 1e9:.2f} GB, drawn "
          f"in {out['init_s']:.2f} s", flush=True)
    gen = torch.Generator().manual_seed(1)
    shapes = [(LM_BATCH, LM_SEQ)]
    if "swa" in (*cfg.pattern, *cfg.tail):
        shapes.append((1, NEW_LONG_SEQ))
    tokens = {sh: torch.randint(0, cfg.vocab_size, sh, generator=gen).to(dev)
              for sh in shapes}
    vision = None
    if vlm:
        vision = torch.randn((LM_BATCH, cfg.num_patches, cfg.vision_dim),
                             generator=torch.Generator().manual_seed(2)
                             ).to(dev)

    def vis_of(b):
        return None if vision is None else vision[:b]

    def run(c, sh, label, p=params):
        torch.cuda.synchronize()
        before = dict(_build.LAUNCHES)
        t = time.perf_counter()
        logits = forward(c, p, tokens[sh], vis_of(sh[0]))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = {k: _build.LAUNCHES[k] - before[k] for k in before}
        check(logits.shape == sh + (cfg.vocab_size,)
              and bool(torch.isfinite(logits).all()),
              f"{cfg.name} prefill [{label}]: logits malformed")
        want = n_k6 if c.attn_backend == "kernel" else 0
        check(launches["flash_attention"] == want
              and sum(launches.values()) == want,
              f"{cfg.name} prefill [{label}]: launches {launches}, "
              f"expected K6 {want} times and nothing else")
        return logits, ms, launches

    with torch.inference_mode():
        for sh in shapes:
            key = f"{sh[0]}x{sh[1]}"
            run(cfg, sh, f"warm-up {key}")
            times = []
            for _ in range(NEW_PREFILL_RUNS):
                logits, ms, launches = run(cfg, sh, f"bf16 {key}")
                times.append(ms)
            med = statistics.median(times)
            out[f"prefill_{key}"] = {
                "ms": times, "median_ms": med,
                "tokens_per_s": sh[0] * sh[1] / (med / 1e3)}
            print(f"phase 18 {cfg.name} bf16 prefill {key}: median "
                  f"{med:.2f} ms of {[round(t, 2) for t in times]}, "
                  f"{out[f'prefill_{key}']['tokens_per_s']:.0f} tokens/s",
                  flush=True)
            if sh == shapes[0]:
                out["launches"] = launches
                main_logits = logits
            del logits
        sh = shapes[0]
        out["blocks"] = block_wall_ms(
            torch, lambda: forward(cfg, params, tokens[sh], vis_of(sh[0])))
        print(f"phase 18 {cfg.name} prefill wall by block kind (each block "
              f"between two synchronisations): "
              f"{ {k: round(v, 2) for k, v in out['blocks']['by_kind_ms'].items()} } "
              f"ms of {out['blocks']['total_ms']:.2f}; shares "
              f"{ {k: round(v, 4) for k, v in out['blocks']['share'].items()} }",
              flush=True)
        prof = device_trace(
            torch, lambda: forward(cfg, params, tokens[sh], vis_of(sh[0])))
        out["prefill_profile"] = prof
        print(f"phase 18 {cfg.name} bf16 prefill traced: device "
              f"{prof['device_ms']:.2f} ms of {prof['wall_ms']:.2f} wall, "
              f"busy {100 * prof['busy_share']:.1f}%, {prof['launches']} "
              f"device ops, K6 {prof['k6_device_ms']:.3f} ms "
              f"({prof['k6_calls']} records); by class "
              f"{ {k: round(v, 2) for k, v in prof['device_ms_by_class'].items()} }; "
              f"top {top_ops(prof)}", flush=True)

        if vlm:
            # K6 in bf16 against the chunked oracle, at twice the
            # oracle's one-ulp sensitivity; in fp32 against the dense one.
            ch = dataclasses.replace(cfg, attn_backend="chunked")
            oracle, out["chunked_prefill_ms"], _ = run(ch, sh, "bf16 chunked")
            scale = float(oracle.abs().max())
            bf16_rel = float((main_logits - oracle).abs().max()) / scale
            emb = params["embed"].to(torch.bfloat16)
            bumped = (emb.view(torch.int16) + 1).view(torch.bfloat16).float()
            del emb
            moved, _, _ = run(ch, sh, "bf16 chunked, embeddings + 1 ulp",
                              dict(params, embed=bumped))
            del bumped
            sens = float((moved - oracle).abs().max()) / scale
            del moved, oracle
            out.update(bf16_rel_err_vs_chunked=bf16_rel,
                       bf16_oracle_ulp_sensitivity=sens,
                       bf16_err_over_sensitivity=bf16_rel / max(sens, 1e-30))
            print(f"phase 18 {cfg.name} bf16 prefill: K6 path vs chunked "
                  f"oracle {bf16_rel:.4e} of max |logit|; the oracle's "
                  f"one-ulp sensitivity {sens:.4e}; ratio "
                  f"{out['bf16_err_over_sensitivity']:.3f} (bar "
                  f"{LM_BF16_SENS_FACTOR})", flush=True)
            check(bf16_rel <= LM_BF16_SENS_FACTOR * sens,
                  f"{cfg.name} bf16 prefill through K6 differs from the "
                  f"chunked oracle by {bf16_rel:.3e} of max |logit|, more "
                  f"than {LM_BF16_SENS_FACTOR} x its one-ulp sensitivity "
                  f"{sens:.3e}")
            c32 = dataclasses.replace(cfg, dtype="float32")
            l32, out["fp32_prefill_ms"], out["fp32_launches"] = run(
                c32, sh, "fp32 kernel")
            d32, out["fp32_dense_prefill_ms"], _ = run(
                dataclasses.replace(c32, attn_backend="dense"), sh,
                "fp32 dense")
            out["fp32_rel_err_vs_dense"] = scale_rel(l32, d32)
            del l32, d32
            print(f"phase 18 {cfg.name} fp32 prefill: K6 path vs dense "
                  f"oracle {out['fp32_rel_err_vs_dense']:.4e} of max "
                  f"|logit| (bar {LM_FP32_TOL}); {out['fp32_prefill_ms']:.2f} "
                  f"ms, dense {out['fp32_dense_prefill_ms']:.2f}", flush=True)
            check(out["fp32_rel_err_vs_dense"] <= LM_FP32_TOL,
                  f"{cfg.name} fp32 prefill through K6 differs from the "
                  f"dense oracle by {out['fp32_rel_err_vs_dense']:.3e} "
                  f"(bar {LM_FP32_TOL})")
        del main_logits

    out["prefill_section_s"] = time.perf_counter() - t_model
    # Served decode (a VLM's cache filled by precompute_vision_cache).
    stats, outs, _ = serve(cfg, params, LM_BATCH, LM_MAX_SEQ, LM_GEN,
                           device=dev)
    check(all(o.shape == (LM_BATCH, 1, cfg.vocab_size)
              and bool(torch.isfinite(o).all()) for o in outs),
          f"{cfg.name} serve: logits malformed")
    del outs
    out["decode"] = {"ms_per_token": stats.total_s / LM_GEN * 1e3,
                     "p50_ms": stats.p50_ms, "p99_ms": stats.p99_ms,
                     "tokens_per_s": stats.per_sec}
    with torch.inference_mode():
        cache = init_cache(cfg, LM_BATCH, LM_MAX_SEQ, device=dev)
        if vlm:
            precompute_vision_cache(cfg, params, cache, vision)
        toks = tokens[shapes[0]]

        def steps():
            c = cache
            for t in range(NEW_TRACED):
                _, c = decode_step(cfg, params, c, toks[:, t:t + 1])

        steps()
        dprof = device_trace(torch, steps)
        del cache
    out["decode"]["profile"] = dprof
    print(f"phase 18 {cfg.name} serve batch {LM_BATCH}: "
          f"{out['decode']['ms_per_token']:.3f} ms/token (steady p50 "
          f"{stats.p50_ms:.3f} / p99 {stats.p99_ms:.3f} ms); {NEW_TRACED} "
          f"steps traced: device {dprof['device_ms'] / NEW_TRACED:.2f} ms a "
          f"step, busy {100 * dprof['busy_share']:.1f}%, "
          f"{dprof['launches'] // NEW_TRACED} device ops a step; by class "
          f"{ {k: round(v / NEW_TRACED, 2) for k, v in dprof['device_ms_by_class'].items()} }"
          f"; top {top_ops(dprof)}", flush=True)

    out["through_serve_s"] = time.perf_counter() - t_model
    # Teacher forcing at batch 1 against the prefill of the same tokens,
    # each dtype held at the reference's decode bar, or at twice the
    # prefill's own one-ulp sensitivity where that is larger (a deep
    # xLSTM's normaliser amplifies rounding: PERF.md section 6): in fp32
    # the embeddings and then every parameter one fp32 ulp up, in bf16
    # every input embedding one bf16 ulp up (phase 9's rule).
    toks = tokens[shapes[0]][:1, :NEW_TEACHER]
    with torch.inference_mode():
        for key, c in (("fp32", dataclasses.replace(cfg, dtype="float32")),
                       ("bf16", cfg)):
            ref = forward(c, params, toks, vis_of(1))
            if key == "fp32":
                out["fp32_ulp_sensitivity"] = ulp_sensitivity(
                    torch, lambda: forward(c, params, toks, vis_of(1)),
                    params, ref)
            else:
                emb = params["embed"].to(torch.bfloat16)
                bumped = (emb.view(torch.int16) + 1).view(
                    torch.bfloat16).float()
                del emb
                out["bf16_ulp_sensitivity"] = scale_rel(
                    forward(c, dict(params, embed=bumped), toks, vis_of(1)),
                    ref)
                del bumped
            cache = init_cache(c, 1, NEW_TEACHER, device=dev)
            if vlm:
                precompute_vision_cache(c, params, cache, vis_of(1))
            steps = []
            for t in range(NEW_TEACHER):
                lg, cache = decode_step(c, params, cache, toks[:, t:t + 1])
                steps.append(lg)
            rel = scale_rel(torch.cat(steps, dim=1), ref)
            out[f"decode_vs_prefill_rel_err_{key}"] = rel
            out[f"decode_vs_prefill_bar_ratio_{key}"] = rel / DECODE_TOL
            del cache, steps, ref
    for key in ("fp32", "bf16"):
        sens = out[f"{key}_ulp_sensitivity"]
        bar = max(DECODE_TOL, LM_BF16_SENS_FACTOR * sens)
        out[f"decode_{key}_bar"] = bar
        err = out[f"decode_vs_prefill_rel_err_{key}"]
        print(f"phase 18 {cfg.name} teacher-forced {key} decode vs "
              f"prefill: {err:.4e} of max |logit| "
              f"({out[f'decode_vs_prefill_bar_ratio_{key}']:.3f} of "
              f"{DECODE_TOL}; the {key} prefill's one-ulp sensitivity "
              f"{sens:.4e}, bar {bar:.4e})", flush=True)
        check(err < bar, f"{cfg.name} teacher-forced {key} decode differs "
              f"from the prefill by {err:.3e} (bar {bar:.3e})")
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t_model
    del params, tokens, vision
    return out


def last_archs(torch, dev, smi) -> dict:
    """Phase 18: (a), then (b)-(d) one model at a time, each freed before
    the next.  No kernel but K6 (the VLM's attention) may launch."""
    from repro_torch.kernels import _build
    t_phase = time.perf_counter()
    _build.reset_launches()
    out = {"phase": 18}
    t0 = time.perf_counter()
    out["a_card_vs_cpu"] = new_archs_smoke(torch, dev)
    out["a_seconds"] = time.perf_counter() - t0
    for name in NEW_ARCHS:
        res = new_arch_full(torch, dev, name, smi)
        gc_cuda(torch)
        out[name] = res
        print(f"phase 18 {name} ({smi}): " + json.dumps(res), flush=True)
    others = {k: v for k, v in _build.LAUNCHES.items()
              if k != "flash_attention" and v}
    check(not others, f"phase 18 launched kernels besides K6: {others}")
    vlm = out["llama-3.2-vision-11b"]
    out["launches"] = vlm["launches"]
    out["fp32_launches"] = vlm["fp32_launches"]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 18: {out['seconds']:.1f} s ((a) {out['a_seconds']:.1f} s; "
          + ", ".join(f"{n} {out[n]['seconds']:.1f} s" for n in NEW_ARCHS)
          + ")", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 19: the mesh forms (expert-parallel MoE, data-parallel training)
# ---------------------------------------------------------------------------

def mesh_rank(rank: int, world: int, tmp: str, job: str) -> None:
    """One gloo rank of phase 19's (a), (b) or (c), all ranks sharing card
    0.  It joins its group at once, then waits for the go file the
    parent writes when the card has room for the job; writes its report
    to ``tmp``.  A failed check exits the rank non-zero, which fails the
    script."""
    # Ranks sharing the card grow and free large buffers in turns: the
    # allocator maps memory in segments it can grow, so a freed block is
    # not left stranded between two live ones.
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store-{job}",
                            world_size=world, rank=rank)
    try:
        while not Path(f"{tmp}/go-{job}").exists():
            time.sleep(0.05)
        out = MESH_JOBS[job](torch, dev, rank, world, tmp)
        torch.save(out, f"{tmp}/{job}-r{rank}.pt")
    finally:
        dist.destroy_process_group()


def gather_meter() -> dict:
    """Make ``collectives.all_gather`` (and ``all_to_all_single``, the FSDP
    backward's reduce-scatter) also add, to the returned dict, the bytes
    this rank receives (the other ranks' tensors) and the milliseconds it
    takes (synchronised on both sides); the caller zeroes it before a
    run.  A second call returns the first one's dict."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import collectives
    if hasattr(collectives.all_gather, "meter"):
        return collectives.all_gather.meter
    meter = {"bytes": 0, "ms": 0.0}
    gather, to_all = collectives.all_gather, collectives.all_to_all_single

    def timed(fn, *args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        meter["ms"] += (time.perf_counter() - t) * 1e3
        return out

    def metered(tensor, group=None):
        outs = timed(gather, tensor, group)
        meter["bytes"] += (len(outs) - 1) * tensor.numel() * \
            tensor.element_size()
        return outs

    def metered_to_all(output, input, group=None):
        timed(to_all, output, input, group)
        n = dist.get_world_size(group)
        meter["bytes"] += (n - 1) * output.numel() // n * \
            output.element_size()
        return output

    metered.meter = meter
    collectives.all_gather = metered
    collectives.all_to_all_single = metered_to_all
    return meter


def record_moe_outputs() -> list:
    """Make the transformer's MoE FFN (``models.transformer.moe_ffn``)
    also append each call's output to the returned list; the caller
    clears it before a run.  A second call returns the first one's
    list."""
    from repro_torch.models import transformer
    if hasattr(transformer.moe_ffn, "log"):
        return transformer.moe_ffn.log
    log = []
    inner = transformer.moe_ffn

    def recorded(*args, **kw):
        out = inner(*args, **kw)
        log.append(out)
        return out

    recorded.log = log
    transformer.moe_ffn = recorded
    return log


def dev_rel(got, want) -> float:
    """max |got - want| over max |want|, on the tensors' device."""
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def leaf_names(tree, prefix: str = "") -> list:
    """Each leaf's path ("pattern/0/wq"), in the trainer's pytree order
    (sorted dict keys, list positions)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def leaf_err(torch, want, got) -> float:
    """The largest max |got - want| of a leaf over the leaf's max |want|
    (two trees of equal structure)."""
    from repro_torch.optim import tree_leaves
    return max(dev_rel(g, w) for w, g in zip(tree_leaves(want),
                                             tree_leaves(got)))


def params_diff(torch, want, got) -> dict:
    """Two parameter trees after an optimizer step: the largest absolute
    difference, and the largest of a leaf over its max |want| with that
    leaf's index and max.  Printed, not held: Adam's first step moves an
    element by lr·g/(|g| + eps), so an element whose summands cancel to
    within a few eps moves by a visible share of lr when the sums'
    rounding changes; the gradients and the loss trajectory carry the
    bars."""
    from repro_torch.optim import tree_leaves
    rows = [(float((g.float() - w.float()).abs().max()),
             float(w.float().abs().max()))
            for w, g in zip(tree_leaves(want), tree_leaves(got))]
    rel = [a / max(m, 1e-30) for a, m in rows]
    worst = max(range(len(rel)), key=rel.__getitem__)
    return {"abs": max(a for a, _ in rows), "rel": rel[worst],
            "rel_leaf": worst, "rel_leaf_max": rows[worst][1]}


def mesh_smoke_job(torch, dev, rank, world, tmp) -> dict:
    """Phase 19 (a), one of MESH_SMOKE_WORLD ranks: moe_ep over meshes and
    the trainer's (pod 2, data 2) form at the SMOKE widths."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.core import collectives
    from repro_torch.distributed import TRAIN_RULES, gather_whole
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.transformer import arch_specs
    from repro_torch.nn import init_params
    from repro_torch.optim import tree_leaves
    from repro_torch.train import (TrainSettings, init_train_state,
                                   make_train_step, trainer)

    cpu = torch.device("cpu")
    _build.reset_launches()
    meshes = {"data 2 x model 2": make_mesh(2, model=2),
              "data 1 x model 4": make_mesh(1, model=4)}
    out = {"moe": {}, "train": {}}
    for arch in (MOE_ARCH, "kimi-k2-1t-a32b"):
        cfg = get_smoke_arch(arch)
        block = init_params(arch_specs(cfg), torch.Generator().manual_seed(0),
                            cpu)["pattern"][0]
        p_cpu = {"router": block["router"][0], "w_gate": block["w_gate_e"][0],
                 "w_up": block["w_up_e"][0], "w_down": block["w_down_e"][0]}
        p_dev = {key: v.to(dev) for key, v in p_cpu.items()}
        x_all = torch.randn(LM_SMOKE_BATCH, MESH_MOE_SEQ, cfg.d_model,
                            generator=torch.Generator().manual_seed(2))
        k, cf = cfg.experts_per_token, cfg.moe_capacity_factor
        for label, b in (("data 2 x model 2", LM_SMOKE_BATCH),
                         ("data 1 x model 4", LM_SMOKE_BATCH),
                         ("data 2 x model 2", 1)):
            mesh, x = meshes[label], x_all[:b]
            collectives.reset_collectives()
            y = moe.moe_ep(x.to(dev), p_dev, k, capacity_factor=cf,
                           mesh=mesh)
            census = dict(collectives.COLLECTIVES)
            n = 2 if label.startswith("data 2") and b % 2 == 0 else 1
            single_cpu = torch.cat([moe.moe_ep(blk, p_cpu, k,
                                               capacity_factor=cf)
                                    for blk in x.chunk(n)])
            single = torch.cat([moe.moe_ep(blk.to(dev), p_dev, k,
                                           capacity_factor=cf)
                                for blk in x.chunk(n)])
            sharded = moe.moe_ep(x.to(dev), moe.shard_experts(p_dev, mesh),
                                 k, capacity_factor=cf, mesh=mesh)
            key = f"{arch} {label} B{b}"
            res = {"vs_cpu": scale_rel(y, single_cpu),
                   "vs_card_single": dev_rel(y, single),
                   "card_single_bitwise": torch.equal(y, single),
                   "sharded_bitwise": torch.equal(y, sharded),
                   "census": census, "blocks": n}
            check(res["vs_cpu"] <= TOL, f"(a) {key}: moe_ep over the mesh "
                  f"vs the CPU's single device {res['vs_cpu']:.3e}")
            check(res["vs_card_single"] <= MOE_EP_TOL
                  and dev_rel(sharded, y) <= MOE_EP_TOL,
                  f"(a) {key}: moe_ep over the mesh vs the card's single "
                  f"device {res['vs_card_single']:.3e}")
            check(census == {"all_gather": 1 + (n > 1)},
                  f"(a) {key}: census {census}")
            res["y"] = y.cpu()
            out["moe"][key] = res
    mesh = make_mesh(2, 2)
    pod = mesh.get_local_rank("pod")
    for arch in (LM_TRAIN_ARCH, MOE_ARCH):
        cfg = get_smoke_arch(arch)
        stacked = TrainSettings(sync_mode="digest", n_pod=2,
                                sync_interval=LM_POD_INTERVAL,
                                total_steps=LM_SMOKE_STEPS, warmup_steps=2)
        pods = dataclasses.replace(stacked, pod_impl="shard_map")
        batches = _lm_batches(torch, cfg, LM_POD_STEPS, LM_SMOKE_BATCH,
                              LM_SMOKE_SEQ, 3, dev)
        specs = arch_specs(cfg)
        sb = init_train_state(cfg, stacked, device=dev)
        # FSDP inside each pod (the trainer's rules): this rank's blocks.
        sc = init_train_state(cfg, pods, device=dev, mesh=mesh)
        # The step-1 gradient (the clip's input, gathered whole) against
        # the pod batch's.
        pod_batch = {key: trainer._pod_slice(v, pod, 2)
                     for key, v in batches[0].items()}
        want = trainer.loss_and_grads(cfg, pods, gather_whole(
            sc["params"], specs, mesh, TRAIN_RULES), pod_batch)[2]
        res = {"loss_rel": [], "params_err": [], "census": []}
        fb, fc = make_train_step(cfg, stacked), make_train_step(
            cfg, pods, mesh)
        grads = capture_grads()
        for i, b in enumerate(batches):
            sb, mb = fb(sb, b)
            grads.clear()
            collectives.reset_collectives()
            sc, mc = fc(sc, b)
            res["census"].append(dict(collectives.COLLECTIVES))
            if i == 0:
                res["grad_err"] = leaf_err(torch, want, gather_whole(
                    grads[0], specs, mesh, TRAIN_RULES))
                del want
            grads.clear()
            res["loss_rel"].append(max(
                abs(float(mc[key]) - float(mb[key]))
                / max(abs(float(mb[key])), 1e-30)
                for key in ("loss", "ce", "aux")))
            res["params_err"].append(params_diff(
                torch, [x[pod] for x in tree_leaves(sb["params"])],
                tree_leaves(gather_whole(sc["params"], specs, mesh,
                                         TRAIN_RULES))))
        aux = int(cfg.num_experts > 0)
        gathers, scatters = MESH_FSDP[arch]
        want_census = [{"all_reduce": 1, "all_to_all": scatters,
                        "all_gather": gathers + 2 + aux + (
                            (s + 1) % LM_POD_INTERVAL == 0)}
                       for s in range(LM_POD_STEPS)]
        if rank == 0:
            print(f"phase 19 (a) {arch} pod 2 x data 2 vs stacked, rank 0: "
                  + json.dumps(res), flush=True)
        check(res["grad_err"] <= TOL, f"(a) {arch} pod 2 x data 2: step-1 "
              f"gradient {res['grad_err']:.3e} of a leaf's max")
        check(max(res["loss_rel"]) <= TRAJ_TOL, f"(a) {arch} pod 2 x data "
              f"2: trajectory {res['loss_rel']}")
        check(res["census"] == want_census, f"(a) {arch} pod 2 x data 2: "
              f"census {res['census']}")
        res["checksum"] = [int(p.view(torch.int32).long().sum())
                           for p in tree_leaves(gather_whole(
                               sc["params"], specs, mesh, TRAIN_RULES))]
        out["train"][arch] = res
    out["pod"] = pod
    out["launches"] = dict(_build.LAUNCHES)
    return out


def ep_config():
    """Phase 19 (b)'s llama4-scout: published widths, MOE_LAYERS layers,
    K6 on its attention, the expert-parallel ``moe_ep``."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(MOE_ARCH), num_layers=MOE_LAYERS,
                               attn_backend="kernel", moe_impl="ep")


def ep_weights(torch, cfg, dev, mesh=None):
    """``init_params(arch_specs(cfg))`` from a CUDA generator (seed 0) on
    the card, drawn one leaf at a time in its order; with ``mesh`` each
    expert leaf keeps only this rank's rows as soon as it is drawn, so a
    rank never holds every expert."""
    from repro_torch.launch.mesh import dim_size
    from repro_torch.models.moe import expert_rows
    from repro_torch.models.transformer import arch_specs
    from repro_torch.nn import ParamSpec, init_params

    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(node, name=""):
        if isinstance(node, ParamSpec):
            t = init_params(node, gen, dev)
            if mesh is not None and name.endswith("_e"):
                t = expert_rows(t, cfg.num_experts,
                                mesh.get_local_rank("model"),
                                dim_size(mesh, "model"), len(t.shape) - 3)
            return t
        if isinstance(node, (list, tuple)):
            return [draw(v) for v in node]
        return {k: draw(node[k], k) for k in sorted(node)}

    return draw(arch_specs(cfg))


def ep_inputs(torch, cfg, dev) -> tuple:
    """Phase 16's tokens (CPU generator, seed 1), the seeded logit rows
    of a prefill and vocabulary ids of decode's logits."""
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                           generator=torch.Generator().manual_seed(1)
                           ).to(dev)
    g = torch.Generator().manual_seed(4)
    rows = torch.randperm(LM_BATCH * LM_SEQ, generator=g)[:MESH_LOGIT_ROWS]
    cols = torch.randperm(cfg.vocab_size, generator=g)[:MESH_LOGIT_ROWS]
    return tokens, rows.to(dev), cols.to(dev)


def ep_decode(torch, cfg, params, tokens, cols, mesh=None) -> dict:
    """MESH_DECODE teacher-forced decode steps at batch LM_BATCH: the
    logits at ``cols`` ((b, t) rows), the routes, the median ms a token
    (steps 2 on, synchronised), the census and the gathers."""
    from repro_torch.core import collectives
    from repro_torch.distributed import EXPERT_PARALLEL_RULES as EP_RULES
    from repro_torch.models.transformer import decode_step, init_cache
    routes, meter = record_routes(), gather_meter()
    cache = init_cache(cfg, LM_BATCH, MESH_DECODE, device=tokens.device)
    routes.clear()
    collectives.reset_collectives()
    meter.update(bytes=0, ms=0.0)
    steps, times = [], []
    for t in range(MESH_DECODE):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1],
                                mesh=mesh, rules=EP_RULES)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        steps.append(lg[:, 0, cols])
    out = {"logits": torch.stack(steps, 1).reshape(-1, len(cols)),
           "routes": decode_routes(routes, cfg.num_layers, LM_BATCH),
           "ms_per_token": statistics.median(times[1:]),
           "census": dict(collectives.COLLECTIVES),
           "gather_bytes": meter["bytes"], "gather_ms": meter["ms"]}
    routes.clear()
    return out


def ep_run(torch, cfg, params, tokens, rows, cols, mesh=None,
           warm: bool = True) -> dict:
    """Phase 19 (b)'s runs on one process or one rank: a warm-up bf16
    prefill, then one at each factor (MoE outputs, routes, the logits at
    ``rows``, ms, launches, census, gather bytes), and decode
    (:func:`ep_decode`) in bf16 and in fp32 activations."""
    from repro_torch.core import collectives
    from repro_torch.distributed import EXPERT_PARALLEL_RULES as EP_RULES
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import forward
    routes, moe_log = record_routes(), record_moe_outputs()
    meter = gather_meter()
    out = {}
    with torch.inference_mode():
        if warm:
            forward(cfg, params, tokens, mesh=mesh, rules=EP_RULES)
        for cf in (MOE_DROPLESS_CF, cfg.moe_capacity_factor):
            c = dataclasses.replace(cfg, moe_capacity_factor=cf)
            routes.clear()
            moe_log.clear()
            collectives.reset_collectives()
            meter.update(bytes=0, ms=0.0)
            torch.cuda.synchronize()
            _build.reset_launches()
            t = time.perf_counter()
            logits = forward(c, params, tokens, mesh=mesh, rules=EP_RULES)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            out[cf] = {
                "ms": ms, "launches": dict(_build.LAUNCHES),
                "census": dict(collectives.COLLECTIVES),
                "gather_bytes": meter["bytes"], "gather_ms": meter["ms"],
                "moe": [o.clone() for o in moe_log],
                "routes": [(i.clone(), lg.clone()) for i, lg in routes],
                "logits": logits.reshape(-1, cfg.vocab_size)[rows].clone()}
            check(bool(torch.isfinite(logits).all()),
                  f"(b) prefill at capacity {cf}: logits not finite")
            del logits
        routes.clear()
        moe_log.clear()
        out["decode"] = ep_decode(torch, cfg, params, tokens, cols, mesh)
        out["decode_fp32"] = ep_decode(
            torch, dataclasses.replace(cfg, dtype="float32"), params, tokens,
            cols, mesh)
    return out


def ep_sensitivity(torch, base: dict, moved: dict, cfs, rows) -> dict:
    """The single process's own bf16 rounding sensitivity: how far its
    MoE outputs and logits move when every input embedding moves one bf16
    ulp (``moved``), over the tokens no route flip between the two runs
    moved, relative to the largest value (phase 9's rule)."""
    out = {}
    for cf in cfs:
        d = route_diff(torch, moved[cf]["routes"], base[cf]["routes"],
                       LM_BATCH)
        out[cf] = {
            "moe": max(rows_rel_err(m, b, d["moved"])
                       for m, b in zip(moved[cf]["moe"], base[cf]["moe"])),
            "logits": rows_rel_err(moved[cf]["logits"], base[cf]["logits"],
                                   d["moved"][rows])}
    d = route_diff(torch, moved["decode"]["routes"], base["decode"]["routes"],
                   LM_BATCH)
    out["decode"] = rows_rel_err(moved["decode"]["logits"],
                                 base["decode"]["logits"], d["moved"])
    return out


def ep_compare(torch, cfg, got: dict, want: dict, rows) -> dict:
    """The mesh run against the single process, over the tokens no route
    tie moved (phase 16's rule): bit for bit, or the MoE blocks' outputs
    and the logit rows within MOE_EP_TOL of their max, in bf16 within
    LM_BF16_SENS_FACTOR times the single process's own one-ulp change
    where that is larger (a product's kernel may differ between 8 and 16
    experts, and one bf16 rounding of the hidden activation then moves);
    fp32 decode at MOE_EP_TOL."""
    sens = want["sens"]

    def to(x, like):
        return x.to(like.device)

    def diff(g_routes, w_routes):
        return route_diff(torch, g_routes, [tuple(to(x, g_routes[0][0])
                                                  for x in r)
                                            for r in w_routes], LM_BATCH)

    res = {}
    for cf in (MOE_DROPLESS_CF, cfg.moe_capacity_factor):
        g, w = got[cf], want[cf]
        d = diff(g["routes"], w["routes"])
        ties = d["ties"]
        res[cf] = {
            "bitwise": all(torch.equal(a, to(b, a)) for a, b in
                           zip(g["moe"] + [g["logits"]],
                               w["moe"] + [w["logits"]])),
            "moe_rel_err": max(rows_rel_err(a, to(b, a), ties)
                               for a, b in zip(g["moe"], w["moe"])),
            "logit_rel_err": rows_rel_err(g["logits"],
                                          to(w["logits"], g["logits"]),
                                          ties[rows]),
            "moe_bar": max(MOE_EP_TOL, LM_BF16_SENS_FACTOR * sens[cf]["moe"]),
            "logit_bar": max(MOE_EP_TOL,
                             LM_BF16_SENS_FACTOR * sens[cf]["logits"]),
            "flips": [f for f in d["flips"]], "tie_tokens": int(ties.sum())}
    for key, bar in (("decode", max(MOE_EP_TOL, LM_BF16_SENS_FACTOR
                                    * sens["decode"])),
                     ("decode_fp32", MOE_EP_TOL)):
        g, w = got[key], want[key]
        d = diff(g["routes"], w["routes"])
        res[key] = {"bitwise": torch.equal(g["logits"],
                                           to(w["logits"], g["logits"])),
                    "logit_rel_err": rows_rel_err(
                        g["logits"], to(w["logits"], g["logits"]),
                        d["ties"]),
                    "logit_bar": bar, "flips": d["flips"],
                    "tie_tokens": int(d["ties"].sum())}
    print(f"phase 19 (b) mesh vs single process: {json.dumps(res)}",
          flush=True)
    for key, r in res.items():
        wild = [f for f in r["flips"] if f["gap"] >= MOE_TIE]
        check(not wild, f"(b) {key}: routes flipped off a tie {wild[:4]}")
        check(r["logit_rel_err"] <= r["logit_bar"]
              and r.get("moe_rel_err", 0.0) <= r.get("moe_bar", 1.0),
              f"(b) {key}: mesh vs single process {r}")
        r["flips"] = len(r["flips"])
    return res


def ep_reference(torch, dev, tmp: str) -> dict:
    """Phase 19 (b)'s single process: (b)'s runs without a mesh, and once
    more with every input embedding one bf16 ulp up (its sensitivity),
    saved to ``tmp`` for the ranks; the card is left empty."""
    cfg = ep_config()
    t0 = time.perf_counter()
    params = ep_weights(torch, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens, rows, cols = ep_inputs(torch, cfg, dev)
    res = ep_run(torch, cfg, params, tokens, rows, cols)
    emb = params["embed"].to(torch.bfloat16)
    params["embed"] = (emb.view(torch.int16) + 1).view(torch.bfloat16).float()
    del emb
    cfs = (MOE_DROPLESS_CF, cfg.moe_capacity_factor)
    res["sens"] = ep_sensitivity(
        torch, res, ep_run(torch, cfg, params, tokens, rows, cols,
                           warm=False), cfs, rows)
    del params, tokens
    gc_cuda(torch)

    def host(v):
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [host(x) for x in v]
        return v.cpu() if isinstance(v, torch.Tensor) else v

    torch.save(host(res), f"{tmp}/ep-ref.pt")
    return {"init_s": init_s,
            "prefill_ms": {cf: res[cf]["ms"] for cf in cfs},
            "launches": {cf: res[cf]["launches"] for cf in cfs},
            "decode_ms_per_token": res["decode"]["ms_per_token"],
            "decode_fp32_ms_per_token": res["decode_fp32"]["ms_per_token"],
            "bf16_ulp_sensitivity": res["sens"]}


def mesh_ep_job(torch, dev, rank, world, tmp) -> dict:
    """Phase 19 (b), one of MESH_EP_WORLD ranks: llama4-scout over a
    ("data", "model") = 1 x MESH_EP_WORLD mesh against the single
    process."""
    from repro_torch.launch.mesh import make_mesh
    cfg = ep_config()
    mesh = make_mesh(1, model=world)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = ep_weights(torch, cfg, dev, mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens, rows, cols = ep_inputs(torch, cfg, dev)
    got = ep_run(torch, cfg, params, tokens, rows, cols, mesh)
    want = torch.load(f"{tmp}/ep-ref.pt", weights_only=False)
    res = ep_compare(torch, cfg, got, want, rows)
    out = {"shard": mesh.get_local_rank("model"), "init_s": init_s,
           "expert_rows": int(params["pattern"][0]["w_gate_e"].shape[1]),
           "compare": res, "peak_memory_bytes":
           torch.cuda.max_memory_allocated()}
    for cf in (MOE_DROPLESS_CF, cfg.moe_capacity_factor):
        g = got[cf]
        out[cf] = {key: g[key] for key in ("ms", "launches", "census",
                                             "gather_bytes", "gather_ms")}
        check(g["census"] == {"all_gather": cfg.num_layers},
              f"(b) capacity {cf}: census {g['census']}")
        check(g["launches"].get("flash_attention") == cfg.num_layers
              and sum(g["launches"].values()) == cfg.num_layers,
              f"(b) capacity {cf}: launches {g['launches']}")
    for key in ("decode", "decode_fp32"):
        d = got[key]
        out[key] = {k: d[k] for k in ("ms_per_token", "census",
                                      "gather_bytes", "gather_ms")}
        check(d["census"] == {"all_gather": cfg.num_layers * MESH_DECODE},
              f"(b) {key} census {d['census']}")
    return out


def capture_grads() -> list:
    """Make the trainer's clip (``trainer.clip_by_global_norm``, which a
    step calls once on its summed gradients) also append the gradients
    it is given to the returned list; the caller clears it.  A second
    call returns the first one's list."""
    from repro_torch.train import trainer
    if hasattr(trainer.clip_by_global_norm, "log"):
        return trainer.clip_by_global_norm.log
    log = []
    clip = trainer.clip_by_global_norm

    def recorded(grads, max_norm, *groups):
        log.append(grads)
        return clip(grads, max_norm, *groups)

    recorded.log = log
    trainer.clip_by_global_norm = recorded
    return log


def mesh_dp_job(torch, dev, rank, world, tmp) -> dict:
    """Phase 19 (c), one of MESH_DP_WORLD ranks: qwen3-0.6b's every_step
    baseline over ("data",) = world at full width, FSDP over "data" (the
    trainer's rules); rank 0 first runs the single process on the same
    batches and holds the mesh run to it: the losses, and the step-1
    gradient (before the clip, gathered whole) leaf by leaf within
    TOL of the leaf's max or, where larger, LM_BF16_SENS_FACTOR times the
    single process's own change when every input embedding moves one
    bf16 ulp (bf16 activations: the half-batch products round
    differently); the params after step 1 are printed
    (:func:`params_diff`)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import collectives
    from repro_torch.distributed import (TRAIN_RULES, gather_whole,
                                         init_sharded)
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import arch_specs
    from repro_torch.nn import init_params
    from repro_torch.optim import tree_leaves, tree_map
    from repro_torch.train import TrainSettings, make_train_step
    from repro_torch.train.trainer import _state, loss_and_grads

    cfg = dataclasses.replace(get_arch(LM_TRAIN_ARCH),
                              num_layers=MESH_DP_LAYERS)
    settings = TrainSettings(total_steps=LM_TRAIN_STEPS,
                             warmup_steps=max(LM_TRAIN_STEPS // 20, 2))
    batches = _lm_batches(torch, cfg, MESH_DP_STEPS, LM_BATCH, LM_SEQ, 6,
                          dev)
    specs = arch_specs(cfg)
    mesh = make_mesh(world)
    meter = gather_meter()
    grads = capture_grads()
    _build.reset_launches()
    out = {"rank": rank}
    if rank == 0:
        params = init_params(specs, torch.Generator(device=dev).manual_seed(0),
                             dev)
        state = _state(cfg, settings, tree_map(torch.clone, params))
        step = make_train_step(cfg, settings)
        single = []
        for i, b in enumerate(batches):
            state, m = step(state, b)
            single.append(float(m["loss"]))
            if i == 0:
                step1 = tree_map(torch.clone, state["params"])
                grad1 = grads[0]
            grads.clear()
        del state, step
        gc_cuda(torch)
        # The step-1 gradient's own bf16 rounding sensitivity: every input
        # embedding one bf16 ulp up (phase 9's rule), leaf by leaf.
        emb = params["embed"].to(torch.bfloat16)
        bumped = dict(params, embed=(emb.view(torch.int16) + 1).view(
            torch.bfloat16).float())
        del emb
        moved = loss_and_grads(cfg, settings, bumped, batches[0])[2]
        del bumped, params
        sens = [dev_rel(m, g) for g, m in zip(tree_leaves(grad1),
                                              tree_leaves(moved))]
        del moved
        gc_cuda(torch)
    collectives.barrier()
    torch.cuda.reset_peak_memory_stats()
    # FSDP over "data" (the trainer's rules): this rank's blocks of the
    # same draw.
    state = _state(cfg, settings, init_sharded(
        specs, torch.Generator(device=dev).manual_seed(0), mesh,
        TRAIN_RULES, dev))
    step = make_train_step(cfg, settings, mesh)
    losses, step_ms, census, gathers = [], [], [], []
    for i, b in enumerate(batches):
        collectives.reset_collectives()
        meter.update(bytes=0, ms=0.0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t) * 1e3)
        census.append(dict(collectives.COLLECTIVES))
        gathers.append({"bytes": meter["bytes"], "ms": meter["ms"]})
        # Every rank gathers (a collective); rank 0 compares.
        whole = ((gather_whole(grads[0], specs, mesh, TRAIN_RULES),
                  gather_whole(state["params"], specs, mesh, TRAIN_RULES))
                 if i == 0 else None)
        if i == 0 and rank == 0:
            err = [dev_rel(g, w) for w, g in zip(tree_leaves(grad1),
                                                 tree_leaves(whole[0]))]
            ratio = [e / max(TOL, LM_BF16_SENS_FACTOR * z)
                     for e, z in zip(err, sens)]
            worst = max(range(len(ratio)), key=ratio.__getitem__)
            out["grad_step1"] = {
                "err_over_bar": ratio[worst], "leaf": worst,
                "err": err[worst], "sensitivity": sens[worst],
                "max_err": max(err), "max_sensitivity": max(sens)}
            out["params_step1"] = params_diff(torch, step1, whole[1])
            del step1, grad1
        del whole
        grads.clear()
    out.update(losses=losses, step_ms=step_ms, census=census,
               gathers=gathers, launches=dict(_build.LAUNCHES),
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               checksum=[int(p.view(torch.int32).long().sum())
                         for p in tree_leaves(gather_whole(
                             state["params"], specs, mesh, TRAIN_RULES))])
    if rank == 0:
        out.update(single_losses=single, trajectory_rel=max(
            abs(a - b) / abs(b) for a, b in zip(losses, single)))
        print(f"phase 19 (c) rank 0: {json.dumps(out)}", flush=True)
        check(out["trajectory_rel"] <= TRAJ_TOL, f"(c) losses {losses} "
              f"against the single process's {single} (bar {TRAJ_TOL})")
        check(out["grad_step1"]["err_over_bar"] <= 1.0, f"(c) step-1 "
              f"gradient against the single process: {out['grad_step1']}")
    tt_census_ok("(c)", census, True)
    check(all(c == census[0] for c in census), f"(c) census {census}")
    check(not any(out["launches"].values()),
          f"(c) kernels launched: {out['launches']}")
    return out


MESH_JOBS = {"a": mesh_smoke_job, "b": mesh_ep_job, "c": mesh_dp_job}


def mesh_forms(torch, dev, smi) -> dict:
    """Phase 19: (a)-(c) (the constants' comment).  The three groups of
    ranks start together, so their start-up overlaps (a)'s work and (b)'s
    single process; (b)'s ranks start work once this process has freed
    the card, (c)'s once (b)'s have ended.  Returns the phase's summary
    with K6's launches in (b)'s ranks."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp()
    Path(f"{tmp}/go-a").touch()
    groups = {job: mp.start_processes(
        mesh_rank, args=(world, tmp, job), nprocs=world, join=False,
        start_method="spawn") for job, world in (
            ("a", MESH_SMOKE_WORLD), ("b", MESH_EP_WORLD),
            ("c", MESH_DP_WORLD))}
    sections = {}

    def reports(job, world):
        t = time.perf_counter()
        while not groups[job].join():
            pass
        sections[f"{job} (wait)"] = time.perf_counter() - t
        return [torch.load(f"{tmp}/{job}-r{r}.pt", weights_only=False)
                for r in range(world)]

    try:
        out = _mesh_forms(torch, dev, smi, tmp, groups, reports, sections)
    finally:
        # A failed check here or in a rank leaves ranks waiting for a go
        # file or a collective: end every one still running.
        for ctx in groups.values():
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    out["sections_s"] = sections
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 19: {out['seconds']:.1f} s; sections (s) "
          + json.dumps(sections), flush=True)
    return out


def _mesh_forms(torch, dev, smi, tmp, groups, reports, sections) -> dict:
    """:func:`mesh_forms`' work once the ranks have started."""
    out = {"phase": 19}
    t0 = time.perf_counter()
    ref = ep_reference(torch, dev, tmp)
    sections["b single process"] = time.perf_counter() - t0
    Path(f"{tmp}/go-b").touch()

    ranks = reports("a", MESH_SMOKE_WORLD)
    first = ranks[0]
    for r in ranks:
        check(not any(r["launches"].values()),
              f"(a) kernels launched: {r['launches']}")
        for key, res in r["moe"].items():
            check(torch.equal(res["y"], first["moe"][key]["y"]),
                  f"(a) {key}: the ranks' outputs differ")
    for arch in (LM_TRAIN_ARCH, MOE_ARCH):
        for p in (0, 1):
            sums = [r["train"][arch]["checksum"] for r in ranks
                    if r["pod"] == p]
            check(sums[0] == sums[1], f"(a) {arch}: the data ranks of pod "
                  f"{p} gather different params")
    out["a"] = {
        "moe": {key: {k: v for k, v in res.items() if k != "y"}
                for key, res in first["moe"].items()},
        "train": {arch: {k: v for k, v in res.items() if k != "checksum"}
                  for arch, res in first["train"].items()}}
    print("phase 19 (a) card vs CPU, smoke widths, fp32, "
          f"{MESH_SMOKE_WORLD} gloo ranks: " + json.dumps(out["a"]),
          flush=True)

    ranks = reports("b", MESH_EP_WORLD)
    Path(f"{tmp}/go-c").touch()
    cfg = ep_config()
    cfs = (MOE_DROPLESS_CF, cfg.moe_capacity_factor)
    out["b"] = {
        "arch": cfg.name, "layers": cfg.num_layers, "mesh": {
            "data": 1, "model": MESH_EP_WORLD},
        "single_process": ref,
        "ranks": [{"shard": r["shard"], "expert_rows": r["expert_rows"],
                   "init_s": r["init_s"],
                   "prefill_ms": {cf: r[cf]["ms"] for cf in cfs},
                   "gather_bytes_a_prefill": r[cfs[1]]["gather_bytes"],
                   "gather_ms_a_prefill": r[cfs[1]]["gather_ms"],
                   "census_a_prefill": r[cfs[1]]["census"],
                   "decode_ms_per_token": r["decode"]["ms_per_token"],
                   "decode_fp32_ms_per_token":
                       r["decode_fp32"]["ms_per_token"],
                   "decode_gather_bytes": r["decode"]["gather_bytes"],
                   "decode_gather_ms": r["decode"]["gather_ms"],
                   "compare": r["compare"],
                   "peak_memory_bytes": r["peak_memory_bytes"]}
                  for r in ranks]}
    out["launches_per_rank"] = [r[cfs[1]]["launches"] for r in ranks]
    out["launches"] = collections.Counter()
    for r in ranks:
        out["launches"].update(r[cfs[1]]["launches"])
    print(f"phase 19 (b) {cfg.name} at its published widths, "
          f"{cfg.num_layers} layers, expert-parallel over {MESH_EP_WORLD} "
          f"gloo ranks on one card ({smi}): " + json.dumps(out["b"]),
          flush=True)

    ranks = reports("c", MESH_DP_WORLD)
    check(ranks[0]["checksum"] == ranks[1]["checksum"],
          "(c) the data ranks gather different params")
    check(ranks[0]["census"] == ranks[1]["census"],
          "(c) the data ranks' censuses differ")
    out["c"] = {"arch": LM_TRAIN_ARCH, "layers": MESH_DP_LAYERS,
                "mesh": {"data": MESH_DP_WORLD},
                "batch": LM_BATCH, "seq": LM_SEQ, "steps": MESH_DP_STEPS,
                "ranks": [{k: v for k, v in r.items() if k != "checksum"}
                          for r in ranks]}
    print(f"phase 19 (c) {LM_TRAIN_ARCH} every_step over ('data',) = "
          f"{MESH_DP_WORLD} at its published widths, {MESH_DP_LAYERS} "
          f"layers ({smi}): "
          + json.dumps(out["c"]), flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 20: tensor-parallel LM serving
# ---------------------------------------------------------------------------

def tp_rank(rank: int, world: int, tmp: str, group: str, groups: dict,
            jobs: dict) -> None:
    """One gloo rank of a phase 20 or 21 group (``groups``: each group's
    world and jobs; ``jobs``: each job's function), all ranks sharing card
    0: it joins its group at once, then runs the group's jobs in order,
    each when the parent's go file for it appears, and writes each report
    to ``tmp``.  A failed check exits the rank non-zero, which fails the
    script."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store-{group}",
                            world_size=world, rank=rank)
    try:
        for job in groups[group][1]:
            while not Path(f"{tmp}/go-{job}").exists():
                time.sleep(0.05)
            out = jobs[job](torch, dev, rank, world, tmp)
            # Written whole, then renamed: the parent waits for the name.
            torch.save(out, f"{tmp}/{job}-r{rank}.part")
            os.replace(f"{tmp}/{job}-r{rank}.part", f"{tmp}/{job}-r{rank}.pt")
            gc_cuda(torch)
    finally:
        dist.destroy_process_group()


def tp_long(cfg):
    """``cfg`` decoding ``long`` with :data:`TP_LONG`'s settings."""
    return dataclasses.replace(cfg, **TP_LONG)


def tp_smoke_meshes():
    """(a)'s meshes over 4 ranks: "1x2" is ("replica", "model") = 2 x 2,
    two 1 x 2 meshes side by side (no rule names "replica", so each holds
    the whole batch); "2x2" ("data", "model"); "1x4"."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_mesh
    return {"1x2": init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("replica", "model")),
            "2x2": make_mesh(2, model=2), "1x4": make_mesh(1, model=4)}


def tp_smoke_job(torch, dev, rank, world, tmp) -> dict:
    """Phase 20 (a): every SMOKE config in fp32 on the card (CPU
    generator, seed 0, gates open), ``forward`` on TP_SMOKE_BATCH x
    TP_SMOKE_SEQ tokens and TP_SMOKE_STEPS teacher-forced decode steps,
    full and ``long``, single process and over each mesh of
    :func:`tp_smoke_meshes`: this rank's logit blocks within TOL of max
    |logit| of the single process's, a forward's census only
    ``all_gather``s."""
    from repro_torch.configs import all_archs, get_smoke_arch
    from repro_torch.core import collectives
    from repro_torch.distributed import shard_params
    from repro_torch.models import transformer as tt
    from repro_torch.nn import init_params

    meshes = tp_smoke_meshes()
    b, s, n = TP_SMOKE_BATCH, TP_SMOKE_SEQ, TP_SMOKE_STEPS
    out = {}
    with torch.inference_mode():
        for arch in all_archs():
            cfg = get_smoke_arch(arch)
            params = open_gates(init_params(
                tt.arch_specs(cfg), torch.Generator().manual_seed(0), dev))
            toks = torch.randint(0, cfg.vocab_size, (b, s),
                                 generator=torch.Generator().manual_seed(1)
                                 ).to(dev)
            vis = None if not cfg.vision_dim else torch.randn(
                (b, cfg.num_patches, cfg.vision_dim),
                generator=torch.Generator().manual_seed(2)).to(dev)

            def run(p, mesh=None):
                res = {"forward": tt.forward(cfg, p, toks, vis, mesh=mesh)}
                res["census"] = dict(collectives.COLLECTIVES)
                for long in (False, True):
                    c = tp_long(cfg) if long else cfg
                    cache = tt.init_cache(c, b, 2 * n, long=long,
                                          device=dev, mesh=mesh)
                    if vis is not None:
                        tt.precompute_vision_cache(c, p, cache, vis,
                                                   mesh=mesh)
                    logs = []
                    for t in range(n):
                        lg, cache = tt.decode_step(c, p, cache,
                                                   toks[:, t:t + 1],
                                                   long=long, mesh=mesh)
                        logs.append(lg)
                    res["long" if long else "full"] = torch.stack(logs)
                return res

            single = run(params)
            errs = {}
            for name, mesh in meshes.items():
                mine = shard_params(params, tt.arch_specs(cfg), mesh)
                r0, rows = tt.batch_rows(b, mesh)
                v0, cols = tt.vocab_block(cfg, mesh)
                collectives.reset_collectives()
                got = run(mine, mesh)
                census = got.pop("census")
                check(set(census) == {"all_gather"},
                      f"(a) {arch} over {name}: census {census}")
                err = {}
                for key, val in got.items():
                    want = single[key]
                    blk = (want[r0:r0 + rows] if key == "forward"
                           else want[:, r0:r0 + rows])[..., v0:v0 + cols]
                    err[key] = float((val - blk).abs().max()) / float(
                        want.abs().max())
                    check(err[key] <= TOL, f"(a) {arch} over {name} [{key}]:"
                          f" {err[key]:.3e} of max |logit| (bar {TOL})")
                errs[name] = {"max_rel_err": max(err.values()),
                              "gathers_a_forward": census["all_gather"]}
                del mine, got
            out[arch] = errs
    return out


def tp_tokens(torch, cfg, batch, dev):
    """(b)-(d)'s prompt (CPU generator, seed 1) and the seeded rows of a
    prefill's logits that are held (TP_ROWS of batch x TP_SEQ)."""
    tokens = torch.randint(0, cfg.vocab_size, (batch, TP_SEQ),
                           generator=torch.Generator().manual_seed(1)
                           ).to(dev)
    rows = torch.randperm(batch * TP_SEQ, generator=torch.Generator(
    ).manual_seed(4))[:TP_ROWS]
    return tokens, rows.to(dev)


def tp_config(name: str):
    """(b)-(d)'s config: published widths, K6 on the attention;
    deepseek's depth cut to TP_DEEPSEEK_LAYERS."""
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch(name), attn_backend="kernel")
    if name == TP_DEEPSEEK:
        cfg = dataclasses.replace(cfg, num_layers=TP_DEEPSEEK_LAYERS)
    return cfg


def tp_vision(torch, cfg, batch, dev):
    return None if not cfg.vision_dim else torch.randn(
        (batch, cfg.num_patches, cfg.vision_dim),
        generator=torch.Generator().manual_seed(2)).to(dev)


def tp_serve(torch, cfg, params, batch, dev, mesh=None,
             more=False) -> dict:
    """One process's or one rank's runs of (b)-(d): a warm-up and a timed
    bf16 prefill (and an fp32 one where ``more``: qwen3), then
    TP_DECODE teacher-forced bf16 decode steps of a full cache (and of a
    ``long`` one where ``more``).  Returns the held logit rows
    (this rank's vocabulary block) on the host, ms, K6's launches a
    prefill, the census and the bytes and ms gathered a prefill and a
    token."""
    from repro_torch.core import collectives
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as tt

    tokens, rows = tp_tokens(torch, cfg, batch, dev)
    vis = tp_vision(torch, cfg, batch, dev)
    meter = gather_meter()
    out = {}
    with torch.inference_mode():
        tt.forward(cfg, params, tokens, vis, mesh=mesh)
        for key, c in (("bf16", cfg), ("fp32", dataclasses.replace(
                cfg, dtype="float32"))):
            if key == "fp32" and not more:
                continue
            meter.update(bytes=0, ms=0.0)
            collectives.reset_collectives()
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            logits = tt.forward(c, params, tokens, vis, mesh=mesh)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            check(bool(torch.isfinite(logits).all()),
                  f"{cfg.name} {key} prefill: logits not finite")
            out[f"prefill_{key}"] = {
                "ms": ms, "launches": {k: v for k, v in
                                       _build.LAUNCHES.items() if v},
                "census": dict(collectives.COLLECTIVES),
                "gather_bytes": meter["bytes"], "gather_ms": meter["ms"],
                "rows": logits.reshape(-1, logits.shape[-1])[rows].cpu()}
            del logits
        decodes = [("full", cfg, False)] + (
            [("long", tp_long(cfg), True)] if more else [])
        for key, c, long in decodes:
            cache = tt.init_cache(c, batch, TP_SEQ, long=long, device=dev,
                                  mesh=mesh)
            if vis is not None:
                tt.precompute_vision_cache(c, params, cache, vis, mesh=mesh)
            meter.update(bytes=0, ms=0.0)
            collectives.reset_collectives()
            held, times = [], []
            for t in range(TP_DECODE):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, cache = tt.decode_step(c, params, cache,
                                           tokens[:, t:t + 1], long=long,
                                           mesh=mesh)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                if t % TP_DECODE_HELD == 0:
                    held.append(lg[:, 0].cpu())
            out[f"decode_{key}"] = {
                "ms_per_token": statistics.median(times[1:]),
                "census_a_token": {k: v / TP_DECODE for k, v in
                                   collectives.COLLECTIVES.items()},
                "gather_bytes_a_token": meter["bytes"] / TP_DECODE,
                "gather_ms_a_token": meter["ms"] / TP_DECODE,
                "rows": torch.cat(held)}
            del cache
    return out


def tp_reference(torch, dev, name: str, tmp: str) -> dict:
    """(b)-(d)'s single process on the card: the weights from a CUDA
    generator (seed 0; the ranks draw the same numbers leaf by leaf),
    :func:`tp_serve`'s runs, and the bf16 prefill once more with every
    input embedding one bf16 ulp up (its one-ulp sensitivity, phase 9's
    rule); saved to ``tmp`` for the ranks, the card left empty."""
    from repro_torch.launch.serve import tensor_bytes
    from repro_torch.models.transformer import arch_specs, forward
    from repro_torch.nn import init_params

    cfg = tp_config(name)
    batch = TP_BATCH[name]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(arch_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    open_gates(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = tensor_bytes(params)
    res = tp_serve(torch, cfg, params, batch, dev, more=name == TP_QWEN)
    tokens, rows = tp_tokens(torch, cfg, batch, dev)
    with torch.inference_mode():
        emb = params["embed"].to(torch.bfloat16)
        params["embed"] = (emb.view(torch.int16) + 1).view(
            torch.bfloat16).float()
        del emb
        moved = forward(cfg, params, tokens, tp_vision(torch, cfg, batch,
                                                       dev))
        moved = moved.reshape(-1, cfg.vocab_size)[rows].cpu()
    base = res["prefill_bf16"]["rows"]
    res["sens"] = float((moved - base).abs().max() / base.abs().max())
    res.update(init_s=init_s, weight_bytes=weight_bytes,
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    del params, moved
    gc_cuda(torch)
    torch.save(res, f"{tmp}/{name}-ref.pt")
    return {k: (v if not isinstance(v, dict) else
                {x: y for x, y in v.items() if x != "rows"})
            for k, v in res.items()}


def tp_bar(key: str, sens: float) -> float:
    """(b)-(d)'s bar against the single process, relative to max |logit|:
    TOL in fp32; in bf16 max(DECODE_TOL, LM_BF16_SENS_FACTOR times the
    single process's one-ulp change), phase 9's rule."""
    if "fp32" in key:
        return TOL
    return max(DECODE_TOL, LM_BF16_SENS_FACTOR * sens)


def tp_model_job(torch, dev, rank, world, tmp, name) -> dict:
    """Phase 20 (b)-(d), one rank: ``name`` at its published widths over
    ("data", "model") = 1 x ``world``, weights drawn leaf by leaf and cut
    (``sharding.init_sharded``), :func:`tp_serve`'s runs against the
    single process's saved rows."""
    from repro_torch.distributed import init_sharded
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import tensor_bytes
    from repro_torch.models import transformer as tt

    cfg = tp_config(name)
    batch = TP_BATCH[name]
    mesh = make_mesh(1, model=world)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = open_gates(init_sharded(
        tt.arch_specs(cfg), torch.Generator(device=dev).manual_seed(0), mesh,
        device=dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = tensor_bytes(params)
    got = tp_serve(torch, cfg, params, batch, dev, mesh,
                   more=name == TP_QWEN)
    want = torch.load(f"{tmp}/{name}-ref.pt", weights_only=False)
    v0, cols = tt.vocab_block(cfg, mesh)
    h_loc = params["pattern"][0]["wq"].shape[-2]
    kv_loc = params["pattern"][0]["wk"].shape[-2]
    out = {"rank": rank, "vocab_block": [v0, cols],
           "heads": [h_loc, kv_loc], "init_s": init_s,
           "weight_bytes": weight_bytes,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    for key, g in got.items():
        w = want[key]["rows"]
        rel = float((g["rows"] - w[:, v0:v0 + cols]).abs().max()
                    / w.abs().max())
        bar = tp_bar(key, want["sens"])
        check(rel <= bar, f"({name}) {key} over model={world}: "
              f"{rel:.3e} of max |logit| from the single process (bar "
              f"{bar:.3e})")
        out[key] = {k: v for k, v in g.items() if k != "rows"}
        out[key].update(rel_err=rel, bar=bar)
        if key.startswith("prefill"):
            check(g["launches"] == {"flash_attention": cfg.num_layers
                                    - cfg.pattern.count("xattn")
                                    * cfg.repeats},
                  f"({name}) {key}: launches {g['launches']}")
            check(set(g["census"]) == {"all_gather"},
                  f"({name}) {key}: census {g['census']}")
    return out


TP_JOBS = {"a": tp_smoke_job,
           "b": functools.partial(tp_model_job, name=TP_QWEN),
           "c": functools.partial(tp_model_job, name=TP_VLM),
           "d2": functools.partial(tp_model_job, name=TP_DEEPSEEK),
           "d4": functools.partial(tp_model_job, name=TP_DEEPSEEK)}


def tensor_parallel(torch, dev, smi) -> dict:
    """Phase 20: (a)-(d) (the constants' comment).  Both groups of ranks
    start together; (a) starts at once, each model's ranks once this
    process has run its single process and freed the card.  Returns the
    phase's summary with K6's launches in the ranks."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp()
    Path(f"{tmp}/go-a").touch()
    groups = {g: mp.start_processes(tp_rank, args=(world, tmp, g,
                                                   TP_GROUPS, TP_JOBS),
                                    nprocs=world, join=False,
                                    start_method="spawn")
              for g, (world, _) in TP_GROUPS.items()}
    sections = {}
    try:
        out = _tensor_parallel(torch, dev, smi, tmp, groups, sections)
    finally:
        for ctx in groups.values():
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    out["sections_s"] = sections
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 20: {out['seconds']:.1f} s; sections (s) "
          + json.dumps(sections), flush=True)
    return out


def _tensor_parallel(torch, dev, smi, tmp, groups, sections) -> dict:
    """:func:`tensor_parallel`'s work once the ranks have started."""
    from repro_torch.distributed import local_bytes
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import arch_specs

    out = {"phase": 20}
    t0 = time.perf_counter()
    refs = {}
    for name, job in ((TP_QWEN, "b"), (TP_VLM, "c"), (TP_DEEPSEEK, "d")):
        t = time.perf_counter()
        refs[name] = tp_reference(torch, dev, name, tmp)
        sections[f"{job} single process"] = time.perf_counter() - t
        for go in ((job,) if job != "d" else ("d2", "d4")):
            Path(f"{tmp}/go-{go}").touch()

    def reports(job, world, group):
        t = time.perf_counter()
        while not all(Path(f"{tmp}/{job}-r{r}.pt").exists()
                      for r in range(world)):
            for proc in groups[group].processes:
                check(proc.exitcode in (None, 0),
                      f"phase 20 group {group}: a rank exited "
                      f"{proc.exitcode}")
            time.sleep(0.05)
        sections[f"{job} (wait)"] = time.perf_counter() - t
        return [torch.load(f"{tmp}/{job}-r{r}.pt", weights_only=False)
                for r in range(world)]

    ranks = reports("a", 4, "four")
    out["a"] = ranks[0]
    print("phase 20 (a) tensor-parallel SMOKE configs, fp32, on the card "
          "over 1 x 2, 2 x 2 and 1 x 4 (4 gloo ranks): " + json.dumps({
              arch: {m: ranks_max(ranks, arch, m) for m in res}
              for arch, res in ranks[0].items()}), flush=True)
    out["launches"] = collections.Counter()
    out["fp32_launches"] = collections.Counter()
    out["launches_per_rank"] = []
    for job, name, world, group in (("b", TP_QWEN, 2, "two"),
                                    ("c", TP_VLM, 2, "two"),
                                    ("d2", TP_DEEPSEEK, 2, "two"),
                                    ("d4", TP_DEEPSEEK, 4, "four")):
        ranks = reports(job, world, group)
        for r in ranks:
            out["launches"].update(r["prefill_bf16"]["launches"])
            if "prefill_fp32" in r:
                out["fp32_launches"].update(r["prefill_fp32"]["launches"])
            out["launches_per_rank"].append(
                r["prefill_bf16"]["launches"].get("flash_attention", 0))
        cfg = tp_config(name)
        out[job] = {"arch": name, "layers": cfg.num_layers,
                    "mesh": {"data": 1, "model": world},
                    "single_process": refs[name], "ranks": ranks}
        print(f"phase 20 ({job}) {name} at its published widths, "
              f"{cfg.num_layers} layers, tensor-parallel over model = "
              f"{world} (gloo ranks on one card; {smi}): "
              + json.dumps(out[job]), flush=True)
    full = arch_specs(get_arch(TP_DEEPSEEK))
    out["deepseek_full_depth_bytes_a_rank"] = {
        m: local_bytes(full, {"data": 1, "model": m}) for m in (1, 2, 4, 8)}
    print("phase 20 (d) deepseek-coder-33b at full depth, fp32 weight "
          "bytes a rank by the placement: "
          + json.dumps(out["deepseek_full_depth_bytes_a_rank"]), flush=True)
    sections["all"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 21: the LM trainer's tensor parallelism and FSDP
# ---------------------------------------------------------------------------

def tt_batches(torch, cfg, n, batch, seq, dev) -> list:
    """``n`` batches of ``batch`` x ``seq`` tokens (CPU generator, seed
    5) with an uneven mask (a VLM's with its vision input)."""
    gen = torch.Generator().manual_seed(5)
    out = []
    for _ in range(n):
        toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                             generator=gen)
        mask = (torch.rand((batch, seq), generator=gen) < 0.75).float()
        mask[0, :2] = 1.0
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
        if cfg.vision_dim:
            b["vision"] = torch.randn((batch, cfg.num_patches,
                                       cfg.vision_dim), generator=gen)
        out.append({k: v.to(dev) for k, v in b.items()})
    return out


def tt_settings(pods: bool = False, stacked: bool = False):
    from repro_torch.train import TrainSettings
    if not pods:
        return TrainSettings(total_steps=20, warmup_steps=2)
    return TrainSettings(sync_mode="digest", n_pod=2,
                         sync_interval=TT_POD_INTERVAL, total_steps=20,
                         warmup_steps=2,
                         pod_impl="vmap" if stacked else "shard_map")


def tt_run(torch, cfg, settings, state, batches, mesh=None) -> dict:
    """``make_train_step`` over ``batches``: each step's metrics, census
    and ms (synchronised), the bytes gathered and their ms a step, and
    the clip's input of each step-1 call (a pod's in the stacked form)."""
    from repro_torch.core import collectives
    from repro_torch.kernels import _build
    from repro_torch.train import make_train_step

    step = make_train_step(cfg, settings, mesh)
    grads, meter = capture_grads(), gather_meter()
    grads.clear()
    out = {"metrics": [], "census": [], "ms": [], "gather_bytes": [],
           "gather_ms": []}
    _build.reset_launches()
    for i, b in enumerate(batches):
        collectives.reset_collectives()
        meter.update(bytes=0, ms=0.0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, b)
        metrics = {k: float(m[k]) for k in ("loss", "ce", "aux")}
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["metrics"].append(metrics)
        out["census"].append(dict(collectives.COLLECTIVES))
        out["gather_bytes"].append(meter["bytes"])
        out["gather_ms"].append(meter["ms"])
        if i == 0:
            out["grad1"] = list(grads)
        grads.clear()
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(not launched, f"{cfg.name}: the training path launched {launched}")
    out["state"] = state
    return out


def tt_hold(tag, got: dict, want: dict) -> dict:
    """The bars of a run against the single process's metrics: the
    step-1 loss within LM_LOSS_TOL, every step's loss, ce and aux within
    LM_FP32_TOL (relative).  Returns the largest differences."""
    loss1 = abs(got[0]["loss"] - want[0]["loss"]) / abs(want[0]["loss"])
    check(loss1 <= LM_LOSS_TOL, f"{tag}: step-1 loss {got[0]['loss']} "
          f"against {want[0]['loss']} ({loss1:.3e}, bar {LM_LOSS_TOL})")
    traj = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "ce", "aux"):
            e = abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
            traj = max(traj, e)
            check(e <= LM_FP32_TOL, f"{tag}: step {i + 1} {k} {g[k]} "
                  f"against {w[k]} ({e:.3e}, bar {LM_FP32_TOL})")
    return {"loss1_rel": loss1, "traj_rel": traj}


def tt_census_ok(tag, census: list, data_split: bool) -> None:
    """Gathers every step, and where "data" splits the batch (and, by the
    FSDP rule, the parameters) the mask count's all_reduce and the FSDP
    backward's all_to_alls; nothing else."""
    for c in census:
        check(set(c) <= {"all_gather", "all_reduce", "all_to_all"}
              and c.get("all_reduce", 0) == int(data_split)
              and (c.get("all_to_all", 0) > 0) == data_split
              and c.get("all_gather", 0) > 0, f"{tag}: census {c}")


def tt_smoke_job(torch, dev, rank, world, tmp) -> dict:
    """Phase 21 (a), one of 4 ranks (the constants' comment)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import all_archs, get_smoke_arch
    from repro_torch.distributed import (TRAIN_RULES, gather_whole,
                                         shard_params, train_state_specs)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import arch_specs
    from repro_torch.nn import init_params
    from repro_torch.optim import tree_map
    from repro_torch.train.trainer import _state

    meshes = {"1x2": init_device_mesh("cpu", (2, 2),
                                      mesh_dim_names=("replica", "model")),
              "2x2": make_mesh(2, model=2),
              "pod2_model2": make_mesh(1, pod=2, model=2)}

    def setup(arch):
        cfg = get_smoke_arch(arch)
        params = open_gates(init_params(
            arch_specs(cfg), torch.Generator().manual_seed(0), dev))
        return cfg, params, tt_batches(torch, cfg, TT_SMOKE_STEPS,
                                       TT_SMOKE_BATCH, TT_SMOKE_SEQ, dev)

    # The single process's runs: a config's on one rank, dealt round.
    archs = list(all_archs())
    for arch in archs[rank::world]:
        cfg, params, batches = setup(arch)
        single = {}
        for key, st in (("every", tt_settings()),
                        ("stacked", tt_settings(True, True))):
            run = tt_run(torch, cfg, st, _state(
                cfg, st, tree_map(torch.clone, params)), batches)
            single[key] = {"metrics": run["metrics"], "grad1": [
                tree_map(lambda g: g.cpu(), g) for g in run["grad1"]]}
        torch.save(single, f"{tmp}/a-single-{arch}.part")
        os.replace(f"{tmp}/a-single-{arch}.part",
                   f"{tmp}/a-single-{arch}.pt")
    out = {}
    for arch in archs:
        cfg, params, batches = setup(arch)
        specs = arch_specs(cfg)
        while not Path(f"{tmp}/a-single-{arch}.pt").exists():
            time.sleep(0.05)
        single = torch.load(f"{tmp}/a-single-{arch}.pt",
                            weights_only=False)
        res = {}
        for name, mesh in meshes.items():
            pods = name.startswith("pod")
            st = tt_settings(pods)
            whole = _state(cfg, st, tree_map(torch.clone, params))
            state = shard_params(whole, train_state_specs(specs,
                                                          cfg.optimizer),
                                 mesh, TRAIN_RULES)
            del whole
            got = tt_run(torch, cfg, st, state, batches, mesh)
            tag = f"(a) {arch} over {name}"
            ref = single["stacked" if pods else "every"]
            want = ref["grad1"][mesh.get_local_rank("pod") if pods else 0]
            g1 = tree_map(lambda g: g.cpu(), gather_whole(
                got["grad1"][0], specs, mesh, TRAIN_RULES))
            err = leaf_err(torch, want, g1)
            check(err <= TOL, f"{tag}: step-1 gradient {err:.3e} of a "
                  f"leaf's max (bar {TOL})")
            tt_census_ok(tag, got["census"], name == "2x2")
            res[name] = dict(tt_hold(tag, got["metrics"], ref["metrics"]),
                             grad_err=err, census=got["census"])
            del got, g1, state
        out[arch] = res
        del single, params
    return out


def tt_config(name: str):
    """(b)-(c)'s config: published widths with fp32 activations;
    deepseek's depth cut to TT_DEEPSEEK_LAYERS."""
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch(name), dtype="float32")
    if name == TT_DEEPSEEK:
        cfg = dataclasses.replace(cfg, num_layers=TT_DEEPSEEK_LAYERS)
    return cfg


def tt_reference(torch, dev, name: str, tmp: str) -> dict:
    """(b)-(c)'s single process on the card: its metrics and its step-1
    gradient saved to ``tmp`` for the ranks; the card left empty.  Also
    the gradient's own sensitivity to rounding: the step-1 gradient
    again with every input embedding one fp32 ulp up (phase 9's rule at
    fp32), each leaf's change over the leaf's max (``ulp_by_leaf``)."""
    from repro_torch.launch.serve import tensor_bytes
    from repro_torch.models.transformer import arch_specs
    from repro_torch.nn import init_params
    from repro_torch.optim import tree_leaves, tree_map
    from repro_torch.train.trainer import _state, loss_and_grads

    cfg = tt_config(name)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(arch_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    state = _state(cfg, tt_settings(), params)
    del params
    state_bytes = tensor_bytes(state)
    batches = tt_batches(torch, cfg, TT_STEPS[name], TT_BATCH, TT_SEQ, dev)
    run = tt_run(torch, cfg, tt_settings(), state, batches)
    del state, run["state"]
    peak = torch.cuda.max_memory_allocated()
    grad1 = run.pop("grad1")[0]
    params = init_params(arch_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev)
    params["embed"] = (params["embed"].view(torch.int32) + 1).view(
        torch.float32)
    moved = loss_and_grads(cfg, tt_settings(), params, batches[0])[2]
    del params
    ulp = [dev_rel(m, g) for g, m in zip(tree_leaves(grad1),
                                         tree_leaves(moved))]
    del moved
    grad1 = tree_map(lambda g: g.cpu(), grad1)
    torch.save({"metrics": run["metrics"], "grad1": grad1},
               f"{tmp}/{name}-train-ref.pt")
    del grad1
    res = dict(run, state_bytes=state_bytes, peak_memory_bytes=peak,
               ulp_by_leaf=ulp)
    gc_cuda(torch)
    return res


def tt_model_job(torch, dev, rank, world, tmp, name, data) -> dict:
    """Phase 21 (b)-(c), one rank: ``name`` over ("data", "model") =
    ``data`` x ``world / data`` under the FSDP rule, its state drawn leaf
    by leaf and cut, against the single process's saved run."""
    from repro_torch.distributed import (TRAIN_RULES, init_sharded,
                                         shard_params)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import tensor_bytes
    from repro_torch.models.transformer import arch_specs
    from repro_torch.optim import tree_leaves
    from repro_torch.train.trainer import _state

    cfg = tt_config(name)
    mesh = make_mesh(data, model=world // data)
    tag = f"({name}) over data {data} x model {world // data}"
    torch.cuda.reset_peak_memory_stats()
    params = init_sharded(arch_specs(cfg),
                          torch.Generator(device=dev).manual_seed(0), mesh,
                          TRAIN_RULES, dev)
    state = _state(cfg, tt_settings(), params)
    del params
    state_bytes = tensor_bytes(state)
    batches = tt_batches(torch, cfg, TT_STEPS[name], TT_BATCH, TT_SEQ, dev)
    got = tt_run(torch, cfg, tt_settings(), state, batches, mesh)
    del state, got["state"]
    want = torch.load(f"{tmp}/{name}-train-ref.pt", mmap=True,
                      weights_only=False)
    mine = shard_params(want["grad1"], arch_specs(cfg), mesh, TRAIN_RULES,
                        copy=False)
    # Each leaf's block against the single process's block, over the
    # whole leaf's max, and a pattern leaf's by layer (its leading
    # repeats dim): the parent takes the largest over the ranks.
    errs, by_layer = [], []
    for name, g, w, whole in zip(
            leaf_names(want["grad1"]), tree_leaves(got.pop("grad1")[0]),
            tree_leaves(mine), tree_leaves(want["grad1"])):
        diff = (g.float() - w.to(dev).float()).abs()
        top = max(float(whole.abs().max()), 1e-30)
        errs.append(float(diff.max()) / top)
        by_layer.append((diff.reshape(len(diff), -1).amax(1) / top).tolist()
                        if name.startswith("pattern/") else None)
        del diff
    err = max(errs)
    check(err <= TOL, f"{tag}: step-1 gradient {err:.3e} of a leaf's max "
          f"(bar {TOL})")
    tt_census_ok(tag, got["census"], data > 1)
    return dict({k: v for k, v in got.items() if k != "metrics"},
                **tt_hold(tag, got["metrics"], want["metrics"]),
                rank=rank, grad_err=err, grad_err_by_leaf=errs,
                grad_err_by_layer=by_layer,
                state_bytes=state_bytes,
                peak_memory_bytes=torch.cuda.max_memory_allocated())


def tt_warm_job(torch, dev, rank, world, tmp) -> dict:
    """Two SMOKE steps of qwen3-0.6b over ("data", "model") = 1 x world:
    the 2-rank group's first use of the card, untimed."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.distributed import TRAIN_RULES, init_sharded
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import arch_specs
    from repro_torch.train.trainer import _state

    cfg = get_smoke_arch(TT_QWEN)
    mesh = make_mesh(1, model=world)
    state = _state(cfg, tt_settings(), init_sharded(
        arch_specs(cfg), torch.Generator().manual_seed(0), mesh,
        TRAIN_RULES, dev))
    tt_run(torch, cfg, tt_settings(), state,
           tt_batches(torch, cfg, 2, TT_SMOKE_BATCH, TT_SMOKE_SEQ, dev),
           mesh)
    return {}


TT_JOBS = {"w": tt_warm_job, "a": tt_smoke_job,
           "b2": functools.partial(tt_model_job, name=TT_QWEN, data=1),
           "b4": functools.partial(tt_model_job, name=TT_QWEN, data=2),
           "c2": functools.partial(tt_model_job, name=TT_DEEPSEEK, data=1)}


def tensor_parallel_training(torch, dev, smi) -> dict:
    """Phase 21: (a)-(c) (the constants' comment).  Both groups start
    together: (a) at once, beside this process's single-process runs and
    then (b) over 2 ranks and (c); (b) over 4 ranks last, alone."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp()
    Path(f"{tmp}/go-a").touch()
    Path(f"{tmp}/go-w").touch()
    groups = {g: mp.start_processes(tp_rank, args=(world, tmp, g,
                                                   TT_GROUPS, TT_JOBS),
                                    nprocs=world, join=False,
                                    start_method="spawn")
              for g, (world, _) in TT_GROUPS.items()}
    sections = {}
    try:
        out = _tensor_parallel_training(torch, dev, smi, tmp, groups,
                                        sections)
    finally:
        for ctx in groups.values():
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    out["sections_s"] = sections
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 21: {out['seconds']:.1f} s; sections (s) "
          + json.dumps(sections), flush=True)
    return out


def _tensor_parallel_training(torch, dev, smi, tmp, groups,
                              sections) -> dict:
    """:func:`tensor_parallel_training`'s work once the ranks have
    started."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import (TRAIN_RULES, local_bytes,
                                         train_state_specs)
    from repro_torch.models.transformer import arch_specs
    from repro_torch.nn import abstract_params

    out = {"phase": 21}
    t0 = time.perf_counter()
    refs = {}
    for name, job in ((TT_QWEN, "b2"), (TT_DEEPSEEK, "c2")):
        t = time.perf_counter()
        refs[name] = tt_reference(torch, dev, name, tmp)
        sections[f"{name} single process"] = time.perf_counter() - t
        Path(f"{tmp}/go-{job}").touch()

    def reports(job, world, group):
        Path(f"{tmp}/go-{job}").touch()
        t = time.perf_counter()
        while not all(Path(f"{tmp}/{job}-r{r}.pt").exists()
                      for r in range(world)):
            for proc in groups[group].processes:
                check(proc.exitcode in (None, 0),
                      f"phase 21 group {group}: a rank exited "
                      f"{proc.exitcode}")
            time.sleep(0.05)
        sections[f"{job} (wait)"] = time.perf_counter() - t
        return [torch.load(f"{tmp}/{job}-r{r}.pt", weights_only=False)
                for r in range(world)]

    ranks = reports("a", 4, "four")
    for arch, res in ranks[0].items():
        for mesh in res:
            census = [r[arch][mesh].pop("census") for r in ranks]
            check(all(c == census[0] for c in census),
                  f"(a) {arch} over {mesh}: the ranks' censuses differ")
            res[mesh]["gathers_a_step"] = census[0][0].get("all_gather", 0)
            for key in ("grad_err", "loss1_rel", "traj_rel"):
                res[mesh][key] = max(r[arch][mesh][key] for r in ranks)
    out["a"] = ranks[0]
    print("phase 21 (a) sharded training of the SMOKE configs, fp32, on "
          "the card over 1 x 2, 2 x 2 (FSDP) and (pod 2, model 2) (4 gloo "
          "ranks): " + json.dumps(out["a"]), flush=True)
    for job, name, world, group in (("b2", TT_QWEN, 2, "two"),
                                    ("c2", TT_DEEPSEEK, 2, "two"),
                                    ("b4", TT_QWEN, 4, "four")):
        ranks = reports(job, world, group)
        census = [r.pop("census") for r in ranks]
        check(all(c == census[0] for c in census),
              f"({job}) the ranks' censuses differ")
        cfg = tt_config(name)
        data = 2 if job == "b4" else 1
        # The worst leaf of the step-1 gradient over the ranks, beside
        # the single process's own change under one fp32 ulp of its
        # input, and the largest error of a pattern leaf by layer (the
        # backward runs from the last layer to the first).
        errs = [max(e) for e in zip(*(r.pop("grad_err_by_leaf")
                                      for r in ranks))]
        layers = [None if ls[0] is None else [max(v) for v in zip(*ls)]
                  for ls in zip(*(r.pop("grad_err_by_layer")
                                  for r in ranks))]
        ulp = refs[name]["ulp_by_leaf"]
        names = leaf_names(abstract_params(arch_specs(cfg)))
        worst = max(range(len(errs)), key=errs.__getitem__)
        most = max(range(len(ulp)), key=ulp.__getitem__)
        out[job] = {"arch": name, "layers": cfg.num_layers,
                    "optimizer": cfg.optimizer,
                    "mesh": {"data": data, "model": world // data},
                    "batch": TT_BATCH, "seq": TT_SEQ,
                    "census_a_step": census[0],
                    "grad_worst_leaf": {
                        "leaf": names[worst], "err": errs[worst],
                        "err_by_layer": layers[worst],
                        "single_one_ulp_change": ulp[worst],
                        "single_one_ulp_change_max": ulp[most],
                        "single_one_ulp_change_max_leaf": names[most]},
                    "grad_err_by_layer": [
                        max(ls[i] for ls in layers if ls is not None)
                        for i in range(cfg.repeats)],
                    "single_process": {k: v for k, v in refs[name].items()
                                       if k not in ("census",
                                                    "ulp_by_leaf")},
                    "ranks": ranks}
        print(f"phase 21 ({job}) {name} training at its published widths "
              f"(fp32 activations), {cfg.num_layers} layers, over data "
              f"{data} x model {world // data} (gloo ranks on one card; "
              f"{smi}): " + json.dumps(out[job]), flush=True)
    full = arch_specs(get_arch(TT_DEEPSEEK))
    state = train_state_specs(full, "adafactor")
    out["deepseek_full_depth_state_bytes_a_rank"] = {
        f"data {d} x model {m}": local_bytes(state, {"data": d, "model": m},
                                             TRAIN_RULES)
        for d in (1, 2) for m in (1, 2, 4, 8)}
    print("phase 21 (c) deepseek-coder-33b at full depth (62 layers), "
          "Adafactor train-state bytes a rank by the placement (the "
          "FSDP rule): "
          + json.dumps(out["deepseek_full_depth_state_bytes_a_rank"]),
          flush=True)
    sections["all"] = time.perf_counter() - t0
    return out


def ranks_max(ranks, arch, mesh) -> dict:
    return {"max_rel_err": max(r[arch][mesh]["max_rel_err"] for r in ranks),
            "gathers_a_forward": ranks[0][arch][mesh]["gathers_a_forward"]}


def dry_run_phase(torch, dev, smi) -> dict:
    """Phase 22: (a) and (b) (the constants' comment).  Returns the
    phase's summary with K6's launches on (a)'s real prefill."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = []
    for i, extra in enumerate(DRY_GNN_RECORDS):
        out = f"{tmp}/census-{i}.jsonl"
        procs.append((out, extra, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun_gnn",
             "--multi-pod", "--pull", "collective", "--out", out, *extra],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)))
    try:
        res = _dry_prefill(torch, dev, smi)
        t_gnn = time.perf_counter()
        records = []
        for out, extra, proc in procs:
            _, err = proc.communicate(timeout=DRY_GNN_TIMEOUT)
            check(proc.returncode == 0,
                  f"dryrun_gnn {extra}: exit {proc.returncode}: "
                  f"{err[-3000:]}")
            with open(out) as f:
                records += [json.loads(line) for line in f if line.strip()]
        census = f"{tmp}/census-multipod.jsonl"
        with open(census, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in records)
        from repro_torch.launch import census_check
        rc = census_check.main([census, "--records", "3"])
        check(rc == 0, f"census_check of the GNN dry run's records: exit "
              f"{rc}")
        res["gnn"] = [{k: r[k] for k in (
            "mesh", "precision", "parts_per_device", "predictor",
            "collective_counts", "collective_per_op",
            "collective_inter_pod_bytes", "compute_term_s", "memory_term_s",
            "collective_term_s", "mem_peak_bytes", "t_dry_s")}
            for r in records]
        res["gnn_wait_s"] = time.perf_counter() - t_gnn
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"dry_run": res}), flush=True)
    print(f"phase 22: {res['seconds']:.1f} s", flush=True)
    return res


def _dry_prefill(torch, dev, smi) -> dict:
    """Phase 22 (a)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import arch_specs, forward
    from repro_torch.nn import init_params

    cfg = dataclasses.replace(get_arch("qwen3-0.6b"), attn_backend="kernel")
    shape = {"seq": LM_SEQ, "batch": LM_BATCH, "kind": "prefill"}
    dry = dryrun.lm_case(cfg, shape, None)
    gc_cuda(torch)
    base = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(arch_specs(cfg), gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                           generator=gen, device=dev, dtype=torch.int32)
    with torch.inference_mode():
        forward(cfg, params, tokens)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        logits = forward(cfg, params, tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) - base
    check(logits.shape == (LM_BATCH, LM_SEQ, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "dry-run phase: the real prefill's logits are malformed")
    del logits, params, tokens
    gc_cuda(torch)
    k6 = dry["kernels"].get("flash_attention", {}).get("calls", 0)
    check(launches["flash_attention"] == cfg.num_layers == k6
          and sum(launches.values()) == k6,
          f"dry-run phase: the dry ledger's K6 calls {k6} against the real "
          f"launches {launches} (expected {cfg.num_layers})")
    rel = abs(dry["mem_peak_bytes"] - peak) / peak
    terms = {k: dry[k] for k in ("compute_term_s", "memory_term_s",
                                 "collective_term_s")}
    print(f"card: {smi}", flush=True)
    print(f"phase 22 (a) qwen3-0.6b bf16 prefill {LM_BATCH} x {LM_SEQ}: "
          f"K6 {k6} dry calls, {launches['flash_attention']} launches; "
          f"peak memory predicted {dry['mem_peak_bytes']} B (the dry run), "
          f"measured {peak} B (max_memory_allocated less the "
          f"{base} B allocated before), {100 * rel:.2f}% apart; predicted "
          f"terms from data-sheet peaks {terms}, measured wall "
          f"{ms:.2f} ms", flush=True)
    check(rel <= DRY_PEAK_TOL,
          f"dry-run phase: predicted peak {dry['mem_peak_bytes']} B is "
          f"{100 * rel:.1f}% from the measured {peak} B (bar "
          f"{100 * DRY_PEAK_TOL:.0f}%)")
    return {"arch": cfg.name, "batch": LM_BATCH, "seq": LM_SEQ,
            "k6_dry_calls": k6, "launches": launches,
            "predicted_peak_bytes": dry["mem_peak_bytes"],
            "measured_peak_bytes": peak, "allocated_before_bytes": base,
            "peak_rel_diff": rel, "predicted": terms,
            "flops_by_dtype": dry["flops_by_dtype"],
            "hbm_bytes": dry["hbm_bytes"], "device_ops": dry["device_ops"],
            "measured_ms": ms, "card": smi}


def gc_cuda(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


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
    tally_shapes()
    t0 = time.perf_counter()
    with torch.inference_mode():
        serve_records, serve_launches = run(torch, dev)
    t_serve = time.perf_counter() - t0
    train_records, train_launches, data, raw_ms = training(torch, dev)
    sat = sat_training(torch, dev, data, raw_ms, smi)
    sampled = sampled_training(torch, dev, data, raw_ms, smi)
    asynchronous = async_training(torch, dev, data, raw_ms, smi)
    multi = distributed(torch, dev, data, raw_ms, smi)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0 - t_serve
    with torch.no_grad():
        lm_records = lm_kernel_phase(torch, dev, data)
    print(json.dumps({"kernel_variants": lm_records}), flush=True)
    pre = lm_prefill(torch, dev)
    lm_decode(torch, dev, pre)
    path_launches = {"prefill": pre["launches"],
                     "fp32 prefill": pre["fp32_launches"],
                     "gat_aggregate": gat_path(torch, dev, data)["launches"]}
    del pre
    torch.cuda.empty_cache()
    moe = moe_serving(torch, dev, smi)
    path_launches.update({"moe prefill": moe["launches"],
                          "moe fp32 prefill": moe["fp32_launches"]})
    moe_s = moe["seconds"]
    del moe
    torch.cuda.empty_cache()
    lm_train = lm_training(torch, dev, smi)
    gc_cuda(torch)
    last = last_archs(torch, dev, smi)
    path_launches.update({"vlm prefill": last["launches"],
                          "vlm fp32 prefill": last["fp32_launches"]})
    gc_cuda(torch)
    mesh = mesh_forms(torch, dev, smi)
    path_launches["moe ep mesh prefill"] = mesh["launches"]
    gc_cuda(torch)
    tp = tensor_parallel(torch, dev, smi)
    path_launches.update({"tp prefill": tp["launches"],
                          "tp fp32 prefill": tp["fp32_launches"]})
    gc_cuda(torch)
    tt = tensor_parallel_training(torch, dev, smi)
    gc_cuda(torch)
    dry = dry_run_phase(torch, dev, smi)
    path_launches["dry run prefill"] = dry["launches"]
    torch.cuda.synchronize()
    print(f"phases: serving {t_serve:.1f} s, training {t_train:.1f} s (of "
          f"which SAT training {sat['seconds']:.1f} s, sampled training "
          f"{sampled['seconds']:.1f} s, async training "
          f"{asynchronous['seconds']:.1f} s, multi-GPU exchange "
          f"{multi['seconds']:.1f} s), "
          f"LM, GAT and MoE {time.perf_counter() - t0 - t_serve - t_train:.1f}"
          f" s (of which MoE serving {moe_s:.1f} s, LM training "
          f"{lm_train['seconds']:.1f} s, the last three architectures "
          f"{last['seconds']:.1f} s, the mesh forms {mesh['seconds']:.1f} "
          f"s, tensor parallelism {tp['seconds']:.1f} s, sharded "
          f"training {tt['seconds']:.1f} s, the dry run "
          f"{dry['seconds']:.1f} s); the script "
          f"{time.perf_counter() - T_START:.1f} s", flush=True)
    records = serve_records + train_records + lm_records
    kernels = []
    for name, (title, source, replaces, variant) in KERNELS.items():
        kernel = BODY_OF.get(name, name)
        mine = [r for r in records if r["name"] == kernel]
        if kernel == "flash_attention":         # one entry a body
            body = variant.split()[0]
            mine = [r for r in mine if r["variant"].split()[0] == body]
        rec = next(r for r in mine if r["variant"] == variant)
        launches = {"serving": serve_launches[kernel] if kernel
                    in SERVING_KERNELS else 0,
                    "training": train_launches[kernel] if kernel
                    in TRAINING_KERNELS else 0,
                    "sat training": sat["launches"][kernel] if kernel
                    in TRAINING_KERNELS else 0,
                    "sampled training": sampled["launches"][kernel] if kernel
                    in TRAINING_KERNELS else 0,
                    "async training": asynchronous["launches"][kernel]
                    if kernel in TRAINING_KERNELS else 0,
                    "collective training": multi["launches"][kernel],
                    "sharded serving": multi["serve_launches"][kernel]}
        for path in PATH_OF.get(name, ()):
            launches[path] = path_launches[path][kernel]
        launches["lm training"] = lm_train["main_path_launches"].get(
            kernel, 0)
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
        # Its device times at every shape timed (phases 3, 6 and 8).
        kernels[-1]["ms_by_variant"] = {r["variant"]: r["ms"] for r in mine}
        if name == "flash_attention":
            kernels[-1]["mesh_launches_per_rank"] = [
                r.get(kernel, 0) for r in mesh["launches_per_rank"]]
            kernels[-1]["tp_launches_per_rank"] = tp["launches_per_rank"]
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
