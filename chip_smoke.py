#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card and
check it.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each ending the run with a non-zero exit on failure:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions;
2. build the CUDA kernels from ``src/repro_torch/csrc`` (timed);
3. every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (products-sim, scale 1.0, 8 parts: K1 on
   the full-graph ELL at widths 100 and 128 and on a bf16 or fp32 query
   batch, K2/K3 on a 256-query batch over the 12616-row serving store with
   the store's own scales), within atol = rtol = 1e-5, and K3 == K2 (K1
   for an unscaled slab) exactly when one chunk covers the slab; each
   timed (``ms``: device time per call, 20 calls queued behind a spin
   kernel between two CUDA events; ``kernel_ms``: the median of 20 single
   calls between CUDA events, host launch gap included) beside its plain
   version, its byte/operation bound and one PyTorch library call
   (``torch.sparse.mm`` on the CSR form of the ELL) as a yardstick;
4. the main path: the paper's GCN config (products-sim, 3 layers, hidden
   128, 8 parts, random weights from ``torch.Generator`` seed 0), for an
   int8, a bf16 and an fp32 serving store: top-layer representations, two
   in-place store refreshes, then 64 Zipf batches of 256 queries behind a
   2048-row 4-way hot-row cache.  The refresh forward's h^(L-1) is held
   against a forward through the gather-form oracles, and the first and
   last batches' logits against the top layer recomputed from the store's
   own (dequantised) rows, all within 1e-5; the launch counters must show
   K1 in the refresh forward and K2 (int8), K1 (bf16) or K3 (fp32) in the
   queries;
5. SAGE and GAT (same sizes, int8 store): one refresh and 8 batches each,
   with the same check.

The last lines are the card's ``nvidia-smi`` line, one JSON object
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.  Without a
card, or outside a checkout, it exits non-zero and prints no result.
TF32 is off throughout (fp32 products run in full fp32).
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the fp32 rate outside
# the tensor cores (the kernels' FMAs are plain fp32).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TOL = 1e-5
BATCH = 256
BATCHES = 64
ZIPF_SKEW = 1.1

KERNELS = {
    "spmm": ("K1 ELL SpMM", "src/repro_torch/csrc/spmm.cu",
             "src/repro/kernels/spmm/spmm.py:49"),
    "halo_spmm": ("K2 fused halo pull (resident)",
                  "src/repro_torch/csrc/halo_pull.cu",
                  "src/repro/kernels/spmm/halo_pull.py:128"),
    "halo_spmm_stream": ("K3 fused halo pull (stream)",
                         "src/repro_torch/csrc/halo_pull.cu",
                         "src/repro/kernels/spmm/halo_pull.py:251"),
}


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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    from repro_torch.kernels.spmm import (halo_spmm_cuda,
                                          halo_spmm_plain,
                                          halo_spmm_stream_cuda,
                                          halo_spmm_stream_plain, spmm_cuda,
                                          spmm_plain)
    gen = torch.Generator().manual_seed(1)

    def randn(rows, feat):
        t = torch.randn((rows, feat), generator=gen)
        t[-1] = 0                                  # zero sentinel row
        return t.to(dev)

    records = []

    def record(name, variant, got, want, run, plain, nbr, wts, slabs,
               scales, lib_table):
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=TOL, rtol=TOL),
              f"{name} [{variant}] disagrees with its plain version: "
              f"max |err| {err:.3e}")
        feat = got.shape[1]
        b_ms, b_by = bound(torch, nbr, wts, slabs, scales, feat)
        csr = csr_of(torch, nbr, wts, lib_table.shape[0])
        lib = torch.sparse.mm(csr, lib_table)
        check(torch.allclose(lib, want, atol=1e-4, rtol=1e-4),
              f"library yardstick of {name} [{variant}] computes another "
              "function")
        times = {"ms": device_ms(torch, run),
                 "kernel_ms": event_ms(torch, run),
                 "plain_ms": event_ms(torch, plain, reps=5, warmup=1),
                 "library_ms": device_ms(
                     torch, lambda: torch.sparse.mm(csr, lib_table))}
        check(all(isinstance(t, float) and t > 0 for t in times.values()),
              f"{name} [{variant}]: a timing is missing: {times}")
        records.append({
            "name": name, "variant": variant, "shape": list(nbr.shape)
            + [int(lib_table.shape[0]), feat],
            "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            **times})

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
    from repro_torch.launch.serving_driver import run_serve_loop
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
            "reps_max_abs_err": reps_err,
            "launches_refresh": {k: c1[k] - c0[k] for k in c0},
            "launches_queries": {k: c2[k] - c1[k] for k in c0}}


def run(torch, dev) -> list:
    """Phases 3-5 on the card ``dev``; returns the kernels' records."""
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
        check(res["launches_queries"][expect[storage]] == BATCHES,
              f"{res['path']}: {expect[storage]} launched "
              f"{res['launches_queries'][expect[storage]]} times in "
              f"{BATCHES} batches")
    main_launches = dict(_build.LAUNCHES)
    check(all(v > 0 for v in main_launches.values()),
          f"a kernel of the main path never launched: {main_launches}")

    for name in ("sage", "gat"):
        cfg, params = model(name)
        res = serve_path(torch, dev, cfg, params, data, plan, "int8", 1,
                         queries[:8], "descending degree")
        print(json.dumps(res), flush=True)
        check(res["launches_refresh"]["spmm"] > 0,
              f"{res['path']}: K1 not launched in the refresh forward")

    out = []
    main_variant = {"spmm": "full float32 w128", "halo_spmm": "int8",
                    "halo_spmm_stream": "fp32"}
    for name, (title, source, replaces) in KERNELS.items():
        mine = [r for r in records if r["name"] == name]
        rec = next(r for r in mine if r["variant"] == main_variant[name])
        out.append({"name": name, "title": title, "route": "cuda",
                    "source": source, "replaces": replaces,
                    "launches": main_launches[name],
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    "ms": rec["ms"], "kernel_ms": rec["kernel_ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"],
                    "variant": rec["variant"], "shape": rec["shape"]})
    return out


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
    for name, info in built.items():
        print(f"--- nvcc {name}.cu ({info['seconds']:.2f} s)\n"
              f"{info['log'].strip()}", flush=True)

    dev = torch.device("cuda", 0)
    with torch.inference_mode():
        kernels = run(torch, dev)
    torch.cuda.synchronize()
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
