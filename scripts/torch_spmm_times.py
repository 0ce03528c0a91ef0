#!/usr/bin/env python3
"""Device time of the port's K1 (``spmm_cuda``) and SpMM backward kernels
(``spmm_bwd_table``, ``spmm_bwd_wts``) at every shape the main paths give
them, on one NVIDIA card.

    PYTHONPATH=src python3 scripts/torch_spmm_times.py [--label NAME]

The ``repro_torch`` on the import path is the one timed, so two checkouts
are compared on one card by running this script once with each checkout's
``src`` first on ``PYTHONPATH``, in turns (A, B, B, A).  Shapes: products-
sim at scale 1.0 in 8 parts (the full-graph in-ELL at widths 128 fp32,
128 bf16 and 100 fp32; a 256-query batch over the serving store in fp32
and bf16) and papers-sim at scale 1.0 in 8 rcm parts with 256-row chunks,
subgraph 0 (the in-ELL over the local table at widths 128 and 32 fp32,
the out-ELL over the bf16 halo slab, the table gradient through the
transposed in-ELL at widths 128 and 32, and the weight gradient at GAT's
shapes: the in-ELL over the local table and the out-ELL over the halo
table, at the hidden layers' per-head width 32 and the output layer's
8).  Each time is
``chip_smoke.device_ms``: 20 calls queued behind a spin kernel between two
CUDA events.  Prints the card's ``nvidia-smi`` name and power limit and
one JSON line ``{"label", "card", "ms": {shape: ms}}``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (device_ms, nvidia_smi)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import numpy as np
    import torch

    from repro_torch.core import serving
    from repro_torch.core.digest import prepare_graph_data
    from repro_torch.graph import make_dataset
    from repro_torch.kernels.spmm import (spmm_bwd_table, spmm_bwd_wts,
                                          spmm_cuda)

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    card = chip_smoke.nvidia_smi()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(5)

    def table(rows, width, dtype):
        t = torch.randn((rows, width), generator=gen)
        t[-1] = 0
        return t.to(dev, dtype)

    ms = {}

    def time_k1(name, nbr, wts, tab):
        ms[name] = chip_smoke.device_ms(torch,
                                        lambda: spmm_cuda(nbr, wts, tab))

    with torch.inference_mode():
        g = make_dataset("products-sim", scale=1.0, seed=0)
        data = prepare_graph_data(g, 8, seed=0, device=dev)
        nbr = data["full_struct"]["in_nbr"][0]
        wts = data["full_struct"]["in_wts"][0]
        n = nbr.shape[0] + 1
        for dtype, width in ((torch.float32, 128), (torch.bfloat16, 128),
                             (torch.float32, 100)):
            time_k1(f"full {nbr.shape[0]}x{nbr.shape[1]} "
                    f"{str(dtype).split('.')[-1]} w{width}", nbr, wts,
                    table(n, width, dtype))
        plan = serving.build_serve_plan(data)
        hot = np.argsort(-g.degrees()).astype(np.int32)
        q = serving.zipf_queries(g.num_nodes, chip_smoke.BATCH,
                                 chip_smoke.BATCHES, chip_smoke.ZIPF_SKEW,
                                 seed=1, hot_ids=hot)[0]
        qdata = plan.query_data(dev)
        q = torch.from_numpy(q).to(dev).long()
        qnbr = qdata["serve_map"][qdata["nbr"][q].long()]
        qwts = qdata["wts"][q]
        for dtype in (torch.float32, torch.bfloat16):
            time_k1(f"query 256x{qnbr.shape[1]} "
                    f"{str(dtype).split('.')[-1]} w128", qnbr, qwts,
                    table(plan.store_rows, 128, dtype))

        g = make_dataset("papers-sim", scale=1.0, seed=0)
        data = prepare_graph_data(g, 8, seed=0, order="rcm",
                                  stream_chunk_rows=256, device=dev)
        st = {k: v[0] for k, v in data["struct"].items()}
        n_in = st["in_nbr"].shape[0] + 1
        n_out = int(data["halo_ids"].shape[1]) + 1
        for side, dtype, width, rows in (("in", torch.float32, 128, n_in),
                                         ("in", torch.float32, 32, n_in),
                                         ("out", torch.bfloat16, 128, n_out)):
            knbr = st[f"{side}_nbr"]
            time_k1(f"train {side} {knbr.shape[0]}x{knbr.shape[1]} "
                    f"{str(dtype).split('.')[-1]} w{width}", knbr,
                    st[f"{side}_wts"], table(rows, width, dtype))
        pos, wts = st["in_pos"], st["in_wts"]
        for width in (128, 32):
            gr = table(wts.shape[0], width, torch.float32)
            ms[f"table grad {pos.shape[0]}x{pos.shape[1]} w{width}"] = (
                chip_smoke.device_ms(torch,
                                     lambda: spmm_bwd_table(pos, wts, gr)))
        for side, rows in (("in", n_in), ("out", n_out)):
            knbr = st[f"{side}_nbr"]
            for width in (32, 8):
                tab = table(rows, width, torch.float32)
                gr = table(knbr.shape[0], width, torch.float32)
                ms[f"wts grad {side} {knbr.shape[0]}x{knbr.shape[1]} "
                   f"w{width}"] = chip_smoke.device_ms(
                       torch, lambda: spmm_bwd_wts(knbr, gr, tab))
    import repro_torch
    print(card, flush=True)
    print(json.dumps({"label": args.label, "card": card,
                      "package": str(Path(repro_torch.__file__).parent),
                      "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
