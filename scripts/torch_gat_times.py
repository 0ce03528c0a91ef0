#!/usr/bin/env python3
"""Device time of the port's K5 (``gat_edge_partial_cuda``) at the shapes
``gat_aggregate`` gives it, on one NVIDIA card.

    PYTHONPATH=src python3 scripts/torch_gat_times.py [--label NAME]

The ``repro_torch`` on the import path is the one timed, so two checkouts
are compared on one card by running this script once with each checkout's
``src`` first on ``PYTHONPATH``, in turns (A, B, B, A).  Shapes: GAT's
per-head width 32 on subgraph 0 of papers-sim at scale 1.0 in 8 rcm parts
with 256-row chunks (the in-ELL over the (5257, 32) local table and the
out-ELL over the (14289, 32) halo table), and the reference's own test
shape, (128, 8) over a (65, 128) table: ``chip_smoke.k5_inputs``, the
inputs phase 8 holds K5 to its plain version with, here from a
``torch.Generator`` seeded 6.  Beside K5, the backward of GAT's score
gather over that in-ELL at 4 heads (``models.gnn._RowGather``, a random
gradient of shape (5256, 56, 4)), two ways: as the table-gradient kernel
with unit weights (``spmm_bwd_table``, what the backward runs), and as
the gather-and-sum over the transposed ELL that it replaced.  Each time
is ``chip_smoke.device_ms``: 20 calls queued behind a spin kernel between
two CUDA events.  Prints the card's ``nvidia-smi`` name and power limit
and one JSON line ``{"label", "card", "package", "ms": {shape: ms}}``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (device_ms, k5_inputs, nvidia_smi)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch

    from repro_torch.core.digest import prepare_graph_data
    from repro_torch.graph import make_dataset
    from repro_torch.kernels.gat_edge import gat_edge_partial_cuda
    from repro_torch.kernels.spmm.spmm import spmm_bwd_table

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    card = chip_smoke.nvidia_smi()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(6)
    g = make_dataset("papers-sim", scale=1.0, seed=0)
    data = prepare_graph_data(g, chip_smoke.TRAIN_PARTS, seed=0, order="rcm",
                              stream_chunk_rows=chip_smoke.TRAIN_CHUNK_ROWS,
                              device=dev)
    ms = {}
    with torch.inference_mode():
        for side, k5 in chip_smoke.k5_inputs(torch, dev, data, gen):
            nbr, z = k5[0], k5[4]
            name = (f"{side} {nbr.shape[0]}x{nbr.shape[1]} over "
                    f"{z.shape[0]}x{z.shape[1]}")
            ms[name] = chip_smoke.device_ms(
                torch, lambda: gat_edge_partial_cuda(*k5))
        nbr, pos = data["struct"]["in_nbr"][0], data["struct"]["in_pos"][0]
        g_s = torch.randn((nbr.shape[0], nbr.shape[1], 4), generator=gen)
        flat = g_s.reshape(-1, 4).to(dev)
        ones = torch.ones((flat.shape[0], 1), device=dev)
        p_long = pos.long()

        def gather_sum():
            ext = torch.cat([flat, flat.new_zeros((1, 4))])
            return ext[p_long].sum(dim=1)

        # The same sums, the sentinel row (no gradient) aside.
        assert torch.allclose(spmm_bwd_table(pos, ones, flat)[:-1],
                              gather_sum()[:-1], rtol=1e-5, atol=1e-5)
        name = (f"score-gather backward, in {nbr.shape[0]}x{nbr.shape[1]} "
                "x 4 heads")
        ms[f"{name}: table-gradient kernel"] = chip_smoke.device_ms(
            torch, lambda: spmm_bwd_table(pos, ones, flat))
        ms[f"{name}: gather and sum"] = chip_smoke.device_ms(
            torch, gather_sum)
    import repro_torch
    print(card, flush=True)
    print(json.dumps({"label": args.label, "card": card,
                      "package": str(Path(repro_torch.__file__).parent),
                      "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
