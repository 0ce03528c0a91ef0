#!/usr/bin/env python
"""DIGEST-A under heterogeneity (paper Fig. 7): one straggler worker with
an 8-10 s delay; async training sails past the synchronous barrier (the
port of ``examples/async_straggler.py``).  On the card:

  PYTHONPATH=src python -m repro_torch.launch.async_straggler

``--device cpu`` runs the kernels' plain PyTorch versions instead;
``--rounds`` shortens the run.
"""
from __future__ import annotations

import argparse

from repro_torch.core import (AsyncSettings, digest_a_train,
                              prepare_graph_data, sync_time_per_round)
from repro_torch.device import resolve_device
from repro_torch.graph import make_dataset
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim import adam


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--rounds", type=int, default=240)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g = make_dataset("flickr-sim", scale=0.3)
    data = prepare_graph_data(g, 4, device=dev)
    cfg = GNNConfig(model="gcn", num_layers=3,
                    in_dim=g.features.shape[1], hidden_dim=64,
                    num_classes=int(g.labels.max()) + 1)
    settings = AsyncSettings(sync_interval=10, straggler=0, seed=7)
    _, hist = digest_a_train(cfg, adam(5e-3), data, settings,
                             total_rounds=args.rounds, eval_every_rounds=60)
    t_sync = sync_time_per_round(settings, 4)
    t_async = hist["sim_time"][-1] / hist["round"][-1]
    print(f"{'round':>6s} {'sim_t(s)':>9s} {'val F1':>7s} {'delay':>6s}")
    for r, t, f1, d in zip(hist["round"], hist["sim_time"],
                           hist["val_f1"], hist["delay"]):
        print(f"{r:6d} {t:9.1f} {f1:7.4f} {d:6d}")
    print(f"\nper-round: async {t_async:.2f}s vs sync barrier "
          f"{t_sync:.2f}s -> {t_sync/t_async:.1f}x faster under the "
          f"straggler (paper Fig. 7 behaviour)")


if __name__ == "__main__":
    main()
