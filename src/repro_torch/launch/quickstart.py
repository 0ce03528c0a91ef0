#!/usr/bin/env python
"""Quickstart: DIGEST vs the two baseline framework families on a small
synthetic graph (the port of ``examples/quickstart.py``).  On the card:

  PYTHONPATH=src python -m repro_torch.launch.quickstart

``--device cpu`` runs the kernels' plain PyTorch versions instead.
"""
from __future__ import annotations

import argparse

from repro_torch.core import TrainSettings, digest_train, prepare_graph_data
from repro_torch.device import resolve_device
from repro_torch.graph import make_dataset
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim import adam


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--epochs", type=int, default=80)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g = make_dataset("flickr-sim", scale=0.3)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges")
    data = prepare_graph_data(g, num_parts=4, device=dev)
    cfg = GNNConfig(model="gcn", num_layers=3,
                    in_dim=g.features.shape[1], hidden_dim=64,
                    num_classes=int(g.labels.max()) + 1)
    print(f"{'mode':14s} {'loss':>8s} {'val F1':>8s} {'test F1':>8s}")
    for mode in ("partition", "propagation", "digest"):
        _, hist = digest_train(cfg, adam(5e-3), data,
                               TrainSettings(sync_interval=5, mode=mode),
                               epochs=args.epochs, eval_every=args.epochs)
        print(f"{mode:14s} {hist['loss'][-1]:8.4f} "
              f"{hist['val_f1'][-1]:8.4f} {hist['test_f1'][-1]:8.4f}")
    print("\nExpected: digest ≈ propagation (no info loss), both > "
          "partition; digest communicates ~N× less than propagation.")


if __name__ == "__main__":
    main()
