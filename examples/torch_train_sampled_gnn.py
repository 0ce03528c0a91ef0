#!/usr/bin/env python
"""Mini-batch sampled DIGEST training with stale-store control variates
(the port's counterpart of ``examples/train_sampled_gnn.py``), through
``repro_torch.launch.train_gnn --sampling``; ``--estimator plain`` is
scaled neighbour sampling, the variance baseline.

Runs on the card unless ``--device cpu`` is given; arguments after the
script's name go to the launcher after its defaults here, so they
override them:

  PYTHONPATH=src python examples/torch_train_sampled_gnn.py \\
      [--device cpu --scale 0.15 --epochs 4]
"""
import sys

from repro_torch.launch import train_gnn

# The reference example's settings, as the launcher's flags.
DEFAULTS = ["--sampling", "--fanout", "3", "--batch-seeds", "64",
            "--interval", "2"]


def main(argv=None):
    return train_gnn.main(DEFAULTS + list(sys.argv[1:] if argv is None
                                       else argv))


if __name__ == "__main__":
    main()
