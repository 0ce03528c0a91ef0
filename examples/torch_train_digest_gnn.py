#!/usr/bin/env python
"""End-to-end DIGEST GNN training (the paper's experiment; the port's
counterpart of ``examples/train_digest_gnn.py``): dataset, partition,
DIGEST with periodic stale sync, evaluation, checkpoints and the
communication accounting, through ``repro_torch.launch.train_gnn``
(``--pull collective`` under ``torchrun`` spreads the parts over
ranks).

Runs on the card unless ``--device cpu`` is given; arguments after the
script's name go to the launcher after its defaults here, so they
override them:

  PYTHONPATH=src python examples/torch_train_digest_gnn.py \\
      [--device cpu --scale 0.15 --epochs 4]
"""
import sys

from repro_torch.launch import train_gnn

# The reference example's settings, as the launcher's flags.
DEFAULTS = ["--dataset", "products-sim", "--parts", "8", "--epochs", "200",
            "--interval", "10"]


def main(argv=None):
    return train_gnn.main(DEFAULTS + list(sys.argv[1:] if argv is None
                                       else argv))


if __name__ == "__main__":
    main()
