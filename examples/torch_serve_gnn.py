#!/usr/bin/env python
"""Embedding serving from the DIGEST store, end to end on one card (the
port's counterpart of ``examples/serve_gnn.py``): the store refreshed
from the model, batched queries through the hot-row cache, served
logits against the offline forward, through
``repro_torch.launch.serve_gnn``.

Runs on the card unless ``--device cpu`` is given; arguments after the
script's name go to the launcher after its defaults here, so they
override them:

  PYTHONPATH=src python examples/torch_serve_gnn.py [--device cpu --scale 0.1]
"""
import sys

from repro_torch.launch import serve_gnn

# The reference example's settings, as the launcher's flags.
DEFAULTS = ["--cache-rows", "2048"]


def main(argv=None):
    return serve_gnn.main(DEFAULTS + list(sys.argv[1:] if argv is None
                                       else argv))


if __name__ == "__main__":
    main()
