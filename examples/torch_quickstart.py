#!/usr/bin/env python
"""Quickstart: DIGEST against the two baseline framework families on a
small synthetic graph (the port's counterpart of ``examples/quickstart.py``,
through ``repro_torch.launch.quickstart``).

Runs on the card unless ``--device cpu`` is given; arguments after the
script's name go to the launcher after its defaults here, so they
override them:

  PYTHONPATH=src python examples/torch_quickstart.py \\
      [--device cpu] [--epochs 80]
"""
import sys

from repro_torch.launch import quickstart

# The reference example's settings, as the launcher's flags.
DEFAULTS = []


def main(argv=None):
    return quickstart.main(DEFAULTS + list(sys.argv[1:] if argv is None
                                       else argv))


if __name__ == "__main__":
    main()
