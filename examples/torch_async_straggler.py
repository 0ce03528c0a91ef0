#!/usr/bin/env python
"""DIGEST-A under heterogeneity (paper Fig. 7): one straggler worker with
an 8-10 s delay, the asynchronous trainer past the synchronous barrier
(the port's counterpart of ``examples/async_straggler.py``, through
``repro_torch.launch.async_straggler``).

Runs on the card unless ``--device cpu`` is given; arguments after the
script's name go to the launcher after its defaults here, so they
override them:

  PYTHONPATH=src python examples/torch_async_straggler.py \\
      [--device cpu --rounds 24]
"""
import sys

from repro_torch.launch import async_straggler

# The reference example's settings, as the launcher's flags.
DEFAULTS = []


def main(argv=None):
    return async_straggler.main(DEFAULTS + list(sys.argv[1:] if argv is None
                                       else argv))


if __name__ == "__main__":
    main()
