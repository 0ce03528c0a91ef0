#!/usr/bin/env python
"""LM serving: batched prefill, then KV-cache decode, with DIGEST's
stale-KV long-context mode under ``--long`` (the port's counterpart of
``examples/serve_lm.py``), through ``repro_torch.launch.serve``.

Runs on the card unless ``--device cpu`` is given; arguments after the
script's name go to the launcher after its defaults here, so they
override them:

  PYTHONPATH=src python examples/torch_serve_lm.py \\
      [--device cpu --smoke] [--long]
"""
import sys

from repro_torch.launch import serve

# The reference example's settings, as the launcher's flags.
DEFAULTS = ["--arch", "phi3-mini-3.8b", "--batch", "4", "--gen", "32"]


def main(argv=None):
    return serve.main(DEFAULTS + list(sys.argv[1:] if argv is None
                                       else argv))


if __name__ == "__main__":
    main()
