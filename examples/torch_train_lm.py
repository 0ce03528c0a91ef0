#!/usr/bin/env python
"""LM training on an assigned architecture, reduced (SMOKE widths), with
DIGEST periodic pod synchronization (local SGD across ``--n-pod``
parameter copies; the port's counterpart of ``examples/train_lm.py``),
through ``repro_torch.launch.train``.

Runs on the card unless ``--device cpu`` is given; arguments after the
script's name go to the launcher after its defaults here, so they
override them:

  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu --steps 20]
"""
import sys

from repro_torch.launch import train

# The reference example's settings, as the launcher's flags.
DEFAULTS = ["--smoke", "--arch", "qwen3-0.6b", "--steps", "300",
            "--sync-mode", "digest", "--n-pod", "2", "--sync-interval",
            "10"]


def main(argv=None):
    return train.main(DEFAULTS + list(sys.argv[1:] if argv is None
                                       else argv))


if __name__ == "__main__":
    main()
