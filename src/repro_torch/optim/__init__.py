from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                          constant_schedule, sgd, tree_map)

__all__ = ["Optimizer", "adam", "adamw", "constant_schedule", "sgd",
           "tree_map"]
