from repro_torch.optim.optimizers import (REGISTRY, Optimizer, adafactor,
                                          adam, adamw, clip_by_global_norm,
                                          constant_schedule, make_optimizer,
                                          sgd, tree_leaves, tree_map,
                                          warmup_cosine_schedule)

__all__ = [
    "Optimizer", "adafactor", "adam", "adamw", "clip_by_global_norm",
    "constant_schedule", "make_optimizer", "sgd", "warmup_cosine_schedule",
    "REGISTRY", "tree_leaves", "tree_map",
]
